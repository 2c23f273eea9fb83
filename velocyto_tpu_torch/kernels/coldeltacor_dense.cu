// Dense colDeltaCor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel velocyto_tpu/ops/coldeltacor.py::_dense_kernel
// (launched by _col_delta_cor_dense_pallas).  For every center cell c and
// candidate cell i it forms a = transform(e[:, i] - e[:, c]) over the genes
// and returns the Pearson correlation of a with d[:, c], built from five
// moments: S1 = sum a, S2 = sum a^2, S3 = sum a*b, Sb = sum b, Sb2 = sum b^2
// (b = d[:, c]).  The diagonal is 0/0 by construction; callers overwrite it.
// The dual form takes a second displacement matrix d2 (the randomized
// control) and returns its correlations from the same pass: a, S1 and S2
// are shared and only S3 (and Sb, Sb2) are taken for both fields.
// A center range [c0, c0 + M) writes only those rows, an (M, N) output:
// what one shard of a mesh runs when the centers are split over the
// shards (make_dense_sharded in the JAX package).  A center's moments do
// not depend on the tile it falls in, so each row of a ranged launch is
// bitwise equal to the same row of the whole (c0 = 0, M = N) launch.
//
// What bounds it: instruction issue and the SFU, not bytes.  At G = 2000,
// N = 20000 one call does 8.0e11 (pair, gene) steps; at 8 flop each that is
// 95.5 ms of FP32 at 67 TFLOP/s, one MUFU op each is 191 ms at 16 per SM
// per clock (132 SMs, 1.98 GHz), and its compulsory bytes (two (G, N)
// inputs, one (N, N) output) take 0.6 ms.  IEEE sqrtf with its fixup, two
// selects, a*a and scalar shared loads cost 15-20 issued instructions per
// step.
//
// What the design does about it:
//   - the lean step of coldeltacor_step.cuh: 7.3 issued instructions per
//     (pair, gene) for sqrt in the SASS (tools/sass_steps.py), one of them
//     the MUFU op, so the issue floor (174 ms) and the SFU floor (191 ms)
//     nearly meet;
//   - the dual form: the full-mode pipeline's main field and control cost
//     one launch, one extra FFMA per step instead of a second pass;
//   - one block per 64-center x 128-candidate tile, 8 warps; a warp owns 8
//     centers and a lane 4 candidates, so each thread keeps an 8 x 4
//     register tile (96 moment registers, 128 in the dual form) and reads
//     its per-gene operands with four or six 16-byte shared loads
//     (0.2 loads per step);
//   - gene chunks of 16 are double-buffered in shared memory with
//     cp.async (16-byte copies when N % 4 == 0, else 4-byte ones), so the
//     next chunk's loads overlap this chunk's arithmetic;
//   - Sb, Sb2 are summed once per center by all 256 threads in turn (4
//     genes of each chunk per thread), not per pair;
//   - __launch_bounds__(256, 1): the register tile, not occupancy, hides
//     latency (32 independent moment chains per thread); a 4 x 4 tile at
//     two blocks per SM gained nothing consistent, lost on the dual form
//     and spilled in the linear dual form, so it was not kept.
// Numerics: see coldeltacor_step.cuh (MUFU sqrt.approx / lg2.approx, the
// sign quirks of the full and partial variants).
//
// C interface (bound with ctypes): vtt_coldeltacor_dense returns the
// cudaError_t of the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "coldeltacor_step.cuh"

namespace {

using vtt::kLinear;
using vtt::kLog10;
using vtt::kSqrt;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRT = 8;         // centers per thread: its register tile rows
constexpr int kTI = 128;       // candidates per block: 32 lanes x 4
constexpr int kTC = kRT * (kThreads / 32);   // centers per block: 64
constexpr int kKG = 16;        // genes per shared-memory chunk
constexpr int kParts = kThreads / kTC;       // threads summing Sb per center
constexpr int kSbGenes = kKG / kParts;       // genes of a chunk per thread

struct Args {
  const float* e;     // (G, N)
  const float* d;     // (G, N)
  const float* d2;    // (G, N) or null
  float* out;         // (M, N)
  float* out2;        // (M, N) or null
  int G, N;
  int c0, M;          // the centers [c0, c0 + M): rows of out
  float psc;
  bool vec;           // 16-byte copies and stores are aligned
};

struct Stage {
  float ei[kKG][kTI];
  float ec[kKG][kTC];
  float b[kKG][kTC];
  float b2[kKG][kTC];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

// queue the copies of genes [g0, g0 + kKG) of the block's tile; cells and
// genes out of range are zero-filled (and never read by the step loop)
template <bool DUAL>
__device__ __forceinline__ void load_stage(Stage& st, const Args& p, int g0,
                                           int i0, int c0) {
  const size_t N = (size_t)p.N;
  if (p.vec) {
    for (int t = threadIdx.x; t < kKG * kTI / 4; t += kThreads) {
      const int gg = t / (kTI / 4), col = 4 * (t % (kTI / 4));
      const bool ok = g0 + gg < p.G && i0 + col < p.N;
      cp_async16(&st.ei[gg][col],
                 ok ? p.e + (size_t)(g0 + gg) * N + i0 + col : p.e, ok);
    }
    for (int t = threadIdx.x; t < kKG * kTC / 4; t += kThreads) {
      const int gg = t / (kTC / 4), col = 4 * (t % (kTC / 4));
      const bool ok = g0 + gg < p.G && c0 + col < p.N;
      const size_t at = ok ? (size_t)(g0 + gg) * N + c0 + col : 0;
      cp_async16(&st.ec[gg][col], p.e + at, ok);
      cp_async16(&st.b[gg][col], p.d + at, ok);
      if (DUAL) cp_async16(&st.b2[gg][col], p.d2 + at, ok);
    }
  } else {
    for (int t = threadIdx.x; t < kKG * kTI; t += kThreads) {
      const int gg = t / kTI, col = t % kTI;
      const bool ok = g0 + gg < p.G && i0 + col < p.N;
      cp_async4(&st.ei[gg][col],
                ok ? p.e + (size_t)(g0 + gg) * N + i0 + col : p.e, ok);
    }
    for (int t = threadIdx.x; t < kKG * kTC; t += kThreads) {
      const int gg = t / kTC, col = t % kTC;
      const bool ok = g0 + gg < p.G && c0 + col < p.N;
      const size_t at = ok ? (size_t)(g0 + gg) * N + c0 + col : 0;
      cp_async4(&st.ec[gg][col], p.e + at, ok);
      cp_async4(&st.b[gg][col], p.d + at, ok);
      if (DUAL) cp_async4(&st.b2[gg][col], p.d2 + at, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int TF, bool PARTIAL, bool DUAL>
__global__ void __launch_bounds__(kThreads, 1)
coldeltacor_dense_kernel(Args p) {
  __shared__ __align__(16) Stage stage[2];
  __shared__ float sb_part[kParts][4][kTC];   // [part][Sb, Sb2, Sc, Sc2][c]

  const int lane = threadIdx.x % 32;   // candidates i0 + 4 lane + q
  const int warp = threadIdx.x / 32;   // centers    c0 + kRT warp + r
  const int i0 = blockIdx.x * kTI;
  const int c0 = p.c0 + blockIdx.y * kTC;
  const int sb_c = threadIdx.x % kTC;  // this thread's share of Sb, Sb2:
  const int sb_g = kSbGenes * (threadIdx.x / kTC);   // genes of a chunk

  float s1[kRT][4], s2[kRT][4], s3[kRT][4], s4[kRT][DUAL ? 4 : 1];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s1[r][q] = s2[r][q] = s3[r][q] = 0.0f;
      if (DUAL) s4[r][q] = 0.0f;
    }
  }
  float sb1 = 0.0f, sb2 = 0.0f, sc1 = 0.0f, sc2 = 0.0f;

  const int n_chunks = (p.G + kKG - 1) / kKG;
  load_stage<DUAL>(stage[0], p, 0, i0, c0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks)
      load_stage<DUAL>(stage[(k + 1) & 1], p, (k + 1) * kKG, i0, c0);
    else
      asm volatile("cp.async.commit_group;\n" ::);   // keep the count
    asm volatile("cp.async.wait_group 1;\n" ::);      // chunk k has landed
    __syncthreads();
    const Stage& st = stage[k & 1];
    const int gn = min(kKG, p.G - k * kKG);

#pragma unroll
    for (int j = 0; j < kSbGenes; ++j) {
      if (sb_g + j < gn) {
        const float bv = st.b[sb_g + j][sb_c];
        sb1 = __fadd_rn(sb1, bv);
        sb2 = __fmaf_rn(bv, bv, sb2);
        if (DUAL) {
          const float bv2 = st.b2[sb_g + j][sb_c];
          sc1 = __fadd_rn(sc1, bv2);
          sc2 = __fmaf_rn(bv2, bv2, sc2);
        }
      }
    }

#pragma unroll 2
    for (int gg = 0; gg < gn; ++gg) {
      const float4 ei = *reinterpret_cast<const float4*>(&st.ei[gg][4 * lane]);
      const float xi[4] = {ei.x, ei.y, ei.z, ei.w};
      float xc[kRT], xb[kRT], xb2[kRT];
#pragma unroll
      for (int h = 0; h < kRT; h += 4) {
        const int at = kRT * warp + h;
        const float4 c = *reinterpret_cast<const float4*>(&st.ec[gg][at]);
        const float4 b = *reinterpret_cast<const float4*>(&st.b[gg][at]);
        const float4 b2 =
            DUAL ? *reinterpret_cast<const float4*>(&st.b2[gg][at]) : b;
        xc[h] = c.x, xc[h + 1] = c.y, xc[h + 2] = c.z, xc[h + 3] = c.w;
        xb[h] = b.x, xb[h + 1] = b.y, xb[h + 2] = b.z, xb[h + 3] = b.w;
        xb2[h] = b2.x, xb2[h + 1] = b2.y, xb2[h + 2] = b2.z,
        xb2[h + 3] = b2.w;
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          vtt::moment_step<TF, PARTIAL, DUAL>(
              xi[q], xc[r], xb[r], xb2[r], p.psc, s1[r][q], s2[r][q],
              s3[r][q], s4[r][DUAL ? q : 0]);
        }
      }
    }
    __syncthreads();   // stage k & 1 is refilled by the next iteration
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  sb_part[threadIdx.x / kTC][0][sb_c] = sb1;
  sb_part[threadIdx.x / kTC][1][sb_c] = sb2;
  sb_part[threadIdx.x / kTC][2][sb_c] = sc1;
  sb_part[threadIdx.x / kTC][3][sb_c] = sc2;
  __syncthreads();

  const float gf = (float)p.G;
  const size_t N = (size_t)p.N;
  const int i = i0 + 4 * lane;
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int cl = kRT * warp + r;
    const int c = c0 + cl;
    if (c >= p.c0 + p.M || i >= p.N) continue;
    float m[4];
#pragma unroll
    for (int f = 0; f < (DUAL ? 2 : 1); ++f) {
      float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        t1 = __fadd_rn(t1, sb_part[part][2 * f][cl]);
        t2 = __fadd_rn(t2, sb_part[part][2 * f + 1][cl]);
      }
      float* dst = f == 0 ? p.out : p.out2;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        m[q] = vtt::corr_from_moments(s1[r][q], s2[r][q],
                                      f == 0 ? s3[r][q] : s4[r][DUAL ? q : 0],
                                      t1, t2, gf);
      float* row = dst + (size_t)(c - p.c0) * N + i;
      if (p.vec) {
        *reinterpret_cast<float4*>(row) = make_float4(m[0], m[1], m[2], m[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i + q < p.N) row[q] = m[q];
      }
    }
  }
}

template <int TF, bool PARTIAL>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.N + kTI - 1) / kTI, (p.M + kTC - 1) / kTC);
  if (p.d2 != nullptr)
    coldeltacor_dense_kernel<TF, PARTIAL, true><<<grid, kThreads, 0, stream>>>(p);
  else
    coldeltacor_dense_kernel<TF, PARTIAL, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vtt_coldeltacor_dense(const void* e, const void* d,
                                     const void* d2, void* out, void* out2,
                                     int G, int N, int c0, int M,
                                     int transform, int partial, float psc,
                                     void* stream) {
  if (G < 1 || N < 1 || c0 < 0 || M < 1 || M > N - c0 ||
      (d2 == nullptr) != (out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.e = static_cast<const float*>(e);
  p.d = static_cast<const float*>(d);
  p.d2 = static_cast<const float*>(d2);
  p.out = static_cast<float*>(out);
  p.out2 = static_cast<float*>(out2);
  p.G = G;
  p.N = N;
  p.c0 = c0;
  p.M = M;
  p.psc = psc;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(e) |
                          reinterpret_cast<uintptr_t>(d) |
                          reinterpret_cast<uintptr_t>(d2) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(out2);
  // the centers' 16-byte copies start at column c0
  p.vec = N % 4 == 0 && c0 % 4 == 0 && bases % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (transform * 2 + (partial ? 1 : 0)) {
    case kLinear * 2 + 0: err = launch<kLinear, false>(p, s); break;
    case kLinear * 2 + 1: err = launch<kLinear, true>(p, s); break;
    case kSqrt * 2 + 0: err = launch<kSqrt, false>(p, s); break;
    case kSqrt * 2 + 1: err = launch<kSqrt, true>(p, s); break;
    case kLog10 * 2 + 0: err = launch<kLog10, false>(p, s); break;
    case kLog10 * 2 + 1: err = launch<kLog10, true>(p, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
