// Neighbour-sampled colDeltaCor for NVIDIA Hopper (sm_90a).
//
// Replaces the jitted XLA program velocyto_tpu/ops/coldeltacor.py::_partial_impl,
// the hot kernel of estimate_transition_prob(knn_random=True).  For center
// row m and each of its nn sampled neighbours j = ixs[m, k] it forms
// a = transform(e_full[j, :] - e_ctr[m, :]) over the genes and returns the
// Pearson correlation of a with d_ctr[m, :], built from five moments:
// S1 = sum a, S2 = sum a^2, S3 = sum a*b, Sb = sum b, Sb2 = sum b^2.
// Optionally a second displacement matrix d_ctr2 (the randomized control)
// is correlated with the same a in the same pass: the neighbour rows are
// gathered once for both outputs, and each output equals a single call.
//
// What bounds it: the row gather.  Each (center, neighbour) pair reads one
// 4G-byte row of e_full in sampled order and does ~10 operations per gene
// on it, so at the 20k-cell operating point (nn = 1750, G = 2000) one call
// reads N * nn * G * 4 = 280 GB: >= 84 ms at 3.35 TB/s, while the moment
// arithmetic is well under that.  A 24.6 MB source (3,072 cells) stays in
// the 50 MB L2; a 160 MB one (20,000 cells) does not.
//
// What the design does about it: one block per (center row, chunk of 256
// neighbours).  The center row and its displacement row(s) are staged once
// in shared memory (2 or 3 x 4G bytes) with Sb and Sb2 reduced there, so
// the only device-memory traffic per pair is the neighbour row itself.
// Each warp takes one neighbour at a time and streams its row with
// coalesced 16-byte loads (4-byte loads when G is not a multiple of 4);
// S1, S2 and S3 are reduced with warp shuffles.  The dual form halves the
// bytes of the transition stage.
//
// Numerics follow _apply_transform(partial=True) and _corr_from_moments of
// the JAX package: f32 throughout, IEEE sqrtf/log10f (build without
// --use_fast_math), and the partial sign quirks:
//   sqrt:  |delta| < 1e-16 maps to exactly 0
//   log10: delta == 0 takes the positive branch (`delta >= 0` test)
// An index outside [0, N) is not read; its output is NaN.
//
// C interface (bound with ctypes): vtt_coldeltacor_partial returns the
// cudaError_t of the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;               // neighbours per block
constexpr int kLinear = 0, kSqrt = 1, kLog10 = 2;

template <int TF>
__device__ __forceinline__ float transform_partial(float delta, float psc) {
  if (TF == kLinear) return delta;
  if (TF == kSqrt) {
    if (fabsf(delta) < 1e-16f) return 0.0f;
    const float mag = sqrtf(fabsf(delta) + psc);
    return delta > 0.0f ? mag : -mag;
  }
  const float mag = log10f(fabsf(delta) + psc);
  return delta >= 0.0f ? mag : -mag;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float corr(float s1, float s2, float s3, float sb1,
                                      float sb2, float gf) {
  const float num = s3 - s1 * (sb1 / gf);
  const float var_a = s2 - s1 * s1 / gf;
  const float var_b = sb2 - sb1 * sb1 / gf;
  return num / (sqrtf(var_a) * sqrtf(var_b));
}

struct Args {
  const float* e_full;   // (N, G) gather source
  const float* e_ctr;    // (M, G) center rows
  const float* d_ctr;    // (M, G) displacement rows
  const float* d_ctr2;   // (M, G) second displacement rows, or null
  const void* ixs;       // (M, nn) int32 or int64 neighbour ids
  float* out;            // (M, nn)
  float* out2;           // (M, nn), or null
  int N, M, G, nn;
  float psc;
};

// Adds the moments of one gene to the running sums.
template <int TF, bool DUAL>
__device__ __forceinline__ void accumulate(float e_nb, float e_c, float b,
                                           float b2, float psc, float& s1,
                                           float& s2, float& s3, float& s4) {
  const float a = transform_partial<TF>(e_nb - e_c, psc);
  s1 += a;
  s2 += a * a;
  s3 += a * b;
  if (DUAL) s4 += a * b2;
}

template <int TF, bool DUAL, typename IDX, bool VEC>
__global__ void __launch_bounds__(kThreads)
coldeltacor_partial_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* ec = reinterpret_cast<float*>(smem4);   // [G] center row
  float* b = ec + p.G;                           // [G] displacement row
  float* b2 = b + p.G;                           // [G] second one (DUAL)
  __shared__ float red[kWarps][4];

  const int G = p.G;
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t crow = (size_t)m * (size_t)G;

  // stage the center rows and reduce Sb, Sb2 over them
  float sb1 = 0.0f, sb2 = 0.0f, sc1 = 0.0f, sc2 = 0.0f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ec[g] = p.e_ctr[crow + g];
    const float bv = p.d_ctr[crow + g];
    b[g] = bv;
    sb1 += bv;
    sb2 += bv * bv;
    if (DUAL) {
      const float bv2 = p.d_ctr2[crow + g];
      b2[g] = bv2;
      sc1 += bv2;
      sc2 += bv2 * bv2;
    }
  }
  sb1 = warp_sum(sb1);
  sb2 = warp_sum(sb2);
  if (DUAL) {
    sc1 = warp_sum(sc1);
    sc2 = warp_sum(sc2);
  }
  if (lane == 0) {
    red[warp][0] = sb1;
    red[warp][1] = sb2;
    red[warp][2] = sc1;
    red[warp][3] = sc2;
  }
  __syncthreads();
  sb1 = sb2 = sc1 = sc2 = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    sb1 += red[w][0];
    sb2 += red[w][1];
    sc1 += red[w][2];
    sc2 += red[w][3];
  }

  const float gf = (float)G;
  const IDX* ixs = static_cast<const IDX*>(p.ixs) + (size_t)m * (size_t)p.nn;
  const int k_end = min(p.nn, (int)(blockIdx.y + 1) * kChunk);
  for (int k = blockIdx.y * kChunk + warp; k < k_end; k += kWarps) {
    const long long j = (long long)ixs[k];
    const bool ok = j >= 0 && j < p.N;
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
    if (ok) {
      const float* row = p.e_full + (size_t)j * (size_t)G;
      if (VEC) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        const float4* ec4 = reinterpret_cast<const float4*>(ec);
        const float4* b4 = reinterpret_cast<const float4*>(b);
        const float4* b24 = reinterpret_cast<const float4*>(b2);
        const int g4n = G / 4;
#pragma unroll 4
        for (int g4 = lane; g4 < g4n; g4 += 32) {
          const float4 v = __ldg(row4 + g4);
          const float4 c = ec4[g4];
          const float4 bb = b4[g4];
          const float4 bb2 = DUAL ? b24[g4] : bb;
          accumulate<TF, DUAL>(v.x, c.x, bb.x, bb2.x, p.psc, s1, s2, s3, s4);
          accumulate<TF, DUAL>(v.y, c.y, bb.y, bb2.y, p.psc, s1, s2, s3, s4);
          accumulate<TF, DUAL>(v.z, c.z, bb.z, bb2.z, p.psc, s1, s2, s3, s4);
          accumulate<TF, DUAL>(v.w, c.w, bb.w, bb2.w, p.psc, s1, s2, s3, s4);
        }
      } else {
#pragma unroll 4
        for (int g = lane; g < G; g += 32)
          accumulate<TF, DUAL>(__ldg(row + g), ec[g], b[g],
                               DUAL ? b2[g] : 0.0f, p.psc, s1, s2, s3, s4);
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    s3 = warp_sum(s3);
    if (DUAL) s4 = warp_sum(s4);
    if (lane == 0) {
      const size_t o = (size_t)m * (size_t)p.nn + k;
      const float nan = __int_as_float(0x7fc00000);
      p.out[o] = ok ? corr(s1, s2, s3, sb1, sb2, gf) : nan;
      if (DUAL) p.out2[o] = ok ? corr(s1, s2, s4, sc1, sc2, gf) : nan;
    }
  }
}

template <int TF, bool DUAL, typename IDX, bool VEC>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const size_t smem = (size_t)(DUAL ? 3 : 2) * (size_t)p.G * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coldeltacor_partial_kernel<TF, DUAL, IDX, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.M, (p.nn + kChunk - 1) / kChunk);
  coldeltacor_partial_kernel<TF, DUAL, IDX, VEC>
      <<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int TF, bool DUAL, typename IDX>
cudaError_t pick_vec(const Args& p, bool vec, cudaStream_t s) {
  return vec ? launch<TF, DUAL, IDX, true>(p, s)
             : launch<TF, DUAL, IDX, false>(p, s);
}

template <int TF, bool DUAL>
cudaError_t pick_idx(const Args& p, bool idx64, bool vec, cudaStream_t s) {
  return idx64 ? pick_vec<TF, DUAL, int64_t>(p, vec, s)
               : pick_vec<TF, DUAL, int32_t>(p, vec, s);
}

template <int TF>
cudaError_t pick_dual(const Args& p, bool idx64, bool vec, cudaStream_t s) {
  return p.d_ctr2 != nullptr ? pick_idx<TF, true>(p, idx64, vec, s)
                             : pick_idx<TF, false>(p, idx64, vec, s);
}

}  // namespace

extern "C" int vtt_coldeltacor_partial(const void* e_full, const void* e_ctr,
                                       const void* d_ctr, const void* d_ctr2,
                                       const void* ixs, int idx64, void* out,
                                       void* out2, int N, int M, int G, int nn,
                                       int transform, float psc, void* stream) {
  if (M < 1 || nn < 1 || G < 1 || (d_ctr2 == nullptr) != (out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.e_full = static_cast<const float*>(e_full);
  p.e_ctr = static_cast<const float*>(e_ctr);
  p.d_ctr = static_cast<const float*>(d_ctr);
  p.d_ctr2 = static_cast<const float*>(d_ctr2);
  p.ixs = ixs;
  p.out = static_cast<float*>(out);
  p.out2 = static_cast<float*>(out2);
  p.N = N;
  p.M = M;
  p.G = G;
  p.nn = nn;
  p.psc = psc;
  // 16-byte loads need every gathered row 16-byte aligned
  const bool vec = G % 4 == 0 && reinterpret_cast<uintptr_t>(e_full) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (transform) {
    case kLinear: return (int)pick_dual<kLinear>(p, idx64 != 0, vec, s);
    case kSqrt: return (int)pick_dual<kSqrt>(p, idx64 != 0, vec, s);
    case kLog10: return (int)pick_dual<kLog10>(p, idx64 != 0, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
