// Dense colDeltaCor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel velocyto_tpu/ops/coldeltacor.py::_dense_kernel
// (launched by _col_delta_cor_dense_pallas).  For every center cell c and
// candidate cell i it forms a = transform(e[:, i] - e[:, c]) over the genes
// and returns the Pearson correlation of a with d[:, c], built from five
// moments: S1 = sum a, S2 = sum a^2, S3 = sum a*b, Sb = sum b, Sb2 = sum b^2
// (b = d[:, c]).  The diagonal is 0/0 by construction; callers overwrite it.
//
// What bounds it: FP32 and SFU issue, not bytes.  Each (pair, gene) costs
// about ten operations (subtract, abs, add, sqrt or log10, select, three
// FMAs), while a 64 x 64 tile reads only 3 * 64 floats per gene for its 4096
// pairs, so the arithmetic intensity grows with the tile and the kernel sits
// far above the memory roofline.
//
// What the design does about it: each block owns one 64-center x
// 64-candidate output tile and loops over all genes itself (the TPU's
// sequential gene grid axis becomes this loop), with every moment in
// registers: 256 threads, 4 x 4 pairs each.  Gene chunks of e[g, candidates],
// e[g, centers] and d[g, centers] are staged in shared memory by coalesced
// loads from the (G, N) row-major layout, and each staged value is reused by
// 16 threads and 4 pairs.  The loop is bounded by G, so padded genes never
// exist and no mask is needed.
//
// Numerics follow _apply_transform and _corr_from_moments of the JAX package:
// f32 throughout, IEEE sqrtf/log10f (build without --use_fast_math), and the
// sign quirks of the full and partial variants:
//   sqrt,  partial: |delta| < 1e-16 maps to exactly 0
//   log10, full:    delta == 0 takes the negative branch (`delta > 0` test)
//   log10, partial: delta == 0 takes the positive branch (`delta >= 0` test)
//
// C interface (bound with ctypes): vtt_coldeltacor_dense returns the
// cudaError_t of the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;      // centers and candidates per block
constexpr int kGenes = 32;     // genes per shared-memory chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 pairs each
constexpr int kLinear = 0, kSqrt = 1, kLog10 = 2;

template <int TF, bool PARTIAL>
__device__ __forceinline__ float transform(float delta, float psc) {
  if (TF == kLinear) return delta;
  if (TF == kSqrt) {
    const float mag = sqrtf(fabsf(delta) + psc);
    if (PARTIAL && fabsf(delta) < 1e-16f) return 0.0f;
    return delta > 0.0f ? mag : -mag;
  }
  const float mag = log10f(fabsf(delta) + psc);
  if (PARTIAL) return delta >= 0.0f ? mag : -mag;
  return delta > 0.0f ? mag : -mag;
}

template <int TF, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
coldeltacor_dense_kernel(const float* __restrict__ e,
                         const float* __restrict__ d,
                         float* __restrict__ out, int G, int N, float psc) {
  __shared__ float e_i[kGenes][kTile];
  __shared__ float e_c[kGenes][kTile];
  __shared__ float d_c[kGenes][kTile];

  const int tx = threadIdx.x % 16;  // candidate lane: i = i0 + tx + 16 q
  const int ty = threadIdx.x / 16;  // center lane:    c = c0 + ty + 16 p
  const int i0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;

  float s1[4][4], s2[4][4], s3[4][4], sb1[4], sb2[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    sb1[p] = 0.0f;
    sb2[p] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s1[p][q] = 0.0f;
      s2[p][q] = 0.0f;
      s3[p][q] = 0.0f;
    }
  }

  for (int g0 = 0; g0 < G; g0 += kGenes) {
    const int gn = min(kGenes, G - g0);
    // stage one gene chunk; a warp reads 32 consecutive cells of one gene
    for (int t = threadIdx.x; t < kGenes * kTile; t += kThreads) {
      const int gg = t / kTile;
      const int col = t % kTile;
      const bool gene_ok = gg < gn;
      const size_t row = (size_t)(g0 + gg) * (size_t)N;
      const int ci = i0 + col;
      const int cc = c0 + col;
      e_i[gg][col] = (gene_ok && ci < N) ? e[row + ci] : 0.0f;
      e_c[gg][col] = (gene_ok && cc < N) ? e[row + cc] : 0.0f;
      d_c[gg][col] = (gene_ok && cc < N) ? d[row + cc] : 0.0f;
    }
    __syncthreads();
    for (int gg = 0; gg < gn; ++gg) {
      float ei[4], ec[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) ei[q] = e_i[gg][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        ec[p] = e_c[gg][ty + 16 * p];
        b[p] = d_c[gg][ty + 16 * p];
        sb1[p] += b[p];
        sb2[p] += b[p] * b[p];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = transform<TF, PARTIAL>(ei[q] - ec[p], psc);
          s1[p][q] += a;
          s2[p][q] += a * a;
          s3[p][q] += a * b[p];
        }
      }
    }
    __syncthreads();
  }

  const float gf = (float)G;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int c = c0 + ty + 16 * p;
    if (c >= N) continue;
    const float var_b = sb2[p] - sb1[p] * sb1[p] / gf;
    const float mean_b = sb1[p] / gf;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + tx + 16 * q;
      if (i >= N) continue;
      const float num = s3[p][q] - s1[p][q] * mean_b;
      const float var_a = s2[p][q] - s1[p][q] * s1[p][q] / gf;
      out[(size_t)c * (size_t)N + i] = num / (sqrtf(var_a) * sqrtf(var_b));
    }
  }
}

template <int TF, bool PARTIAL>
void launch(const float* e, const float* d, float* out, int G, int N,
            float psc, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  coldeltacor_dense_kernel<TF, PARTIAL>
      <<<grid, kThreads, 0, stream>>>(e, d, out, G, N, psc);
}

}  // namespace

extern "C" int vtt_coldeltacor_dense(const void* e, const void* d, void* out,
                                     int G, int N, int transform, int partial,
                                     float psc, void* stream) {
  const float* ef = static_cast<const float*>(e);
  const float* df = static_cast<const float*>(d);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (transform * 2 + (partial ? 1 : 0)) {
    case kLinear * 2 + 0: launch<kLinear, false>(ef, df, of, G, N, psc, s); break;
    case kLinear * 2 + 1: launch<kLinear, true>(ef, df, of, G, N, psc, s); break;
    case kSqrt * 2 + 0: launch<kSqrt, false>(ef, df, of, G, N, psc, s); break;
    case kSqrt * 2 + 1: launch<kSqrt, true>(ef, df, of, G, N, psc, s); break;
    case kLog10 * 2 + 0: launch<kLog10, false>(ef, df, of, G, N, psc, s); break;
    case kLog10 * 2 + 1: launch<kLog10, true>(ef, df, of, G, N, psc, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
