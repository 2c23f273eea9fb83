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
// 4G-byte row of e_full in sampled order, so at the 20k-cell operating
// point (nn = 1750, G = 2000) one call gathers N * nn * G * 4 = 280 GB,
// while its compulsory bytes are about 1 GB (0.33 ms at 3.35 TB/s) and its
// arithmetic 7.0e10 (pair, gene) steps: 10.4 ms of FP32 at 67 TFLOP/s,
// 16.7 ms of SFU at one MUFU op per step.  Served from device memory the
// gather takes >= 84 ms.  Cells in index order are not neighbours, so
// blocks that take centers in index order gather unrelated rows and the
// 50 MB L2 serves few of them twice.
//
// What the design does about it:
//   - a center order: block b serves center order[b / n_chunks] (identity
//     when no order is given), and consecutive blocks take one center's
//     256-neighbour chunks in turn.  The caller passes a locality order of
//     the embedding (ops/coldeltacor.py::locality_order); centers close in
//     the embedding share most of their kNN candidates, so the blocks in
//     flight gather from a few thousand distinct rows that L2 can hold.
//     The order changes no output: each output is computed by the same
//     code from the same inputs;
//   - the center row and its displacement row(s) are staged once in shared
//     memory with Sb and Sb2 reduced there; each warp then takes 4
//     neighbours at a time, so one set of 16-byte shared loads of the
//     center values serves 4 gathered rows (0.19 shared loads per step)
//     and each lane keeps 4 independent 16-byte row loads in flight;
//   - the lean step of coldeltacor_step.cuh (one MUFU op per step);
//   - int32 indices: the pipeline builds its sampled ids as int32, so the
//     path converts nothing (the wrapper converts int64 ids of other
//     callers).
// The order must be a permutation of the centers (the public entry point
// ops/coldeltacor.py::col_delta_cor_partial_compact checks it): a center
// left out keeps its output row unwritten, and an entry out of range is
// skipped here rather than dereferenced.
// Numerics: see coldeltacor_step.cuh; the partial sign quirks:
//   sqrt:  |delta| < 1e-16 maps to exactly 0
//   log10: delta == 0 takes the positive branch (`delta >= 0` test)
// An index outside [0, N) is not dereferenced; its output is NaN.
//
// C interface (bound with ctypes): vtt_coldeltacor_partial returns the
// cudaError_t of the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "coldeltacor_step.cuh"

namespace {

using vtt::kLinear;
using vtt::kLog10;
using vtt::kSqrt;

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;               // neighbours per block
constexpr int kQuad = 4;                  // neighbours per warp at a time

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const float* e_full;   // (N, G) gather source
  const float* e_ctr;    // (M, G) center rows
  const float* d_ctr;    // (M, G) displacement rows
  const float* d_ctr2;   // (M, G) second displacement rows, or null
  const int* ixs;        // (M, nn) neighbour ids
  const int* order;      // (M,) permutation of the centers, or null
  float* out;            // (M, nn)
  float* out2;           // (M, nn), or null
  int N, M, G, nn, n_chunks;
  float psc;
};

template <int TF, bool DUAL, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
coldeltacor_partial_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* ec = reinterpret_cast<float*>(smem4);   // [G] center row
  float* b = ec + p.G;                           // [G] displacement row
  float* b2 = b + p.G;                           // [G] second one (DUAL)
  __shared__ float red[kWarps][4];

  const int G = p.G;
  const int pos = blockIdx.x / p.n_chunks;
  const int chunk = blockIdx.x - pos * p.n_chunks;
  const int m = p.order != nullptr ? p.order[pos] : pos;
  if (m < 0 || m >= p.M) return;               // not a permutation entry
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
  const float psc = p.psc;
  const int* ixs = p.ixs + (size_t)m * (size_t)p.nn;
  const int k_end = min(p.nn, (chunk + 1) * kChunk);
  for (int k0 = chunk * kChunk + kQuad * warp; k0 < k_end;
       k0 += kQuad * kWarps) {
    // a slot past k_end or with an index out of range reads row 0 (never
    // written out), so the loop below has no per-slot branch
    const float* row[kQuad];
    bool ok[kQuad];
#pragma unroll
    for (int u = 0; u < kQuad; ++u) {
      const int j = k0 + u < k_end ? ixs[k0 + u] : -1;
      ok[u] = j >= 0 && j < p.N;
      row[u] = p.e_full + (size_t)(ok[u] ? j : 0) * (size_t)G;
    }
    float s1[kQuad], s2[kQuad], s3[kQuad], s4[kQuad];
#pragma unroll
    for (int u = 0; u < kQuad; ++u) s1[u] = s2[u] = s3[u] = s4[u] = 0.0f;
    if (VEC) {
      const float4* ec4 = reinterpret_cast<const float4*>(ec);
      const float4* b4 = reinterpret_cast<const float4*>(b);
      const float4* b24 = reinterpret_cast<const float4*>(b2);
      const int g4n = G / 4;
#pragma unroll 2
      for (int g4 = lane; g4 < g4n; g4 += 32) {
        float4 v[kQuad];
#pragma unroll
        for (int u = 0; u < kQuad; ++u)
          v[u] = __ldg(reinterpret_cast<const float4*>(row[u]) + g4);
        const float4 c = ec4[g4];
        const float4 bb = b4[g4];
        const float4 bb2 = DUAL ? b24[g4] : bb;
#pragma unroll
        for (int u = 0; u < kQuad; ++u) {
          vtt::moment_step<TF, true, DUAL>(v[u].x, c.x, bb.x, bb2.x, psc,
                                           s1[u], s2[u], s3[u], s4[u]);
          vtt::moment_step<TF, true, DUAL>(v[u].y, c.y, bb.y, bb2.y, psc,
                                           s1[u], s2[u], s3[u], s4[u]);
          vtt::moment_step<TF, true, DUAL>(v[u].z, c.z, bb.z, bb2.z, psc,
                                           s1[u], s2[u], s3[u], s4[u]);
          vtt::moment_step<TF, true, DUAL>(v[u].w, c.w, bb.w, bb2.w, psc,
                                           s1[u], s2[u], s3[u], s4[u]);
        }
      }
    } else {
#pragma unroll 2
      for (int g = lane; g < G; g += 32) {
        const float c = ec[g], bb = b[g], bb2 = DUAL ? b2[g] : 0.0f;
#pragma unroll
        for (int u = 0; u < kQuad; ++u)
          vtt::moment_step<TF, true, DUAL>(__ldg(row[u] + g), c, bb, bb2,
                                           psc, s1[u], s2[u], s3[u], s4[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kQuad; ++u) {
      s1[u] = warp_sum(s1[u]);
      s2[u] = warp_sum(s2[u]);
      s3[u] = warp_sum(s3[u]);
      if (DUAL) s4[u] = warp_sum(s4[u]);
    }
    if (lane == 0) {
      const float nan = __int_as_float(0x7fc00000);
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (k0 + u >= k_end) break;
        const size_t o = (size_t)m * (size_t)p.nn + k0 + u;
        p.out[o] = ok[u] ? vtt::corr_from_moments(s1[u], s2[u], s3[u], sb1,
                                                  sb2, gf)
                         : nan;
        if (DUAL)
          p.out2[o] = ok[u] ? vtt::corr_from_moments(s1[u], s2[u], s4[u],
                                                     sc1, sc2, gf)
                            : nan;
      }
    }
  }
}

template <int TF, bool DUAL, bool VEC>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const size_t smem = (size_t)(DUAL ? 3 : 2) * (size_t)p.G * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coldeltacor_partial_kernel<TF, DUAL, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)p.M * (unsigned)p.n_chunks;
  coldeltacor_partial_kernel<TF, DUAL, VEC>
      <<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int TF, bool DUAL>
cudaError_t pick_vec(const Args& p, bool vec, cudaStream_t s) {
  return vec ? launch<TF, DUAL, true>(p, s) : launch<TF, DUAL, false>(p, s);
}

template <int TF>
cudaError_t pick_dual(const Args& p, bool vec, cudaStream_t s) {
  return p.d_ctr2 != nullptr ? pick_vec<TF, true>(p, vec, s)
                             : pick_vec<TF, false>(p, vec, s);
}

}  // namespace

extern "C" int vtt_coldeltacor_partial(const void* e_full, const void* e_ctr,
                                       const void* d_ctr, const void* d_ctr2,
                                       const void* ixs, const void* order,
                                       void* out, void* out2, int N, int M,
                                       int G, int nn, int transform,
                                       float psc, void* stream) {
  if (M < 1 || nn < 1 || G < 1 || (d_ctr2 == nullptr) != (out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args p;
  p.e_full = static_cast<const float*>(e_full);
  p.e_ctr = static_cast<const float*>(e_ctr);
  p.d_ctr = static_cast<const float*>(d_ctr);
  p.d_ctr2 = static_cast<const float*>(d_ctr2);
  p.ixs = static_cast<const int*>(ixs);
  p.order = static_cast<const int*>(order);
  p.out = static_cast<float*>(out);
  p.out2 = static_cast<float*>(out2);
  p.N = N;
  p.M = M;
  p.G = G;
  p.nn = nn;
  p.n_chunks = (nn + kChunk - 1) / kChunk;
  p.psc = psc;
  if ((long long)M * p.n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads need every gathered row 16-byte aligned
  const bool vec = G % 4 == 0 && reinterpret_cast<uintptr_t>(e_full) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (transform) {
    case kLinear: return (int)pick_dual<kLinear>(p, vec, s);
    case kSqrt: return (int)pick_dual<kSqrt>(p, vec, s);
    case kLog10: return (int)pick_dual<kLog10>(p, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
