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
// The flat block-table kernel beside it replaces the jitted XLA program
// velocyto_tpu/ops/coldeltacor.py::_partial_flat_impl (:589), the step of
// the ring schedule (ops/coldeltacor.py::make_partial_ring): expression is
// split over the mesh's shards too, and at each step a shard correlates
// its own centers with the chunk of cells visiting it, through a table
// whose row f holds one center (qrow[f]) and q rows of the chunk (qloc[f,
// :]).  The plan packs each center's entries into adjacent table rows, so
// the table is a sequence of runs: segments of rows with one center, cut
// at 128 rows so a long one (the plan's dummy tail) spreads over blocks
// (kernels.flat_runs builds them on the card: run_start, and run_order,
// the runs in the locality rank of their centers).
//
// What bounds it: the same as the sampled kernel.  At the 20k operating
// point over 2 shards the 4 tables gather 7.06e10 / G rows of 4G bytes
// (~282 GB, >= 84 ms from device memory, so the L2 has to serve them) for
// 7.06e10 (entry, gene) steps: 10.5 ms of FP32, 16.9 ms of SFU at one MUFU
// op per step.
//
// What the design does about it:
//   - one block a run, blocks in run_order: the center row and its
//     displacement row(s) are staged and reduced once per run
//     (stage_center), then the run's ~55 table rows (~875 entries at
//     nn 1750, 2 shards) are walked as the sampled kernel walks a center's
//     neighbours; in the embedding's locality order the blocks in flight
//     gather from rows the L2 holds.  A run of one center, split, or
//     taken in any order gives the same outputs;
//   - warp w takes the run's quads w, w + kWarps, ..., loads each quad's
//     rows from global memory (quad_corr: 16-byte loads where G % 4 == 0
//     and the source is aligned, else 4-byte ones, the sampled kernel's
//     rule) and the next quad's ids while it works, so no row address
//     waits on them; 3 blocks an SM (24 warps; 2 for the linear dual step,
//     which needs more than 80 registers) keep more rows in flight.  Bulk
//     copies of the rows into a shared-memory ring (a producer warp's
//     cp.async.bulk of 2 KB segments, on mbarriers) were measured at the
//     20k point on the H100: 70 ms in any order, against 41 ms for these
//     loads in locality order (PERF.md), so the kernel has no such route;
//   - bitwise by construction: a pair's moments accumulate as in the
//     sampled kernel (quad_corr), so each entry is bitwise the sampled
//     kernel's for the same pair (same G, aligned sources).
// The schedule must cover the table (kernels.coldeltacor_flat checks one
// that a caller passes): a table row no run holds keeps its outputs
// unwritten.  An entry of run_order out of range, or a run whose rows are
// not in [0, F), is skipped rather than dereferenced.
//
// C interface (bound with ctypes): vtt_coldeltacor_partial and
// vtt_coldeltacor_flat return the cudaError_t of the launch as an int; 0
// means the kernel was queued.

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

struct FlatArgs {
  const float* e_visit;  // (C, G) gather source: the chunk visiting
  const float* e_ctr;    // (M, G) center rows of this shard
  const float* d_ctr;    // (M, G) displacement rows
  const float* d_ctr2;   // (M, G) second displacement rows, or null
  const int* qloc;       // (F, q) rows of e_visit
  const int* qrow;       // (F,) center row of each table row
  const int* run_start;  // (S + 1,) run r: rows [start[r], start[r + 1])
  const int* run_order;  // (S,) the run each block takes
  float* out;            // (F, q)
  float* out2;           // (F, q), or null
  int C, M, G, F, q, S;
  float psc;
};

struct CenterSums {
  float sb1, sb2, sc1, sc2;   // Sb, Sb2 of d_ctr (and Sc, Sc2 of d_ctr2)
};

// Stage one center row and its displacement row(s) in shared memory and
// reduce Sb, Sb2 (Sc, Sc2) over them with all kThreads threads: each
// thread sums every kThreads-th gene, then the warps and the block in a
// fixed order.  red: [kWarps][4] shared scratch of this center.  Ends
// with a barrier, so every thread sees the staged rows.
template <bool DUAL>
__device__ __forceinline__ CenterSums stage_center(
    const float* e_row, const float* d_row, const float* d2_row, int G,
    float* ec, float* b, float* b2, float (*red)[4]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float sb1 = 0.0f, sb2 = 0.0f, sc1 = 0.0f, sc2 = 0.0f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ec[g] = e_row[g];
    const float bv = d_row[g];
    b[g] = bv;
    sb1 += bv;
    sb2 += bv * bv;
    if (DUAL) {
      const float bv2 = d2_row[g];
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
  CenterSums cs = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cs.sb1 += red[w][0];
    cs.sb2 += red[w][1];
    cs.sc1 += red[w][2];
    cs.sc2 += red[w][3];
  }
  return cs;
}

// One warp: the correlations of kQuad gathered rows against the staged
// center, each lane taking every 32nd gene (or float4 of genes), the
// moments then summed over the warp.  Every lane ends with the results;
// a slot with ok[u] false gives NaN.  Both kernels below call this, so a
// pair's moments accumulate in the same order in either.
template <int TF, bool DUAL, bool VEC>
__device__ __forceinline__ void quad_corr(const float* const row[kQuad],
                                          const bool ok[kQuad],
                                          const float* ec, const float* b,
                                          const float* b2, int G, float psc,
                                          const CenterSums& cs,
                                          float c1[kQuad], float c2[kQuad]) {
  const int lane = threadIdx.x % 32;
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
  const float gf = (float)G;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    s1[u] = warp_sum(s1[u]);
    s2[u] = warp_sum(s2[u]);
    s3[u] = warp_sum(s3[u]);
    if (DUAL) s4[u] = warp_sum(s4[u]);
    c1[u] = ok[u] ? vtt::corr_from_moments(s1[u], s2[u], s3[u], cs.sb1,
                                           cs.sb2, gf)
                  : nan;
    if (DUAL)
      c2[u] = ok[u] ? vtt::corr_from_moments(s1[u], s2[u], s4[u], cs.sc1,
                                             cs.sc2, gf)
                    : nan;
  }
}

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
  const CenterSums cs = stage_center<DUAL>(
      p.e_ctr + crow, p.d_ctr + crow, DUAL ? p.d_ctr2 + crow : nullptr, G,
      ec, b, b2, red);

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
    float c1[kQuad], c2[kQuad];
    quad_corr<TF, DUAL, VEC>(row, ok, ec, b, b2, G, p.psc, cs, c1, c2);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (k0 + u >= k_end) break;
        const size_t o = (size_t)m * (size_t)p.nn + k0 + u;
        p.out[o] = c1[u];
        if (DUAL) p.out2[o] = c2[u];
      }
    }
  }
}

// The ids of quad k0..k0+kQuad-1 of a run (loc: its qloc entries, E of
// them), -1 past E.  Each walker of the run's quads loads the next quad's
// ids while it works on the current one, so no row address waits on them.
__device__ __forceinline__ void quad_ids(const int* loc, int k0, int E,
                                         int j[kQuad]) {
#pragma unroll
  for (int u = 0; u < kQuad; ++u) j[u] = k0 + u < E ? loc[k0 + u] : -1;
}

// The rows of a quad's ids: a slot past E or with a row outside [0, C) is
// not ok and points at row 0, which is never written out.
__device__ __forceinline__ void quad_rows(const FlatArgs& p,
                                          const int j[kQuad],
                                          const float* row[kQuad],
                                          bool ok[kQuad]) {
#pragma unroll
  for (int u = 0; u < kQuad; ++u) {
    ok[u] = j[u] >= 0 && j[u] < p.C;
    row[u] = p.e_visit + (size_t)(ok[u] ? j[u] : 0) * (size_t)p.G;
  }
}

// Move a walker to its next quad (k0 += kQuad * kWarps): its rows from the
// ids loaded ahead, and the ids of the quad after it loaded now.
__device__ __forceinline__ void next_quad(const FlatArgs& p, const int* loc,
                                          int E, int& k0, int nj[kQuad],
                                          const float* row[kQuad],
                                          bool ok[kQuad]) {
  k0 += kQuad * kWarps;
  quad_rows(p, nj, row, ok);
  quad_ids(loc, k0 + kQuad * kWarps, E, nj);
}

// The flat block-table form (the ring schedule's step): block b takes run
// run_order[b], the table rows [run_start[r], run_start[r + 1]) of one
// center qrow[run_start[r]], pairs that center of e_ctr / d_ctr with the
// rows qloc[f, :] of e_visit (the chunk of cells visiting this shard) and
// writes out[f, :].  It stages the center once; then warp w takes the
// run's entries kQuad at a time (quads w, w + kWarps, ...).  3 blocks an
// SM (80 registers a thread, 24 KB of center rows a block at G = 2000),
// but 2 for the linear dual step, which would spill at 80.
template <int TF, bool DUAL, bool VEC>
__global__ void __launch_bounds__(kThreads, TF == kLinear && DUAL ? 2 : 3)
coldeltacor_flat_kernel(FlatArgs p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kWarps][4];
  const int r = p.run_order[blockIdx.x];
  if (r < 0 || r >= p.S) return;                 // not a run
  const int f0 = p.run_start[r], f1 = p.run_start[r + 1];
  if (f0 < 0 || f1 > p.F || f1 <= f0) return;    // not rows of the table
  const int E = (f1 - f0) * p.q;                 // the run's entries
  const size_t e0 = (size_t)f0 * (size_t)p.q;    // its first, in qloc / out
  const int* loc = p.qloc + e0;
  const int m = p.qrow[f0];                      // the run's center
  const int G = p.G;
  if (m < 0 || m >= p.M) {                       // every entry gives NaN
    const float nan = __int_as_float(0x7fc00000);
    for (int t = threadIdx.x; t < E; t += kThreads) {
      p.out[e0 + t] = nan;
      if (DUAL) p.out2[e0 + t] = nan;
    }
    return;
  }
  float* ec = reinterpret_cast<float*>(smem4);   // [G] center row
  float* b = ec + G;                             // [G] displacement row
  float* b2 = b + G;                             // [G] second one (DUAL)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t crow = (size_t)m * (size_t)G;
  const CenterSums cs = stage_center<DUAL>(
      p.e_ctr + crow, p.d_ctr + crow, DUAL ? p.d_ctr2 + crow : nullptr, G,
      ec, b, b2, red);

  const float* row[kQuad];
  bool ok[kQuad];
  int nj[kQuad];
  int k0 = kQuad * (warp - kWarps);
  quad_ids(loc, k0 + kQuad * kWarps, E, nj);
  for (next_quad(p, loc, E, k0, nj, row, ok); k0 < E;
       next_quad(p, loc, E, k0, nj, row, ok)) {
    float c1[kQuad], c2[kQuad];
    quad_corr<TF, DUAL, VEC>(row, ok, ec, b, b2, G, p.psc, cs, c1, c2);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kQuad; ++u) {
        if (k0 + u >= E) break;
        p.out[e0 + k0 + u] = c1[u];
        if (DUAL) p.out2[e0 + k0 + u] = c2[u];
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


namespace {

template <int TF, bool DUAL, bool VEC>
cudaError_t launch_flat(const FlatArgs& p, cudaStream_t stream) {
  const size_t smem = (size_t)(DUAL ? 3 : 2) * (size_t)p.G * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coldeltacor_flat_kernel<TF, DUAL, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  coldeltacor_flat_kernel<TF, DUAL, VEC>
      <<<(unsigned)p.S, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int TF>
cudaError_t pick_flat(const FlatArgs& p, bool vec, cudaStream_t s) {
  if (p.d_ctr2 != nullptr)
    return vec ? launch_flat<TF, true, true>(p, s)
               : launch_flat<TF, true, false>(p, s);
  return vec ? launch_flat<TF, false, true>(p, s)
             : launch_flat<TF, false, false>(p, s);
}

}  // namespace

extern "C" int vtt_coldeltacor_flat(const void* e_visit, const void* e_ctr,
                                    const void* d_ctr, const void* d_ctr2,
                                    const void* qloc, const void* qrow,
                                    const void* run_start,
                                    const void* run_order, void* out,
                                    void* out2, int C, int M, int G, int F,
                                    int q, int S, int transform, float psc,
                                    void* stream) {
  if (C < 1 || M < 1 || G < 1 || F < 1 || q < 1 || S < 1 || S > F ||
      (long long)F * q > 0x7fffffffLL || run_start == nullptr ||
      run_order == nullptr || (d_ctr2 == nullptr) != (out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  FlatArgs p;
  p.e_visit = static_cast<const float*>(e_visit);
  p.e_ctr = static_cast<const float*>(e_ctr);
  p.d_ctr = static_cast<const float*>(d_ctr);
  p.d_ctr2 = static_cast<const float*>(d_ctr2);
  p.qloc = static_cast<const int*>(qloc);
  p.qrow = static_cast<const int*>(qrow);
  p.run_start = static_cast<const int*>(run_start);
  p.run_order = static_cast<const int*>(run_order);
  p.out = static_cast<float*>(out);
  p.out2 = static_cast<float*>(out2);
  p.C = C;
  p.M = M;
  p.G = G;
  p.F = F;
  p.q = q;
  p.S = S;
  p.psc = psc;
  // the same rule as the sampled kernel: with the same G and an aligned
  // gather source both take the same loop, so a pair's moments agree
  const bool vec =
      G % 4 == 0 && reinterpret_cast<uintptr_t>(e_visit) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (transform) {
    case kLinear: return (int)pick_flat<kLinear>(p, vec, s);
    case kSqrt: return (int)pick_flat<kSqrt>(p, vec, s);
    case kLog10: return (int)pick_flat<kLog10>(p, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
