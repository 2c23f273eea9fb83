// Exact t-SNE gradient (Student-t kernel) of (n, d) float32 positions,
// d = 1, 2 or 3, for NVIDIA Hopper (sm_90a).
//
// Replaces the gradient of sklearn's Barnes-Hut TSNE that the JAX package
// calls (velocyto_tpu/analysis.py:1070, _barnes_hut_tsne.gradient through
// _kl_divergence_bh).  It computes the theta -> 0 limit of the same
// objective with sklearn's degrees of freedom, dof = max(d - 1, 1): with
// q_ij = (dof / (dof + |y_i - y_j|^2))^((dof + 1) / 2) and
// Z = sum_{i != j} q_ij,
//
//   grad_i = (2 (dof + 1) / dof) (sum_{j in P_i} p_ij q_ij (y_i - y_j)
//                                 - sum_{j != i} q_ij^2 (y_i - y_j) / Z)
//
// and, when asked, the KL error sum p_ij log(max(p_ij, tiny) /
// max(q_ij / Z, tiny)) over the sparse P, as sklearn's
// compute_gradient_positive does.  For d = 3 (dof = 2), q = w sqrt(w) with
// w = 2 / (2 + |y_i - y_j|^2), as ops/tsne.py::_tsne_grad_plain computes.
//
// What bounds it: the all-pairs repulsive term, n^2 pairs of ~9 issued
// FP32 instructions and one MUFU reciprocal (4e8 pairs at n = 20,000); the
// bytes are the positions and the CSR of P, a few MB.
//
// What the design does about it:
//
// tsne_pairs_kernel: a tiled N-body pass.  A block of kPairThreads threads
// holds kBlockRows rows, kRowsPer in the registers of each thread, so one
// shared-memory read of a column serves kRowsPer pairs; the columns of one
// of `splits` column ranges stream through shared memory in tiles of a
// compile-time kTile, the ragged edge padded with a far point whose pairs
// give exactly 0.  Each tile's float sums are added into double per-row
// sums.  The wrapper picks `splits` so ~16 blocks per SM are queued.
// Each block writes its rows' partial forces and its partial sum of q
// (self pairs included); the last block to finish (an integer ticket, no
// floating-point atomics) sums the partials in a fixed order into Z.
//
// tsne_attract_kernel: one warp per row.  The lanes read the row's CSR
// entries coalesced, gather the neighbours' positions, and sum the
// attractive term and the KL terms; the row's partial forces are summed
// over the splits; lane sums combine through a fixed shuffle tree.  The
// KL error's per-block sums are summed by the last block in a fixed order.
// Every sum is in a fixed order, so two calls give bitwise equal results.
//
// C interface (bound with ctypes): vtt_tsne_pairs and vtt_tsne_attract each
// launch one kernel on the stream and return the cudaError_t of the launch
// as an int.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kPairThreads = 128;   // threads per block of the pair pass
constexpr int kRowsPer = 2;         // rows in each thread's registers
constexpr int kBlockRows = kPairThreads * kRowsPer;
constexpr int kTile = kPairThreads; // columns per shared tile
constexpr int kWarpsAttract = 8;    // rows (warps) per block of the second
constexpr float kFar = 1e30f;       // |pad - y|^2 overflows to inf: q = 0
constexpr float kTiny = 1.17549435e-38f;   // FLT_MIN, sklearn's FLOAT32_TINY

template <int D> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<3> { using T = float4; };

__device__ __forceinline__ float comp(float v, int) { return v; }
__device__ __forceinline__ float comp(float2 v, int d) {
  return d == 0 ? v.x : v.y;
}
__device__ __forceinline__ float comp(float4 v, int d) {
  return d == 0 ? v.x : (d == 1 ? v.y : v.z);
}

template <int D>
__device__ __forceinline__ typename Vec<D>::T load_pt(const float* y, int i) {
  if constexpr (D == 1) {
    return y[i];
  } else if constexpr (D == 2) {
    return reinterpret_cast<const float2*>(y)[i];
  } else {
    return make_float4(y[3 * i], y[3 * i + 1], y[3 * i + 2], 0.f);
  }
}

template <int D>
__device__ __forceinline__ typename Vec<D>::T far_pt(float v) {
  if constexpr (D == 1) return v;
  else if constexpr (D == 2) return make_float2(v, v);
  else return make_float4(v, v, v, 0.f);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Sum over the block in a fixed tree; valid on thread 0.
template <int kThreads>
__device__ double block_sum(double v, double* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  double r = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) r += buf[w];
  }
  return r;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether this block is the last of the grid to arrive (thread 0 counts;
// every thread gets the answer).  The last block resets the ticket.
__device__ bool last_block(unsigned* ticket, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x * gridDim.y;
    *flag = atomicAdd(ticket, 1u) == blocks - 1;
    if (*flag) *ticket = 0u;
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// blocks (row block, column split); rep holds (n, splits, D) partial
// forces, zpart one partial sum of q per block, z the final Z
template <int D>
__global__ void __launch_bounds__(kPairThreads, 8)
tsne_pairs_kernel(const float* __restrict__ y, int n, int splits,
                  double* __restrict__ rep, double* __restrict__ zpart,
                  double* __restrict__ z, unsigned* __restrict__ ticket) {
  using V = typename Vec<D>::T;
  __shared__ V tile[kTile];
  __shared__ double buf[kPairThreads / 32];
  __shared__ bool last;
  // column ranges in whole tiles: only the last one has a ragged edge
  const int split = blockIdx.y;
  const int per = ((n + splits - 1) / splits + kTile - 1) / kTile * kTile;
  const int c0 = min(n, split * per), c1 = min(n, c0 + per);
  float yi[kRowsPer][D];
  double acc[kRowsPer][D];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int i = blockIdx.x * kBlockRows + r * kPairThreads + threadIdx.x;
    // a missing row sits at -kFar, a padded column at +kFar: every pair
    // with either gives q = 0
    const V p = i < n ? load_pt<D>(y, i) : far_pt<D>(-kFar);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      yi[r][d] = comp(p, d);
      acc[r][d] = 0.0;
    }
  }
  double qs = 0.0;
  for (int t0 = c0; t0 < c1; t0 += kTile) {
    const int c = t0 + threadIdx.x;
    tile[threadIdx.x] = c < c1 ? load_pt<D>(y, c) : far_pt<D>(kFar);
    __syncthreads();
    float tacc[kRowsPer][D], tq[kRowsPer];
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      tq[r] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) tacc[r][d] = 0.f;
    }
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const V yj = tile[t];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        float dd[D];
#pragma unroll
        for (int d = 0; d < D; ++d) dd[d] = yi[r][d] - comp(yj, d);
        float q;
        if constexpr (D == 3) {
          const float w = 2.f * rcp_approx(
              fmaf(dd[0], dd[0], fmaf(dd[1], dd[1], fmaf(dd[2], dd[2], 2.f))));
          q = w * sqrt_approx(w);
        } else if constexpr (D == 2) {
          q = rcp_approx(fmaf(dd[0], dd[0], fmaf(dd[1], dd[1], 1.f)));
        } else {
          q = rcp_approx(fmaf(dd[0], dd[0], 1.f));
        }
        const float q2 = q * q;
        tq[r] += q;
#pragma unroll
        for (int d = 0; d < D; ++d) tacc[r][d] = fmaf(q2, dd[d], tacc[r][d]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      qs += tq[r];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[r][d] += tacc[r][d];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int i = blockIdx.x * kBlockRows + r * kPairThreads + threadIdx.x;
    if (i < n) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        rep[((size_t)i * splits + split) * D + d] = acc[r][d];
    }
  }
  const double zb = block_sum<kPairThreads>(qs, buf);
  const int nblocks = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) zpart[blockIdx.y * gridDim.x + blockIdx.x] = zb;
  if (last_block(ticket, &last)) {
    double s = 0.0;
    for (int b = threadIdx.x; b < nblocks; b += kPairThreads)
      s += __ldcg(zpart + b);
    s = block_sum<kPairThreads>(s, buf);
    if (threadIdx.x == 0) z[0] = fmax(s - (double)n, DBL_EPSILON);
  }
}

// one warp per row: the attractive term over the row's CSR entries, the
// row's partial forces summed over the splits, the gradient, the row's KL
// terms; per-block KL sums, summed by the last block into err[0]
template <int D>
__global__ void __launch_bounds__(kWarpsAttract * 32)
tsne_attract_kernel(const float* __restrict__ y, int n, int splits,
                    const int64_t* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float* __restrict__ pval,
                    const double* __restrict__ rep,
                    const double* __restrict__ zin, int compute_error,
                    float* __restrict__ grad, double* __restrict__ err_part,
                    double* __restrict__ err, unsigned* __restrict__ ticket) {
  using V = typename Vec<D>::T;
  constexpr double kCoef = D == 3 ? 3.0 : 4.0;    // 2 (dof + 1) / dof
  __shared__ double wsum[kWarpsAttract];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarpsAttract + warp;
  const double Z = *zin;
  double e = 0.0;
  if (i < n) {
    const V pi = load_pt<D>(y, i);
    double a[D];
#pragma unroll
    for (int d = 0; d < D; ++d) a[d] = 0.0;
    const int64_t k1 = indptr[i + 1];
    for (int64_t k = indptr[i] + lane; k < k1; k += 32) {
      const V pj = load_pt<D>(y, indices[k]);
      float dd[D], d2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dd[d] = comp(pi, d) - comp(pj, d);
        d2 += dd[d] * dd[d];
      }
      float q;
      if constexpr (D == 3) {
        const float w = 2.f / (2.f + d2);
        q = w * sqrtf(w);
      } else {
        q = 1.f / (1.f + d2);
      }
      const float p = pval[k];
      const float pq = p * q;
#pragma unroll
      for (int d = 0; d < D; ++d) a[d] += (double)(pq * dd[d]);
      if (compute_error) {
        const double qz = (double)q / Z;
        e += (double)p * log(fmax((double)p, (double)kTiny) /
                             fmax(qz, (double)kTiny));
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const double ad = warp_sum(a[d]);
      const double rd = warp_sum(
          lane < splits ? rep[((size_t)i * splits + lane) * D + d] : 0.0);
      if (lane == 0) grad[(size_t)i * D + d] = (float)(kCoef * (ad - rd / Z));
    }
    e = warp_sum(e);
  }
  if (compute_error) {
    if (lane == 0) wsum[warp] = e;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int w = 0; w < kWarpsAttract; ++w) s += wsum[w];
      err_part[blockIdx.x] = s;
    }
    if (last_block(ticket, &last)) {
      __shared__ double buf[kWarpsAttract];
      double s = 0.0;
      for (int b = threadIdx.x; b < (int)gridDim.x; b += kWarpsAttract * 32)
        s += __ldcg(err_part + b);
      s = block_sum<kWarpsAttract * 32>(s, buf);
      if (threadIdx.x == 0) err[0] = s;
    }
  }
}

}  // namespace

extern "C" int vtt_tsne_pairs(const void* y, int n, int d, int splits,
                              void* rep, void* zpart, void* z, void* ticket,
                              void* stream) {
  if (n < 2 || d < 1 || d > 3 || splits < 1 || splits > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, splits);
  const float* yy = static_cast<const float*>(y);
  double* r = static_cast<double*>(rep);
  double* zp = static_cast<double*>(zpart);
  double* zz = static_cast<double*>(z);
  unsigned* t = static_cast<unsigned*>(ticket);
  if (d == 1)
    tsne_pairs_kernel<1><<<grid, kPairThreads, 0, st>>>(yy, n, splits, r, zp,
                                                        zz, t);
  else if (d == 2)
    tsne_pairs_kernel<2><<<grid, kPairThreads, 0, st>>>(yy, n, splits, r, zp,
                                                        zz, t);
  else
    tsne_pairs_kernel<3><<<grid, kPairThreads, 0, st>>>(yy, n, splits, r, zp,
                                                        zz, t);
  return (int)cudaGetLastError();
}

extern "C" int vtt_tsne_attract(const void* y, int n, int d, int splits,
                                const void* indptr, const void* indices,
                                const void* pval, const void* rep,
                                const void* z, int compute_error, void* grad,
                                void* err_part, void* err, void* ticket,
                                void* stream) {
  if (n < 2 || d < 1 || d > 3 || splits < 1 || splits > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kWarpsAttract - 1) / kWarpsAttract;
  const float* yy = static_cast<const float*>(y);
  const int64_t* ip = static_cast<const int64_t*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const float* pv = static_cast<const float*>(pval);
  const double* r = static_cast<const double*>(rep);
  const double* zz = static_cast<const double*>(z);
  float* g = static_cast<float*>(grad);
  double* ep = static_cast<double*>(err_part);
  double* ee = static_cast<double*>(err);
  unsigned* t = static_cast<unsigned*>(ticket);
  if (d == 1)
    tsne_attract_kernel<1><<<blocks, kWarpsAttract * 32, 0, st>>>(
        yy, n, splits, ip, ix, pv, r, zz, compute_error, g, ep, ee, t);
  else if (d == 2)
    tsne_attract_kernel<2><<<blocks, kWarpsAttract * 32, 0, st>>>(
        yy, n, splits, ip, ix, pv, r, zz, compute_error, g, ep, ee, t);
  else
    tsne_attract_kernel<3><<<blocks, kWarpsAttract * 32, 0, st>>>(
        yy, n, splits, ip, ix, pv, r, zz, compute_error, g, ep, ee, t);
  return (int)cudaGetLastError();
}
