// Exact t-SNE gradient (Student-t kernel, one degree of freedom) of (n, 2)
// float32 positions, for NVIDIA Hopper (sm_90a).
//
// Replaces the gradient of sklearn's Barnes-Hut TSNE that the JAX package
// calls (velocyto_tpu/analysis.py:1070, _barnes_hut_tsne.gradient through
// _kl_divergence_bh).  It computes the theta -> 0 limit of the same
// objective: with q_ij = 1 / (1 + |y_i - y_j|^2) and Z = sum_{i != j} q_ij,
//
//   grad_i = 4 (sum_{j in P_i} p_ij q_ij (y_i - y_j)
//               - sum_{j != i} q_ij^2 (y_i - y_j) / Z)
//
// and, when asked, the KL error sum p_ij log(max(p_ij, tiny) /
// max(q_ij / Z, tiny)) over the sparse P, as sklearn's
// compute_gradient_positive does.
//
// What bounds it: the all-pairs repulsive term, n^2 pairs of ~13 FP32
// operations and one reciprocal (4e8 pairs at n = 20,000); the bytes are
// the positions and the CSR of P, a few MB.
//
// What the design does about it: tsne_repulsive_kernel is a tiled N-body
// pass.  A block holds kRows rows, one per thread, and one of kSplits
// column ranges; the column positions stream through shared memory in
// tiles, each pair costs one MUFU reciprocal (rcp.approx) and FMAs, and
// every tile's float sums are added into double per-thread accumulators.
// The split keeps ~1,300 blocks in flight at n = 20,000.  Each block writes
// its rows' partial forces and its partial sum of q; no (n, n) array
// exists.  tsne_finish_kernel then sums the partials in a fixed order
// (every block computes the same Z), runs the attractive term over the CSR
// of P, and writes the gradient and per-block KL sums.
//
// C interface (bound with ctypes): vtt_tsne_grad launches both kernels on
// the stream and returns the cudaError_t of the launches as an int.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;      // rows (threads) per block of the pair pass
constexpr int kSplits = 8;      // column ranges of the pair pass
constexpr int kFinish = 256;    // threads per block of the finish pass
constexpr float kTiny = 1.17549435e-38f;   // FLT_MIN, sklearn's FLOAT32_TINY

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

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
  return r;    // valid on thread 0
}

// blocks (row block, column split); rep holds (n, kSplits, 2) partial
// forces, zpart one partial sum of q (self pairs included) per block
__global__ void __launch_bounds__(kRows)
tsne_repulsive_kernel(const float2* __restrict__ y, int n,
                      double* __restrict__ rep, double* __restrict__ zpart) {
  __shared__ float2 tile[kRows];
  __shared__ double buf[kRows / 32];
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int split = blockIdx.y;
  const int per = (n + kSplits - 1) / kSplits;
  const int c0 = split * per, c1 = min(n, c0 + per);
  const float2 yi = i < n ? y[i] : make_float2(0.f, 0.f);
  double fx = 0.0, fy = 0.0, qs = 0.0;
  for (int t0 = c0; t0 < c1; t0 += kRows) {
    const int c = t0 + threadIdx.x;
    if (c < c1) tile[threadIdx.x] = y[c];
    __syncthreads();
    const int cnt = min(kRows, c1 - t0);
    float tx = 0.f, ty = 0.f, tq = 0.f;
#pragma unroll 8
    for (int t = 0; t < cnt; ++t) {
      const float2 yj = tile[t];
      const float dx = yi.x - yj.x, dy = yi.y - yj.y;
      const float q = rcp_approx(fmaf(dx, dx, fmaf(dy, dy, 1.f)));
      const float q2 = q * q;
      tq += q;
      tx = fmaf(q2, dx, tx);
      ty = fmaf(q2, dy, ty);
    }
    fx += tx;
    fy += ty;
    qs += tq;
    __syncthreads();
  }
  if (i < n) {
    rep[((size_t)i * kSplits + split) * 2] = fx;
    rep[((size_t)i * kSplits + split) * 2 + 1] = fy;
  }
  const double z = block_sum<kRows>(i < n ? qs : 0.0, buf);
  if (threadIdx.x == 0) zpart[blockIdx.y * gridDim.x + blockIdx.x] = z;
}

// one row per thread: Z from the partials, the attractive term over the
// CSR of P, the gradient, and the row's KL terms summed per block
__global__ void __launch_bounds__(kFinish)
tsne_finish_kernel(const float2* __restrict__ y, int n,
                   const int64_t* __restrict__ indptr,
                   const int* __restrict__ indices,
                   const float* __restrict__ pval,
                   const double* __restrict__ rep,
                   const double* __restrict__ zpart, int n_zpart,
                   int compute_error, float* __restrict__ grad,
                   double* __restrict__ err_part) {
  __shared__ double buf[kFinish / 32];
  __shared__ double z_sh;
  double z = 0.0;
  for (int b = threadIdx.x; b < n_zpart; b += kFinish) z += zpart[b];
  z = block_sum<kFinish>(z, buf);
  if (threadIdx.x == 0) z_sh = fmax(z - (double)n, DBL_EPSILON);
  __syncthreads();
  const double Z = z_sh;
  const int i = blockIdx.x * kFinish + threadIdx.x;
  double err = 0.0;
  if (i < n) {
    const float2 yi = y[i];
    double ax = 0.0, ay = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const float2 yj = y[indices[k]];
      const float dx = yi.x - yj.x, dy = yi.y - yj.y;
      const float q = 1.f / (1.f + (dx * dx + dy * dy));
      const float p = pval[k];
      const float pq = p * q;
      ax += (double)(pq * dx);
      ay += (double)(pq * dy);
      if (compute_error) {
        const double qz = (double)q / Z;
        err += (double)p * log(fmax((double)p, (double)kTiny) /
                               fmax(qz, (double)kTiny));
      }
    }
    double rx = 0.0, ry = 0.0;
#pragma unroll
    for (int s = 0; s < kSplits; ++s) {
      rx += rep[((size_t)i * kSplits + s) * 2];
      ry += rep[((size_t)i * kSplits + s) * 2 + 1];
    }
    grad[2 * i] = (float)(4.0 * (ax - rx / Z));
    grad[2 * i + 1] = (float)(4.0 * (ay - ry / Z));
  }
  if (compute_error) {
    const double e = block_sum<kFinish>(err, buf);
    if (threadIdx.x == 0) err_part[blockIdx.x] = e;
  }
}

}  // namespace

extern "C" int vtt_tsne_grad(const void* y, int n, const void* indptr,
                             const void* indices, const void* pval,
                             void* rep, void* zpart, int compute_error,
                             void* grad, void* err_part, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + kRows - 1) / kRows;
  tsne_repulsive_kernel<<<dim3(row_blocks, kSplits), kRows, 0, st>>>(
      static_cast<const float2*>(y), n, static_cast<double*>(rep),
      static_cast<double*>(zpart));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tsne_finish_kernel<<<(n + kFinish - 1) / kFinish, kFinish, 0, st>>>(
      static_cast<const float2*>(y), n, static_cast<const int64_t*>(indptr),
      static_cast<const int*>(indices), static_cast<const float*>(pval),
      static_cast<const double*>(rep), static_cast<const double*>(zpart),
      row_blocks * kSplits, compute_error, static_cast<float*>(grad),
      static_cast<double*>(err_part));
  return (int)cudaGetLastError();
}
