// Greedy degree-capped balance of a kNN graph in one launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the JAX package's device balance scan,
// velocyto_tpu/ops/knn_device.py::_balance_scan_impl (jitted XLA: a
// speculative batched while_loop), which runs the reference's numba loop
// velocyto/neighbors.py:11-140.  The semantics are those of
// ops/knn_device.py::_balance_scan_plain: the nodes are visited in the
// order lsi; a candidate is admissible when it is not the node itself,
// its in-degree l is below maxl and, when constrained, it shares the
// node's group; a node takes the first k admissible candidates of its row
// into slots 1..p in acceptance order, with their distances, and bumps l
// for each.  Slot 0 holds the node (distance 0) when it appears among the
// examined positions, those up to and including the k-th acceptance or
// the whole row when fewer are accepted, else -1 (distance 0).  Slots
// p+1..k hold the node with the distance dist[el, 0].  A row's candidates
// are distinct (they come from a kNN search), so the bumps of one node
// never meet.  An index outside [0, n) is never admissible.
//
// What bounds it: latency.  Each node's choices depend on the l left by
// every earlier node, so the n nodes form one chain; the data a node
// reads (the examined part of its row, ~k plus the rejections) is small.
//
// The design: one persistent block of kThreads threads walks the nodes.
// A node's row is scanned in chunks of kThreads candidates.  In a chunk
// each thread reads its candidate and the candidate's l; a ballot and one
// scan over the warp totals rank the admissible candidates; those of rank
// below k - (accepted so far) take their slots and bump l.  The walk stops
// at the chunk of the k-th acceptance.  A barrier closes each chunk (the
// warp totals, double-buffered) and each node (l).  While a node is
// scanned, the first chunk of the next node's row (indices and distances)
// is loaded into registers, so a node that ends in its first chunk waits
// on no device-memory load.  l lives in shared memory as uint16 where the
// in-degrees and the cells fit (balance_kernel<true>: 2 B a cell, up to
// kMaxSmem), else in an int32 array in global memory, which stays in L2
// (balance_kernel<false>): one loop, templated on where l lives.
//
// C interface (bound with ctypes): vtt_knn_balance and
// vtt_knn_balance_probe return the cudaError_t of the launch as an int; 0
// means the kernel was queued.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 224 * 1024;      // shared memory for l, bytes
constexpr int kMaxL16 = 65535;            // largest l a uint16 holds
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "the warp-total scan is one warp wide");

struct Args {
  const int64_t* dsi;     // (n, sight) candidates of each row, in order
  const double* dist;     // (n, sight) their distances
  const int64_t* lsi;     // (n,) visit order
  const int* cst;         // (n,) group of each cell, or null
  int64_t* idx_out;       // (n, k + 1) dsi_new
  double* dist_out;       // (n, k + 1) dist_new
  int64_t* l_out;         // (n,) final in-degrees
  int n, sight, maxl, k;
};

// (admissible flags before this thread, admissible flags in the block) for
// the block's flags: a ballot, the warp totals through shared memory, one
// barrier, and a shuffle scan of the totals on every warp.
__device__ __forceinline__ int2 block_rank(bool flag, int* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, flag);
  if (lane == 0) wtot[warp] = __popc(m);
  __syncthreads();
  int v = wtot[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  const int before = __shfl_sync(kFull, v, warp) - __popc(m) +
                     __popc(m & ((1u << lane) - 1u));
  return make_int2(before, __shfl_sync(kFull, v, 31));
}

__device__ __forceinline__ bool is_cell(int64_t v, int n) {
  return v >= 0 && v < n;
}

// The walk over the nodes, with l in the memory `l` points to (shared
// uint16 or global int32).  wtot2: two buffers of kWarps ints.
template <class LT>
__device__ void balance_loop(const Args& a, LT* l, int* wtot2) {
  const int t = threadIdx.x;
  const int64_t S = a.sight, kw = (int64_t)a.k + 1;
  for (int i = t; i < a.n; i += kThreads) l[i] = 0;
  // the next node, the one after, and the first chunk of the next row
  int64_t el_next = a.lsi[0];
  int64_t el_after = a.n > 1 ? a.lsi[1] : -1;
  int64_t c_next = -1;
  double d_next = 0.0;
  if (is_cell(el_next, a.n) && t < a.sight) {
    c_next = a.dsi[el_next * S + t];
    d_next = a.dist[el_next * S + t];
  }
  __syncthreads();                                  // l is zero
  int buf = 0;
  for (int i = 0; i < a.n; ++i) {
    const int64_t el = el_next;
    int64_t c = c_next;
    double d = d_next;
    el_next = el_after;
    if (i + 1 < a.n && is_cell(el_next, a.n) && t < a.sight) {
      c_next = a.dsi[el_next * S + t];
      d_next = a.dist[el_next * S + t];
    }
    if (i + 2 < a.n) el_after = a.lsi[i + 2];
    if (!is_cell(el, a.n)) continue;                // the same on every thread
    const int group = a.cst ? a.cst[el] : 0;
    int64_t* irow = a.idx_out + el * kw;
    double* drow = a.dist_out + el * kw;
    if (t == 0) {                    // before the first chunk's barrier
      irow[0] = -1;
      drow[0] = 0.0;
    }
    int acc = 0;
    for (int base = 0; acc < a.k && base < a.sight; base += kThreads) {
      const int j = base + t;
      if (base > 0) {
        c = j < a.sight ? a.dsi[el * S + j] : -1;
        d = j < a.sight ? a.dist[el * S + j] : 0.0;
      }
      const bool cell = is_cell(c, a.n);     // false past the row's end
      int lv = 0;
      bool ok = false;
      if (cell && c != el) {
        lv = (int)l[c];
        ok = lv < a.maxl && (a.cst == nullptr || a.cst[c] == group);
      }
      const int2 r = block_rank(ok, wtot2 + buf * kWarps);
      // admissible candidates before this position, in the whole row
      const int rank = acc + r.x;
      if (ok && rank < a.k) {
        irow[rank + 1] = c;
        drow[rank + 1] = d;
        l[c] = (LT)(lv + 1);
      }
      if (cell && c == el && rank < a.k) irow[0] = el;   // examined
      acc += r.y;
      buf ^= 1;
    }
    if (acc < a.k) {                                   // sight exhausted
      const double d0 = a.dist[el * S];
      for (int s = acc + 1 + t; s <= a.k; s += kThreads) {
        irow[s] = el;
        drow[s] = d0;
      }
    }
    __syncthreads();               // the next node reads l as this one left it
  }
  for (int i = t; i < a.n; i += kThreads) a.l_out[i] = (int64_t)l[i];
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
balance_kernel(Args a, int* l_global) {
  __shared__ int wtot2[2 * kWarps];
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kSmem)
    balance_loop(a, reinterpret_cast<uint16_t*>(smem), wtot2);
  else
    balance_loop(a, l_global, wtot2);
}

// reps dependent steps of what chains one node to the next when its first
// chunk ends it: a load of l at an address that depends on the step
// before, a ballot, the chunk's barrier and scan, a store to l and the
// node's barrier.  With rows (n, sight) given, each step r first reads its
// chunk of row r * 7919 mod n (a permutation of the rows unless 7919
// divides n, so no row is read twice and none waits in L2), its address
// made to depend on the step before, as a node reads its row when
// nothing was loaded ahead.  Timed, it gives the scan's latency floor.
// n >= kThreads.
template <class LT>
__device__ void probe_loop(LT* w, int n, int reps, const int64_t* rows,
                           int sight, int64_t* out, int* wtot2) {
  const int t = threadIdx.x;
  for (int i = t; i < n; i += kThreads) w[i] = 0;
  __syncthreads();
  int h = 0, buf = 0;
  for (int r = 0; r < reps; ++r) {
    int c = h + t;
    if (c >= n) c -= n;
    bool ok = true;
    if (rows != nullptr && t < sight) {
      const int64_t row = (int64_t)r * 7919 % n + (h >> 31);   // h >= 0
      ok = rows[row * sight + t] >= 0;
    }
    const int lv = (int)w[c];
    ok = ok && lv < kMaxL16;
    const int2 s = block_rank(ok, wtot2 + buf * kWarps);
    if (ok) w[c] = (LT)(lv + 1);
    h += s.y;
    if (h >= n) h -= n;
    buf ^= 1;
    __syncthreads();
  }
  if (t == 0) out[0] = h;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
balance_probe_kernel(int* w_global, int n, int reps, const int64_t* rows,
                     int sight, int64_t* out) {
  __shared__ int wtot2[2 * kWarps];
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kSmem)
    probe_loop(reinterpret_cast<uint16_t*>(smem), n, reps, rows, sight, out,
               wtot2);
  else
    probe_loop(w_global, n, reps, rows, sight, out, wtot2);
}

// dynamic shared memory for n uint16 values, or 0 where they do not fit
size_t smem_bytes(int n) {
  const size_t b = ((size_t)n * 2 + 15) / 16 * 16;
  return b <= (size_t)kMaxSmem ? b : 0;
}

template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// shared = 1 keeps l in shared memory and refuses (cudaErrorInvalidValue)
// a size it does not fit (more than kMaxSmem, or an l above kMaxL16);
// shared = 0 keeps it in l_work, n int32 values.  maxl in [0, n].
extern "C" int vtt_knn_balance(const void* dsi, const void* dist,
                               const void* lsi, const void* cst,
                               void* l_work, void* idx_out, void* dist_out,
                               void* l_out, int n, int sight, int maxl,
                               int k, int shared, void* stream) {
  if (n < 1 || k < 0 || sight < k || maxl < 0 || maxl > n)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int64_t*>(dsi), static_cast<const double*>(dist),
         static_cast<const int64_t*>(lsi), static_cast<const int*>(cst),
         static_cast<int64_t*>(idx_out),  static_cast<double*>(dist_out),
         static_cast<int64_t*>(l_out),    n, sight, maxl, k};
  const auto st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t bytes = smem_bytes(n);
    const int top = maxl < n - 1 ? maxl : n - 1;      // l never passes it
    if (bytes == 0 || top > kMaxL16) return (int)cudaErrorInvalidValue;
    const int e = allow_smem(balance_kernel<true>, bytes);
    if (e != 0) return e;
    balance_kernel<true><<<1, kThreads, bytes, st>>>(a, nullptr);
  } else {
    if (l_work == nullptr) return (int)cudaErrorInvalidValue;
    balance_kernel<false><<<1, kThreads, 0, st>>>(
        a, static_cast<int*>(l_work));
  }
  return (int)cudaGetLastError();
}

// shared = 0 needs w_work, n int32 values; rows, (n, sight) int64, may be
// null.
extern "C" int vtt_knn_balance_probe(void* w_work, int n, int reps,
                                     const void* rows, int sight, int shared,
                                     void* out, void* stream) {
  if (n < kThreads || reps < 1 || (rows != nullptr && sight < 1))
    return (int)cudaErrorInvalidValue;
  const auto rw = static_cast<const int64_t*>(rows);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<int64_t*>(out);
  if (shared) {
    const size_t bytes = smem_bytes(n);
    if (bytes == 0) return (int)cudaErrorInvalidValue;
    const int e = allow_smem(balance_probe_kernel<true>, bytes);
    if (e != 0) return e;
    balance_probe_kernel<true><<<1, kThreads, bytes, st>>>(nullptr, n, reps,
                                                          rw, sight, o);
  } else {
    if (w_work == nullptr) return (int)cudaErrorInvalidValue;
    balance_probe_kernel<false><<<1, kThreads, 0, st>>>(
        static_cast<int*>(w_work), n, reps, rw, sight, o);
  }
  return (int)cudaGetLastError();
}
