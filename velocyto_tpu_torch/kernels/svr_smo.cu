// libsvm's epsilon-SVR SMO solver (RBF kernel, one feature) in one launch,
// for NVIDIA Hopper (sm_90a).
//
// Replaces sklearn's SVR in the JAX package (velocyto_tpu/analysis.py:331,
// the CV-vs-mean fit of score_cv_vs_mean, and :650, the totals fit of
// adjust_totS_totU), which runs libsvm's Solver on the CPU.  The kernel
// follows that solver step by step (ops/svr.py lists what it keeps): the
// 2l variables of SVR_Q, float32 kernel columns computed in float64 as
// exp(-gamma ((x_i^2 + x_j^2) - 2 x_i x_j)), G and G_bar in float64,
// working-set selection with the second-order j and ties going to the
// last index in active order, shrinking every min(2l, 1000) iterations
// with libsvm's swap order, the unshrink at 10 tol, the gradient
// reconstruction, and rho from a sequential sum.  Every product that
// libsvm adds to something is written with __dmul_rn / __dadd_rn, which
// the compiler never fuses into an FMA, so each rounds as libsvm does.
//
// What bounds it: latency.  The loop is sequential, 5k-26k iterations at
// the sizes velocyto fits, each a few dependent passes over the active
// set.  A plain torch loop pays several launches and a host sync per
// iteration.
//
// The design: one thread-block cluster of kCluster blocks on as many SMs.
// Thread t of block b owns the positions k = b kThreads + t (mod the
// cluster's threads), so the active prefix stays evenly split as
// shrinking cuts it.  The state the loop reads every iteration (G, G_bar,
// alpha, x, column i of Q, the flags: kSlotBytes a position) lives in each
// block's shared memory where the cluster holds it (kMaxSmem a block, up
// to l = 40,960), else in the global arrays, in the same loop
// (svr_smo_kernel<false>); p and the active-set map stay in global memory,
// touched only by shrinking and reconstruction.  A working-set selection
// reduces each block's positions; the warp owning the block's winner
// pushes it, with the winner's state, into every block's inbox through
// distributed shared memory; after one cluster barrier every block
// reduces its inbox in rank order and reaches the same (i, j): the
// (value, index) reductions with ties to the last index are associative
// and commutative, so the choice is libsvm's.  Every thread runs the
// two-variable step on the same inputs, so nothing else is broadcast.
// The G update of one iteration also computes the next iteration's Gmax
// candidates (two passes per iteration, not three) except where shrinking
// follows.  Shrinking and reconstruction work on global memory across the
// cluster (libsvm's swap order from two cluster-wide scans), the shared
// state written out before and read back after.
//
// C interface (bound with ctypes): vtt_svr_smo and vtt_svr_sync_probe
// return the cudaError_t of the launch as an int; 0 means the kernel was
// queued.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;                   // blocks (non-portable size)
constexpr int kSlotBytes = 4 * 8 + 4 + 1;      // shared state a position
constexpr int kMaxSmem = 200 * 1024;           // of it, a block at most
constexpr double kTau = 1e-12;
// per-position flags: the status in the low two bits, the sign in bit 2
constexpr uint8_t kLower = 0, kUpper = 1, kFree = 2, kStatus = 3, kPos = 4;

struct State {
  double* G;
  double* Gbar;
  double* alpha;
  double* p;
  double* x;      // the sample of each position
  uint8_t* f;     // status and sign
  int* aset;      // original position (libsvm's active_set)
  float* qi;      // column i of Q (the global-memory form only)
  int* posL;      // shrinking: k-th shrinkable position from the left
  int* posR;      // shrinking: k-th kept position from the right
  int L;
  double C, gamma, eps;
};

struct ArgBest {
  double v;
  int i;
};

struct Select2 {   // second pass of the working-set selection
  ArgBest m;       // min obj_diff, last index on ties
  double g;        // Gmax2
};

struct Rho {
  double ub, lb;
  int n_free;
};

__device__ __forceinline__ double shfl(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ int shfl(int v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ ArgBest shfl(ArgBest v, int o) {
  return {shfl(v.v, o), shfl(v.i, o)};
}
__device__ __forceinline__ double2 shfl(double2 v, int o) {
  return make_double2(shfl(v.x, o), shfl(v.y, o));
}
__device__ __forceinline__ Select2 shfl(Select2 v, int o) {
  return {shfl(v.m, o), shfl(v.g, o)};
}
__device__ __forceinline__ Rho shfl(Rho v, int o) {
  return {shfl(v.ub, o), shfl(v.lb, o), shfl(v.n_free, o)};
}

// libsvm scans with `>=` (max) and `<=` (min): among equal values the last
// index in active order wins
__device__ __forceinline__ ArgBest later_max(ArgBest a, ArgBest b) {
  return (b.v > a.v || (b.v == a.v && b.i > a.i)) ? b : a;
}
__device__ __forceinline__ ArgBest later_min(ArgBest a, ArgBest b) {
  return (b.v < a.v || (b.v == a.v && b.i > a.i)) ? b : a;
}

struct MaxOp {
  __device__ ArgBest operator()(ArgBest a, ArgBest b) const {
    return later_max(a, b);
  }
};
struct Select2Op {
  __device__ Select2 operator()(Select2 a, Select2 b) const {
    return {later_min(a.m, b.m), fmax(a.g, b.g)};
  }
};
struct Max2Op {
  __device__ double2 operator()(double2 a, double2 b) const {
    return make_double2(fmax(a.x, b.x), fmax(a.y, b.y));
  }
};
struct RhoOp {
  __device__ Rho operator()(Rho a, Rho b) const {
    return {fmin(a.ub, b.ub), fmax(a.lb, b.lb), a.n_free + b.n_free};
  }
};

// Reduce v over the block; every thread gets the result.  buf holds
// kWarps values of T; `id` is the identity of op.
template <class T, class Op>
__device__ T block_reduce(T v, Op op, T id, T* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl(v, o));
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? buf[lane] : id;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, shfl(v, o));
    if (lane == 0) buf[0] = v;
  }
  __syncthreads();
  const T r = buf[0];
  __syncthreads();
  return r;
}

// Reduce v over the block; every thread gets the result.  Two barrier-free
// shuffle levels around one __syncthreads: wbuf may be written again only
// after a barrier that every thread passes after reading it (each caller
// below reaches a cluster barrier first).
template <class T, class Op>
__device__ T block_all(T v, Op op, T id, T* wbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl(v, o));
  if (lane == 0) wbuf[warp] = v;
  __syncthreads();
  v = lane < kWarps ? wbuf[lane] : id;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl(v, o));
  return v;
}

// Exclusive prefix sum of one int per thread, and the total.
__device__ int block_scan(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kWarps) buf[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int before = (warp ? buf[warp - 1] : 0) + incl - v;
  *total = buf[kWarps - 1];
  __syncthreads();
  return before;
}

// Q[c][k] as SVR_Q::get_Q gives it: the kernel of the two samples in
// float64 from their squares and product, rounded to float, with the
// product of the two signs.
__device__ __forceinline__ float q_entry(double xc, bool pc, double xk,
                                         bool pk, double gamma) {
  const double sq = __dadd_rn(__dmul_rn(xc, xc), __dmul_rn(xk, xk));
  const double d2 = __dsub_rn(sq, __dmul_rn(2.0, __dmul_rn(xc, xk)));
  const float k = (float)exp(-gamma * d2);
  return pc == pk ? k : -k;
}

__device__ __forceinline__ bool is_pos(uint8_t f) { return f & kPos; }
__device__ __forceinline__ int status_of(uint8_t f) { return f & kStatus; }

__device__ __forceinline__ bool be_shrunk(const State& s, int k, double gmax1,
                                          double gmax2) {
  const uint8_t f = s.f[k];
  const double g = s.G[k];
  const int st = status_of(f);
  if (st == kUpper) return is_pos(f) ? -g > gmax1 : -g > gmax2;
  if (st == kLower) return is_pos(f) ? g > gmax2 : g > gmax1;
  return false;
}

__device__ void swap_positions(const State& s, int a, int b) {
  double t;
  t = s.G[a]; s.G[a] = s.G[b]; s.G[b] = t;
  t = s.Gbar[a]; s.Gbar[a] = s.Gbar[b]; s.Gbar[b] = t;
  t = s.alpha[a]; s.alpha[a] = s.alpha[b]; s.alpha[b] = t;
  t = s.p[a]; s.p[a] = s.p[b]; s.p[b] = t;
  t = s.x[a]; s.x[a] = s.x[b]; s.x[b] = t;
  const uint8_t f = s.f[a]; s.f[a] = s.f[b]; s.f[b] = f;
  const int i = s.aset[a]; s.aset[a] = s.aset[b]; s.aset[b] = i;
}

// The two-variable step of Solver::Solve: ai, aj (alpha_i, alpha_j) moved
// along the constraint and clipped to [0, C], in libsvm's order; opposite
// when the two positions carry opposite signs.
__device__ __forceinline__ void two_variable_step(double C, double Gi,
                                                  double Gj, float qij,
                                                  bool opposite, double& ai,
                                                  double& aj) {
  if (opposite) {
    double quad = (1.0 + 1.0) + (double)(2 * qij);
    if (quad <= 0) quad = kTau;
    const double delta = (-Gi - Gj) / quad;
    const double diff = ai - aj;
    ai += delta;
    aj += delta;
    if (diff > 0) {
      if (aj < 0) { aj = 0; ai = diff; }
    } else {
      if (ai < 0) { ai = 0; aj = -diff; }
    }
    if (diff > C - C) {
      if (ai > C) { ai = C; aj = C - diff; }
    } else {
      if (aj > C) { aj = C; ai = C + diff; }
    }
  } else {
    double quad = (1.0 + 1.0) - (double)(2 * qij);
    if (quad <= 0) quad = kTau;
    const double delta = (Gi - Gj) / quad;
    const double sum = ai + aj;
    ai -= delta;
    aj += delta;
    if (sum > C) {
      if (ai > C) { ai = C; aj = sum - C; }
    } else {
      if (aj < 0) { aj = 0; ai = sum; }
    }
    if (sum > C) {
      if (aj > C) { aj = C; ai = sum - C; }
    } else {
      if (ai < 0) { ai = 0; aj = sum; }
    }
  }
}

// Solver::calculate_rho over the first `active` positions in global
// memory, on one block: the bounds by a block reduction, libsvm's
// sequential sum of the free variables' y G on thread 0.  Valid on
// thread 0.
__device__ double calculate_rho(const State& s, int active, double4* red,
                                int* list, double* vals) {
  Rho r{CUDART_INF, -CUDART_INF, 0};
  for (int k = threadIdx.x; k < active; k += kThreads) {
    const uint8_t f = s.f[k];
    const int st = status_of(f);
    const double yG = is_pos(f) ? s.G[k] : -s.G[k];
    if (st == kUpper) {
      if (is_pos(f)) r.lb = fmax(r.lb, yG); else r.ub = fmin(r.ub, yG);
    } else if (st == kLower) {
      if (is_pos(f)) r.ub = fmin(r.ub, yG); else r.lb = fmax(r.lb, yG);
    } else {
      ++r.n_free;
    }
  }
  r = block_reduce(r, RhoOp(), Rho{CUDART_INF, -CUDART_INF, 0},
                   reinterpret_cast<Rho*>(red));
  double sum_free = 0.0;                  // sequential, as libsvm sums
  if (r.n_free > 0) {
    for (int base = 0; base < active; base += kThreads) {
      const int k = base + threadIdx.x;
      const bool fr = k < active && status_of(s.f[k]) == kFree;
      vals[threadIdx.x] = fr ? (is_pos(s.f[k]) ? s.G[k] : -s.G[k]) : 0.0;
      list[threadIdx.x] = fr;
      __syncthreads();
      if (threadIdx.x == 0) {
        const int n = min(kThreads, active - base);
        for (int t = 0; t < n; ++t)
          if (list[t]) sum_free += vals[t];
      }
      __syncthreads();
    }
  }
  return r.n_free > 0 ? sum_free / r.n_free : (r.ub + r.lb) / 2;
}

// One block's entry of a cluster-wide reduction: the block's best (v, k)
// and, from the thread owning k, that position's state at the time of the
// reduction.  Pushed into every block's inbox, so the picks read local
// shared memory only.
struct __align__(16) Part {
  double v, g2;          // value; Gmax2 of the block (or a second max)
  double G, x, alpha;    // the winner's state
  float q;               // Q_ij at the winner (the selection's second pass)
  int k;                 // the winner, -1 for none; a count in scans
  int f;                 // the winner's flags
};

struct Cluster {
  cg::cluster_group g;
  int rank, size, nt;    // this block's rank, blocks, threads in the cluster
  int buf;               // which of the two inboxes is next
  Part (*inbox)[kCluster];   // this block's two inboxes, one entry a rank

  // The inbox of the next reduction.  Two alternate: a block pushes into
  // inbox b again only after the next reduction's cluster barrier, which
  // every block reaches after reading b.
  __device__ Part* next() {
    Part* p = inbox[buf];
    buf ^= 1;
    return p;
  }
  // the position of this thread's m-th slot
  __device__ int pos(int m) const {
    return m * nt + rank * kThreads + (int)threadIdx.x;
  }
  // whether this thread owns position k, and its slot
  __device__ bool owns(int k) const {
    return k >= 0 && (k % nt) == rank * kThreads + (int)threadIdx.x;
  }
  __device__ int slot(int k) const {
    return (k / nt) * kThreads + (int)threadIdx.x;
  }
  // Called by a whole warp with e valid in lane src: lane r < size stores
  // e into entry `rank` of inbox p of block r.
  __device__ void push(Part* p, Part e, int src) const {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    e.v = __shfl_sync(full, e.v, src);
    e.g2 = __shfl_sync(full, e.g2, src);
    e.G = __shfl_sync(full, e.G, src);
    e.x = __shfl_sync(full, e.x, src);
    e.alpha = __shfl_sync(full, e.alpha, src);
    e.q = __shfl_sync(full, e.q, src);
    e.k = __shfl_sync(full, e.k, src);
    e.f = __shfl_sync(full, e.f, src);
    if (lane < size) *g.map_shared_rank(p + rank, lane) = e;
  }
};

__device__ Cluster this_cluster(Part (*inbox)[kCluster]) {
  Cluster c{cg::this_cluster(), 0, 0, 0, 0, inbox};
  c.rank = (int)c.g.block_rank();
  c.size = (int)c.g.num_blocks();
  c.nt = c.size * kThreads;
  return c;
}

// The per-position state the loop reads every iteration.  kSmem: in the
// block's shared memory, the m-th position a thread owns at slot
// m kThreads + t; otherwise the State's own arrays, at the position.
template <bool kSmem>
struct Held {
  double* G;
  double* Gbar;
  double* alpha;
  double* x;
  float* qi;       // column i of Q over the active set
  uint8_t* f;
  // where the m-th position of this thread, k, is held
  __device__ int at(int m, int k) const {
    return kSmem ? m * kThreads + (int)threadIdx.x : k;
  }
  // where position k, owned by this thread, is held
  __device__ int of(const Cluster& c, int k) const {
    return kSmem ? c.slot(k) : k;
  }
};

// Every warp reduces the entries of inbox p in rank order (later_min or
// later_max on (v, k), fmax on g2); the winner's state comes from its
// entry.
template <bool kMin>
__device__ Part cluster_pick(const Cluster& c, const Part* p) {
  const int lane = threadIdx.x & 31;
  ArgBest a{kMin ? CUDART_INF : -CUDART_INF, -1};
  double g2 = -CUDART_INF;
  if (lane < c.size) {
    a = ArgBest{p[lane].v, p[lane].k};
    g2 = p[lane].g2;
  }
  const int k_lane = a.i;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = kMin ? later_min(a, shfl(a, o)) : later_max(a, shfl(a, o));
    g2 = fmax(g2, shfl(g2, o));
  }
  const unsigned m =
      __ballot_sync(0xffffffffu, lane < c.size && k_lane == a.i);
  Part r = p[m ? __ffs(m) - 1 : 0];
  r.v = a.v;
  r.k = a.i;
  r.g2 = g2;
  return r;
}

// Push this block's winner (v, k) of a reduction: the warp of the thread
// owning k (warp 0 when k < 0) pushes e, built by that thread, into every
// block's inbox p.  `build` fills e's state of position k.
template <class Build>
__device__ void push_winner(const Cluster& c, Part* p, double v, double g2,
                            int k, Build build) {
  const int owner = k < 0 ? 0 : k % kThreads;
  if ((int)(threadIdx.x >> 5) != (owner >> 5)) return;
  Part e{};
  e.v = v;
  e.g2 = g2;
  e.k = k;
  if (k >= 0 && c.owns(k)) build(e, k);
  c.push(p, e, owner & 31);
}

// Exclusive prefix over the cluster's threads, in (rank, thread) order, of
// one int per thread; total gets the sum over the cluster.
__device__ int cluster_scan(Cluster& c, int v, int* ibuf, int* total) {
  int block_total;
  const int before = block_scan(v, ibuf, &block_total);
  Part* p = c.next();
  if (threadIdx.x < 32) {
    Part e{};
    e.k = block_total;
    c.push(p, e, 0);
  }
  c.g.sync();
  int off = 0, sum = 0;
  for (int r = 0; r < c.size; ++r) {
    if (r < c.rank) off += p[r].k;
    sum += p[r].k;
  }
  *total = sum;
  return off + before;
}

// shared state -> global memory and back, over every position this thread
// owns (nothing to do where the state is the global arrays)
template <bool S>
__device__ void spill(const Cluster& c, const State& s, const Held<S>& h) {
  if (!S) return;
  for (int m = 0;; ++m) {
    const int k = c.pos(m);
    if (k >= s.L) break;
    const int sl = h.at(m, k);
    s.G[k] = h.G[sl];
    s.Gbar[k] = h.Gbar[sl];
    s.alpha[k] = h.alpha[sl];
    s.f[k] = h.f[sl];
  }
}
template <bool S>
__device__ void fill(const Cluster& c, const State& s, const Held<S>& h) {
  if (!S) return;
  for (int m = 0;; ++m) {
    const int k = c.pos(m);
    if (k >= s.L) break;
    const int sl = h.at(m, k);
    h.G[sl] = s.G[k];
    h.Gbar[sl] = s.Gbar[k];
    h.alpha[sl] = s.alpha[k];
    h.x[sl] = s.x[k];
    h.f[sl] = s.f[k];
  }
}

// The cluster's contiguous segment of [0, n) for this thread, in (rank,
// thread) order.
__device__ void segment(const Cluster& c, int n, int& lo, int& hi) {
  const int seg = (n + c.nt - 1) / c.nt;
  lo = min(n, (c.rank * kThreads + (int)threadIdx.x) * seg);
  hi = min(n, lo + seg);
}

// Solver::reconstruct_gradient on the state in global memory: the free
// positions of the active set listed in active order (in s.posL), then G
// of each inactive position summed over them in that order.
__device__ void reconstruct(Cluster& c, const State& s, int active,
                            int* ibuf, long long& evals) {
  if (active == s.L) return;
  int lo, hi;
  segment(c, active, lo, hi);
  int cnt = 0;
  for (int k = lo; k < hi; ++k) cnt += status_of(s.f[k]) == kFree;
  int n_free;
  int at = cluster_scan(c, cnt, ibuf, &n_free);
  for (int k = lo; k < hi; ++k)
    if (status_of(s.f[k]) == kFree) s.posL[at++] = k;
  c.g.sync();
  for (int k = active + c.rank * kThreads + threadIdx.x; k < s.L; k += c.nt) {
    const double xk = s.x[k];
    const bool pk = is_pos(s.f[k]);
    double g = s.Gbar[k] + s.p[k];
    for (int m = 0; m < n_free; ++m) {
      const int c2 = s.posL[m];
      const float q = q_entry(s.x[c2], is_pos(s.f[c2]), xk, pk, s.gamma);
      ++evals;
      g = __dadd_rn(g, __dmul_rn(s.alpha[c2], (double)q));
    }
    s.G[k] = g;
  }
  c.g.sync();
}

// Solver::do_shrinking across the cluster; returns the new active size.
template <bool S>
__device__ int shrink(Cluster& c, const State& s, const Held<S>& h,
                      int active, bool& unshrink, int* ibuf, double2* wbuf,
                      long long& evals) {
  double2 m = make_double2(-CUDART_INF, -CUDART_INF);   // Gmax1, Gmax2
  for (int mm = 0;; ++mm) {
    const int k = c.pos(mm);
    if (k >= active) break;
    const int sl = h.at(mm, k);
    const uint8_t f = h.f[sl];
    const int st = status_of(f);
    const double g = h.G[sl];
    if (is_pos(f)) {
      if (st != kUpper) m.x = fmax(m.x, -g);
      if (st != kLower) m.y = fmax(m.y, g);
    } else {
      if (st != kUpper) m.y = fmax(m.y, -g);
      if (st != kLower) m.x = fmax(m.x, g);
    }
  }
  m = block_all(m, Max2Op(), make_double2(-CUDART_INF, -CUDART_INF), wbuf);
  Part* p = c.next();
  if (threadIdx.x < 32) {
    Part e{};
    e.v = m.x;
    e.g2 = m.y;
    c.push(p, e, 0);
  }
  spill(c, s, h);
  c.g.sync();
  for (int r = 0; r < c.size; ++r) {
    m.x = fmax(m.x, p[r].v);
    m.y = fmax(m.y, p[r].g2);
  }
  if (!unshrink && m.x + m.y <= s.eps * 10) {
    unshrink = true;
    reconstruct(c, s, active, ibuf, evals);
    active = s.L;
  }
  // libsvm's loop swaps the k-th shrinkable position from the left with
  // the k-th kept one from the right while the first lies left of the
  // second; rank both over contiguous segments, then swap the pairs
  int lo, hi;
  segment(c, active, lo, hi);
  int cnt = 0;
  for (int k = lo; k < hi; ++k) cnt += be_shrunk(s, k, m.x, m.y);
  int n_shrunk;
  int rs = cluster_scan(c, cnt, ibuf, &n_shrunk);
  const int n_kept = active - n_shrunk;
  int rk = lo - rs;
  for (int k = lo; k < hi; ++k) {
    if (be_shrunk(s, k, m.x, m.y)) s.posL[rs++] = k;
    else s.posR[n_kept - 1 - rk++] = k;
  }
  c.g.sync();
  const int pairs = min(n_shrunk, n_kept);
  for (int t = c.rank * kThreads + threadIdx.x; t < pairs; t += c.nt) {
    const int a = s.posL[t], b = s.posR[t];
    if (a < b) swap_positions(s, a, b);
  }
  c.g.sync();
  fill(c, s, h);
  return n_kept;
}

// Solver::select_working_set across the cluster: true with the winners'
// entries wi (i, Gmax, its state) and wj (j, Gmax2, its state, Q_ij), or
// false when optimal.  b1, when have1, is this thread's Gmax candidate
// from the fused update; otherwise the first pass runs here.  Leaves
// column i over the active set in h.qi.
template <bool S>
__device__ bool select_ws(Cluster& c, const State& s, const Held<S>& h,
                          int active, bool have1, ArgBest b1, ArgBest* w1,
                          Select2* w2, Part& wi, Part& wj, long long& evals) {
  ArgBest best = have1 ? b1 : ArgBest{-CUDART_INF, -1};
  if (!have1) {
    for (int m = 0;; ++m) {
      const int k = c.pos(m);
      if (k >= active) break;
      const int sl = h.at(m, k);
      const uint8_t f = h.f[sl];
      const int st = status_of(f);
      if (is_pos(f) ? st != kUpper : st != kLower) {
        const double g = h.G[sl];
        best = later_max(best, {is_pos(f) ? -g : g, k});
      }
    }
  }
  best = block_all(best, MaxOp(), ArgBest{-CUDART_INF, -1}, w1);
  Part* p = c.next();
  push_winner(c, p, best.v, -CUDART_INF, best.i, [&](Part& e, int k) {
    const int sl = h.of(c, k);
    e.G = h.G[sl];
    e.x = h.x[sl];
    e.f = h.f[sl];
    e.alpha = h.alpha[sl];
  });
  c.g.sync();
  wi = cluster_pick<false>(c, p);
  if (wi.k < 0) return false;        // Gmax = -inf: no j qualifies
  const double gmax = wi.v, xi = wi.x;
  const bool pi = is_pos((uint8_t)wi.f);
  const double yi = pi ? 1.0 : -1.0;
  Select2 acc{{CUDART_INF, -1}, -CUDART_INF};
  for (int m = 0;; ++m) {
    const int k = c.pos(m);
    if (k >= active) break;
    const int sl = h.at(m, k);
    const uint8_t f = h.f[sl];
    const int st = status_of(f);
    const double g = h.G[sl];
    const float q = q_entry(xi, pi, h.x[sl], is_pos(f), s.gamma);
    ++evals;
    h.qi[sl] = q;
    double grad_diff, quad;
    if (is_pos(f)) {
      if (st == kLower) continue;
      grad_diff = gmax + g;
      acc.g = fmax(acc.g, g);
      quad = __dsub_rn(1.0 + 1.0, __dmul_rn(2.0 * yi, (double)q));
    } else {
      if (st == kUpper) continue;
      grad_diff = gmax - g;
      acc.g = fmax(acc.g, -g);
      quad = __dadd_rn(1.0 + 1.0, __dmul_rn(2.0 * yi, (double)q));
    }
    if (grad_diff > 0) {
      const double obj = -(grad_diff * grad_diff) / (quad > 0 ? quad : kTau);
      acc.m = later_min(acc.m, {obj, k});
    }
  }
  acc = block_all(acc, Select2Op(), Select2{{CUDART_INF, -1}, -CUDART_INF},
                  w2);
  p = c.next();
  push_winner(c, p, acc.m.v, acc.g, acc.m.i, [&](Part& e, int k) {
    const int sl = h.of(c, k);
    e.G = h.G[sl];
    e.x = h.x[sl];
    e.f = h.f[sl];
    e.q = h.qi[sl];
    e.alpha = h.alpha[sl];
  });
  c.g.sync();
  wj = cluster_pick<true>(c, p);
  return !(gmax + wj.g2 < s.eps || wj.k < 0);
}

// The two-variable step of Solver::Solve, on every thread from the same
// entries, then G over the active set and, where a bound changed, G_bar
// over all positions.  With fuse, returns this thread's Gmax candidate
// over the updated G (the next selection's first pass).
template <bool S>
__device__ ArgBest update(const Cluster& c, const State& s, const Held<S>& h,
                          int active, const Part& wi, const Part& wj,
                          bool fuse, long long& evals) {
  const double C = s.C;
  const int i = wi.k, j = wj.k;
  const bool pi = is_pos((uint8_t)wi.f), pj = is_pos((uint8_t)wj.f);
  const double Gi = wi.G, Gj = wj.G;
  const double ai0 = wi.alpha, aj0 = wj.alpha;
  const float qij = wj.q;
  double ai = ai0, aj = aj0;
  two_variable_step(C, Gi, Gj, qij, pi != pj, ai, aj);
  const double dai = ai - ai0, daj = aj - aj0;
  int ch[2];   // +1: became upper bound (G_bar += C Q), -1: left it
  {
    const int idx[2] = {i, j};
    const double a[2] = {ai, aj};
    const int fl[2] = {wi.f, wj.f};
    for (int t = 0; t < 2; ++t) {
      const bool was_upper = status_of((uint8_t)fl[t]) == kUpper;
      const uint8_t st = a[t] >= C ? kUpper : (a[t] <= 0 ? kLower : kFree);
      ch[t] = was_upper == (st == kUpper) ? 0 : (was_upper ? -1 : 1);
      if (c.owns(idx[t])) {      // the owner keeps the new state
        const int sl = h.of(c, idx[t]);
        h.alpha[sl] = a[t];
        h.f[sl] = (uint8_t)((fl[t] & kPos) | st);
      }
    }
  }
  const int ci = ch[0], cj = ch[1];
  const double xi = wi.x, xj = wj.x;
  const int hi = (ci || cj) ? s.L : active;
  ArgBest best{-CUDART_INF, -1};
  for (int m = 0;; ++m) {
    const int k = c.pos(m);
    if (k >= hi) break;
    const int sl = h.at(m, k);
    const double xk = h.x[sl];
    const uint8_t fk = h.f[sl];
    const bool pk = is_pos(fk);
    const bool in_active = k < active;
    float qj = 0.f;
    if (in_active || cj) {
      qj = q_entry(xj, pj, xk, pk, s.gamma);
      ++evals;
    }
    if (in_active) {
      const double g = __dadd_rn(
          h.G[sl], __dadd_rn(__dmul_rn((double)h.qi[sl], dai),
                             __dmul_rn((double)qj, daj)));
      h.G[sl] = g;
      const int st = status_of(fk);
      if (fuse && (pk ? st != kUpper : st != kLower))
        best = later_max(best, {pk ? -g : g, k});
    }
    if (ci || cj) {
      double gb = h.Gbar[sl];
      if (ci) {
        float qik;
        if (in_active) {
          qik = h.qi[sl];
        } else {
          qik = q_entry(xi, pi, xk, pk, s.gamma);
          ++evals;
        }
        const double cq = __dmul_rn(C, (double)qik);
        gb = ci > 0 ? __dadd_rn(gb, cq) : __dsub_rn(gb, cq);
      }
      if (cj) {
        const double cq = __dmul_rn(C, (double)qj);
        gb = cj > 0 ? __dadd_rn(gb, cq) : __dsub_rn(gb, cq);
      }
      h.Gbar[sl] = gb;
    }
  }
  return best;
}

// The whole solve.  kSmem: the hot state in the blocks' shared memory,
// mslots rounds of kThreads positions a block; otherwise in the State's
// arrays (mslots unused).
template <bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
svr_smo_kernel(const double* __restrict__ xin,
               const double* __restrict__ target, int l, double epsilon,
               State s, int mslots, double* __restrict__ alpha_out,
               double* __restrict__ rho_out,
               unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Part inbox[2][kCluster];
  __shared__ ArgBest w1[kWarps];
  __shared__ Select2 w2[kWarps];
  __shared__ double2 w3[kWarps];
  __shared__ double4 red[kWarps];
  __shared__ int ibuf[kWarps];
  __shared__ int list[kThreads];
  __shared__ double vals[kThreads];
  Held<kSmem> h{s.G, s.Gbar, s.alpha, s.x, s.qi, s.f};
  if (kSmem) {
    const int slots = mslots * kThreads;
    h.G = reinterpret_cast<double*>(dyn);
    h.Gbar = h.G + slots;
    h.alpha = h.Gbar + slots;
    h.x = h.alpha + slots;
    h.qi = reinterpret_cast<float*>(h.x + slots);
    h.f = reinterpret_cast<uint8_t*>(h.qi + slots);
  }
  Cluster c = this_cluster(inbox);
  const int L = s.L;
  for (int m = 0;; ++m) {
    const int k = c.pos(m);
    if (k >= L) break;
    const int sl = h.at(m, k);
    const bool pos = k < l;
    const int r = pos ? k : k - l;
    const double pk = pos ? epsilon - target[r] : epsilon + target[r];
    s.x[k] = h.x[sl] = xin[r];
    s.p[k] = pk;
    h.G[sl] = pk;
    h.Gbar[sl] = 0.0;
    h.alpha[sl] = 0.0;
    h.f[sl] = (uint8_t)(kLower | (pos ? kPos : 0));
    s.aset[k] = k;
  }
  c.g.sync();       // every block runs before any writes another's memory

  int active = L;
  long long iter = 0, evals = 0, sum_active = 0;
  int counter = min(L, 1000) + 1;
  bool unshrink = false, have1 = false;
  ArgBest b1{-CUDART_INF, -1};
  while (true) {
    if (--counter == 0) {
      counter = min(L, 1000);
      active = shrink(c, s, h, active, unshrink, ibuf, w3, evals);
      have1 = false;
    }
    Part wi, wj;
    if (!select_ws(c, s, h, active, have1, b1, w1, w2, wi, wj, evals)) {
      spill(c, s, h);
      c.g.sync();
      reconstruct(c, s, active, ibuf, evals);
      fill(c, s, h);
      active = L;
      if (!select_ws(c, s, h, active, false, b1, w1, w2, wi, wj, evals))
        break;
      counter = 1;            // shrink at the next iteration
    }
    ++iter;
    sum_active += active;
    // fuse the next selection's first pass unless shrinking comes first
    have1 = counter != 1;
    b1 = update(c, s, h, active, wi, wj, have1, evals);
  }
  spill(c, s, h);
  c.g.sync();

  // Solver::calculate_rho on block 0
  if (c.rank == 0) {
    const double rho = calculate_rho(s, active, red, list, vals);
    if (threadIdx.x == 0) {
      rho_out[0] = rho;
      stats[0] = (unsigned long long)iter;
      stats[1] = (unsigned long long)sum_active;
    }
  }
  atomicAdd(&stats[2], (unsigned long long)evals);
  for (int k = c.rank * kThreads + threadIdx.x; k < L; k += c.nt)
    alpha_out[s.aset[k]] = s.alpha[k];
  c.g.sync();       // no block leaves while another may write its memory
}

// The synchronisation skeleton of one iteration, with no pass over the
// variables: the two selections' block reductions, the pushes into every
// block's inbox, the cluster barriers and the picks, and the step on
// every thread, each round depending on the last.  Its time over `reps`
// rounds is the latency floor of one iteration of svr_smo_kernel (a
// measurement probe).
__global__ void __launch_bounds__(kThreads, 1)
svr_sync_probe_kernel(int reps, double* __restrict__ out) {
  __shared__ Part inbox[2][kCluster];
  __shared__ ArgBest w1[kWarps];
  __shared__ Select2 w2[kWarps];
  Cluster c = this_cluster(inbox);
  c.g.sync();
  const int gt = c.rank * kThreads + threadIdx.x;
  double v = (double)gt;
  const auto build = [&](Part& e, int) {
    e.G = v;
    e.x = v;
    e.alpha = v;
    e.q = (float)v;
  };
  for (int r = 0; r < reps; ++r) {
    const ArgBest b = block_all(ArgBest{v, gt}, MaxOp(),
                                ArgBest{-CUDART_INF, -1}, w1);
    Part* p = c.next();
    push_winner(c, p, b.v, -CUDART_INF, b.i, build);
    c.g.sync();
    const Part wi = cluster_pick<false>(c, p);
    const Select2 m = block_all(Select2{{v - wi.v, gt}, -v}, Select2Op(),
                                Select2{{CUDART_INF, -1}, -CUDART_INF}, w2);
    p = c.next();
    push_winner(c, p, m.m.v, m.g, m.m.i, build);
    c.g.sync();
    const Part wj = cluster_pick<true>(c, p);
    v += (wi.G + wj.g2) / (2.0 + wj.v * 1e-300) * 1e-300;
  }
  c.g.sync();
  if (gt == 0) out[0] = v;
}

// cudaLaunchKernelEx of one cluster of kCluster blocks
template <class... Args, class... Act>
int launch_cluster(void (*kernel)(Args...), size_t smem, cudaStream_t st,
                   Act... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vtt_svr_sync_probe(int reps, void* out, void* stream) {
  if (reps < 1) return (int)cudaErrorInvalidValue;
  return launch_cluster(svr_sync_probe_kernel, 0,
                        static_cast<cudaStream_t>(stream), reps,
                        static_cast<double*>(out));
}

// shared = 1 keeps the hot state in the blocks' shared memory and refuses
// (cudaErrorInvalidValue) a size whose share exceeds kMaxSmem a block;
// shared = 0 keeps it in the arrays given (qi is read only then).
extern "C" int vtt_svr_smo(const void* x, const void* target, void* G,
                           void* Gbar, void* alpha, void* p, void* xs,
                           void* flags, void* aset, void* qi, void* posL,
                           void* posR, void* alpha_out, void* rho_out,
                           void* stats, int l, double C, double epsilon,
                           double gamma, double tol, int shared,
                           void* stream) {
  if (l < 1 || l > (1 << 29)) return (int)cudaErrorInvalidValue;
  const long long nt = (long long)kCluster * kThreads;
  const int mslots = (int)((2LL * l + nt - 1) / nt);
  const size_t smem = (size_t)mslots * kThreads * kSlotBytes;
  if (shared && smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  State s{static_cast<double*>(G),     static_cast<double*>(Gbar),
          static_cast<double*>(alpha), static_cast<double*>(p),
          static_cast<double*>(xs),    static_cast<uint8_t*>(flags),
          static_cast<int*>(aset),     static_cast<float*>(qi),
          static_cast<int*>(posL),     static_cast<int*>(posR),
          2 * l,                       C,
          gamma,                       tol};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xin = static_cast<const double*>(x);
  const auto tin = static_cast<const double*>(target);
  const auto aout = static_cast<double*>(alpha_out);
  const auto rout = static_cast<double*>(rho_out);
  const auto sout = static_cast<unsigned long long*>(stats);
  if (shared)
    return launch_cluster(svr_smo_kernel<true>, smem, st, xin, tin, l,
                          epsilon, s, mslots, aout, rout, sout);
  return launch_cluster(svr_smo_kernel<false>, 0, st, xin, tin, l, epsilon,
                        s, mslots, aout, rout, sout);
}
