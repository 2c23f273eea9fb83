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
// the compiler never fuses into an FMA, so each rounds as libsvm's does.
//
// What bounds it: latency.  The loop is sequential, 5k-26k iterations at
// the sizes velocyto fits, each a handful of dependent passes over the
// active set (2l x ~40 B, 1.6 MB at l = 20,000, which stays in L2).  A
// plain torch loop pays several launches and a host sync per iteration.
//
// What the design does about it: one persistent block of kThreads threads
// owns every variable (thread t owns the positions k = t (mod kThreads)),
// so an iteration costs block barriers, not launches: the two working-set
// reductions as (value, index) warp shuffles, the kernel column i kept in
// a float buffer for the gradient update, column j computed on the fly,
// the two-variable step on thread 0, and G (and, when a bound changes,
// G_bar) updated in one fused pass.  Nothing is read back per iteration.
//
// C interface (bound with ctypes): vtt_svr_smo returns the cudaError_t of
// the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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
  float* qi;      // column i of Q over the active set
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

// the first position >= lo that this thread owns
__device__ __forceinline__ int first_owned(int lo) {
  return lo + (int)(((unsigned)threadIdx.x - (unsigned)lo) % kThreads);
}

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

// Solver::reconstruct_gradient: G of the inactive positions from G_bar,
// p and the free variables, summed in active order.
__device__ void reconstruct(const State& s, int active, int* list,
                            int* ibuf, long long& evals) {
  if (active == s.L) return;
  const int k0 = first_owned(active);
  for (int k = k0; k < s.L; k += kThreads) s.G[k] = s.Gbar[k] + s.p[k];
  for (int base = 0; base < active; base += kThreads) {
    const int c = base + threadIdx.x;
    const int fr = c < active && status_of(s.f[c]) == kFree;
    int n_free;
    const int at = block_scan(fr, ibuf, &n_free);
    if (fr) list[at] = c;
    __syncthreads();
    for (int m = 0; m < n_free; ++m) {
      const int c2 = list[m];
      const double a = s.alpha[c2], xc = s.x[c2];
      const bool pc = is_pos(s.f[c2]);
      for (int k = k0; k < s.L; k += kThreads) {
        const float q = q_entry(xc, pc, s.x[k], is_pos(s.f[k]), s.gamma);
        ++evals;
        s.G[k] = __dadd_rn(s.G[k], __dmul_rn(a, (double)q));
      }
    }
    __syncthreads();
  }
}

// Solver::select_working_set: true with (i, j), or false when optimal.
// Leaves column i over the active set in s.qi.
__device__ bool select_ws(const State& s, int active, int& out_i, int& out_j,
                          long long& evals, void* buf) {
  ArgBest best{-CUDART_INF, -1};
  for (int k = threadIdx.x; k < active; k += kThreads) {
    const uint8_t f = s.f[k];
    const int st = status_of(f);
    if (is_pos(f) ? st != kUpper : st != kLower) {
      const double g = s.G[k];
      best = later_max(best, {is_pos(f) ? -g : g, k});
    }
  }
  best = block_reduce(best, MaxOp(), ArgBest{-CUDART_INF, -1},
                      static_cast<ArgBest*>(buf));
  const int i = best.i;
  if (i < 0) return false;        // Gmax = -inf: no j qualifies
  const double gmax = best.v;
  const double xi = s.x[i];
  const bool pi = is_pos(s.f[i]);
  const double yi = pi ? 1.0 : -1.0;
  Select2 acc{{CUDART_INF, -1}, -CUDART_INF};
  for (int k = threadIdx.x; k < active; k += kThreads) {
    const uint8_t f = s.f[k];
    const int st = status_of(f);
    const double g = s.G[k];
    const float q = q_entry(xi, pi, s.x[k], is_pos(f), s.gamma);
    ++evals;
    s.qi[k] = q;
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
  acc = block_reduce(acc, Select2Op(),
                     Select2{{CUDART_INF, -1}, -CUDART_INF},
                     static_cast<Select2*>(buf));
  if (gmax + acc.g < s.eps || acc.m.i < 0) return false;
  out_i = i;
  out_j = acc.m.i;
  return true;
}

// Solver::do_shrinking; returns the new active size.
__device__ int do_shrinking(const State& s, int active, bool& unshrink,
                            int* list, int* ibuf, void* buf,
                            long long& evals) {
  double2 m = make_double2(-CUDART_INF, -CUDART_INF);   // Gmax1, Gmax2
  for (int k = threadIdx.x; k < active; k += kThreads) {
    const uint8_t f = s.f[k];
    const int st = status_of(f);
    const double g = s.G[k];
    if (is_pos(f)) {
      if (st != kUpper) m.x = fmax(m.x, -g);
      if (st != kLower) m.y = fmax(m.y, g);
    } else {
      if (st != kUpper) m.y = fmax(m.y, -g);
      if (st != kLower) m.x = fmax(m.x, g);
    }
  }
  m = block_reduce(m, Max2Op(), make_double2(-CUDART_INF, -CUDART_INF),
                   static_cast<double2*>(buf));
  if (!unshrink && m.x + m.y <= s.eps * 10) {
    unshrink = true;
    reconstruct(s, active, list, ibuf, evals);
    active = s.L;
  }
  // libsvm's loop swaps the k-th shrinkable position from the left with
  // the k-th kept one from the right while the first lies left of the
  // second; rank both over contiguous segments, then swap the pairs
  const int seg = (active + kThreads - 1) / kThreads;
  const int lo = min(active, (int)threadIdx.x * seg);
  const int hi = min(active, lo + seg);
  int cnt = 0;
  for (int k = lo; k < hi; ++k) cnt += be_shrunk(s, k, m.x, m.y);
  int n_shrunk;
  int rs = block_scan(cnt, ibuf, &n_shrunk);
  const int n_kept = active - n_shrunk;
  int rk = lo - rs;
  for (int k = lo; k < hi; ++k) {
    if (be_shrunk(s, k, m.x, m.y)) s.posL[rs++] = k;
    else s.posR[n_kept - 1 - rk++] = k;
  }
  __syncthreads();
  const int pairs = min(n_shrunk, n_kept);
  for (int t = threadIdx.x; t < pairs; t += kThreads) {
    const int a = s.posL[t], b = s.posR[t];
    if (a < b) swap_positions(s, a, b);
  }
  __syncthreads();
  return n_kept;
}

// The two-variable step of Solver::Solve on thread 0, then G over the
// active set and, where a bound changed, G_bar over all positions.
__device__ void update(const State& s, int active, int i, int j,
                       double* dsh, int* ish, long long& evals) {
  if (threadIdx.x == 0) {
    const double C = s.C;
    const double Gi = s.G[i], Gj = s.G[j];
    const double ai0 = s.alpha[i], aj0 = s.alpha[j];
    const float qij = s.qi[j];
    double ai = ai0, aj = aj0;
    if (is_pos(s.f[i]) != is_pos(s.f[j])) {
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
    s.alpha[i] = ai;
    s.alpha[j] = aj;
    dsh[0] = ai - ai0;
    dsh[1] = aj - aj0;
    const int idx[2] = {i, j};
    const double a[2] = {ai, aj};
    for (int t = 0; t < 2; ++t) {
      const uint8_t f = s.f[idx[t]];
      const bool was_upper = status_of(f) == kUpper;
      const uint8_t st = a[t] >= C ? kUpper : (a[t] <= 0 ? kLower : kFree);
      s.f[idx[t]] = (uint8_t)((f & kPos) | st);
      // +1: became upper bound (G_bar += C Q), -1: left it (G_bar -= C Q)
      ish[t] = was_upper == (st == kUpper) ? 0 : (was_upper ? -1 : 1);
    }
  }
  __syncthreads();
  const double dai = dsh[0], daj = dsh[1], C = s.C;
  const int ci = ish[0], cj = ish[1];
  const double xi = s.x[i], xj = s.x[j];
  const bool pi = is_pos(s.f[i]), pj = is_pos(s.f[j]);
  const int hi = (ci || cj) ? s.L : active;
  for (int k = threadIdx.x; k < hi; k += kThreads) {
    const double xk = s.x[k];
    const bool pk = is_pos(s.f[k]);
    const bool in_active = k < active;
    float qj = 0.f;
    if (in_active || cj) {
      qj = q_entry(xj, pj, xk, pk, s.gamma);
      ++evals;
    }
    if (in_active)
      s.G[k] = __dadd_rn(s.G[k], __dadd_rn(__dmul_rn((double)s.qi[k], dai),
                                           __dmul_rn((double)qj, daj)));
    if (ci || cj) {
      double gb = s.Gbar[k];
      if (ci) {
        float qik;
        if (in_active) {
          qik = s.qi[k];
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
      s.Gbar[k] = gb;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
svr_smo_kernel(const double* __restrict__ xin,
               const double* __restrict__ target, int l, double epsilon,
               State s, double* __restrict__ alpha_out,
               double* __restrict__ rho_out,
               unsigned long long* __restrict__ stats) {
  __shared__ double4 red[kWarps];          // reduction scratch
  __shared__ int ibuf[kWarps];              // scan scratch
  __shared__ int list[kThreads];            // free positions of a chunk
  __shared__ double vals[kThreads];         // y G of a chunk, for rho
  __shared__ double dsh[2];
  __shared__ int ish[2];
  const int L = s.L;
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const bool pos = k < l;
    const int r = pos ? k : k - l;
    const double pk = pos ? epsilon - target[r] : epsilon + target[r];
    s.x[k] = xin[r];
    s.p[k] = pk;
    s.G[k] = pk;
    s.Gbar[k] = 0.0;
    s.alpha[k] = 0.0;
    s.f[k] = (uint8_t)(kLower | (pos ? kPos : 0));
    s.aset[k] = k;
  }
  __syncthreads();

  int active = L;
  long long iter = 0, evals = 0, sum_active = 0;
  int counter = min(L, 1000) + 1;
  bool unshrink = false;
  while (true) {
    if (--counter == 0) {
      counter = min(L, 1000);
      active = do_shrinking(s, active, unshrink, list, ibuf, red, evals);
    }
    int i, j;
    if (!select_ws(s, active, i, j, evals, red)) {
      reconstruct(s, active, list, ibuf, evals);
      active = L;
      if (!select_ws(s, active, i, j, evals, red)) break;
      counter = 1;            // shrink at the next iteration
    }
    ++iter;
    sum_active += active;
    update(s, active, i, j, dsh, ish, evals);
  }

  // Solver::calculate_rho (the loop ends with the whole set active)
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
  if (threadIdx.x == 0) {
    rho_out[0] = r.n_free > 0 ? sum_free / r.n_free : (r.ub + r.lb) / 2;
    stats[0] = (unsigned long long)iter;
    stats[1] = (unsigned long long)sum_active;
  }
  atomicAdd(&stats[2], (unsigned long long)evals);
  for (int k = threadIdx.x; k < L; k += kThreads) alpha_out[s.aset[k]] = s.alpha[k];
}

// The synchronisation skeleton of one SMO iteration, with no pass over
// the variables: the two working-set block reductions, the step on
// thread 0 and the update's two barriers, each round depending on the
// last.  Its time over `reps` rounds is the latency floor of one
// iteration of svr_smo_kernel (a measurement probe, not part of a fit).
__global__ void __launch_bounds__(kThreads, 1)
svr_sync_probe_kernel(int reps, double* __restrict__ out) {
  __shared__ double4 red[kWarps];
  __shared__ double dsh[2];
  double v = (double)threadIdx.x;
  for (int r = 0; r < reps; ++r) {
    const ArgBest b = block_reduce(ArgBest{v, (int)threadIdx.x}, MaxOp(),
                                   ArgBest{-CUDART_INF, -1},
                                   reinterpret_cast<ArgBest*>(red));
    const Select2 m = block_reduce(
        Select2{{v - b.v, (int)threadIdx.x}, -v}, Select2Op(),
        Select2{{CUDART_INF, -1}, -CUDART_INF},
        reinterpret_cast<Select2*>(red));
    if (threadIdx.x == 0) dsh[0] = (b.v + m.g) / (2.0 + m.m.v * 1e-300);
    __syncthreads();
    v += dsh[0] * 1e-300;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = v;
}

}  // namespace

extern "C" int vtt_svr_sync_probe(int reps, void* out, void* stream) {
  if (reps < 1) return (int)cudaErrorInvalidValue;
  svr_sync_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reps, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

extern "C" int vtt_svr_smo(const void* x, const void* target, void* G,
                           void* Gbar, void* alpha, void* p, void* xs,
                           void* flags, void* aset, void* qi, void* posL,
                           void* posR, void* alpha_out, void* rho_out,
                           void* stats, int l, double C, double epsilon,
                           double gamma, double tol, void* stream) {
  if (l < 1 || l > (1 << 29)) return (int)cudaErrorInvalidValue;
  State s{static_cast<double*>(G),     static_cast<double*>(Gbar),
          static_cast<double*>(alpha), static_cast<double*>(p),
          static_cast<double*>(xs),    static_cast<uint8_t*>(flags),
          static_cast<int*>(aset),     static_cast<float*>(qi),
          static_cast<int*>(posL),     static_cast<int*>(posR),
          2 * l,                       C,
          gamma,                       tol};
  svr_smo_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(target), l,
      epsilon, s, static_cast<double*>(alpha_out),
      static_cast<double*>(rho_out),
      static_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}
