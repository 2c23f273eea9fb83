// Greedy degree-capped balance of a kNN graph, for NVIDIA Hopper (sm_90a):
// a walk over the nodes in one block that writes acceptance bits, then a
// decode over every SM that turns the bits into the balanced rows.
//
// Replaces the JAX package's device balance scan,
// velocyto_tpu/ops/knn_device.py::_balance_scan_impl (jitted XLA: a
// speculative batched while_loop, then a gather that decodes its slot
// codes, :310), which runs the reference's numba loop
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
// never meet.  An index outside [0, n) is never admissible.  Group labels
// must lie in [0, n): the wrapper (kernels.balance_walk) hands the walk
// the dense ranks of the caller's labels, which keep their equalities;
// a label outside [0, n) that reaches the walk all the same matches no
// label, and is never read as an address.
//
// What bounds it: latency.  Each node's choices depend on the l left by
// every earlier node, so the n nodes form one chain; the data a node
// reads (the examined part of its row, ~k plus the rejections) is small.
// A node costs its chain (the loads of its candidates and their l, a
// ballot, a barrier and a scan of the warp totals, the stores to l, the
// node's barrier) plus whatever it waits for from device memory and
// whatever code its walkers issue; measured on the card, the code a node
// runs (branches, 64-bit address arithmetic, the writes of its results)
// costs as much as the barriers.
//
// The walk (walk_kernel): one persistent block of kThreads = 256 walker
// threads (512 were no faster at 20,000 cells and slower at 50,000) and
// one producer warp, specialised.
//   - The producer fills a ring of R stages in shared memory, each the
//     first T candidate indices of one node's row: node m goes to stage
//     m mod R once the walkers have released node m - R there (an
//     `empty` mbarrier), as one bulk copy (cp.async.bulk, completing on
//     the stage's `full` mbarrier with its byte count).  The rows are
//     (n, sight) int64, so with an odd sight every other row starts 8
//     bytes past a 16-byte boundary, which a bulk copy refuses: the copy
//     starts at the boundary at or before the row, a stage holds T + 1
//     indices (rounded up to even), and the stage header carries the
//     row's offset (0 or 1) with the node and its group.  The last row
//     may end 8 bytes short of a 16-byte unit: lane 0 copies that tail
//     by hand, then fences the async proxy, so the stage's later bulk
//     copies are ordered after its ordinary stores.  The producer
//     reads lsi 32 nodes at a time, a lane each, so no row address waits
//     on a global load in the walkers' chain, and T is the JAX package's
//     depth (_balance_plan: k + 1 + max(192, k/2), rounded up to 128, at
//     most 1,024 and sight); a row examined past T reads its later chunks
//     from device memory, each one chunk ahead of its ranking.  (An 8-byte
//     cp.async of each index by every walker, the first design, left the
//     walk no faster than the one-block kernel it replaced: the copies'
//     issue sat on the walkers' path.)
//   - A chunk is T positions, kPer = ceil(T / kThreads) a walker, fixed at
//     compile time with the label mode, so the code a node runs has no
//     branch per position and every load of a chunk is in flight at
//     once.  One ballot per position, one named barrier over the walkers
//     and one shuffle scan of the <= 32 warp totals (double-buffered)
//     rank the admissible candidates.
//   - Group labels sit beside l in shared memory as uint16 where they fit
//     (n <= kMaxL16), else the producer's 32 lanes gather the labels of a
//     stage's indices by cp.async into the ring's second half, R/2 nodes
//     after its copy, and arrive on the stage's `labs` mbarrier when
//     they land: the group check reads shared memory either way.
//   - Per node the walkers write one 32-bit word per warp and chunk of
//     the accepted positions (a second ballot: ok and rank < k) into bits
//     (n, ceil(sight / 32)), and (p, examined itself) into meta (n, 2):
//     no distance is read and ~100 B are written a node, not ~8 KB.
//     meta starts at (-1, 0): a row never visited decodes as -1 / 0.
//   - l lives in shared memory as uint16 where the in-degrees and the
//     cells fit with the ring (kSmemL), else in an int32 array in global
//     memory, which stays in L2: one loop, templated on where l lives.
//     Every region's size is layout(), mirrored by kernels.balance_plan in
//     Python.
// The decode (decode_kernel): one warp a row, over every SM.  The warp
// scans the popcounts of 32 words at a time; each lane takes a slot r,
// finds its word by a binary search over the scan (shuffles) and its bit
// by a popcount select, and gathers dsi and dist at that position: the
// (n, k + 1) rows are written in order, coalesced.  Words past a row's
// examined region are never written by the walk and may hold anything:
// their bits rank at p or above, so they are never taken.
//
// C interface (bound with ctypes): every function returns the
// cudaError_t of the launch as an int; 0 means the kernel was queued.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // the walk's walkers, the probe's block
constexpr int kMaxDepth = 1024;           // staged positions a row: 32 x 32
constexpr int kMaxStages = 8;             // stages of the ring, at most
constexpr int kOutWords = kMaxDepth / 32 + 2;  // a stage's results: bits, p, self
constexpr int kMaxSmem = 224 * 1024;      // dynamic shared memory, bytes
constexpr int kMaxL16 = 65535;            // largest l (or label) a uint16 holds
constexpr int kDecodeThreads = 256;       // the decode: a warp a row
constexpr int kProbeMinCells = 1024;      // the probe's smallest n
constexpr unsigned kFull = 0xffffffffu;
constexpr uint16_t kNoLabel = 0xffff;     // a label outside [0, n)

enum Labels { kNone = 0, kSharedLabels = 1, kStagedLabels = 2 };

__host__ __device__ inline size_t pad16(size_t b) { return (b + 15) / 16 * 16; }

// elements of a ring stage for T staged positions: T + 1 rounded up to
// even, so a stage is a whole number of 16-byte units and holds a row
// copied from the 16-byte boundary at or before its start
__host__ __device__ inline int stage_len(int depth) {
  return (depth + 2) / 2 * 2;
}

// Byte offsets of the walk's dynamic shared memory regions.
struct Layout {
  size_t ring, ring_lab, outs, l, lab, total;
};

__host__ __device__ inline Layout layout(int n, int depth, int stages,
                                         int labels, bool smem_l) {
  Layout o;
  const size_t cells = (size_t)stages * depth;
  o.ring = 0;
  o.ring_lab = o.ring + pad16(8 * (size_t)stages * stage_len(depth));
  o.outs = o.ring_lab + (labels == kStagedLabels ? pad16(4 * cells) : 0);
  o.l = o.outs + pad16(4 * (size_t)stages * kOutWords);
  o.lab = o.l + (smem_l ? pad16(2 * (size_t)n) : 0);
  o.total = o.lab + (labels == kSharedLabels ? pad16(2 * (size_t)n) : 0);
  return o;
}

__device__ __forceinline__ bool is_cell(int64_t v, int n) {
  return v >= 0 && v < n;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// thread 0's arrival for a stage: with the bytes its bulk copy brings
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

struct WalkArgs {
  const int64_t* dsi;     // (n, sight) candidates of each row, in order
  const int64_t* lsi;     // (n,) visit order
  const int* cst;         // (n,) group of each cell, or null
  unsigned* bits;         // (n, words) accepted positions
  int2* meta;             // (n,) (accepted count p, examined itself)
  int64_t* l_out;         // (n,) final in-degrees
  int n, sight, maxl, k, depth, stages, words, labels;
};

// The sum of the warp's values v below this lane: a shuffle scan.
__device__ __forceinline__ int exclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += u;
  }
  return x - v;
}

template <bool B>
struct Tag {
  static constexpr bool value = B;
};

// The walkers' barrier: named barrier 1 over the kThreads walker threads
// (the producer warp never joins it).
__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// this thread's ordinary stores to shared memory before its later
// async-proxy operations (bulk copies) there
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// this thread's cp.async copies arrive on `bar` once they land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// The block's shared state beside the dynamic regions: per stage, the
// barriers and the node it holds.
struct Ring {
  uint64_t full[kMaxStages];    // header and indices landed (bulk copy)
  uint64_t labs[kMaxStages];    // staged labels landed (32 producer lanes)
  uint64_t empty[kMaxStages];   // the walkers are done with the stage
  int el[kMaxStages];           // the node, or -1
  int group[kMaxStages];        // its group, or -1
  int off[kMaxStages];          // its row's offset from the 16-byte boundary
  int wtot[2 * 32];             // warp totals, double-buffered
  int self;                     // the node examined itself
};

// The walk.  Threads 0..kThreads-1 walk the nodes; warp kThreads/32 is the
// producer, which fills the ring ahead of them.  l lives where `l` points
// (shared uint16 or global int32).
template <int kPer, bool kLabels, class LT>
__device__ void walk(const WalkArgs& a, LT* l, unsigned char* smem,
                     const Layout& o, Ring& rg) {
  constexpr int kT{kThreads}, kW{kThreads / 32};
  static_assert(kW * kPer <= 32, "one warp scans the chunk's totals");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = a.n, T = a.depth, R = a.stages, k = a.k;
  const int64_t S = a.sight, W = a.words;
  const int Tc = T < S ? T : (int)S;          // staged positions that exist
  const int Ts = stage_len(T);
  const bool staged = kLabels && a.labels == kStagedLabels;
  int64_t* ring = reinterpret_cast<int64_t*>(smem + o.ring);
  int* ring_lab = reinterpret_cast<int*>(smem + o.ring_lab);
  int* outs = reinterpret_cast<int*>(smem + o.outs);
  uint16_t* lab16 = reinterpret_cast<uint16_t*>(smem + o.lab);

  for (int i = t; i < n; i += kT + 32) {
    l[i] = 0;
    a.meta[i] = make_int2(-1, 0);
    if (kLabels && a.labels == kSharedLabels) {
      const int g = a.cst[i];
      lab16[i] = g >= 0 && g < n ? (uint16_t)g : kNoLabel;
    }
  }
  if (t < 2 * 32) rg.wtot[t] = 0;             // totals past kPer warps
  if (t == 0) {
    for (int r = 0; r < R; ++r) {
      mbar_init(rg.full + r, 1);
      mbar_init(rg.labs + r, 32);
      mbar_init(rg.empty + r, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kW) {
    // The producer.  Node m goes to stage m mod R once the walkers have
    // released node m - R there: lane 0 writes the stage's header and
    // bulk-copies the row's first T indices from the 16-byte boundary at
    // or before it (the rows are int64 with any sight, so a row may
    // start 8 bytes past one); with staged labels, D nodes later the 32
    // lanes gather the labels of those indices by cp.async.
    const int D = R / 2;
    const int words0 = (Tc + 31) / 32;       // the words of a staged chunk
    int64_t el_batch = -1;
    int g_batch = -1;
    for (int m = 0; m < n + R; ++m) {
      const int s_m = m % R;
      if (m >= R) {
        // the walkers are done with node m - R: write its results out
        mbar_wait(rg.empty + s_m, ((m / R) & 1) ^ 1);
        const int e = rg.el[s_m];
        const int* out = outs + s_m * kOutWords;
        if (e >= 0 && out[kOutWords - 2] > 0 && lane < words0)
          a.bits[(int64_t)e * W + lane] = (unsigned)out[lane];
        if (e >= 0 && lane == 0)
          a.meta[e] = make_int2(out[kOutWords - 2], out[kOutWords - 1]);
      }
      if (m < n) {
        if ((m & 31) == 0) {                  // 32 nodes of lsi, a lane each
          el_batch = m + lane < n ? a.lsi[m + lane] : -1;
          if (!is_cell(el_batch, n)) el_batch = -1;
          if (kLabels) {
            g_batch = el_batch >= 0 ? a.cst[el_batch] : -1;
            if (g_batch < 0 || g_batch >= n) g_batch = -1;
          }
        }
        const int e = __shfl_sync(kFull, (int)el_batch, m & 31);
        const int g = kLabels ? __shfl_sync(kFull, g_batch, m & 31) : -1;
        __syncwarp();                 // every lane has read the old header
        if (lane == 0) {
          rg.el[s_m] = e;
          rg.group[s_m] = g;
          if (e >= 0 && Tc > 0) {
            const int64_t* src = a.dsi + (int64_t)e * S;
            const int off = (int)(((uintptr_t)src & 15) >> 3);
            const int64_t* src16 = src - off;
            unsigned bytes = (unsigned)((off + Tc) * 8 + 15) / 16 * 16;
            // the last row may end 8 bytes short of its last 16-byte
            // unit: lane 0 copies what the bulk copy leaves
            if (src16 + bytes / 8 > a.dsi + (int64_t)n * S) bytes -= 16;
            int64_t* dst = ring + (size_t)s_m * Ts;
            if ((int)(bytes / 8) < off + Tc) {
              for (int j = (int)(bytes / 8); j < off + Tc; ++j)
                dst[j] = src16[j];
              fence_proxy_async();    // before the stage's next bulk copy
            }
            rg.off[s_m] = off;
            mbar_expect(rg.full + s_m, bytes);
            if (bytes > 0) bulk_load(dst, src16, bytes, rg.full + s_m);
          } else {
            mbar_arrive(rg.full + s_m);      // no row: the phase just ends
          }
        }
      }
      const int h = m - D;                   // its labels, with staged labels
      if (staged && h >= 0 && h < n) {
        const int s_h = h % R;
        mbar_wait(rg.full + s_h, (h / R) & 1);
        if (rg.el[s_h] >= 0) {
          const int64_t* idx = ring + (size_t)s_h * Ts + rg.off[s_h];
          int* dst = ring_lab + (size_t)s_h * T;
          for (int j = lane; j < Tc; j += 32) {
            const int64_t cj = idx[j];
            if (is_cell(cj, n)) cp_async4(dst + j, a.cst + cj);
          }
        }
        cp_async_arrive(rg.labs + s_h);
      }
    }
    cp_async_wait_all();
  } else {
    int buf = 0;
    const unsigned below = (1u << lane) - 1u;
    unsigned phase = 0;                      // the parity of this use
    bool deep = false;                       // the last row went past T
    for (int i = 0, stage = 0; i < n; ++i) {
      mbar_wait(rg.full + stage, phase);     // header and indices landed
      const int el = rg.el[stage];           // uniform
      if (el >= 0) {
        const int node_g = kLabels ? rg.group[stage] : 0;
        const int64_t* row = a.dsi + (int64_t)el * S;
        const int64_t* st = ring + (size_t)stage * Ts + rg.off[stage];
        const int* stl = ring_lab + (size_t)stage * T;
        int* out = outs + stage * kOutWords;   // the staged chunk's words
        unsigned* brow = a.bits + (int64_t)el * W;   // the later chunks'
        if (staged) mbar_wait(rg.labs + stage, phase);
        int acc = 0;
        // this thread's indices of the chunk at `base` past T, from
        // device memory
        auto load = [&](int64_t base, int64_t (&c)[kPer]) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int j = q * kT + t;
            c[q] = j < T && base + j < S ? row[base + j] : -1;
          }
        };
        // rank one chunk of T positions from `base`: the staged one
        // (base 0) or one past T, whose indices `past` holds
        auto chunk = [&](auto from_stage, int64_t base,
                         const int64_t (&past)[kPer]) {
          constexpr bool kStage = decltype(from_stage)::value;
          int64_t c[kPer];
          int lv[kPer];
          bool ok[kPer];
          unsigned m[kPer];
          int* wtot = rg.wtot + buf * 32;
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int j = q * kT + t;
            if constexpr (kStage)
              c[q] = j < Tc ? st[j] : -1;
            else
              c[q] = past[q];
          }
          // no branch per position: every load is issued at a safe
          // address (cell 0 for a position that is not a candidate), so
          // the loads of all kPer positions are in flight together
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const bool cell = (uint64_t)c[q] < (uint64_t)n && c[q] != el;
            const int ci = cell ? (int)c[q] : 0;
            lv[q] = (int)l[ci];
            ok[q] = cell && lv[q] < a.maxl;
            if constexpr (kLabels) {
              int g;
              if (a.labels == kSharedLabels)
                g = lab16[ci] == kNoLabel ? -1 : (int)lab16[ci];
              else if constexpr (kStage)
                g = cell ? stl[q * kT + t] : -1;   // gathered for cells
              else
                g = a.cst[ci];
              ok[q] = ok[q] && node_g >= 0 && g == node_g;
            }
          }
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            m[q] = __ballot_sync(kFull, ok[q]);
            if (lane == 0) wtot[q * kW + warp] = __popc(m[q]);
          }
          walkers_sync();
          const int v = wtot[lane];
          const int pre = exclusive_scan(v);   // totals before lane's
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            // admissible candidates before this position, in the row
            const int rank = acc + __shfl_sync(kFull, pre, q * kW + warp) +
                             __popc(m[q] & below);
            const bool take = ok[q] && rank < k;
            const unsigned taken = __ballot_sync(kFull, take);
            if (take) l[(int)c[q]] = (LT)(lv[q] + 1);
            if (c[q] == el && rank < k) rg.self = 1;       // examined
            const int j0 = q * kT + warp * 32;
            if (lane == 0 && j0 < T && base + j0 < S) {
              if constexpr (kStage)
                out[j0 >> 5] = (int)taken;
              else
                brow[(base + j0) >> 5] = taken;
            }
          }
          acc += __shfl_sync(kFull, pre + v, 31);   // the chunk's total
          buf ^= 1;
        };
        if (t == 0) rg.self = 0;             // before the chunk's barrier
        // A row examined past T reads its later chunks from device
        // memory, each one chunk ahead of its ranking; after a row that
        // went past T, the next row's first such chunk is read while its
        // staged chunk is ranked (rows past T come in runs).
        int64_t next[kPer];
        bool ahead = deep && T < S;
        if (ahead) load(T, next);
        deep = false;
        if (k > 0 && S > 0) chunk(Tag<true>{}, 0, next);
        for (int64_t base = T; acc < k && base < S; base += T) {
          int64_t cur[kPer];
#pragma unroll
          for (int q = 0; q < kPer; ++q) cur[q] = next[q];
          if (!ahead) load(base, cur);
          ahead = base + T < S;
          if (ahead) load(base + T, next);
          chunk(Tag<false>{}, base, cur);    // past T
          deep = true;
        }
        walkers_sync();    // the next node reads l as this one left it
        if (t == 0) {
          out[kOutWords - 2] = acc < k ? acc : k;
          out[kOutWords - 1] = rg.self;
          mbar_arrive(rg.empty + stage);     // the stage and results are free
        }
      } else {
        walkers_sync();                  // every walker read el
        if (t == 0) mbar_arrive(rg.empty + stage);
      }
      if (++stage == R) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  __syncthreads();
  for (int i = t; i < n; i += kT + 32) a.l_out[i] = (int64_t)l[i];
}

template <int kPer, bool kLabels, bool kSmemL>
__global__ void __launch_bounds__(kThreads + 32, 1)
walk_kernel(WalkArgs a, int* l_global) {
  __shared__ Ring rg;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout o = layout(a.n, a.depth, a.stages, a.labels, kSmemL);
  if constexpr (kSmemL)
    walk<kPer, kLabels>(a, reinterpret_cast<uint16_t*>(smem + o.l), smem,
                        o, rg);
  else
    walk<kPer, kLabels>(a, l_global, smem, o, rg);
}

struct DecodeArgs {
  const unsigned* bits;   // (n, words)
  const int2* meta;       // (n,)
  const int64_t* dsi;     // (n, sight)
  const double* dist;     // (n, sight)
  int64_t* idx_out;       // (n, k + 1) dsi_new
  double* dist_out;       // (n, k + 1) dist_new
  int n, sight, words, k;
};

// the position of the m-th (from 0) set bit of w, m < popc(w)
__device__ __forceinline__ int select_bit(unsigned w, int m) {
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned lo = w & ((1u << half) - 1u);
    const int c = __popc(lo);
    if (m >= c) {
      m -= c;
      w >>= half;
      pos += half;
    } else {
      w = lo;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(DecodeArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t el = (int64_t)blockIdx.x * (kDecodeThreads / 32) +
                     (threadIdx.x >> 5);
  if (el >= a.n) return;                       // the whole warp
  const int64_t S = a.sight, W = a.words, kw = (int64_t)a.k + 1;
  int64_t* orow = a.idx_out + el * kw;
  double* drow = a.dist_out + el * kw;
  const int2 mt = a.meta[el];
  if (mt.x < 0) {                              // never visited
    for (int64_t s = lane; s < kw; s += 32) {
      orow[s] = -1;
      drow[s] = 0.0;
    }
    return;
  }
  if (lane == 0) {
    orow[0] = mt.y ? el : -1;
    drow[0] = 0.0;
  }
  const unsigned* brow = a.bits + el * W;
  const int64_t* row = a.dsi + el * S;
  const double* dr = a.dist + el * S;
  const int p = mt.x < a.k ? mt.x : a.k;
  int done = 0;                                // slots 1..done written
  for (int64_t base = 0; done < p && base < W; base += 32) {
    const unsigned w = base + lane < W ? brow[base + lane] : 0u;
    const int c = __popc(w);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    const int batch = __shfl_sync(kFull, incl, 31);
    const int end = done + batch < p ? done + batch : p;
    for (int rb = done; rb < end; rb += 32) {
      const int q = rb + lane - done;          // rank within the batch
      int src = 0;                             // lanes whose words end at or before q
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int u = __shfl_sync(kFull, incl, src + step - 1);
        if (u <= q) src += step;
      }
      const int before = __shfl_sync(kFull, incl - c, src);
      const unsigned word = __shfl_sync(kFull, w, src);
      if (rb + lane < end) {
        const int64_t j = (base + src) * 32 + select_bit(word, q - before);
        orow[rb + lane + 1] = row[j];
        drow[rb + lane + 1] = dr[j];
      }
    }
    done = end;
  }
  if (done < a.k) {                            // sight exhausted
    const double d0 = dr[0];
    for (int64_t s = done + 1 + lane; s < kw; s += 32) {
      orow[s] = el;
      drow[s] = d0;
    }
  }
}

// reps dependent steps of what chains one node to the next when its first
// chunk ends it: a load of l at an address that depends on the step
// before, a ballot, the chunk's barrier and scan, a store to l and the
// node's barrier, in a block of the walk's kThreads.  With rows
// (n, sight) given, each step first reads its chunk of row r * 7919 mod n
// (a permutation of the rows unless 7919 divides n, so no row is read
// twice and none waits in L2), its address made to depend on the step
// before, as a node reads its row when nothing was loaded ahead.  Timed,
// it gives the walk's latency floor.  n >= kProbeMinCells.
template <class LT>
__device__ void probe_loop(LT* w, int n, int reps, const int64_t* rows,
                           int sight, int64_t* out, int* wtot2) {
  constexpr int kW{kThreads / 32};
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
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
    const unsigned m = __ballot_sync(kFull, ok);
    int* wtot = wtot2 + buf * 32;
    if (lane == 0) wtot[warp] = __popc(m);
    __syncthreads();
    const int v = lane < kW ? wtot[lane] : 0;
    const int pre = exclusive_scan(v);
    if (ok && __shfl_sync(kFull, pre, warp) + __popc(m & below) < n)
      w[c] = (LT)(lv + 1);
    h += __shfl_sync(kFull, pre + v, 31);
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
  __shared__ int wtot2[2 * 32];
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kSmem)
    probe_loop(reinterpret_cast<uint16_t*>(smem), n, reps, rows, sight, out,
               wtot2);
  else
    probe_loop(w_global, n, reps, rows, sight, out, wtot2);
}

template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int kPer, bool kLabels>
int launch_walk(const WalkArgs& a, int* l_work, bool shared, size_t bytes,
                cudaStream_t st) {
  if (shared) {
    const auto kernel = walk_kernel<kPer, kLabels, true>;
    const int e = allow_smem(kernel, bytes);
    if (e != 0) return e;
    kernel<<<1, kThreads + 32, bytes, st>>>(a, nullptr);
  } else {
    const auto kernel = walk_kernel<kPer, kLabels, false>;
    const int e = allow_smem(kernel, bytes);
    if (e != 0) return e;
    kernel<<<1, kThreads + 32, bytes, st>>>(a, l_work);
  }
  return (int)cudaGetLastError();
}

// the walk with its positions a thread (ceil(T / kThreads)) and its labels
// fixed at compile time
template <int kPer = 1>
int dispatch_walk(const WalkArgs& a, int* l_work, bool shared, size_t bytes,
                  cudaStream_t st) {
  if ((a.depth + kThreads - 1) / kThreads == kPer)
    return a.labels != kNone
               ? launch_walk<kPer, true>(a, l_work, shared, bytes, st)
               : launch_walk<kPer, false>(a, l_work, shared, bytes, st);
  if constexpr (kPer * (kThreads / 32) < 32)
    return dispatch_walk<kPer + 1>(a, l_work, shared, bytes, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The walk: bits (n, words) uint32 with words = ceil(sight / 32), meta (n,
// 2) int32, l_out (n,) int64.  depth T in [1, kMaxDepth], a multiple of 32
// unless it covers the row; stages R even in [2, kMaxStages]; labels 0
// (cst null), 1 (uint16 beside l, n <= kMaxL16) or 2 (staged), the labels
// in [0, n); shared = 1 keeps l in shared memory as uint16 (no l may pass
// kMaxL16), shared = 0 in l_work, n int32 values.  Every other size is
// refused (cudaErrorInvalidValue), as is a layout above kMaxSmem.  maxl in
// [0, n].
extern "C" int vtt_knn_balance_walk(const void* dsi, const void* lsi,
                                    const void* cst, void* l_work,
                                    void* bits, void* meta, void* l_out,
                                    int n, int sight, int maxl, int k,
                                    int depth, int stages, int labels,
                                    int shared, void* stream) {
  const int top = maxl < n - 1 ? maxl : n - 1;      // l never passes it
  if (n < 1 || k < 0 || sight < k || maxl < 0 || maxl > n || depth < 1 ||
      depth > kMaxDepth || (depth < sight && depth % 32 != 0) ||
      stages < 2 || stages > kMaxStages || stages % 2 != 0 || labels < 0 ||
      labels > 2 || (labels == kNone) != (cst == nullptr) ||
      (labels == kSharedLabels && n > kMaxL16) ||
      (shared && top > kMaxL16) || (!shared && l_work == nullptr))
    return (int)cudaErrorInvalidValue;
  const Layout o = layout(n, depth, stages, labels, shared != 0);
  if (o.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  WalkArgs a{static_cast<const int64_t*>(dsi),
             static_cast<const int64_t*>(lsi), static_cast<const int*>(cst),
             static_cast<unsigned*>(bits),    static_cast<int2*>(meta),
             static_cast<int64_t*>(l_out),    n, sight, maxl, k, depth,
             stages, (sight + 31) / 32, labels};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lw = static_cast<int*>(l_work);
  return dispatch_walk(a, lw, shared, o.total, st);
}

// The decode: the walk's bits (n, words) and meta (n, 2) with the
// candidates' dsi (n, sight) and dist (n, sight) -> idx_out (n, k + 1)
// int64 and dist_out (n, k + 1) float64.
extern "C" int vtt_knn_balance_decode(const void* bits, const void* meta,
                                      const void* dsi, const void* dist,
                                      void* idx_out, void* dist_out, int n,
                                      int sight, int k, void* stream) {
  if (n < 1 || k < 0 || sight < k) return (int)cudaErrorInvalidValue;
  DecodeArgs a{static_cast<const unsigned*>(bits),
               static_cast<const int2*>(meta),
               static_cast<const int64_t*>(dsi),
               static_cast<const double*>(dist),
               static_cast<int64_t*>(idx_out),
               static_cast<double*>(dist_out), n, sight, (sight + 31) / 32,
               k};
  constexpr int rows = kDecodeThreads / 32;
  decode_kernel<<<(n + rows - 1) / rows, kDecodeThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// shared = 0 needs w_work, n int32 values; rows, (n, sight) int64, may be
// null.
extern "C" int vtt_knn_balance_probe(void* w_work, int n, int reps,
                                     const void* rows, int sight, int shared,
                                     void* out, void* stream) {
  if (n < kProbeMinCells || reps < 1 || (rows != nullptr && sight < 1))
    return (int)cudaErrorInvalidValue;
  const auto rw = static_cast<const int64_t*>(rows);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<int64_t*>(out);
  if (shared) {
    const size_t bytes = pad16(2 * (size_t)n);
    if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
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
