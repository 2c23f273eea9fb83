// numpy-exact weighted sampling without replacement, for the neighbour
// sampling of VelocytoLoom.estimate_transition_prob(knn_random=True).
//
// It replays numpy's legacy RandomState.choice(pop, size, replace=False,
// p=p) once per row, byte for byte: standard MT19937 (init_genrand seeding,
// numpy's 53-bit double recipe) driving the rejection loop of
// numpy/random/mtrand.pyx,
//
//     while n_uniq < size:
//         x = rand(size - n_uniq)
//         p[found[:n_uniq]] = 0; cdf = cumsum(p); cdf /= cdf[-1]
//         new = cdf.searchsorted(x, side='right')
//         append the first occurrence of each value of new, in draw order
//
// The positions and the final MT19937 state equal those of
// np.random.seed(seed) followed by one np.random.choice call per row, as
// do those of the sampler of velocyto_tpu/native/vtpu.cpp (struct
// Mt19937, choice_rows_core), whose entry points this file copies.
//
// At the neighbour sampling's shapes (pop 3,501, size 1,750) a row takes
// about 3.4 rounds and 2,200 doubles, and the loop is built around that:
// - The generator keeps numpy's key and, beside it, the tempered words of
//   the current 624-word block, both written by one pass of the
//   recurrence (three loops, no modulo), as native/permute.cpp's does; a
//   resumed state may sit anywhere in its block, and the state written
//   back is numpy's: the last block twisted and the position in it.
// - Round 1 searches cdf0, the cdf of p itself, the same for every row,
//   through a table of about 4 pop buckets: most buckets bracket at most
//   one boundary, so a draw costs one compare.  First occurrences are
//   kept without a branch: found[n] = r; n += !seen[r]; seen[r] = 1.
// - Rounds >= 2 sum, divide and search a compact list: the positive
//   weights round 1 left unfound, in index order, built once a row by a
//   stream compaction; what a later round finds gets weight 0 in it.
//   The sum stays sequential and the division a pass of its own, and
//   adding numpy's zeros to a sum of non-negative doubles changes no bit,
//   so each entry is the double numpy's whole cumsum holds at its index.
//   searchsorted side='right' lands on the first index whose cdf exceeds
//   x; its weight is positive and unfound, so it is in the list, and the
//   compact search, eight draws abreast, lands on it too.
//
// Build without -march=native and with -ffp-contract=off: the cdf sums
// must round exactly as numpy's do.

#include <stddef.h>
#include <stdint.h>

#include <cmath>
#include <vector>

namespace {

constexpr int kN = 624;
constexpr int kM = 397;
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7fffffffu;

inline uint32_t temper(uint32_t y) {
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
}

// the recurrence's new key[i] from key[i], key[i + 1] and key[i + M]
inline uint32_t twist(uint32_t a, uint32_t b, uint32_t c) {
    const uint32_t y = (a & kUpper) | (b & kLower);
    return c ^ (y >> 1) ^ ((0u - (y & 1u)) & kMatrixA);
}

// numpy's rk_double from two words: exact, the 53 bits over 2^53
inline double to_double(uint32_t a, uint32_t b) {
    return ((a >> 5) * 67108864.0 + (b >> 6)) * (1.0 / 9007199254740992.0);
}

struct Stream {
    uint32_t key[kN];     // numpy's state
    uint32_t word[kN];    // temper(key[k]): the block's output words
    int pos;              // numpy's position: the next word is word[pos]

    explicit Stream(const uint32_t* state) {
        for (int k = 0; k < kN; ++k) key[k] = state[k];
        pos = (int)state[kN];
        for (int k = pos; k < kN; ++k) word[k] = temper(key[k]);
    }

    void save(uint32_t* state) const {
        for (int k = 0; k < kN; ++k) state[k] = key[k];
        state[kN] = (uint32_t)pos;
    }

    // numpy's mt19937_gen, tempering each new key as it is written
    void refill() {
        int i = 0;
        for (; i < kN - kM; ++i) {
            key[i] = twist(key[i], key[i + 1], key[i + kM]);
            word[i] = temper(key[i]);
        }
        for (; i < kN - 1; ++i) {
            key[i] = twist(key[i], key[i + 1], key[i + kM - kN]);
            word[i] = temper(key[i]);
        }
        key[kN - 1] = twist(key[kN - 1], key[0], key[kM - 1]);
        word[kN - 1] = temper(key[kN - 1]);
        pos = 0;
    }

    // n doubles into x; a block is twisted only when a word of it is due
    void doubles(double* x, int64_t n) {
        int64_t i = 0;
        while (i < n) {
            if (pos == kN) refill();
            if (pos == kN - 1) {          // one word here, one in the next
                const uint32_t a = word[kN - 1];
                refill();
                x[i++] = to_double(a, word[0]);
                pos = 1;
                continue;
            }
            const int64_t pairs = (kN - pos) / 2;
            const int64_t cnt = n - i < pairs ? n - i : pairs;
            const uint32_t* w = word + pos;
            for (int64_t k = 0; k < cnt; ++k)
                x[i + k] = to_double(w[2 * k], w[2 * k + 1]);
            pos += (int)(2 * cnt);
            i += cnt;
        }
    }
};

// #{k < n : c[k] <= x} for a non-decreasing c with c[n - 1] > x, n >= 1:
// numpy's searchsorted side='right', without a data-dependent branch
// (the step is a mask, not a select: the compiler would branch on one)
inline int64_t count_le(const double* c, int64_t n, double x) {
    int64_t b = 0;
    while (n > 1) {
        const int64_t half = n >> 1;
        b += half & -(int64_t)(c[b + half - 1] <= x);
        n -= half;
    }
    return b + (c[b] <= x);
}

// count_le for kLanes draws at once: the steps are the same for every
// draw of a round, so their loads are independent and overlap
constexpr int kLanes = 8;
inline void count_le_lanes(const double* c, int64_t n, const double* x,
                           int64_t* r) {
    int64_t b[kLanes] = {};
    while (n > 1) {
        const int64_t half = n >> 1;
        for (int l = 0; l < kLanes; ++l)
            b[l] += half & -(int64_t)(c[b[l] + half - 1] <= x[l]);
        n -= half;
    }
    for (int l = 0; l < kLanes; ++l) r[l] = b[l] + (c[b[l]] <= x[l]);
}

struct Sampler {
    int64_t pop, size;
    std::vector<double> cdf0;       // the round-1 cdf, numpy's bits
    int64_t nb;                     // buckets: a power of two >= 4 pop
    std::vector<int32_t> bstart;    // #{j : cdf0[j] <= b / nb}, (nb + 1,)
    std::vector<int32_t> pos_idx;   // the indices of positive weight
    std::vector<double> pos_w;      // and their weights
    // rounds >= 2: the entries round 1 left unfound, in index order, their
    // weights (0 once found in a later round) and their cdf
    std::vector<int32_t> idx;
    std::vector<double> w, cdf, x;
    std::vector<int64_t> r;
    std::vector<unsigned char> seen;
    int64_t draws = 0, rounds = 0;

    Sampler(const double* p, int64_t pop_, int64_t size_)
        : pop(pop_), size(size_), cdf0((size_t)pop_), idx((size_t)pop_),
          w((size_t)pop_), cdf((size_t)pop_), x((size_t)size_),
          r((size_t)size_), seen((size_t)pop_, 0) {
        double acc = 0.0;
        for (int64_t j = 0; j < pop; ++j) {
            acc += p[j];
            cdf0[(size_t)j] = acc;
        }
        for (int64_t j = 0; j < pop; ++j) cdf0[(size_t)j] /= acc;
        // x in bucket b = floor(x nb) lies in [b / nb, (b + 1) / nb), both
        // exact, so its count lies in [bstart[b], bstart[b + 1]]
        nb = 4;
        while (nb < 4 * pop) nb <<= 1;
        bstart.resize((size_t)nb + 1);
        int64_t j = 0;
        for (int64_t b = 0; b < nb; ++b) {
            const double thr = (double)b / (double)nb;
            while (j < pop && cdf0[(size_t)j] <= thr) ++j;
            bstart[(size_t)b] = (int32_t)j;
        }
        bstart[(size_t)nb] = (int32_t)pop;
        for (int64_t k = 0; k < pop; ++k)
            if (p[k] > 0) {
                pos_idx.push_back((int32_t)k);
                pos_w.push_back(p[k]);
            }
    }

    // round 1 over cdf0: cdf0[pop - 1] == 1.0 > x, so every r < pop, and
    // bstart[b] < pop for b < nb
    int64_t first_round(int64_t* found) {
        const double nbd = (double)nb;
        const double* c = cdf0.data();
        const int32_t* bs = bstart.data();
        unsigned char* sn = seen.data();
        int64_t n = 0;
        for (int64_t i = 0; i < size; ++i) {
            const double xv = x[(size_t)i];
            const int64_t b = (int64_t)(xv * nbd);
            const int64_t lo = bs[b];
            const int64_t d = bs[b + 1] - lo;
            // d == 0: cdf0[lo] > (b + 1) / nb > x
            int64_t rv = lo + (c[lo] <= xv);
            if (d > 1) rv = lo + count_le(c + lo, d + 1 < pop - lo ? d + 1
                                                        : pop - lo, xv);
            found[n] = rv;
            n += !sn[rv];
            sn[rv] = 1;
        }
        return n;
    }

    // the positive entries round 1 left unfound, in order, into idx and w
    // (a stream compaction: every entry is written, only the unfound kept)
    int64_t compact() {
        const unsigned char* sn = seen.data();
        const int64_t n_pos = (int64_t)pos_idx.size();
        int64_t k = 0;
        for (int64_t t = 0; t < n_pos; ++t) {
            const int32_t j = pos_idx[(size_t)t];
            idx[(size_t)k] = j;
            w[(size_t)k] = pos_w[(size_t)t];
            k += !sn[j];
        }
        return k;
    }

    // a later round of m draws over the L entries of the compact list;
    // what it finds gets weight 0 there, as numpy zeroes it in p
    int64_t later_round(int64_t* found, int64_t n, int64_t m, int64_t L) {
        double acc = 0.0;
        for (int64_t k = 0; k < L; ++k) {
            acc += w[(size_t)k];
            cdf[(size_t)k] = acc;
        }
        for (int64_t k = 0; k < L; ++k) cdf[(size_t)k] /= acc;
        const double* c = cdf.data();
        int64_t* rr = r.data();
        int64_t i = 0;
        for (; i + kLanes <= m; i += kLanes)
            count_le_lanes(c, L, x.data() + i, rr + i);
        for (; i < m; ++i) rr[i] = count_le(c, L, x[(size_t)i]);
        unsigned char* sn = seen.data();
        for (i = 0; i < m; ++i) {
            const int64_t j = idx[(size_t)rr[i]];
            found[n] = j;
            n += !sn[j];
            sn[j] = 1;
        }
        for (i = 0; i < m; ++i) w[(size_t)rr[i]] = 0.0;
        return n;
    }

    void rows(Stream& rng, int64_t n_rows, int64_t* out) {
        for (int64_t row = 0; row < n_rows; ++row) {
            int64_t* found = out + row * size;
            rng.doubles(x.data(), size);
            draws += size;
            ++rounds;
            int64_t n = first_round(found);
            const int64_t L = n < size ? compact() : 0;
            while (n < size) {
                const int64_t m = size - n;
                rng.doubles(x.data(), m);
                draws += m;
                ++rounds;
                n = later_round(found, n, m, L);
            }
            for (int64_t i = 0; i < size; ++i) seen[(size_t)found[i]] = 0;
        }
    }
};

}  // namespace

extern "C" {

// The resumable replay (the entry points of vtpu_mt19937_seed and
// vtpu_choice_noreplace_resume, velocyto_tpu/native/vtpu.cpp:874-902):
// state625 holds the 624 MT19937 key words and the position.  Seed it
// with vtt_mt19937_seed, then call vtt_choice_noreplace_resume once per
// chunk of rows: it reads the state, samples n_rows rows into out
// ((n_rows, size) int64), writes the advanced state back and adds the
// rounds of the rejection loop it ran to *rounds, so a caller can hand
// each finished chunk on while the next one is sampled.  Returns the
// number of doubles drawn; -1 (nothing drawn) if fewer than `size`
// weights are positive (the sampling could not terminate), -2 if a
// weight is negative or not finite, their sum is not finite or pop is
// past INT32_MAX, -3 for a position past 624.
void vtt_mt19937_seed(uint32_t seed, uint32_t* state625) {
    state625[0] = seed;
    for (int i = 1; i < kN; ++i)
        state625[i] = 1812433253u * (state625[i - 1] ^ (state625[i - 1] >> 30))
                      + (uint32_t)i;
    state625[kN] = (uint32_t)kN;
}

int64_t vtt_choice_noreplace_resume(uint32_t* state625, int64_t n_rows,
                                    int64_t pop, int64_t size,
                                    const double* p_in, int64_t* out,
                                    int64_t* rounds) {
    if (state625[kN] > (uint32_t)kN) return -3;
    if (pop > INT32_MAX) return -2;
    int64_t positive = 0;
    double sum = 0.0;
    for (int64_t j = 0; j < pop; ++j) {
        if (!(p_in[j] >= 0.0) || !std::isfinite(p_in[j])) return -2;
        positive += p_in[j] > 0;
        sum += p_in[j];
    }
    if (!std::isfinite(sum)) return -2;
    if (positive < size) return -1;
    if (n_rows <= 0 || size <= 0) return 0;
    Stream rng(state625);
    Sampler s(p_in, pop, size);
    s.rows(rng, n_rows, out);
    rng.save(state625);
    *rounds += s.rounds;
    return s.draws;
}

}  // extern "C"
