// numpy-exact weighted sampling without replacement, for the neighbour
// sampling of VelocytoLoom.estimate_transition_prob(knn_random=True).
//
// A copy of the sampler of velocyto_tpu/native/vtpu.cpp (struct Mt19937,
// choice_rows_core, make_cdf0, vtpu_mt19937_seed,
// vtpu_choice_noreplace_resume), and of nothing else in that file: the
// port builds it on first use with the host C++ compiler and needs
// neither zlib nor the JAX package's prebuilt library.
//
// It replays numpy's legacy RandomState.choice(pop, size, replace=False,
// p=p) once per row, byte for byte: standard MT19937 (init_genrand seeding,
// numpy's 53-bit double recipe) driving the rejection loop of
// numpy/random/mtrand.pyx (zero the entries already found, cumsum and
// normalise, searchsorted side='right', keep first occurrences in draw
// order).  The positions and the final MT19937 state equal those of
// np.random.seed(seed) followed by one np.random.choice call per row.
//
// Build without -march=native and with -ffp-contract=off: the cdf sums
// must round exactly as numpy's do.

#include <stddef.h>
#include <stdint.h>

#include <vector>

namespace {

struct Mt19937 {
    uint32_t mt[624];
    int mti;
    explicit Mt19937(uint32_t s) {
        mt[0] = s;
        for (int i = 1; i < 624; ++i)
            mt[i] = 1812433253u * (mt[i - 1] ^ (mt[i - 1] >> 30)) + (uint32_t)i;
        mti = 624;
    }
    uint32_t next() {
        if (mti >= 624) {
            for (int i = 0; i < 624; ++i) {
                uint32_t y = (mt[i] & 0x80000000u) | (mt[(i + 1) % 624] & 0x7fffffffu);
                uint32_t v = mt[(i + 397) % 624] ^ (y >> 1);
                if (y & 1u) v ^= 2567483615u;
                mt[i] = v;
            }
            mti = 0;
        }
        uint32_t y = mt[mti++];
        y ^= y >> 11;
        y ^= (y << 7) & 2636928640u;
        y ^= (y << 15) & 4022730752u;
        y ^= y >> 18;
        return y;
    }
    double next_double() {   // numpy rk_double
        uint32_t a = next() >> 5, b = next() >> 6;
        return (a * 67108864.0 + b) / 9007199254740992.0;
    }
};

// The rejection loop for n_rows rows on one shared p.  The round-1 cdf
// (nothing zeroed yet) is the same for every row, so the caller computes
// it once (cdf0) and a bucket index over it narrows each round-1 search;
// later rounds search the re-normalised cdf.  Both searches are
// branchless counts r = #{j : cdf[j] <= x}, numpy's searchsorted
// side='right'.
int64_t choice_rows_core(Mt19937& rng, int64_t n_rows, int64_t pop,
                         int64_t size, const double* p_in,
                         const double* cdf0, int64_t* out) {
    std::vector<double> p(p_in, p_in + pop), cdf(pop), x((size_t)size);
    std::vector<unsigned char> seen((size_t)pop, 0);
    // r lies in [bstart[b], bstart[b+1]] for x in bucket b
    constexpr int64_t NB = 4096;
    std::vector<int32_t> bstart((size_t)NB + 1);
    {
        int64_t j = 0;
        for (int64_t b = 0; b < NB; ++b) {
            double thr = (double)b / (double)NB;
            while (j < pop && cdf0[j] <= thr) ++j;
            bstart[(size_t)b] = (int32_t)j;
        }
        bstart[(size_t)NB] = (int32_t)pop;
    }
    int64_t draws = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t* found = out + r * size;
        int64_t n_uniq = 0;
        bool first_round = true;
        while (n_uniq < size) {
            int64_t m = size - n_uniq;
            for (int64_t i = 0; i < m; ++i) x[(size_t)i] = rng.next_double();
            draws += m;
            if (first_round) {
                first_round = false;
                for (int64_t i = 0; i < m; ++i) {
                    double xv = x[(size_t)i];
                    int64_t b = (int64_t)(xv * (double)NB);
                    if (b < 0) b = 0;
                    if (b >= NB) b = NB - 1;
                    int64_t base = bstart[(size_t)b];
                    int64_t n2 = bstart[(size_t)b + 1] - base + 1;
                    while (n2 > 1) {
                        int64_t half = n2 >> 1;
                        base += (cdf0[(size_t)(base + half - 1)] <= xv)
                            ? half : 0;
                        n2 -= half;
                    }
                    int64_t lo = base;
                    if (lo < pop && !seen[(size_t)lo]) {
                        seen[(size_t)lo] = 1;
                        found[n_uniq++] = lo;
                    }
                }
                continue;
            }
            for (int64_t i = 0; i < n_uniq; ++i) p[(size_t)found[i]] = 0.0;
            double acc = 0.0;
            for (int64_t j = 0; j < pop; ++j) { acc += p[(size_t)j]; cdf[(size_t)j] = acc; }
            double tot = cdf[(size_t)pop - 1];
            for (int64_t j = 0; j < pop; ++j) cdf[(size_t)j] /= tot;
            for (int64_t i = 0; i < m; ++i) {
                double xv = x[(size_t)i];
                int64_t base = 0, n2 = pop;
                while (n2 > 1) {
                    int64_t half = n2 >> 1;
                    base += (cdf[(size_t)(base + half - 1)] <= xv) ? half : 0;
                    n2 -= half;
                }
                int64_t lo = base + (cdf[(size_t)base] <= xv);
                // keep first occurrences in draw order (numpy's
                // unique(return_index) + sorted indices + take)
                if (lo < pop && !seen[(size_t)lo]) {
                    seen[(size_t)lo] = 1;
                    found[n_uniq++] = lo;
                }
            }
        }
        for (int64_t i = 0; i < n_uniq; ++i) {
            seen[(size_t)found[i]] = 0;
            p[(size_t)found[i]] = p_in[(size_t)found[i]];
        }
    }
    return draws;
}

void make_cdf0(const double* p_in, int64_t pop, std::vector<double>& cdf0) {
    cdf0.resize((size_t)pop);
    double acc = 0.0;
    for (int64_t j = 0; j < pop; ++j) { acc += p_in[j]; cdf0[(size_t)j] = acc; }
    double tot = cdf0[(size_t)pop - 1];
    for (int64_t j = 0; j < pop; ++j) cdf0[(size_t)j] /= tot;
}

}  // namespace

extern "C" {

// The resumable replay (copies of vtpu_mt19937_seed and
// vtpu_choice_noreplace_resume, velocyto_tpu/native/vtpu.cpp:874-902):
// state625 holds the 624 MT19937 key words and the position.  Seed it
// with vtt_mt19937_seed, then call vtt_choice_noreplace_resume once per
// chunk of rows: it reads the state, samples n_rows rows into out
// ((n_rows, size) int64) and writes the advanced state back, so a caller
// can hand each finished chunk on while the next one is sampled.
// Returns the number of doubles drawn, or -1 if fewer than `size`
// weights are positive (the sampling could not terminate).
void vtt_mt19937_seed(uint32_t seed, uint32_t* state625) {
    Mt19937 rng(seed);
    for (int i = 0; i < 624; ++i) state625[i] = rng.mt[i];
    state625[624] = (uint32_t)rng.mti;
}

int64_t vtt_choice_noreplace_resume(uint32_t* state625, int64_t n_rows,
                                    int64_t pop, int64_t size,
                                    const double* p_in, int64_t* out) {
    int64_t positive = 0;
    for (int64_t j = 0; j < pop; ++j) positive += p_in[j] > 0;
    if (positive < size) return -1;
    Mt19937 rng(0);
    for (int i = 0; i < 624; ++i) rng.mt[i] = state625[i];
    rng.mti = (int)state625[624];
    std::vector<double> cdf0;
    make_cdf0(p_in, pop, cdf0);
    int64_t draws = choice_rows_core(rng, n_rows, pop, size, p_in,
                                     cdf0.data(), out);
    for (int i = 0; i < 624; ++i) state625[i] = rng.mt[i];
    state625[624] = (uint32_t)rng.mti;
    return draws;
}

}  // extern "C"
