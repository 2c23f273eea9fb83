// The randomized control's plan (analysis._permute_rows_nsign_plan): the
// row permutations and sign flips that permute_rows_nsign applies to a
// (g, n) matrix, drawn from numpy's legacy MT19937 stream without the
// matrix.  Per row, numpy's loop runs
//
//     RandomState.shuffle(arange(n))        (legacy Fisher-Yates)
//     RandomState.choice([+1, -1], size=n)  (a legacy randint(0, 2))
//
// and this file replays both, byte for byte, from a given MT19937 state
// (numpy's key and position, numpy/random/src/mt19937): the same
// permutations, the same signs, the same end state.
//
// - The shuffle swaps p[i] with p[j] for i from n-1 down to 1, j from
//   random_interval(i): with mask the smallest all-ones value >= i, it
//   draws 32-bit words until (w & mask) <= i.  i = 0 draws nothing.
// - The sign of a column is one word: w & 1 == 0 gives +1.
//
// The stream's own cost is the work (about 98M words for 2,000 rows of
// 20,000 columns), so the loops are built around it:
// - The generator keeps numpy's key and, beside it, the tempered words
//   of the current 624-word block, both written by one pass of the
//   recurrence (three loops, no modulo); a resumed state may sit anywhere
//   in its block.
// - The rejection loop has no data-dependent branch per word: the swap
//   index is a select, so a rejected word swaps p[i] with itself and i
//   stays; the mask is fixed while i stays in one power-of-two range.
// - The signs go straight into the packed output, eight words a byte
//   (one movemask of their low bits where the host has SSE2), the first
//   column in the top bit and 1 for +1 (np.packbits' layout).
//
// No other part of the port uses this generator (native/sampler.cpp has
// its own).  Built on first use with the host C++ compiler.

#include <stdint.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

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

struct Stream {
    uint32_t key[kN];     // numpy's state
    uint32_t word[kN];    // temper(key[k]): the block's output words
    int pos;              // numpy's position: the next word is word[pos]
    int64_t drawn = 0;

    Stream(const uint32_t* state) {
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
};

template <typename T>
void shuffle_row(Stream& s, T* p, int64_t n) {
    for (int64_t k = 0; k < n; ++k) p[k] = (T)k;
    if (n < 2) return;
    uint32_t i = (uint32_t)(n - 1);
    while (i > 0) {
        // i in [lo + 1, mask]: mask is random_interval's for every such i
        const uint32_t mask = ~0u >> __builtin_clz(i);
        const uint32_t lo = mask >> 1;
        while (i > lo) {
            if (s.pos == kN) s.refill();
            const uint32_t* w = s.word + s.pos;
            // i falls by at most one a word, so it stays above lo for
            // the next i - lo words: a counted loop, with no exit on i
            const uint32_t avail = (uint32_t)(kN - s.pos);
            const uint32_t cnt = avail < i - lo ? avail : i - lo;
            for (uint32_t k = 0; k < cnt; ++k) {
                const uint32_t v = w[k] & mask;
                const uint32_t ok = v <= i;
                const uint32_t j = ok ? v : i;
                const T t = p[i];
                p[i] = p[j];
                p[j] = t;
                i -= ok;
            }
            s.pos += (int)cnt;
            s.drawn += cnt;
        }
    }
}

inline uint32_t plus_bit(uint32_t w) { return ~w & 1u; }

#if defined(__SSE2__)
// kPlusByte[m]: the packed byte of eight words whose low bits are m's
// bits, word t in bit t (what _mm_movemask_ps gives): word t's sign in
// bit 7 - t, 1 for +1
struct PlusByte {
    uint8_t at[256];
    constexpr PlusByte() : at() {
        for (int m = 0; m < 256; ++m) {
            int b = 0;
            for (int t = 0; t < 8; ++t)
                if (!((m >> t) & 1)) b |= 1 << (7 - t);
            at[m] = (uint8_t)b;
        }
    }
};
constexpr PlusByte kPlusByte;
#endif

// the packed signs of the eight words w[0..7]
inline uint8_t plus_byte(const uint32_t* w) {
#if defined(__SSE2__)
    const __m128i a = _mm_slli_epi32(
        _mm_loadu_si128((const __m128i*)w), 31);
    const __m128i b = _mm_slli_epi32(
        _mm_loadu_si128((const __m128i*)(w + 4)), 31);
    return kPlusByte.at[_mm_movemask_ps(_mm_castsi128_ps(a)) |
                        _mm_movemask_ps(_mm_castsi128_ps(b)) << 4];
#else
    uint32_t b = 0;
    for (int t = 0; t < 8; ++t) b |= plus_bit(w[t]) << (7 - t);
    return (uint8_t)b;
#endif
}

void sign_row(Stream& s, uint8_t* out, int64_t n) {
    uint32_t acc = 0;     // the pending byte's bits, nb of them
    int nb = 0;
    int64_t c = 0;
    while (c < n) {
        if (s.pos == kN) s.refill();
        const int64_t rest = n - c;
        const int m = rest < kN - s.pos ? (int)rest : kN - s.pos;
        const uint32_t* w = s.word + s.pos;
        int k = 0;
        for (; nb != 0 && k < m; ++k) {
            acc = (acc << 1) | plus_bit(w[k]);
            if (++nb == 8) {
                *out++ = (uint8_t)acc;
                acc = 0;
                nb = 0;
            }
        }
        for (; k + 8 <= m; k += 8) *out++ = plus_byte(w + k);
        for (; k < m; ++k) {
            acc = (acc << 1) | plus_bit(w[k]);
            ++nb;
        }
        s.pos += m;
        s.drawn += m;
        c += m;
    }
    if (nb != 0) *out = (uint8_t)(acc << (8 - nb));
}

template <typename T>
void plan(Stream& s, int64_t g, int64_t n, T* perms, uint8_t* bits) {
    const int64_t nbytes = (n + 7) / 8;
    for (int64_t r = 0; r < g; ++r) {
        shuffle_row(s, perms + r * n, n);
        sign_row(s, bits + r * nbytes, n);
    }
}

}  // namespace

extern "C" {

// state: 625 words, numpy's key then its position (0..624), advanced in
// place to numpy's end state.  perms: (g, n) of perm_bytes-wide integers
// (2: uint16, 4: int32); bits: (g, ceil(n / 8)).  Returns the words
// drawn, or -1 (nothing written) for a position past 624, a width other
// than 2 or 4, or n past what the width holds.
int64_t vtt_permute_plan(uint32_t* state, int64_t g, int64_t n,
                         int perm_bytes, void* perms, uint8_t* bits) {
    if (state[kN] > (uint32_t)kN || g < 0 || n < 0) return -1;
    if (perm_bytes == 2 ? n > 65536 : perm_bytes != 4 || n > INT32_MAX)
        return -1;
    Stream s(state);
    if (perm_bytes == 2)
        plan(s, g, n, (uint16_t*)perms, bits);
    else
        plan(s, g, n, (int32_t*)perms, bits);
    s.save(state);
    return s.drawn;
}

}  // extern "C"
