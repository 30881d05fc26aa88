// Batched EBCOT Tier-1 coder — native host implementation.
//
// Brand-new implementation from ITU-T T.800 Annex D + T.88 (same algorithm
// as grok_tpu/t1/ebcot_np.py, which is the bit-exact reference; this file is
// the fast host path the reference keeps in t1/t1_part1/, re-written from
// the standard, not copied). Lane order, pass structure, termination and
// byte-stuffing match the batched numpy coder exactly.
//
// Build: g++ -O3 -fPIC -shared -fopenmp -o libgrok_tpu_native.so t1_coder.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

#include "mq_decoder.h"
#include "omp_util.h"

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------- MQ coder
// tables + the bit-reservoir decoder live in mq_decoder.h (shared with the
// lockstep oracle in tools/mq_dual_check.cpp)
using mqshared::MQM;
using mqshared::MQR;
using mqshared::MQDecoder;
using mqshared::MqMergedState;
using mqshared::NUM_CTX;
using mqshared::CTX_ZC0;
using mqshared::CTX_SC0;
using mqshared::CTX_MR0;
using mqshared::CTX_RL;
using mqshared::CTX_UNI;

// codeblock style flags (T.800 Table A-19)
constexpr int STY_BYPASS = 0x01, STY_RESET = 0x02, STY_TERMALL = 0x04,
              STY_VSC = 0x08, STY_PTERM = 0x10, STY_SEGSYM = 0x20;

#ifdef _OPENMP
using ompshared::resolve_threads;  // non-sticky thread resolution
#endif

struct MQEncoder {
    uint32_t a = 0x8000, c = 0;
    int ct = 12;
    uint8_t* buf;  // buf[0] is the virtual carry byte
    int64_t pos = 0;
    int64_t cap = INT64_MAX;  // buffer capacity; writes past it set overflow
    bool overflow = false;
    uint32_t state[NUM_CTX];  // MqRecords entries (one-load, see MQR)

    void reset_ctx() {
        for (int i = 0; i < NUM_CTX; i++) state[i] = MQR.rec[0];
        state[CTX_ZC0] = MQR.rec[2 * 4];
        state[CTX_RL] = MQR.rec[2 * 3];
        state[CTX_UNI] = MQR.rec[2 * 46];
    }

    void init(uint8_t* b, int64_t capacity = INT64_MAX) {
        buf = b;
        buf[0] = 0;
        cap = capacity;
        overflow = false;
        reset_ctx();
    }

    // bounds-checked append: the buffer size in native.py is a heuristic with
    // no worst-case proof, so a pathological block must flag an error instead
    // of silently overrunning the heap
    inline void push(uint8_t v) {
        if (pos + 1 >= cap) {
            overflow = true;
            return;
        }
        buf[++pos] = v;
    }

    void byteout() {
        uint8_t b = buf[pos];
        if (b == 0xFF) {
            push((uint8_t)(c >> 20));
            c &= 0xFFFFF;
            ct = 7;
        } else {
            if ((c & 0x8000000u) == 0) {
                push((uint8_t)(c >> 19));
                c &= 0x7FFFF;
                ct = 8;
            } else {
                buf[pos] = (uint8_t)(b + 1);
                if (buf[pos] == 0xFF) {
                    c &= 0x7FFFFFF;
                    push((uint8_t)(c >> 20));
                    c &= 0xFFFFF;
                    ct = 7;
                } else {
                    push((uint8_t)(c >> 19));
                    c &= 0x7FFFF;
                    ct = 8;
                }
            }
        }
    }

    inline void renorm() {
        do {
            a <<= 1;
            c <<= 1;
            if (--ct == 0) byteout();
        } while ((a & 0x8000) == 0);
    }

    inline void encode(int bit, int ctx) {
        uint32_t s = state[ctx];
        uint32_t qe = s & 0xFFFF;
        if (__builtin_expect(bit == (int)((s >> 16) & 1), 1)) {
            a -= qe;
            if (__builtin_expect((a & 0x8000) == 0, 0)) {
                if (a < qe)
                    a = qe;
                else
                    c += qe;
                state[ctx] = MQR.rec[(s >> 17) & 0x7F];
                renorm();
            } else {
                c += qe;
            }
        } else {
            a -= qe;
            if (a < qe)
                c += qe;
            else
                a = qe;
            state[ctx] = MQR.rec[(s >> 24) & 0x7F];
            renorm();
        }
    }

    void flush() {
        uint32_t tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
    }

    int64_t length() const {
        // bytes 1..pos, excluding a trailing 0xFF
        return pos + (buf[pos] != 0xFF ? 1 : 0) - 1;
    }

    // terminate the current codeword segment and restart for the next one
    // (TERMALL); returns the cumulative stream length so far
    int64_t terminate_restart() {
        flush();
        int64_t len = length();
        pos = len;  // buf[pos] = last counted byte (never 0xFF)
        a = 0x8000;
        c = 0;
        ct = buf[pos] == 0xFF ? 13 : 12;
        return len;
    }

    // ---- raw (bypass) emission into the same buffer --------------------
    // Raw bits go MSB-first with 0xFF stuffing, continuing at the byte
    // after the last MQ byte. Invariant: pos = index of last written byte;
    // stream length so far = pos (buffer index 0 is the virtual byte).
    uint32_t raw_tmp = 0;
    int raw_used = 0;   // bits used in the pending raw byte
    int raw_avail = 8;  // capacity of the pending byte (7 after an 0xFF)

    void raw_start() {
        raw_tmp = 0;
        raw_used = 0;
        raw_avail = buf[pos] == 0xFF ? 7 : 8;
    }

    void raw_bit(int v) {
        raw_tmp = (raw_tmp << 1) | (uint32_t)v;
        if (++raw_used == raw_avail) {
            push((uint8_t)raw_tmp);
            raw_avail = buf[pos] == 0xFF ? 7 : 8;
            raw_tmp = 0;
            raw_used = 0;
        }
    }

    // conservative decodable-prefix length while inside a raw pass
    int64_t raw_safe_len() const { return pos + (raw_used > 0 ? 1 : 0); }

    // byte-align the raw segment and restart MQ; returns stream length
    int64_t raw_terminate_restart_mq() {
        if (raw_used > 0) {
            raw_tmp <<= (raw_avail - raw_used);
            push((uint8_t)raw_tmp);
        }
        if (buf[pos] == 0xFF) push(0);  // raw segments can't end 0xFF
        int64_t len = pos;
        a = 0x8000;
        c = 0;
        ct = buf[pos] == 0xFF ? 13 : 12;
        return len;
    }
};


// ------------------------------------------------------ stripe-word state
// One uint64 per (stripe, column) covers a 4-row column and carries the
// entire coding neighborhood in-word, so each pass loads ONE word per
// column instead of four per-sample flag words (the reference's T1 keeps
// an equivalent stripe-oriented packed-flags scheme in t1/t1_part1/; this
// 64-bit layout and the LUT indexing are our own design):
//
//   bits 0-17  : significance of columns {left,self,right} x rows {-1..4}
//                bit index = col*6 + (row+1)
//   bits 18-21 : VISITED, own rows 0-3 (coded earlier in current plane)
//   bits 22-25 : REFINED, own rows 0-3
//   bits 26-31 : sign of self column rows -1..4   (1 = negative)
//   bits 32-35 : sign of left column rows 0-3
//   bits 36-39 : sign of right column rows 0-3
//   bits 40-43 : own-coefficient sign rows 0-3 (encoder prefill)

#if defined(__BMI2__)
#include <immintrin.h>
#endif

constexpr uint64_t W_SIG18 = 0x3FFFFULL;
constexpr uint64_t W_VIS4 = 0xFULL << 18;
// significance contributed by row 4 (the stripe below), dropped under VSC
constexpr uint64_t W_VSC_SIGCUT = (1ULL << 5) | (1ULL << 11) | (1ULL << 17);
// bit positions feeding the sign-context key for row k (ascending order):
// sigL(1+k) sigU(6+k) sigD(8+k) sigR(13+k) sgnU(26+k) sgnD(28+k)
// sgnL(32+k) sgnR(36+k)
constexpr uint64_t SC_PEXT = (1ULL << 1) | (1ULL << 6) | (1ULL << 8) |
                             (1ULL << 13) | (1ULL << 26) | (1ULL << 28) |
                             (1ULL << 32) | (1ULL << 36);
constexpr uint64_t ZC_PEXT = 0x71C7ULL;  // rows k-1..k+1 of all 3 columns

// 4-bit "has a significant neighbor" mask over rows 0-3, computed from a
// whole stripe word at once: bit k set iff row k's 8-neighborhood (the
// zkey & 0x1EF test) is non-empty. Lets the SPP scan skip all
// no-neighbor rows of a column without per-row pext+test. The caller
// pre-clears W_VSC_SIGCUT under VSC (row-4 contributions).
static inline unsigned nbr4(uint64_t w) {
    unsigned LR = (unsigned)((w | (w >> 12)) & 0x3F);  // left|right column
    unsigned S = (unsigned)((w >> 6) & 0x3F);          // self column
    // row k sees L/R rows k-1..k+1 (bits k..k+2) and self rows k-1,k+1
    return ((LR | (LR >> 1) | (LR >> 2)) | S | (S >> 2)) & 0xFu;
}

// 9-bit neighborhood-significance key for row k: bits 0-2 left column
// rows k-1..k+1, bits 3-5 self column (bit 4 = self, ignored by the LUT),
// bits 6-8 right column
static inline uint32_t zkey(uint64_t w, int k) {
#if defined(__BMI2__)
    return (uint32_t)_pext_u64(w, ZC_PEXT << k);
#else
    return (uint32_t)(((w >> k) & 7) | (((w >> (6 + k)) & 7) << 3) |
                      (((w >> (12 + k)) & 7) << 6));
#endif
}

// 8-bit sign-context key for row k:
// sigL | sigU<<1 | sigD<<2 | sigR<<3 | sgnU<<4 | sgnD<<5 | sgnL<<6 | sgnR<<7
static inline uint32_t skey(uint64_t w, int k) {
#if defined(__BMI2__)
    return (uint32_t)_pext_u64(w, SC_PEXT << k);
#else
    return (uint32_t)(((w >> (1 + k)) & 1) | (((w >> (6 + k)) & 1) << 1) |
                      (((w >> (8 + k)) & 1) << 2) |
                      (((w >> (13 + k)) & 1) << 3) |
                      (((w >> (26 + k)) & 1) << 4) |
                      (((w >> (28 + k)) & 1) << 5) |
                      (((w >> (32 + k)) & 1) << 6) |
                      (((w >> (36 + k)) & 1) << 7));
#endif
}

struct StripeLuts {
    uint8_t zc9[4][512];              // [orient][9-bit neighborhood key]
    uint8_t sc_ctx[256], sc_xor[256]; // [8-bit sign key, skey() layout]
    StripeLuts() {
        auto normal = [](int h, int v, int d) -> int {
            if (h == 2) return 8;
            if (h == 1) {
                if (v >= 1) return 7;
                return d >= 1 ? 6 : 5;
            }
            if (v == 2) return 4;
            if (v == 1) return 3;
            return d >= 2 ? 2 : (d == 1 ? 1 : 0);
        };
        auto hh = [](int h, int v, int d) -> int {
            int a = h + v;
            if (d >= 3) return 8;
            if (d == 2) return a >= 1 ? 7 : 6;
            if (d == 1) return a >= 2 ? 5 : (a == 1 ? 4 : 3);
            return a >= 2 ? 2 : (a == 1 ? 1 : 0);
        };
        for (int key = 0; key < 512; key++) {
            int l = key & 7, c = (key >> 3) & 7, r = (key >> 6) & 7;
            int hc = ((l >> 1) & 1) + ((r >> 1) & 1);
            int vc = (c & 1) + ((c >> 2) & 1);
            int dc = (l & 1) + ((l >> 2) & 1) + (r & 1) + ((r >> 2) & 1);
            zc9[0][key] = (uint8_t)normal(hc, vc, dc);
            zc9[2][key] = (uint8_t)normal(hc, vc, dc);
            zc9[1][key] = (uint8_t)normal(vc, hc, dc);
            zc9[3][key] = (uint8_t)hh(hc, vc, dc);
        }
        // sign coding (T.800 Table D-3), rows hbar=-1..1, cols vbar=-1..1
        const int tbl[3][3][2] = {
            {{13, 1}, {12, 1}, {11, 1}},
            {{10, 1}, {9, 0}, {10, 0}},
            {{11, 0}, {12, 0}, {13, 0}},
        };
        for (int idx = 0; idx < 256; idx++) {
            int sigL = idx & 1, sigU = (idx >> 1) & 1, sigD = (idx >> 2) & 1;
            int sigR = (idx >> 3) & 1, sgnU = (idx >> 4) & 1;
            int sgnD = (idx >> 5) & 1, sgnL = (idx >> 6) & 1;
            int sgnR = (idx >> 7) & 1;
            int hb = (sigL ? (sgnL ? -1 : 1) : 0) + (sigR ? (sgnR ? -1 : 1) : 0);
            int vb = (sigU ? (sgnU ? -1 : 1) : 0) + (sigD ? (sgnD ? -1 : 1) : 0);
            hb = hb < -1 ? -1 : (hb > 1 ? 1 : hb);
            vb = vb < -1 ? -1 : (vb > 1 ? 1 : vb);
            sc_ctx[idx] = (uint8_t)tbl[hb + 1][vb + 1][0];
            sc_xor[idx] = (uint8_t)tbl[hb + 1][vb + 1][1];
        }
    }
};
static const StripeLuts SL;

// distortion decrease helpers (squared-error change in coefficient units of
// 2^{2p}; caller scales by step^2 * bandnorm^2 outside). Constants are
// hoisted per pass — ldexp per coded event was ~100M libm calls per 4K
// frame. Algebra matches ebcot_np exactly (same fp64 op order).
struct DistConsts {
    double sig_c1, sig_c2;  // dd_sig = c1*v - c2  (= v^2 - (v - 1.5*2^p)^2)
    double full, half;      // 2^p, 0.5*2^p
    int64_t m1, m2;         // masks: 2^(p+1)-1, 2^p-1
    explicit DistConsts(int p)
        : sig_c1(std::ldexp(3.0, p)),
          sig_c2(std::ldexp(2.25, 2 * p)),
          full(std::ldexp(1.0, p)),
          half(std::ldexp(0.5, p)),
          m1((int64_t(2) << p) - 1),
          m2((int64_t(1) << p) - 1) {}
};
static inline double dd_sig(int64_t v, const DistConsts& dc) {
    return dc.sig_c1 * (double)v - dc.sig_c2;
}
static inline double dd_ref(int64_t v, const DistConsts& dc) {
    // (v - rb)^2 - (v - ra)^2 with rb/ra the pre/post-refinement mid-bins
    double a1 = (double)(v & dc.m1) - dc.full;
    double a2 = (double)(v & dc.m2) - dc.half;
    return a1 * a1 - a2 * a2;
}

// ------------------------------------------------------------ block state
struct BlockCtx2 {
    int h, w, orient;
    int ws;       // word-row stride = W + 2 (padded columns)
    int mstride;  // magnitude row stride = W
    bool vsc;
    uint64_t* words;  // padded (num_stripes + 2) x ws
    uint32_t* mag;    // unpadded h x mstride
    uint64_t* colact = nullptr;  // per-stripe column-activity bits (w <= 64)
    uint64_t* colfull = nullptr;  // columns whose 4 rows are all significant:
                                  // no SPP/CUP candidates remain, skip them
    bool use_bits = false;
    uint64_t wmask = 0;
    uint32_t zmask[4] = {}, smask[4] = {};  // per-row VSC key masks (init())

    inline uint64_t* row(int s) const {
        return words + (int64_t)(s + 1) * ws;
    }

    void init(uint64_t* colbuf) {
        zmask[0] = zmask[1] = zmask[2] = 0x1FF;
        smask[0] = smask[1] = smask[2] = 0xFF;
        // VSC stripe bottom: drop row-below significance (zkey bits 2/5/8)
        // and the below sig+sign from the sign key (skey bits 2/5)
        zmask[3] = vsc ? 0x0DB : 0x1FF;
        smask[3] = vsc ? 0xDB : 0xFF;
        colact = colbuf;
        colfull = colbuf + (h + 3) / 4 + 1;
        use_bits = w <= 64;
        wmask = w >= 64 ? ~0ULL : ((1ULL << w) - 1);
        if (use_bits) {
            std::memset(colact, 0, ((h + 3) / 4) * sizeof(uint64_t));
            std::memset(colfull, 0, ((h + 3) / 4) * sizeof(uint64_t));
        }
    }

    // call with the LOCAL word after its self-sig bit was set
    inline void mark_full(uint64_t w_word, int s, int x) {
        if (use_bits && (w_word & (0xFULL << 7)) == (0xFULL << 7))
            colfull[s] |= 1ULL << x;
    }

    inline void colact_mark(int y, int x) {
        if (!use_bits) return;
        uint64_t m = (x > 0 ? 7ULL << (x - 1) : 3ULL) & wmask;
        colact[y >> 2] |= m;
        if (y > 0) colact[(y - 1) >> 2] |= m;
        if (y + 1 < h) colact[(y + 1) >> 2] |= m;
    }

    // neighbor-word updates when (stripe word row Wr, padded col x1, row k)
    // becomes significant; the caller applies the self-word bits
    //   (1<<(7+k)) | (neg<<(27+k)) to its local copy
    inline void mark_nbr(uint64_t* Wr, int x1, int k, uint64_t neg) {
        Wr[x1 - 1] |= (1ULL << (13 + k)) | (neg << (36 + k));
        Wr[x1 + 1] |= (1ULL << (1 + k)) | (neg << (32 + k));
        if (k == 0) {  // row above lives in the stripe word above
            uint64_t* U = Wr - ws;
            U[x1] |= (1ULL << 11) | (neg << 31);
            U[x1 - 1] |= 1ULL << 17;
            U[x1 + 1] |= 1ULL << 5;
        } else if (k == 3) {  // row below lives in the stripe word below
            uint64_t* D = Wr + ws;
            D[x1] |= (1ULL << 6) | (neg << 26);
            D[x1 - 1] |= 1ULL << 12;
            D[x1 + 1] |= 1ULL;
        }
    }
};

// --------------------------------------------------------------- encoder
template <bool WD>
static void enc_spp(BlockCtx2& B, MQEncoder& mq_io, int plane, double* dist,
                    bool raw = false) {
    // Local copy: a non-escaping local cannot alias the magnitude/flag-word
    // stores (uint32_t*/uint64_t* may legally alias the coder's uint32_t/
    // int64_t members), so a/c/ct/pos stay in registers for the whole pass.
    MQEncoder mq = mq_io;
    const uint8_t* zc = SL.zc9[B.orient];
    const DistConsts dc(plane);
    for (int s = 0, y0 = 0; y0 < B.h; s++, y0 += 4) {
        int rows = std::min(4, B.h - y0);
        uint64_t* Wr = B.row(s);
        auto col = [&](int x) __attribute__((always_inline)) {
            int x1 = x + 1;
            uint64_t w0 = Wr[x1], w = w0;
            const uint32_t* mg = B.mag + (int64_t)y0 * B.mstride + x;
            unsigned cand = ~(unsigned)(w >> 7) & ((1u << rows) - 1);
            // see dec_spp: the nbr4 jump visits exactly the rows the
            // sequential scan's (key & 0x1EF) test would code
            unsigned live =
                cand & nbr4(B.vsc ? (w & ~W_VSC_SIGCUT) : w);
            while (live) {
                int k = __builtin_ctz(live);
                cand &= ~((2u << k) - 1);
                uint32_t key = zkey(w, k) & B.zmask[k];
                uint32_t m = mg[k * B.mstride];
                int bit = (int)((m >> plane) & 1);
                if (raw)
                    mq.raw_bit(bit);
                else
                    mq.encode(bit, zc[key]);
                w |= 1ULL << (18 + k);
                if (bit) {
                    uint64_t neg = (w >> (40 + k)) & 1;
                    if (raw) {
                        mq.raw_bit((int)neg);
                    } else {
                        uint32_t si = skey(w, k) & B.smask[k];
                        mq.encode((int)(neg ^ SL.sc_xor[si]), SL.sc_ctx[si]);
                    }
                    w |= (1ULL << (7 + k)) | (neg << (27 + k));
                    B.mark_nbr(Wr, x1, k, neg);
                    B.colact_mark(y0 + k, x);
                    B.mark_full(w, s, x);
                    if (WD) *dist += dd_sig((int64_t)m, dc);
                    live = cand & nbr4(B.vsc ? (w & ~W_VSC_SIGCUT) : w);
                } else {
                    live &= live - 1;
                }
            }
            if (w != w0) Wr[x1] = w;
        };
        if (B.use_bits) {
            uint64_t done = 0;
            for (;;) {
                uint64_t avail =
                    B.colact[s] & B.wmask & ~B.colfull[s] & ~done;
                if (!avail) break;
                int x = __builtin_ctzll(avail);
                // strictly left-to-right: a bit newly set at x-1 by a
                // mark during col(x) must not be revisited this pass
                done |= (2ULL << x) - 1;
                col(x);
            }
        } else {
            for (int x = 0; x < B.w; x++) {
                if (!(Wr[x + 1] & W_SIG18)) continue;
                col(x);
            }
        }
    }
    mq_io = mq;
}

template <bool WD>
static void enc_mrp(BlockCtx2& B, MQEncoder& mq_io, int plane, double* dist,
                    bool raw = false) {
    MQEncoder mq = mq_io;  // local copy, see enc_spp
    const DistConsts dc(plane);
    for (int s = 0, y0 = 0; y0 < B.h; s++, y0 += 4) {
        int rows = std::min(4, B.h - y0);
        uint64_t* Wr = B.row(s);
        auto col = [&](int x) __attribute__((always_inline)) {
            int x1 = x + 1;
            uint64_t w0 = Wr[x1], w = w0;
            const uint32_t* mg = B.mag + (int64_t)y0 * B.mstride + x;
            unsigned cand = (unsigned)(w >> 7) & ~(unsigned)(w >> 18) &
                            ((1u << rows) - 1);
            while (cand) {
                int k = __builtin_ctz(cand);
                cand &= cand - 1;
                uint32_t m = mg[k * B.mstride];
                int bit = (int)((m >> plane) & 1);
                if (raw) {
                    mq.raw_bit(bit);
                } else {
                    int ctx;
                    if (w & (1ULL << (22 + k))) {
                        ctx = CTX_MR0 + 2;
                    } else {
                        uint32_t key = zkey(w, k) & B.zmask[k];
                        ctx = (key & 0x1EF) ? CTX_MR0 + 1 : CTX_MR0;
                    }
                    mq.encode(bit, ctx);
                }
                w |= 1ULL << (22 + k);
                if (WD) *dist += dd_ref((int64_t)m, dc);
            }
            if (w != w0) Wr[x1] = w;
        };
        if (B.use_bits) {
            uint64_t avail = B.colact[s] & B.wmask;
            while (avail) {
                int x = __builtin_ctzll(avail);
                avail &= avail - 1;
                col(x);
            }
        } else {
            for (int x = 0; x < B.w; x++) {
                if (!(Wr[x + 1] & (0xFULL << 7))) continue;  // no sig rows
                col(x);
            }
        }
    }
    mq_io = mq;
}

template <bool WD>
static void enc_cup(BlockCtx2& B, MQEncoder& mq_io, int plane, double* dist,
                    bool segsym) {
    MQEncoder mq = mq_io;  // local copy, see enc_spp
    const uint8_t* zc = SL.zc9[B.orient];
    const DistConsts dc(plane);
    const uint64_t rlmask =
        (B.vsc ? (W_SIG18 & ~W_VSC_SIGCUT) : W_SIG18) | W_VIS4;
    for (int s = 0, y0 = 0; y0 < B.h; s++, y0 += 4) {
        int rows = std::min(4, B.h - y0);
        bool full = rows == 4;
        uint64_t* Wr = B.row(s);
        auto cup_one = [&](int x) __attribute__((always_inline)) {
            int x1 = x + 1;
            uint64_t w0 = Wr[x1], w = w0;
            const uint32_t* mg = B.mag + (int64_t)y0 * B.mstride + x;
            int first_k = 4;
            bool rl = false;
            if (full) {
                if (B.use_bits && !((B.colact[s] >> x) & 1))
                    rl = true;  // untouched column: provably all-clear
                else
                    rl = (w & rlmask) == 0;
            }
            if (rl) {
                for (int k = 0; k < 4; k++)
                    if ((mg[k * B.mstride] >> plane) & 1) {
                        first_k = k;
                        break;
                    }
                mq.encode(first_k < 4 ? 1 : 0, CTX_RL);
                if (first_k == 4) return;  // whole column stays zero
                mq.encode((first_k >> 1) & 1, CTX_UNI);
                mq.encode(first_k & 1, CTX_UNI);
            }
            unsigned cand = ~(unsigned)((w >> 7) | (w >> 18)) &
                            ((1u << rows) - 1);
            if (rl) cand &= ~((1u << first_k) - 1);
            while (cand) {
                int k = __builtin_ctz(cand);
                cand &= cand - 1;
                int bit;
                if (rl && k == first_k) {
                    bit = 1;  // significance implied by the run interrupt
                } else {
                    bit = (int)((mg[k * B.mstride] >> plane) & 1);
                    mq.encode(bit, zc[zkey(w, k) & B.zmask[k]]);
                }
                if (bit) {
                    uint64_t neg = (w >> (40 + k)) & 1;
                    uint32_t si = skey(w, k) & B.smask[k];
                    mq.encode((int)(neg ^ SL.sc_xor[si]), SL.sc_ctx[si]);
                    w |= (1ULL << (7 + k)) | (neg << (27 + k));
                    B.mark_nbr(Wr, x1, k, neg);
                    B.colact_mark(y0 + k, x);
                    B.mark_full(w, s, x);
                    if (WD) *dist += dd_sig((int64_t)mg[k * B.mstride], dc);
                }
            }
            if (w != w0) Wr[x1] = w;
        };
        if (B.use_bits) {
            // all-significant columns have no CUP candidates: skip (the
            // decoder maintains the same bitset, so the scan stays in step)
            uint64_t cols = B.wmask & ~B.colfull[s];
            while (cols) {
                int x = __builtin_ctzll(cols);
                cols &= cols - 1;
                cup_one(x);
            }
        } else {
            for (int x = 0; x < B.w; x++) cup_one(x);
        }
    }
    if (segsym) {  // segmentation symbol 1010 in the UNIFORM context
        mq.encode(1, CTX_UNI);
        mq.encode(0, CTX_UNI);
        mq.encode(1, CTX_UNI);
        mq.encode(0, CTX_UNI);
    }
    mq_io = mq;
}

// --------------------------------------------------------------- decoder
static void dec_spp(BlockCtx2& B, MQDecoder& mq_io, int plane, bool raw = false) {
    MQDecoder mq = mq_io;  // local copy, see enc_spp
    const uint8_t* zc = SL.zc9[B.orient];
    for (int s = 0, y0 = 0; y0 < B.h; s++, y0 += 4) {
        int rows = std::min(4, B.h - y0);
        uint64_t* Wr = B.row(s);
        auto col = [&](int x) __attribute__((always_inline)) {
            int x1 = x + 1;
            uint64_t w0 = Wr[x1], w = w0;
            uint32_t* mg = B.mag + (int64_t)y0 * B.mstride + x;
            unsigned cand = ~(unsigned)(w >> 7) & ((1u << rows) - 1);
            // scan order is top-down and w only changes on a hit, so
            // jumping to the next live (has-neighbor) row evaluates each
            // skipped row with exactly the state a sequential scan would
            unsigned live =
                cand & nbr4(B.vsc ? (w & ~W_VSC_SIGCUT) : w);
            while (live) {
                int k = __builtin_ctz(live);
                cand &= ~((2u << k) - 1);  // rows <= k are done this pass
                int bit = raw ? mq.raw_bit()
                              : mq.decode(zc[zkey(w, k) & B.zmask[k]]);
                w |= 1ULL << (18 + k);
                if (bit) {
                    uint64_t neg;
                    if (raw) {
                        neg = (uint64_t)mq.raw_bit();
                    } else {
                        uint32_t si = skey(w, k) & B.smask[k];
                        neg = (uint64_t)(mq.decode(SL.sc_ctx[si]) ^
                                         SL.sc_xor[si]);
                    }
                    // scaled-by-2 magnitudes: reconstruct at 1.5 * 2^plane
                    // (the reference's oneplushalf mid-bin convention)
                    mg[k * B.mstride] = 3u << plane;
                    w |= (1ULL << (7 + k)) | (neg << (27 + k));
                    B.mark_nbr(Wr, x1, k, neg);
                    B.colact_mark(y0 + k, x);
                    B.mark_full(w, s, x);
                    live = cand & nbr4(B.vsc ? (w & ~W_VSC_SIGCUT) : w);
                } else {
                    live &= live - 1;
                }
            }
            if (w != w0) Wr[x1] = w;
        };
        if (B.use_bits) {
            uint64_t done = 0;
            for (;;) {
                uint64_t avail =
                    B.colact[s] & B.wmask & ~B.colfull[s] & ~done;
                if (!avail) break;
                int x = __builtin_ctzll(avail);
                done |= (2ULL << x) - 1;
                col(x);
            }
        } else {
            for (int x = 0; x < B.w; x++) {
                if (!(Wr[x + 1] & W_SIG18)) continue;
                col(x);
            }
        }
    }
    mq_io = mq;
}

static void dec_mrp(BlockCtx2& B, MQDecoder& mq_io, int plane, bool raw = false) {
    MQDecoder mq = mq_io;  // local copy, see enc_spp
    for (int s = 0, y0 = 0; y0 < B.h; s++, y0 += 4) {
        int rows = std::min(4, B.h - y0);
        uint64_t* Wr = B.row(s);
        auto col = [&](int x) __attribute__((always_inline)) {
            int x1 = x + 1;
            uint64_t w0 = Wr[x1], w = w0;
            uint32_t* mg = B.mag + (int64_t)y0 * B.mstride + x;
            unsigned cand = (unsigned)(w >> 7) & ~(unsigned)(w >> 18) &
                            ((1u << rows) - 1);
            while (cand) {
                int k = __builtin_ctz(cand);
                cand &= cand - 1;
                int bit;
                if (raw) {
                    bit = mq.raw_bit();
                } else {
                    int ctx;
                    if (w & (1ULL << (22 + k))) {
                        ctx = CTX_MR0 + 2;
                    } else {
                        uint32_t key = zkey(w, k) & B.zmask[k];
                        ctx = (key & 0x1EF) ? CTX_MR0 + 1 : CTX_MR0;
                    }
                    bit = mq.decode(ctx);
                }
                // refinement re-centers to the half-bin (+-2^(plane-1),
                // i.e. +-2^plane in scaled units)
                if (bit)
                    mg[k * B.mstride] += 1u << plane;
                else
                    mg[k * B.mstride] -= 1u << plane;
                w |= 1ULL << (22 + k);
            }
            if (w != w0) Wr[x1] = w;
        };
        if (B.use_bits) {
            uint64_t avail = B.colact[s] & B.wmask;
            while (avail) {
                int x = __builtin_ctzll(avail);
                avail &= avail - 1;
                col(x);
            }
        } else {
            for (int x = 0; x < B.w; x++) {
                if (!(Wr[x + 1] & (0xFULL << 7))) continue;
                col(x);
            }
        }
    }
    mq_io = mq;
}

static void dec_cup(BlockCtx2& B, MQDecoder& mq_io, int plane, bool segsym) {
    MQDecoder mq = mq_io;  // local copy, see enc_spp
    const uint8_t* zc = SL.zc9[B.orient];
    const uint64_t rlmask =
        (B.vsc ? (W_SIG18 & ~W_VSC_SIGCUT) : W_SIG18) | W_VIS4;
    for (int s = 0, y0 = 0; y0 < B.h; s++, y0 += 4) {
        int rows = std::min(4, B.h - y0);
        bool full = rows == 4;
        uint64_t* Wr = B.row(s);
        auto cup_one = [&](int x) __attribute__((always_inline)) {
            int x1 = x + 1;
            uint64_t w0 = Wr[x1], w = w0;
            uint32_t* mg = B.mag + (int64_t)y0 * B.mstride + x;
            int first_k = 0;
            bool rl = false;
            if (full) {
                if (B.use_bits && !((B.colact[s] >> x) & 1))
                    rl = true;
                else
                    rl = (w & rlmask) == 0;
            }
            if (rl) {
                if (!mq.decode(CTX_RL)) return;
                int b1 = mq.decode(CTX_UNI);
                int b0 = mq.decode(CTX_UNI);
                first_k = (b1 << 1) | b0;
            }
            unsigned cand = ~(unsigned)((w >> 7) | (w >> 18)) &
                            ((1u << rows) - 1);
            if (rl) cand &= ~((1u << first_k) - 1);
            while (cand) {
                int k = __builtin_ctz(cand);
                cand &= cand - 1;
                int bit;
                if (rl && k == first_k) {
                    bit = 1;
                } else {
                    bit = mq.decode(zc[zkey(w, k) & B.zmask[k]]);
                }
                if (bit) {
                    uint32_t si = skey(w, k) & B.smask[k];
                    uint64_t neg = (uint64_t)(mq.decode(SL.sc_ctx[si]) ^
                                              SL.sc_xor[si]);
                    mg[k * B.mstride] = 3u << plane;  // mid-bin (scaled-by-2)
                    w |= (1ULL << (7 + k)) | (neg << (27 + k));
                    B.mark_nbr(Wr, x1, k, neg);
                    B.colact_mark(y0 + k, x);
                    B.mark_full(w, s, x);
                }
            }
            if (w != w0) Wr[x1] = w;
        };
        if (B.use_bits) {
            uint64_t cols = B.wmask & ~B.colfull[s];
            while (cols) {
                int x = __builtin_ctzll(cols);
                cols &= cols - 1;
                cup_one(x);
            }
        } else {
            for (int x = 0; x < B.w; x++) cup_one(x);
        }
    }
    if (segsym) {  // consume (and ignore) the 1010 segmentation symbol
        mq.decode(CTX_UNI);
        mq.decode(CTX_UNI);
        mq.decode(CTX_UNI);
        mq.decode(CTX_UNI);
    }
    mq_io = mq;
}

}  // namespace

extern "C" {

// impl shared by the plugin-ABI entry (no plane limits) and the rate-
// control-aware v2 entry: plane_limits[b] > 0 codes only the top
// plane_limits[b] magnitude bitplanes of block b. Coded pass data, rates
// and distortions are byte/bit-identical to the full encode's first
// 3*planes-2 passes (coding of plane p never reads magnitude bits below
// p, and the conservative safe-rate boundaries exclude bytes later
// passes could still touch), so PCRD over the coded prefix matches the
// full run wherever its cut stays strictly above the limit (the caller
// verifies that and deepens blocks that fail — tile_processor.py).
static int t1_encode_cblks_impl(
    const int32_t* coeffs, const int32_t* heights,
    const int32_t* widths, const int32_t* orients,
    const int32_t* styles, const int32_t* plane_limits, int64_t n,
    int32_t H, int32_t W, uint8_t* out_data, int64_t max_bytes,
    int64_t* out_lengths, int32_t* out_numbps,
    int32_t* out_npasses, int64_t* out_pass_rates,
    double* out_pass_dist, int32_t max_passes,
    int32_t num_threads) {
    const int ws = W + 2;
    const int smax = (H + 3) / 4;
    const int64_t words_sz = (int64_t)(smax + 2) * ws;

#ifdef _OPENMP
    const int nth = resolve_threads(num_threads);
#pragma omp parallel num_threads(nth)
#endif
    {
        // per-thread workspace: stripe words + magnitude plane
        uint64_t* words = new uint64_t[words_sz];
        uint32_t* mag = new uint32_t[(int64_t)H * W];
        uint64_t* colact = new uint64_t[2 * (smax + 1) + 2];

#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t b = 0; b < n; b++) {
            int h = heights[b], w = widths[b];
            int S = (h + 3) / 4;
            std::memset(words, 0, (int64_t)(S + 2) * ws * sizeof(uint64_t));

            const int32_t* src = coeffs + b * (int64_t)H * W;
            uint32_t maxmag = 0;
            for (int y = 0; y < h; y++) {
                uint64_t* Wr = words + (int64_t)((y >> 2) + 1) * ws;
                int kb = 40 + (y & 3);
                for (int x = 0; x < w; x++) {
                    int32_t v = src[y * W + x];
                    uint32_t av = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
                    mag[y * W + x] = av;
                    if (v < 0) Wr[x + 1] |= 1ULL << kb;
                    if (av > maxmag) maxmag = av;
                }
            }
            int numbps = 0;
            while (maxmag >> numbps) numbps++;
            int limit = plane_limits ? plane_limits[b] : 0;
            int floor_p =
                (limit > 0 && limit < numbps) ? numbps - limit : 0;
            int npasses =
                numbps > 0 ? 3 * (numbps - floor_p) - 2 : 0;
            out_numbps[b] = numbps;
            out_npasses[b] = npasses;
            for (int i = 0; i < max_passes; i++) {
                out_pass_rates[b * max_passes + i] = 0;
                if (out_pass_dist) out_pass_dist[b * max_passes + i] = 0.0;
            }
            if (npasses == 0) {
                out_lengths[b] = 0;
                continue;
            }

            int style = styles ? styles[b] : 0;
            BlockCtx2 B{h, w, orients[b], ws, W,
                        (style & STY_VSC) != 0, words, mag};
            B.init(colact);
            MQEncoder mq;
            mq.init(out_data + b * max_bytes, max_bytes);
            bool reset = (style & STY_RESET) != 0;
            bool segsym = (style & STY_SEGSYM) != 0;
            bool termall = (style & STY_TERMALL) != 0;
            bool bypass = (style & STY_BYPASS) != 0;

            // pass p type: 0 SPP, 1 MRP, 2 CUP; raw from the 11th pass on
            auto typ = [](int p) { return p == 0 ? 2 : (p - 1) % 3; };
            auto is_raw = [&](int p) { return bypass && p >= 10 && typ(p) != 2; };
            auto term_after = [&](int p) {
                if (termall) return true;
                if (!bypass) return false;
                int t = typ(p);
                return p == 9 || (p > 9 && (t == 1 || t == 2));
            };

            int pass_i = 0;
            bool in_raw = false;
            bool last_term = false;
            for (int plane = numbps - 1; plane >= floor_p; plane--) {
                double d;
                auto end_pass = [&](double dd) {
                    bool term = term_after(pass_i);
                    int64_t r;
                    if (term)
                        r = in_raw ? mq.raw_terminate_restart_mq()
                                   : mq.terminate_restart();
                    else
                        r = in_raw ? mq.raw_safe_len()
                                   : mq.pos + (27 - mq.ct + 7) / 8;
                    out_pass_rates[b * max_passes + pass_i] = r;
                    if (out_pass_dist) out_pass_dist[b * max_passes + pass_i] = dd;
                    pass_i++;
                    last_term = term;
                    if (reset) mq.reset_ctx();
                    if (term) {
                        in_raw = is_raw(pass_i);
                        if (in_raw) mq.raw_start();
                    }
                };
                bool wd = out_pass_dist != nullptr;
                if (plane < numbps - 1) {
                    d = 0;
                    wd ? enc_spp<true>(B, mq, plane, &d, in_raw)
                       : enc_spp<false>(B, mq, plane, &d, in_raw);
                    end_pass(d);
                    d = 0;
                    wd ? enc_mrp<true>(B, mq, plane, &d, in_raw)
                       : enc_mrp<false>(B, mq, plane, &d, in_raw);
                    end_pass(d);
                }
                d = 0;
                wd ? enc_cup<true>(B, mq, plane, &d, segsym)
                   : enc_cup<false>(B, mq, plane, &d, segsym);
                end_pass(d);
                uint64_t* p = words + ws;
                for (int64_t ii = 0; ii < (int64_t)S * ws; ii++)
                    p[ii] &= ~W_VIS4;
            }
            int64_t len;
            if (last_term) {
                len = out_pass_rates[b * max_passes + npasses - 1];
            } else if (in_raw) {
                len = mq.raw_terminate_restart_mq();
            } else {
                mq.flush();
                len = mq.length();
            }
            // a negative length flags buffer overflow to the Python caller
            out_lengths[b] = mq.overflow ? -1 : len;
            // clamp conservative per-pass rates to the final length
            for (int i = 0; i < npasses; i++) {
                int64_t r = out_pass_rates[b * max_passes + i];
                if (r > len || i == npasses - 1)
                    out_pass_rates[b * max_passes + i] = len;
            }
        }
        delete[] words;
        delete[] mag;
        delete[] colact;
    }
    return 0;
}

}  // namespace

extern "C" {

int t1_encode_cblks(const int32_t* coeffs, const int32_t* heights,
                    const int32_t* widths, const int32_t* orients,
                    const int32_t* styles, int64_t n,
                    int32_t H, int32_t W, uint8_t* out_data, int64_t max_bytes,
                    int64_t* out_lengths, int32_t* out_numbps,
                    int32_t* out_npasses, int64_t* out_pass_rates,
                    double* out_pass_dist, int32_t max_passes,
                    int32_t num_threads) {
    return t1_encode_cblks_impl(coeffs, heights, widths, orients, styles,
                                nullptr, n, H, W, out_data, max_bytes,
                                out_lengths, out_numbps, out_npasses,
                                out_pass_rates, out_pass_dist, max_passes,
                                num_threads);
}

int t1_encode_cblks_v2(const int32_t* coeffs, const int32_t* heights,
                       const int32_t* widths, const int32_t* orients,
                       const int32_t* styles, const int32_t* plane_limits,
                       int64_t n, int32_t H, int32_t W, uint8_t* out_data,
                       int64_t max_bytes, int64_t* out_lengths,
                       int32_t* out_numbps, int32_t* out_npasses,
                       int64_t* out_pass_rates, double* out_pass_dist,
                       int32_t max_passes, int32_t num_threads) {
    return t1_encode_cblks_impl(coeffs, heights, widths, orients, styles,
                                plane_limits, n, H, W, out_data, max_bytes,
                                out_lengths, out_numbps, out_npasses,
                                out_pass_rates, out_pass_dist, max_passes,
                                num_threads);
}

int t1_decode_cblks(const uint8_t* data, const int64_t* lengths,
                    const int32_t* numbps, const int32_t* npasses,
                    const int32_t* heights, const int32_t* widths,
                    const int32_t* orients, const int32_t* styles,
                    const int64_t* seg_lengths, int32_t max_segs,
                    int64_t n, int32_t H, int32_t W,
                    int64_t max_bytes, int32_t* out_coeffs,
                    int32_t num_threads) {
    const int ws = W + 2;
    const int smax = (H + 3) / 4;
    const int64_t words_sz = (int64_t)(smax + 2) * ws;

#ifdef _OPENMP
    const int nth = resolve_threads(num_threads);
#pragma omp parallel num_threads(nth)
#endif
    {
        uint64_t* words = new uint64_t[words_sz];
        uint32_t* mag = new uint32_t[(int64_t)H * W];
        uint64_t* colact = new uint64_t[2 * (smax + 1) + 2];
        uint8_t* useg = new uint8_t[(size_t)max_bytes + 64];  // unstuff scratch
        int64_t* uev = new int64_t[(size_t)max_bytes / 2 + 8];  // carry events

#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t b = 0; b < n; b++) {
            int h = heights[b], w = widths[b];
            int S = (h + 3) / 4;
            int32_t* dst = out_coeffs + b * (int64_t)H * W;
            int nb = numbps[b];
            int np = npasses[b];
            if (nb <= 0 || np <= 0 || h < H || w < W) {
                // the final writeout covers rows [0,h) x cols [0,w) only;
                // clear the padding (or the whole plane for empty blocks)
                std::memset(dst, 0, (int64_t)H * W * sizeof(int32_t));
                if (nb <= 0 || np <= 0) continue;
            }

            std::memset(words, 0, (int64_t)(S + 2) * ws * sizeof(uint64_t));
            std::memset(mag, 0, (int64_t)h * W * sizeof(uint32_t));

            int style = styles ? styles[b] : 0;
            BlockCtx2 B{h, w, orients[b], ws, W,
                        (style & STY_VSC) != 0, words, mag};
            B.init(colact);
            bool reset = (style & STY_RESET) != 0;
            bool segsym = (style & STY_SEGSYM) != 0;
            bool termall = (style & STY_TERMALL) != 0;
            bool bypass = (style & STY_BYPASS) != 0;
            bool segmented = (termall || bypass) && seg_lengths;
            const int64_t* segl =
                seg_lengths ? seg_lengths + b * max_segs : nullptr;

            auto typ = [](int p) { return p == 0 ? 2 : (p - 1) % 3; };
            auto is_raw = [&](int p) { return bypass && p >= 10 && typ(p) != 2; };
            auto term_after = [&](int p) {
                if (termall) return true;
                if (!bypass) return false;
                int t = typ(p);
                return p == 9 || (p > 9 && (t == 1 || t == 2));
            };

            MQDecoder mq;
            mq.ubuf = useg;
            mq.evbuf = uev;
            int64_t seg_off = 0;
            int seg_i = 0;
            bool in_raw = false;
            mq.init(data + b * max_bytes,
                    segmented ? segl[0] : lengths[b]);
            auto next_seg = [&](int finished_pass) {
                if (!segmented) return;
                if (!term_after(finished_pass)) return;
                seg_off += segl[seg_i];
                seg_i++;
                int64_t sl = seg_i < max_segs ? segl[seg_i] : 0;
                in_raw = is_raw(finished_pass + 1);
                if (in_raw)
                    mq.raw_init(data + b * max_bytes + seg_off, sl);
                else
                    mq.init_registers(data + b * max_bytes + seg_off, sl);
            };

            int pass_i = 0;
            bool done = false;
            for (int plane = nb - 1; plane >= 0 && !done; plane--) {
                if (plane < nb - 1) {
                    if (pass_i >= np) { done = true; break; }
                    dec_spp(B, mq, plane, in_raw);
                    pass_i++;
                    if (reset) mq.reset_ctx();
                    if (pass_i < np) next_seg(pass_i - 1);
                    if (pass_i >= np) { done = true; break; }
                    dec_mrp(B, mq, plane, in_raw);
                    pass_i++;
                    if (reset) mq.reset_ctx();
                    if (pass_i < np) next_seg(pass_i - 1);
                }
                if (pass_i >= np) { done = true; break; }
                dec_cup(B, mq, plane, segsym);
                pass_i++;
                if (reset) mq.reset_ctx();
                if (pass_i < np) next_seg(pass_i - 1);
                uint64_t* p = words + ws;
                for (int64_t ii = 0; ii < (int64_t)S * ws; ii++)
                    p[ii] &= ~W_VIS4;
            }
            // ROI downshift rides style bits 8-15 and applies in the
            // SCALED (x2 + half-bit) domain, before the halving — the
            // reference's RoiShiftFilter order (PostDecompressFilters.h:
            // thresh vs the scaled magnitude, then val/2)
            const uint32_t rs = ((uint32_t)style >> 8) & 0xFF;
            for (int y = 0; y < h; y++) {
                const uint64_t* Wr = words + (int64_t)((y >> 2) + 1) * ws;
                int kb = 27 + (y & 3);
                for (int x = 0; x < w; x++) {
                    uint32_t m2 = mag[y * W + x];
                    if (rs && m2 >= (1u << rs)) m2 >>= rs;
                    int32_t v = (int32_t)(m2 >> 1);  // drop 1/2 bit
                    if ((Wr[x + 1] >> kb) & 1) v = -v;
                    dst[y * W + x] = v;
                }
            }
        }
        delete[] words;
        delete[] mag;
        delete[] colact;
        delete[] useg;
        delete[] uev;
    }
    return 0;
}

}  // extern "C"
