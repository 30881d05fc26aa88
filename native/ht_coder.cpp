// Batched HTJ2K (FBCOT) cleanup-pass coder — native host implementation.
//
// Mirrors grok_tpu/t1/ht.py (the correctness reference) exactly; the
// normative T.814 CxtVLC tables are passed in from Python so the data lives
// in one place. Compiled into libgrok_tpu_native.so together with
// t1_coder.cpp.

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#include "omp_util.h"
#endif

namespace ht {

static const int MEL_EXP[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

// tables installed once from Python
static uint16_t g_enc_tbl[2][2048];
// dec entry: rho(0-3) | u_off(4) | e_k(5-8) | e_1(9-12) | len(13-15)
static uint16_t g_dec_tbl[2][8][128];
static bool g_tables_ready = false;

struct MelEnc {
    uint8_t buf[4096];
    int pos = 0, tmp = 0, rem = 8, run = 0, k = 0, threshold = 1;
    void bit(int v) {
        tmp = (tmp << 1) | v;
        if (--rem == 0) {
            buf[pos++] = (uint8_t)tmp;
            rem = tmp == 0xFF ? 7 : 8;
            tmp = 0;
        }
    }
    void encode(bool b) {
        if (!b) {
            if (++run >= threshold) {
                bit(1);
                run = 0;
                k = std::min(12, k + 1);
                threshold = 1 << MEL_EXP[k];
            }
        } else {
            bit(0);
            for (int t = MEL_EXP[k]; t > 0;) bit((run >> --t) & 1);
            run = 0;
            k = std::max(0, k - 1);
            threshold = 1 << MEL_EXP[k];
        }
    }
};

// VLC emitter with a 64-bit staging register. Capacity rule of the byte
// machine: a byte following one > 0x8F holds 7 bits unless those 7 bits
// are not all-ones, in which case bit 7 is usable too (only the value
// 0xFF must never appear) — i.e. emit low-7 = 0x7F as a 7-bit byte,
// anything else as 8 bits.
struct VlcEnc {
    uint8_t buf[8192];  // buf[0] is the 0xFF sentinel; grows upward
    int n = 1;
    uint64_t tmp = 0xF;
    int bits = 4;
    bool last_gt_8f = true;
    VlcEnc() { buf[0] = 0xFF; }
    inline void encode(int cwd, int len) {
        tmp |= (uint64_t)(uint32_t)cwd << bits;
        bits += len;
        if (bits >= 32) drain();
    }
    void drain() {
        while (bits >= 8) {
            uint32_t low7 = (uint32_t)(tmp & 0x7F);
            if (last_gt_8f && low7 == 0x7F) {
                buf[n++] = 0x7F;
                last_gt_8f = false;
                tmp >>= 7;
                bits -= 7;
            } else {
                uint8_t b = (uint8_t)(tmp & 0xFF);
                buf[n++] = b;
                last_gt_8f = b > 0x8F;
                tmp >>= 8;
                bits -= 8;
            }
        }
    }
    void finalize() {
        // the byte machine emits a pending 0x7F at exactly 7 bits when
        // the previous byte was > 0x8F; the staged drain stops below 8
        drain();
        if (bits == 7 && last_gt_8f && (tmp & 0x7F) == 0x7F) {
            buf[n++] = 0x7F;
            last_gt_8f = false;
            tmp = 0;
            bits = 0;
        }
    }
    // byte-machine-compatible views of the pending byte (assembly reads)
    int pending_used() const { return bits; }
    uint32_t pending_tmp() const {
        return (uint32_t)(tmp & ((1u << (bits < 8 ? bits : 8)) - 1));
    }
};

// MagSgn emitter with a 64-bit staging register: one shift-or per coded
// sample, stuffing resolved byte-at-a-time only when the register drains
// (a 7-bit byte after an 0xFF has its top bit 0, so masking to capacity
// reproduces the byte machine exactly).
struct MsEnc {
    uint8_t* buf;
    int pos = 0;
    uint64_t tmp = 0;
    int bits = 0;
    bool prev_ff = false;
    inline void encode(uint32_t cwd, int len) {
        tmp |= (uint64_t)cwd << bits;
        bits += len;
        if (bits >= 32) drain();
    }
    void drain() {
        for (;;) {
            int nb = prev_ff ? 7 : 8;
            if (bits < nb) break;
            uint8_t b = (uint8_t)(tmp & ((1u << nb) - 1));
            buf[pos++] = b;
            prev_ff = b == 0xFF;  // unreachable for 7-bit bytes (top bit 0)
            tmp >>= nb;
            bits -= nb;
        }
    }
    void terminate() {
        drain();
        int nb = prev_ff ? 7 : 8;
        if (bits) {
            // pad the final partial byte to capacity with 1-bits
            uint32_t b = (uint32_t)(tmp & ((1u << bits) - 1)) |
                         (((1u << nb) - 1) & ~((1u << bits) - 1));
            if (b != 0xFF) buf[pos++] = (uint8_t)b;
        } else if (prev_ff) {
            pos--;  // drop the trailing 0xFF
        }
    }
};

// UVLC tables (LSB-first), T.814 C.3.5
static int U_PRE[33], U_PRE_LEN[33], U_SUF[33], U_SUF_LEN[33];
static bool init_uvlc() {
    int p[5] = {0, 1, 2, 4, 4}, pl[5] = {0, 1, 2, 3, 3};
    int s[5] = {0, 0, 0, 0, 1}, sl[5] = {0, 0, 0, 1, 1};
    for (int i = 0; i < 5; i++) {
        U_PRE[i] = p[i];
        U_PRE_LEN[i] = pl[i];
        U_SUF[i] = s[i];
        U_SUF_LEN[i] = sl[i];
    }
    for (int i = 5; i < 33; i++) {
        U_PRE[i] = 0;
        U_PRE_LEN[i] = 3;
        U_SUF[i] = i - 5;
        U_SUF_LEN[i] = 5;
    }
    return true;
}
static bool uvlc_ready = init_uvlc();

static inline int bitlen64(int64_t v) {
    return v ? 64 - __builtin_clzll((uint64_t)v) : 0;
}

// Encode one codeblock; returns segment length, writes into out.
static int64_t encode_block(const int32_t* coeffs, int W_stride, int h, int w,
                            uint8_t* out, uint8_t* ms_scratch) {
    MelEnc mel;
    VlcEnc vlc;
    MsEnc ms{ms_scratch};

    int nqw = (w + 1) / 2;
    int nqr = (h + 1) / 2;
    // line buffers
    uint8_t prev_e[520], prev_cx[520], cur_e[520], cur_cx[520];
    std::memset(prev_e, 0, nqw + 2);
    std::memset(prev_cx, 0, nqw + 2);

    for (int qy = 0; qy < nqr; qy++) {
        bool line0 = qy == 0;
        const uint16_t* tbl = g_enc_tbl[line0 ? 0 : 1];
        std::memset(cur_e, 0, nqw + 2);
        std::memset(cur_cx, 0, nqw + 2);
        int c_left = 0;
        for (int qx = 0; qx < nqw; qx += 2) {
            int u_pair[2] = {0, 0};
            for (int j = 0; j < 2; j++) {
                int qi = qx + j;
                if (qi >= nqw) break;
                int rho = 0, emax = 0;
                int e_q[4] = {0, 0, 0, 0};
                uint32_t s_q[4] = {0, 0, 0, 0};
                for (int k = 0; k < 4; k++) {
                    int y = 2 * qy + (k & 1), x = 2 * qi + (k >> 1);
                    if (y >= h || x >= w) continue;
                    int64_t v = coeffs[y * W_stride + x];
                    int64_t mu = v < 0 ? -v : v;
                    if (mu) {
                        rho |= 1 << k;
                        int64_t tv = 2 * mu - 1;
                        e_q[k] = bitlen64(tv);
                        emax = std::max(emax, e_q[k]);
                        s_q[k] = (uint32_t)(2 * (mu - 1) + (v < 0 ? 1 : 0));
                    }
                }
                int c_q, kappa;
                if (line0) {
                    c_q = c_left;
                    kappa = 1;
                } else {
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left;
                    int max_e = std::max(prev_e[qi], prev_e[qi + 1]) - 1;
                    kappa = (rho & (rho - 1)) ? std::max(1, max_e) : 1;
                }
                int uq = std::max(emax, kappa);
                int u = uq - kappa;
                int eps = 0;
                if (u > 0)
                    for (int k = 0; k < 4; k++) eps |= (e_q[k] == emax) << k;
                uint16_t tup = tbl[(c_q << 8) + (rho << 4) + eps];
                vlc.encode(tup >> 8, (tup >> 4) & 7);
                if (c_q == 0) mel.encode(rho != 0);
                for (int k = 0; k < 4; k++) {
                    if (rho & (1 << k)) {
                        int m = uq - ((tup >> k) & 1);
                        ms.encode(s_q[k] & ((1u << m) - 1), m);
                    }
                }
                cur_e[qi] = std::max<int>(cur_e[qi], e_q[1]);
                cur_e[qi + 1] = (uint8_t)e_q[3];
                cur_cx[qi] |= (rho & 2) >> 1;
                cur_cx[qi + 1] = (rho & 8) >> 3;
                c_left = line0 ? ((rho >> 1) | (rho & 1))
                               : (((rho & 4) >> 1) | ((rho & 8) >> 2));
                u_pair[j] = u;
            }
            int u0 = u_pair[0], u1 = u_pair[1];
            if (line0) {
                if (u0 > 0 && u1 > 0) mel.encode(std::min(u0, u1) > 2);
                if (u0 > 2 && u1 > 2) {
                    vlc.encode(U_PRE[u0 - 2], U_PRE_LEN[u0 - 2]);
                    vlc.encode(U_PRE[u1 - 2], U_PRE_LEN[u1 - 2]);
                    vlc.encode(U_SUF[u0 - 2], U_SUF_LEN[u0 - 2]);
                    vlc.encode(U_SUF[u1 - 2], U_SUF_LEN[u1 - 2]);
                } else if (u0 > 2 && u1 > 0) {
                    vlc.encode(U_PRE[u0], U_PRE_LEN[u0]);
                    vlc.encode(u1 - 1, 1);
                    vlc.encode(U_SUF[u0], U_SUF_LEN[u0]);
                } else {
                    vlc.encode(U_PRE[u0], U_PRE_LEN[u0]);
                    vlc.encode(U_PRE[u1], U_PRE_LEN[u1]);
                    vlc.encode(U_SUF[u0], U_SUF_LEN[u0]);
                    vlc.encode(U_SUF[u1], U_SUF_LEN[u1]);
                }
            } else {
                vlc.encode(U_PRE[u0], U_PRE_LEN[u0]);
                vlc.encode(U_PRE[u1], U_PRE_LEN[u1]);
                vlc.encode(U_SUF[u0], U_SUF_LEN[u0]);
                vlc.encode(U_SUF[u1], U_SUF_LEN[u1]);
            }
        }
        std::memcpy(prev_e, cur_e, nqw + 2);
        std::memcpy(prev_cx, cur_cx, nqw + 2);
    }

    // terminate mel+vlc (with possible fuse byte)
    if (mel.run > 0) mel.bit(1);
    vlc.finalize();
    int vused = vlc.pending_used();
    uint32_t vtmp = vlc.pending_tmp();
    int mel_tmp = (mel.tmp << mel.rem) & 0xFF;
    int mel_mask = (0xFF << mel.rem) & 0xFF;
    int vlc_mask = vused ? (0xFF >> (8 - vused)) : 0;
    int vlc_extra = 0;  // pending vlc byte emitted separately
    int fuse_byte = -1;
    if ((mel_mask | vlc_mask) != 0) {
        uint32_t fuse = mel_tmp | vtmp;
        if (((((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vtmp) & vlc_mask)) == 0) &&
            fuse != 0xFF && vlc.n > 1) {
            fuse_byte = (int)fuse;
        } else {
            fuse_byte = mel_tmp;
            vlc_extra = 1;
        }
    }
    ms.terminate();

    // assemble: [MagSgn][MEL(+fuse)][VLC pending?][VLC reversed incl sentinel]
    int64_t p = 0;
    std::memcpy(out, ms.buf, ms.pos);
    p += ms.pos;
    std::memcpy(out + p, mel.buf, mel.pos);
    p += mel.pos;
    if (fuse_byte >= 0) out[p++] = (uint8_t)fuse_byte;
    if (vlc_extra) out[p++] = (uint8_t)vtmp;
    for (int i = vlc.n - 1; i >= 0; i--) out[p++] = vlc.buf[i];
    int scup = (int)(p - ms.pos);
    out[p - 1] = (uint8_t)((scup >> 4) & 0xFF);
    out[p - 2] = (uint8_t)((out[p - 2] & 0xF0) | (scup & 0xF));
    return p;
}

// ------------------------------------------------------------- decoder
struct MelDec {
    const uint8_t* data;
    int len, pos = 0, tmp = 0, bits = 0, k = 0;
    bool prev_ff = false;
    int runs = 0;       // pending zero events
    int one_pending = 0;
    int bit() {
        if (bits == 0) {
            int b = pos < len ? data[pos++] : 0xFF;
            bits = prev_ff ? 7 : 8;
            prev_ff = b == 0xFF;
            tmp = b;
        }
        bits--;
        return (tmp >> bits) & 1;
    }
    int event() {
        if (runs > 0) {
            runs--;
            return 0;
        }
        if (one_pending) {
            one_pending = 0;
            return 1;
        }
        if (bit()) {
            runs = (1 << MEL_EXP[k]) - 1;
            k = std::min(12, k + 1);
            return 0;
        } else {
            int t = MEL_EXP[k], run = 0;
            while (t-- > 0) run = (run << 1) | bit();
            k = std::max(0, k - 1);
            if (run > 0) {
                runs = run - 1;
                one_pending = 1;
                return 0;
            }
            return 1;
        }
    }
};

// VLC reader over a pre-unstuffed LSB-first bit stream (the backward
// byte walk with its stuffing state machine runs once up front; refills
// become one 8-byte load). Past-beginning bytes are zeros in both
// formulations. The init nibble's overlap bit (bit 3 when its low 3 bits
// are 111) is masked; encoders emit 0 there, matching the byte-machine's
// OR on valid streams.
struct VlcDec {
    const uint8_t* u = nullptr;
    int64_t ulen = 0, upos = 0;
    uint64_t tmp = 0;
    int bits = 0;
    void init(const uint8_t* d, int len, uint8_t* scratch) {
        int64_t n = 0;
        int pos = len - 2;
        uint32_t b = pos >= 0 ? d[pos--] : 0;
        uint32_t nib = b >> 4;
        int ab = 4 - (((nib & 7) == 7) ? 1 : 0);
        uint32_t acc = nib & ((1u << ab) - 1);
        bool unstuff = (b | 0xF) > 0x8F;
        while (pos >= 0) {
            uint32_t c = d[pos--];
            int nb = (unstuff && (c & 0x7F) == 0x7F) ? 7 : 8;
            unstuff = c > 0x8F;
            acc |= (c & ((1u << nb) - 1)) << ab;
            ab += nb;
            if (ab >= 8) {
                scratch[n++] = (uint8_t)acc;
                acc >>= 8;
                ab -= 8;
            }
        }
        if (ab) scratch[n++] = (uint8_t)acc;  // high bits zero (past-start)
        u = scratch;
        ulen = n;
        upos = 0;
        tmp = 0;
        bits = 0;
    }
    inline void fill(int need) {
        if (bits < need) {
            int k = (64 - bits) >> 3;
            uint64_t v;
            if (upos + 8 <= ulen) {
                std::memcpy(&v, u + upos, 8);
                if (k < 8) v &= (1ull << (8 * k)) - 1;
            } else {
                v = 0;
                for (int i = 0; i < k && upos + i < ulen; i++)
                    v |= (uint64_t)u[upos + i] << (8 * i);
            }
            tmp |= v << bits;
            upos += k;
            bits += 8 * k;
        }
    }
    int peek(int n) {
        fill(n);
        return (int)(tmp & ((1u << n) - 1));
    }
    void advance(int n) {
        fill(n);
        tmp >>= n;
        bits -= n;
    }
    int read(int n) {
        int v = peek(n);
        advance(n);
        return v;
    }
};

// MagSgn reader over a pre-unstuffed LSB-first bit stream: one read per
// significant sample, so the per-byte stuffing branches are hoisted into
// a single up-front pass and refills become one 8-byte load. Past-end
// bytes are all-ones in both formulations (0xFF feed), so grouping is
// immaterial there.
struct MsDec {
    const uint8_t* u = nullptr;
    int64_t ulen = 0, upos = 0;
    uint64_t tmp = 0;
    int bits = 0;
    void init(const uint8_t* data, int len, uint8_t* scratch) {
        uint32_t acc = 0;
        int ab = 0;
        bool pf = false;
        int64_t n = 0;
        for (int i = 0; i < len; i++) {
            uint32_t b = data[i];
            int nb = pf ? 7 : 8;
            pf = b == 0xFF;
            acc |= (b & ((1u << nb) - 1)) << ab;
            ab += nb;
            if (ab >= 8) {
                scratch[n++] = (uint8_t)acc;
                acc >>= 8;
                ab -= 8;
            }
        }
        if (ab) scratch[n++] = (uint8_t)(acc | (0xFFu << ab));
        u = scratch;
        ulen = n;
    }
    uint32_t read(int n) {
        if (n == 0) return 0;
        if (bits < n) {
            int k = (64 - bits) >> 3;
            uint64_t v;
            if (upos + 8 <= ulen) {
                std::memcpy(&v, u + upos, 8);
                if (k < 8) v &= (1ull << (8 * k)) - 1;
            } else {
                v = 0;
                for (int i = 0; i < k; i++)
                    v |= (uint64_t)(upos + i < ulen ? u[upos + i] : 0xFF)
                         << (8 * i);
            }
            tmp |= v << bits;
            upos += k;
            bits += 8 * k;
        }
        uint32_t v = (uint32_t)(tmp & ((1ull << n) - 1));
        tmp >>= n;
        bits -= n;
        return v;
    }
};

static int read_prefix(VlcDec& v) {
    if (v.read(1)) return 1;
    if (v.read(1)) return 2;
    return v.read(1) ? 3 : 5;
}
static int read_suffix(VlcDec& v, int p) {
    if (p == 3) return 3 + v.read(1);
    if (p == 5) return 5 + v.read(5);
    return p;
}

static bool decode_block(const uint8_t* seg, int64_t seg_len, int h, int w,
                         int32_t* out, int W_stride, uint8_t* ms_scratch) {
    if (seg_len < 2) return true;
    int scup = (seg[seg_len - 1] << 4) | (seg[seg_len - 2] & 0xF);
    if (scup < 2 || scup > seg_len) return false;
    MsDec ms;
    ms.init(seg, (int)(seg_len - scup), ms_scratch);
    MelDec mel{seg + seg_len - scup, scup};
    VlcDec vlc;
    vlc.init(seg + seg_len - scup, scup, ms_scratch + (seg_len - scup) + 8);

    int nqw = (w + 1) / 2;
    int nqr = (h + 1) / 2;
    uint8_t prev_e[520], prev_cx[520], cur_e[520], cur_cx[520];
    std::memset(prev_e, 0, nqw + 2);
    std::memset(prev_cx, 0, nqw + 2);

    for (int qy = 0; qy < nqr; qy++) {
        bool line0 = qy == 0;
        const uint16_t(*tbl)[128] = g_dec_tbl[line0 ? 0 : 1];
        std::memset(cur_e, 0, nqw + 2);
        std::memset(cur_cx, 0, nqw + 2);
        int c_left = 0;
        for (int qx = 0; qx < nqw; qx += 2) {
            int rho_q[2] = {0, 0}, uoff_q[2] = {0, 0}, ek_q[2] = {0, 0},
                e1_q[2] = {0, 0}, kap_q[2] = {1, 1};
            int nq = std::min(2, nqw - qx);
            for (int j = 0; j < nq; j++) {
                int qi = qx + j;
                int c_q, kappa_base = 0;
                if (line0) {
                    c_q = c_left;
                } else {
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left;
                    kappa_base = std::max(prev_e[qi], prev_e[qi + 1]) - 1;
                }
                int rho = 0, u_off = 0, e_k = 0, e_1 = 0;
                if (c_q == 0 && !mel.event()) {
                    // insignificant quad, no VLC bits
                } else {
                    uint16_t e = tbl[c_q][vlc.peek(7)];
                    if (e == 0) return false;  // 0 = invalid entry (len 0)
                    rho = e & 0xF;
                    u_off = (e >> 4) & 1;
                    e_k = (e >> 5) & 0xF;
                    e_1 = (e >> 9) & 0xF;
                    vlc.advance((e >> 13) & 7);
                }
                rho_q[j] = rho;
                uoff_q[j] = u_off;
                ek_q[j] = e_k;
                e1_q[j] = e_1;
                kap_q[j] = line0 ? 1
                                 : ((rho & (rho - 1)) ? std::max(1, kappa_base) : 1);
                c_left = line0 ? ((rho >> 1) | (rho & 1))
                               : (((rho & 4) >> 1) | ((rho & 8) >> 2));
            }
            // u pair
            int u0 = 0, u1 = 0;
            if (line0) {
                bool both = uoff_q[0] && uoff_q[1];
                bool both_gt2 = both && mel.event();
                if (both && both_gt2) {
                    int p0 = read_prefix(vlc), p1 = read_prefix(vlc);
                    u0 = read_suffix(vlc, p0) + 2;
                    u1 = read_suffix(vlc, p1) + 2;
                } else if (both) {
                    int p0 = read_prefix(vlc);
                    if (p0 > 2) {
                        u1 = 1 + vlc.read(1);
                        u0 = read_suffix(vlc, p0);
                    } else {
                        int p1 = read_prefix(vlc);
                        u0 = read_suffix(vlc, p0);
                        u1 = read_suffix(vlc, p1);
                    }
                } else {
                    int p0 = 0, p1 = 0;
                    if (uoff_q[0]) p0 = read_prefix(vlc);
                    if (uoff_q[1]) p1 = read_prefix(vlc);
                    if (uoff_q[0]) u0 = read_suffix(vlc, p0);
                    if (uoff_q[1]) u1 = read_suffix(vlc, p1);
                }
            } else {
                int p0 = 0, p1 = 0;
                if (uoff_q[0]) p0 = read_prefix(vlc);
                if (uoff_q[1]) p1 = read_prefix(vlc);
                if (uoff_q[0]) u0 = read_suffix(vlc, p0);
                if (uoff_q[1]) u1 = read_suffix(vlc, p1);
            }
            int u_arr[2] = {u0, u1};
            for (int j = 0; j < nq; j++) {
                int qi = qx + j;
                int rho = rho_q[j];
                int uq = kap_q[j] + u_arr[j];
                int e_bl = 0, e_br = 0;
                for (int k = 0; k < 4; k++) {
                    if (!(rho & (1 << k))) continue;
                    int m = uq - ((ek_q[j] >> k) & 1);
                    if (m > 32) return false;
                    uint64_t v = ms.read(m);
                    v |= (uint64_t)((e1_q[j] >> k) & 1) << m;
                    int sign = (int)(v & 1);
                    int64_t mu = (int64_t)(v >> 1) + 1;
                    int e_n = bitlen64((int64_t)(v | 1));
                    int y = 2 * qy + (k & 1), x = 2 * qi + (k >> 1);
                    if (y < h && x < w) out[y * W_stride + x] = (int32_t)(sign ? -mu : mu);
                    if (k == 1) e_bl = e_n;
                    if (k == 3) e_br = e_n;
                }
                cur_e[qi] = std::max<int>(cur_e[qi], e_bl);
                cur_e[qi + 1] = (uint8_t)e_br;
                cur_cx[qi] |= (rho & 2) >> 1;
                cur_cx[qi + 1] = (rho & 8) >> 3;
            }
        }
        std::memcpy(prev_e, cur_e, nqw + 2);
        std::memcpy(prev_cx, cur_cx, nqw + 2);
    }
    return true;
}

}  // namespace ht

extern "C" {

int ht_install_tables(const uint16_t* enc0, const uint16_t* enc1,
                      const uint16_t* dec0, const uint16_t* dec1) {
    std::memcpy(ht::g_enc_tbl[0], enc0, 2048 * sizeof(uint16_t));
    std::memcpy(ht::g_enc_tbl[1], enc1, 2048 * sizeof(uint16_t));
    std::memcpy(ht::g_dec_tbl[0], dec0, 8 * 128 * sizeof(uint16_t));
    std::memcpy(ht::g_dec_tbl[1], dec1, 8 * 128 * sizeof(uint16_t));
    ht::g_tables_ready = true;
    return 0;
}

int ht_encode_cblks_c(const int32_t* coeffs, const int32_t* heights,
                      const int32_t* widths, int64_t n, int32_t H, int32_t W,
                      uint8_t* out_data, int64_t max_bytes,
                      int64_t* out_lengths, int32_t* out_numbps,
                      double* out_dist, int32_t num_threads) {
    if (!ht::g_tables_ready) return -1;
#ifdef _OPENMP
    omp_set_num_threads(ompshared::resolve_threads(num_threads));
#pragma omp parallel
#endif
    {
        uint8_t* ms_scratch = new uint8_t[(size_t)max_bytes + 64];
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t b = 0; b < n; b++) {
            int h = heights[b], w = widths[b];
            const int32_t* src = coeffs + b * (int64_t)H * W;
            int64_t mx = 0;
            double d = 0;
            for (int y = 0; y < h; y++) {
                const int32_t* row = src + (int64_t)y * W;
                uint32_t m32 = 0;  // unsigned: |INT32_MIN| is representable
                double dr = 0;
                for (int x = 0; x < w; x++) {  // branch-free: auto-vectorizes
                    int32_t v = row[x];
                    uint32_t a = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
                    m32 = a > m32 ? a : m32;
                    dr += (double)v * (double)v;
                }
                if ((int64_t)m32 > mx) mx = m32;
                d += dr;
            }
            out_dist[b] = d;
            if (mx == 0 || h == 0 || w == 0) {
                out_numbps[b] = 0;
                out_lengths[b] = 0;
                continue;
            }
            out_numbps[b] = 1;  // HT convention: magnitudes self-described
            out_lengths[b] =
                ht::encode_block(src, W, h, w, out_data + b * max_bytes, ms_scratch);
        }
        delete[] ms_scratch;
    }
    return 0;
}

int ht_decode_cblks_c(const uint8_t* data, const int64_t* lengths,
                      const int32_t* npasses, const int32_t* heights,
                      const int32_t* widths, int64_t n, int32_t H, int32_t W,
                      int64_t max_bytes, int32_t* out_coeffs,
                      int32_t num_threads) {
    if (!ht::g_tables_ready) return -1;
    int rc = 0;
#ifdef _OPENMP
    omp_set_num_threads(ompshared::resolve_threads(num_threads));
#pragma omp parallel
#endif
    {
        uint8_t* ms_scratch = new uint8_t[(size_t)max_bytes + 32];
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t b = 0; b < n; b++) {
            int32_t* dst = out_coeffs + b * (int64_t)H * W;
            std::memset(dst, 0, (int64_t)H * W * sizeof(int32_t));
            if (npasses[b] <= 0 || lengths[b] <= 0) continue;
            if (!ht::decode_block(data + b * max_bytes, lengths[b],
                                  heights[b], widths[b], dst, W, ms_scratch))
                rc = 1;
        }
        delete[] ms_scratch;
    }
    return rc;
}

// Byte-stuff device-packed bit streams (the host half of the device HT
// encoder): ht_jax._encode_device packs MagSgn/MEL/VLC items into LSB-first
// uint32 word arrays on the device (the parallel part); this linear pass
// maps each lane's unstuffed bit sequence to the stuffed byte stream plus
// the partial-byte state ht_jax._compact feeds into segment termination.
// kind: 0 = ms (byte after 0xFF holds 7 bits), 1 = mel (same rule, bytes
// emitted MSB-first), 2 = vlc (7 bits only when they are 0x7F; sentinel
// 0xFF precedes the stream). Bit-exact with the per-sample encoders above
// (tests/test_ht_device.py drives both against ht.encode_cleanup).
int ht_stuff_words(const uint32_t* words, int64_t n_words,
                   const int64_t* totals, int64_t n, int32_t kind,
                   int64_t cap_bytes, uint8_t* out_bytes, int64_t* n_emit,
                   uint32_t* out_partial, int32_t* out_rem,
                   uint8_t* out_fprev, int32_t num_threads) {
#ifdef _OPENMP
    omp_set_num_threads(ompshared::resolve_threads(num_threads));
#pragma omp parallel for schedule(static)
#endif
    for (int64_t b = 0; b < n; b++) {
        const uint32_t* w = words + b * n_words;
        uint8_t* out = out_bytes + b * cap_bytes;
        const int64_t total = totals[b];
        auto read_bits = [&](int64_t p) -> uint32_t {
            // bits [p, p+8) LSB-first; zero past the word array
            int64_t wi = p >> 5;
            int sh = (int)(p & 31);
            uint64_t lo = wi < n_words ? w[wi] : 0u;
            uint64_t hi = wi + 1 < n_words ? w[wi + 1] : 0u;
            return (uint32_t)(((lo | (hi << 32)) >> sh) & 0xFF);
        };
        int64_t p = 0, emit = 0;
        bool prev = kind == 2;  // vlc: sentinel 0xFF precedes the stream
        bool fprev = prev;
        while (emit < cap_bytes) {
            uint32_t raw8 = read_bits(p);
            bool seven = kind == 2 ? (prev && (raw8 & 0x7F) == 0x7F) : prev;
            uint32_t byte = seven ? (raw8 & 0x7F) : raw8;
            int nbits = seven ? 7 : 8;
            if (p + nbits > total) break;
            bool f = kind == 2 ? byte > 0x8F : byte == 0xFF;
            if (kind == 1) {  // mel bytes are MSB-first: reverse low nbits
                uint32_t r = 0;
                for (int i = 0; i < nbits; i++)
                    r |= ((byte >> i) & 1u) << (nbits - 1 - i);
                byte = r;
            }
            out[emit++] = (uint8_t)byte;
            p += nbits;
            prev = f;
            fprev = f;
        }
        n_emit[b] = emit;
        int rem = (int)(total - p);
        out_rem[b] = rem;
        out_partial[b] = read_bits(p) & (uint32_t)((1u << rem) - 1u);
        out_fprev[b] = emit > 0 ? (uint8_t)fprev : (uint8_t)(kind == 2);
    }
    return 0;
}

}  // extern "C"
