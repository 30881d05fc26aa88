"""Device HTJ2K cleanup-pass encoder — batched FBCOT on XLA.

Array reformulation of the HT cleanup pass (parity target: the
reference's t1_ht/coding/ojph_block_encoder.cpp:470 and this repo's
scalar oracle t1/ht.py). The design exploits the property that
cleanup-pass significance is a pure function of the input magnitudes, so
unlike the MQ coder there is no feedback loop through the arithmetic-coder
state:

1. **Quad math is dense array math** over [N, QH, QW] lanes: significance
   patterns rho, neighbor contexts (line-buffer shifts), exponents,
   EMB/eps patterns, CxtVLC table lookups, u-codes and per-sample MagSgn
   (value, length) pairs — all fully parallel across every quad of every
   codeblock in the batch.
2. **The MEL adaptive run-length machine** is the only sequential piece; it
   runs as a short `lax.scan` over quad-pairs (3 event slots per step),
   vectorized across the block batch.
3. **Bit packing** of variable-length items into each stream uses an
   exclusive cumsum of lengths + a sorted segment-sum (cumsum/searchsorted,
   exploiting that disjoint-bit ORs are adds), with no scatter.
4. **Byte stuffing** (0xFF rule for MagSgn/MEL, the >0x8F rule for VLC)
   runs on the host (native ht_stuff_words) during compaction: each
   stuffed byte's width depends on the byte before it, a serial chain.

Per-block fixed-capacity MagSgn/MEL/VLC segments are emitted on device;
the host compacts them (stuffing, termination, MEL/VLC fuse, Scup patch),
which is O(bytes). Streams are byte-identical to the scalar/native coders.
"""

from __future__ import annotations

import functools

import numpy as np

from .ht import (ENC_TBL, MEL_EXP, _U_PRE, _U_PRE_LEN, _U_SUF, _U_SUF_LEN,
                 _terminate_mel_vlc)

# ---------------------------------------------------------------- tables

_MEL_EXP_NP = np.array(MEL_EXP, dtype=np.int32)
_TBL_NP = np.array(list(ENC_TBL[0]) + list(ENC_TBL[1]), dtype=np.int32)
_U_PRE_NP = np.array(_U_PRE, dtype=np.uint32)
_U_PRE_LEN_NP = np.array(_U_PRE_LEN, dtype=np.int32)
_U_SUF_NP = np.array(_U_SUF, dtype=np.uint32)
_U_SUF_LEN_NP = np.array(_U_SUF_LEN, dtype=np.int32)

# device path handles magnitudes below this (so MagSgn item lengths < 32
# and all packing fits uint32 lanes); larger falls back to the host coder
DEVICE_MAG_LIMIT = 1 << 24


# ------------------------------------------------------------- primitives
def _bitlen(x):
    """ceil(log2(x+1)) for int32 x >= 0 (bit_length), branchless."""
    import jax.numpy as jnp

    n = jnp.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        m = x >= (1 << sh)
        n = n + jnp.where(m, sh, 0)
        x = jnp.where(m, x >> sh, x)
    return n + (x > 0).astype(x.dtype)


def _bitrev(v, n, maxbits):
    """Reverse the low-n bits of v (n an array, n <= maxbits)."""
    import jax.numpy as jnp

    v = v.astype(jnp.uint32)
    r = jnp.zeros_like(v)
    for i in range(maxbits):
        bit = (v >> np.uint32(i)) & np.uint32(1)
        pos = n - 1 - i
        r = r | jnp.where(pos >= 0,
                          jnp.left_shift(bit, jnp.maximum(pos, 0)
                                         .astype(jnp.uint32)),
                          np.uint32(0))
    return r


def _mask_u32(lens):
    """(1 << lens) - 1 for 0 <= lens <= 31, uint32."""
    import jax.numpy as jnp

    return jnp.left_shift(np.uint32(1), lens.astype(jnp.uint32)) - np.uint32(1)


def _pack_bits(vals, lens, cap_words):
    """Pack per-item (value, bit-length) sequences into uint32 word arrays.

    vals: [N, M] uint32 (only low `lens` bits may be set)
    lens: [N, M] int32
    Returns (words [N, cap_words] uint32 LSB-first, total_bits [N] int32).

    No scatter: since bit offsets are monotone in the item index, the OR of
    disjoint-bit contributions per word equals a segment-sum, taken as the
    difference of wraparound cumsums at searchsorted word boundaries.
    """
    import jax
    import jax.numpy as jnp

    vals = vals & _mask_u32(lens)
    off_end = jnp.cumsum(lens, axis=1)
    off = off_end - lens
    total = off_end[:, -1]
    s = (off & 31).astype(jnp.uint32)
    w0 = off >> 5
    lo = jnp.left_shift(vals, s)
    hi = jnp.right_shift(jnp.right_shift(vals, np.uint32(31) - s),
                         np.uint32(1))

    ss_r = jax.vmap(lambda a: jnp.searchsorted(
        a, jnp.arange(cap_words, dtype=jnp.int32), side="right"))
    ss_l = jax.vmap(lambda a: jnp.searchsorted(
        a, jnp.arange(cap_words, dtype=jnp.int32), side="left"))

    def seg(keys, contrib):
        cx = jnp.pad(jnp.cumsum(contrib, axis=1), ((0, 0), (1, 0)))
        r = ss_r(keys).astype(jnp.int32)
        left = ss_l(keys).astype(jnp.int32)
        return (jnp.take_along_axis(cx, r, axis=1)
                - jnp.take_along_axis(cx, left, axis=1))

    words = seg(w0, lo) + seg(w0 + 1, hi)
    return words, total


def _extract(words_padded, p, nbits_mask):
    """Read bit fields from packed words at per-element bit positions.

    words_padded: [N, W+1] uint32 (one zero pad word), p: [N, C] int32 bit
    positions, nbits_mask: uint32 mask array (or scalar). Returns the
    LSB-first field values. Out-of-range positions read the zero pad word
    (indices are clamped, never left to the backend's gather semantics).
    """
    import jax.numpy as jnp

    wi = p >> 5
    sh = (p & 31).astype(jnp.uint32)
    last = words_padded.shape[1] - 1
    w0 = jnp.take_along_axis(words_padded, jnp.clip(wi, 0, last), axis=1)
    w1 = jnp.take_along_axis(words_padded, jnp.clip(wi + 1, 0, last), axis=1)
    chunk = jnp.right_shift(w0, sh) | jnp.left_shift(
        jnp.left_shift(w1, np.uint32(31) - sh), np.uint32(1))
    return chunk & nbits_mask


def _chunk_items(vals, lens, K):
    """Pre-combine K consecutive items (sum of lens <= 32 bits guaranteed
    by the caller) into one uint32 chunk each: the global _pack_bits cost
    scales with the ITEM count (its XLA lowering is scatter-class), so a
    4-6x item reduction via cheap elementwise shifts is a direct speedup.
    vals/lens [n, M] with M % K == 0 -> chunks/chunk_lens [n, M/K]."""
    import jax.numpy as jnp

    import jax

    if K <= 1:
        # barrier: keep the item producers from fusing into the pack
        # (a fused producer is recomputed per use)
        return jax.lax.optimization_barrier((vals, lens))
    n, M = vals.shape
    vals = vals & _mask_u32(lens)  # drop value bits beyond each length
    v = vals.reshape(n, M // K, K)
    l = lens.reshape(n, M // K, K)
    off = jnp.cumsum(l, axis=2) - l  # exclusive prefix within the chunk
    chunk = jnp.zeros((n, M // K), dtype=jnp.uint32)
    for k in range(K):
        chunk = chunk | jnp.left_shift(v[:, :, k], off[:, :, k].astype(jnp.uint32))
    return jax.lax.optimization_barrier((chunk, jnp.sum(l, axis=2)))


def _cxt_vlc_lookup(idx):
    """CxtVLC table entries for int32 indices in [0, 4096)."""
    import jax.numpy as jnp

    return jnp.asarray(_TBL_NP)[idx]


# ------------------------------------------------------------ the encoder
def _encode_device(coeffs, heights, widths, bh, bw, caps):
    """Traceable device encode: [N, bh, bw] int32 coeffs -> packed stream
    arrays + metadata (see encode_cblks for the host compaction)."""
    import jax
    import jax.numpy as jnp

    n = coeffs.shape[0]
    qh, qw = bh // 2, bw // 2
    pw = qw // 2

    mag = jnp.abs(coeffs)
    sgn = (coeffs < 0).astype(jnp.int32)

    ys = jnp.arange(bh, dtype=jnp.int32)[None, :, None]
    xs = jnp.arange(bw, dtype=jnp.int32)[None, None, :]
    valid = (ys < heights[:, None, None]) & (xs < widths[:, None, None])
    mag = jnp.where(valid, mag, 0)

    # quad sample views: k = 0 TL, 1 BL, 2 TR, 3 BR (ht.py sample())
    mq = mag.reshape(n, qh, 2, qw, 2)
    sq = sgn.reshape(n, qh, 2, qw, 2)
    m_k = [mq[:, :, k & 1, :, k >> 1] for k in range(4)]
    s_raw = [sq[:, :, k & 1, :, k >> 1] for k in range(4)]

    sig = [(m > 0) for m in m_k]
    e_k = [jnp.where(s, _bitlen(2 * m - 1), 0)
           for m, s in zip(m_k, sig)]
    s_q = [(2 * (m - 1) + sv).astype(jnp.int32)
           for m, sv in zip(m_k, s_raw)]
    rho = (sig[0].astype(jnp.int32) | (sig[1].astype(jnp.int32) << 1)
           | (sig[2].astype(jnp.int32) << 2) | (sig[3].astype(jnp.int32) << 3))
    emax = jnp.maximum(jnp.maximum(e_k[0], e_k[1]),
                       jnp.maximum(e_k[2], e_k[3]))

    qxs = jnp.arange(qw, dtype=jnp.int32)[None, None, :]
    qys = jnp.arange(qh, dtype=jnp.int32)[None, :, None]
    inq = ((2 * qxs < widths[:, None, None])
           & (2 * qys < heights[:, None, None]))

    # previous-row line buffers (ht.py cur_e/cur_cx updates):
    #   e_line[qi]  = max(e1[prev,qi], e3[prev,qi-1])
    #   cx_line[qi] = ((rho[prev,qi]&2)>>1) | ((rho[prev,qi-1]&8)>>3)
    def shift_r(a):  # a[..., qi] -> a[..., qi-1], 0 at qi=0
        return jnp.pad(a, ((0, 0), (0, 0), (1, 0)))[:, :, :qw]

    def shift_l(a):  # a[..., qi] -> a[..., qi+1], 0 at qi=qw-1
        return jnp.pad(a, ((0, 0), (0, 0), (0, 1)))[:, :, 1:]

    e_line = jnp.maximum(e_k[1], shift_r(e_k[3]))
    e_line_p = jnp.maximum(shift_l(e_k[1]), e_k[3])
    cx_line = ((rho & 2) >> 1) | (shift_r(rho & 8) >> 3)
    cx_line_p = (shift_l(rho & 2) >> 1) | ((rho & 8) >> 3)

    def shift_down(a):  # a[:, qy, :] -> a[:, qy-1, :], 0 at qy=0
        return jnp.pad(a, ((0, 0), (1, 0), (0, 0)))[:, :qh]

    prev_e = shift_down(e_line)
    prev_e_p = shift_down(e_line_p)
    prev_cx = shift_down(cx_line)
    prev_cx_p = shift_down(cx_line_p)

    line0 = qys == 0  # [1, qh, 1]
    cl0 = (rho >> 1) | (rho & 1)
    cl1 = ((rho & 4) >> 1) | ((rho & 8) >> 2)
    c_left = shift_r(jnp.where(line0, cl0, cl1))
    c_q = jnp.where(line0, c_left,
                    prev_cx + (prev_cx_p << 2) + c_left)

    multi = (rho & (rho - 1)) != 0
    kappa = jnp.where(line0 | ~multi, 1,
                      jnp.maximum(1, jnp.maximum(prev_e, prev_e_p) - 1))
    uq = jnp.maximum(emax, kappa)
    u = jnp.where(inq, uq - kappa, 0)
    eps = jnp.where(
        (u > 0),
        sum(((e_k[k] == emax).astype(jnp.int32) << k) for k in range(4)),
        0)

    idx = (c_q << 8) | (rho << 4) | eps
    idx = jnp.where(line0, idx, idx + 2048)
    tup = _cxt_vlc_lookup(idx)
    cwd = (tup >> 8).astype(jnp.uint32)
    cwd_len = jnp.where(inq, (tup >> 4) & 7, 0)
    ek_nib = tup & 0xF

    # ---- MagSgn items: quad-major, k = 0..3 (ht.py:291-294).
    # Chunks are folded directly from the four per-k arrays — the generic
    # stack->reshape->chunk route materializes two [n, 4096] planes
    mmax_s = caps.get("mmax", 32)
    ms_k = 4 if mmax_s * 4 <= 32 else (2 if mmax_s * 2 <= 32 else 1)
    lens_k = [jnp.where(sig[k], uq - ((ek_nib >> k) & 1), 0)
              for k in range(4)]
    vals_k = [s_q[k].astype(jnp.uint32) & _mask_u32(lens_k[k])
              for k in range(4)]
    if ms_k == 4:
        off = jnp.zeros_like(lens_k[0])
        chunk = jnp.zeros_like(vals_k[0])
        for k in range(4):
            chunk = chunk | jnp.left_shift(vals_k[k],
                                           off.astype(jnp.uint32))
            off = off + lens_k[k]
        ms_cv = chunk.reshape(n, -1)
        ms_cl = off.reshape(n, -1)
    elif ms_k == 2:
        pair_v, pair_l = [], []
        for k0, k1 in ((0, 1), (2, 3)):
            pair_v.append(vals_k[k0] | jnp.left_shift(
                vals_k[k1], lens_k[k0].astype(jnp.uint32)))
            pair_l.append(lens_k[k0] + lens_k[k1])
        ms_cv = jnp.stack(pair_v, axis=-1).reshape(n, -1)
        ms_cl = jnp.stack(pair_l, axis=-1).reshape(n, -1)
    else:
        ms_cv = jnp.stack(vals_k, axis=-1).reshape(n, -1)
        ms_cl = jnp.stack(lens_k, axis=-1).reshape(n, -1)
    ms_cv, ms_cl = jax.lax.optimization_barrier((ms_cv, ms_cl))
    ms_words, ms_total = _pack_bits(ms_cv, ms_cl, caps["ms_words"])

    # ---- u codes per quad pair (ht.py:307-329)
    u0 = u[:, :, 0::2]
    u1 = u[:, :, 1::2]
    upre = jnp.asarray(_U_PRE_NP)
    upre_l = jnp.asarray(_U_PRE_LEN_NP)
    usuf = jnp.asarray(_U_SUF_NP)
    usuf_l = jnp.asarray(_U_SUF_LEN_NP)

    l0 = line0  # [1, qh, 1] broadcasts over [n, qh, pw]
    bg2 = l0 & (u0 > 2) & (u1 > 2)
    mid = l0 & ~bg2 & (u0 > 2) & (u1 > 0)
    i0 = jnp.where(bg2, u0 - 2, u0)
    i1 = jnp.where(bg2, u1 - 2, u1)
    a_v, a_l = upre[i0], upre_l[i0]
    b_v = jnp.where(mid, (u1 - 1).astype(jnp.uint32), upre[i1])
    b_l = jnp.where(mid, 1, upre_l[i1])
    c_v, c_l = usuf[i0], usuf_l[i0]
    d_v = jnp.where(mid, np.uint32(0), usuf[i1])
    d_l = jnp.where(mid, 0, usuf_l[i1])

    # ---- VLC items: locator nibble, then per pair (cwd0, cwd1, a, b, c, d)
    cw0_v, cw0_l = cwd[:, :, 0::2], cwd_len[:, :, 0::2]
    cw1_v, cw1_l = cwd[:, :, 1::2], cwd_len[:, :, 1::2]
    # one uint32 chunk per pair, folded directly (cwd<=7 each, u
    # prefix<=3, suffix<=5 -> 30 bits max): the pack sees 6x fewer items
    # and no [n, 3073] stacked intermediates are materialized
    vchunk = jnp.zeros_like(cw0_v)
    voff = jnp.zeros_like(cw0_l)
    for v_, l_ in ((cw0_v, cw0_l), (cw1_v, cw1_l), (a_v, a_l),
                   (b_v, b_l), (c_v, c_l), (d_v, d_l)):
        vchunk = vchunk | jnp.left_shift(v_ & _mask_u32(l_),
                                         voff.astype(jnp.uint32))
        voff = voff + l_
    vlc_cv = jnp.concatenate(
        [jnp.full((n, 1), 0xF, dtype=jnp.uint32),
         vchunk.reshape(n, -1)], axis=1)
    vlc_cl = jnp.concatenate(
        [jnp.full((n, 1), 4, dtype=jnp.int32),
         voff.reshape(n, -1)], axis=1)
    vlc_cv, vlc_cl = jax.lax.optimization_barrier((vlc_cv, vlc_cl))
    vlc_words, vlc_total = _pack_bits(vlc_cv, vlc_cl, caps["vlc_words"])

    # ---- MEL events: per quad (c_q==0 -> rho!=0), then the line0 pair
    # event min(u0,u1)>2 when both u>0 (ht.py:290,309-310)
    ev_q_valid = inq & (c_q == 0)
    ev_q_val = rho != 0
    ev_p_valid = (l0 & (u0 > 0) & (u1 > 0)) & jnp.ones_like(u0, dtype=bool)
    ev_p_val = jnp.minimum(u0, u1) > 2

    evv = jnp.stack([ev_q_valid[:, :, 0::2], ev_q_valid[:, :, 1::2],
                     ev_p_valid], axis=-1)  # [n, qh, pw, 3]
    evb = jnp.stack([ev_q_val[:, :, 0::2], ev_q_val[:, :, 1::2],
                     ev_p_val], axis=-1)
    evv = evv.reshape(n, -1, 3).transpose(1, 2, 0)  # [steps, 3, n]
    evb = evb.reshape(n, -1, 3).transpose(1, 2, 0)

    mel_exp = jnp.asarray(_MEL_EXP_NP)

    def mel_step(state, ev):
        k, run = state
        valid3, bit3 = ev
        outs_v, outs_l = [], []
        for s in range(3):
            va, bi = valid3[s], bit3[s].astype(jnp.int32)
            t = mel_exp[k]
            thr = jnp.left_shift(1, t)
            hit = (run + 1) >= thr
            # bit==0: run++; on threshold emit '1'
            v0 = np.uint32(1)
            l0b = jnp.where(hit, 1, 0)
            k0 = jnp.where(hit, jnp.minimum(12, k + 1), k)
            r0 = jnp.where(hit, 0, run + 1)
            # bit==1: emit '0' + t run bits (MSB-first) -> LSB item
            v1 = jnp.left_shift(_bitrev(run.astype(jnp.uint32), t, 5),
                                np.uint32(1))
            l1b = 1 + t
            k1 = jnp.maximum(0, k - 1)
            is1 = bi == 1
            ov = jnp.where(is1, v1, v0)
            ol = jnp.where(is1, l1b, l0b)
            nk = jnp.where(is1, k1, k0)
            nr = jnp.where(is1, 0, r0)
            outs_v.append(jnp.where(va, ov, np.uint32(0)))
            outs_l.append(jnp.where(va, ol, 0))
            k = jnp.where(va, nk, k)
            run = jnp.where(va, nr, run)
        return (k, run), (jnp.stack(outs_v), jnp.stack(outs_l))

    k0_ = jnp.zeros((n,), dtype=jnp.int32)
    r0_ = jnp.zeros((n,), dtype=jnp.int32)
    (k_f, run_f), (mel_v, mel_l) = jax.lax.scan(
        mel_step, (k0_, r0_), (evv, evb))
    mel_v = mel_v.transpose(2, 0, 1).reshape(n, -1)  # [n, steps*3]
    mel_l = mel_l.transpose(2, 0, 1).reshape(n, -1)
    # _terminate_mel_vlc flushes a final '1' bit when a run is pending
    mel_v = jnp.concatenate(
        [mel_v, jnp.ones((n, 1), dtype=jnp.uint32)], axis=1)
    mel_l = jnp.concatenate(
        [mel_l, (run_f > 0).astype(jnp.int32)[:, None]], axis=1)
    # 5 events per chunk (each <= 1 + mel_exp_max = 6 bits); pad to x5
    pad5 = (-mel_v.shape[1]) % 5
    mel_v = jnp.pad(mel_v, ((0, 0), (0, pad5)))
    mel_l = jnp.pad(mel_l, ((0, 0), (0, pad5)))
    mel_cv, mel_cl = _chunk_items(mel_v, mel_l, 5)
    mel_words, mel_total = _pack_bits(mel_cv, mel_cl, caps["mel_words"])

    # Byte-stuffing happens on the host during compaction (_stuff_host):
    # the stuffed byte boundaries form a serial chain. The packed word
    # arrays are the same size as the stuffed bytes, so the device-to-host
    # copy does not grow.
    dist = jnp.sum(
        (coeffs * jnp.where(valid, 1, 0)).astype(jnp.float32) ** 2,
        axis=(1, 2))
    mx = jnp.max(mag, axis=(1, 2))
    return {"ms": (ms_words, ms_total), "mel": (mel_words, mel_total),
            "vlc": (vlc_words, vlc_total), "dist": dist, "max": mx}


@functools.lru_cache(maxsize=64)
def _build(n, bh, bw, mmax):
    import jax

    qh, qw = bh // 2, bw // 2
    n_pairs = qh * (qw // 2)
    ms_bits = bh * bw * mmax + 64
    vlc_bits = 4 + 30 * n_pairs + 32
    mel_bits = 6 * (3 * n_pairs + 1) + 32
    caps = {
        "ms_words": (ms_bits + 31) // 32 + 1,
        "vlc_words": (vlc_bits + 31) // 32 + 1,
        "mel_words": (mel_bits + 31) // 32 + 1,
        "mmax": mmax,
    }

    def run(coeffs, heights, widths):
        return _encode_device(coeffs, heights, widths, bh, bw, caps)

    return jax.jit(run)


class _PartState:
    """Duck-typed stand-ins feeding ht._terminate_mel_vlc."""
    __slots__ = ("bytes", "tmp", "rem", "used", "run", "last_gt_8f")

    def tail_bytes(self):
        return bytes(reversed(self.bytes))


def _stuff_host(words, totals, kind):
    """Host byte-stuffing of a device-packed bit stream (native fast path,
    python fallback): same return layout the on-device fixpoint had."""
    from . import native

    words = np.ascontiguousarray(np.asarray(words), dtype=np.uint32)
    totals = np.asarray(totals, dtype=np.int64)
    if native.available():
        return native.ht_stuff_words(words, totals, kind)
    n, nw = words.shape
    cap = nw * 32 // 7 + 2
    out = np.zeros((n, cap), dtype=np.uint8)
    n_emit = np.zeros(n, dtype=np.int64)
    partial = np.zeros(n, dtype=np.uint32)
    rem = np.zeros(n, dtype=np.int32)
    fprev = np.zeros(n, dtype=np.uint8)
    init_prev = kind == "vlc"
    for b in range(n):
        w = words[b]
        total = int(totals[b])

        def read8(p):
            wi = p >> 5
            sh = p & 31
            lo = int(w[wi]) if wi < nw else 0
            hi = int(w[wi + 1]) if wi + 1 < nw else 0
            return ((lo | (hi << 32)) >> sh) & 0xFF

        p = 0
        emit = 0
        prev = init_prev
        f_last = init_prev
        while emit < cap:
            raw8 = read8(p)
            seven = (prev and (raw8 & 0x7F) == 0x7F) if kind == "vlc" \
                else prev
            byte = (raw8 & 0x7F) if seven else raw8
            nbits = 7 if seven else 8
            if p + nbits > total:
                break
            f = byte > 0x8F if kind == "vlc" else byte == 0xFF
            if kind == "mel":
                byte = sum(((byte >> i) & 1) << (nbits - 1 - i)
                           for i in range(nbits))
            out[b, emit] = byte
            emit += 1
            p += nbits
            prev = f
            f_last = f
        n_emit[b] = emit
        r = total - p
        rem[b] = r
        partial[b] = read8(p) & ((1 << r) - 1)
        fprev[b] = f_last if emit > 0 else init_prev
    return out, n_emit, partial, rem, fprev


def _compact(dev, n, heights, widths):
    """Host compaction: byte-stuffing (native, see _stuff_host), then
    termination, MEL/VLC fuse, Scup patch, assembly."""
    ms_bytes, ms_n, ms_part, ms_rem, ms_ff = _stuff_host(*dev["ms"], "ms")
    mel_bytes, mel_n, mel_part, mel_rem, mel_ff = _stuff_host(
        *dev["mel"], "mel")
    vlc_bytes, vlc_n, vlc_part, vlc_rem, vlc_ff = _stuff_host(
        *dev["vlc"], "vlc")
    mx = np.asarray(dev["max"])

    segs = []
    for i in range(n):
        if mx[i] == 0 or heights[i] == 0 or widths[i] == 0:
            segs.append(b"")
            continue
        # MagSgn termination (ht.py MsEnc.terminate)
        msb = bytearray(ms_bytes[i, : ms_n[i]].astype(np.uint8).tobytes())
        used, tmp = int(ms_rem[i]), int(ms_part[i])
        max_bits = 7 if ms_ff[i] else 8
        if used:
            t = max_bits - used
            tmp |= (0xFF & ((1 << t) - 1)) << used
            if tmp != 0xFF:
                msb.append(tmp)
        elif max_bits == 7:
            msb.pop()

        mel = _PartState()
        mel.bytes = bytearray(
            mel_bytes[i, : mel_n[i]].astype(np.uint8).tobytes())
        mel_used = int(mel_rem[i])
        mel_max = 7 if mel_ff[i] else 8
        # MelEnc accumulates MSB-first: tmp = bitrev(partial), rem counts down
        mp = int(mel_part[i])
        mel.tmp = int(
            sum(((mp >> b) & 1) << (mel_used - 1 - b) for b in range(mel_used)))
        mel.rem = mel_max - mel_used
        mel.run = 0  # the pending-run flush bit is already in the stream

        vlc = _PartState()
        vlc.bytes = bytearray([0xFF]) + bytearray(
            vlc_bytes[i, : vlc_n[i]].astype(np.uint8).tobytes())
        vlc.tmp = int(vlc_part[i])
        vlc.used = int(vlc_rem[i])
        vlc.last_gt_8f = bool(vlc_ff[i])
        if vlc.used == 7 and vlc.last_gt_8f and vlc.tmp != 0x7F:
            vlc.last_gt_8f = False  # mid-byte 8th-bit grant (ht.py:143-146)

        mel_out, vlc_out = _terminate_mel_vlc(mel, vlc)
        scup = len(mel_out) + len(vlc_out)
        seg = bytearray(bytes(msb) + mel_out + vlc_out)
        seg[-1] = (scup >> 4) & 0xFF
        seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
        segs.append(bytes(seg))
    return segs


SUPPORTED_STYLES = 0

# blocks coded on the device and blocks sent to the host coder instead
# (running totals, read by chip_smoke.py's HT coverage check)
STATS = {"blocks": 0, "host_blocks": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def encode_cleanup_batch(coeffs, heights, widths):
    """Encode a [N, bh, bw] batch of codeblocks on the device; returns the
    list of cleanup codeword segments (byte-identical to ht.encode_cleanup)."""
    from ..ops.jax_pipeline import pin_device

    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    n, bh, bw = coeffs.shape
    mx = int(np.abs(coeffs).max(initial=0))
    if mx >= DEVICE_MAG_LIMIT:
        raise ValueError("magnitudes exceed the device HT range")
    mmax = max(int(2 * mx - 1).bit_length() if mx else 1, 1)
    fn = pin_device(_build(n, bh, bw, mmax))
    dev = fn(coeffs, np.asarray(heights, dtype=np.int32),
             np.asarray(widths, dtype=np.int32))
    STATS["blocks"] += n
    return _compact(dev, n, heights, widths)


def encode_cblks(coeffs, heights, widths, orients, num_threads: int = 0,
                 refine: bool = False):
    """Batch HT encode on the device (T1 backend API).

    The refine (3-pass) mode and out-of-range magnitudes fall back to the
    host coder; the cleanup path runs fully on the accelerator."""
    from .ebcot_np import T1EncodeResult
    from . import ht as _host

    coeffs = np.asarray(coeffs)
    if (refine or coeffs.size == 0 or coeffs.shape[1] < 4
            or coeffs.shape[2] < 4 or coeffs.shape[1] % 2
            or coeffs.shape[2] % 2
            or int(np.abs(coeffs).max(initial=0)) >= DEVICE_MAG_LIMIT):
        STATS["host_blocks"] += coeffs.shape[0]
        return _host.encode_cblks(coeffs, heights, widths, orients,
                                  num_threads, refine, device=False)
    n = coeffs.shape[0]
    segs = encode_cleanup_batch(coeffs.astype(np.int32), heights, widths)

    lengths = np.array([len(s) for s in segs], dtype=np.int64)
    numbps = (lengths > 0).astype(np.int64)
    npasses = numbps.copy()
    maxlen = max(int(lengths.max(initial=0)), 1)
    data = np.zeros((n, maxlen), dtype=np.uint8)
    dists = np.zeros((n, 1), dtype=np.float64)
    for i, s in enumerate(segs):
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        if len(s):
            hi, wi = int(heights[i]), int(widths[i])
            blk = coeffs[i, :hi, :wi].astype(np.float64)
            dists[i, 0] = float((blk * blk).sum())
    return T1EncodeResult(
        data=data, lengths=lengths, numbps=numbps, npasses=npasses,
        pass_rates=lengths[:, None].astype(np.int64),
        pass_dist=dists,
    )


def decode_cblks(data, lengths, numbps, npasses, heights, widths, orients,
                 block_h, block_w, num_threads: int = 0, seg_lengths=None):
    """Device HT decode for cleanup-only batches (ht_jax_dec); 3-pass HT
    sets decode via the host refinement path."""
    from . import ht as _host

    return _host.decode_cblks(data, lengths, numbps, npasses, heights,
                              widths, orients, block_h, block_w,
                              num_threads, seg_lengths, device=True)
