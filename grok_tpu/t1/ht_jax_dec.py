"""Device HTJ2K cleanup-pass decoder — batched FBCOT on XLA.

Array reformulation of the HT cleanup decode (parity target: the
reference's t1_ht/coding/ojph_block_decoder.cpp and this repo's scalar
oracle t1/ht.py decode_cleanup). Unlike the Part-1 MQ coder,
HT decode has no arithmetic-coder feedback across samples, so it splits:

1. **Byte unstuffing is local**: whether a byte carries 7 or 8 payload bits
   depends only on its predecessor (0xFF rule for MagSgn/MEL, the >0x8F
   rule for VLC). Each of the three chunks is therefore un-stuffed fully in
   parallel and re-packed into a dense LSB-first uint32 bitstream with the
   encoder's `_pack_bits` cumsum machinery — no byte-serial scan.
2. **The VLC/MEL parse is the only sequential piece**: codeword lengths
   depend on quad contexts, which chain left-to-right and row-to-row. It
   runs as a `lax.scan` over quad-pair steps (the reference's own scan
   order), vectorized across every codeblock in the batch.
3. **MagSgn extraction is row-parallel**: once a quad row's (rho, uq, EMB)
   are known, every sample's MagSgn bit-length is known, so bit offsets are
   an exclusive cumsum and all magnitudes of the row decode as one gather.

Blocks whose streams violate device limits (codeword tables miss, MagSgn
fields over 30 bits, bit positions past capacity) are flagged and re-decoded
on the host, so device output always matches the scalar oracle.
"""

from __future__ import annotations

import functools

import numpy as np

from .ht import DEC_TBL, MEL_EXP
from .ht_jax import (_bitlen, _bitrev, _chunk_items, _extract, _mask_u32,
                     _pack_bits)

# ---------------------------------------------------------------- tables

_MEL_EXP_NP = np.array(MEL_EXP, dtype=np.int32)

# flat decode table [2*8*128]: rho | u_off<<4 | e_k<<5 | e_1<<9 | len<<13,
# invalid codewords get bit 31 (decode falls back to the host for them)
_DEC_FLAT_NP = np.full(2 * 8 * 128, -(2 ** 31), dtype=np.int64)
for _t in range(2):
    for _c in range(8):
        for _v in range(128):
            _e = DEC_TBL[_t][_c][_v]
            if _e is None:
                continue
            _rho, _uoff, _ek, _e1, _ln = _e
            _DEC_FLAT_NP[(_t * 8 + _c) * 128 + _v] = (
                _rho | (_uoff << 4) | (_ek << 5) | (_e1 << 9) | (_ln << 13))
_DEC_FLAT_NP = _DEC_FLAT_NP.astype(np.int32)

# MagSgn fields above this many bits fall back to the host decoder (keeps
# v | 1<<m inside uint32 and mu inside int32)
_MS_BIT_LIMIT = 30


# ------------------------------------------------------------- unstuffing
def _unstuff_ms(data, ms_len, cap_words):
    """MagSgn chunk -> dense LSB-first bitstream.

    data: [N, L] uint8 (full segment bytes), ms_len: [N] int32 (bytes that
    belong to MagSgn). Bytes past ms_len read as 0xFF (MsDec's pad)."""
    import jax.numpy as jnp

    n, L = data.shape
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    b = jnp.where(idx < ms_len[:, None], data, 255).astype(jnp.uint32)
    prev = jnp.pad(b, ((0, 0), (1, 0)))[:, :L]  # first byte: no 0xFF before
    nbits = jnp.where(prev == 255, 7, 8).astype(jnp.int32)
    vals = b & _mask_u32(nbits)
    # 4 bytes -> one <=32-bit chunk: the pack cost follows item count
    pad = (-vals.shape[1]) % 4
    cv, cl = _chunk_items(jnp.pad(vals, ((0, 0), (0, pad))),
                          jnp.pad(nbits, ((0, 0), (0, pad))), 4)
    return _pack_bits(cv, cl, cap_words)


def _unstuff_mel(mel_region, scup, cap_words):
    """MEL chunk (forward MSB-first) -> dense LSB-first bitstream.

    mel_region: [N, cap_bytes] uint8, data[i, ms_len_i + j] (see
    _suffix_regions)."""
    import jax.numpy as jnp

    cap_bytes = mel_region.shape[1]
    idx = jnp.arange(cap_bytes, dtype=jnp.int32)[None, :]
    b = jnp.where(idx < scup[:, None], mel_region, 255).astype(jnp.uint32)
    prev = jnp.pad(b, ((0, 0), (1, 0)))[:, :cap_bytes]
    nbits = jnp.where(prev == 255, 7, 8).astype(jnp.int32)
    # MelDec reads each byte's payload MSB-first: LSB-first stream takes the
    # bit-reversed payload
    vals = _bitrev(b & _mask_u32(nbits), nbits, 8)
    pad = (-vals.shape[1]) % 4
    cv, cl = _chunk_items(jnp.pad(vals, ((0, 0), (0, pad))),
                          jnp.pad(nbits, ((0, 0), (0, pad))), 4)
    return _pack_bits(cv, cl, cap_words)


def _unstuff_vlc(vlc_rev, nib_byte, scup, cap_words):
    """VLC chunk (backward LSB-first from the segment end) -> bitstream.

    Item 0 is the high nibble of the byte at scup-2 (3 payload bits when
    its low 3 bits are all ones — the encoder's stuffed sentinel), then
    bytes scup-3 .. 0; a byte after one reading > 0x8F carries 7 bits
    when its low 7 bits are 0x7F (VlcDec._read_byte).

    vlc_rev: [N, cap_items-1] uint8, the reversed suffix
    (vlc_rev[i, j] = data[i, ms_len_i + scup_i - 3 - j], zero out of
    range); nib_byte: [N] uint8 = data[i, ms_len_i + scup_i - 2] (see
    _suffix_regions)."""
    import jax.numpy as jnp

    d = nib_byte.astype(jnp.uint32)
    nib = d >> 4
    nib_bits = jnp.where((nib & 7) == 7, 3, 4).astype(jnp.int32)

    cap_items = vlc_rev.shape[1] + 1
    idx = jnp.arange(cap_items - 1, dtype=jnp.int32)[None, :]
    in_rng = idx < (scup[:, None] - 2)  # src >= ms_len  <=>  j <= scup-3
    bcur = jnp.where(in_rng, vlc_rev, 0).astype(jnp.uint32)
    # byte read just before this one = previous item in read order
    bprev = jnp.concatenate(
        [nib_byte[:, None].astype(jnp.uint32), bcur[:, :-1]], axis=1)
    seven = (bprev > 0x8F) & ((bcur & 0x7F) == 0x7F)
    nbits = jnp.where(in_rng, jnp.where(seven, 7, 8), 8).astype(jnp.int32)
    vals = jnp.where(in_rng, bcur & _mask_u32(nbits), 0)

    all_vals = jnp.concatenate([(nib & _mask_u32(nib_bits))[:, None], vals],
                               axis=1)
    all_lens = jnp.concatenate([nib_bits[:, None], nbits], axis=1)
    pad = (-all_vals.shape[1]) % 4
    cv, cl = _chunk_items(jnp.pad(all_vals, ((0, 0), (0, pad))),
                          jnp.pad(all_lens, ((0, 0), (0, pad))), 4)
    return _pack_bits(cv, cl, cap_words)


def _suffix_regions(data, ms_len, scup, scc):
    """Per-lane reads of the MEL/VLC suffix of each segment: (mel_region
    [N, scc+8], vlc_rev [N, scc-1] reversed suffix, nib_byte [N]).
    Reads past a segment clamp into the row, and the unstuffers mask
    them by scup."""
    import jax.numpy as jnp

    Lp = data.shape[1]

    def take(cols):
        return jnp.take_along_axis(data, jnp.clip(cols, 0, Lp - 1), axis=1)

    j = jnp.arange(scc + 8, dtype=jnp.int32)[None, :]
    mel_region = take(ms_len[:, None] + j)
    last = ms_len + scup - 2
    nib_byte = take(last[:, None])[:, 0]
    src_r = last[:, None] - 1 - jnp.arange(scc - 1, dtype=jnp.int32)[None, :]
    vlc_rev = jnp.where(src_r >= ms_len[:, None], take(src_r), 0
                        ).astype(jnp.uint8)
    return mel_region, vlc_rev, nib_byte


# ------------------------------------------------------------ bit readers
def _peek(words, pos, nbits_mask):
    """Read a bit field at scalar-per-lane position pos [N] -> [N]."""
    return _extract(words, pos[:, None], nbits_mask)[:, 0]


def _mel_event(mel_words, state, consume):
    """One MEL event per lane (MelDec.event), gated by `consume`.

    state: (pos, k, zeros, one) int32/bool [N]. Returns (bit, state')."""
    import jax.numpy as jnp

    pos, k, zeros, one = state
    mel_exp = jnp.asarray(_MEL_EXP_NP)

    empty = (zeros == 0) & ~one
    need = consume & empty
    bit0 = _peek(mel_words, pos, np.uint32(1)).astype(jnp.int32)
    t = mel_exp[k]
    # run bits are written MSB-first; the LSB-first chunk reverses them.
    # NB: the mask is per-lane here — it must stay [N, 1]-aligned inside
    # _extract (a bare [N] mask would broadcast across lanes).
    runbits = _extract(mel_words, (pos + 1)[:, None],
                       _mask_u32(t)[:, None])[:, 0]
    run = _bitrev(runbits, t, 5).astype(jnp.int32)
    zeros_f = jnp.where(bit0 == 1, jnp.left_shift(1, t), run)
    one_f = bit0 == 0
    k_f = jnp.where(bit0 == 1, jnp.minimum(12, k + 1), jnp.maximum(0, k - 1))
    pos_f = pos + 1 + jnp.where(bit0 == 1, 0, t)

    zeros1 = jnp.where(need, zeros_f, zeros)
    one1 = jnp.where(need, one_f, one)
    k1 = jnp.where(need, k_f, k)
    pos1 = jnp.where(need, pos_f, pos)

    bit = jnp.where(zeros1 > 0, 0, one1.astype(jnp.int32))
    zeros2 = jnp.where(consume & (zeros1 > 0), zeros1 - 1, zeros1)
    one2 = jnp.where(consume & (zeros1 == 0), False, one1)
    return bit, (pos1, k1, zeros2, one2)


def _parse_prefix(w):
    """LSB-first u prefix from a 3-bit window: value (1,2,3,5) + length."""
    import jax.numpy as jnp

    b0 = (w & 1).astype(jnp.int32)
    b1 = ((w >> 1) & 1).astype(jnp.int32)
    b2 = ((w >> 2) & 1).astype(jnp.int32)
    pre = jnp.where(b0 == 1, 1,
                    jnp.where(b1 == 1, 2, jnp.where(b2 == 1, 3, 5)))
    ln = jnp.where(b0 == 1, 1, jnp.where(b1 == 1, 2, 3))
    return pre, ln


def _suffix_len(pre):
    import jax.numpy as jnp

    return jnp.where(pre == 3, 1, jnp.where(pre == 5, 5, 0))


def _suffix_val(pre, bits):
    import jax.numpy as jnp

    return jnp.where(pre == 3, 3 + (bits & 1).astype(jnp.int32),
                     jnp.where(pre == 5, 5 + (bits & 31).astype(jnp.int32),
                               pre))


# ------------------------------------------------------------ the decoder
def _decode_device(data, ms_len, scup, heights, widths, bh, bw, caps):
    """Traceable device decode: [N, L] uint8 segments -> [N, bh, bw] int32
    coefficients + per-lane ok flags (False -> redo on host)."""
    import jax
    import jax.numpy as jnp

    n, L = data.shape
    mel_region, vlc_rev, nib_byte = _suffix_regions(
        data, ms_len, scup, caps["vlc_items"])
    qh = (bh + 1) // 2
    pw = ((bw + 1) // 2 + 1) // 2
    qw = 2 * pw  # quad columns padded to whole pairs; extras are masked

    ms_words, ms_total = _unstuff_ms(data, ms_len, caps["ms_words"])
    mel_words, _ = _unstuff_mel(mel_region, scup, caps["mel_words"])
    vlc_words, _ = _unstuff_vlc(vlc_rev, nib_byte, scup,
                                caps["vlc_words"])
    ms_words = jnp.pad(ms_words, ((0, 0), (0, 1)))
    mel_words = jnp.pad(mel_words, ((0, 0), (0, 1)))
    vlc_words = jnp.pad(vlc_words, ((0, 0), (0, 1)))

    tbl = jnp.asarray(_DEC_FLAT_NP)
    nqw_b = (widths + 1) // 2
    nqr_b = (heights + 1) // 2

    def make_pair_step(row_valid):
      def pair_step(carry, xs):
        (vpos, mpos, mk, mzero, mone, c_left, ok) = carry
        (qi2, kb2, cp2, line0) = xs  # [N,2] cols for the two quads + flag

        rho_l, uoff_l, ek_l, e1_l, uq_pre = [], [], [], [], []
        for j in range(2):
            qi = qi2[:, j]
            inq = (qi < nqw_b) & row_valid
            c_q = jnp.where(line0, c_left, cp2[:, j] + c_left)
            need_mel = inq & (c_q == 0)
            mbit, (mpos, mk, mzero, mone) = _mel_event(
                mel_words, (mpos, mk, mzero, mone), need_mel)
            use_vlc = inq & ((c_q != 0) | (mbit == 1))

            peek7 = _peek(vlc_words, vpos, np.uint32(0x7F)).astype(jnp.int32)
            tsel = jnp.where(line0, 0, 8)
            ent = tbl[(tsel + c_q) * 128 + peek7]
            bad = use_vlc & (ent < 0)
            ent = jnp.where(use_vlc, ent, 0)
            rho = ent & 0xF
            uoff = (ent >> 4) & 1
            ek = (ent >> 5) & 0xF
            e1 = (ent >> 9) & 0xF
            ln = (ent >> 13) & 0x7
            vpos = vpos + jnp.where(use_vlc, ln, 0)
            ok = ok & ~bad

            c_left = jnp.where(
                inq,
                jnp.where(line0, (rho >> 1) | (rho & 1),
                          ((rho & 4) >> 1) | ((rho & 8) >> 2)),
                c_left)
            kappa = jnp.where(
                line0 | ((rho & (rho - 1)) == 0), 1,
                jnp.maximum(1, kb2[:, j]))
            rho_l.append(rho)
            uoff_l.append(uoff)
            ek_l.append(ek)
            e1_l.append(e1)
            uq_pre.append(kappa)

        # ---- u pair (mirrors ht._dec_u_pair + the encoder's a,b,c,d items)
        off0 = uoff_l[0] == 1
        off1 = uoff_l[1] == 1
        both = off0 & off1
        need_pair_mel = line0 & both & row_valid & (qi2[:, 0] < nqw_b)
        bg2_bit, (mpos, mk, mzero, mone) = _mel_event(
            mel_words, (mpos, mk, mzero, mone), need_pair_mel)
        bg2 = need_pair_mel & (bg2_bit == 1)

        w16 = _peek(vlc_words, vpos, np.uint32(0xFFFF))
        used = jnp.zeros_like(vpos)

        # item a: prefix0 (when off0)
        p0, p0len = _parse_prefix(w16)
        alen = jnp.where(off0, p0len, 0)
        p0 = jnp.where(off0, p0, 0)
        w = jnp.right_shift(w16, alen.astype(jnp.uint32))
        used = used + alen

        # item b: u1's single bit (mid case) or prefix1
        mid = line0 & both & ~bg2 & (p0 > 2)
        p1, p1len = _parse_prefix(w)
        b_is_p1 = off1 & ~mid
        blen = jnp.where(mid, 1, jnp.where(b_is_p1, p1len, 0))
        u1_midbit = (w & 1).astype(jnp.int32)
        p1 = jnp.where(b_is_p1, p1, 0)
        w = jnp.right_shift(w, blen.astype(jnp.uint32))
        used = used + blen

        # item c: suffix0
        clen = jnp.where(off0, _suffix_len(p0), 0)
        u0_val = _suffix_val(p0, w)
        w = jnp.right_shift(w, clen.astype(jnp.uint32))
        used = used + clen

        # item d: suffix1 (absent in the mid case)
        dlen = jnp.where(b_is_p1, _suffix_len(p1), 0)
        u1_val = _suffix_val(p1, w)
        used = used + dlen
        vpos = vpos + used

        u0 = jnp.where(off0, u0_val + jnp.where(bg2, 2, 0), 0)
        u1 = jnp.where(mid, 1 + u1_midbit,
                       jnp.where(b_is_p1, u1_val + jnp.where(bg2, 2, 0), 0))

        uq0 = uq_pre[0] + u0
        uq1 = uq_pre[1] + u1
        ys = (jnp.stack([rho_l[0], rho_l[1]], axis=1),
              jnp.stack([uq0, uq1], axis=1),
              jnp.stack([ek_l[0], ek_l[1]], axis=1),
              jnp.stack([e1_l[0], e1_l[1]], axis=1))
        return (vpos, mpos, mk, mzero, mone, c_left, ok), ys

      return pair_step

    def row_body(carry, row_xs):
        (vpos, mpos, mk, mzero, mone, ms_pos,
         prev_e, prev_e_p, prev_cx, prev_cx_p, ok) = carry
        qy, line0 = row_xs

        row_valid = qy < nqr_b  # [N]

        # row-level context inputs (vectorized; only c_left chains)
        kb = jnp.maximum(prev_e, prev_e_p) - 1            # [N, qw]
        cp = prev_cx + (prev_cx_p << 2)                   # [N, qw]
        qi_cols = jnp.broadcast_to(
            jnp.arange(qw, dtype=jnp.int32)[None, :], (n, qw))

        def resh(a):  # [N, qw] -> [pw, N, 2]
            return a.reshape(n, pw, 2).transpose(1, 0, 2)

        c0 = jnp.zeros((n,), dtype=jnp.int32)
        inner0 = (vpos, mpos, mk, mzero, mone, c0, ok)
        (vpos, mpos, mk, mzero, mone, _, ok), (rho_s, uq_s, ek_s, e1_s) = (
            jax.lax.scan(make_pair_step(row_valid), inner0,
                         (resh(qi_cols), resh(kb), resh(cp),
                          jnp.broadcast_to(line0, (pw,))),
                         unroll=4))
        rho = rho_s.transpose(1, 0, 2).reshape(n, qw)     # [N, qw]
        uq = uq_s.transpose(1, 0, 2).reshape(n, qw)
        ek = ek_s.transpose(1, 0, 2).reshape(n, qw)
        e1 = e1_s.transpose(1, 0, 2).reshape(n, qw)

        # ---- row-parallel MagSgn extraction
        sig = jnp.stack([(rho >> k) & 1 for k in range(4)], axis=-1) == 1
        ekb = jnp.stack([(ek >> k) & 1 for k in range(4)], axis=-1)
        e1b = jnp.stack([(e1 >> k) & 1 for k in range(4)], axis=-1)
        m = jnp.where(sig, uq[:, :, None] - ekb, 0)       # [N, qw, 4]
        ok = ok & jnp.all(m <= _MS_BIT_LIMIT, axis=(1, 2))
        m = jnp.minimum(m, _MS_BIT_LIMIT)

        mf = m.reshape(n, qw * 4)
        ends = jnp.cumsum(mf, axis=1)
        offs = ms_pos[:, None] + ends - mf
        v = _extract(ms_words, offs, _mask_u32(mf))
        v = v.reshape(n, qw, 4)
        v = v | jnp.left_shift(e1b.astype(jnp.uint32),
                               m.astype(jnp.uint32))
        ms_pos = ms_pos + ends[:, -1]

        sign = (v & 1) == 1
        mu = (jnp.right_shift(v, np.uint32(1))).astype(jnp.int32) + 1
        val = jnp.where(sig, jnp.where(sign, -mu, mu), 0)  # [N, qw, 4]
        e_n = jnp.where(sig, _bitlen((v | 1).astype(jnp.int32)), 0)

        # line buffers for the next row (encoder lines 275-286 mirrored)
        def shift_r(a):
            return jnp.pad(a, ((0, 0), (1, 0)))[:, :qw]

        def shift_l(a):
            return jnp.pad(a, ((0, 0), (0, 1)))[:, 1:]

        e_bl = e_n[:, :, 1]
        e_br = e_n[:, :, 3]
        upd = row_valid[:, None]
        prev_e = jnp.where(upd, jnp.maximum(e_bl, shift_r(e_br)), prev_e)
        prev_e_p = jnp.where(upd, jnp.maximum(shift_l(e_bl), e_br), prev_e_p)
        prev_cx = jnp.where(upd, ((rho & 2) >> 1) | (shift_r(rho & 8) >> 3),
                            prev_cx)
        prev_cx_p = jnp.where(upd,
                              (shift_l(rho & 2) >> 1) | ((rho & 8) >> 3),
                              prev_cx_p)

        # two output rows: y0 = (k=0, k=2) interleaved, y1 = (k=1, k=3)
        row0 = jnp.stack([val[:, :, 0], val[:, :, 2]],
                         axis=-1).reshape(n, 2 * qw)
        row1 = jnp.stack([val[:, :, 1], val[:, :, 3]],
                         axis=-1).reshape(n, 2 * qw)
        out2 = jnp.stack([row0, row1], axis=1)            # [N, 2, 2*qw]

        carry = (vpos, mpos, mk, mzero, mone, ms_pos,
                 prev_e, prev_e_p, prev_cx, prev_cx_p, ok)
        return carry, out2

    z_i = jnp.zeros((n,), dtype=jnp.int32)
    z_row = jnp.zeros((n, qw), dtype=jnp.int32)
    carry0 = (z_i, z_i, z_i, z_i, jnp.zeros((n,), bool), z_i,
              z_row, z_row, z_row, z_row, jnp.ones((n,), bool))
    qys = jnp.arange(qh, dtype=jnp.int32)
    carry_f, rows = jax.lax.scan(row_body, carry0, (qys, qys == 0))
    ok = carry_f[-1]
    vpos_f, mel_pos_f, ms_pos_f = carry_f[0], carry_f[1], carry_f[5]
    ok = ok & (vpos_f <= 32 * caps["vlc_words"])
    ok = ok & (ms_pos_f <= 32 * caps["ms_words"])
    # corrupt lanes over-reading the MEL region fall back to the host path
    # the same way (keeps garbage-lane host parity)
    ok = ok & (mel_pos_f <= 32 * caps["mel_words"])

    out = rows.transpose(1, 0, 2, 3).reshape(n, 2 * qh, 2 * qw)
    out = out[:, :bh, :bw]
    ys = jnp.arange(bh, dtype=jnp.int32)[None, :, None]
    xs = jnp.arange(bw, dtype=jnp.int32)[None, None, :]
    out = jnp.where((ys < heights[:, None, None])
                    & (xs < widths[:, None, None]), out, 0)
    return out, ok


@functools.lru_cache(maxsize=64)
def _build(n, L, bh, bw, ms_cap, scup_cap):
    """ms_cap/scup_cap: bucketed batch maxima of the MagSgn / suffix chunk
    byte lengths — the unstuffed streams and the per-lane suffix reads
    scale with them, so capacities track the batch, not the worst-case
    segment length L."""
    import jax

    scup_cap = min(scup_cap, L)
    ms_cap = min(ms_cap, L)
    caps = {
        "ms_words": (8 * (ms_cap + 8) + 31) // 32 + 1,
        "mel_bytes": scup_cap + 8,
        "mel_words": (8 * (scup_cap + 8) + 31) // 32 + 1,
        "vlc_items": scup_cap,
        "vlc_words": (8 * scup_cap + 31) // 32 + 1,
    }

    def run(data, ms_len, scup, heights, widths):
        return _decode_device(data, ms_len, scup, heights, widths, bh, bw,
                              caps)

    return jax.jit(run)


def decode_cleanup_batch(data, lengths, heights, widths, bh, bw):
    """Decode a batch of HT cleanup segments on the device.

    data: [N, L] uint8, lengths/heights/widths: [N]. Returns
    [N, bh, bw] int64 coefficients, byte-identical to ht.decode_cleanup
    (device-flagged blocks are transparently re-decoded on the host)."""
    from ..ops.jax_pipeline import pin_device
    from . import ht as _host

    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    n, L = data.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    heights = np.asarray(heights, dtype=np.int32)
    widths = np.asarray(widths, dtype=np.int32)

    # header parse (host, O(N)): scup + validity (decode_cleanup:541-545)
    scup = np.zeros(n, dtype=np.int32)
    ok_hdr = np.zeros(n, dtype=bool)
    for i in range(n):
        ln = int(lengths[i])
        if ln < 2:
            continue
        sc = (int(data[i, ln - 1]) << 4) | (int(data[i, ln - 2]) & 0xF)
        if sc < 2 or sc > ln:
            continue
        scup[i] = sc
        ok_hdr[i] = True
    ms_len = np.where(ok_hdr, lengths.astype(np.int32) - scup, 0)

    # bucket L and N (and the chunk caps) to limit recompiles
    Lc = 64
    while Lc < L:
        Lc *= 2
    Nc = 64
    while Nc < n:
        Nc *= 2
    msc = 64
    while msc < int(ms_len.max(initial=0)):
        msc *= 2
    scc = 64
    while scc < int(scup.max(initial=0)):
        scc *= 2
    if Lc > L or Nc > n:
        data = np.pad(data, ((0, n_pad := Nc - n), (0, Lc - L)))
        scup = np.pad(scup, (0, n_pad))
        ms_len = np.pad(ms_len, (0, n_pad))
        heights_p = np.pad(heights, (0, n_pad))
        widths_p = np.pad(widths, (0, n_pad))
    else:
        heights_p, widths_p = heights, widths
    fn = pin_device(_build(Nc, Lc, bh, bw, msc, scc))
    out_dev, ok_dev = fn(data, ms_len, scup, heights_p, widths_p)
    out = np.asarray(out_dev)[:n].astype(np.int64)
    ok_dev = np.asarray(ok_dev)[:n]
    out[~ok_hdr] = 0

    # host redo for flagged blocks (device limits exceeded / bad codeword)
    redo = np.nonzero(ok_hdr & ~ok_dev)[0]
    for i in redo:
        hi, wi = int(heights[i]), int(widths[i])
        out[i] = 0
        try:
            out[i, :hi, :wi] = _host.decode_cleanup(
                bytes(data[i, : lengths[i]]), hi, wi)
        except ValueError:
            pass
    # running totals, read by chip_smoke.py's HT coverage check
    STATS["calls"] += 1
    STATS["blocks"] += int(n)
    STATS["host_fallbacks"] += int(len(redo))
    return out


STATS = {"calls": 0, "blocks": 0, "host_fallbacks": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0
