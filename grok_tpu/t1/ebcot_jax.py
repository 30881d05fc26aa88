"""Device lockstep EBCOT Tier-1 coder — jax.lax formulation.

The same lane-parallel algorithm as ebcot_np.py compiled for the device:
every MQ register, context table and flag plane lives in an [.., N] array
with the codeblock batch as the minor (vector) dimension, and the standard's
sequential scan becomes nested lax.fori_loops whose body advances all N
blocks one position per step. Renormalization is branch-free (CLZ + three
unrolled byte-boundary blocks), context-state updates are dense one-hot
selects (19 contexts), and flag updates are single-row dynamic slices.

Both directions are implemented (encode and decode), with ALL Part-1
codeblock style bits supported (SUPPORTED_STYLES = 0x3F): VSC / RESET /
SEGSYM as per-lane masks in the scan, BYPASS / TERMALL / PTERM via the
per-pass raw-segment + termination machinery mirrored from the host
coders. Per-pass rates use the same safe Taubman bound
as the host coders; per-pass distortions are accumulated on device in
float32 (the host backends use float64 — layer allocation may differ in
ties, the codestreams remain standard-conformant and self-consistent).

Bit-exact against the numpy/C++ coders for the supported styles
(tests/test_t1.py); parity targets t1/t1_part1/T1.cpp + mqc_*.cpp.
"""

from __future__ import annotations

import numpy as np

from .ebcot_np import T1EncodeResult, _ZC_LUT, _SC_CTX, _SC_XOR, _local_pass_index
from .mq_np import NMPS, NLPS, QE, SWITCH, CTX_MR0, CTX_RL, CTX_UNI

SUPPORTED_STYLES = 0x3F  # all Part-1 codeblock style bits


def _j():
    import jax
    import jax.numpy as jnp

    return jax, jnp


# ---------------------------------------------------------------- MQ tables
def _mq_tables(jnp):
    return (
        jnp.asarray(QE, dtype=jnp.int32),
        jnp.asarray(NMPS, dtype=jnp.int32),
        jnp.asarray(NLPS, dtype=jnp.int32),
        jnp.asarray(SWITCH, dtype=jnp.int32),
    )


_INIT_CTX = np.zeros(19, dtype=np.int32)
_INIT_CTX[0] = 4
_INIT_CTX[CTX_RL] = 3
_INIT_CTX[CTX_UNI] = 46


def _bitlen32(jax, jnp, v):
    """bit length of positive int32 values."""
    return 32 - jax.lax.clz(v.astype(jnp.int32))


# ---------------------------------------------------------------- MQ (enc)
def _enc_byteout(jax, jnp, st, do):
    """Branch-free lockstep BYTEOUT. st: dict of MQ state arrays."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    b = st["buf"][st["pos"], lanes].astype(jnp.int32)
    c = st["c"]

    is_ff = b == 0xFF
    carry = (c & 0x8000000) != 0
    prop = do & (~is_ff) & carry
    b2 = jnp.where(prop, (b + 1) & 0xFF, b)
    buf = st["buf"].at[st["pos"], lanes].set(
        jnp.where(do, b2, b).astype(jnp.uint8), mode="drop"
    )
    c = jnp.where(prop & (b2 == 0xFF), c & 0x7FFFFFF, c)
    is_ff = b2 == 0xFF

    new_byte = jnp.where(is_ff, (c >> 20) & 0xFF, (c >> 19) & 0xFF)
    new_c = jnp.where(is_ff, c & 0xFFFFF, c & 0x7FFFF)
    new_ct = jnp.where(is_ff, 7, 8)

    wpos = jnp.where(do, st["pos"] + 1, st["pos"])
    prev = buf[wpos, lanes]
    buf = buf.at[wpos, lanes].set(
        jnp.where(do, new_byte.astype(jnp.uint8), prev), mode="drop"
    )
    st = dict(st)
    st["buf"] = buf
    st["pos"] = wpos
    st["c"] = jnp.where(do, new_c, st["c"])
    st["ct"] = jnp.where(do, new_ct, st["ct"])
    return st


def _enc_renorm(jax, jnp, st, need):
    """Branch-free renorm: shift A fully, move C across <=3 byte boundaries."""
    a = st["a"]
    k = jnp.where(need, 16 - _bitlen32(jax, jnp, jnp.maximum(a, 1)), 0)
    st = dict(st)
    st["a"] = jnp.where(need, a << k, a)
    for _ in range(3):
        take = jnp.minimum(k, st["ct"])
        st["c"] = jnp.where(need, (st["c"] << take) & 0xFFFFFFF, st["c"])
        st["ct"] = st["ct"] - jnp.where(need, take, 0)
        k = k - take
        st = _enc_byteout(jax, jnp, st, need & (st["ct"] == 0) & True)
    return st


def _enc_encode(jax, jnp, st, bit, ctx, mask, tables):
    """One lockstep ENCODE (T.88 CODEMPS/CODELPS)."""
    qe_t, nmps_t, nlps_t, sw_t = tables
    n = st["a"].shape[0]
    onehot = (jnp.arange(19)[None, :] == ctx[:, None]) & mask[:, None]

    state = jnp.take_along_axis(st["cx_state"], ctx[:, None], axis=1)[:, 0]
    mps = jnp.take_along_axis(st["cx_mps"], ctx[:, None], axis=1)[:, 0]
    qe = jnp.take(qe_t, state)
    is_mps = (bit == mps) & mask
    is_lps = (bit != mps) & mask

    a = st["a"]
    a_sub = a - qe
    no_renorm = is_mps & ((a_sub & 0x8000) != 0)
    renorm_mps = is_mps & ((a_sub & 0x8000) == 0)
    cond_ex = renorm_mps & (a_sub < qe)
    cond_ex_l = is_lps & (a_sub < qe)

    st = dict(st)
    st["c"] = jnp.where(
        no_renorm | (renorm_mps & ~cond_ex) | cond_ex_l, st["c"] + qe, st["c"]
    )
    new_state = jnp.where(
        renorm_mps, jnp.take(nmps_t, state),
        jnp.where(is_lps, jnp.take(nlps_t, state), state),
    )
    st["cx_state"] = jnp.where(
        onehot, new_state[:, None].astype(jnp.int32), st["cx_state"]
    )
    sw = is_lps & (jnp.take(sw_t, state) == 1)
    new_mps = jnp.where(sw, 1 - mps, mps)
    st["cx_mps"] = jnp.where(onehot, new_mps[:, None], st["cx_mps"])

    st["a"] = jnp.where(mask, a_sub, a)
    st["a"] = jnp.where(cond_ex | (is_lps & ~cond_ex_l), qe, st["a"])
    return _enc_renorm(jax, jnp, st, renorm_mps | is_lps)


def _enc_flush(jax, jnp, st):
    tempc = st["c"] + st["a"]
    c = st["c"] | 0xFFFF
    c = jnp.where(c >= tempc, c - 0x8000, c)
    st = dict(st)
    st["c"] = c
    on = jnp.ones_like(st["a"], dtype=bool)
    for _ in range(2):
        # shift C by CT without int32 overflow: only bits <= 27 of the
        # result are ever read (bit 27 is the carry), so pre-mask the input
        st["c"] = (st["c"] & (0xFFFFFFF >> st["ct"])) << st["ct"]
        st = _enc_byteout(jax, jnp, st, on)
    return st


def _enc_flush_masked(jax, jnp, st, mask):
    """FLUSH for the masked lanes only (TERMALL/BYPASS termination)."""
    tempc = st["c"] + st["a"]
    c = st["c"] | 0xFFFF
    c = jnp.where(c >= tempc, c - 0x8000, c)
    st = dict(st)
    st["c"] = jnp.where(mask, c, st["c"])
    for _ in range(2):
        newc = (st["c"] & (0xFFFFFFF >> st["ct"])) << st["ct"]
        st["c"] = jnp.where(mask, newc, st["c"])
        st = _enc_byteout(jax, jnp, st, mask)
    return st


def _enc_raw_push(jax, jnp, st, byte, mask):
    """Append one raw byte for masked lanes (pos+1, buf[pos]=byte)."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    wpos = jnp.where(mask, st["pos"] + 1, st["pos"])
    prev = st["buf"][wpos, lanes]
    st = dict(st)
    st["buf"] = st["buf"].at[wpos, lanes].set(
        jnp.where(mask, byte.astype(jnp.uint8), prev), mode="drop"
    )
    st["pos"] = wpos
    return st


def _enc_raw_start(jax, jnp, st, mask):
    """Begin a raw (bypass) segment after the byte at pos (mq_np.raw_start)."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    lastb = st["buf"][st["pos"], lanes].astype(jnp.int32)
    st = dict(st)
    st["raw_tmp"] = jnp.where(mask, 0, st["raw_tmp"])
    st["raw_used"] = jnp.where(mask, 0, st["raw_used"])
    st["raw_avail"] = jnp.where(mask, jnp.where(lastb == 0xFF, 7, 8),
                                st["raw_avail"])
    return st


def _enc_raw_bit(jax, jnp, st, bit, mask):
    """MSB-first raw bit with 0xFF stuffing (mq_np.MQEncoder.raw_bit)."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    tmp = jnp.where(mask, (st["raw_tmp"] << 1) | bit, st["raw_tmp"])
    used = st["raw_used"] + jnp.where(mask, 1, 0)
    flush = mask & (used == st["raw_avail"])
    st = dict(st)
    st["raw_tmp"] = tmp
    st["raw_used"] = used
    st = _enc_raw_push(jax, jnp, st, tmp & 0xFF, flush)
    lastb = st["buf"][st["pos"], lanes].astype(jnp.int32)
    st["raw_avail"] = jnp.where(flush, jnp.where(lastb == 0xFF, 7, 8),
                                st["raw_avail"])
    st["raw_tmp"] = jnp.where(flush, 0, st["raw_tmp"])
    st["raw_used"] = jnp.where(flush, 0, st["raw_used"])
    return st


def _enc_terminate_restart(jax, jnp, st, mask):
    """Masked MQ segment termination + register restart; returns
    (st, cumulative length per lane) — mq_np.terminate_restart."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    st = _enc_flush_masked(jax, jnp, st, mask)
    lastb = st["buf"][st["pos"], lanes].astype(jnp.int32)
    length = st["pos"] + jnp.where(lastb != 0xFF, 1, 0) - 1
    st = dict(st)
    st["pos"] = jnp.where(mask, length, st["pos"])
    newlast = st["buf"][st["pos"], lanes].astype(jnp.int32)
    st["a"] = jnp.where(mask, 0x8000, st["a"])
    st["c"] = jnp.where(mask, 0, st["c"])
    st["ct"] = jnp.where(mask, jnp.where(newlast == 0xFF, 13, 12), st["ct"])
    return st, length


def _enc_raw_terminate(jax, jnp, st, mask):
    """Byte-align raw segments, restart MQ; returns (st, length per lane)
    — mq_np.raw_terminate_restart_mq."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    pend = mask & (st["raw_used"] > 0)
    pad = jnp.where(pend, st["raw_tmp"] << (st["raw_avail"] - st["raw_used"]),
                    0)
    st = _enc_raw_push(jax, jnp, st, pad & 0xFF, pend)
    lastb = st["buf"][st["pos"], lanes].astype(jnp.int32)
    fix = mask & (lastb == 0xFF)  # raw segments cannot end 0xFF
    st = _enc_raw_push(jax, jnp, st, jnp.zeros_like(lastb), fix)
    length = st["pos"]
    st = dict(st)
    lastb2 = st["buf"][st["pos"], lanes].astype(jnp.int32)
    st["a"] = jnp.where(mask, 0x8000, st["a"])
    st["c"] = jnp.where(mask, 0, st["c"])
    st["ct"] = jnp.where(mask, jnp.where(lastb2 == 0xFF, 13, 12), st["ct"])
    st["raw_tmp"] = jnp.where(mask, 0, st["raw_tmp"])
    st["raw_used"] = jnp.where(mask, 0, st["raw_used"])
    return st, length


def _pass_typ(jnp, p):
    """Pass type of global pass index p: 0 SPP, 1 MRP, 2 CUP."""
    return jnp.where(p == 0, 2, (p - 1) % 3)


def _term_after_m(jnp, termall_m, bypass_m, idx, kind):
    """T.800 D.4: which lanes terminate their segment after pass idx of
    static type `kind` (SPP never terminates under lazy mode; MRP from
    pass 11 on; CUP from pass 9 on)."""
    if kind == 0:
        byp = jnp.zeros_like(bypass_m)
    elif kind == 1:
        byp = bypass_m & (idx > 9)
    else:
        byp = bypass_m & (idx >= 9)
    return termall_m | byp


def _is_raw_m(jnp, bypass_m, idx, kind):
    """Lanes for which pass (idx, kind) is a raw (bypass) pass."""
    if kind == 2:
        return jnp.zeros_like(bypass_m)
    return bypass_m & (idx >= 10)


# ---------------------------------------------------------------- MQ (dec)
def _dec_byte_at(jax, jnp, st, idx):
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    clipped = jnp.minimum(idx, st["buf"].shape[0] - 1)
    vals = st["buf"][clipped, lanes].astype(jnp.int32)
    return jnp.where(idx < st["end"], vals, 0xFF)


def _dec_bytein(jax, jnp, st, mask):
    b = _dec_byte_at(jax, jnp, st, st["bp"])
    b1 = _dec_byte_at(jax, jnp, st, st["bp"] + 1)
    is_ff = b == 0xFF
    marker = is_ff & (b1 > 0x8F)  # marker (or end): feed 1 bits
    adv7 = is_ff & ~marker

    c = st["c"]  # uint32
    b1u = b1.astype(jnp.uint32)
    new_c = jnp.where(marker, c + jnp.uint32(0xFF00),
                      jnp.where(adv7, c + (b1u << 9), c + (b1u << 8)))
    new_ct = jnp.where(marker, 8, jnp.where(adv7, 7, 8))
    new_bp = jnp.where(marker, st["bp"], st["bp"] + 1)

    st = dict(st)
    st["c"] = jnp.where(mask, new_c, c)
    st["ct"] = jnp.where(mask, new_ct, st["ct"])
    st["bp"] = jnp.where(mask, new_bp, st["bp"])
    return st


def _dec_renorm(jax, jnp, st, need):
    """Lockstep decoder renorm: a <<= k with byteins when CT exhausts.

    Mirrors mq_np.MQDecoder._renorm (bytein when ct==0, THEN shift)."""
    a = st["a"]
    k = jnp.where(need, 16 - _bitlen32(jax, jnp, jnp.maximum(a, 1)), 0)
    st = dict(st)
    st["a"] = jnp.where(need, a << k, a)
    for _ in range(3):
        st = _dec_bytein(jax, jnp, st, need & (st["ct"] == 0) & (k > 0))
        take = jnp.minimum(k, st["ct"]).astype(jnp.uint32)
        st["c"] = jnp.where(need, st["c"] << take, st["c"])
        st["ct"] = st["ct"] - jnp.where(need, take.astype(jnp.int32), 0)
        k = k - take.astype(jnp.int32)
    return st


def _dec_decode(jax, jnp, st, ctx, mask, tables):
    """One lockstep DECODE; returns (st, bit [N] int32)."""
    qe_t, nmps_t, nlps_t, sw_t = tables
    onehot = (jnp.arange(19)[None, :] == ctx[:, None]) & mask[:, None]

    state = jnp.take_along_axis(st["cx_state"], ctx[:, None], axis=1)[:, 0]
    mps = jnp.take_along_axis(st["cx_mps"], ctx[:, None], axis=1)[:, 0]
    qe = jnp.take(qe_t, state)

    a = st["a"] - qe
    chigh = ((st["c"] >> 16) & jnp.uint32(0xFFFF)).astype(jnp.int32)
    lps_path = mask & (chigh < qe)
    mps_path = mask & ~lps_path

    st = dict(st)
    st["c"] = jnp.where(mps_path, st["c"] - (qe.astype(jnp.uint32) << 16),
                        st["c"])
    st["a"] = jnp.where(mask, a, st["a"])

    need_renorm_mps = mps_path & ((a & 0x8000) == 0)
    ex_mps = need_renorm_mps & (a < qe)  # exchange: decode LPS symbol
    ex_lps = lps_path & (a < qe)  # exchange: decode MPS symbol

    bit = jnp.where(mps_path, jnp.where(ex_mps, 1 - mps, mps),
                    jnp.where(ex_lps, mps, 1 - mps))
    bit = jnp.where(mask, bit, 0).astype(jnp.int32)

    # state transitions
    take_nmps = (mps_path & ~ex_mps & need_renorm_mps) | ex_lps
    take_nlps = ex_mps | (lps_path & ~ex_lps)
    new_state = jnp.where(take_nmps, jnp.take(nmps_t, state),
                          jnp.where(take_nlps, jnp.take(nlps_t, state), state))
    st["cx_state"] = jnp.where(onehot, new_state[:, None], st["cx_state"])
    sw = take_nlps & (jnp.take(sw_t, state) == 1)
    new_mps = jnp.where(sw, 1 - mps, mps)
    st["cx_mps"] = jnp.where(onehot, new_mps[:, None], st["cx_mps"])

    st["a"] = jnp.where(lps_path, qe, st["a"])
    st = _dec_renorm(jax, jnp, st, need_renorm_mps | lps_path)
    return st, bit


def _dec_init_registers(jax, jnp, st, mask):
    """Masked INITDEC at st["bp"] (segment re-prime; ctx states persist)."""
    b0 = _dec_byte_at(jax, jnp, st, st["bp"])
    c0 = b0.astype(jnp.uint32) << 16
    old_c, old_ct, old_a = st["c"], st["ct"], st["a"]
    st = dict(st)
    st["c"] = jnp.where(mask, c0, old_c)
    st["ct"] = jnp.where(mask, 0, old_ct)
    st = _dec_bytein(jax, jnp, st, mask)
    st["c"] = jnp.where(mask, st["c"] << 7, st["c"])
    st["ct"] = jnp.where(mask, st["ct"] - 7, st["ct"])
    st["a"] = jnp.where(mask, 0x8000, old_a)
    return st


def _dec_raw_init(jax, jnp, st, mask, base, seg_len):
    """Begin reading a raw (bypass) segment at absolute offset base."""
    st = dict(st)
    st["rpos"] = jnp.where(mask, base, st["rpos"])
    st["rend"] = jnp.where(mask, base + seg_len, st["rend"])
    st["rbits"] = jnp.where(mask, 0, st["rbits"])
    st["rprev_ff"] = jnp.where(mask, False, st["rprev_ff"])
    return st


def _dec_raw_bit(jax, jnp, st, mask):
    """MSB-first raw bit with 0xFF unstuffing (mq_np.MQDecoder.raw_bit)."""
    n = st["a"].shape[0]
    lanes = jnp.arange(n)
    refill = mask & (st["rbits"] == 0)
    clipped = jnp.minimum(st["rpos"], st["buf"].shape[0] - 1)
    b = jnp.where(st["rpos"] < st["rend"],
                  st["buf"][clipped, lanes].astype(jnp.int32), 0xFF)
    st = dict(st)
    st["rbits"] = jnp.where(refill, jnp.where(st["rprev_ff"], 7, 8),
                            st["rbits"])
    st["rtmp"] = jnp.where(refill, b, st["rtmp"])
    st["rprev_ff"] = jnp.where(refill, b == 0xFF, st["rprev_ff"])
    st["rpos"] = jnp.where(refill, st["rpos"] + 1, st["rpos"])
    st["rbits"] = st["rbits"] - jnp.where(mask, 1, 0)
    bit = jnp.where(mask, (st["rtmp"] >> st["rbits"]) & 1, 0).astype(jnp.int32)
    return st, bit


# ------------------------------------------------------------- scan helpers
def _neigh(jnp, plane_arr, y, x):
    """3x3 window [3,3,N] around padded coords (y, x) from [H+2,W+2,N]."""
    import jax

    return jax.lax.dynamic_slice(
        plane_arr, (y - 1, x - 1, 0), (3, 3, plane_arr.shape[2])
    )


def _is_stripe_bottom(jnp, y):
    """Row at a stripe bottom (block row (y-1) has (y-1)&3 == 3)."""
    return ((y - 1) % 4) == 3


def _zc_ctx(jax, jnp, sig, orients_oh, y, x, zc_lut, vsc_m):
    win = _neigh(jnp, sig, y, x)
    cut = vsc_m & _is_stripe_bottom(jnp, y)
    below = lambda col: jnp.where(cut, 0, win[2, col])
    hcnt = win[1, 0] + win[1, 2]
    vcnt = win[0, 1] + below(1)
    dcnt = win[0, 0] + win[0, 2] + below(0) + below(2)
    idx = hcnt * 15 + vcnt * 5 + dcnt
    vals = jnp.take(zc_lut, idx[None, :] + 45 * jnp.arange(4)[:, None])  # [4, N]
    ctx = jnp.sum(vals * orients_oh.T, axis=0).astype(jnp.int32)
    return ctx, hcnt + vcnt + dcnt


def _sc_ctx(jax, jnp, sig, sgn, y, x, sc_ctx_t, sc_xor_t, vsc_m):
    ws = _neigh(jnp, sig, y, x)
    wg = _neigh(jnp, sgn, y, x)
    cut = vsc_m & _is_stripe_bottom(jnp, y)
    contrib = lambda a, b: ws[a, b] * (1 - 2 * wg[a, b])
    below = jnp.where(cut, 0, contrib(2, 1))
    hbar = jnp.clip(contrib(1, 0) + contrib(1, 2), -1, 1)
    vbar = jnp.clip(contrib(0, 1) + below, -1, 1)
    idx = (hbar + 1) * 3 + (vbar + 1)
    return jnp.take(sc_ctx_t, idx).astype(jnp.int32), jnp.take(sc_xor_t, idx)


def _set_at(jax, jnp, plane_arr, y, x, vals):
    return jax.lax.dynamic_update_slice(plane_arr, vals[None, None, :], (y, x, 0))


def _get_at(jax, jnp, plane_arr, y, x):
    return jax.lax.dynamic_slice(plane_arr, (y, x, 0), (1, 1, plane_arr.shape[2]))[0, 0]


def _dd_sig_f32(jnp, mag, plane):
    dv = mag.astype(jnp.float32)
    rec = jnp.float32(1.5) * jnp.exp2(plane.astype(jnp.float32))
    return dv * dv - (dv - rec) * (dv - rec)


def _dd_ref_f32(jnp, mag, plane):
    dv = mag.astype(jnp.float32)
    rb = ((mag >> (plane + 1)) << (plane + 1)).astype(jnp.float32) + jnp.exp2(
        plane.astype(jnp.float32)
    )
    ra = ((mag >> plane) << plane).astype(jnp.float32) + jnp.exp2(
        plane.astype(jnp.float32) - 1
    )
    return (dv - rb) * (dv - rb) - (dv - ra) * (dv - ra)


def _reset_ctx_lanes(jnp, st, mask):
    init = jnp.asarray(_INIT_CTX)[None, :]
    st = dict(st)
    st["cx_state"] = jnp.where(mask[:, None], init, st["cx_state"])
    st["cx_mps"] = jnp.where(mask[:, None], 0, st["cx_mps"])
    return st


def _lpi(jnp, plane, kind, numbps):
    """Lane-local pass index (mirror of ebcot_np._local_pass_index)."""
    rel = numbps - 1 - plane
    return jnp.where(rel <= 0, 0, (rel - 1) * 3 + 1 + kind)


# ================================================================= encoder
def _build_encoder(jax, jnp, H, W, N, max_bytes, max_passes):
    tables = _mq_tables(jnp)
    zc_lut = jnp.asarray(_ZC_LUT.reshape(-1), dtype=jnp.int32)
    sc_ctx_t = jnp.asarray(_SC_CTX, dtype=jnp.int32)
    sc_xor_t = jnp.asarray(_SC_XOR, dtype=jnp.int32)
    nstripes = (H + 3) // 4

    def make(inb):
        def mq_enc(st, bit, ctx, mask):
            return _enc_encode(jax, jnp, st, bit, ctx, mask, tables)

        def code_sign(st, y, x, became, plane, rawm=None):
            sc, xr = _sc_ctx(jax, jnp, st["sig"], st["sgn"], y, x, sc_ctx_t,
                             sc_xor_t, st["vsc"])
            sbit = (_get_at(jax, jnp, st["sgn"], y, x) ^ xr).astype(jnp.int32)
            mqm = became if rawm is None else became & ~rawm
            st = mq_enc(st, sbit, sc, mqm)
            st["sig"] = _set_at(
                jax, jnp, st["sig"],
                y, x,
                jnp.where(became, 1, _get_at(jax, jnp, st["sig"], y, x)),
            )
            mag_v = _get_at(jax, jnp, st["mag"], y, x)
            st["dist_acc"] = st["dist_acc"] + jnp.where(
                became, _dd_sig_f32(jnp, mag_v, plane), 0.0
            )
            return st

        def spp_body(st, y, x, plane, lanes_m):
            pos_inb = jax.lax.dynamic_slice(inb, (y - 1, x - 1, 0), (1, 1, N))[0, 0]
            sig_v = _get_at(jax, jnp, st["sig"], y, x)
            ctx, ncnt = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x, zc_lut,
                                st["vsc"])
            code = lanes_m & (pos_inb == 1) & (sig_v == 0) & (ncnt > 0)
            bit = ((_get_at(jax, jnp, st["mag"], y, x) >> plane) & 1).astype(jnp.int32)
            rawm = st["in_raw"] & code
            st = _enc_raw_bit(jax, jnp, st, bit, rawm)
            st = mq_enc(st, bit, ctx, code & ~rawm)
            vis = _get_at(jax, jnp, st["visited"], y, x)
            st["visited"] = _set_at(
                jax, jnp, st["visited"], y, x, jnp.where(code, 1, vis)
            )
            became = code & (bit == 1)
            # raw sign bit goes out verbatim (no sign-context xor)
            sgn_v = _get_at(jax, jnp, st["sgn"], y, x).astype(jnp.int32)
            st = _enc_raw_bit(jax, jnp, st, sgn_v, became & rawm)
            st = code_sign(st, y, x, became, plane, rawm)
            return st

        def mrp_body(st, y, x, plane, lanes_m):
            pos_inb = jax.lax.dynamic_slice(inb, (y - 1, x - 1, 0), (1, 1, N))[0, 0]
            sig_v = _get_at(jax, jnp, st["sig"], y, x)
            vis = _get_at(jax, jnp, st["visited"], y, x)
            code = lanes_m & (pos_inb == 1) & (sig_v == 1) & (vis == 0)
            _, ncnt = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x, zc_lut,
                              st["vsc"])
            ref = _get_at(jax, jnp, st["refined"], y, x)
            ctx = jnp.where(
                ref == 1, CTX_MR0 + 2, jnp.where(ncnt > 0, CTX_MR0 + 1, CTX_MR0)
            ).astype(jnp.int32)
            mag_v = _get_at(jax, jnp, st["mag"], y, x)
            bit = ((mag_v >> plane) & 1).astype(jnp.int32)
            rawm = st["in_raw"] & code
            st = _enc_raw_bit(jax, jnp, st, bit, rawm)
            st = mq_enc(st, bit, ctx, code & ~rawm)
            st["refined"] = _set_at(
                jax, jnp, st["refined"], y, x, jnp.where(code, 1, ref)
            )
            st["dist_acc"] = st["dist_acc"] + jnp.where(
                code, _dd_ref_f32(jnp, mag_v, plane), 0.0
            )
            return st

        def cup_col(st, s_idx, x, plane, lanes_m):
            y0 = 4 * s_idx + 1
            rl0 = lanes_m & (st["full_stripe"][s_idx] == 1)
            colw = jax.lax.dynamic_slice(inb, (4 * s_idx, x - 1, 0), (4, 1, N))[:, 0]
            rl0 = rl0 & (colw[0] == 1)  # x within lane width, row0 in block

            def rl_scan(k, rl):
                y = y0 + k
                sig_v = _get_at(jax, jnp, st["sig"], y, x)
                vis = _get_at(jax, jnp, st["visited"], y, x)
                _, ncnt = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x,
                                  zc_lut, st["vsc"])
                return rl & (sig_v == 0) & (vis == 0) & (ncnt == 0)

            rl = jax.lax.fori_loop(0, 4, rl_scan, rl0)

            def fk_scan(k, first_k):
                bit = ((_get_at(jax, jnp, st["mag"], y0 + k, x) >> plane) & 1)
                hit = rl & (bit == 1) & (first_k == 4)
                return jnp.where(hit, k, first_k).astype(jnp.int32)

            first_k = jax.lax.fori_loop(
                0, 4, fk_scan, jnp.full((N,), 4, dtype=jnp.int32)
            )
            rl_bit = jnp.where(rl & (first_k < 4), 1, 0).astype(jnp.int32)
            rl_ctx = jnp.full((N,), CTX_RL, dtype=jnp.int32)
            uni_ctx = jnp.full((N,), CTX_UNI, dtype=jnp.int32)
            st = mq_enc(st, rl_bit, rl_ctx, rl)
            sigcol = rl & (rl_bit == 1)
            st = mq_enc(st, (first_k >> 1) & 1, uni_ctx, sigcol)
            st = mq_enc(st, first_k & 1, uni_ctx, sigcol)
            skip_rl0 = rl & (rl_bit == 0)

            def code_row(k, st):
                y = y0 + k
                pos_inb = jax.lax.dynamic_slice(inb, (y - 1, x - 1, 0), (1, 1, N))[0, 0]
                sig_v = _get_at(jax, jnp, st["sig"], y, x)
                vis = _get_at(jax, jnp, st["visited"], y, x)
                base = (
                    lanes_m & (pos_inb == 1) & (sig_v == 0) & (vis == 0) & ~skip_rl0
                )
                pre_run = rl & (rl_bit == 1) & (k < first_k)
                implied = rl & (rl_bit == 1) & (k == first_k)
                zc_code = base & ~pre_run & ~implied
                ctx, _ = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x,
                                 zc_lut, st["vsc"])
                bit = ((_get_at(jax, jnp, st["mag"], y, x) >> plane) & 1).astype(jnp.int32)
                st = mq_enc(st, bit, ctx, zc_code)
                became = (zc_code & (bit == 1)) | implied
                return code_sign(st, y, x, became, plane)

            return jax.lax.fori_loop(0, 4, code_row, st)

        def pass_loop(st, plane, lanes_m, kind):
            def stripe_loop(s_idx, st):
                def col_loop(x, st):
                    if kind == 2:
                        return cup_col(st, s_idx, x + 1, plane, lanes_m)

                    # fori over the 4 stripe rows: the row body is traced
                    # once instead of four times (XLA program size, and
                    # with it compile time, drops ~4x)
                    def row_body(k, st2):
                        y = 4 * s_idx + k + 1
                        if kind == 0:
                            return spp_body(st2, y, x + 1, plane, lanes_m)
                        return mrp_body(st2, y, x + 1, plane, lanes_m)

                    return jax.lax.fori_loop(0, 4, row_body, st)

                return jax.lax.fori_loop(0, W, col_loop, st)

            st = jax.lax.fori_loop(0, nstripes, stripe_loop, st)
            if kind == 2:
                # segmentation symbol 1010 for SEGSYM lanes
                uni_ctx = jnp.full((N,), CTX_UNI, dtype=jnp.int32)
                seg = st["segsym"] & lanes_m
                for b in (1, 0, 1, 0):
                    st = mq_enc(st, jnp.full((N,), b, jnp.int32), uni_ctx, seg)
            return st

        def end_pass(st, plane, kind, lanes_m, numbps):
            """Record the truncation rate + pass distortion; terminate
            TERMALL/BYPASS segments; enter/leave raw mode; reset."""
            idx = _lpi(jnp, plane, kind, numbps)
            raw_now = st["in_raw"]
            est = jnp.where(
                raw_now,
                st["pos"] + jnp.where(st["raw_used"] > 0, 1, 0),
                st["pos"] + (27 - st["ct"] + 7) // 8,
            )
            term = _term_after_m(jnp, st["termall"], st["bypass"], idx,
                                 kind) & lanes_m
            st, len_mq = _enc_terminate_restart(jax, jnp, st, term & ~raw_now)
            st, len_raw = _enc_raw_terminate(jax, jnp, st, term & raw_now)
            r = jnp.where(term, jnp.where(raw_now, len_raw, len_mq), est)
            lanes = jnp.arange(N)
            st = dict(st)
            st["rates"] = st["rates"].at[idx, lanes].set(
                jnp.where(lanes_m, r, st["rates"][idx, lanes]), mode="drop"
            )
            st["dists"] = st["dists"].at[idx, lanes].set(
                jnp.where(lanes_m, st["dist_acc"], st["dists"][idx, lanes]),
                mode="drop",
            )
            st["dist_acc"] = jnp.zeros_like(st["dist_acc"])
            st["last_term"] = jnp.where(lanes_m, term, st["last_term"])
            st = _reset_ctx_lanes(jnp, st, st["reset"] & lanes_m)
            # raw mode for the NEXT pass starts right after a termination
            nxt_raw = term & _is_raw_m(
                jnp, st["bypass"], idx + 1,
                {0: 1, 1: 2, 2: 0}[kind],
            )
            st = _enc_raw_start(jax, jnp, st, nxt_raw)
            st["in_raw"] = jnp.where(term, nxt_raw, st["in_raw"])
            return st

        def plane_body(p_rev, carry):
            st, numbps, pmax = carry
            plane = pmax - 1 - p_rev
            spp_lanes = (numbps - 1 > plane) & (plane >= 0)
            cup_lanes = (numbps - 1 >= plane) & (plane >= 0)
            st = pass_loop(st, plane, spp_lanes, 0)
            st = end_pass(st, plane, 0, spp_lanes, numbps)
            st = pass_loop(st, plane, spp_lanes, 1)
            st = end_pass(st, plane, 1, spp_lanes, numbps)
            st = pass_loop(st, plane, cup_lanes, 2)
            st = end_pass(st, plane, 2, cup_lanes, numbps)
            st = dict(st)
            st["visited"] = jnp.zeros_like(st["visited"])
            return (st, numbps, pmax)

        def encode(mag, sgn, or_oh, inb_dyn, full_stripe, numbps, vsc, reset,
                   segsym, termall, bypass, pmax):
            st = {
                "mag": mag,
                "sgn": sgn,
                "sig": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "visited": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "refined": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "or_oh": or_oh,
                "full_stripe": full_stripe,
                "vsc": vsc,
                "reset": reset,
                "segsym": segsym,
                "termall": termall,
                "bypass": bypass,
                "in_raw": jnp.zeros((N,), bool),
                "last_term": jnp.zeros((N,), bool),
                "raw_tmp": jnp.zeros((N,), jnp.int32),
                "raw_used": jnp.zeros((N,), jnp.int32),
                "raw_avail": jnp.full((N,), 8, jnp.int32),
                "a": jnp.full((N,), 0x8000, jnp.int32),
                "c": jnp.zeros((N,), jnp.int32),
                "ct": jnp.full((N,), 12, jnp.int32),
                "buf": jnp.zeros((max_bytes, N), jnp.uint8),
                "pos": jnp.zeros((N,), jnp.int32),
                "cx_state": jnp.tile(jnp.asarray(_INIT_CTX)[None, :], (N, 1)),
                "cx_mps": jnp.zeros((N, 19), jnp.int32),
                "rates": jnp.zeros((max_passes, N), jnp.int32),
                "dists": jnp.zeros((max_passes, N), jnp.float32),
                "dist_acc": jnp.zeros((N,), jnp.float32),
            }
            st, _, _ = jax.lax.fori_loop(
                0, pmax, plane_body, (st, numbps, jnp.int32(pmax))
            )
            # lanes whose final pass terminated already carry their length
            # in rates[npasses-1]; flush only the rest
            st = _enc_flush_masked(jax, jnp, st, ~st["last_term"])
            lanes = jnp.arange(N)
            lastb = st["buf"][st["pos"], lanes]
            flush_len = st["pos"] + jnp.where(lastb != 0xFF, 1, 0) - 1
            npi = jnp.maximum(3 * numbps - 3, 0)
            term_len = st["rates"][npi, lanes]
            lengths = jnp.where(st["last_term"], term_len, flush_len)
            return st["buf"], lengths, st["rates"], st["dists"]

        return encode

    return make


# ================================================================= decoder
def _build_decoder(jax, jnp, H, W, N, max_bytes):
    tables = _mq_tables(jnp)
    zc_lut = jnp.asarray(_ZC_LUT.reshape(-1), dtype=jnp.int32)
    sc_ctx_t = jnp.asarray(_SC_CTX, dtype=jnp.int32)
    sc_xor_t = jnp.asarray(_SC_XOR, dtype=jnp.int32)
    nstripes = (H + 3) // 4

    def make(inb):
        def mq_dec(st, ctx, mask):
            return _dec_decode(jax, jnp, st, ctx, mask, tables)

        def dec_sign(st, y, x, became, plane, rawm=None):
            sc, xr = _sc_ctx(jax, jnp, st["sig"], st["sgn"], y, x, sc_ctx_t,
                             sc_xor_t, st["vsc"])
            if rawm is None:
                rawm = jnp.zeros_like(became)
            st, sbit = mq_dec(st, sc, became & ~rawm)
            st, rbit = _dec_raw_bit(jax, jnp, st, became & rawm)
            sgn_new = jnp.where(rawm, rbit, sbit ^ xr)
            sgn_v = _get_at(jax, jnp, st["sgn"], y, x)
            st["sgn"] = _set_at(
                jax, jnp, st["sgn"], y, x,
                jnp.where(became, sgn_new, sgn_v),
            )
            mag_v = _get_at(jax, jnp, st["mag"], y, x)
            # scaled-by-2 mid-bin reconstruction (1.5 * 2^plane)
            st["mag"] = _set_at(
                jax, jnp, st["mag"], y, x,
                jnp.where(became, 3 << plane, mag_v),
            )
            st["sig"] = _set_at(
                jax, jnp, st["sig"], y, x,
                jnp.where(became, 1, _get_at(jax, jnp, st["sig"], y, x)),
            )
            return st

        def spp_body(st, y, x, plane, lanes_m):
            pos_inb = jax.lax.dynamic_slice(inb, (y - 1, x - 1, 0), (1, 1, N))[0, 0]
            sig_v = _get_at(jax, jnp, st["sig"], y, x)
            ctx, ncnt = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x, zc_lut,
                                st["vsc"])
            code = lanes_m & (pos_inb == 1) & (sig_v == 0) & (ncnt > 0)
            rawm = st["in_raw"] & code
            st, bit = mq_dec(st, ctx, code & ~rawm)
            st, rbit = _dec_raw_bit(jax, jnp, st, rawm)
            bit = jnp.where(rawm, rbit, bit)
            vis = _get_at(jax, jnp, st["visited"], y, x)
            st["visited"] = _set_at(
                jax, jnp, st["visited"], y, x, jnp.where(code, 1, vis)
            )
            became = code & (bit == 1)
            st = dec_sign(st, y, x, became, plane, st["in_raw"])
            return st

        def mrp_body(st, y, x, plane, lanes_m):
            pos_inb = jax.lax.dynamic_slice(inb, (y - 1, x - 1, 0), (1, 1, N))[0, 0]
            sig_v = _get_at(jax, jnp, st["sig"], y, x)
            vis = _get_at(jax, jnp, st["visited"], y, x)
            code = lanes_m & (pos_inb == 1) & (sig_v == 1) & (vis == 0)
            _, ncnt = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x, zc_lut,
                              st["vsc"])
            ref = _get_at(jax, jnp, st["refined"], y, x)
            ctx = jnp.where(
                ref == 1, CTX_MR0 + 2, jnp.where(ncnt > 0, CTX_MR0 + 1, CTX_MR0)
            ).astype(jnp.int32)
            rawm = st["in_raw"] & code
            st, bit = mq_dec(st, ctx, code & ~rawm)
            st, rbit = _dec_raw_bit(jax, jnp, st, rawm)
            bit = jnp.where(rawm, rbit, bit)
            mag_v = _get_at(jax, jnp, st["mag"], y, x)
            st["mag"] = _set_at(
                jax, jnp, st["mag"], y, x,
                jnp.where(code,
                          mag_v + jnp.where(bit == 1, 1 << plane,
                                            -(1 << plane)),
                          mag_v),
            )
            st["refined"] = _set_at(
                jax, jnp, st["refined"], y, x, jnp.where(code, 1, ref)
            )
            return st

        def cup_col(st, s_idx, x, plane, lanes_m):
            y0 = 4 * s_idx + 1
            rl0 = lanes_m & (st["full_stripe"][s_idx] == 1)
            colw = jax.lax.dynamic_slice(inb, (4 * s_idx, x - 1, 0), (4, 1, N))[:, 0]
            rl0 = rl0 & (colw[0] == 1)

            def rl_scan(k, rl):
                y = y0 + k
                sig_v = _get_at(jax, jnp, st["sig"], y, x)
                vis = _get_at(jax, jnp, st["visited"], y, x)
                _, ncnt = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x,
                                  zc_lut, st["vsc"])
                return rl & (sig_v == 0) & (vis == 0) & (ncnt == 0)

            rl = jax.lax.fori_loop(0, 4, rl_scan, rl0)
            rl_ctx = jnp.full((N,), CTX_RL, dtype=jnp.int32)
            uni_ctx = jnp.full((N,), CTX_UNI, dtype=jnp.int32)
            st, rl_bit = mq_dec(st, rl_ctx, rl)
            sigcol = rl & (rl_bit == 1)
            st, b1 = mq_dec(st, uni_ctx, sigcol)
            st, b0 = mq_dec(st, uni_ctx, sigcol)
            first_k = jnp.where(sigcol, (b1 << 1) | b0, 4)
            skip_rl0 = rl & (rl_bit == 0)

            def code_row(k, st):
                y = y0 + k
                pos_inb = jax.lax.dynamic_slice(inb, (y - 1, x - 1, 0), (1, 1, N))[0, 0]
                sig_v = _get_at(jax, jnp, st["sig"], y, x)
                vis = _get_at(jax, jnp, st["visited"], y, x)
                base = (
                    lanes_m & (pos_inb == 1) & (sig_v == 0) & (vis == 0) & ~skip_rl0
                )
                pre_run = rl & (rl_bit == 1) & (k < first_k)
                implied = rl & (rl_bit == 1) & (k == first_k)
                zc_code = base & ~pre_run & ~implied
                ctx, _ = _zc_ctx(jax, jnp, st["sig"], st["or_oh"], y, x,
                                 zc_lut, st["vsc"])
                st, bit = mq_dec(st, ctx, zc_code)
                became = (zc_code & (bit == 1)) | implied
                return dec_sign(st, y, x, became, plane)

            return jax.lax.fori_loop(0, 4, code_row, st)

        def pass_loop(st, plane, lanes_m, kind):
            def stripe_loop(s_idx, st):
                def col_loop(x, st):
                    if kind == 2:
                        return cup_col(st, s_idx, x + 1, plane, lanes_m)

                    # fori over the 4 stripe rows: the row body is traced
                    # once instead of four times (XLA program size, and
                    # with it compile time, drops ~4x)
                    def row_body(k, st2):
                        y = 4 * s_idx + k + 1
                        if kind == 0:
                            return spp_body(st2, y, x + 1, plane, lanes_m)
                        return mrp_body(st2, y, x + 1, plane, lanes_m)

                    return jax.lax.fori_loop(0, 4, row_body, st)

                return jax.lax.fori_loop(0, W, col_loop, st)

            st = jax.lax.fori_loop(0, nstripes, stripe_loop, st)
            if kind == 2:
                uni_ctx = jnp.full((N,), CTX_UNI, dtype=jnp.int32)
                seg = st["segsym"] & lanes_m
                for _ in range(4):
                    st, _b = mq_dec(st, uni_ctx, seg)
            return st

        def next_seg(st, idx, kind, lanes_m, npasses):
            """Advance segmented lanes whose pass (idx, kind) ended its
            codeword segment (mirrors ebcot_np decode next_seg)."""
            lanes = jnp.arange(N)
            adv = (lanes_m & st["segmented"]
                   & _term_after_m(jnp, st["termall"], st["bypass"], idx, kind)
                   & (idx + 1 < npasses))
            msegs = st["segl"].shape[1]
            cur_i = jnp.minimum(st["seg_i"], msegs - 1)
            cur = st["segl"][lanes, cur_i]
            st = dict(st)
            st["seg_off"] = st["seg_off"] + jnp.where(adv, cur, 0)
            st["seg_i"] = st["seg_i"] + jnp.where(adv, 1, 0)
            nxt_i = jnp.minimum(st["seg_i"], msegs - 1)
            nxt = jnp.where(st["seg_i"] < msegs, st["segl"][lanes, nxt_i], 0)
            nkind = {0: 1, 1: 2, 2: 0}[kind]
            nraw = _is_raw_m(jnp, st["bypass"], idx + 1, nkind)
            st = _dec_raw_init(jax, jnp, st, adv & nraw, st["seg_off"], nxt)
            rm = adv & ~nraw
            st["bp"] = jnp.where(rm, st["seg_off"], st["bp"])
            st["end"] = jnp.where(rm, st["seg_off"] + nxt, st["end"])
            st = _dec_init_registers(jax, jnp, st, rm)
            st["in_raw"] = jnp.where(adv, nraw, st["in_raw"])
            return st

        def plane_body(p_rev, carry):
            st, numbps, npasses, pmax = carry
            plane = pmax - 1 - p_rev
            lp_spp = _lpi(jnp, plane, 0, numbps)
            lp_mrp = _lpi(jnp, plane, 1, numbps)
            lp_cup = _lpi(jnp, plane, 2, numbps)
            spp_lanes = (numbps - 1 > plane) & (lp_spp < npasses) & (plane >= 0)
            mrp_lanes = (numbps - 1 > plane) & (lp_mrp < npasses) & (plane >= 0)
            cup_lanes = (numbps - 1 >= plane) & (lp_cup < npasses) & (plane >= 0)
            first_cup = (numbps - 1 == plane) & (npasses > 0) & (plane >= 0)
            cup_lanes = cup_lanes | first_cup
            st = pass_loop(st, plane, spp_lanes, 0)
            st = _reset_ctx_lanes(jnp, st, st["reset"] & spp_lanes)
            st = next_seg(st, lp_spp, 0, spp_lanes, npasses)
            st = pass_loop(st, plane, mrp_lanes, 1)
            st = _reset_ctx_lanes(jnp, st, st["reset"] & mrp_lanes)
            st = next_seg(st, lp_mrp, 1, mrp_lanes, npasses)
            st = pass_loop(st, plane, cup_lanes, 2)
            st = _reset_ctx_lanes(jnp, st, st["reset"] & cup_lanes)
            st = next_seg(st, lp_cup, 2, cup_lanes, npasses)
            st = dict(st)
            st["visited"] = jnp.zeros_like(st["visited"])
            return (st, numbps, npasses, pmax)

        def decode(buf, lengths, or_oh, inb_dyn, full_stripe, numbps, npasses,
                   vsc, reset, segsym, termall, bypass, segmented, segl,
                   pmax):
            end0 = jnp.where(segmented, segl[:, 0], lengths)
            st = {
                "mag": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "sgn": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "sig": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "visited": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "refined": jnp.zeros((H + 2, W + 2, N), jnp.int32),
                "or_oh": or_oh,
                "full_stripe": full_stripe,
                "vsc": vsc,
                "reset": reset,
                "segsym": segsym,
                "termall": termall,
                "bypass": bypass,
                "segmented": segmented,
                "segl": segl,
                "seg_off": jnp.zeros((N,), jnp.int32),
                "seg_i": jnp.zeros((N,), jnp.int32),
                "in_raw": jnp.zeros((N,), bool),
                "rtmp": jnp.zeros((N,), jnp.int32),
                "rbits": jnp.zeros((N,), jnp.int32),
                "rprev_ff": jnp.zeros((N,), bool),
                "rpos": jnp.zeros((N,), jnp.int32),
                "rend": jnp.zeros((N,), jnp.int32),
                "buf": buf,
                "end": end0,
                "bp": jnp.zeros((N,), jnp.int32),
                "a": jnp.zeros((N,), jnp.int32),
                "c": jnp.zeros((N,), jnp.uint32),
                "ct": jnp.zeros((N,), jnp.int32),
                "cx_state": jnp.tile(jnp.asarray(_INIT_CTX)[None, :], (N, 1)),
                "cx_mps": jnp.zeros((N, 19), jnp.int32),
            }
            # INITDEC
            b0 = _dec_byte_at(jax, jnp, st, st["bp"])
            st["c"] = b0.astype(jnp.uint32) << 16
            st = _dec_bytein(jax, jnp, st, jnp.ones((N,), bool))
            st["c"] = st["c"] << 7
            st["ct"] = st["ct"] - 7
            st["a"] = jnp.full((N,), 0x8000, jnp.int32)
            st, _, _, _ = jax.lax.fori_loop(
                0, pmax, plane_body, (st, numbps, npasses, jnp.int32(pmax))
            )
            coeffs = (st["mag"] >> 1) * (1 - 2 * st["sgn"])
            return coeffs[1 : H + 1, 1 : W + 1, :]

        return decode

    return make


# =============================================================== entry API
def _style_masks(np_styles, n):
    st = np.zeros(n, dtype=np.int64) if np_styles is None else np.asarray(np_styles)
    return ((st & 0x08) != 0, (st & 0x02) != 0, (st & 0x20) != 0,
            (st & 0x04) != 0, (st & 0x01) != 0)


def _check_styles(styles):
    if styles is not None and int(np.max(np.asarray(styles) & ~SUPPORTED_STYLES & 0x3F, initial=0)):
        raise NotImplementedError(
            "unsupported codeblock style bits for the jax backend"
        )


def encode_cblks(coeffs, heights, widths, orients, num_threads: int = 0,
                 styles=None, want_dist: bool = True):
    """Backend-API entry: host numpy in/out, device lockstep inside."""
    _check_styles(styles)
    jax, jnp = _j()
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int64)
    n, h0, w = coeffs.shape
    # pad the batch height to a whole stripe: the jitted scan visits 4 rows
    # per stripe and lax.dynamic_slice CLAMPS out-of-range starts, so rows
    # past the true height would silently alias row h-1
    h = ((h0 + 3) // 4) * 4
    if h != h0:
        coeffs = np.concatenate(
            [coeffs, np.zeros((n, h - h0, w), dtype=np.int64)], axis=1
        )
    mag_np = np.abs(coeffs)
    sgn_np = (coeffs < 0).astype(np.int64)

    # in-block predicate, lanes minor: [h, w, n]
    inb = (
        (np.arange(h)[:, None, None] < np.asarray(heights)[None, None, :])
        & (np.arange(w)[None, :, None] < np.asarray(widths)[None, None, :])
    ).astype(np.int32)

    mx = np.where(inb.transpose(2, 0, 1) > 0, mag_np, 0).reshape(n, -1).max(axis=1)
    numbps = np.zeros(n, dtype=np.int64)
    nz = mx > 0
    numbps[nz] = np.floor(np.log2(mx[nz])).astype(np.int64) + 1
    pmax = int(numbps.max(initial=0))
    npasses = np.maximum(numbps * 3 - 2, 0)
    max_bytes = max(64, (pmax * h * w) // 4 + 128)
    max_passes = max(int(npasses.max(initial=0)), 1)

    if pmax == 0:
        return T1EncodeResult(
            data=np.zeros((n, 1), np.uint8),
            lengths=np.zeros(n, np.int64),
            numbps=numbps,
            npasses=npasses,
            pass_rates=np.zeros((n, 1), np.int64),
            pass_dist=np.zeros((n, 1), np.float64),
        )

    nstripes = (h + 3) // 4
    full_stripe = (
        (4 * np.arange(nstripes)[:, None] + 4) <= np.asarray(heights)[None, :]
    ).astype(np.int32)

    mag_d = np.zeros((h + 2, w + 2, n), dtype=np.int32)
    mag_d[1 : h + 1, 1 : w + 1, :] = np.transpose(mag_np, (1, 2, 0))
    sgn_d = np.zeros((h + 2, w + 2, n), dtype=np.int32)
    sgn_d[1 : h + 1, 1 : w + 1, :] = np.transpose(sgn_np, (1, 2, 0))
    or_oh = (np.arange(4)[None, :] == np.asarray(orients)[:, None]).astype(np.int32)
    vsc, reset, segsym, termall, bypass = _style_masks(styles, n)

    import jax.numpy as jnp2

    enc = _get_cached_encoder(h, w, n, max_bytes, max_passes)
    buf, lengths, rates_d, dists_d = enc(
        jnp2.asarray(mag_d),
        jnp2.asarray(sgn_d),
        jnp2.asarray(or_oh),
        jnp2.asarray(inb),
        jnp2.asarray(full_stripe),
        jnp2.asarray(numbps, dtype=jnp2.int32),
        jnp2.asarray(vsc),
        jnp2.asarray(reset),
        jnp2.asarray(segsym),
        jnp2.asarray(termall),
        jnp2.asarray(bypass),
        pmax,
    )
    buf = np.asarray(buf)  # [max_bytes, N]
    lengths = np.asarray(lengths).astype(np.int64)
    lengths = np.where(npasses > 0, lengths, 0)
    data = np.ascontiguousarray(buf.T[:, 1:])
    rates = np.asarray(rates_d).T.astype(np.int64)  # [N, max_passes]
    dists = np.asarray(dists_d).T.astype(np.float64)
    # final pass rate = actual flushed length; clamp the safe bounds
    if max_passes:
        last = np.maximum(npasses - 1, 0)
        rates[np.arange(n), last] = lengths
        np.minimum(rates, lengths[:, None], out=rates)
    return T1EncodeResult(
        data=data,
        raw_data=(buf.T, 1) if buf.T.flags.c_contiguous else None,
        lengths=lengths,
        numbps=numbps,
        npasses=npasses,
        pass_rates=rates,
        pass_dist=dists,
    )


def decode_cblks(data, lengths, numbps, npasses, heights, widths, orients,
                 block_h, block_w, num_threads: int = 0, styles=None,
                 seg_lengths=None):
    """Device lockstep decode; mirrors ebcot_np.decode_cblks."""
    roi_rs = None
    if styles is not None:
        sa = np.asarray(styles)
        if (sa >> 8).any():
            roi_rs = (sa >> 8) & 0xFF
            styles = sa & 0xFF
    _check_styles(styles)
    jax, jnp = _j()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    h0, w = block_h, block_w
    h = ((h0 + 3) // 4) * 4  # see encode_cblks: stripe-padded batch height
    numbps = np.asarray(numbps, dtype=np.int64)
    npasses = np.asarray(npasses, dtype=np.int64)
    pmax = int(numbps.max(initial=0))
    if pmax == 0 or n == 0:
        return np.zeros((n, h, w), dtype=np.int64), np.zeros(n, dtype=np.int64)

    inb = (
        (np.arange(h)[:, None, None] < np.asarray(heights)[None, None, :])
        & (np.arange(w)[None, :, None] < np.asarray(widths)[None, None, :])
    ).astype(np.int32)
    nstripes = (h + 3) // 4
    full_stripe = (
        (4 * np.arange(nstripes)[:, None] + 4) <= np.asarray(heights)[None, :]
    ).astype(np.int32)
    or_oh = (np.arange(4)[None, :] == np.asarray(orients)[:, None]).astype(np.int32)
    vsc, reset, segsym, termall, bypass = _style_masks(styles, n)
    if seg_lengths is None:
        seg_arr = np.zeros((n, 1), dtype=np.int32)
    else:
        seg_arr = np.ascontiguousarray(seg_lengths, dtype=np.int32)
    segmented = (termall | bypass) & (seg_lengths is not None)

    import jax.numpy as jnp2

    dec = _get_cached_decoder(h, w, n, data.shape[1], seg_arr.shape[1])
    coeffs_d = dec(
        jnp2.asarray(np.ascontiguousarray(data.T)),  # [max_bytes, N]
        jnp2.asarray(np.asarray(lengths, dtype=np.int32)),
        jnp2.asarray(or_oh),
        jnp2.asarray(inb),
        jnp2.asarray(full_stripe),
        jnp2.asarray(numbps, dtype=jnp2.int32),
        jnp2.asarray(npasses, dtype=jnp2.int32),
        jnp2.asarray(vsc),
        jnp2.asarray(reset),
        jnp2.asarray(segsym),
        jnp2.asarray(termall),
        jnp2.asarray(bypass),
        jnp2.asarray(segmented),
        jnp2.asarray(seg_arr),
        pmax,
    )
    coeffs = np.transpose(np.asarray(coeffs_d), (2, 0, 1)).astype(np.int64)
    if roi_rs is not None:
        # the kernel already halved; apply the full-decode-equivalent ROI
        # rule on c (exact when the scaled magnitude was even — i.e. for
        # fully decoded blocks; truncated half-bit blocks may differ by
        # +-1 from the native scaled-domain rule)
        rs = roi_rs[:, None, None]
        mag = np.abs(coeffs)
        mag = np.where((rs > 0) & (mag >= (1 << np.maximum(rs - 1, 0))),
                       mag >> rs, mag)
        coeffs = np.where(coeffs < 0, -mag, mag)
    coeffs = coeffs[:, :h0, :]
    planes_decoded = np.minimum((npasses + 2) // 3, numbps)
    return coeffs, planes_decoded


_ENC_CACHE: dict = {}
_DEC_CACHE: dict = {}


def _get_cached_encoder(h, w, n, max_bytes, max_passes):
    jax, jnp = _j()
    key = (h, w, n, max_bytes, max_passes)
    if key not in _ENC_CACHE:
        make = _build_encoder(jax, jnp, h, w, n, max_bytes, max_passes)

        def run(mag, sgn, or_oh, inb, full_stripe, numbps, vsc, reset,
                segsym, termall, bypass, pmax):
            encode = make(inb)
            return encode(mag, sgn, or_oh, inb, full_stripe, numbps, vsc,
                          reset, segsym, termall, bypass, pmax)

        _ENC_CACHE[key] = jax.jit(run, static_argnums=(11,))
    return _ENC_CACHE[key]


def _get_cached_decoder(h, w, n, max_bytes, max_segs=1):
    jax, jnp = _j()
    key = (h, w, n, max_bytes, max_segs)
    if key not in _DEC_CACHE:
        make = _build_decoder(jax, jnp, h, w, n, max_bytes)

        def run(buf, lengths, or_oh, inb, full_stripe, numbps, npasses,
                vsc, reset, segsym, termall, bypass, segmented, segl, pmax):
            decode = make(inb)
            return decode(buf, lengths, or_oh, inb, full_stripe, numbps,
                          npasses, vsc, reset, segsym, termall, bypass,
                          segmented, segl, pmax)

        _DEC_CACHE[key] = jax.jit(run, static_argnums=(14,))
    return _DEC_CACHE[key]
