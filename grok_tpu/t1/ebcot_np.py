"""Batched EBCOT Tier-1 bit-plane coder (T.800 Annex D).

Lane-parallel formulation across codeblocks: every pass scans the padded
[Hmax, Wmax] geometry once, and all per-position decisions happen as masked
vector ops over the N-block lane dimension, feeding the batched MQ coder.
This is the lane-parallel reformulation of the reference's per-block scalar
coder (t1/t1_part1/T1.cpp compress_cblk/decompress passes); the scan is
sequential (as the standard requires) but the block batch rides the lanes.

Blocks of different sizes and bit depths coexist in a batch: out-of-block
positions are masked, and a lane only participates in plane p's passes when
p is inside its own coded-plane range, which reproduces the standard
"first plane has only a cleanup pass" structure per lane.

Key speed levers (mirrors of the reference's schedulers, not its code):
  - column skipping in SPP/MRP when no lane can code anything there,
  - the run-length (aggregation) fast path in CUP.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mq_np import (
    CTX_MR0,
    CTX_RL,
    CTX_UNI,
    MQDecoder,
    MQEncoder,
)

SUPPORTED_STYLES = 0x3F  # all Part-1 codeblock style bits (native parity)

# ------------------------------------------------------------- context LUTs
# Zero-coding contexts (T.800 Table D-1), indexed [orient][h*15 + v*5 + d]
# with h, v in 0..2 and d in 0..4. Orients: 0 LL, 1 HL, 2 LH, 3 HH.


def _build_zc_luts() -> np.ndarray:
    lut = np.zeros((4, 45), dtype=np.uint8)

    def normal(h, v, d):
        if h == 2:
            return 8
        if h == 1:
            if v >= 1:
                return 7
            return 6 if d >= 1 else 5
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)

    def hh(h, v, d):
        a = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if a >= 1 else 6
        if d == 1:
            return 5 if a >= 2 else (4 if a == 1 else 3)
        return 2 if a >= 2 else (1 if a == 1 else 0)

    for h in range(3):
        for v in range(3):
            for d in range(5):
                i = h * 15 + v * 5 + d
                lut[0, i] = normal(h, v, d)  # LL
                lut[2, i] = normal(h, v, d)  # LH
                lut[1, i] = normal(v, h, d)  # HL: transpose roles
                lut[3, i] = hh(h, v, d)  # HH
    return lut


_ZC_LUT = _build_zc_luts()

# Sign-coding contexts (T.800 Table D-3): index (hbar+1)*3 + (vbar+1).
_SC_CTX = np.zeros(9, dtype=np.uint8)
_SC_XOR = np.zeros(9, dtype=np.uint8)
for _hb in (-1, 0, 1):
    for _vb in (-1, 0, 1):
        _i = (_hb + 1) * 3 + (_vb + 1)
        if _hb == 0:
            _ctx, _x = (9, 0) if _vb == 0 else (10, 0 if _vb > 0 else 1)
        elif _hb > 0:
            _ctx, _x = {1: (13, 0), 0: (12, 0), -1: (11, 0)}[_vb]
        else:
            _ctx, _x = {1: (11, 1), 0: (12, 1), -1: (13, 1)}[_vb]
        _SC_CTX[_i] = _ctx
        _SC_XOR[_i] = _x


@dataclass
class T1EncodeResult:
    data: np.ndarray  # [N, max_bytes] uint8 codeword segment per lane
    lengths: np.ndarray  # [N] total segment bytes
    numbps: np.ndarray  # [N] coded magnitude bit planes per lane
    npasses: np.ndarray  # [N] number of coding passes (3*numbps - 2, or 0)
    pass_rates: np.ndarray  # [N, max_passes] cumulative byte bound per pass
    pass_dist: np.ndarray  # [N, max_passes] distortion reduction per pass
    # optional zero-copy view for the native T2 codec: (contiguous base
    # buffer [N, stride], column offset of byte 0 of each segment)
    raw_data: tuple | None = None


class _State:
    """Shared scan state for one batch (padded by 1 on every side)."""

    def __init__(self, mag, sgn, heights, widths, orients, styles=None):
        self.n, self.h, self.w = mag.shape
        n, h, w = self.n, self.h, self.w
        self.mag = np.zeros((n, h + 2, w + 2), dtype=np.int64)
        self.mag[:, 1 : h + 1, 1 : w + 1] = mag
        self.sgn = np.zeros((n, h + 2, w + 2), dtype=np.int8)
        self.sgn[:, 1 : h + 1, 1 : w + 1] = sgn
        self.sig = np.zeros((n, h + 2, w + 2), dtype=bool)
        self.visited = np.zeros((n, h + 2, w + 2), dtype=bool)
        self.refined = np.zeros((n, h + 2, w + 2), dtype=bool)
        self.heights = heights
        self.widths = widths
        self.orients = orients.astype(np.int64)
        self.lanes = np.arange(n)
        st = np.zeros(n, dtype=np.int64) if styles is None else np.asarray(styles)
        self.vsc = (st & 0x08) != 0
        self.reset = (st & 0x02) != 0
        self.segsym = (st & 0x20) != 0

    def _below_mask(self, y):
        """VSC: rows at a stripe bottom see no significance below (per lane)."""
        if ((y - 1) & 3) != 3:
            return None
        return self.vsc

    def zc_ctx(self, y, x):
        """(ctx, neighbor-count) at padded coords (y, x) = block pos +1."""
        s = self.sig
        cut = self._below_mask(y)
        below = lambda xx: (
            s[:, y + 1, xx].astype(np.int64)
            if cut is None
            else np.where(cut, 0, s[:, y + 1, xx])
        )
        hcnt = s[:, y, x - 1].astype(np.int64) + s[:, y, x + 1]
        vcnt = s[:, y - 1, x].astype(np.int64) + below(x)
        dcnt = (
            s[:, y - 1, x - 1].astype(np.int64)
            + s[:, y - 1, x + 1]
            + below(x - 1)
            + below(x + 1)
        )
        idx = hcnt * 15 + vcnt * 5 + dcnt
        ctx = _ZC_LUT[self.orients, idx]
        return ctx.astype(np.int64), hcnt + vcnt + dcnt

    def sc_ctx(self, y, x):
        """Sign-coding context + xor bit at padded coords."""
        s = self.sig
        g = self.sgn
        contrib = lambda yy, xx: s[:, yy, xx] * (1 - 2 * g[:, yy, xx].astype(np.int64))
        cut = self._below_mask(y)
        below = contrib(y + 1, x)
        if cut is not None:
            below = np.where(cut, 0, below)
        hbar = np.clip(contrib(y, x - 1) + contrib(y, x + 1), -1, 1)
        vbar = np.clip(contrib(y - 1, x) + below, -1, 1)
        idx = (hbar + 1) * 3 + (vbar + 1)
        return _SC_CTX[idx].astype(np.int64), _SC_XOR[idx].astype(np.int64)

    def in_block(self, y, x):
        """Block-coords (y-1, x-1) inside each lane's actual extent."""
        return ((y - 1) < self.heights) & ((x - 1) < self.widths)


def _lane_numbps(mag, heights, widths) -> np.ndarray:
    n, h, w = mag.shape
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    inb = (ys < heights[:, None, None]) & (xs < widths[:, None, None])
    mx = np.where(inb, mag, 0).reshape(n, -1).max(axis=1)
    out = np.zeros(n, dtype=np.int64)
    nz = mx > 0
    out[nz] = np.floor(np.log2(mx[nz])).astype(np.int64) + 1
    return out


def _local_pass_index(plane, kind, numbps):
    """Lane-local pass index for (plane, kind) given lane's numbps.

    kind: 0 SPP, 1 MRP, 2 CUP. First (MSB) plane has only CUP (pass 0)."""
    rel = numbps - 1 - plane  # 0 for MSB plane
    return np.where(rel <= 0, 0, (rel - 1) * 3 + 1 + kind)


def _pass_is_raw(styles_bypass, lpi, kind):
    """Bypass lanes code SPP/MRP raw from the 11th pass on (T.800 D.4)."""
    return styles_bypass & (lpi >= 10) & (kind != 2)


def _term_after(styles_termall, styles_bypass, lpi, kind):
    """Per-lane 'this pass ends a codeword segment' predicate."""
    t = np.where(lpi == 0, 2, (lpi - 1) % 3)
    bypass_bound = styles_bypass & (
        (lpi == 9) | ((lpi > 9) & ((t == 1) | (t == 2)))
    )
    return styles_termall | bypass_bound


# Distortion-decrease helpers (squared error in coefficient units of 2^{2p};
# caller scales by step^2 * bandnorm^2). Mirrors native/t1_coder.cpp dd_sig/dd_ref.
def _dd_sig(v, plane):
    # v^2 - (v - 1.5*2^p)^2 = 3*2^p*v - 2.25*4^p, same fp64 op order as the
    # native coder (constants exact in fp64)
    c1 = float(3.0 * 2.0**plane)
    c2 = float(2.25 * 4.0**plane)
    return c1 * v.astype(np.float64) - c2


def _dd_ref(v, plane):
    # (v - rb)^2 - (v - ra)^2 with a1 = (v mod 2^{p+1}) - 2^p and
    # a2 = (v mod 2^p) - 2^{p-1}; masks avoid the shift chains
    m1 = (np.int64(2) << plane) - 1
    m2 = (np.int64(1) << plane) - 1
    a1 = (v & m1).astype(np.float64) - float(2.0**plane)
    a2 = (v & m2).astype(np.float64) - float(2.0 ** (plane - 1))
    return a1 * a1 - a2 * a2


# ================================================================== encoder
def encode_cblks(
    coeffs: np.ndarray,
    heights: np.ndarray,
    widths: np.ndarray,
    orients: np.ndarray,
    max_bitplanes: int | None = None,
    styles: np.ndarray | None = None,
    want_dist: bool = True,  # accepted for API parity; always computed here
    cxd_capture: list | None = None,  # t1/debug.py CxD stream sink
) -> T1EncodeResult:
    """Encode a batch of codeblocks.

    coeffs: [N, H, W] int32/int64 quantized coefficients (signed).
    heights/widths: [N] actual extents; orients: [N] band orientation codes.
    """
    coeffs = coeffs.astype(np.int64)
    n, h, w = coeffs.shape
    mag = np.abs(coeffs)
    sgn = (coeffs < 0).astype(np.int8)

    numbps = _lane_numbps(mag, heights, widths)
    if max_bitplanes is not None:
        assert numbps.max(initial=0) <= max_bitplanes
    pmax = int(numbps.max(initial=0))
    npasses = np.maximum(numbps * 3 - 2, 0)
    max_passes = int(npasses.max(initial=0))

    st = _State(mag, sgn, heights, widths, orients, styles)
    max_bytes = max(64, (pmax * h * w) // 4 + 128)
    mq = MQEncoder(n, max_bytes)
    mq.cxd_capture = cxd_capture

    pass_rates = np.zeros((n, max(max_passes, 1)), dtype=np.int64)
    pass_dist = np.zeros((n, max(max_passes, 1)), dtype=np.float64)

    sty = np.zeros(n, dtype=np.int64) if styles is None else np.asarray(styles)
    termall_m = (sty & 0x04) != 0
    bypass_m = (sty & 0x01) != 0
    last_term = np.zeros(n, dtype=bool)

    def end_pass(plane, kind, lane_mask, dd):
        """Record rate/distortion, terminate segments, start raw mode —
        the lane-parallel mirror of the native coder's end_pass."""
        if not lane_mask.any():
            return
        lpi = _local_pass_index(plane, kind, numbps)
        raw_m = _pass_is_raw(bypass_m, lpi, kind) & lane_mask
        term_m = _term_after(termall_m, bypass_m, lpi, kind) & lane_mask
        r = mq.pos + (27 - mq.ct + 7) // 8  # Taubman safe bound
        if hasattr(mq, "raw_used"):
            r = np.where(raw_m, mq.raw_safe_len(), r)
        t_mq = term_m & ~raw_m
        t_raw = term_m & raw_m
        if t_mq.any():
            r = np.where(t_mq, mq.terminate_restart(t_mq), r)
        if t_raw.any():
            r = np.where(t_raw, mq.raw_terminate_restart_mq(t_raw), r)
        pass_rates[lane_mask, lpi[lane_mask]] = r[lane_mask]
        pass_dist[lane_mask, lpi[lane_mask]] = dd[lane_mask]
        last_term[lane_mask] = term_m[lane_mask]
        mq.reset_ctx(st.reset & lane_mask)
        # lanes whose NEXT pass is raw start a fresh raw segment
        nxt_raw = _pass_is_raw(bypass_m, lpi + 1, (kind + 1) % 3) & term_m
        if nxt_raw.any():
            mq.raw_start(nxt_raw)

    def pass_raw_mask(plane, kind, lane_mask):
        lpi = _local_pass_index(plane, kind, numbps)
        return _pass_is_raw(bypass_m, lpi, kind) & lane_mask

    for plane in range(pmax - 1, -1, -1):
        spp_lanes = numbps - 1 > plane  # lanes whose first plane was earlier
        cup_lanes = numbps - 1 >= plane
        if spp_lanes.any():
            dd = np.zeros(n, dtype=np.float64)
            _spp(st, mq, plane, spp_lanes, None, dist=dd,
                 raw=pass_raw_mask(plane, 0, spp_lanes))
            end_pass(plane, 0, spp_lanes, dd)
            dd = np.zeros(n, dtype=np.float64)
            _mrp(st, mq, plane, spp_lanes, None, dist=dd,
                 raw=pass_raw_mask(plane, 1, spp_lanes))
            end_pass(plane, 1, spp_lanes, dd)
        dd = np.zeros(n, dtype=np.float64)
        _cup(st, mq, plane, cup_lanes, None, dist=dd)
        end_pass(plane, 2, cup_lanes, dd)
        st.visited[:] = False

    # final termination per lane: already-terminated lanes keep their last
    # recorded rate; raw-tail lanes byte-align; the rest FLUSH
    final_lpi = np.maximum(npasses - 1, 0)
    in_raw_tail = _pass_is_raw(bypass_m, final_lpi, np.where(
        final_lpi == 0, 2, (final_lpi - 1) % 3)) & ~last_term
    lengths = np.zeros(n, dtype=np.int64)
    if last_term.any():
        lengths = np.where(
            last_term, pass_rates[st.lanes, final_lpi], lengths
        )
    if in_raw_tail.any():
        lengths = np.where(
            in_raw_tail, mq.raw_terminate_restart_mq(in_raw_tail), lengths
        )
    rest = ~last_term & ~in_raw_tail
    if rest.any():
        mq.flush(rest)
        lengths = np.where(rest, mq.lengths(), lengths)
    lengths = np.where(npasses > 0, lengths, 0)
    # clamp conservative per-pass rates to the final length
    if max_passes:
        pass_rates[st.lanes, final_lpi] = lengths
        np.minimum(pass_rates, lengths[:, None], out=pass_rates)
    return T1EncodeResult(
        data=mq.buf[:, 1:],
        raw_data=(mq.buf, 1),
        lengths=lengths,
        numbps=numbps,
        npasses=npasses,
        pass_rates=pass_rates,
        pass_dist=pass_dist,
    )


# ================================================================== decoder
def decode_cblks(
    data: np.ndarray,
    lengths: np.ndarray,
    numbps: np.ndarray,
    npasses: np.ndarray,
    heights: np.ndarray,
    widths: np.ndarray,
    orients: np.ndarray,
    block_h: int,
    block_w: int,
    styles: np.ndarray | None = None,
    seg_lengths: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of codeblock codeword segments.

    Returns (coeffs [N, H, W] int64 signed, planes_decoded [N])."""
    n = data.shape[0]
    h, w = block_h, block_w
    numbps = numbps.astype(np.int64)
    pmax = int(numbps.max(initial=0))

    st = _State(
        np.zeros((n, h, w), dtype=np.int64),
        np.zeros((n, h, w), dtype=np.int8),
        heights,
        widths,
        orients.astype(np.int64),
        styles,
    )
    sty = np.zeros(n, dtype=np.int64) if styles is None else np.asarray(styles)
    termall_m = (sty & 0x04) != 0
    bypass_m = (sty & 0x01) != 0
    segmented = (termall_m | bypass_m) & (seg_lengths is not None)
    if seg_lengths is not None:
        segl = np.asarray(seg_lengths, dtype=np.int64)
    else:
        segl = np.zeros((n, 1), dtype=np.int64)
    first_len = np.where(segmented, segl[:, 0], np.asarray(lengths, dtype=np.int64))
    mq = MQDecoder(data, first_len)
    seg_i = np.zeros(n, dtype=np.int64)
    seg_off = np.zeros(n, dtype=np.int64)

    def next_seg(finished_lpi, lane_mask):
        """Advance segmented lanes whose pass ended a segment (native
        next_seg): re-prime MQ or start a raw segment at the new offset."""
        adv = lane_mask & segmented & _term_after(
            termall_m, bypass_m, finished_lpi,
            np.where(finished_lpi == 0, 2, (finished_lpi - 1) % 3),
        ) & (finished_lpi + 1 < npasses)
        if not adv.any():
            return
        cur = segl[st.lanes, np.minimum(seg_i, segl.shape[1] - 1)]
        seg_off[adv] += cur[adv]
        seg_i[adv] += 1
        nxt = np.where(
            seg_i < segl.shape[1],
            segl[st.lanes, np.minimum(seg_i, segl.shape[1] - 1)], 0
        )
        nlpi = finished_lpi + 1
        nraw = _pass_is_raw(bypass_m, nlpi,
                            np.where(nlpi == 0, 2, (nlpi - 1) % 3))
        mq.raw_init(adv & nraw, seg_off, nxt)
        mq.init_registers(adv & ~nraw, seg_off, nxt)

    def raw_of(plane, kind, lanes_m):
        lpi = _local_pass_index(np.int64(plane), kind, numbps)
        return _pass_is_raw(bypass_m, lpi, kind) & lanes_m

    for plane in range(pmax - 1, -1, -1):
        lp_spp = _local_pass_index(np.int64(plane), 0, numbps)
        lp_mrp = _local_pass_index(np.int64(plane), 1, numbps)
        lp_cup = _local_pass_index(np.int64(plane), 2, numbps)
        spp_lanes = (numbps - 1 > plane) & (lp_spp < npasses)
        mrp_lanes = (numbps - 1 > plane) & (lp_mrp < npasses)
        cup_lanes = (numbps - 1 >= plane) & (lp_cup < npasses)
        first_cup = (numbps - 1 == plane) & (0 < npasses)
        cup_lanes = cup_lanes | first_cup
        if spp_lanes.any():
            _spp(st, None, plane, spp_lanes, mq,
                 raw=raw_of(plane, 0, spp_lanes))
            mq.reset_ctx(st.reset & spp_lanes)
            next_seg(lp_spp, spp_lanes)
        if mrp_lanes.any():
            _mrp(st, None, plane, mrp_lanes, mq,
                 raw=raw_of(plane, 1, mrp_lanes))
            mq.reset_ctx(st.reset & mrp_lanes)
            next_seg(lp_mrp, mrp_lanes)
        if cup_lanes.any():
            _cup(st, None, plane, cup_lanes, mq)
            mq.reset_ctx(st.reset & cup_lanes)
            next_seg(lp_cup, cup_lanes)
        st.visited[:] = False

    # ROI downshift (style bits 8-15) applies in the SCALED domain before
    # the halving (reference RoiShiftFilter order)
    m2 = st.mag[:, 1 : h + 1, 1 : w + 1]
    rs = ((np.asarray(styles) >> 8) & 0xFF)[:, None, None] \
        if styles is not None else np.zeros((m2.shape[0], 1, 1), np.int64)
    if (rs > 0).any():
        m2 = np.where((rs > 0) & (m2 >= (1 << rs)), m2 >> rs, m2)
    coeffs = m2 >> 1  # drop the 1/2 bit
    signs = st.sgn[:, 1 : h + 1, 1 : w + 1]
    coeffs = coeffs.copy()
    coeffs[signs == 1] *= -1
    planes_decoded = np.minimum((npasses + 2) // 3, numbps)
    return coeffs, planes_decoded


# ============================================================ the 3 passes
def _spp(st: _State, enc: MQEncoder | None, plane: int, lanes: np.ndarray, dec, dist=None, raw=None):
    """Significance propagation pass."""
    n, h, w = st.n, st.h, st.w
    sig = st.sig
    nstripes = (h + 3) // 4
    for s in range(nstripes):
        y0 = 4 * s
        rows = min(4, h - y0)
        # static column activity: any significant sample in the 3-wide
        # neighborhood window of this stripe, any lane
        win = sig[:, y0 : y0 + rows + 2, :]
        colact = win.any(axis=(0, 1))
        act = colact[:-2] | colact[1:-1] | colact[2:]  # columns 0..w-1
        force_next = False
        for x in range(w):
            if not (act[x] or force_next):
                force_next = False
                continue
            force_next = False
            px = x + 1
            for k in range(rows):
                py = y0 + k + 1
                inb = st.in_block(py, px) & lanes
                ctx, ncnt = st.zc_ctx(py, px)
                code = inb & ~sig[:, py, px] & (ncnt > 0)
                if not code.any():
                    continue
                rawm = raw if raw is not None else np.zeros(st.n, dtype=bool)
                if enc is not None:
                    bit = ((st.mag[:, py, px] >> plane) & 1).astype(np.uint8)
                    enc.encode(bit, ctx, code & ~rawm)
                    enc.raw_bit(bit, code & rawm)
                else:
                    bit = dec.decode(ctx, code & ~rawm)
                    if rawm.any():
                        rb = dec.raw_bit(code & rawm)
                        bit = np.where(code & rawm, rb, bit)
                st.visited[:, py, px] |= code
                became = code & (bit == 1)
                if became.any():
                    sc, xr = st.sc_ctx(py, px)
                    if enc is not None:
                        sbit = (st.sgn[:, py, px].astype(np.int64) ^ xr).astype(np.uint8)
                        enc.encode(sbit, sc, became & ~rawm)
                        # raw sign bits are NOT xored with the predictor
                        enc.raw_bit(st.sgn[:, py, px].astype(np.uint8),
                                    became & rawm)
                    else:
                        sbit = dec.decode(sc, became & ~rawm)
                        if rawm.any():
                            rs = dec.raw_bit(became & rawm)
                            # undo the xor for raw lanes (applied below)
                            sbit = np.where(became & rawm,
                                            rs ^ xr.astype(np.uint8), sbit)
                        st.sgn[:, py, px] = np.where(
                            became, (sbit ^ xr).astype(np.int8), st.sgn[:, py, px]
                        )
                        # scaled-by-2 mid-bin reconstruction (1.5 * 2^plane)
                        st.mag[:, py, px] = np.where(
                            became, np.int64(3) << plane, st.mag[:, py, px]
                        )
                    if dist is not None:
                        dist += np.where(became, _dd_sig(st.mag[:, py, px], plane), 0.0)
                    sig[:, py, px] |= became
                    force_next = True


def _mrp(st: _State, enc: MQEncoder | None, plane: int, lanes: np.ndarray, dec, dist=None, raw=None):
    """Magnitude refinement pass."""
    n, h, w = st.n, st.h, st.w
    sig = st.sig
    nstripes = (h + 3) // 4
    for s in range(nstripes):
        y0 = 4 * s
        rows = min(4, h - y0)
        # refinement candidates are static within the pass
        cand = sig[:, y0 + 1 : y0 + 1 + rows, 1 : w + 1] & ~st.visited[
            :, y0 + 1 : y0 + 1 + rows, 1 : w + 1
        ]
        colact = cand.any(axis=(0, 1))
        for x in range(w):
            if not colact[x]:
                continue
            px = x + 1
            for k in range(rows):
                py = y0 + k + 1
                inb = st.in_block(py, px) & lanes
                code = inb & sig[:, py, px] & ~st.visited[:, py, px]
                if not code.any():
                    continue
                _, ncnt = st.zc_ctx(py, px)
                ctx = np.where(
                    st.refined[:, py, px],
                    CTX_MR0 + 2,
                    np.where(ncnt > 0, CTX_MR0 + 1, CTX_MR0),
                ).astype(np.int64)
                rawm = raw if raw is not None else np.zeros(st.n, dtype=bool)
                if enc is not None:
                    bit = ((st.mag[:, py, px] >> plane) & 1).astype(np.uint8)
                    enc.encode(bit, ctx, code & ~rawm)
                    enc.raw_bit(bit, code & rawm)
                else:
                    bit = dec.decode(ctx, code & ~rawm)
                    if rawm.any():
                        rb = dec.raw_bit(code & rawm)
                        bit = np.where(code & rawm, rb, bit)
                    st.mag[:, py, px] = np.where(
                        code,
                        st.mag[:, py, px]
                        + np.where(bit == 1, np.int64(1) << plane,
                                   -(np.int64(1) << plane)),
                        st.mag[:, py, px],
                    )
                if dist is not None:
                    dist += np.where(code, _dd_ref(st.mag[:, py, px], plane), 0.0)
                st.refined[:, py, px] |= code


def _cup(st: _State, enc: MQEncoder | None, plane: int, lanes: np.ndarray, dec, dist=None):
    """Cleanup pass with run-length aggregation."""
    n, h, w = st.n, st.h, st.w
    sig = st.sig
    nstripes = (h + 3) // 4
    rl_ctx = np.full(n, CTX_RL, dtype=np.int64)
    uni_ctx = np.full(n, CTX_UNI, dtype=np.int64)
    for s in range(nstripes):
        y0 = 4 * s
        rows = min(4, h - y0)
        full_stripe = (y0 + 4) <= np.minimum(st.heights, h)
        for x in range(w):
            px = x + 1
            # run-length eligibility: full 4-row column, in-block, all four
            # positions insignificant with empty neighborhoods
            col_ok = full_stripe & (x < st.widths) & lanes
            if rows == 4:
                rl_eligible = col_ok.copy()
                for k in range(4):
                    py = y0 + k + 1
                    _, ncnt = st.zc_ctx(py, px)
                    rl_eligible &= (~sig[:, py, px]) & (ncnt == 0) & ~st.visited[:, py, px]
            else:
                rl_eligible = np.zeros(n, dtype=bool)

            first_k = np.full(n, 4, dtype=np.int64)
            rl_bit = np.zeros(n, dtype=np.uint8)
            if rl_eligible.any():
                if enc is not None:
                    for k in range(3, -1, -1):
                        py = y0 + k + 1
                        b = ((st.mag[:, py, px] >> plane) & 1) == 1
                        first_k = np.where(rl_eligible & b, k, first_k)
                    rl_bit = np.where(rl_eligible & (first_k < 4), 1, 0).astype(np.uint8)
                    enc.encode(rl_bit, rl_ctx, rl_eligible)
                    sigcol = rl_eligible & (rl_bit == 1)
                    if sigcol.any():
                        enc.encode(((first_k >> 1) & 1).astype(np.uint8), uni_ctx, sigcol)
                        enc.encode((first_k & 1).astype(np.uint8), uni_ctx, sigcol)
                else:
                    rl_bit = dec.decode(rl_ctx, rl_eligible)
                    sigcol = rl_eligible & (rl_bit == 1)
                    if sigcol.any():
                        b1 = dec.decode(uni_ctx, sigcol)
                        b0 = dec.decode(uni_ctx, sigcol)
                        fk = (b1.astype(np.int64) << 1) | b0
                        first_k = np.where(sigcol, fk, first_k)
                    first_k = np.where(rl_eligible & (rl_bit == 0), 4, first_k)
                if enc is not None:
                    first_k = np.where(rl_eligible & (rl_bit == 0), 4, first_k)

            skip_rl0 = rl_eligible & (rl_bit == 0)
            # fast path: every lane either skips via RL, is outside its
            # block extent at this column, or isn't in this pass at all
            no_work = skip_rl0 | ~lanes | (x >= st.widths) | (y0 >= st.heights)
            if no_work.all():
                continue

            for k in range(rows):
                py = y0 + k + 1
                inb = st.in_block(py, px) & lanes
                base = inb & ~sig[:, py, px] & ~st.visited[:, py, px] & ~skip_rl0
                # positions before the first significant one in an RL column
                # are implied zero; the first one skips ZC (significance known)
                pre_run = rl_eligible & (rl_bit == 1) & (k < first_k)
                implied = rl_eligible & (rl_bit == 1) & (k == first_k)
                zc_code = base & ~pre_run & ~implied
                bit = np.zeros(n, dtype=np.uint8)
                if zc_code.any():
                    ctx, _ = st.zc_ctx(py, px)
                    if enc is not None:
                        bit = ((st.mag[:, py, px] >> plane) & 1).astype(np.uint8)
                        enc.encode(bit, ctx, zc_code)
                    else:
                        bit = dec.decode(ctx, zc_code)
                became = (zc_code & (bit == 1)) | implied
                if became.any():
                    sc, xr = st.sc_ctx(py, px)
                    if enc is not None:
                        sbit = (st.sgn[:, py, px].astype(np.int64) ^ xr).astype(np.uint8)
                        enc.encode(sbit, sc, became)
                    else:
                        sbit = dec.decode(sc, became)
                        st.sgn[:, py, px] = np.where(
                            became, (sbit ^ xr).astype(np.int8), st.sgn[:, py, px]
                        )
                        st.mag[:, py, px] = np.where(
                            became, np.int64(3) << plane, st.mag[:, py, px]
                        )
                    if dist is not None:
                        dist += np.where(became, _dd_sig(st.mag[:, py, px], plane), 0.0)
                    sig[:, py, px] |= became

    # segmentation symbol (SEGSYM style): 1010 in the UNIFORM context at the
    # end of every cleanup pass
    seg = st.segsym & lanes
    if seg.any():
        for b in (1, 0, 1, 0):
            bits = np.full(n, b, dtype=np.uint8)
            if enc is not None:
                enc.encode(bits, uni_ctx, seg)
            else:
                dec.decode(uni_ctx, seg)
