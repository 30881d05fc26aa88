"""2-D multi-level lifting DWT (5/3 reversible, 9/7 irreversible).

Array formulation of the wavelet stage (parity targets:
transform/WaveletFwd.cpp:618 and transform/WaveletReverse.cpp:2232):

* Each 1-D lifting step gathers only the +-1 opposite-phase neighbors, and
  whole-sample symmetric extension is exactly "clamp to the nearest valid
  opposite-phase sample" — so every step is a shifted-slice + elementwise op
  that XLA fuses; no gather/scatter, no halo special cases.
* The split/lift/concat per axis emits the deinterleaved (Mallat-packed)
  layout directly — the analogue of the reference's fused
  encode_and_deinterleave kernels, expressed functionally.
* Works with numpy or jax.numpy as the array module (``xp``); int32 shifts
  are arithmetic in both, so the 5/3 path is bit-exact between backends.

Canvas-parity ("cas") handling: low-pass samples always live at even canvas
coordinates, so a sub-rect starting at an odd coordinate begins with a
high-pass sample. ``parity`` below is (x0 & 1) / (y0 & 1) of the current
level's sub-rect.
"""

from __future__ import annotations

import numpy as np

from ..core.rect import Rect

# 9/7 lifting constants (T.800 F.4.8.2)
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _split(x, axis: int, parity: int):
    """Split into (low-phase, high-phase) samples along axis.

    parity 0: lows at 0::2, highs at 1::2; parity 1: lows at 1::2."""
    nd = x.ndim
    s_sl = [slice(None)] * nd
    d_sl = [slice(None)] * nd
    s_sl[axis] = slice(parity, None, 2)
    d_sl[axis] = slice(1 - parity, None, 2)
    return x[tuple(s_sl)], x[tuple(d_sl)]


def _trim(a, axis, n):
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, n)
    return a[tuple(sl)]


def _take1(a, axis, s):
    sl = [slice(None)] * a.ndim
    sl[axis] = s
    return a[tuple(sl)]


def _prev_clamped(xp, a, axis, n):
    """a[max(i-1, 0)] for i in range(n); requires n <= len(a) + 1."""
    return _trim(xp.concatenate([_take1(a, axis, slice(0, 1)), a], axis=axis), axis, n)


def _next_clamped(xp, a, axis, n):
    """a[min(i+1, len-1)] for i in range(n); requires n <= len(a)."""
    return _trim(
        xp.concatenate(
            [_take1(a, axis, slice(1, None)), _take1(a, axis, slice(-1, None))],
            axis=axis,
        ),
        axis,
        n,
    )


def _cur_clamped(xp, a, axis, n):
    """a[min(i, len-1)] for i in range(n); requires n <= len(a) + 1."""
    cur = a.shape[axis]
    if cur >= n:
        return _trim(a, axis, n)
    return xp.concatenate([a, _take1(a, axis, slice(-1, None))], axis=axis)


def _neighbors_of_d(xp, s, axis, parity, dn, sn):
    """(left, right) low-phase neighbors for each high-phase sample, with
    whole-sample symmetric extension == clamp to nearest valid low sample."""
    if parity == 0:
        # d[j] at abs 2j+1: neighbors s[j], s[j+1] (clamped at the end)
        return _trim(s, axis, dn), _next_clamped(xp, s, axis, dn)
    # d[j] at abs 2j: neighbors s[j-1] (clamped at start), s[j] (clamped at end)
    return _prev_clamped(xp, s, axis, dn), _cur_clamped(xp, s, axis, dn)


def _neighbors_of_s(xp, d, axis, parity, dn, sn):
    """(left, right) high-phase neighbors for each low-phase sample."""
    if parity == 0:
        # s[i] at abs 2i: neighbors d[i-1] (clamp start), d[i] (clamp end)
        return _prev_clamped(xp, d, axis, sn), _cur_clamped(xp, d, axis, sn)
    # s[i] at abs 2i+1: neighbors d[i], d[i+1] (clamp end)
    return _trim(d, axis, sn), _next_clamped(xp, d, axis, sn)


def _phase_counts(n: int, parity: int) -> tuple[int, int]:
    """(#low, #high) samples for a length-n run starting at given parity."""
    if parity == 0:
        return (n + 1) // 2, n // 2
    return n // 2, (n + 1) // 2


# ------------------------------------------------------------------ 5/3
def fwd53_axis(xp, x, axis: int, parity: int):
    """One forward 5/3 pass along axis; returns Mallat-packed [s | d]."""
    n = x.shape[axis]
    if n == 0:
        return x
    sn, dn = _phase_counts(n, parity)
    if n == 1:
        return x * 2 if parity == 1 else x
    s, d = _split(x, axis, parity)
    sl, sr = _neighbors_of_d(xp, s, axis, parity, dn, sn)
    d = d - ((sl + sr) >> 1)
    dl, dr = _neighbors_of_s(xp, d, axis, parity, dn, sn)
    s = s + ((dl + dr + 2) >> 2)
    return xp.concatenate([s, d], axis=axis)


def inv53_axis(xp, y, axis: int, parity: int, out_dtype=None):
    """One inverse 5/3 pass along axis; input Mallat-packed, output interleaved."""
    n = y.shape[axis]
    if n == 0:
        return y
    sn, dn = _phase_counts(n, parity)
    if n == 1:
        return y >> 1 if parity == 1 else y
    s = _trim(y, axis, sn)
    sl2 = [slice(None)] * y.ndim
    sl2[axis] = slice(sn, None)
    d = y[tuple(sl2)]
    dl, dr = _neighbors_of_s(xp, d, axis, parity, dn, sn)
    s = s - ((dl + dr + 2) >> 2)
    sl_, sr_ = _neighbors_of_d(xp, s, axis, parity, dn, sn)
    d = d + ((sl_ + sr_) >> 1)
    return _interleave(xp, s, d, axis, parity)


# ------------------------------------------------------------------ 9/7
def fwd97_axis(xp, x, axis: int, parity: int):
    n = x.shape[axis]
    if n == 0:
        return x
    sn, dn = _phase_counts(n, parity)
    if n == 1:
        # Single-sample signal: T.800 leaves it unscaled for parity 0; the
        # parity-1 (lone high-pass) convention is validated against the
        # reference in the lossy test suite.
        return x
    s, d = _split(x, axis, parity)
    sl, sr = _neighbors_of_d(xp, s, axis, parity, dn, sn)
    d = d + ALPHA * (sl + sr)
    dl, dr = _neighbors_of_s(xp, d, axis, parity, dn, sn)
    s = s + BETA * (dl + dr)
    sl, sr = _neighbors_of_d(xp, s, axis, parity, dn, sn)
    d = d + GAMMA * (sl + sr)
    dl, dr = _neighbors_of_s(xp, d, axis, parity, dn, sn)
    s = s + DELTA * (dl + dr)
    s = s * (1.0 / K)
    d = d * K
    return xp.concatenate([s, d], axis=axis)


def inv97_axis(xp, y, axis: int, parity: int):
    n = y.shape[axis]
    if n == 0:
        return y
    sn, dn = _phase_counts(n, parity)
    if n == 1:
        return y
    s = _trim(y, axis, sn)
    sl2 = [slice(None)] * y.ndim
    sl2[axis] = slice(sn, None)
    d = y[tuple(sl2)]
    s = s * K
    d = d * (1.0 / K)
    dl, dr = _neighbors_of_s(xp, d, axis, parity, dn, sn)
    s = s - DELTA * (dl + dr)
    sl_, sr_ = _neighbors_of_d(xp, s, axis, parity, dn, sn)
    d = d - GAMMA * (sl_ + sr_)
    dl, dr = _neighbors_of_s(xp, d, axis, parity, dn, sn)
    s = s - BETA * (dl + dr)
    sl_, sr_ = _neighbors_of_d(xp, s, axis, parity, dn, sn)
    d = d - ALPHA * (sl_ + sr_)
    return _interleave(xp, s, d, axis, parity)


def _interleave(xp, s, d, axis: int, parity: int):
    """Merge phase arrays back to natural order along axis."""
    sn = s.shape[axis]
    dn = d.shape[axis]
    n = sn + dn
    shape = list(s.shape)
    shape[axis] = n
    if xp is np:
        if sn == dn:
            # preallocated pair-view writes (no stack temp)
            first, second = (s, d) if parity == 0 else (d, s)
            out = np.empty(shape, dtype=s.dtype)
            ax = axis if axis >= 0 else out.ndim + axis
            vshape = shape[:ax] + [sn, 2] + shape[ax + 1 :]
            v = out.reshape(vshape)
            sl0 = [slice(None)] * len(vshape)
            sl1 = [slice(None)] * len(vshape)
            sl0[ax + 1] = 0
            sl1[ax + 1] = 1
            v[tuple(sl0)] = first
            v[tuple(sl1)] = second
            return out
        out = np.empty(shape, dtype=s.dtype)
        sl_s = [slice(None)] * len(shape)
        sl_d = [slice(None)] * len(shape)
        if parity == 0:
            sl_s[axis] = slice(0, None, 2)
            sl_d[axis] = slice(1, None, 2)
        else:
            sl_s[axis] = slice(1, None, 2)
            sl_d[axis] = slice(0, None, 2)
        out[tuple(sl_s)] = s
        out[tuple(sl_d)] = d
        return out
    out = xp.zeros(shape, dtype=s.dtype)
    if parity == 0:
        out = out.at[_sl(len(shape), axis, slice(0, None, 2))].set(s)
        out = out.at[_sl(len(shape), axis, slice(1, None, 2))].set(d)
    else:
        out = out.at[_sl(len(shape), axis, slice(1, None, 2))].set(s)
        out = out.at[_sl(len(shape), axis, slice(0, None, 2))].set(d)
    return out


def _sl(ndim, axis, s):
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


# ------------------------------------------------------------ multi-level
def _native_ok(xp, arr):
    import os

    if xp is not np or arr.ndim != 2 or not arr.flags.c_contiguous:
        return False
    if os.environ.get("GROK_TPU_NATIVE_OPS", "1") == "0":
        return False
    from . import native_ops

    return native_ops.available()


def forward(xp, arr, rect: Rect, num_levels: int, irreversible: bool):
    """Full forward DWT of a tile-component array (shape = rect h x w).

    Returns the Mallat-packed array: resolution r's data occupies the
    top-left ceil(rect / 2^(NL-r)) region.
    """
    if _native_ok(xp, arr):
        from . import native_ops

        out = native_ops.dwt_forward(arr, rect, num_levels, irreversible)
        if out is not None:
            return out
    fwd = fwd97_axis if irreversible else fwd53_axis
    cur = rect
    for _ in range(num_levels):
        h, w = cur.height, cur.width
        if h == 0 or w == 0:
            break
        sub = arr[..., :h, :w]
        sub = fwd(xp, sub, arr.ndim - 2, cur.y0 & 1)  # vertical
        sub = fwd(xp, sub, arr.ndim - 1, cur.x0 & 1)  # horizontal
        arr = _paste(xp, arr, sub, h, w)
        cur = cur.ceil_div_pow2(1)
    return arr


def inverse(xp, arr, rect: Rect, num_levels: int, irreversible: bool):
    """Full inverse DWT; input Mallat-packed, output natural order."""
    if _native_ok(xp, arr):
        from . import native_ops

        out = native_ops.dwt_inverse(arr, rect, num_levels, irreversible)
        if out is not None:
            return out
    inv = inv97_axis if irreversible else inv53_axis
    rects = [rect]
    for _ in range(num_levels):
        rects.append(rects[-1].ceil_div_pow2(1))
    for lvl in range(num_levels, 0, -1):
        cur = rects[lvl - 1]
        h, w = cur.height, cur.width
        if h == 0 or w == 0:
            continue
        sub = arr[..., :h, :w]
        sub = inv(xp, sub, arr.ndim - 1, cur.x0 & 1)  # horizontal
        sub = inv(xp, sub, arr.ndim - 2, cur.y0 & 1)  # vertical
        arr = _paste(xp, arr, sub, h, w)
    return arr


def _paste(xp, arr, sub, h, w):
    if (h, w) == (arr.shape[-2], arr.shape[-1]):
        return sub
    if xp is np:
        # sub is freshly materialized (concatenate output), no aliasing
        arr[..., :h, :w] = sub
        return arr
    return arr.at[..., :h, :w].set(sub)


# --------------------------------------------------------- windowed inverse
def window_supports(rect: Rect, num_levels: int, irrev: bool, win: Rect):
    """Per-level support rects for reconstructing only ``win`` (level-0
    canvas coords): sups[l] is the level-l region needed, each level padded
    by the filter half-support (2 for 5/3, 4 for 9/7) before descending —
    the reference's FILTER_WIDTH halo scheme (WaveletReverse.cpp:1890)."""
    m = 4 if irrev else 2
    rects = [rect]
    for _ in range(num_levels):
        rects.append(rects[-1].ceil_div_pow2(1))
    sups = [win.intersect(rect)]
    for l in range(1, num_levels + 1):
        prev = sups[-1]
        s = Rect(
            prev.x0 // 2 - m, prev.y0 // 2 - m,
            (prev.x1 + 1) // 2 + m, (prev.y1 + 1) // 2 + m,
        ).intersect(rects[l])
        sups.append(s)
    return rects, sups


def _phase_ranges(sup: Rect):
    """(s-range, d-range) per axis for the interleaved region ``sup``."""
    ys = ((sup.y0 + 1) // 2, (sup.y1 + 1) // 2)
    yd = (sup.y0 // 2, sup.y1 // 2)
    xs = ((sup.x0 + 1) // 2, (sup.x1 + 1) // 2)
    xd = (sup.x0 // 2, sup.x1 // 2)
    return ys, yd, xs, xd


def inverse_window(xp, arr, rect: Rect, num_levels: int, irrev: bool,
                   win: Rect):
    """Windowed multi-level inverse DWT.

    arr: Mallat-packed array (as produced by forward); only the coefficients
    inside the per-level supports need to be valid — everything else may be
    zero/garbage (the margins absorb boundary-clamp error, so the returned
    region is exact). Returns (out, out_rect) with out_rect == sups[0] ⊇ win
    clamped to the tile; out has out_rect's shape, natural sample order."""
    inv = inv97_axis if irrev else inv53_axis
    rects, sups = window_supports(rect, num_levels, irrev, win)
    if sups[0].empty():
        return arr[:0, :0], sups[0]

    # the forward transform stops once a level becomes degenerate: only
    # levels whose SOURCE rect is non-empty were ever transformed
    start = num_levels
    while start > 0 and rects[start - 1].empty():
        start -= 1

    top = sups[start]
    r_top = rects[start]
    if r_top.empty() or top.empty():
        # no LL samples at the deepest level (all rows/cols are high-phase)
        cur = arr[..., :0, :0]
        cur_rect = Rect(0, 0, 0, 0)
    else:
        cur = arr[
            ...,
            top.y0 - r_top.y0 : top.y1 - r_top.y0,
            top.x0 - r_top.x0 : top.x1 - r_top.x0,
        ]
        cur = cur.copy() if xp is np else cur
        cur_rect = top
    for l in range(start, 0, -1):
        # reconstruct the FULL interleaved span of the available subband
        # data; its outer margin absorbs boundary-clamp error so the next
        # level's support region stays exact
        sup_l = sups[l]
        # span all interleaved samples derivable from the available data
        # (the -1 keeps a leading high-phase sample on odd boundaries)
        out_rect = Rect(
            2 * sup_l.x0 - 1, 2 * sup_l.y0 - 1, 2 * sup_l.x1, 2 * sup_l.y1
        ).intersect(rects[l - 1])
        if out_rect.empty():
            return arr[:0, :0], out_rect
        ys, yd, xs, xd = _phase_ranges(out_rect)
        sn_y, dn_y = ys[1] - ys[0], yd[1] - yd[0]
        sn_x, dn_x = xs[1] - xs[0], xd[1] - xd[0]
        r_prev = rects[l - 1]
        # packed sub-array [sy | dy] x [sx | dx]
        P = xp.zeros(
            (*arr.shape[:-2], sn_y + dn_y, sn_x + dn_x), dtype=arr.dtype
        )
        # LL from cur (level-l canvas coords)
        if sn_y > 0 and sn_x > 0:
            ll = cur[
                ...,
                ys[0] - cur_rect.y0 : ys[1] - cur_rect.y0,
                xs[0] - cur_rect.x0 : xs[1] - cur_rect.x0,
            ]
        else:
            ll = None
        # H bands from the packed array (Mallat offsets at level l-1's split)
        ph, pw = rects[l].height, rects[l].width  # previous-level extent
        ry0, rx0 = rects[l].y0, rects[l].x0  # s-phase band origin (canvas)
        by0, bx0 = r_prev.y0 // 2, r_prev.x0 // 2  # d-phase band origin
        hl = arr[
            ...,
            ys[0] - ry0 : ys[1] - ry0,
            pw + xd[0] - bx0 : pw + xd[1] - bx0,
        ]
        lh = arr[
            ...,
            ph + yd[0] - by0 : ph + yd[1] - by0,
            xs[0] - rx0 : xs[1] - rx0,
        ]
        hh = arr[
            ...,
            ph + yd[0] - by0 : ph + yd[1] - by0,
            pw + xd[0] - bx0 : pw + xd[1] - bx0,
        ]
        if xp is np:
            if ll is not None:
                P[..., :sn_y, :sn_x] = ll
            P[..., :sn_y, sn_x:] = hl
            P[..., sn_y:, :sn_x] = lh
            P[..., sn_y:, sn_x:] = hh
        else:
            if ll is not None:
                P = P.at[..., :sn_y, :sn_x].set(ll)
            P = P.at[..., :sn_y, sn_x:].set(hl)
            P = P.at[..., sn_y:, :sn_x].set(lh)
            P = P.at[..., sn_y:, sn_x:].set(hh)
        P = inv(xp, P, P.ndim - 1, out_rect.x0 & 1)
        P = inv(xp, P, P.ndim - 2, out_rect.y0 & 1)
        cur = P
        cur_rect = out_rect
    return cur, cur_rect


def window_band_needs(rect: Rect, num_levels: int, irrev: bool, win: Rect):
    """Needed band regions (band coords) per (resolution, orient) for a
    windowed decode; resolution 0 maps to the LL support."""
    rects, sups = window_supports(rect, num_levels, irrev, win)
    needs = {}
    start = num_levels
    while start > 0 and rects[start - 1].empty():
        start -= 1
    top = sups[start]
    if not rects[start].empty() and not top.empty():
        needs[(0, 0)] = top
    else:
        needs[(0, 0)] = Rect(0, 0, 0, 0)
    for l in range(start, 0, -1):
        rr = num_levels - l + 1  # geometry resolution index
        sup_l = sups[l]
        out_rect = Rect(
            2 * sup_l.x0 - 1, 2 * sup_l.y0 - 1, 2 * sup_l.x1, 2 * sup_l.y1
        ).intersect(rects[l - 1])
        ys, yd, xs, xd = _phase_ranges(out_rect)
        # absolute band coordinates (low phase: level-l canvas; high phase:
        # canvas//2 — the same convention the tile geometry uses)
        needs[(rr, 1)] = Rect(xd[0], ys[0], xd[1], ys[1])
        needs[(rr, 2)] = Rect(xs[0], yd[0], xs[1], yd[1])
        needs[(rr, 3)] = Rect(xd[0], yd[0], xd[1], yd[1])
    return needs
