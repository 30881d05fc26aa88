"""Device-resident tile transform pipeline (jax/XLA).

One jitted function per tile geometry runs DC shift -> MCT -> DWT ->
quantization (encode) or dequantization -> inverse DWT -> inverse MCT ->
final conversion (decode) entirely on the accelerator; only entropy-coded
bytes cross the host boundary when combined with a device T1 coder.

Enabled with GROK_TPU_DEVICE=jax (tile_processor checks it); the band
geometry is closed over at trace time so every slice is static and XLA
fuses the whole chain. Parity: the numpy stages in tile_processor.py.

The 5/3 chain is bit-exact against the host path on every backend
(integer arithmetic). The 9/7, ICT and custom-MCT chain is bit-exact only
where the device compiler rounds every float32 product and sum like the
host does; a compiler that contracts mul+add into one fused multiply-add
moves rare samples by one LSB. :func:`float_chain_exact` measures that
property on the device at hand, and the mesh paths
(parallel/distributed.py) key their lossy default on it.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from . import dwt as dwt_ops
from . import mct as mct_ops


def _band_origin(geom, res_idx: int, orient: int):
    if orient == 0:
        return 0, 0
    prev = geom.resolutions[res_idx - 1].rect
    if orient == 1:
        return 0, prev.width
    if orient == 2:
        return prev.height, 0
    return prev.height, prev.width


def quantize(xp, vals, step):
    """sign(v) * floor(|v| / step) as int32, the host quantizer's formula.
    XLA rounds the float32 quotient like a multiply by the reciprocal
    (XLA:CPU for a constant step, XLA:GPU always), so on the device a few
    coefficients can land one step away from the host's."""
    return (xp.sign(vals) * xp.floor(xp.abs(vals) / xp.float32(step))
            ).astype(xp.int32)


def make_forward_fn(geoms, tccps, siz_comps, mct: int,
                    mct_enc_matrix=None):
    """Un-jitted forward transform fn(*comps) (see build_forward)."""
    import jax
    import jax.numpy as jnp

    ncomp = len(geoms)
    irrev = tccps[0].irreversible
    band_specs = []
    for g, tccp in zip(geoms, tccps):
        specs = []
        for res in g.resolutions:
            for band in res.bands:
                oy, ox = _band_origin(g, res.r, band.orient)
                specs.append((oy, ox, band.rect.height, band.rect.width,
                              float(band.step)))
        band_specs.append((specs, tccp.roi_shift))

    dcs = [0 if c.signed else 1 << (c.prec - 1) for c in siz_comps]
    nls = [t.num_resolutions - 1 for t in tccps]
    rects = [g.rect for g in geoms]

    enc_m = (np.asarray(mct_enc_matrix, dtype=np.float32)
             if mct == 2 and mct_enc_matrix is not None else None)

    def f(*comps):
        shifted = [comps[c] - dcs[c] for c in range(ncomp)]
        if mct == 2 and enc_m is not None:
            # Part-2 array-based MCT (float path, the host's arithmetic)
            shifted = mct_ops.custom_mct_forward(
                jnp, [x.astype(jnp.float32) for x in shifted], enc_m)
        elif mct == 1 and ncomp >= 3:
            if irrev:
                r, g, b = (x.astype(jnp.float32) for x in shifted[:3])
                y, cb, cr = mct_ops.ict_forward(jnp, r, g, b)
                shifted = [y, cb, cr, *shifted[3:]]
            else:
                y, cb, cr = mct_ops.rct_forward(jnp, *shifted[:3])
                shifted = [y, cb, cr, *shifted[3:]]
        outs = []
        for c in range(ncomp):
            a = shifted[c]
            if irrev:
                a = a.astype(jnp.float32)
            packed = dwt_ops.forward(jnp, a, rects[c], nls[c], irrev)
            if irrev:
                specs, roi = band_specs[c]
                q = jnp.zeros(packed.shape, dtype=jnp.int32)
                for (oy, ox, bh, bw, step) in specs:
                    vals = jax.lax.dynamic_slice(packed, (oy, ox), (bh, bw))
                    q = jax.lax.dynamic_update_slice(
                        q, quantize(jnp, vals, step), (oy, ox))
                if roi:
                    q = q << roi
                outs.append(q)
            else:
                specs, roi = band_specs[c]
                outs.append(packed << roi if roi else packed)
        return tuple(outs)

    return f


def pin_device(fn):
    """Honor GROK_TPU_DEVICE_ID (CLI -G DeviceId parity): run the jitted
    program on the selected device instead of jax's default. Pass host
    (numpy) arguments so they are copied straight to that device."""
    did = os.environ.get("GROK_TPU_DEVICE_ID", "")
    if not did:
        return fn
    import jax

    dev = jax.devices()[int(did)]

    def wrapped(*a):
        with jax.default_device(dev):
            return fn(*a)

    return wrapped


def build_forward(geoms, tccps, siz_comps, mct: int, mct_enc_matrix=None):
    """Returns jitted fn(*comps int32 [H,W]) -> tuple of packed int32 arrays.

    Band steps/ROI must already be applied to the geometry (apply_band_quant).
    """
    import jax

    return pin_device(jax.jit(make_forward_fn(
        geoms, tccps, siz_comps, mct, mct_enc_matrix=mct_enc_matrix)))


def make_inverse_fn(geoms, tccps, siz_comps, mct: int, reduce: int = 0,
                    mct_dec_matrix=None, mct_offsets=None):
    """Un-jitted inverse transform fn(*staging) (see build_inverse)."""
    import jax
    import jax.numpy as jnp

    ncomp = len(geoms)
    irrev = tccps[0].irreversible
    band_specs = []
    for g, tccp in zip(geoms, tccps):
        top = max(g.num_resolutions - 1 - reduce, 0)
        specs = []
        for res in g.resolutions[: top + 1]:
            for band in res.bands:
                oy, ox = _band_origin(g, res.r, band.orient)
                specs.append((oy, ox, band.rect.height, band.rect.width,
                              float(band.step)))
        band_specs.append((specs, tccp.roi_shift))
    nls = [max(t.num_resolutions - 1 - reduce, 0) for t in tccps]
    rects = [g.rect.ceil_div_pow2(reduce) if reduce else g.rect for g in geoms]
    dec_m = (np.asarray(mct_dec_matrix, dtype=np.float32)
             if mct == 2 and mct_dec_matrix is not None else None)

    def f(*staging):
        outs = []
        for c in range(ncomp):
            a = staging[c]
            specs, roi = band_specs[c]
            if roi:
                mag = jnp.abs(a)
                thresh = 1 << roi
                mag = jnp.where(mag >= thresh, mag >> roi, mag)
                a = jnp.where(a < 0, -mag, mag)
            if irrev:
                deq = jnp.zeros(a.shape, dtype=jnp.float32)
                for (oy, ox, bh, bw, step) in specs:
                    qv = jax.lax.dynamic_slice(a, (oy, ox), (bh, bw)).astype(
                        jnp.float32
                    )
                    m = jnp.abs(qv)
                    rec = jnp.where(
                        m > 0, (m + jnp.float32(0.5)) * jnp.float32(step), 0.0
                    )
                    deq = jax.lax.dynamic_update_slice(
                        deq, jnp.where(qv < 0, -rec, rec), (oy, ox)
                    )
                a = deq
            outs.append(dwt_ops.inverse(jnp, a, rects[c], nls[c], irrev))
        if mct == 2 and dec_m is not None:
            outs = mct_ops.custom_mct_inverse(
                jnp, [o.astype(jnp.float32) for o in outs], dec_m)
        elif mct == 1 and ncomp >= 3:
            if irrev:
                r, g, b = mct_ops.ict_inverse(jnp, outs[0], outs[1], outs[2])
            else:
                r, g, b = mct_ops.rct_inverse(jnp, outs[0], outs[1], outs[2])
            outs = [r, g, b, *outs[3:]]
        final = []
        for c in range(ncomp):
            a = outs[c]
            prec = siz_comps[c].prec
            signed = siz_comps[c].signed
            lo = -(1 << (prec - 1)) if signed else 0
            hi = (1 << (prec - 1)) - 1 if signed else (1 << prec) - 1
            if irrev:
                off = 0.0 if signed else float(1 << (prec - 1))
                if mct == 2 and mct_offsets is not None:
                    off = float(mct_offsets[c])
                a = jnp.clip(
                    jnp.floor(a + jnp.float32(0.5 + off)), lo, hi
                ).astype(jnp.int32)
            else:
                a = jnp.clip(a + (0 if signed else 1 << (prec - 1)), lo, hi)
            final.append(a.astype(jnp.int32))
        return tuple(final)

    return f


def build_inverse(geoms, tccps, siz_comps, mct: int, reduce: int = 0,
                  mct_dec_matrix=None, mct_offsets=None):
    """Returns jitted fn(*staging int32 packed) -> tuple of final int32."""
    import jax

    return pin_device(
        jax.jit(make_inverse_fn(geoms, tccps, siz_comps, mct, reduce,
                                mct_dec_matrix=mct_dec_matrix,
                                mct_offsets=mct_offsets))
    )


def device_enabled() -> bool:
    return os.environ.get("GROK_TPU_DEVICE", "") == "jax"


@functools.cache
def float_chain_exact() -> bool:
    """Whether the default device rounds the 9/7 / ICT / custom-MCT float
    chain, quantizer included, bit-for-bit like the host.

    Runs the forward and inverse chain on a fixed 64x64x3 input once per
    process, jitted on the device and in numpy, and compares every
    sample. Fused multiply-adds or a reciprocal-rounded division change
    the last bit of a large share of samples, so either shows here."""
    import jax
    import jax.numpy as jnp

    from ..core.rect import Rect

    n = 64
    x = np.random.default_rng(0).integers(
        -128, 128, size=(3, n, n)).astype(np.float32)
    rect = Rect(0, 0, n, n)
    mat = np.array([[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]],
                   dtype=np.float32)

    def chain(xp, a):
        # the host DWT works in place: hand it copies
        ycc = mct_ops.ict_forward(xp, a[0], a[1], a[2])
        fwd = [dwt_ops.forward(xp, xp.array(c), rect, 3, True) for c in ycc]
        inv = [dwt_ops.inverse(xp, xp.array(c), rect, 3, True) for c in fwd]
        # the quotient, not its floor: a few floors in a million differ
        return (fwd + [xp.abs(c) / xp.float32(0.0213720) for c in fwd]
                + list(mct_ops.ict_inverse(xp, *inv))
                + mct_ops.custom_mct_forward(xp, inv, mat))

    host = chain(np, x)
    dev = jax.jit(lambda a: chain(jnp, a))(x)
    return all(np.array_equal(h, np.asarray(d)) for h, d in zip(host, dev))
