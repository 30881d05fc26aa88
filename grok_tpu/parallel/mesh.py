"""Mesh-sharded codec components (SURVEY §2.3 P1-P8 device-mesh equivalents).

The reference's parallelism is a single-host thread pool; here the same
axes become mesh axes with XLA collectives:

* tile parallelism (P1/P2): `shard_map` over a "tile" axis — each device
  transforms a batch of tiles; per-tile entropy coding rides the lanes.
* sharded-tile DWT (P4, BASELINE config 4): a tile strip sharded along Y
  across devices, with one-row halo exchanges via `jax.lax.ppermute` per
  lifting step — the distributed generalization of the reference's
  windowed lifting (WaveletReverse.cpp FILTER_WIDTH halos).
* rate-allocation stats (P8): `psum` of distortion / byte counts — the
  collective analogue of RateInfo::synch + the tile min-heap gather.

Everything compiles under jit on a `jax.sharding.Mesh`; tests run on a
virtual 8-device CPU mesh, production on ICI.
"""

from __future__ import annotations

import functools

import numpy as np


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


# ------------------------------------------------------------ halo helpers
# n_shards is always static (from the mesh shape) so ppermute gets concrete
# permutation lists.
def _halo_from_next(x, axis_name, n_shards):
    """Receive the first row of the next shard (edge shards get zeros; the
    caller fixes the global boundary with symmetric-extension clamping)."""
    import jax

    perm = [(i, i - 1) for i in range(1, n_shards)]  # shard i sends to i-1
    return jax.lax.ppermute(x, axis_name, perm)


def _halo_from_prev(x, axis_name, n_shards):
    import jax

    perm = [(i, i + 1) for i in range(n_shards - 1)]
    return jax.lax.ppermute(x, axis_name, perm)


def _is_last(axis_name, n_shards):
    import jax

    return jax.lax.axis_index(axis_name) == n_shards - 1


def _is_first(axis_name):
    import jax

    return jax.lax.axis_index(axis_name) == 0


# ------------------------------------------------- sharded 5/3 lifting DWT
def _fwd53_v_sharded(x, axis_name, n_shards):
    """One vertical 5/3 forward lifting pass on a Y-sharded array.

    x: [S, W] local shard (S even, global row offset even). Returns the
    locally packed [s | d] halves. Needs two one-row halo exchanges."""
    jax, jnp = _jax()
    s = x[0::2]
    d = x[1::2]

    # predict: d[j] -= floor((s[j] + s[j+1]) / 2); the last d of a shard
    # needs the next shard's first s row
    s_next_first = _halo_from_next(s[0:1], axis_name, n_shards)
    last = _is_last(axis_name, n_shards)
    # global symmetric extension: on the last shard, clamp to own last s
    s_next_first = jnp.where(last, s[-1:], s_next_first)
    s_right = jnp.concatenate([s[1:], s_next_first], axis=0)
    d = d - ((s + s_right) >> 1)

    # update: s[i] += floor((d[i-1] + d[i] + 2) / 4); the first s needs the
    # previous shard's last d row
    d_prev_last = _halo_from_prev(d[-1:], axis_name, n_shards)
    first = _is_first(axis_name)
    d_prev_last = jnp.where(first, d[0:1], d_prev_last)
    d_left = jnp.concatenate([d_prev_last, d[:-1]], axis=0)
    s = s + ((d_left + d + 2) >> 2)
    return jnp.concatenate([s, d], axis=0)


def _inv53_v_sharded(y, axis_name, n_shards):
    """Inverse of _fwd53_v_sharded on the locally packed [s | d] halves."""
    jax, jnp = _jax()
    half = y.shape[0] // 2
    s = y[:half]
    d = y[half:]

    d_prev_last = _halo_from_prev(d[-1:], axis_name, n_shards)
    first = _is_first(axis_name)
    d_prev_last = jnp.where(first, d[0:1], d_prev_last)
    d_left = jnp.concatenate([d_prev_last, d[:-1]], axis=0)
    s = s - ((d_left + d + 2) >> 2)

    s_next_first = _halo_from_next(s[0:1], axis_name, n_shards)
    last = _is_last(axis_name, n_shards)
    s_next_first = jnp.where(last, s[-1:], s_next_first)
    s_right = jnp.concatenate([s[1:], s_next_first], axis=0)
    d = d + ((s + s_right) >> 1)

    out = jnp.zeros_like(y)
    out = out.at[0::2].set(s)
    out = out.at[1::2].set(d)
    return out


def _fwd53_h_local(x):
    """Horizontal 5/3 pass (unsharded axis), parity 0, packed output."""
    _, jnp = _jax()
    s = x[:, 0::2]
    d = x[:, 1::2]
    s_right = jnp.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    d = d - ((s + s_right) >> 1)
    d_left = jnp.concatenate([d[:, :1], d[:, :-1]], axis=1)
    s = s + ((d_left + d + 2) >> 2)
    return jnp.concatenate([s, d], axis=1)


def _inv53_h_local(y):
    _, jnp = _jax()
    half = y.shape[1] // 2
    s = y[:, :half]
    d = y[:, half:]
    d_left = jnp.concatenate([d[:, :1], d[:, :-1]], axis=1)
    s = s - ((d_left + d + 2) >> 2)
    s_right = jnp.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    d = d + ((s + s_right) >> 1)
    out = jnp.zeros_like(y)
    out = out.at[:, 0::2].set(s)
    out = out.at[:, 1::2].set(d)
    return out


# ------------------------------------------------- sharded 9/7 lifting DWT
def _fwd97_v_sharded(x, axis_name, n_shards):
    """One vertical 9/7 forward pass on a Y-sharded float32 array: four
    lifting steps, each with a single one-row halo exchange (ops/dwt.py
    fwd97_axis math, distributed)."""
    jax, jnp = _jax()
    from ..ops.dwt import ALPHA, BETA, DELTA, GAMMA, K

    s = x[0::2]
    d = x[1::2]
    last = _is_last(axis_name, n_shards)
    first = _is_first(axis_name)

    def s_next(sv):
        nxt = _halo_from_next(sv[0:1], axis_name, n_shards)
        nxt = jnp.where(last, sv[-1:], nxt)
        return jnp.concatenate([sv[1:], nxt], axis=0)

    def d_prev(dv):
        prv = _halo_from_prev(dv[-1:], axis_name, n_shards)
        prv = jnp.where(first, dv[0:1], prv)
        return jnp.concatenate([prv, dv[:-1]], axis=0)

    d = d + jnp.float32(ALPHA) * (s + s_next(s))
    s = s + jnp.float32(BETA) * (d_prev(d) + d)
    d = d + jnp.float32(GAMMA) * (s + s_next(s))
    s = s + jnp.float32(DELTA) * (d_prev(d) + d)
    s = s * jnp.float32(1.0 / K)
    d = d * jnp.float32(K)
    return jnp.concatenate([s, d], axis=0)


def _inv97_v_sharded(y, axis_name, n_shards):
    jax, jnp = _jax()
    from ..ops.dwt import ALPHA, BETA, DELTA, GAMMA, K

    half = y.shape[0] // 2
    s = y[:half] * jnp.float32(K)
    d = y[half:] * jnp.float32(1.0 / K)
    last = _is_last(axis_name, n_shards)
    first = _is_first(axis_name)

    def s_next(sv):
        nxt = _halo_from_next(sv[0:1], axis_name, n_shards)
        nxt = jnp.where(last, sv[-1:], nxt)
        return jnp.concatenate([sv[1:], nxt], axis=0)

    def d_prev(dv):
        prv = _halo_from_prev(dv[-1:], axis_name, n_shards)
        prv = jnp.where(first, dv[0:1], prv)
        return jnp.concatenate([prv, dv[:-1]], axis=0)

    s = s - jnp.float32(DELTA) * (d_prev(d) + d)
    d = d - jnp.float32(GAMMA) * (s + s_next(s))
    s = s - jnp.float32(BETA) * (d_prev(d) + d)
    d = d - jnp.float32(ALPHA) * (s + s_next(s))
    out = jnp.zeros_like(y)
    out = out.at[0::2].set(s)
    out = out.at[1::2].set(d)
    return out


def _fwd97_h_local(x):
    _, jnp = _jax()
    from ..ops.dwt import ALPHA, BETA, DELTA, GAMMA, K

    s = x[:, 0::2]
    d = x[:, 1::2]

    def nxt(sv):
        return jnp.concatenate([sv[:, 1:], sv[:, -1:]], axis=1)

    def prv(dv):
        return jnp.concatenate([dv[:, :1], dv[:, :-1]], axis=1)

    d = d + jnp.float32(ALPHA) * (s + nxt(s))
    s = s + jnp.float32(BETA) * (prv(d) + d)
    d = d + jnp.float32(GAMMA) * (s + nxt(s))
    s = s + jnp.float32(DELTA) * (prv(d) + d)
    return jnp.concatenate(
        [s * jnp.float32(1.0 / K), d * jnp.float32(K)], axis=1
    )


def _inv97_h_local(y):
    _, jnp = _jax()
    from ..ops.dwt import ALPHA, BETA, DELTA, GAMMA, K

    half = y.shape[1] // 2
    s = y[:, :half] * jnp.float32(K)
    d = y[:, half:] * jnp.float32(1.0 / K)

    def nxt(sv):
        return jnp.concatenate([sv[:, 1:], sv[:, -1:]], axis=1)

    def prv(dv):
        return jnp.concatenate([dv[:, :1], dv[:, :-1]], axis=1)

    s = s - jnp.float32(DELTA) * (prv(d) + d)
    d = d - jnp.float32(GAMMA) * (s + nxt(s))
    s = s - jnp.float32(BETA) * (prv(d) + d)
    d = d - jnp.float32(ALPHA) * (s + nxt(s))
    out = jnp.zeros_like(y)
    out = out.at[:, 0::2].set(s)
    out = out.at[:, 1::2].set(d)
    return out


def sharded_dwt53_forward(x_local, levels: int, axis_name: str, n_shards: int = 1):
    """Multi-level forward 5/3 DWT of a Y-sharded tile strip.

    Runs inside shard_map. x_local: [S, W] with S divisible by 2^levels and
    W divisible by 2^levels. Layout: per-shard packed — level l's low band
    occupies the first S/2^l rows of every shard (still evenly sharded), so
    each level only exchanges one halo row per lifting step over ICI.
    """
    _, jnp = _jax()
    S, W = x_local.shape
    cur_h, cur_w = S, W
    for _ in range(levels):
        sub = x_local[:cur_h, :cur_w]
        sub = _fwd53_v_sharded(sub, axis_name, n_shards)
        sub = _fwd53_h_local(sub)
        x_local = x_local.at[:cur_h, :cur_w].set(sub)
        cur_h //= 2
        cur_w //= 2
    return x_local


def sharded_dwt53_inverse(y_local, levels: int, axis_name: str, n_shards: int = 1):
    _, jnp = _jax()
    S, W = y_local.shape
    hs = [(S >> l, W >> l) for l in range(levels + 1)]
    for l in range(levels, 0, -1):
        h, w = hs[l - 1]
        sub = y_local[:h, :w]
        sub = _inv53_h_local(sub)
        sub = _inv53_v_sharded(sub, axis_name, n_shards)
        y_local = y_local.at[:h, :w].set(sub)
    return y_local


def sharded_dwt97_forward(x_local, levels: int, axis_name: str,
                          n_shards: int = 1):
    """Multi-level forward 9/7 DWT of a Y-sharded float32 tile strip
    (same per-shard packed layout as the 5/3 variant)."""
    _, jnp = _jax()
    S, W = x_local.shape
    cur_h, cur_w = S, W
    for _ in range(levels):
        sub = x_local[:cur_h, :cur_w]
        sub = _fwd97_v_sharded(sub, axis_name, n_shards)
        sub = _fwd97_h_local(sub)
        x_local = x_local.at[:cur_h, :cur_w].set(sub)
        cur_h //= 2
        cur_w //= 2
    return x_local


def sharded_dwt97_inverse(y_local, levels: int, axis_name: str,
                          n_shards: int = 1):
    _, jnp = _jax()
    S, W = y_local.shape
    hs = [(S >> l, W >> l) for l in range(levels + 1)]
    for l in range(levels, 0, -1):
        h, w = hs[l - 1]
        sub = y_local[:h, :w]
        sub = _inv97_h_local(sub)
        sub = _inv97_v_sharded(sub, axis_name, n_shards)
        y_local = y_local.at[:h, :w].set(sub)
    return y_local


# ------------------------------------------- strip <-> codestream layout
def _strip_row_provenance(H: int, n_shards: int, levels: int) -> np.ndarray:
    """strip_row -> provenance id (the natural input row whose coefficient
    chain lands there), by simulating the per-shard packing on indices."""
    S = H // n_shards
    out = np.arange(H).reshape(n_shards, S).copy()
    cur = S
    for _ in range(levels):
        sub = out[:, :cur]
        out[:, :cur] = np.concatenate([sub[:, 0::2], sub[:, 1::2]], axis=1)
        cur //= 2
    return out.reshape(-1)


def _mallat_row_provenance(H: int, levels: int) -> np.ndarray:
    out = np.arange(H).copy()
    cur = H
    for _ in range(levels):
        sub = out[:cur].copy()
        out[: (cur + 1) // 2] = sub[0::2]
        out[(cur + 1) // 2 : cur] = sub[1::2]
        cur //= 2
    return out


def _row_perm_at_level(H: int, n_shards: int, level: int) -> np.ndarray:
    """mallat = strip_rows[perm] for rows packed ``level`` times."""
    strip = _strip_row_provenance(H, n_shards, level)
    mallat = _mallat_row_provenance(H, level)
    inv = np.empty(H, dtype=np.int64)
    inv[strip] = np.arange(H)
    return inv[mallat]


def strip_to_mallat_map(H: int, W: int, n_shards: int,
                        levels: int) -> np.ndarray:
    """[H, W] row-index map m with mallat = strip[m, arange(W)] (one
    take_along_axis gather): converts the per-shard packed layout of
    sharded_dwt*_forward into the global codestream (Mallat) layout of
    ops/dwt.py, so sharded coefficients feed codeblock gathering /
    compress_from_coeffs directly.

    The map is per-column-band because each level's vertical split only
    reorders the columns it still owns (cols < W >> (l-1)): the h-high
    band of level l keeps the row order after exactly l vertical
    packings. Requires n_shards | H and 2^levels | H/n_shards (the strip
    constraint); the column layout already matches (the horizontal axis
    is unsharded)."""
    m = np.empty((H, W), dtype=np.int64)
    for lvl in range(1, levels + 1):
        perm = _row_perm_at_level(H, n_shards, lvl)
        lo, hi = W >> lvl, W >> (lvl - 1)
        m[:, lo:hi] = perm[:, None]
        if lvl == levels:
            m[:, :lo] = perm[:, None]
    return m


def strip_to_mallat(y: np.ndarray, n_shards: int, levels: int) -> np.ndarray:
    """Apply the layout bridge on a gathered [H, W] strip result."""
    H, W = y.shape[-2], y.shape[-1]
    return np.take_along_axis(
        y, strip_to_mallat_map(H, W, n_shards, levels), axis=-2
    )


def mallat_to_strip(y: np.ndarray, n_shards: int, levels: int) -> np.ndarray:
    H, W = y.shape[-2], y.shape[-1]
    m = strip_to_mallat_map(H, W, n_shards, levels)
    out = np.empty_like(y)
    np.put_along_axis(out, m, y, axis=-2)
    return out


def make_auto_sharded_dwt(mesh, rect, levels: int, irreversible: bool):
    """GSPMD-partitioned multi-level DWT for arbitrary sizes and parity.

    The hand-rolled strip kernels above pin one ppermute per lifting step
    but require even, equally-divisible shards. For odd dimensions or
    odd canvas origins (parity 1) the XLA-idiomatic route is to let the
    XLA partitioner insert the halo exchanges itself: trace the general
    host lifting (ops/dwt.py — full parity/odd-size handling) over a
    Y-sharded global array. Output is already in codestream (Mallat)
    layout — no bridge needed. Returns (forward, inverse) jitted fns."""
    import functools as _ft

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax.numpy as jnp

    from ..ops import dwt as dwt_ops

    sh = NamedSharding(mesh, P("y", None))
    n = mesh.shape["y"]
    H = rect.height
    pad = (-H) % n  # sharded dims must divide the mesh; the lifting only
    # ever reads/writes [:h, :w], so trailing pad rows are inert

    def fwd(x):
        return dwt_ops.forward(jnp, x, rect, levels, irreversible)

    def inv(y):
        return dwt_ops.inverse(jnp, y, rect, levels, irreversible)

    jfwd = jax.jit(fwd, in_shardings=sh, out_shardings=sh)
    jinv = jax.jit(inv, in_shardings=sh, out_shardings=sh)

    def _wrap(jfn):
        def run(x):
            x = np.asarray(x)
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad, x.shape[1]), x.dtype)], axis=0
                )
            out = jfn(x)
            return out[:H] if pad else out

        return run

    return _wrap(jfwd), _wrap(jinv)


# --------------------------------------------------- tile-parallel encode
def make_sharded_transform(mesh, levels: int = 5):
    """jit-compiled tile-parallel encode transform: DC shift + RCT + DWT +
    per-codeblock max-magnitude stats, tiles sharded over the mesh's
    'tile' axis; global distortion psum (RateInfo::synch analogue)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map  # jax >= 0.8
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from ..ops import mct as mct_ops

    def per_shard(batch):  # [T_local, 3, H, W] int32
        r, g, b = batch[:, 0], batch[:, 1], batch[:, 2]
        rs = mct_ops.dc_shift_forward(jnp, r, 8, False)
        gs = mct_ops.dc_shift_forward(jnp, g, 8, False)
        bs = mct_ops.dc_shift_forward(jnp, b, 8, False)
        y, cb, cr = mct_ops.rct_forward(jnp, rs, gs, bs)
        comps = jnp.stack([y, cb, cr], axis=1)

        T, C, H, W = comps.shape
        flat = comps.reshape(T * C, H, W)

        from ..core.rect import Rect
        from ..ops import dwt as dwt_ops

        def one(x):
            # the shared multi-level lifting (ops/dwt.py), traced under jit
            return dwt_ops.forward(jnp, x, Rect(0, 0, W, H), levels, False)

        packed = jax.vmap(one)(flat).reshape(T, C, H, W)
        mags = jnp.abs(packed).reshape(T, C, H // 64, 64, W // 64, 64)
        blk_max = mags.max(axis=(3, 5))
        dist = jax.lax.psum(
            jnp.sum(jnp.square(packed.astype(jnp.float32))), "tile"
        )
        return packed, blk_max, dist

    spec = P("tile")
    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec,), out_specs=(spec, spec, P()),
    )
    return jax.jit(fn)


def make_sharded_strip_dwt(mesh, levels: int, irreversible: bool = False):
    """jit-compiled forward/inverse sharded-strip DWT pair (config 4):
    5/3 int32 or 9/7 float32 per ``irreversible``."""
    import jax
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map  # jax >= 0.8
    except ImportError:
        from jax.experimental.shard_map import shard_map

    n = mesh.shape["y"]
    f = sharded_dwt97_forward if irreversible else sharded_dwt53_forward
    g = sharded_dwt97_inverse if irreversible else sharded_dwt53_inverse
    fwd = shard_map(
        functools.partial(f, levels=levels, axis_name="y", n_shards=n),
        mesh=mesh, in_specs=(P("y", None),), out_specs=P("y", None),
    )
    inv = shard_map(
        functools.partial(g, levels=levels, axis_name="y", n_shards=n),
        mesh=mesh, in_specs=(P("y", None),), out_specs=P("y", None),
    )
    return jax.jit(fwd), jax.jit(inv)
