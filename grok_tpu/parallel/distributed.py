"""Distributed (mesh-sharded) encode driver — BASELINE config 4.

Tiles are the natural independent work unit of the codestream (no filtering
crosses a tile boundary), so the production multi-chip axis shards TILES
over the mesh: every device runs the full transform chain (DC shift -> MCT
-> DWT -> quantization) for its tile shard as one jitted shard_map program;
the entropy-coded tile bodies are then assembled on the host in tile order
with a TLM index — the collective analogue of the reference's tile min-heap
stream assembly (CodeStreamCompress.cpp:615-699).

The reversible (5/3) transform is bit-exact between the device batch and
the host path, so ``compress_distributed`` produces a codestream
byte-identical to ``gk.compress`` — asserted by tests/test_parallel.py and
the driver's dryrun_multichip.

Tiles are grouped by a transform fingerprint — the per-level (origin
parity, size) chain that determines the DWT split structure — and EVERY
group rides the device, so right/bottom edge tiles of a non-multiple image
shard onto the mesh too (one compiled program per distinct geometry, at
most four for a regular grid: interior, right edge, bottom edge, corner).
The fingerprint, not the raw (w, h), is the grouping key: two same-size
tiles whose origins differ in parity at some level transform differently,
so shape-only grouping would mis-batch them (caught by the odd-tile-size
regression in tests/test_parallel.py).
"""

from __future__ import annotations

import numpy as np

from ..codestream.compress import (
    build_siz,
    build_tcp,
    compress as _compress,
    _extract_tile,
)
from ..codestream.quantizer import apply_band_quant
from ..core.params import CompressParams
from ..tile.tile_processor import TileProcessor


def _make_mesh(n_devices=None):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("tile",))


def _device_irrev_default() -> bool:
    """Default for ``device_irreversible=None``: lossy (9/7 / custom-MCT)
    tiles ride the mesh only where the device float chain rounds exactly
    like the host (:func:`jax_pipeline.float_chain_exact`, measured on the
    device), so the stream stays byte-identical. Where the compiler
    contracts mul+add into FMAs (XLA:CPU does) samples can move by one LSB,
    and the default keeps irreversible tiles on the host path; pass
    ``device_irreversible=True`` explicitly to override."""
    from ..ops import jax_pipeline

    return jax_pipeline.float_chain_exact()


def _tile_fingerprint(siz, tcp, ti):
    """Transform-equivalence key: tiles with equal fingerprints run the
    same compiled forward/inverse program (same DWT split structure and
    packed-band layout).

    The wavelet lifting splits on ABSOLUTE coordinate parity, and the
    level-l rect is the ceil-halved level-(l-1) rect, so the per-level
    (x0&1, y0&1, w, h) chain captures exactly what the jitted program
    bakes from the tile rect (ops/jax_pipeline.make_forward_fn uses
    g.rect + band sizes; ref: DWT anchoring in T.800 Annex F)."""
    tb = siz.tile_bounds(ti)
    key = []
    for c in range(siz.num_comps):
        comp = siz.comps[c]
        x0 = -(-tb.x0 // comp.dx)
        y0 = -(-tb.y0 // comp.dy)
        x1 = -(-tb.x1 // comp.dx)
        y1 = -(-tb.y1 // comp.dy)
        lev = []
        for _ in range(tcp.tccps[c].num_resolutions):
            lev.append((x0 & 1, y0 & 1, x1 - x0, y1 - y0))
            x0, y0 = -(-x0 // 2), -(-y0 // 2)
            x1, y1 = -(-x1 // 2), -(-y1 // 2)
        key.append(tuple(lev))
    return tuple(key)


def _mesh_key(mesh):
    return tuple(getattr(d, "id", i)
                 for i, d in enumerate(np.ravel(mesh.devices)))


def _fwd_key(siz, tcp):
    """Everything the jitted forward program depends on besides the tile
    fingerprint (program cache key half)."""
    mat = getattr(tcp, "_mct_enc_matrix", None)
    return (
        tcp.mct,
        None if mat is None else np.asarray(mat, np.float64).tobytes(),
        tuple(
            (t.num_resolutions, t.irreversible, int(t.quant_style),
             t.guard_bits, tuple(t.step_exps), tuple(t.step_mants),
             t.roi_shift)
            for t in tcp.tccps
        ),
        tuple((c.prec, c.signed, c.dx, c.dy) for c in siz.comps),
    )


_PROG_CACHE: dict = {}
_PROG_CACHE_MAX = 64


def _prog_cache_get(key, build):
    fn = _PROG_CACHE.get(key)
    if fn is None:
        if len(_PROG_CACHE) >= _PROG_CACHE_MAX:
            _PROG_CACHE.clear()
        fn = _PROG_CACHE[key] = build()
    return fn


def transform_tiles_on_mesh(image, siz, tcp, params, tiles, mesh,
                            device_irreversible: bool | None = None):
    """Run the forward transform chain (DC shift -> MCT -> DWT -> quant)
    for ``tiles`` as fingerprint-grouped shard_map batches over ``mesh``;
    returns {tile_index: [packed coeff plane per component]}.

    Shared by the single-process distributed encoder and the per-process
    local step of the multi-host encoder (parallel/multihost.py). Tiles
    that cannot batch (subsampled components, irreversible flows on a
    platform where the float chain isn't bit-stable) are simply absent
    from the result — the caller's host path covers them. Compiled
    shard_map programs are cached on (fingerprint, transform params,
    mesh), so steady-state frame/strip loops pay zero retrace cost."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map  # jax >= 0.8
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from ..ops import jax_pipeline

    n_dev = mesh.shape["tile"]
    groups: dict[tuple, list[int]] = {}
    subsampled = any(c.dx != 1 or c.dy != 1 for c in siz.comps)
    irrev = bool(tcp.tccps and tcp.tccps[0].irreversible)
    if irrev and device_irreversible is None:
        device_irreversible = _device_irrev_default()
    coeff_map: dict[int, list[np.ndarray]] = {}
    if subsampled or (irrev and not device_irreversible):
        return coeff_map
    fwd_key = _fwd_key(siz, tcp)
    mesh_key = _mesh_key(mesh)
    for ti in tiles:
        groups.setdefault(_tile_fingerprint(siz, tcp, ti), []).append(ti)

    for fp, batch_tiles in groups.items():
        t0 = batch_tiles[0]

        def build(t0=t0):
            tp0 = TileProcessor(siz, tcp, t0, enc_params=params)
            for c in range(siz.num_comps):
                apply_band_quant(tp0.geoms[c], tcp.tccps[c],
                                 tp0._comp_prec(c))
            fwd_one = jax_pipeline.make_forward_fn(
                tp0.geoms, tcp.tccps, siz.comps, tcp.mct
            )

            def batched(stack):  # [T_local, C, H, W]
                def one(tile):
                    outs = fwd_one(*[tile[c] for c in range(tile.shape[0])])
                    return jnp.stack(outs, axis=0)

                return jax.vmap(one)(stack)

            return jax.jit(
                shard_map(
                    batched, mesh=mesh,
                    in_specs=(P("tile"),), out_specs=P("tile"),
                )
            )

        sharded = _prog_cache_get(("fwd", fp, fwd_key, mesh_key), build)

        # chunked async dispatch (P6 overlap): one mesh-full of tiles per
        # dispatch, submitted back-to-back without waiting — the caller
        # fetches each chunk lazily via the returned getter, so the host
        # entropy stage for chunk k runs while the device transforms
        # chunk k+1 (and the device-to-host copy of chunk k)
        chunk = max(n_dev, 1)
        for c0 in range(0, len(batch_tiles), chunk):
            sub = batch_tiles[c0:c0 + chunk]
            stack = np.stack(
                [
                    np.stack(
                        [a.astype(np.int32)
                         for a in _extract_tile(image, siz, ti)],
                        axis=0,
                    )
                    for ti in sub
                ],
                axis=0,
            )
            pad = (-len(sub)) % n_dev
            if pad:
                stack = np.concatenate(
                    [stack, np.zeros((pad, *stack.shape[1:]), np.int32)],
                    axis=0,
                )
            dev_out = sharded(jnp.asarray(stack))  # async dispatch
            h = _ChunkHandle(dev_out, sub)
            for ti in sub:
                coeff_map[ti] = h
    return _CoeffMapView(coeff_map)


class _ChunkHandle:
    """One dispatched transform chunk; fetched on first use."""

    __slots__ = ("dev", "tiles", "planes", "lock")

    def __init__(self, dev, tiles):
        import threading

        self.dev = dev
        self.tiles = tiles
        self.planes = None
        self.lock = threading.Lock()

    def get(self, ti):
        with self.lock:
            if self.planes is None:
                out = np.asarray(self.dev)  # blocks until the chunk lands
                self.dev = None
                self.planes = {
                    t: [out[i, c] for c in range(out.shape[1])]
                    for i, t in enumerate(self.tiles)
                }
        return self.planes[ti]


class _InvChunkHandle:
    """One dispatched inverse chunk; fetched on first paste."""

    __slots__ = ("outs", "tiles", "cache", "lock")

    def __init__(self, outs, tiles):
        import threading

        self.outs = outs
        self.tiles = tiles
        self.cache = None
        self.lock = threading.Lock()

    def get(self, ti):
        with self.lock:
            if self.cache is None:
                host = [np.asarray(o) for o in self.outs]  # blocks
                self.outs = None
                self.cache = {
                    t: [np.ascontiguousarray(host[c][i])
                        for c in range(len(host))]
                    for i, t in enumerate(self.tiles)
                }
        return self.cache[ti]


class _CoeffMapView:
    """dict-like front over chunk handles (tile_coeff_fn target)."""

    def __init__(self, chunk_of):
        self._chunks = chunk_of

    def get(self, ti):
        h = self._chunks.get(ti)
        return None if h is None else h.get(ti)

    def __bool__(self):
        return bool(self._chunks)


def compress_distributed(image, params: CompressParams | None = None,
                         mesh=None, device_irreversible: bool | None = None,
                         entropy_workers: int | None = None,
                         entropy_threads: int | None = None) -> bytes:
    """Distributed encode over a tile mesh; byte-identical to compress()
    under the measured default (see :func:`_device_irrev_default`).

    Reversible (5/3) tiles are byte-identical on every backend (integer
    arithmetic). Irreversible (9/7) tiles ride the mesh by default only
    where the device float chain rounds exactly like the host; elsewhere
    (XLA:CPU contracts mul+add into FMAs, ±1 LSB) they default to the host
    transform. Pass ``device_irreversible=True`` to force lossy tiles onto
    the mesh anyway (equal quality, possibly not byte-equal to the host
    stream) or ``False`` to force the host path everywhere.

    The entropy stage (T1 + T2) fans the mesh-transformed tiles out over
    a host worker pool (the device-mesh analogue of the reference's
    per-tile T1CompressScheduler fan-out); ``entropy_workers`` pins the pool width
    (default: every available core) and ``entropy_threads`` the
    per-worker native team size — the scaling harness uses
    (n_devices, 1) to model per-host cores that scale with the pod."""
    params = params or CompressParams()
    params.validate()
    image.finalize()
    if params.profile:
        from ..codestream.profile import apply_profile

        apply_profile(params, image)

    from ..core import trace

    siz = build_siz(image, params)
    tcp = build_tcp(image, params)
    mesh = mesh or _make_mesh()
    coeff_map = {}
    if siz.num_tiles > 1:
        with trace.span("dist.transform_mesh"):
            coeff_map = transform_tiles_on_mesh(
                image, siz, tcp, params, range(siz.num_tiles), mesh,
                device_irreversible)

    with trace.span("dist.entropy_t2_assemble"):
        return _compress(image, params, tile_coeff_fn=coeff_map.get,
                         entropy_workers=entropy_workers,
                         entropy_threads=entropy_threads)


def _inverse_key(tcp):
    """Hashable summary of everything the device inverse program depends
    on — tiles with equal keys share one compiled shard_map program."""
    mat = tcp.mct_dec_matrix
    off = tcp.mct_offsets
    return (
        tcp.mct,
        None if mat is None else np.asarray(mat, np.float64).tobytes(),
        None if off is None else tuple(float(o) for o in off),
        tuple(
            (
                t.num_resolutions,
                t.irreversible,
                t.roi_shift,
                int(t.quant_style),
                t.guard_bits,
                tuple(t.step_exps),
                tuple(t.step_mants),
            )
            for t in tcp.tccps
        ),
    )


def decompress_distributed(data, params=None, mesh=None,
                           device_irreversible: bool | None = None,
                           entropy_workers: int | None = None,
                           entropy_threads: int | None = None):
    """Distributed decode over a tile mesh; output identical to
    decompress() under the measured default (:func:`_device_irrev_default`).

    The mirror of :func:`compress_distributed` (P2): tile bodies are
    entropy-decoded on the host pool into int32 staging planes
    (``TileProcessor.decompress(staging_only=True)``), the staging planes of
    the dominant same-geometry tile group are stacked per component and the
    whole dequant -> ROI -> inverse-DWT -> inverse-MCT -> finish chain runs
    as ONE jitted shard_map program over the mesh (the same program
    ``jax_pipeline.build_inverse`` runs single-chip); the reconstructed
    tiles ride the normal ordered paste. 5/3 tiles are bit-exact vs the
    host path on every backend (integer arithmetic). 9/7 / custom-MCT
    tiles ride the mesh by default only where the device float chain
    rounds exactly like the host, so the output Image equals
    ``gk.decompress`` sample-for-sample; elsewhere (XLA:CPU FMA
    contraction, ±1 LSB on rare samples) they default to the host
    inverse. ``device_irreversible=True`` forces them onto the mesh
    anyway; ``False`` forces the host inverse everywhere.

    Tiles that fail entropy decode, differ in geometry/coding params, or
    fall outside the dominant group take the per-tile host path inside the
    same paste loop (identical output either way).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map  # jax >= 0.8
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from ..codestream.decompress import Decoder
    from ..ops import jax_pipeline
    from ..tile.tile_processor import TileProcessor

    dec = Decoder(data, params)
    p = dec.params
    if entropy_workers is not None and not p.num_threads:
        # per-shard resource model: the paste pool follows the mesh width
        p.num_threads = entropy_workers
    siz = dec.header.siz

    groups: dict[tuple, list[int]] = {}
    parsed: dict[int, tuple] = {}
    if p.window is None and siz.num_tiles > 1:
        for ti in range(siz.num_tiles):
            if ti not in dec.index.spans:
                continue
            try:
                tcp, body, packed = dec._parse_tile_headers(ti)
            except Exception:
                continue  # corrupt headers: host path zero-fills it
            irrev = bool(tcp.tccps[0].irreversible)
            if (irrev or tcp.mct == 2) and device_irreversible is None:
                device_irreversible = _device_irrev_default()
            if (irrev or tcp.mct == 2) and not device_irreversible:
                continue
            parsed[ti] = (tcp, body, packed)
            k = (_inverse_key(tcp), _tile_fingerprint(siz, tcp, ti))
            groups.setdefault(k, []).append(ti)

    all_tiles = [ti for tiles in groups.values() for ti in tiles]
    handles: dict[int, _InvChunkHandle] = {}
    if all_tiles:
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        from ..core import trace
        from ..core.cpu import host_threads, set_tile_threads

        mesh = mesh or _make_mesh()
        n_dev = mesh.shape["tile"]
        ncomp = siz.num_comps
        nw = min(host_threads(p.num_threads), len(all_tiles), 16)
        if entropy_workers is not None:
            nw = max(1, min(entropy_workers, len(all_tiles)))
        per_tile = entropy_threads or max(
            1, host_threads(p.num_threads) // nw)
        tps: dict[int, TileProcessor] = {}

        def stage_one(ti):
            set_tile_threads(
                per_tile if (nw > 1 or entropy_threads) else 0)
            tcp, body, packed = parsed[ti]
            tp = TileProcessor(siz, tcp, ti)
            try:
                st = tp.decompress(
                    body, p.max_layers, p.reduce, packed_headers=packed,
                    plt=dec._plt.get(ti), staging_only=True,
                )
            except Exception:
                return ti, None  # host path handles + zero-fills
            tps[ti] = tp
            return ti, st

        # chunked pipeline (P6 overlap, the decode mirror of the encode
        # path): stage one mesh-full of tiles on the host pool, dispatch
        # its inverse program WITHOUT waiting, stage the next chunk while
        # the mesh works; fetches happen lazily inside the paste loop
        chunk = max(n_dev, 1)
        ex = ThreadPoolExecutor(max_workers=nw) if nw > 1 else None
        t_stage = t_disp = 0.0
        try:
            for gkey, batch in groups.items():
                sharded = None
                for c0 in range(0, len(batch), chunk):
                    sub = batch[c0:c0 + chunk]
                    _t0 = _time.perf_counter()
                    if ex is not None:
                        res = dict(ex.map(stage_one, sub))
                    else:
                        res = dict(stage_one(ti) for ti in sub)
                    t_stage += _time.perf_counter() - _t0
                    valid = [ti for ti in sub if res.get(ti) is not None]
                    if not valid:
                        continue
                    _t0 = _time.perf_counter()
                    if sharded is None:
                        tp0 = tps[valid[0]]  # band quant applied by staging
                        tcp0 = parsed[valid[0]][0]

                        def build(tp0=tp0, tcp0=tcp0):
                            inv_one = jax_pipeline.make_inverse_fn(
                                tp0.geoms, tcp0.tccps, siz.comps, tcp0.mct,
                                p.reduce,
                                mct_dec_matrix=tcp0.mct_dec_matrix,
                                mct_offsets=tcp0.mct_offsets,
                            )

                            def batched(*stacks):  # [T_local, Hc, Wc] each
                                return jax.vmap(
                                    lambda *planes: inv_one(*planes))(*stacks)

                            return jax.jit(
                                shard_map(batched, mesh=mesh,
                                          in_specs=P("tile"),
                                          out_specs=P("tile"))
                            )

                        # gkey = (inverse key, fingerprint) — with reduce +
                        # comps + mesh it pins everything the program reads
                        sharded = _prog_cache_get(
                            ("inv", gkey, p.reduce,
                             tuple((c.prec, c.signed, c.dx, c.dy)
                                   for c in siz.comps),
                             _mesh_key(mesh)), build)
                    pad = (-len(valid)) % n_dev
                    stacks = []
                    for c in range(ncomp):
                        planes = [res[ti][c] for ti in valid]
                        planes += [np.zeros_like(planes[0])] * pad
                        stacks.append(jnp.asarray(np.stack(planes, axis=0)))
                    outs = sharded(*stacks)  # async dispatch
                    h = _InvChunkHandle(outs, valid)
                    for ti in valid:
                        handles[ti] = h
                    t_disp += _time.perf_counter() - _t0
        finally:
            if ex is not None:
                ex.shutdown(wait=True)
        if trace.enabled():
            trace.add("dist.entropy_decode", t_stage)
            trace.add("dist.inverse_mesh", t_disp)

    if not handles:
        dec._move_tiles = True
        return dec.decompress()

    def tile_arrays_fn(ti):
        h = handles.get(ti)
        return None if h is None else h.get(ti)

    return dec.decompress(tile_arrays_fn=tile_arrays_fn)


def compress_frames(images, params: CompressParams | None = None,
                    mesh=None, device_irreversible: bool | None = None
                    ) -> list[bytes]:
    """Frame-parallel batch encode (P7): a video/DCI sequence of
    same-geometry frames is stacked on the frame axis and sharded over the
    mesh — every device runs the whole transform chain for its frame shard
    in one program, then the per-frame entropy/T2/assembly runs on host
    threads. Each returned codestream is byte-identical to
    ``gk.compress(frame)`` under the platform-gated default (asserted by
    tests/test_parallel.py).

    Frames whose geometry differs from the first frame's, subsampled or
    multi-tile inputs fall back to the per-frame host path (same output).
    Irreversible (9/7) sequences batch on the mesh by default only where
    the device float chain rounds exactly like the host (measured by
    :func:`jax_pipeline.float_chain_exact`), so the byte-identity
    guarantee covers the lossy path too; elsewhere they default to the
    host transform (FMA contraction, ±1 LSB — equal quality, not
    byte-equal). ``device_irreversible=True`` forces mesh batching
    anyway; ``False`` forces the host transform.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map  # jax >= 0.8
    except ImportError:
        from jax.experimental.shard_map import shard_map

    from ..ops import jax_pipeline

    params = params or CompressParams()
    params.validate()
    if not images:
        return []
    for im in images:
        im.finalize()
    if params.profile:
        from ..codestream.profile import apply_profile

        apply_profile(params, images[0])

    siz = build_siz(images[0], params)
    tcp = build_tcp(images[0], params)
    subsampled = any(c.dx != 1 or c.dy != 1 for c in siz.comps)

    def _same_geometry(im) -> bool:
        return (im.x0, im.y0, im.x1, im.y1) == (
            images[0].x0, images[0].y0, images[0].x1, images[0].y1
        ) and len(im.components) == len(images[0].components) and all(
            (a.prec, a.signed, a.dx, a.dy) == (b.prec, b.signed, b.dx, b.dy)
            for a, b in zip(im.components, images[0].components)
        )

    irrev = bool(tcp.tccps and tcp.tccps[0].irreversible)
    if irrev and device_irreversible is None:
        device_irreversible = _device_irrev_default()
    batch_idx = [
        i for i, im in enumerate(images)
        if _same_geometry(im) and not subsampled and siz.num_tiles == 1
    ]
    if irrev and not device_irreversible:
        batch_idx = []
    coeffs_of: dict[int, list[np.ndarray]] = {}
    if len(batch_idx) >= 2:
        mesh = mesh or _make_mesh()
        n_dev = mesh.shape["tile"]
        tp0 = TileProcessor(siz, tcp, 0, enc_params=params)
        for c in range(siz.num_comps):
            apply_band_quant(tp0.geoms[c], tcp.tccps[c], tp0._comp_prec(c))
        fwd_one = jax_pipeline.make_forward_fn(
            tp0.geoms, tcp.tccps, siz.comps, tcp.mct
        )

        def batched(stack):  # [F_local, C, H, W]
            def one(frame):
                outs = fwd_one(*[frame[c] for c in range(frame.shape[0])])
                return jnp.stack(outs, axis=0)

            return jax.vmap(one)(stack)

        sharded = jax.jit(
            shard_map(
                batched, mesh=mesh,
                in_specs=(P("tile"),), out_specs=P("tile"),
            )
        )
        stack = np.stack(
            [
                np.stack(
                    [c.data.astype(np.int32)
                     for c in images[i].components],
                    axis=0,
                )
                for i in batch_idx
            ],
            axis=0,
        )
        pad = (-stack.shape[0]) % n_dev
        if pad:
            stack = np.concatenate(
                [stack, np.zeros((pad, *stack.shape[1:]), np.int32)], axis=0
            )
        out = np.asarray(sharded(jnp.asarray(stack)))
        for row, i in enumerate(batch_idx):
            coeffs_of[i] = [out[row, c] for c in range(out.shape[1])]

    # per-frame entropy + T2 + assembly on host threads (the native T1/T2
    # calls release the GIL; cap each worker's OpenMP team)
    from concurrent.futures import ThreadPoolExecutor

    from ..core.cpu import host_threads, set_tile_threads

    nw = min(host_threads(getattr(params, "num_threads", 0)), len(images), 8)
    per_frame = max(1, host_threads(getattr(params, "num_threads", 0)) // nw)

    import copy

    def encode_one(i):
        set_tile_threads(per_frame)
        # compress() may (idempotently) mutate params via apply_profile;
        # give each worker its own copy so frames can't race on it
        p = copy.deepcopy(params)
        cf = coeffs_of.get(i)
        if cf is not None:
            return _compress(images[i], p,
                             tile_coeff_fn=lambda ti: cf if ti == 0 else None)
        return _compress(images[i], p)

    if nw > 1 and len(images) > 1:
        with ThreadPoolExecutor(max_workers=nw) as ex:
            return list(ex.map(encode_one, range(len(images))))
    return [encode_one(i) for i in range(len(images))]
