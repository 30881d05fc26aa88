"""Mesh-sharded component tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grok_tpu.core.rect import Rect
from grok_tpu.ops import dwt as dwt_ops
from grok_tpu.parallel.mesh import make_sharded_strip_dwt, make_sharded_transform


def _mesh(n, name):
    devs = np.array(jax.devices()[:n])
    return Mesh(devs, axis_names=(name,))


def test_sharded_strip_dwt_matches_single_device(rng):
    """Halo-exchange sharded 5/3 DWT == the single-array reference, and the
    inverse reconstructs exactly (config 4 machinery)."""
    n = min(8, len(jax.devices()))
    mesh = _mesh(n, "y")
    H, W, LV = 64 * n, 128, 4
    x = rng.integers(-512, 512, size=(H, W)).astype(np.int32)
    fwd, inv = make_sharded_strip_dwt(mesh, LV)
    sharding = NamedSharding(mesh, P("y", None))
    xd = jax.device_put(x, sharding)
    packed = np.asarray(fwd(xd))
    back = np.asarray(inv(fwd(xd)))
    assert np.array_equal(back, x), "sharded inverse must reconstruct exactly"

    # forward layout check (exact, positional): the per-shard packing keeps
    # level-l lows in each shard's first S/2^l rows. Every band of every
    # level must match the reference Mallat layout sample-for-sample.
    ref = dwt_ops.forward(np, x.astype(np.int32).copy(), Rect(0, 0, W, H), LV, False)
    S = H // n
    for lvl in range(1, LV + 1):
        rh, rw = S >> lvl, W >> lvl  # per-shard rows / global cols at lvl
        for i in range(n):
            # LH|HH rows (high vertical phase of this level)
            got = packed[i * S + rh : i * S + 2 * rh, : 2 * rw]
            rr = (H >> lvl) + i * rh
            assert np.array_equal(got, ref[rr : rr + rh, : 2 * rw]), ("d", lvl, i)
            # HL block (low vertical phase, high horizontal phase)
            got = packed[i * S : i * S + rh, rw : 2 * rw]
            rr = i * rh
            assert np.array_equal(got, ref[rr : rr + rh, rw : 2 * rw]), ("HL", lvl, i)
    # deepest LL
    rh, rw = S >> LV, W >> LV
    for i in range(n):
        got = packed[i * S : i * S + rh, :rw]
        assert np.array_equal(got, ref[i * rh : (i + 1) * rh, :rw]), ("LL", i)


def test_sharded_transform_tile_parallel(rng):
    n = min(8, len(jax.devices()))
    mesh = _mesh(n, "tile")
    T, H, W = n * 2, 64, 64
    batch = rng.integers(0, 256, size=(T, 3, H, W)).astype(np.int32)
    fn = make_sharded_transform(mesh, levels=3)
    sharding = NamedSharding(mesh, P("tile"))
    bd = jax.device_put(batch, sharding)
    packed, blk_max, dist = fn(bd)
    assert packed.shape == (T, 3, H, W)
    assert blk_max.shape == (T, 3, 1, 1)
    assert np.isfinite(float(dist))
    # the device transform must equal the host reference transform exactly
    from grok_tpu.ops import mct as mct_ops

    for t in range(T):
        r, g, b = (batch[t, c].astype(np.int32) - 128 for c in range(3))
        y, cb, cr = mct_ops.rct_forward(np, r, g, b)
        for ci, comp in enumerate((y, cb, cr)):
            ref = dwt_ops.forward(np, comp.copy(), Rect(0, 0, W, H), 3, False)
            assert np.array_equal(np.asarray(packed)[t, ci], ref), (t, ci)
    # distortion psum must equal the direct sum
    assert abs(float(dist) - float(np.square(np.asarray(packed, np.float64)).sum())) < 1e-3 * abs(float(dist))


def test_distributed_encode_byte_identical(rng):
    """Full mesh-sharded encode must produce the exact single-chip stream
    (tiles sharded over devices, ordered host assembly with TLM)."""
    import grok_tpu as gk
    from grok_tpu.parallel.distributed import compress_distributed
    from tests.conftest import natural_image

    arr = natural_image(192, 256, 3)
    p = gk.CompressParams(num_resolutions=3, tile_size=(64, 64), write_tlm=True)
    ref = gk.compress(gk.Image.from_array(arr), p)
    dist = compress_distributed(gk.Image.from_array(arr), p)
    assert dist == ref

    # uneven boundary tiles shard onto the mesh as their own fingerprint
    # groups (right edge / bottom edge / corner)
    arr2 = natural_image(150, 170, 3)
    p2 = gk.CompressParams(num_resolutions=3, tile_size=(64, 64))
    ref2 = gk.compress(gk.Image.from_array(arr2), p2)
    dist2 = compress_distributed(gk.Image.from_array(arr2), p2)
    assert dist2 == ref2


def test_distributed_odd_tile_parity_groups(rng):
    """Regression: same-SIZE tiles whose origins differ in parity at some
    DWT level transform differently — shape-only grouping mis-batched them
    (wrong coefficients, silently corrupt stream). The fingerprint key must
    keep them apart; streams stay byte-identical to the host path."""
    import grok_tpu as gk
    from grok_tpu.parallel.distributed import (compress_distributed,
                                               decompress_distributed)
    from tests.conftest import natural_image

    arr = natural_image(111, 149, 3)
    p = gk.CompressParams(num_resolutions=3, tile_size=(37, 37))
    ref = gk.compress(gk.Image.from_array(arr), p)
    p2 = gk.CompressParams(num_resolutions=3, tile_size=(37, 37))
    dist = compress_distributed(gk.Image.from_array(arr), p2)
    assert dist == ref
    assert np.array_equal(decompress_distributed(ref).to_array(),
                          gk.decompress(ref).to_array())


def test_distributed_decode_bit_identical(rng):
    """Mesh-sharded decode (P2 mirror of config 4): host entropy decode
    per tile, dequant/inverse-DWT/MCT/finish as one shard_map program over
    the tile mesh — output identical to the host decoder, including
    rate-allocated layers, TLM, reduce, ROI and uneven edge tiles."""
    import grok_tpu as gk
    from grok_tpu.parallel.distributed import decompress_distributed
    from tests.conftest import natural_image

    arr = natural_image(150, 170, 3)
    p = gk.CompressParams(num_resolutions=3, tile_size=(64, 64),
                          num_layers=2, layer_rates=[4.0, 0.0],
                          write_tlm=True)
    st = gk.compress(gk.Image.from_array(arr), p)
    assert np.array_equal(decompress_distributed(st).to_array(),
                          gk.decompress(st).to_array())
    dp = gk.DecompressParams(reduce=1)
    assert np.array_equal(
        decompress_distributed(st, gk.DecompressParams(reduce=1)).to_array(),
        gk.decompress(st, dp).to_array())

    # ROI + odd geometry
    arr3 = natural_image(96, 161, 1)
    p3 = gk.CompressParams(num_resolutions=3, tile_size=(48, 48), roi_shift=4)
    st3 = gk.compress(gk.Image.from_array(arr3), p3)
    assert np.array_equal(decompress_distributed(st3).to_array(),
                          gk.decompress(st3).to_array())

    # irreversible rides the device chain by default only where the float
    # chain rounds like the host (jax_pipeline.float_chain_exact); the
    # device chain on XLA:CPU may drift at most ±1 LSB on rare samples
    # (LLVM FMA contraction). The host-inverse opt-out stays exact
    # everywhere.
    p2 = gk.CompressParams(num_resolutions=3, tile_size=(64, 64),
                           irreversible=True)
    st2 = gk.compress(gk.Image.from_array(arr), p2)
    ref2 = gk.decompress(st2).to_array()
    dev = decompress_distributed(st2).to_array()
    assert np.abs(dev.astype(int) - ref2.astype(int)).max() <= 1
    assert np.array_equal(
        decompress_distributed(st2, device_irreversible=False).to_array(),
        ref2)


def test_frame_parallel_cinema_batch(rng):
    """BASELINE config 5: Cinema DCI rate-capped frames as a
    frame-parallel batch — every frame byte-identical to the one-shot
    encoder and within the DCI codestream cap."""
    import grok_tpu as gk
    from grok_tpu.codestream.profile import validate_cinema_stream
    from grok_tpu.core.params import CINEMA_24_CS, PROFILE_CINEMA_2K
    from grok_tpu.parallel.distributed import compress_frames
    from tests.conftest import natural_image

    frames = [
        gk.Image.from_array(natural_image(1080, 2048, nc=3, prec=12, seed=s),
                            prec=12)
        for s in range(3)
    ]
    p = gk.CompressParams(profile=PROFILE_CINEMA_2K, framerate=24)
    # host-transform mode: byte-identical to the one-shot encoder on any
    # backend (the 9/7 device chain is byte-identical only where
    # jax_pipeline.float_chain_exact holds, so strict identity is asserted
    # on the deterministic opt-out here)
    outs = compress_frames(frames, p, device_irreversible=False)
    assert len(outs) == 3
    for s, st in enumerate(outs):
        assert len(st) <= CINEMA_24_CS, s
        assert validate_cinema_stream(st, p), s
        one = gk.compress(
            gk.Image.from_array(
                natural_image(1080, 2048, nc=3, prec=12, seed=s), prec=12),
            gk.CompressParams(profile=PROFILE_CINEMA_2K, framerate=24),
        )
        assert st == one, s
    # default mode (9/7 batched on the mesh): still valid DCI streams
    # within the cap, decoding within the CPU backend's ±1 ulp class
    outs_dev = compress_frames(frames[:1], p)
    assert len(outs_dev[0]) <= CINEMA_24_CS
    assert validate_cinema_stream(outs_dev[0], p)
    a = gk.decompress(outs_dev[0]).to_array().astype(int)
    b = gk.decompress(outs[0]).to_array().astype(int)
    assert np.abs(a - b).max() <= 1


def test_frame_parallel_batch_encode(rng):
    """P7 frame parallelism: a same-geometry frame sequence sharded over
    the mesh encodes each frame byte-identically to the one-shot path."""
    import grok_tpu as gk
    from grok_tpu.parallel.distributed import compress_frames
    from tests.conftest import natural_image

    frames = [
        gk.Image.from_array(natural_image(96, 128, 3, seed=s))
        for s in range(5)
    ]
    p = gk.CompressParams(num_resolutions=3)
    refs = [
        gk.compress(gk.Image.from_array(natural_image(96, 128, 3, seed=s)), p)
        for s in range(5)
    ]
    outs = compress_frames(frames, p)
    assert len(outs) == 5
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o == r, i
    # mixed geometry: odd frame falls back to the host path, same bytes
    frames2 = [
        gk.Image.from_array(natural_image(96, 128, 3, seed=1)),
        gk.Image.from_array(natural_image(64, 80, 3, seed=2)),
        gk.Image.from_array(natural_image(96, 128, 3, seed=3)),
    ]
    outs2 = compress_frames(frames2, p)
    for f2, o2 in zip(
        (natural_image(96, 128, 3, seed=1), natural_image(64, 80, 3, seed=2),
         natural_image(96, 128, 3, seed=3)), outs2
    ):
        assert gk.compress(gk.Image.from_array(f2), p) == o2


def test_sharded_strip_dwt_97(rng):
    """Sharded 9/7 strip DWT (four halo-lifted steps per level) matches
    the single-array reference through the layout bridge and inverts."""
    from grok_tpu.parallel.mesh import strip_to_mallat

    n = min(8, len(jax.devices()))
    mesh = _mesh(n, "y")
    H, W, LV = 32 * n, 64, 3
    x = (rng.standard_normal((H, W)) * 100).astype(np.float32)
    fwd, inv = make_sharded_strip_dwt(mesh, LV, irreversible=True)
    sharding = NamedSharding(mesh, P("y", None))
    xd = jax.device_put(x, sharding)
    packed = np.asarray(fwd(xd))
    back = np.asarray(inv(fwd(xd)))
    assert np.allclose(back, x, atol=1e-3)
    ref = dwt_ops.forward(np, x.copy(), Rect(0, 0, W, H), LV, True)
    got = strip_to_mallat(packed, n, LV)
    assert np.allclose(got, ref, atol=1e-2 * max(1.0, np.abs(ref).max() / 100))


def test_sharded_strip_feeds_codeblock_gathering(rng):
    """The layout bridge makes sharded-strip coefficients directly
    consumable by the entropy/T2 stage: a stream built from them is
    byte-identical to the one-shot encoder."""
    import grok_tpu as gk
    from grok_tpu.codestream.compress import (
        build_siz, build_tcp, encode_tile_to_blob,
    )
    from grok_tpu.parallel.mesh import strip_to_mallat
    from tests.conftest import natural_image

    n = min(8, len(jax.devices()))
    mesh = _mesh(n, "y")
    H = 32 * n
    W = 256
    LV = 3
    arr = natural_image(H, W)
    p = gk.CompressParams(num_resolutions=LV + 1)
    ref_stream = gk.compress(gk.Image.from_array(arr), p)

    fwd, _ = make_sharded_strip_dwt(mesh, LV)
    sharding = NamedSharding(mesh, P("y", None))
    shifted = (arr.astype(np.int32) - 128)  # DC shift (8-bit unsigned)
    packed = np.asarray(fwd(jax.device_put(shifted, sharding)))
    coeffs = strip_to_mallat(packed, n, LV)

    im = gk.Image.from_array(arr)
    im.finalize()
    pp = gk.CompressParams(num_resolutions=LV + 1)
    siz = build_siz(im, pp)
    tcp = build_tcp(im, pp)
    blob, _parts, _plens = encode_tile_to_blob(siz, tcp, pp, 0,
                                               coeffs=[coeffs])
    assert bytes(blob) in ref_stream  # tile body identical, headers shared


def test_auto_sharded_dwt_odd_sizes_and_parity(rng):
    """GSPMD-partitioned DWT handles odd dimensions and odd canvas
    origins (parity 1) bit-exactly on the mesh — the cases the strip
    kernels exclude by construction."""
    from grok_tpu.parallel.mesh import make_auto_sharded_dwt

    n = min(8, len(jax.devices()))
    mesh = _mesh(n, "y")
    for (H, W, x0, y0, LV) in ((171, 133, 0, 0, 3), (160, 96, 1, 1, 2),
                               (97, 241, 3, 5, 4)):
        rect = Rect(x0, y0, x0 + W, y0 + H)
        x = rng.integers(-512, 512, size=(H, W)).astype(np.int32)
        fwd, inv = make_auto_sharded_dwt(mesh, rect, LV, False)
        got = np.asarray(fwd(x))
        ref = dwt_ops.forward(np, x.copy(), rect, LV, False)
        assert np.array_equal(got, ref), (H, W, x0, y0)
        back = np.asarray(inv(got))
        assert np.array_equal(back, x), (H, W, x0, y0)
        # 9/7 on the same odd geometry
        xf = (rng.standard_normal((H, W)) * 80).astype(np.float32)
        fwd97, inv97 = make_auto_sharded_dwt(mesh, rect, LV, True)
        got97 = np.asarray(fwd97(xf))
        ref97 = dwt_ops.forward(np, xf.copy(), rect, LV, True)
        assert np.allclose(got97, ref97, atol=1e-2), (H, W)
        assert np.allclose(np.asarray(inv97(got97)), xf, atol=1e-2)
