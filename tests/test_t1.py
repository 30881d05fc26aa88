"""Tier-1 batched coder roundtrip tests across block shapes and amplitudes."""

import numpy as np
import pytest

from grok_tpu.t1.ebcot_np import decode_cblks, encode_cblks


def _roundtrip(coeffs, heights, widths, orients):
    n, h, w = coeffs.shape
    res = encode_cblks(coeffs, heights, widths, orients)
    dec, _ = decode_cblks(
        res.data, res.lengths, res.numbps, res.npasses,
        heights, widths, orients, h, w,
    )
    for i in range(n):
        a = coeffs[i, : heights[i], : widths[i]]
        b = dec[i, : heights[i], : widths[i]]
        assert np.array_equal(a, b), f"block {i}"


def test_mixed_sizes(rng):
    N, H, W = 8, 32, 32
    coeffs = (
        rng.standard_normal((N, H, W)) * rng.choice([0.5, 4, 40], size=(N, 1, 1))
    ).astype(np.int64)
    coeffs[3] = 0
    heights = np.array([32, 32, 17, 32, 9, 32, 5, 32])
    widths = np.array([32, 32, 32, 21, 13, 32, 32, 7])
    orients = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    _roundtrip(coeffs, heights, widths, orients)


def test_short_blocks(rng):
    N, H, W = 6, 16, 16
    coeffs = (rng.standard_normal((N, H, W)) * 30).astype(np.int64)
    heights = np.array([1, 2, 3, 16, 1, 5])
    widths = np.array([16, 16, 16, 16, 3, 16])
    orients = np.array([0, 1, 2, 3, 0, 1])
    _roundtrip(coeffs, heights, widths, orients)


def test_large_amplitude(rng):
    N, H, W = 4, 16, 16
    coeffs = rng.integers(-(2**20), 2**20, size=(N, H, W)).astype(np.int64)
    heights = np.full(N, H)
    widths = np.full(N, W)
    orients = np.arange(N) % 4
    _roundtrip(coeffs, heights, widths, orients)


def test_sparse(rng):
    N, H, W = 4, 32, 32
    coeffs = np.zeros((N, H, W), dtype=np.int64)
    for i in range(N):
        idx = rng.integers(0, H * W, size=5)
        coeffs[i].flat[idx] = rng.integers(-100, 100, size=5)
    heights = np.full(N, H)
    widths = np.full(N, W)
    orients = np.arange(N) % 4
    _roundtrip(coeffs, heights, widths, orients)


def test_jax_encoder_matches_numpy(rng):
    """Device lockstep coder must produce bit-identical MQ streams,
    per-pass rates included, across the supported codeblock styles."""
    from grok_tpu.t1 import ebcot_jax

    N, H, W = 5, 10, 8
    # H=10: partial bottom stripe (regression: lax.dynamic_slice clamping
    # made phantom rows alias row H-1); magnitudes force >10 passes so the
    # BYPASS/TERMALL segment machinery engages
    coeffs = (rng.standard_normal((N, H, W)) * 900).astype(np.int64)
    hs = np.array([10, 5, 10, 3, 10])
    ws = np.array([8, 8, 6, 8, 8])
    ors = np.array([0, 1, 2, 3, 0])
    styles = np.array([0, 0x08, 0x05, 0x15, 0x3F])
    r_np = encode_cblks(coeffs, hs, ws, ors, styles=styles)
    r_jx = ebcot_jax.encode_cblks(coeffs, hs, ws, ors, styles=styles)
    for i in range(N):
        ln, lj = int(r_np.lengths[i]), int(r_jx.lengths[i])
        assert ln == lj
        assert np.array_equal(r_np.data[i, :ln], r_jx.data[i, :lj])
    mp = min(r_np.pass_rates.shape[1], r_jx.pass_rates.shape[1])
    assert np.array_equal(r_np.pass_rates[:, :mp], r_jx.pass_rates[:, :mp])


def test_jax_decoder_roundtrip(rng):
    """Device lockstep DECODER: native-encoded streams decode bit-exact."""
    from grok_tpu.t1 import ebcot_jax

    N, H, W = 5, 8, 8
    coeffs = (rng.standard_normal((N, H, W)) * 25).astype(np.int64)
    hs = np.array([8, 5, 8, 3, 8])
    ws = np.array([8, 8, 6, 8, 8])
    ors = np.array([0, 1, 2, 3, 0])
    styles = np.array([0, 0x08, 0x02, 0x20, 0x2A])
    res = encode_cblks(coeffs, hs, ws, ors, styles=styles)
    dec, _ = ebcot_jax.decode_cblks(
        res.data, res.lengths, res.numbps, res.npasses,
        hs, ws, ors, H, W, styles=styles,
    )
    for i in range(N):
        assert np.array_equal(
            coeffs[i, : hs[i], : ws[i]], dec[i, : hs[i], : ws[i]]
        ), f"block {i}"


def test_jax_backend_end_to_end(rng):
    """GROK_TPU_T1=jax drives the full codec (compress AND decompress)."""
    import os

    import grok_tpu as gk

    arr = (rng.standard_normal((24, 24)) * 40 + 128).clip(0, 255).astype(np.uint8)
    im = gk.Image.from_array(arr.astype(np.int32))
    old = os.environ.get("GROK_TPU_T1")
    os.environ["GROK_TPU_T1"] = "jax"
    try:
        stream = gk.compress(im, gk.CompressParams(num_resolutions=2, cblk_width=16, cblk_height=16))
        out = gk.decompress(stream)
        assert np.array_equal(out.components[0].data, arr.astype(np.int32))
        # the jax stream must equal the native stream bit-for-bit
        os.environ["GROK_TPU_T1"] = "native"
        ref = gk.compress(im, gk.CompressParams(num_resolutions=2, cblk_width=16, cblk_height=16))
        assert stream == ref
    finally:
        if old is None:
            os.environ.pop("GROK_TPU_T1", None)
        else:
            os.environ["GROK_TPU_T1"] = old


def test_want_dist_does_not_change_streams(rng):
    """want_dist=False must only skip distortion accounting: streams,
    lengths and pass rates stay byte-identical."""
    from grok_tpu.t1 import native

    if not native.available():
        import pytest

        pytest.skip("no native lib")
    n, h, w = 12, 32, 32
    c = rng.laplace(0, 50, (n, h, w)).astype(np.int32)
    hs = np.full(n, h)
    ws = np.full(n, w)
    os_ = (np.arange(n) % 4).astype(np.int64)
    a = native.encode_cblks(c, hs, ws, os_, want_dist=True)
    b = native.encode_cblks(c, hs, ws, os_, want_dist=False)
    assert np.array_equal(a.lengths, b.lengths)
    for i in range(n):  # buffers are np.empty: only [:length] is defined
        ln = int(a.lengths[i])
        assert np.array_equal(a.data[i, :ln], b.data[i, :ln]), i
    assert np.array_equal(a.pass_rates, b.pass_rates)
    assert (b.pass_dist == 0).all()
    assert (a.pass_dist != 0).any()


def test_select_backend_pallas_removed():
    """The Mosaic Part-1 kernel is gone; its name is now unknown."""
    from grok_tpu.t1 import select_backend

    with pytest.raises(ValueError, match="pallas"):
        select_backend("pallas")
