"""Device (jax) HT cleanup encoder vs the scalar host oracle.

Byte-identity of every codeword segment across block sizes, precisions,
sparsity patterns and ragged (odd h/w) edge blocks; plus the backend API
(T1EncodeResult parity with ht.encode_cblks)."""

import numpy as np
import pytest

from grok_tpu.t1 import ht, ht_jax


def _blocks(rng, n, bh, bw, mag, density=0.5, signed=True):
    c = rng.integers(0, mag + 1, size=(n, bh, bw))
    mask = rng.random((n, bh, bw)) < density
    c = c * mask
    if signed:
        c = np.where(rng.random((n, bh, bw)) < 0.5, -c, c)
    return c.astype(np.int64)


def _check_identical(coeffs, heights, widths):
    segs = ht_jax.encode_cleanup_batch(
        coeffs.astype(np.int32), heights, widths)
    for i in range(coeffs.shape[0]):
        hi, wi = int(heights[i]), int(widths[i])
        blk = coeffs[i, :hi, :wi]
        if hi == 0 or wi == 0 or np.abs(blk).max(initial=0) == 0:
            assert segs[i] == b""
            continue
        ref = ht.encode_cleanup(coeffs[i], hi, wi)
        assert segs[i] == ref, (
            f"block {i} ({hi}x{wi}): device {segs[i][:40].hex()}... "
            f"!= host {ref[:40].hex()}...")


@pytest.mark.parametrize("bh,bw", [(64, 64), (32, 32), (16, 16), (4, 4),
                                   (8, 32), (64, 4)])
def test_device_matches_host_sizes(bh, bw):
    rng = np.random.default_rng(7)
    coeffs = _blocks(rng, 24, bh, bw, mag=200)
    heights = np.full(24, bh, dtype=np.int64)
    widths = np.full(24, bw, dtype=np.int64)
    _check_identical(coeffs, heights, widths)


def test_device_matches_host_ragged_edges():
    rng = np.random.default_rng(11)
    bh = bw = 64
    n = 40
    coeffs = _blocks(rng, n, bh, bw, mag=500, density=0.7)
    heights = rng.integers(1, bh + 1, size=n).astype(np.int64)
    widths = rng.integers(1, bw + 1, size=n).astype(np.int64)
    heights[0], widths[0] = 1, 1
    heights[1], widths[1] = 64, 1
    heights[2], widths[2] = 1, 64
    heights[3], widths[3] = 63, 63
    heights[4], widths[4] = 3, 5
    for i in range(n):
        coeffs[i, heights[i]:, :] = 0
        coeffs[i, :, widths[i]:] = 0
    _check_identical(coeffs, heights, widths)


@pytest.mark.parametrize("mag,density", [
    (1, 0.5), (1, 0.02), (3, 0.9), (65000, 0.6), ((1 << 23) - 1, 0.3),
    (255, 1.0), (10, 0.001),
])
def test_device_matches_host_distributions(mag, density):
    rng = np.random.default_rng(mag * 31 + 1)
    coeffs = _blocks(rng, 16, 64, 64, mag=mag, density=density)
    heights = np.full(16, 64, dtype=np.int64)
    widths = np.full(16, 64, dtype=np.int64)
    _check_identical(coeffs, heights, widths)


def test_device_all_zero_and_mixed():
    rng = np.random.default_rng(3)
    coeffs = _blocks(rng, 8, 32, 32, mag=100)
    coeffs[2] = 0
    coeffs[5] = 0
    heights = np.full(8, 32, dtype=np.int64)
    widths = np.full(8, 32, dtype=np.int64)
    _check_identical(coeffs, heights, widths)


def test_stuffing_stress():
    """Dense all-ones-ish content maximizes 0xFF / >0x8F stuffing events."""
    rng = np.random.default_rng(5)
    coeffs = np.full((6, 64, 64), -((1 << 20) - 1), dtype=np.int64)
    coeffs[1] = (1 << 15) - 1
    coeffs[2] = rng.choice([-((1 << 12) - 1), (1 << 12) - 1],
                           size=(64, 64))
    coeffs[3, ::2] = 0
    coeffs[4, :, ::3] = 0
    heights = np.full(6, 64, dtype=np.int64)
    widths = np.full(6, 64, dtype=np.int64)
    _check_identical(coeffs, heights, widths)


def test_backend_result_parity():
    rng = np.random.default_rng(17)
    coeffs = _blocks(rng, 12, 64, 64, mag=300)
    coeffs[3] = 0
    heights = np.full(12, 64, dtype=np.int64)
    widths = np.full(12, 64, dtype=np.int64)
    widths[5] = 17
    heights[6] = 9
    for i in range(12):
        coeffs[i, heights[i]:, :] = 0
        coeffs[i, :, widths[i]:] = 0
    orients = np.zeros(12, dtype=np.int64)
    rd = ht_jax.encode_cblks(coeffs, heights, widths, orients)
    rh = ht.encode_cblks(coeffs, heights, widths, orients, device=False)
    assert np.array_equal(rd.lengths, rh.lengths)
    assert np.array_equal(rd.numbps, rh.numbps)
    assert np.array_equal(rd.npasses, rh.npasses)
    for i in range(12):
        li = int(rd.lengths[i])
        assert bytes(rd.data[i, :li]) == bytes(rh.data[i, :li])
    assert np.allclose(rd.pass_dist, rh.pass_dist)


def test_full_codec_stream_identical(monkeypatch, tmp_path):
    """GROK_TPU_T1=ht-device produces the identical codestream to the host
    HT coder through the full compress pipeline."""
    import grok_tpu as gk
    from grok_tpu.core.image import Image

    rng = np.random.default_rng(42)
    arr = rng.integers(0, 256, size=(96, 160, 3), dtype=np.uint8)
    params = gk.CompressParams(num_resolutions=4, ht=True)

    monkeypatch.delenv("GROK_TPU_T1", raising=False)
    ref = gk.compress(Image.from_array(arr), params)
    monkeypatch.setenv("GROK_TPU_T1", "ht-device")
    dev = gk.compress(Image.from_array(arr), params)
    assert dev == ref
    dec = gk.decompress(dev)
    got = np.stack([c.data for c in dec.components], axis=-1)
    assert np.array_equal(got, arr)


def test_roundtrip_through_host_decoder():
    rng = np.random.default_rng(23)
    coeffs = _blocks(rng, 10, 64, 64, mag=1000, density=0.4)
    heights = np.full(10, 64, dtype=np.int64)
    widths = np.full(10, 64, dtype=np.int64)
    segs = ht_jax.encode_cleanup_batch(
        coeffs.astype(np.int32), heights, widths)
    for i in range(10):
        got = ht.decode_cleanup(segs[i], 64, 64)
        assert np.array_equal(got, coeffs[i])


# ===================================================== device decode path
# (ht_jax_dec: batched FBCOT cleanup decode on XLA; parity target
#  /root/reference/src/lib/jp2/t1/t1_ht/coding/ojph_block_decoder.cpp)

from grok_tpu.t1 import ht_jax_dec


def _batch_segs(coeffs, heights, widths):
    segs = []
    for i in range(coeffs.shape[0]):
        hi, wi = int(heights[i]), int(widths[i])
        blk = coeffs[i, :hi, :wi]
        segs.append(ht.encode_cleanup(coeffs[i], hi, wi)
                    if hi and wi and np.abs(blk).max(initial=0) else b"")
    L = max(max((len(s) for s in segs), default=0), 2)
    data = np.zeros((len(segs), L), np.uint8)
    lens = np.zeros(len(segs), np.int64)
    for i, s in enumerate(segs):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return segs, data, lens


def _check_decode_identical(coeffs, heights, widths, bh, bw):
    segs, data, lens = _batch_segs(coeffs, heights, widths)
    out = ht_jax_dec.decode_cleanup_batch(data, lens, heights, widths,
                                          bh, bw)
    for i in range(coeffs.shape[0]):
        hi, wi = int(heights[i]), int(widths[i])
        ref = np.zeros((bh, bw), np.int64)
        if lens[i] >= 2:
            ref[:hi, :wi] = ht.decode_cleanup(segs[i], hi, wi)
        assert np.array_equal(out[i], ref), f"lane {i} ({hi}x{wi})"


@pytest.mark.parametrize("bh,bw", [(64, 64), (32, 32), (16, 16), (4, 4),
                                   (8, 32), (64, 4)])
def test_decode_matches_host_sizes(bh, bw):
    rng = np.random.default_rng(101)
    coeffs = _blocks(rng, 12, bh, bw, mag=200)
    heights = np.full(12, bh, dtype=np.int64)
    widths = np.full(12, bw, dtype=np.int64)
    _check_decode_identical(coeffs, heights, widths, bh, bw)


def test_decode_matches_host_ragged_edges():
    rng = np.random.default_rng(103)
    n, bh, bw = 24, 64, 64
    coeffs = _blocks(rng, n, bh, bw, mag=500, density=0.7)
    heights = rng.integers(1, bh + 1, size=n).astype(np.int64)
    widths = rng.integers(1, bw + 1, size=n).astype(np.int64)
    heights[0], widths[0] = 1, 1
    heights[1], widths[1] = 64, 1
    heights[2], widths[2] = 1, 64
    heights[3], widths[3] = 63, 63
    heights[4], widths[4] = 3, 5
    for i in range(n):
        coeffs[i, heights[i]:, :] = 0
        coeffs[i, :, widths[i]:] = 0
    _check_decode_identical(coeffs, heights, widths, bh, bw)


@pytest.mark.parametrize("mag,density", [
    (1, 0.5), (1, 0.02), (3, 0.9), (65000, 0.6), ((1 << 23) - 1, 0.3),
    (255, 1.0), (10, 0.001),
])
def test_decode_matches_host_distributions(mag, density):
    rng = np.random.default_rng(mag * 37 + 5)
    coeffs = _blocks(rng, 8, 64, 64, mag=mag, density=density)
    heights = np.full(8, 64, dtype=np.int64)
    widths = np.full(8, 64, dtype=np.int64)
    _check_decode_identical(coeffs, heights, widths, 64, 64)


def test_decode_host_fallback_on_wide_magnitudes():
    """Magnitudes needing >30 MagSgn bits flag the lane for host redo; the
    result must still equal the scalar oracle."""
    coeffs = np.zeros((3, 32, 32), np.int64)
    coeffs[0, :4, :4] = (1 << 29) + 12345
    coeffs[1, 2, 2] = -(1 << 30)
    coeffs[2, :, :] = 77  # normal lane rides the device
    heights = np.full(3, 32, dtype=np.int64)
    widths = np.full(3, 32, dtype=np.int64)
    _check_decode_identical(coeffs, heights, widths, 32, 32)


def test_decode_cblks_device_api():
    rng = np.random.default_rng(107)
    n = 9
    coeffs = _blocks(rng, n, 64, 64, mag=900, density=0.4)
    coeffs[4] = 0
    heights = np.full(n, 64, dtype=np.int64)
    widths = np.full(n, 64, dtype=np.int64)
    orients = np.zeros(n, dtype=np.int64)
    enc = ht.encode_cblks(coeffs, heights, widths, orients, device=False)
    out_d, planes_d = ht.decode_cblks(
        enc.data, enc.lengths, enc.numbps, enc.npasses, heights, widths,
        orients, 64, 64, device=True)
    out_h, planes_h = ht.decode_cblks(
        enc.data, enc.lengths, enc.numbps, enc.npasses, heights, widths,
        orients, 64, 64, device=False)
    assert np.array_equal(out_d, out_h)
    assert np.array_equal(planes_d, planes_h)
    assert np.array_equal(out_d, coeffs)


def test_decode_garbage_segments_match_host():
    """Random bytes: device decode (with host redo on flagged lanes) must
    reproduce the host decoder's output bit-for-bit."""
    rng = np.random.default_rng(109)
    n, L = 16, 400
    data = rng.integers(0, 256, size=(n, L), dtype=np.uint8)
    lens = rng.integers(2, L + 1, size=n).astype(np.int64)
    heights = np.full(n, 32, dtype=np.int64)
    widths = np.full(n, 32, dtype=np.int64)
    out = ht_jax_dec.decode_cleanup_batch(data, lens, heights, widths,
                                          32, 32)
    for i in range(n):
        ref = np.zeros((32, 32), np.int64)
        try:
            ref = ht.decode_cleanup(bytes(data[i, : lens[i]]), 32, 32)
        except ValueError:
            pass
        assert np.array_equal(out[i], ref), f"lane {i}"


def test_stuff_host_native_matches_python_fallback(monkeypatch):
    """ht_stuff_words (native/ht_coder.cpp) and _stuff_host's python
    fallback must agree bit-for-bit on bytes, counts and partial state —
    including 0xFF-dense content that cascades stuffing events."""
    from grok_tpu.t1 import native

    if not native.available():
        import pytest

        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, size=(6, 40), dtype=np.uint64).astype(
        np.uint32)
    words[2] = 0xFFFFFFFF
    words[3, ::2] = 0xFF00FF00
    totals = np.array([0, 5, 40 * 32, 1000, 1001, 777], dtype=np.int64)
    for kind in ("ms", "mel", "vlc"):
        a = native.ht_stuff_words(words, totals, kind)
        monkeypatch.setattr(native, "available", lambda: False)
        b = ht_jax._stuff_host(words, totals, kind)
        monkeypatch.undo()
        for i in range(len(totals)):
            assert a[1][i] == b[1][i], (kind, i, "n_emit")
            assert np.array_equal(a[0][i, : a[1][i]], b[0][i, : b[1][i]]), (
                kind, i, "bytes")
            assert (a[2][i], a[3][i], a[4][i]) == (
                b[2][i], b[3][i], b[4][i]), (kind, i, "tail state")


def _np_pack(vals, lens, cap):
    """Reference bit packer: LSB-first concatenation as Python ints."""
    words = np.zeros((vals.shape[0], cap), np.uint32)
    totals = np.zeros(vals.shape[0], np.int64)
    for i in range(vals.shape[0]):
        acc = pos = 0
        for v, ln in zip(vals[i].tolist(), lens[i].tolist()):
            acc |= (v & ((1 << ln) - 1)) << pos
            pos += ln
        totals[i] = pos
        for k in range(cap):
            words[i, k] = (acc >> (32 * k)) & 0xFFFFFFFF
    return words, totals


@pytest.mark.parametrize("seed,cap", [(7, 24), (8, 40), (9, 9)])
def test_pack_extract_match_numpy(seed, cap):
    """_pack_bits and _extract against a Python-int reference, including
    reads that run past the packed words into the zero pad word."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n, m = 5, 64
    lens = rng.integers(0, 33, size=(n, m)).astype(np.int32)
    # keep totals within capacity (the callers size caps the same way)
    lens = np.minimum(lens, np.maximum(
        0, cap * 32 - np.cumsum(lens, axis=1) + lens)).astype(np.int32)
    vals = rng.integers(0, 2 ** 32, size=(n, m), dtype=np.uint64).astype(
        np.uint32)
    words, totals = ht_jax._pack_bits(jnp.asarray(vals), jnp.asarray(lens),
                                      cap)
    ref_w, ref_t = _np_pack(vals, lens, cap)
    assert np.array_equal(np.asarray(words), ref_w)
    assert np.array_equal(np.asarray(totals), ref_t)

    padded = np.pad(ref_w, ((0, 0), (0, 1)))
    p = rng.integers(0, (cap + 2) * 32, size=(n, 17)).astype(np.int32)
    for mask in (np.uint32(0xFFFF), np.uint32(0x7F), np.uint32(0xFFFFFFFF)):
        got = np.asarray(ht_jax._extract(jnp.asarray(padded),
                                         jnp.asarray(p), mask))
        for i in range(n):
            big = sum(int(w) << (32 * k) for k, w in enumerate(padded[i]))
            want = [(big >> int(q)) & int(mask) for q in p[i]]
            assert got[i].tolist() == want, (i, hex(int(mask)))


def test_cxt_vlc_lookup_all_indices():
    """The CxtVLC lookup returns the encoder table entry for every one of
    the 4096 (context, rho, eps) indices of both row tables."""
    import jax.numpy as jnp

    idx = np.arange(4096, dtype=np.int32)
    got = np.asarray(ht_jax._cxt_vlc_lookup(jnp.asarray(idx)))
    assert np.array_equal(got, ht_jax._TBL_NP)
    # any leading batch shape, as the encoder uses [n, qh, qw]
    got3 = np.asarray(ht_jax._cxt_vlc_lookup(
        jnp.asarray(idx.reshape(4, 32, 32))))
    assert np.array_equal(got3.ravel(), ht_jax._TBL_NP)


def _hw_case(name, rng, n):
    if name == "dense-small":
        c = rng.integers(-40, 41, size=(n, 64, 64))
    elif name == "sparse-1bit":
        c = ((rng.random((n, 64, 64)) < 0.04)
             * rng.choice([-1, 1], size=(n, 64, 64)))
    elif name == "heavy-tail":
        c = rng.standard_t(2, size=(n, 64, 64)) * 60
    elif name == "stuffing":
        c = np.full((n, 64, 64), -((1 << 20) - 1))
    else:  # wide-mag
        c = rng.integers(-(1 << 22), 1 << 22, size=(n, 64, 64))
    return c.astype(np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense-small", "sparse-1bit", "heavy-tail",
                                  "stuffing", "wide-mag"])
def test_device_coder_identical_on_gpu(gpu_device, case):
    """The HT cleanup coder compiled for the GPU: encode byte-identical to
    the scalar oracle and decode bit-identical, ragged blocks included."""
    rng = np.random.default_rng(99)
    n = 48
    hs = np.full(n, 64, np.int64)
    ws = np.full(n, 64, np.int64)
    hs[1], ws[1] = 33, 47
    hs[2], ws[2] = 64, 5
    coeffs = _hw_case(case, rng, n)
    for i in range(n):
        coeffs[i, hs[i]:, :] = 0
        coeffs[i, :, ws[i]:] = 0
    _check_identical(coeffs, hs, ws)
    _check_decode_identical(coeffs, hs, ws, 64, 64)
