"""Raster-format envelope matrix.

Pins exactly which format x bit-depth x layout combinations round-trip
through io/formats.py, so the capability envelope is a test, not a
guess. The native strip TIFF codec (io/tiff.py, parity:
/root/reference/src/bin/image_format/TIFFFormat.cpp) covers the
Cinema/IMF combos PIL cannot (16-bit multi-sample, planar, big-endian);
everything else is documented by SUPPORTED below.
"""

import os

import numpy as np
import pytest

import grok_tpu as gk
from grok_tpu.io import formats, tiff


def _arr(rng, h, w, nc, prec):
    a = rng.integers(0, 1 << prec, (h, w, nc)).astype(np.int32)
    return a[:, :, 0] if nc == 1 else a


# ---------------------------------------------------------------- native TIFF
@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("spp", [1, 3, 4])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("be", [False, True])
def test_tiff_native_matrix(tmp_path, bps, spp, planar, be):
    rng = np.random.default_rng(bps * 100 + spp * 10 + planar)
    a = rng.integers(0, 1 << bps, (37, 53, spp)).astype(np.int32)
    p = str(tmp_path / "t.tif")
    tiff.write(p, a, bps=bps, planar=planar, big_endian=be,
               rows_per_strip=7)
    b, info = tiff.read(p)
    assert np.array_equal(a, b)
    assert info.planar == planar and info.bps == bps and info.spp == spp


def test_tiff_streaming_strips_feed_strip_compressor(tmp_path):
    """iter_strips -> StripCompressor must equal whole-image compress."""
    rng = np.random.default_rng(5)
    h, w = 130, 160
    a = rng.integers(0, 1 << 16, (h, w, 3)).astype(np.int32)
    p = str(tmp_path / "s.tif")
    tiff.write(p, a, bps=16, planar=2, rows_per_strip=24)  # planar source

    params = gk.CompressParams(num_resolutions=4, tile_size=(64, 64))
    dst = str(tmp_path / "out.j2k")
    info = tiff.read_info(p)
    sc = gk.StripCompressor(dst, info.width, info.height, info.spp,
                            prec=16, params=params)
    for chunk in tiff.iter_strips(p, info):
        sc.push(chunk)
    sc.close()

    im = gk.Image.from_array(a, prec=16)
    ref = gk.compress(im, gk.CompressParams(num_resolutions=4,
                                            tile_size=(64, 64)))
    assert open(dst, "rb").read() == ref


def test_tiff_16bit_rgb_codec_pipeline(tmp_path):
    """BASELINE config 3 front door: 16-bit RGB TIFF in -> HT encode ->
    decode -> 16-bit RGB TIFF out, all bit-exact."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1 << 16, (64, 80, 3)).astype(np.int32)
    src = str(tmp_path / "in.tif")
    tiff.write(src, a, bps=16)
    img = formats.load_image(src)
    assert img.components[0].prec == 16
    stream = gk.compress(img, gk.CompressParams(num_resolutions=4, ht=True))
    out = gk.decompress(stream)
    assert np.array_equal(out.to_array(), a)
    dst = str(tmp_path / "out.tif")
    formats.save_image(dst, out)
    b, _ = tiff.read(dst)
    assert np.array_equal(b, a)


# ------------------------------------------------------------- format matrix
# (format, nc, prec) -> supported round-trip through save_image/load_image.
# False rows are DOCUMENTED exclusions (PIL-backed formats without a
# native path for that depth/layout).
SUPPORTED = {
    ("tif", 1, 8): True, ("tif", 3, 8): True, ("tif", 4, 8): True,
    ("tif", 1, 16): True, ("tif", 3, 16): True, ("tif", 4, 16): True,
    ("png", 1, 8): True, ("png", 3, 8): True, ("png", 4, 8): True,
    ("png", 1, 16): True,
    ("png", 3, 16): False,  # PIL has no 16-bit RGB PNG write mode
    ("bmp", 1, 8): True, ("bmp", 3, 8): True,
    ("bmp", 3, 16): False,  # BMP has no 16-bit/sample layout
    ("pgm", 1, 8): True, ("pgm", 1, 16): True,
    ("ppm", 3, 8): True, ("ppm", 3, 16): True,
    ("pgx", 1, 8): True, ("pgx", 1, 16): True,
}


@pytest.mark.parametrize("fmt,nc,prec",
                         sorted(SUPPORTED), ids=lambda v: str(v))
def test_format_matrix(tmp_path, fmt, nc, prec):
    ok = SUPPORTED[(fmt, nc, prec)]
    rng = np.random.default_rng(hash((fmt, nc, prec)) % (2 ** 31))
    a = _arr(rng, 23, 31, nc, prec)
    img = gk.Image.from_array(a, prec=prec)
    p = str(tmp_path / f"m.{fmt}")
    if not ok:
        with pytest.raises(Exception):
            formats.save_image(p, img)
            back = formats.load_image(p)
            want = a if a.ndim == 3 else a[:, :, None]
            assert np.array_equal(back.to_array(), want)
        return
    formats.save_image(p, img)
    back = formats.load_image(p)
    want = a if a.ndim == 3 else a[:, :, None]
    assert np.array_equal(back.to_array(), want)
