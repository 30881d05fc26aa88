"""Public C ABI (native/grok_tpu_c.h): in-process ctypes drive + a real
embedded-from-C host program.

Parity target: the reference's grok.h C API (ref-counted image objects,
buffer compress/decompress, stream write callback, message handlers).
"""

import ctypes
import os
import subprocess
import sysconfig

import numpy as np
import pytest

import grok_tpu as gk
from grok_tpu import capi


lib = capi.get_lib()
pytestmark = pytest.mark.skipif(lib is None, reason="C API lib unavailable")


def _fill_image(rng, h, w, nc):
    img = lib.gktpu_image_create(w, h, nc, 8, 0)
    assert img
    data = rng.integers(0, 256, size=(nc, h, w)).astype(np.int32)
    for c in range(nc):
        ptr = lib.gktpu_image_comp_data(img, c)
        ctypes.memmove(ptr, data[c].ctypes.data, data[c].nbytes)
    return img, data


def test_compress_decompress_roundtrip():
    rng = np.random.default_rng(17)
    h, w, nc = 120, 150, 3
    img, data = _fill_image(rng, h, w, nc)

    p = capi.CParams()
    lib.gktpu_cparams_default(ctypes.byref(p))
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.gktpu_compress(img, ctypes.byref(p), ctypes.byref(out),
                            ctypes.byref(out_len))
    assert rc == 0, lib.gktpu_last_error().decode()
    stream = bytes(bytearray(out[: out_len.value]))
    lib.gktpu_free(out)
    lib.gktpu_image_unref(img)

    # the C stream matches the Python API byte-for-byte
    arr = np.transpose(data, (1, 2, 0))
    ref = gk.compress(gk.Image.from_array(arr), gk.CompressParams())
    assert stream == ref

    dp = capi.DParams()
    lib.gktpu_dparams_default(ctypes.byref(dp))
    buf = (ctypes.c_uint8 * len(stream)).from_buffer_copy(stream)
    dec = lib.gktpu_decompress(buf, len(stream), ctypes.byref(dp))
    assert dec, lib.gktpu_last_error().decode()
    assert lib.gktpu_image_width(dec) == w
    assert lib.gktpu_image_height(dec) == h
    assert lib.gktpu_image_num_comps(dec) == nc
    for c in range(nc):
        ptr = lib.gktpu_image_comp_data(dec, c)
        got = np.ctypeslib.as_array(ptr, shape=(h, w)).copy()
        assert np.array_equal(got, data[c])
    # refcounting: extra ref keeps it alive through one unref
    lib.gktpu_image_ref(dec)
    lib.gktpu_image_unref(dec)
    assert lib.gktpu_image_width(dec) == w
    lib.gktpu_image_unref(dec)


def test_jp2_and_reduced_decode():
    rng = np.random.default_rng(23)
    h, w = 160, 140
    img, data = _fill_image(rng, h, w, 3)
    p = capi.CParams()
    lib.gktpu_cparams_default(ctypes.byref(p))
    p.jp2 = 1
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    assert lib.gktpu_compress(img, ctypes.byref(p), ctypes.byref(out),
                              ctypes.byref(out_len)) == 0
    stream = bytes(bytearray(out[: out_len.value]))
    lib.gktpu_free(out)
    lib.gktpu_image_unref(img)
    assert stream[:4] == b"\x00\x00\x00\x0c"  # JP2 signature box

    dp = capi.DParams()
    lib.gktpu_dparams_default(ctypes.byref(dp))
    dp.reduce = 1
    buf = (ctypes.c_uint8 * len(stream)).from_buffer_copy(stream)
    dec = lib.gktpu_decompress(buf, len(stream), ctypes.byref(dp))
    assert dec, lib.gktpu_last_error().decode()
    assert lib.gktpu_image_width(dec) == (w + 1) // 2
    assert lib.gktpu_image_height(dec) == (h + 1) // 2
    lib.gktpu_image_unref(dec)


def test_decompress_error_reporting():
    dp = capi.DParams()
    lib.gktpu_dparams_default(ctypes.byref(dp))
    junk = (ctypes.c_uint8 * 16).from_buffer_copy(b"not a codestream")
    dec = lib.gktpu_decompress(junk, 16, ctypes.byref(dp))
    assert not dec
    assert lib.gktpu_last_error().decode() != ""


C_HOST = r"""
#include "grok_tpu_c.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static size_t sink_write(const uint8_t* d, size_t n, void* user) {
    *(size_t*)user += n;
    return n;
}

int main(void) {
    if (gktpu_initialize()) { fprintf(stderr, "init: %s\n", gktpu_last_error()); return 1; }
    const uint32_t w = 96, h = 80;
    gktpu_image* img = gktpu_image_create(w, h, 1, 8, 0);
    if (!img) return 2;
    int32_t* px = gktpu_image_comp_data(img, 0);
    for (uint32_t i = 0; i < w * h; i++) px[i] = (int32_t)((i * 2654435761u) >> 24);

    gktpu_cparams cp; gktpu_cparams_default(&cp);
    uint8_t* buf = NULL; size_t len = 0;
    if (gktpu_compress(img, &cp, &buf, &len)) { fprintf(stderr, "compress: %s\n", gktpu_last_error()); return 3; }

    size_t streamed = 0;
    if (gktpu_compress_stream(img, &cp, sink_write, &streamed)) return 4;
    if (streamed != len) { fprintf(stderr, "stream len %zu != %zu\n", streamed, len); return 5; }

    gktpu_dparams dp; gktpu_dparams_default(&dp);
    gktpu_image* dec = gktpu_decompress(buf, len, &dp);
    if (!dec) { fprintf(stderr, "decompress: %s\n", gktpu_last_error()); return 6; }
    const int32_t* out = gktpu_image_comp_data(dec, 0);
    for (uint32_t i = 0; i < w * h; i++)
        if (out[i] != px[i]) { fprintf(stderr, "pixel %u: %d != %d\n", i, out[i], px[i]); return 7; }

    gktpu_free(buf);
    gktpu_image_unref(dec);
    gktpu_image_unref(img);
    gktpu_deinitialize();
    printf("C-HOST-OK %zu bytes\n", len);
    return 0;
}
"""


def test_embedded_c_host(tmp_path):
    """Compile a pure-C host against the header, embedding Python from C."""
    native = os.path.abspath(os.path.join(os.path.dirname(capi.__file__),
                                          "..", "native"))
    libdir = os.path.dirname(capi.build())
    src = tmp_path / "host.c"
    src.write_text(C_HOST)
    exe = tmp_path / "host"
    r = subprocess.run(
        ["gcc", "-O1", str(src), "-o", str(exe), f"-I{native}",
         f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-lgrok_tpu_c"],
        capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "C-HOST-OK" in r.stdout
