"""Build driver + ctypes bindings for the public C ABI (native/capi.cpp).

The C API (native/grok_tpu_c.h) is the framework's answer to the
reference's public C interface (grok.h: ref-counted grk_image objects,
stream write callbacks, message handlers). It embeds the Python runtime
when hosted by a C program and attaches to the running interpreter when
loaded from Python — the binding below is both the self-test harness and
a convenience for Python hosts that want the stable ABI surface.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_NAME = "libgrok_tpu_c.so"


def build() -> str | None:
    """Build libgrok_tpu_c.so unless a matching one exists (see
    core/native_build.py); returns its path (None: no g++)."""
    from .core import native_build

    src = os.path.join(native_build.NATIVE_DIR, "capi.cpp")
    hdr = os.path.join(native_build.NATIVE_DIR, "grok_tpu_c.h")
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    pyver = f"python{sysconfig.get_config_var('py_version_short')}"
    cmd = [
        "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
        f"-I{inc}", src,
        f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{pyver}", "-ldl",
    ]

    def compile_to(out):
        try:
            r = subprocess.run(cmd + ["-o", out], capture_output=True,
                               text=True, timeout=240)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode != 0:
            from .core import logging as log

            log.warn("C API build failed: %s", r.stderr[-800:])
            return False
        return True

    return native_build.build(_NAME, [src, hdr], cmd, compile_to)


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) and bind the C ABI."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        c = ctypes
        lib.gktpu_initialize.restype = c.c_int
        lib.gktpu_version.restype = c.c_char_p
        lib.gktpu_last_error.restype = c.c_char_p
        lib.gktpu_image_create.restype = c.c_void_p
        lib.gktpu_image_create.argtypes = [c.c_uint32] * 3 + [
            c.c_uint32, c.c_int32]
        lib.gktpu_image_ref.argtypes = [c.c_void_p]
        lib.gktpu_image_unref.argtypes = [c.c_void_p]
        for nm in ("width", "height", "num_comps", "prec"):
            fn = getattr(lib, f"gktpu_image_{nm}")
            fn.restype = c.c_uint32
            fn.argtypes = [c.c_void_p]
        lib.gktpu_image_sgnd.restype = c.c_int32
        lib.gktpu_image_sgnd.argtypes = [c.c_void_p]
        lib.gktpu_image_comp_data.restype = c.POINTER(c.c_int32)
        lib.gktpu_image_comp_data.argtypes = [c.c_void_p, c.c_uint32]
        lib.gktpu_cparams_default.argtypes = [c.c_void_p]
        lib.gktpu_dparams_default.argtypes = [c.c_void_p]
        lib.gktpu_compress.restype = c.c_int
        lib.gktpu_compress.argtypes = [
            c.c_void_p, c.c_void_p,
            c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_size_t),
        ]
        lib.gktpu_decompress.restype = c.c_void_p
        lib.gktpu_decompress.argtypes = [
            c.POINTER(c.c_uint8), c.c_size_t, c.c_void_p]
        lib.gktpu_free.argtypes = [c.c_void_p]
        lib.gktpu_set_msg_handlers.restype = c.c_int
        _LIB = lib
        return _LIB


class CParams(ctypes.Structure):
    _fields_ = [
        ("num_resolutions", ctypes.c_uint32),
        ("cblk_w", ctypes.c_uint32),
        ("cblk_h", ctypes.c_uint32),
        ("irreversible", ctypes.c_int32),
        ("ht", ctypes.c_int32),
        ("mct", ctypes.c_int32),
        ("num_layers", ctypes.c_uint32),
        ("layer_rates", ctypes.c_double * 16),
        ("progression", ctypes.c_char * 8),
        ("tile_w", ctypes.c_uint32),
        ("tile_h", ctypes.c_uint32),
        ("jp2", ctypes.c_int32),
        ("cblk_style", ctypes.c_uint32),
    ]


class DParams(ctypes.Structure):
    _fields_ = [
        ("reduce", ctypes.c_uint32),
        ("layers", ctypes.c_int32),
        ("tile", ctypes.c_int32),
        ("win_x0", ctypes.c_uint32),
        ("win_y0", ctypes.c_uint32),
        ("win_x1", ctypes.c_uint32),
        ("win_y1", ctypes.c_uint32),
    ]
