"""ctypes bindings for the native batched T1 coder (native/t1_coder.cpp).

Builds the shared library on first use (g++ -O3 -fopenmp); falls back to the
numpy reference coder if no compiler is available. API mirrors
grok_tpu/t1/ebcot_np.py exactly (bit-identical output by construction).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..core.cpu import tile_threads

def _nthreads(n: int) -> int:
    """0 means 'unset': resolve via the per-tile thread-local cap."""
    return n if n > 0 else tile_threads()


from .ebcot_np import T1EncodeResult

SUPPORTED_STYLES = 0x3F  # all Part-1 codeblock style bits (T.800 Table A-19)

# RLock: the PGO training batch inside _build() re-enters get_lib()
# (via _batch_maxmag's fused min/max probe, which then falls back to
# numpy because _TRIED is already set)
_LOCK = threading.RLock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_SRCS = ["t1_coder.cpp", "ht_coder.cpp", "pipeline.cpp", "t2_codec.cpp",
         "uring_io.cpp"]
_NAME = "libgrok_tpu_native.so"


def _build() -> str | None:
    # GROK_TPU_NATIVE_LIB: load this prebuilt .so instead of building —
    # the hook the sanitizer lane (tools/sanitize_check.sh) uses to run
    # the suite against an ASan/UBSan-instrumented native layer.
    override = os.environ.get("GROK_TPU_NATIVE_LIB")
    if override:
        return override if os.path.exists(override) else None
    import glob

    from ..core import native_build

    srcs = [os.path.join(native_build.NATIVE_DIR, s) for s in _SRCS]
    deps = srcs + glob.glob(os.path.join(native_build.NATIVE_DIR, "*.h"))
    extra = os.environ.get("GROK_TPU_NATIVE_CFLAGS", "").split()
    base = ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17",
            "-ffp-contract=off",  # keep float op-for-op identical to numpy
            "-march=native",  # built at runtime on the machine that runs it
            *extra]
    pgo = os.environ.get("GROK_TPU_PGO", "1") != "0"

    def compile_to(out):
        try:
            r = subprocess.run(base + ["-o", out, *srcs],
                               capture_output=True, text=True, timeout=240)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode != 0:
            from ..core import logging as log

            log.warn("native T1 build failed: %s", r.stderr[-500:])
            return False
        if pgo:
            _try_pgo_upgrade(base, srcs, out)
        return True

    return native_build.build(_NAME, deps, base + ["pgo"] * pgo, compile_to)


def _try_pgo_upgrade(base_cmd, srcs, out) -> bool:
    """Profile-guided rebuild of the native library (best-effort).

    The MQ coder's decision branches are the whole T1 cost and PGO's
    branch-probability layout is worth a measured ~2.5-3% on the photo
    corpus (round-5 A/B) — real margin when the scalar coder is the
    speed of light. Three-stage: instrumented build into a temp dir,
    a synthetic photo-statistics training batch through encode+decode
    via ctypes, then -fprofile-use into the production path. Any failure
    leaves the plain -O3 library in place. Opt out: GROK_TPU_PGO=0.
    """
    import shutil
    import tempfile

    try:
        with tempfile.TemporaryDirectory(prefix="grok_pgo_") as td:
            tmp_so = os.path.join(td, os.path.basename(out))
            prof = os.path.join(td, "prof")
            r = subprocess.run(
                base_cmd + [f"-fprofile-generate={prof}", "-o", tmp_so,
                            *srcs],
                capture_output=True, text=True, timeout=240)
            if r.returncode != 0:
                return False
            lib = ctypes.CDLL(tmp_so)
            bind_t1_abi(lib)
            _pgo_train(lib)
            # flush .gcda from the still-loaded instrumented library
            lib.__gcov_dump()
            r = subprocess.run(
                base_cmd + [f"-fprofile-use={prof}", "-fprofile-correction",
                            "-Wno-missing-profile", "-o", tmp_so, *srcs],
                capture_output=True, text=True, timeout=240)
            if r.returncode != 0:
                return False
            shutil.copy(tmp_so, out)
            return True
    except Exception:
        return False


def _pgo_train(lib) -> None:
    """Run a photo-statistics T1 encode + decode batch through ``lib``."""
    rng = np.random.default_rng(42)
    n, bh, bw = 96, 64, 64
    mag = rng.geometric(0.22, size=(n, bh, bw)).astype(np.int32) - 1
    sgn = rng.integers(0, 2, size=(n, bh, bw))
    coeffs = np.where(sgn > 0, -mag, mag).astype(np.int32)
    h = np.full(n, bh, dtype=np.int64)
    w = np.full(n, bw, dtype=np.int64)
    o = (np.arange(n) % 4).astype(np.int64)
    res = encode_cblks(coeffs, h, w, o, num_threads=1, _lib=lib)
    decode_cblks(res.data, res.lengths, res.numbps, res.npasses, h, w, o,
                 bh, bw, num_threads=1, _lib=lib)


def bind_t1_abi(lib: ctypes.CDLL) -> None:
    """Attach argtypes for the batched-T1 C ABI to ``lib``.

    This pair of entry points IS the loadable T1-accelerator plugin ABI
    (the analogue of the reference's plugin_interface.h block-coder hook):
    any shared library exporting t1_encode_cblks/t1_decode_cblks with
    these signatures can be loaded via t1.load_plugin()."""
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    class _f64p_or_null:
        # out_pass_dist may be NULL: "skip distortion accounting" in the ABI
        @staticmethod
        def from_param(obj):
            if obj is None:
                return ctypes.c_void_p()
            return f64p.from_param(obj)

    lib.t1_encode_cblks.argtypes = [
        i32p, i32p, i32p, i32p, i32p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        u8p, ctypes.c_int64,
        i64p, i32p, i32p, i64p, _f64p_or_null,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.t1_encode_cblks.restype = ctypes.c_int
    if hasattr(lib, "t1_encode_cblks_v2"):
        # v2 = plugin ABI + per-block plane_limits (rate-control skip);
        # optional so third-party T1 plugins keep loading
        lib.t1_encode_cblks_v2.argtypes = [
            i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int64,
            i64p, i32p, i32p, i64p, _f64p_or_null,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.t1_encode_cblks_v2.restype = ctypes.c_int
    lib.t1_decode_cblks.argtypes = [
        u8p, i64p, i32p, i32p, i32p, i32p, i32p, i32p,
        i64p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, i32p, ctypes.c_int32,
    ]
    lib.t1_decode_cblks.restype = ctypes.c_int


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        bind_t1_abi(lib)
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.ht_install_tables.argtypes = [u16p, u16p, u16p, u16p]
        lib.ht_install_tables.restype = ctypes.c_int
        lib.ht_encode_cblks_c.argtypes = [
            i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            u8p, ctypes.c_int64, i64p, i32p, f64p, ctypes.c_int32,
        ]
        lib.ht_encode_cblks_c.restype = ctypes.c_int
        lib.ht_decode_cblks_c.argtypes = [
            u8p, i64p, i32p, i32p, i32p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, i32p, ctypes.c_int32,
        ]
        lib.ht_decode_cblks_c.restype = ctypes.c_int
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.ht_stuff_words.argtypes = [
            u32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, u8p, i64p, u32p, i32p, u8p, ctypes.c_int32,
        ]
        lib.ht_stuff_words.restype = ctypes.c_int
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        dwt_args = [ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_int32]
        for nm in ("dwt53_forward", "dwt53_inverse"):
            getattr(lib, nm).argtypes = [i32p] + dwt_args
            getattr(lib, nm).restype = ctypes.c_int
        for nm in ("dwt97_forward", "dwt97_inverse"):
            getattr(lib, nm).argtypes = [f32p] + dwt_args
            getattr(lib, nm).restype = ctypes.c_int
        lib.quant_bands.argtypes = [
            f32p, i32p, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, f32p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.quant_bands.restype = ctypes.c_int
        lib.dequant_bands.argtypes = [
            i32p, f32p, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, f32p, ctypes.c_int32,
        ]
        lib.dequant_bands.restype = ctypes.c_int
        lib.roi_unshift.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32]
        lib.roi_unshift.restype = ctypes.c_int
        lib.finish_irrev.argtypes = [f32p, i32p, ctypes.c_int64,
                                     ctypes.c_float, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32]
        lib.finish_irrev.restype = ctypes.c_int
        lib.finish_rev.argtypes = [i32p, i32p, ctypes.c_int64,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32]
        lib.finish_rev.restype = ctypes.c_int
        lib.rct_finish.argtypes = [i32p, i32p, i32p, i32p, i32p, i32p,
                                   ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32]
        lib.rct_finish.restype = ctypes.c_int
        lib.ict_finish.argtypes = [f32p, f32p, f32p, i32p, i32p, i32p,
                                   ctypes.c_int64, ctypes.c_float,
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32]
        lib.ict_finish.restype = ctypes.c_int
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        lib.hull_slopes.argtypes = [i64p, f64p, i32p, i64, i32, f64p, i32]
        lib.hull_slopes.restype = ctypes.c_int
        lib.gather_segments.argtypes = [u8p, i32p, i64p, i64p, i64,
                                        u8p, i64, i64p]
        lib.gather_segments.restype = ctypes.c_int
        lib.merge_contrib_segments.argtypes = [i32p, i64p, i64p, i64,
                                               i32p, i64p, i64, i64p, i32]
        lib.merge_contrib_segments.restype = ctypes.c_int
        lib.scatter_rows.argtypes = [i32p, i32, i32, i32p, i64, i32p, i32p,
                                     i32p, i32p, i32p, i32, i32]
        lib.scatter_rows.restype = ctypes.c_int
        lib.scatter_rows_dequant.argtypes = [i32p, i32, i32, i32p, i64, i32p,
                                             i32p, i32p, i32p, f32p, f32p,
                                             i32, i32]
        lib.scatter_rows_dequant.restype = ctypes.c_int
        lib.gather_rows.argtypes = [i32p, i32, i32p, i64, i32p, i32p,
                                    i32p, i32p, i32p, i32, i32, i32]
        lib.gather_rows.restype = ctypes.c_int
        lib.rct_dc_forward.argtypes = [i32p, i32p, i32p, i32p, i32p, i32p,
                                       i64, i32, i32, i32, i32]
        lib.rct_dc_forward.restype = ctypes.c_int
        lib.minmax_i32.argtypes = [i32p, i64, i32p, i32]
        lib.minmax_i32.restype = ctypes.c_int
        lib.rct_inverse_c.argtypes = [i32p, i32p, i32p, i32p, i32p, i32p,
                                      i64, i32]
        lib.rct_inverse_c.restype = ctypes.c_int
        f32p2 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.ict_dc_forward.argtypes = [i32p, i32p, i32p, f32p2, f32p2, f32p2,
                                       i64, i32, i32, i32, i32]
        lib.ict_dc_forward.restype = ctypes.c_int
        lib.ict_inverse_c.argtypes = [f32p2, f32p2, f32p2, f32p2, f32p2,
                                      f32p2, i64, i32]
        lib.ict_inverse_c.restype = ctypes.c_int
        lib.t2_encode_packets.argtypes = [
            i32, i32p, i32p, i32p,
            i32, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p,
            i64, u8p, i64, i32,
            i64p, i32, i32p, i32p, i32p,
            i64p, i32,
            i32, i32, i32, i32, i32,
            u8p, i64, i64p, u8p, i64, i64p, i64p, i64p,
        ]
        lib.t2_encode_packets.restype = ctypes.c_int
        lib.t2_decode_packets.argtypes = [
            u8p, i64,
            i32, i32p, i32p, i32p, i32,
            i32, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
            i32, i32,
            u8p, i64, i32,
            i32, i64p, i32p, i64p,
            i32p, i32p, i64p, i64p, i64, i64p,
            i32p, i64p,
        ]
        lib.t2_decode_packets.restype = ctypes.c_int
        u64pp = ctypes.POINTER(ctypes.c_uint64)
        lib.uring_writer_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.uring_writer_create.restype = ctypes.c_void_p
        lib.uring_writer_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i64, i64, ctypes.c_uint64,
        ]
        lib.uring_writer_write.restype = ctypes.c_int
        lib.uring_writer_reap.argtypes = [
            ctypes.c_void_p, u64pp, ctypes.c_int, ctypes.c_int,
        ]
        lib.uring_writer_reap.restype = ctypes.c_int
        lib.uring_writer_drain.argtypes = [
            ctypes.c_void_p, u64pp, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.uring_writer_drain.restype = ctypes.c_int
        lib.uring_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.uring_writer_destroy.restype = None
        _install_ht_tables(lib)
        _LIB = lib
        return _LIB


def _install_ht_tables(lib) -> None:
    from .ht import DEC_TBL, ENC_TBL

    enc0 = np.asarray(ENC_TBL[0], dtype=np.uint16)
    enc1 = np.asarray(ENC_TBL[1], dtype=np.uint16)

    def pack_dec(tbl):
        out = np.zeros((8, 128), dtype=np.uint16)  # 0 = invalid (len 0 never occurs)
        for cq in range(8):
            for v in range(128):
                e = tbl[cq][v]
                if e is None:
                    continue
                rho, u_off, e_k, e_1, ln = e
                out[cq, v] = rho | (u_off << 4) | (e_k << 5) | (e_1 << 9) | (ln << 13)
        return out.reshape(-1)

    lib.ht_install_tables(enc0, enc1, pack_dec(DEC_TBL[0]), pack_dec(DEC_TBL[1]))


def _batch_maxmag(coeffs) -> int:
    """max |coeff| over the whole batch: one fused native OMP pass when the
    main lib is available (numpy .max()+.min() costs two single-threaded
    sweeps). Always uses get_lib() — a caller's T1 plugin library has no
    bound argtypes for the helper symbols."""
    lib = get_lib()
    if lib is not None:
        mm = np.zeros(2, dtype=np.int32)
        lib.minmax_i32(coeffs.reshape(-1), coeffs.size, mm, 0)
        return int(max(int(mm[1]), -int(mm[0])))
    return int(max(coeffs.max(initial=0), -int(coeffs.min(initial=0))))


def ht_encode_cblks(coeffs, heights, widths, orients, num_threads: int = 0):
    from .ebcot_np import T1EncodeResult

    lib = get_lib()
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    n, h, w = coeffs.shape
    maxmag = _batch_maxmag(coeffs)
    bytes_per_sample = (2 * maxmag).bit_length() // 8 + 2
    max_bytes = max(256, h * w * bytes_per_sample + (h * w) // 2 + 64)
    # np.empty: consumers only read data[i, :lengths[i]], all coder-written
    data = np.empty((n, max_bytes), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    numbps = np.zeros(n, dtype=np.int32)
    dist = np.zeros(n, dtype=np.float64)
    lib.ht_encode_cblks_c(
        coeffs,
        np.ascontiguousarray(heights, dtype=np.int32),
        np.ascontiguousarray(widths, dtype=np.int32),
        n, h, w, data, max_bytes, lengths, numbps, dist, _nthreads(num_threads),
    )
    npasses = np.where(numbps > 0, 1, 0).astype(np.int64)
    return T1EncodeResult(
        data=data,
        raw_data=(data, 0),
        lengths=lengths,
        numbps=numbps.astype(np.int64),
        npasses=npasses,
        pass_rates=lengths[:, None].copy(),
        pass_dist=dist[:, None].copy(),
    )


def ht_decode_cblks(data, lengths, numbps, npasses, heights, widths, orients,
                    block_h, block_w, num_threads: int = 0):
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    # np.empty: the native decoder clears/writes every block's dst plane
    out = np.empty((n, block_h, block_w), dtype=np.int32)
    rc = lib.ht_decode_cblks_c(
        data,
        np.ascontiguousarray(lengths, dtype=np.int64),
        np.ascontiguousarray(npasses, dtype=np.int32),
        np.ascontiguousarray(heights, dtype=np.int32),
        np.ascontiguousarray(widths, dtype=np.int32),
        n, block_h, block_w, data.shape[1], out, _nthreads(num_threads),
    )
    if rc != 0:
        from ..core import logging as log

        log.warn("HT decode reported block errors")
    planes = np.asarray(numbps, dtype=np.int64).copy()
    return out, planes


_STUFF_KIND = {"ms": 0, "mel": 1, "vlc": 2}


def ht_stuff_words(words, totals, kind, num_threads: int = 0):
    """Host byte-stuffing of device-packed bit streams (see ht_coder.cpp
    ht_stuff_words): returns (bytes [n, cap], n_emit, partial, rem, fprev)
    with the same semantics the on-device fixpoint produced."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native lib unavailable (ht_stuff_words)")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    totals = np.ascontiguousarray(totals, dtype=np.int64)
    n, nw = words.shape
    cap = nw * 32 // 7 + 2
    # np.empty: only the emitted prefix is written and read
    out = np.empty((n, cap), dtype=np.uint8)
    n_emit = np.zeros(n, dtype=np.int64)
    partial = np.zeros(n, dtype=np.uint32)
    rem = np.zeros(n, dtype=np.int32)
    fprev = np.zeros(n, dtype=np.uint8)
    lib.ht_stuff_words(words, nw, totals, n, _STUFF_KIND[kind], cap, out,
                       n_emit, partial, rem, fprev, _nthreads(num_threads))
    return out, n_emit, partial, rem, fprev


def available() -> bool:
    return get_lib() is not None


def encode_cblks(
    coeffs: np.ndarray,
    heights: np.ndarray,
    widths: np.ndarray,
    orients: np.ndarray,
    num_threads: int = 0,
    styles: np.ndarray | None = None,
    want_dist: bool = True,
    plane_limits: np.ndarray | None = None,
    _lib: ctypes.CDLL | None = None,
) -> T1EncodeResult:
    lib = _lib if _lib is not None else get_lib()
    assert lib is not None
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    n, h, w = coeffs.shape
    heights32 = np.ascontiguousarray(heights, dtype=np.int32)
    widths32 = np.ascontiguousarray(widths, dtype=np.int32)
    orients32 = np.ascontiguousarray(orients, dtype=np.int32)
    styles32 = np.ascontiguousarray(
        styles if styles is not None else np.zeros(n), dtype=np.int32
    )
    limits32 = None
    if plane_limits is not None and hasattr(lib, "t1_encode_cblks_v2"):
        limits32 = np.ascontiguousarray(plane_limits, dtype=np.int32)

    # worst-case magnitude bitplanes bound the buffer/pass sizes
    # (one fused OMP min/max pass; numpy .max()+.min() costs two
    # single-threaded sweeps of a multi-hundred-MB batch)
    maxmag = _batch_maxmag(coeffs)
    pmax = maxmag.bit_length()
    max_passes = max(3 * pmax - 2, 1)
    max_bytes = max(64, (pmax * h * w) // 4 + 128)

    # np.empty: consumers only read data[i, :lengths[i]], all coder-written
    data = np.empty((n, max_bytes), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    numbps = np.zeros(n, dtype=np.int32)
    npasses = np.zeros(n, dtype=np.int32)
    rates = np.zeros((n, max_passes), dtype=np.int64)
    dists = np.zeros((n, max_passes), dtype=np.float64)
    dists_arg = dists if want_dist else None  # NULL = skip dist accounting

    def _call(data, max_bytes, lengths):
        if limits32 is not None:
            lib.t1_encode_cblks_v2(
                coeffs, heights32, widths32, orients32, styles32, limits32,
                n, h, w, data, max_bytes,
                lengths, numbps, npasses, rates, dists_arg,
                max_passes, _nthreads(num_threads),
            )
        else:
            lib.t1_encode_cblks(
                coeffs, heights32, widths32, orients32, styles32,
                n, h, w, data, max_bytes,
                lengths, numbps, npasses, rates, dists_arg,
                max_passes, _nthreads(num_threads),
            )

    _call(data, max_bytes, lengths)
    if (lengths < 0).any():
        # the coder flagged a buffer overflow (heuristic bound exceeded):
        # retry once with a provably sufficient worst-case bound
        # (< 2 coded bits/sample/pass after stuffing => pmax*h*w bytes)
        max_bytes = max(max_bytes * 4, pmax * h * w + 256)
        data = np.empty((n, max_bytes), dtype=np.uint8)
        lengths[:] = 0
        _call(data, max_bytes, lengths)
        if (lengths < 0).any():
            from ..core.errors import GrokTpuError

            raise GrokTpuError("T1 encode: codeword buffer overflow")
    # drop the per-lane virtual carry byte so data[i][:length] is the segment
    return T1EncodeResult(
        data=data[:, 1:],
        raw_data=(data, 1),
        lengths=lengths,
        numbps=numbps.astype(np.int64),
        npasses=npasses.astype(np.int64),
        pass_rates=rates,
        pass_dist=dists,
    )


def decode_cblks(
    data: np.ndarray,
    lengths: np.ndarray,
    numbps: np.ndarray,
    npasses: np.ndarray,
    heights: np.ndarray,
    widths: np.ndarray,
    orients: np.ndarray,
    block_h: int,
    block_w: int,
    num_threads: int = 0,
    styles: np.ndarray | None = None,
    seg_lengths: np.ndarray | None = None,
    _lib: ctypes.CDLL | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    lib = _lib if _lib is not None else get_lib()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.shape[0]
    # np.empty: the native decoder clears/writes every block's dst plane
    out = np.empty((n, block_h, block_w), dtype=np.int32)
    if seg_lengths is None:
        seg_lengths = np.zeros((n, 1), dtype=np.int64)
    seg_lengths = np.ascontiguousarray(seg_lengths, dtype=np.int64)
    lib.t1_decode_cblks(
        data,
        np.ascontiguousarray(lengths, dtype=np.int64),
        np.ascontiguousarray(numbps, dtype=np.int32),
        np.ascontiguousarray(npasses, dtype=np.int32),
        np.ascontiguousarray(heights, dtype=np.int32),
        np.ascontiguousarray(widths, dtype=np.int32),
        np.ascontiguousarray(orients, dtype=np.int32),
        np.ascontiguousarray(
            styles if styles is not None else np.zeros(n), dtype=np.int32
        ),
        seg_lengths, seg_lengths.shape[1],
        n, block_h, block_w, data.shape[1], out, _nthreads(num_threads),
    )
    planes = np.minimum((np.asarray(npasses) + 2) // 3, np.asarray(numbps))
    return out, planes
