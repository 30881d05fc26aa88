#!/usr/bin/env python
"""Smoke test of the device codec path on one NVIDIA GPU.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # the tile mesh and 4 processes only

One process drives one card. It fails (non-zero exit, no result line) when
JAX's first device is not a GPU: nothing here falls back to the CPU.
Phases, each printing one line:

1. device: JAX's device kind and count, and the card's name and power
   limit from nvidia-smi (a child process that does not import JAX);
2. set-up: native library build, compile cache directory, and the XLA
   compilations (count, seconds, cache hits) of the warm-up calls;
3. codec: lossless53, lossy97_1bpp and ht_lossless on 3840x2160x3 8-bit
   natural and photo frames through gk.compress / gk.decompress with the
   device path on, against the host path in the same process;
4. ht coverage: every codeblock of the HT phase was coded on the device;
5. cli: grok_tpu.cli.compress / decompress on a 4K PPM, in-process;
6. ebcot_jax: the lax Part-1 coder on real 64x64 codeblocks of the frame,
   bit-exact against the native coder;
7. fma: the 9/7 gray, RGB-ICT and custom-MCT chains at 4K, device
   against host;
8. gpu tests: the pytest tests marked ``gpu``.

The last line is the JSON result. With ``--four-cards`` the script runs
only the four-card paths (tile-sharded mesh encode/decode, and
tools/multihost_run.py with one process per card) against one-card
gk.compress / gk.decompress; this process then stays off JAX so that each
card has one process at a time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the repo's frame generators)
import grok_tpu as gk  # noqa: E402

H, W = 2160, 3840
CONFIGS = {
    "lossless53": dict(num_resolutions=6),
    "lossy97_1bpp": dict(num_resolutions=6, irreversible=True, num_layers=1,
                         layer_rates=[8]),
    "ht_lossless": dict(num_resolutions=6, ht=True),
}
_SWITCHES = ("GROK_TPU_DEVICE", "GROK_TPU_T1", "GROK_TPU_TRACE")
EBCOT_BLOCKS = 512


class PhaseError(AssertionError):
    """A phase's check failed."""


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def emit(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=_jsonable), flush=True)


def _jsonable(v):
    if isinstance(v, np.generic):
        return v.item()
    return str(v)


@contextlib.contextmanager
def codec_env(device: bool, cfg: str = "", trace: bool = False):
    """Device path switches on (GROK_TPU_DEVICE=jax, plus
    GROK_TPU_T1=ht-device for HT) or all off; restored afterwards."""
    saved = {k: os.environ.get(k) for k in _SWITCHES}
    for k in _SWITCHES:
        os.environ.pop(k, None)
    if device:
        os.environ["GROK_TPU_DEVICE"] = "jax"
        if cfg.startswith("ht"):
            os.environ["GROK_TPU_T1"] = "ht-device"
    if trace:
        os.environ["GROK_TPU_TRACE"] = "1"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def frames(h=H, w=W):
    return {"natural": bench.natural_image(h, w, 3),
            "photo": bench.photo_image(h, w, 3)}


def params(cfg, **over):
    return gk.CompressParams(**{**CONFIGS[cfg], **over})


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def psnr(a, ref):
    mse = float(np.mean((a.astype(np.float64) - ref) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class CompileLog:
    """XLA compilations seen through jax.monitoring: count, seconds and
    persistent-cache hits since the last ``take()``."""

    def __init__(self):
        import jax
        from jax._src import dispatch

        self.event = dispatch.BACKEND_COMPILE_EVENT
        self.count = self.seconds = self.hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._ev)

    def _dur(self, event, duration, **_):
        if event == self.event:
            self.count += 1
            self.seconds += duration

    def _ev(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def take(self):
        out = {"compiles": self.count, "compile_s": round(self.seconds, 3),
               "cache_hits": self.hits}
        self.count = self.seconds = self.hits = 0
        return out


# ----------------------------------------------------------------- phases
def nvidia_smi():
    """Name and power limit of each card, from a child that does not
    import JAX."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise PhaseError(f"nvidia-smi failed: {e}") from e
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()


def phase_device():
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    emit("device", **info, nvidia_smi=nvidia_smi())
    return info


def warm_up(frames_by_name):
    """First call of every configuration on every frame, device path on:
    builds the native library and compiles every device program."""
    from grok_tpu.t1 import native

    _, t_native = timed(native.get_lib)
    t0 = time.perf_counter()
    for cfg in CONFIGS:
        p = params(cfg)
        for arr in frames_by_name.values():
            with codec_env(True, cfg):
                stream = gk.compress(gk.Image.from_array(arr), p)
                gk.decompress(stream)
    return {"native_build_s": round(t_native, 3),
            "warm_up_s": round(time.perf_counter() - t0, 3)}


def phase_codec(cfg, arr):
    """Device path against host path for one configuration and frame."""
    from grok_tpu.core import trace

    im = gk.Image.from_array(arr)
    p = params(cfg)
    with codec_env(False):
        host, t_host_enc = timed(lambda: gk.compress(im, p))
        host_dec, t_host_dec = timed(lambda: gk.decompress(host).to_array())
    with codec_env(True, cfg, trace=True):
        trace.reset()
        dev, t_enc = timed(lambda: gk.compress(im, p))
        dev_dec, t_dec = timed(lambda: gk.decompress(dev).to_array())
        spans = {r["stage"]: round(r["ms"] / 1e3, 4) for r in trace.rows()
                 if r["stage"] in ("enc.device_fwd", "dec.device_inv")}
        cross_dec = gk.decompress(host).to_array()
        trace.reset()
    res = {"enc_s": round(t_enc, 3), "dec_s": round(t_dec, 3),
           "host_enc_s": round(t_host_enc, 3),
           "host_dec_s": round(t_host_dec, 3),
           "spans_s": spans, "bytes": len(dev),
           "stream_identical": dev == host}
    check(spans.get("enc.device_fwd") and spans.get("dec.device_inv"),
          f"{cfg}: the device transform spans did not run: {spans}")
    if cfg == "lossy97_1bpp":
        res.update(_diff_stats(host_dec, cross_dec, arr))
        check(res["max_d"] <= 1, f"{cfg}: device decode off by "
              f"{res['max_d']} LSB")
    else:
        check(res["stream_identical"], f"{cfg}: device stream differs")
        check(np.array_equal(dev_dec, arr), f"{cfg}: lossless decode")
        check(np.array_equal(cross_dec, host_dec),
              f"{cfg}: device decode of the host stream")
    return res


def _diff_stats(host_dec, dev_dec, ref):
    d = np.abs(host_dec.astype(np.int64) - dev_dec.astype(np.int64))
    return {"samples_differ": int(np.count_nonzero(d)),
            "max_d": int(d.max(initial=0)),
            "dpsnr_db": round(psnr(dev_dec, ref) - psnr(host_dec, ref), 6)}


def phase_ht_coverage(arr):
    """HT encode and decode of ``arr`` with every block on the device."""
    from grok_tpu.t1 import ht_jax, ht_jax_dec

    ht_jax.reset_stats()
    ht_jax_dec.reset_stats()
    with codec_env(True, "ht_lossless"):
        stream = gk.compress(gk.Image.from_array(arr), params("ht_lossless"))
        gk.decompress(stream)
    res = {"enc_device_blocks": ht_jax.STATS["blocks"],
           "enc_host_blocks": ht_jax.STATS["host_blocks"],
           "dec_device_blocks": ht_jax_dec.STATS["blocks"],
           "dec_host_blocks": ht_jax_dec.STATS["host_fallbacks"]}
    check(res["enc_host_blocks"] == 0 and res["dec_host_blocks"] == 0,
          f"HT blocks took the host route: {res}")
    check(res["enc_device_blocks"] > 0 and res["dec_device_blocks"] > 0,
          f"HT coder never ran on the device: {res}")
    return res


def phase_cli(arr, workdir):
    """CLI round trip on a PPM, in this process (a child would open the
    card a second time)."""
    from grok_tpu.cli import compress as cli_c
    from grok_tpu.cli import decompress as cli_d
    from grok_tpu.io.formats import read_pnm, write_pnm

    src = os.path.join(workdir, "in.ppm")
    write_pnm(src, gk.Image.from_array(arr))
    res = {}
    for cfg, extra in (("lossless53", []), ("ht_lossless", ["-M", "64"])):
        j2k = os.path.join(workdir, f"{cfg}.j2k")
        out = os.path.join(workdir, f"{cfg}.ppm")
        with codec_env(True, cfg):
            rc_c, t_c = timed(lambda: cli_c.main(
                ["-i", src, "-o", j2k, "-n", "6", *extra]))
            rc_d, t_d = timed(lambda: cli_d.main(["-i", j2k, "-o", out]))
        check(rc_c in (0, None) and rc_d in (0, None),
              f"cli {cfg}: exit codes {rc_c}, {rc_d}")
        with codec_env(False):
            ref = gk.compress(gk.Image.from_array(arr), params(cfg))
        with open(j2k, "rb") as f:
            same = f.read() == ref
        back = read_pnm(out).to_array()
        check(same, f"cli {cfg}: stream differs from gk.compress")
        check(np.array_equal(back, arr), f"cli {cfg}: round trip")
        res[cfg] = {"enc_s": round(t_c, 3), "dec_s": round(t_d, 3),
                    "stream_identical": same}
    return res


def real_codeblocks(arr, n):
    """Up to ``n`` full 64x64 codeblocks of the lossless 5/3 transform of
    ``arr``, as the native Part-1 coder receives them."""
    from grok_tpu.t1 import native

    seen = {}
    orig = native.encode_cblks

    def capture(coeffs, heights, widths, orients, *a, **k):
        seen.setdefault("args", (np.array(coeffs), np.array(heights),
                                 np.array(widths), np.array(orients)))
        return orig(coeffs, heights, widths, orients, *a, **k)

    native.encode_cblks = capture
    try:
        with codec_env(False):
            gk.compress(gk.Image.from_array(arr), params("lossless53"))
    finally:
        native.encode_cblks = orig
    coeffs, hs, ws, ors = seen["args"]
    full = np.flatnonzero((hs == 64) & (ws == 64)
                          & (np.abs(coeffs).reshape(len(hs), -1).max(1) > 0))
    pick = full[:n]
    return coeffs[pick], hs[pick], ws[pick], ors[pick]


def phase_ebcot(arr, n=EBCOT_BLOCKS):
    """ebcot_jax (GROK_TPU_T1=jax) against the native coder."""
    from grok_tpu.t1 import ebcot_jax, native

    coeffs, hs, ws, ors = real_codeblocks(arr, n)
    check(len(hs) > 0, "no full codeblocks found")
    ebcot_jax.encode_cblks(coeffs, hs, ws, ors)  # compile
    ref, t_nat = timed(lambda: native.encode_cblks(coeffs, hs, ws, ors))
    got, t_jax = timed(lambda: ebcot_jax.encode_cblks(coeffs, hs, ws, ors))
    check(np.array_equal(got.lengths, ref.lengths), "ebcot_jax lengths")
    check(np.array_equal(got.pass_rates, ref.pass_rates),
          "ebcot_jax pass rates")
    for i in range(len(hs)):
        ln = int(ref.lengths[i])
        check(bytes(got.data[i, :ln]) == bytes(ref.data[i, :ln]),
              f"ebcot_jax block {i} bytes")
    dargs = (ref.data, ref.lengths, ref.numbps, ref.npasses, hs, ws, ors,
             64, 64)
    ebcot_jax.decode_cblks(*dargs)  # compile
    (dn, _), t_nat_d = timed(lambda: native.decode_cblks(*dargs))
    (dj, _), t_jax_d = timed(lambda: ebcot_jax.decode_cblks(*dargs))
    check(np.array_equal(np.asarray(dj), np.asarray(dn)),
          "ebcot_jax decode")
    check(np.array_equal(np.asarray(dn), coeffs), "native decode")
    return {"blocks": int(len(hs)), "bit_exact": True,
            "enc_s": {"ebcot_jax": round(t_jax, 4),
                      "native": round(t_nat, 4)},
            "dec_s": {"ebcot_jax": round(t_jax_d, 4),
                      "native": round(t_nat_d, 4)}}


FMA_MATRIX = [[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]]


def fma_cases(h=H, w=W):
    """The 9/7 gray, RGB-ICT and custom-MCT cases (name, frame, params)."""
    rgb = bench.natural_image(h, w, 3)
    photo = bench.photo_image(h, w, 3)
    return [
        ("97_gray_3res", rgb[..., 0],
         gk.CompressParams(num_resolutions=3, irreversible=True)),
        ("97_rgb_ict_5res", rgb,
         gk.CompressParams(num_resolutions=5, irreversible=True)),
        ("97_custom_mct", photo,
         gk.CompressParams(num_resolutions=3, irreversible=True,
                           mct_matrix=FMA_MATRIX)),
    ]


def phase_fma(h=H, w=W):
    """9/7 float chain on the device against the host: encode stream and
    the device decode of both streams."""
    from grok_tpu.ops import jax_pipeline

    res = {"float_chain_exact": jax_pipeline.float_chain_exact()}
    for name, arr, p in fma_cases(h, w):
        im = gk.Image.from_array(arr)
        with codec_env(False):
            host = gk.compress(im, p)
            host_dec = gk.decompress(host).to_array()
        with codec_env(True):
            dev = gk.compress(im, p)
            dev_dec = gk.decompress(host).to_array()
            dev_own = gk.decompress(dev).to_array()
        with codec_env(False):
            host_of_dev = gk.decompress(dev).to_array()
        ref = arr if arr.ndim == 3 else arr[..., None]
        stats = _diff_stats(host_dec, dev_dec, ref)
        own = _diff_stats(host_of_dev, dev_own, ref)
        res[name] = {"stream_identical": dev == host, **stats,
                     "max_d_own_stream": own["max_d"]}
        check(max(stats["max_d"], own["max_d"]) <= 1,
              f"{name}: device 9/7 off by more than 1 LSB")
        if res["float_chain_exact"]:
            check(dev == host and stats["max_d"] == 0 and own["max_d"] == 0,
                  f"{name}: exact float chain but streams differ")
    return res


def phase_gpu_tests():
    """The tests marked gpu, in this process (it holds the card)."""
    import pytest

    saved = dict(os.environ)
    try:
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests")])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    return {"pytest_exit": int(rc)}


# ------------------------------------------------------------- four cards
FOUR_CFGS = ("lossless53", "ht")


def _four_child(kind, workdir):
    """Run one JAX child of the four-card path and parse its JSON line."""
    env = dict(os.environ)
    if kind == "reference":
        env["CUDA_VISIBLE_DEVICES"] = "0"  # one card, as gk.compress uses
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--four-cards-child",
         kind, workdir], capture_output=True, text=True, timeout=900,
        env=env)
    sys.stderr.write(r.stderr[-4000:])
    check(r.returncode == 0, f"{kind} child failed (rc={r.returncode}): "
          f"{r.stdout[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def four_cards_child(kind, workdir):
    """reference: one-card gk.compress/gk.decompress; mesh: the four-card
    tile mesh against the reference files."""
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import multihost_run as mh

    arr = mh.make_image(H, W)
    im = gk.Image.from_array(arr)
    out = {"platform": jax.devices()[0].platform,
           "kind": jax.devices()[0].device_kind,
           "count": len(jax.devices())}
    for cfg in FOUR_CFGS:
        p = mh.build_params(cfg, tile=1024)
        path = os.path.join(workdir, f"{cfg}.j2k")
        if kind == "reference":
            with codec_env(True, cfg):
                stream = gk.compress(im, p)
                dec = gk.decompress(stream).to_array()
            check(np.array_equal(dec, arr), f"{cfg}: one-card round trip")
            with open(path, "wb") as f:
                f.write(stream)
            np.save(os.path.join(workdir, f"{cfg}.npy"), dec)
            out[cfg] = {"bytes": len(stream)}
        else:
            out[cfg] = _mesh_run(im, p, path, workdir, cfg)
    print(json.dumps(out, default=_jsonable), flush=True)


def _mesh_run(im, p, ref_path, workdir, cfg):
    import jax

    from grok_tpu.codestream.compress import build_siz, build_tcp
    from grok_tpu.parallel import distributed as dist

    mesh = dist._make_mesh(4)
    with open(ref_path, "rb") as f:
        ref = f.read()
    ref_dec = np.load(os.path.join(workdir, f"{cfg}.npy"))
    # which devices hold the transform shards of each dispatched chunk
    siz, tcp = build_siz(im, p), build_tcp(im, p)
    coeffs = dist.transform_tiles_on_mesh(
        im, siz, tcp, p, range(siz.num_tiles), mesh)
    shard_devs = sorted({
        s.device.id for h in {id(h): h for h in coeffs._chunks.values()
                              }.values()
        for s in h.dev.addressable_shards})
    stream, t_enc = timed(lambda: dist.compress_distributed(im, p, mesh=mesh))
    dec, t_dec = timed(
        lambda: dist.decompress_distributed(stream, mesh=mesh).to_array())
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    res = {"tiles": siz.num_tiles, "shard_devices": shard_devs,
           "peak_bytes_per_device": peaks,
           "stream_identical": stream == ref,
           "samples_identical": bool(np.array_equal(dec, ref_dec)),
           "enc_s": round(t_enc, 3), "dec_s": round(t_dec, 3)}
    check(res["stream_identical"], f"mesh {cfg}: stream differs")
    check(res["samples_identical"], f"mesh {cfg}: decode differs")
    check(len(shard_devs) == 4, f"mesh {cfg}: shards on {shard_devs}")
    return res


def four_cards():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import multihost_run as mh

    emit("device", nvidia_smi=nvidia_smi())
    with tempfile.TemporaryDirectory() as workdir:
        ref = _four_child("reference", workdir)
        emit("reference", **ref)
        mesh = _four_child("mesh", workdir)
        emit("mesh", **mesh)
        for cfg in FOUR_CFGS:
            with open(os.path.join(workdir, f"{cfg}.j2k"), "rb") as f:
                want = f.read()
            for plane in ("kv", "shared"):
                (stream, info), t = timed(lambda: mh.run_group(
                    4, cfg, H, W, decode=plane == "kv", plane=plane,
                    tile=1024, gpus=True, timeout=900))
                row = {"plane": plane, "stream_identical": stream == want,
                       "group_wall_s": round(t, 3), **info}
                emit(f"multihost.{cfg}", **row)
                check(row["stream_identical"],
                      f"multihost {cfg}/{plane}: stream differs")
                if "dec_identical" in info:
                    check(info["dec_identical"],
                          f"multihost {cfg}/{plane}: decode differs")
    check(mesh["count"] == 4, f"four-card path saw {mesh['count']} devices")
    return {"platform": mesh["platform"], "kind": mesh["kind"],
            "count": mesh["count"]}


# ------------------------------------------------------------------ main
def one_card():
    import jax

    dev = phase_device()
    compiles = CompileLog()
    fr = frames()
    setup = warm_up(fr)
    emit("setup", **setup, compile_cache_dir=jax.config.jax_compilation_cache_dir,
         **compiles.take())
    for cfg in CONFIGS:
        for name, arr in fr.items():
            res = phase_codec(cfg, arr)
            emit(f"codec.{cfg}.{name}", **res, peak_bytes_in_use=peak_bytes())
    emit("ht_coverage", **phase_ht_coverage(fr["natural"]))
    with tempfile.TemporaryDirectory() as workdir:
        emit("cli", **phase_cli(fr["natural"], workdir))
    emit("ebcot_jax", **phase_ebcot(fr["photo"]))
    emit("fma", **phase_fma())
    emit("compiles_after_warm_up", **compiles.take())
    emit("gpu_tests", **phase_gpu_tests())
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh and multi-process "
                         "paths")
    ap.add_argument("--four-cards-child", nargs=2,
                    metavar=("KIND", "WORKDIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.four_cards_child:
        four_cards_child(*args.four_cards_child)
        return 0
    if args.four_cards:
        dev = four_cards()
    else:
        import jax

        platform = jax.devices()[0].platform
        if platform != "gpu":
            print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
                  file=sys.stderr)
            return 1
        dev = one_card()
    check(dev["platform"] == "gpu", f"ran on {dev['platform']}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
