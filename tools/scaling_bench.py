"""Multi-device scaling-efficiency harness (BASELINE: >=80% efficiency
1 chip -> 1 host -> N hosts; SURVEY §7 stage 10).

Runs the distributed tile-sharded ENCODE and DECODE
(parallel/distributed.py) for lossless-5/3 and HT configs over meshes of
1, 2, 4, ... devices and reports wall time, throughput, per-stage split
(mesh transform vs entropy vs assembly, via the built-in tracer) and
scaling efficiency T1 / (n * Tn) per mesh size.

Resource model: the entropy stage runs on a host worker pool of width
n_devices with a 1-thread native team per worker
(entropy_workers=n, entropy_threads=1) — each mesh device brings one
host worker, the way a multi-card host brings cores with every card. On
the CPU backend the virtual devices and workers share the physical
cores, so rows beyond the core count under-report.

Usage: python tools/scaling_bench.py [H W tile devices...]
       (defaults: 2048 2048 512 — 16 tiles — over 1,2,4,8 devices)
One process drives every device of the mesh; it prints one JSON line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("GROK_TPU_TRACE", "1")
# per-chip resource model on the CPU simulation backend: one compute
# thread per virtual device (a real mesh's chips don't share silicon),
# so XLA's intra-op pool must not hand the 1-device baseline every core
if "xla_cpu_multi_thread_eigen" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    ).strip()

import grok_tpu as gk  # noqa: E402
from grok_tpu.core import trace  # noqa: E402
from grok_tpu.parallel.distributed import (  # noqa: E402
    _make_mesh,
    compress_distributed,
    decompress_distributed,
)


def natural_image(h, w, nc=3, seed=3):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 23) * np.cos(yy / 31)
    g = (np.clip(base + r.standard_normal((h, w)) * 0.02, 0, 1) * 255)
    g = g.astype(np.int32)
    return np.stack([g] * nc, -1) if nc > 1 else g


def stage_split(prefixes=("dist.", "enc.")):
    out = {}
    for r in trace.rows():
        if any(r["stage"].startswith(p) for p in prefixes):
            out[r["stage"]] = round(r["ms"] / 1e3, 4)
    return out


def bench_config(name, params, arr, sizes, mp):
    im_bytes = None
    rows_enc, rows_dec = [], []
    im = gk.Image.from_array(arr)  # pixel staging is not the codec's work
    ref = gk.compress(im, params)
    t1e = t1d = None
    for n in sizes:
        mesh = _make_mesh(n)
        kw = dict(mesh=mesh, entropy_workers=n, entropy_threads=1)
        # ---- encode
        compress_distributed(im, params, **kw)  # warm
        best, split = float("inf"), {}
        for _ in range(5):
            trace.reset()
            t0 = time.perf_counter()
            out = compress_distributed(im, params, **kw)
            dt = time.perf_counter() - t0
            if dt < best:
                best, split = dt, stage_split()
        assert out == ref, f"{name}: encode divergence at n={n}"
        im_bytes = len(out)
        if t1e is None:
            t1e = best
        rows_enc.append({
            "devices": n, "seconds": round(best, 4),
            "mps": round(mp / best, 2),
            "efficiency": round(t1e / (n * best), 3),
            "byte_identical": True, "stages_s": split,
        })
        print(json.dumps({"cfg": name, "dir": "enc", **rows_enc[-1]}),
              flush=True)
        # ---- decode
        ref_img = gk.decompress(ref)
        decompress_distributed(ref, **kw)  # warm
        best, split = float("inf"), {}
        for _ in range(5):
            trace.reset()
            t0 = time.perf_counter()
            img = decompress_distributed(ref, **kw)
            dt = time.perf_counter() - t0
            if dt < best:
                best, split = dt, stage_split()
        same = all(np.array_equal(a.data, b.data)
                   for a, b in zip(img.components, ref_img.components))
        assert same, f"{name}: decode divergence at n={n}"
        if t1d is None:
            t1d = best
        rows_dec.append({
            "devices": n, "seconds": round(best, 4),
            "mps": round(mp / best, 2),
            "efficiency": round(t1d / (n * best), 3),
            "sample_identical": True, "stages_s": split,
        })
        print(json.dumps({"cfg": name, "dir": "dec", **rows_dec[-1]}),
              flush=True)
    return {"encode": rows_enc, "decode": rows_dec,
            "stream_bytes": im_bytes}


def main(argv):
    import jax

    H = int(argv[1]) if len(argv) > 1 else 2048
    W = int(argv[2]) if len(argv) > 2 else 2048
    T = int(argv[3]) if len(argv) > 3 else 512
    avail = len(jax.devices())
    sizes = [int(x) for x in argv[4:]] or [
        n for n in (1, 2, 4, 8, 16) if n <= avail
    ]
    arr = natural_image(H, W)
    mp = H * W / 1e6
    try:
        ncores = len(os.sched_getaffinity(0))
    except AttributeError:
        ncores = os.cpu_count() or 1

    configs = {
        "lossless53": gk.CompressParams(num_resolutions=5, tile_size=(T, T),
                                        write_tlm=True),
        "ht_lossless": gk.CompressParams(num_resolutions=5, tile_size=(T, T),
                                         write_tlm=True, ht=True),
    }
    results = {}
    for name, params in configs.items():
        results[name] = bench_config(name, params, arr, sizes, mp)

    summary = {
        "metric": "tile_sharded_codec_scaling",
        "image": f"{W}x{H} tiles {T}x{T}",
        "backend": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "physical_cores": ncores,
        "resource_model": (
            "entropy_workers=n_devices, entropy_threads=1: one host worker "
            "per mesh device"),
        "configs": results,
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main(sys.argv)
