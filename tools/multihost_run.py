#!/usr/bin/env python
"""Multi-process run of the jax.distributed codec (parallel/multihost.py):
N local processes encode one image, and process 0's assembled stream is
asserted byte-identical to single-process gk.compress (and the
multi-process decode sample-identical to gk.decompress).

Parent:   python tools/multihost_run.py [--nproc 2 4] [--gpus] [--out FILE]
Worker:   (spawned internally with --worker)

Without --gpus each worker runs on the CPU backend with 2 virtual local
devices, so the local-mesh transform path is exercised inside every
process. With --gpus worker i sees only GPU i (CUDA_VISIBLE_DEVICES), so
each card has exactly one process. Workers join the group at a
parent-chosen coordinator port on localhost.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make_image(h, w, nc=3, seed=3):
    import numpy as np

    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 23) * np.cos(yy / 31)
    g = (np.clip(base + r.standard_normal((h, w)) * 0.02, 0, 1) * 255)
    g = g.astype(np.int32)
    return np.stack([g] * nc, -1) if nc > 1 else g


def make_image_giga(h, w, seed=3):
    # gigapixel grayscale built tile-row-wise (cheaper than one mgrid)
    import numpy as np

    r = np.random.default_rng(seed)
    out = np.empty((h, w), dtype=np.int32)
    xx = np.arange(w)[None, :]
    for y0 in range(0, h, 1024):
        yy = np.arange(y0, min(y0 + 1024, h))[:, None]
        base = 0.5 + 0.3 * np.sin(xx / 23) * np.cos(yy / 31)
        out[y0:y0 + yy.shape[0]] = (
            np.clip(base + r.standard_normal(base.shape) * 0.02, 0, 1) * 255
        ).astype(np.int32)
    return out


def build_params(cfg, tile=512):
    import grok_tpu as gk

    if cfg == "lossless53":
        return gk.CompressParams(num_resolutions=5, tile_size=(tile, tile),
                                 write_tlm=True)
    if cfg == "ht":
        return gk.CompressParams(num_resolutions=5, tile_size=(tile, tile),
                                 write_tlm=True, ht=True)
    if cfg == "lossy97":
        return gk.CompressParams(num_resolutions=5, tile_size=(tile, tile),
                                 irreversible=True, rates=[1.0])
    if cfg == "giga":
        # BASELINE config 4 shape: 1024x1024 tiles, gigapixel canvas
        return gk.CompressParams(num_resolutions=5, tile_size=(1024, 1024),
                                 write_tlm=True, ht=True)
    raise SystemExit(f"unknown config {cfg}")


def build_array(cfg, h, w):
    return make_image_giga(h, w) if cfg == "giga" else make_image(h, w)


def worker(args):
    if not args.gpus:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=2").strip()
    import jax

    import numpy as np

    import grok_tpu as gk
    from grok_tpu.parallel import multihost

    multihost.initialize(f"127.0.0.1:{args.port}", args.nproc, args.pid)
    im = gk.Image.from_array(build_array(args.cfg, args.h, args.w))
    params = build_params(args.cfg, args.tile)
    t0 = time.perf_counter()
    if args.plane == "shared":
        total = multihost.compress_multihost_shared(
            im, params, out_path=args.stream_out)
        enc_s = time.perf_counter() - t0
        stream = None
        if args.pid == 0:
            with open(args.stream_out, "rb") as f:
                stream = f.read()
            assert total == len(stream)
            print(json.dumps({"enc_s": round(enc_s, 3),
                              "plane": "shared"}), flush=True)
    else:
        stream = multihost.compress_multihost(im, params)
        enc_s = time.perf_counter() - t0
        if args.pid == 0:
            with open(args.stream_out, "wb") as f:
                f.write(stream)
            print(json.dumps({"enc_s": round(enc_s, 3),
                              "plane": "kv"}), flush=True)

    if args.decode:
        if args.pid == 0:
            data = stream
        elif args.plane == "shared":
            with open(args.stream_out, "rb") as f:
                data = f.read()  # the shared file IS the exchange medium
        else:
            data = gk.compress(im, build_params(args.cfg, args.tile))
        t0 = time.perf_counter()
        img = multihost.decompress_multihost(data)
        dec_s = time.perf_counter() - t0
        if args.pid == 0:
            ref = gk.decompress(data)
            same = all(
                np.array_equal(a.data, b.data)
                for a, b in zip(img.components, ref.components))
            print(json.dumps({"dec_s": round(dec_s, 3),
                              "dec_identical": bool(same)}), flush=True)
            if not same:
                raise SystemExit("multihost decode mismatch")
    jax.distributed.shutdown()


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_group(nproc, cfg, h, w, decode, plane="kv", timeout=1800, tile=512,
              gpus=False):
    """Run one group of ``nproc`` workers; returns (process 0's stream,
    its JSON fields). ``gpus``: worker i is bound to GPU i."""
    port = free_port()
    fd, stream_out = tempfile.mkstemp(suffix=".j2k", prefix="gkmh_")
    os.close(fd)
    procs = []
    for pid in range(nproc):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--pid", str(pid), "--nproc", str(nproc),
               "--port", str(port), "--cfg", cfg, "--h", str(h),
               "--w", str(w), "--stream-out", stream_out,
               "--plane", plane, "--tile", str(tile)]
        env = None
        if decode:
            cmd.append("--decode")
        if gpus:
            cmd.append("--gpus")
            env = {**os.environ, "CUDA_VISIBLE_DEVICES": str(pid)}
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env))
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit(f"multihost group (nproc={nproc}) timed out")
        outs.append(out)
        if p.returncode != 0:
            sys.stderr.write(out)
            raise SystemExit(f"worker failed (nproc={nproc}, rc={p.returncode})")
    info = {}
    for line in outs[0].splitlines():
        line = line.strip()
        if line.startswith("{"):
            info.update(json.loads(line))
    with open(stream_out, "rb") as f:
        stream = f.read()
    os.unlink(stream_out)
    return stream, info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, nargs="*", default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--cfg", default="lossless53")
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--stream-out")
    ap.add_argument("--decode", action="store_true", default=False)
    ap.add_argument("--plane", default="kv", choices=["kv", "shared"])
    ap.add_argument("--skip-giga", action="store_true")
    ap.add_argument("--giga-size", type=int, default=32768)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--gpus", action="store_true",
                    help="bind worker i to GPU i (one process per card)")
    ap.add_argument("--out", help="also write the results JSON here")
    args = ap.parse_args()

    if args.worker:
        args.nproc = args.nproc[0] if isinstance(args.nproc, list) else args.nproc
        return worker(args)

    # the parent computes the host references only: it stays off the
    # accelerator so each card keeps one process
    os.environ["JAX_PLATFORMS"] = "cpu"
    import grok_tpu as gk

    sizes = args.nproc or [1, 2, 4]
    results = {"metric": "multihost_encode", "image": f"{args.w}x{args.h}x3",
               "note": ("N local processes via jax.distributed; "
                        "byte-identity vs single-process gk.compress "
                        "asserted per row. plane=shared exchanges only "
                        "length records over the coordinator; tile bytes "
                        "are pwritten into the shared output file at "
                        "derived offsets."),
               "configs": {}}
    for cfg in ("lossless53", "ht"):
        im = gk.Image.from_array(make_image(args.h, args.w))
        ref = gk.compress(im, build_params(cfg, args.tile))
        rows = []
        for n in sizes:
            for plane in (("kv", "shared") if n > 1 else ("kv",)):
                t0 = time.perf_counter()
                stream, info = run_group(n, cfg, args.h, args.w,
                                         decode=(n == max(sizes)),
                                         plane=plane, tile=args.tile,
                                         gpus=args.gpus)
                wall = time.perf_counter() - t0
                ok = stream == ref
                row = {"nproc": n, "plane": plane,
                       "byte_identical": bool(ok),
                       "enc_s": info.get("enc_s"),
                       "group_wall_s": round(wall, 2)}
                if "dec_identical" in info:
                    row["dec_identical"] = info["dec_identical"]
                    row["dec_s"] = info["dec_s"]
                rows.append(row)
                print(json.dumps({"cfg": cfg, **row}), flush=True)
                if not ok:
                    raise SystemExit(
                        f"BYTE MISMATCH cfg={cfg} nproc={n} plane={plane}")
        results["configs"][cfg] = rows

    if not args.skip_giga:
        # BASELINE config 4: gigapixel canvas, 1024x1024 tiles, sharded
        gh = gw = args.giga_size
        im = gk.Image.from_array(make_image_giga(gh, gw))
        t0 = time.perf_counter()
        ref = gk.compress(im, build_params("giga"))
        ref_s = time.perf_counter() - t0
        del im
        rows = []
        for n in [p for p in sizes if p > 1][:2] or [2]:
            t0 = time.perf_counter()
            stream, info = run_group(n, "giga", gh, gw, decode=False,
                                     plane="shared", timeout=3600,
                                     gpus=args.gpus)
            wall = time.perf_counter() - t0
            ok = stream == ref
            row = {"nproc": n, "plane": "shared",
                   "tiles": (gh // 1024) * (gw // 1024),
                   "byte_identical": bool(ok),
                   "enc_s": info.get("enc_s"),
                   "single_host_enc_s": round(ref_s, 2),
                   "group_wall_s": round(wall, 2),
                   "stream_mb": round(len(stream) / 1e6, 1)}
            rows.append(row)
            print(json.dumps({"cfg": "giga", **row}), flush=True)
            if not ok:
                raise SystemExit(f"BYTE MISMATCH giga nproc={n}")
        results["configs"]["gigapixel_1024tiles"] = rows

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")


if __name__ == "__main__":
    main()
