"""Benchmark driver: prints ONE JSON line with the headline metric.

Mirrors BASELINE.json's metric: encode/decode megapixels/s/chip on 4K sRGB,
aggregated over lossless 5/3 and 1bpp lossy 9/7 (plus an HTJ2K column in
detail). vs_baseline compares against the reference Grok binaries on the
same machine and configs (ratio > 1 = faster than the reference); falls
back to 1.0 when the reference isn't built.

Measurement design for this host's heavy timing noise (the same code
swings 1.5-2x minute to minute): ours and the reference are timed
INTERLEAVED inside the same iteration loop (best-of-5 per side), so both
sides sample the same load window; the reference's own `-v` codec-time
report is used when available (codec-vs-codec, no subprocess/file-IO
skew).

Env knobs: BENCH_W/BENCH_H (default 3840x2160), BENCH_GRAY=1 for
grayscale, BENCH_REPS (default 5).
"""

import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np


def natural_image(h, w, nc=3):
    r = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 23) * np.cos(yy / 31)
    tex = r.standard_normal((h, w)) * 0.02
    edges = ((xx // 40 + yy // 40) % 2) * 0.2
    g = (np.clip(base + tex + edges, 0, 1) * 255).astype(np.int32)
    if nc == 1:
        return g
    return np.stack(
        [g] + [np.clip(g + r.integers(-20, 20, (h, w)), 0, 255) for _ in range(nc - 1)],
        axis=-1,
    ).astype(np.int32)


def photo_image(h, w, nc=3):
    """Photographic-statistics content: 1/f amplitude spectrum with random
    phase (the classic natural-image power law), a soft tone curve and
    correlated chroma — entropy-coder work factor matches real photographs
    far better than the sine+checker synthetic."""
    r = np.random.default_rng(11)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / f ** 1.15
    spec = amp * np.exp(2j * np.pi * r.random((h, fx.shape[1])))
    lum = np.fft.irfft2(spec, s=(h, w))
    lum = (lum - lum.mean()) / (lum.std() + 1e-9)
    # soft-knee tone curve into [0,255] with mild sensor noise
    lum = np.tanh(lum * 0.8)
    base = (lum * 0.5 + 0.5) * 235 + 10
    if nc == 1:
        g = np.clip(base + r.normal(0, 1.2, (h, w)), 0, 255)
        return g.astype(np.int32)
    chans = []
    for c in range(nc):
        tint = np.fft.irfft2(
            (1.0 / f ** 1.3) * np.exp(2j * np.pi * r.random((h, fx.shape[1]))),
            s=(h, w))
        tint = 18 * (tint - tint.mean()) / (tint.std() + 1e-9)
        chans.append(np.clip(base + tint + r.normal(0, 1.2, (h, w)), 0, 255))
    return np.stack(chans, axis=-1).astype(np.int32)


def _busy_fraction(dt=0.25):
    """Instantaneous host busy fraction from /proc/stat (this process is
    idle while sampling, so this measures EXTERNAL load)."""
    def snap():
        with open("/proc/stat") as f:
            vals = list(map(int, f.readline().split()[1:]))
        return sum(vals), vals[3] + vals[4]  # total, idle+iowait
    t0, i0 = snap()
    time.sleep(dt)
    t1, i1 = snap()
    tot = t1 - t0
    return 1.0 - (i1 - i0) / tot if tot > 0 else 0.0


def wait_quiet(max_wait=None, thresh=0.30):
    """Hold off until the host looks quiet (or the wait budget runs out).

    Driver captures have repeatedly landed on contention troughs (r04:
    photo HT enc 0.856x while a quiet rerun measured >1.2x); refusing to
    start while another build/test is saturating the cores is cheaper
    than any amount of statistical repair afterwards."""
    if max_wait is None:
        max_wait = float(os.environ.get("BENCH_QUIET_WAIT", "90"))
    t0 = time.time()
    busy = _busy_fraction()
    while busy >= thresh and time.time() - t0 < max_wait:
        time.sleep(1.0)
        busy = _busy_fraction()
    return round(busy, 3)


def _grk_bin():
    for cand in ("/tmp/grok-build/bin", "/usr/local/bin"):
        if os.path.exists(os.path.join(cand, "grk_compress")):
            return cand
    return None


def _grk_run(cmd, marker):
    """Prefer the codec's own -v codec-time report (excludes subprocess
    spawn + image file I/O) over wall clock; fall back to wall time."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    t = time.perf_counter() - t0
    m = re.search(marker + r" time: ([0-9.]+) ms", r.stdout + r.stderr)
    if m:
        t = min(t, float(m.group(1)) / 1000.0)
    return t


def run_configs(gk, arr, configs, reps, grk):
    h, w = arr.shape[:2]
    nc = arr.shape[2] if arr.ndim == 3 else 1
    mp = h * w / 1e6
    im = gk.Image.from_array(arr)
    ours = {}
    ref = {} if grk else None
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.ppm" if nc == 3 else "in.pgm")
        if grk:
            from PIL import Image as PImage

            PImage.fromarray(arr.astype(np.uint8)).save(src)
        for name, (params, gargs) in configs.items():
            samples = {k: [] for k in ("enc", "dec", "g_enc", "g_dec")}
            j2k = os.path.join(td, f"{name}.j2k")
            dec = os.path.join(td, f"{name}_dec.ppm")
            stream = gk.compress(im, params)  # warm (jit/native/page cache)
            out = gk.decompress(stream)

            def _ours():
                nonlocal stream, out
                t0 = time.perf_counter()
                stream = gk.compress(im, params)
                samples["enc"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                out = gk.decompress(stream)
                samples["dec"].append(time.perf_counter() - t0)

            def _theirs():
                samples["g_enc"].append(_grk_run(
                    [os.path.join(grk, "grk_compress"), "-i", src,
                     "-o", j2k, "-v", *gargs], "compress"))
                samples["g_dec"].append(_grk_run(
                    [os.path.join(grk, "grk_decompress"), "-i", j2k,
                     "-o", dec, "-v"], "decompress"))

            # adaptive sampling: alternate the two sides inside each
            # iteration (both sample the same load window) and keep going
            # until neither side's best time has improved for two
            # consecutive iterations — a contention burst then costs extra
            # reps instead of a biased capture (r04 driver trough: 0.856x
            # on 3 photo reps; quiet rerun >1.2x)
            max_reps = max(reps, 12)
            hard_cap = max_reps + 8
            it = stale = 0
            while True:
                prev = {k: min(v) if v else float("inf")
                        for k, v in samples.items()}
                if grk and it % 2:
                    _theirs()
                    _ours()
                else:
                    _ours()
                    if grk:
                        _theirs()
                improved = any(
                    v and min(v) < prev[k] * 0.99
                    for k, v in samples.items())
                stale = 0 if improved else stale + 1
                it += 1
                # external load during this iteration taints it: don't let
                # it count toward convergence, wait for quiet, sample more
                # (bounded by hard_cap)
                if it < hard_cap and _busy_fraction(0.15) >= 0.35:
                    stale = 0
                    max_reps = min(max_reps + 1, hard_cap)
                    wait_quiet(max_wait=20)
                if it >= reps and (stale >= 2 or it >= max_reps):
                    break
            ok = True
            if "lossless" in name:
                want = arr if arr.ndim == 3 else arr[:, :, None]
                ok = bool(np.array_equal(out.to_array(), want))

            def med_over_min(v):
                return round(sorted(v)[len(v) // 2] / min(v), 3) if v else None

            ours[name] = {
                "enc_mps": round(mp / min(samples["enc"]), 3),
                "dec_mps": round(mp / min(samples["dec"]), 3),
                "bytes": len(stream),
                "lossless_ok": ok,
                "reps": it,
                "spread": [med_over_min(samples["enc"]),
                           med_over_min(samples["dec"])],
            }
            if grk:
                ref[name] = {
                    "enc_mps": round(mp / min(samples["g_enc"]), 3),
                    "dec_mps": round(mp / min(samples["g_dec"]), 3),
                    "bytes": os.path.getsize(j2k) if os.path.exists(j2k) else 0,
                    "spread": [med_over_min(samples["g_enc"]),
                               med_over_min(samples["g_dec"])],
                }
    return ours, ref


def main():
    import grok_tpu as gk

    w = int(os.environ.get("BENCH_W", "3840"))
    h = int(os.environ.get("BENCH_H", "2160"))
    nc = 1 if os.environ.get("BENCH_GRAY") else 3
    reps = int(os.environ.get("BENCH_REPS", "7"))
    arr = natural_image(h, w, nc)

    configs = {
        "lossless53": (gk.CompressParams(num_resolutions=6), []),
        "ht_lossless": (gk.CompressParams(num_resolutions=6, ht=True),
                        ["-M", "64"]),
        "lossy97_1bpp": (
            gk.CompressParams(num_resolutions=6, irreversible=True,
                              num_layers=1, layer_rates=[8]),
            ["-r", "8"],
        ),
    }
    grk = _grk_bin()
    load0 = wait_quiet()

    def vs_table(o, r):
        return {
            name: {
                "enc": round(o[name]["enc_mps"] / r[name]["enc_mps"], 3),
                "dec": round(o[name]["dec_mps"] / r[name]["dec_mps"], 3),
            }
            for name in configs
        }

    ours, ref = run_configs(gk, arr, configs, reps, grk)

    # photographic-statistics corpus (entropy coding is content-dependent;
    # record a real-photo-like number next to the synthetic headline)
    photo = None
    if not os.environ.get("BENCH_NO_PHOTO"):
        wait_quiet(max_wait=30)
        p_ours, p_ref = run_configs(
            gk, photo_image(h, w, nc), configs, max(5, reps // 2), grk)
        photo = {"ours": p_ours, "grok_reference": p_ref}
        if p_ref:
            photo["vs_ref"] = vs_table(p_ours, p_ref)

    def agg(r):
        vals = []
        for name in ("lossless53", "lossy97_1bpp"):
            vals += [r[name]["enc_mps"], r[name]["dec_mps"]]
        return 4.0 / sum(1.0 / v for v in vals)  # harmonic mean

    value = agg(ours)
    vs = value / agg(ref) if ref else 1.0

    print(
        json.dumps(
            {
                "metric": "4k_srgb_encdec_megapixels_per_s",
                "value": round(value, 3),
                "unit": "MP/s",
                "vs_baseline": round(vs, 4),
                "detail": {
                    "size": f"{w}x{h}x{nc}",
                    "start_busy_fraction": load0,
                    "ours": ours,
                    "grok_reference": ref,
                    "vs_ref": vs_table(ours, ref) if ref else None,
                    "photo_corpus": photo,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
