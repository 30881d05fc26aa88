"""grok-tpu-compress — CLI encoder (parity target: src/bin/jp2/grk_compress).

Flag names follow the reference CLI where practical.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from ..core.params import CompressParams, ProgressionOrder
from ..codestream.compress import compress
from ..codestream.jp2 import wrap_jp2
from ..io.formats import load_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grok-tpu-compress",
        description="JPEG 2000 / HTJ2K encoder",
    )
    p.add_argument("-i", "--in_file", help="input image (png/tif/bmp/pnm/pgx/raw)")
    p.add_argument("-o", "--out_file", help="output .j2k/.j2c/.jp2")
    p.add_argument("-y", "--batch_src", help="directory of input images (batch mode)")
    p.add_argument("-a", "--out_dir", help="output directory (batch mode)")
    p.add_argument("-r", "--compression_ratios", help="per-layer ratios, e.g. 20,10,1")
    p.add_argument("-q", "--quality", help="per-layer PSNR targets in dB")
    p.add_argument("-n", "--resolutions", type=int, default=6)
    p.add_argument("-I", "--irreversible", action="store_true", help="9/7 lossy transform")
    p.add_argument("-t", "--tile_dims", help="tile size WxH or W,H")
    p.add_argument("-T", "--tile_offset", default="0,0")
    p.add_argument("-d", "--image_offset", default="0,0")
    p.add_argument("-b", "--code_block_dims", default="64,64")
    p.add_argument("-c", "--precinct_dims", help="precinct size exponents, e.g. [128,128]")
    p.add_argument("-p", "--progression_order", default="LRCP",
                   choices=["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
    p.add_argument("-S", "--sop", action="store_true", help="SOP markers")
    p.add_argument("-E", "--eph", action="store_true", help="EPH markers")
    p.add_argument("-M", "--mode", type=int, default=0, help="codeblock style flags (64 = HT)")
    p.add_argument("-u", "--tlm", action="store_true", help="write TLM markers")
    p.add_argument("-L", "--plt", action="store_true", help="write PLT markers")
    p.add_argument("-C", "--comment", default=None)
    p.add_argument("-N", "--guard_bits", type=int, default=2)
    p.add_argument("-H", "--num_threads", type=int, default=0)
    p.add_argument("-Y", "--mct", type=int, default=None,
                   help="0 off / 1 RCT-ICT / 2 custom matrix (default auto)")
    p.add_argument("-m", "--custom_mct", metavar="FILE",
                   help="whitespace-separated NxN MCT matrix file (with -Y 2)")
    p.add_argument("-P", "--poc", help="progression order changes: "
                   "res0,comp0,lay1,res1,comp1,PROG[/...]")
    p.add_argument("-R", "--roi", help="ROI maxshift: c=<comp>,U=<shift>")
    p.add_argument("-Z", "--rsiz", type=lambda v: int(v, 0), default=None,
                   help="profile (rsiz) value, e.g. 0x0400 for IMF 2K")
    p.add_argument("-w", "--cinema2k", type=int, choices=[24, 48],
                   help="DCI Cinema 2K profile at the given fps")
    p.add_argument("-x", "--cinema4k", type=int, choices=[24, 48],
                   help="DCI Cinema 4K profile at the given fps")
    p.add_argument("--TP", dest="tp_divider", choices=["R", "L", "C"],
                   help="split tile-parts at R/L/C boundaries")
    p.add_argument("-F", "--raw", help="raw input geometry: "
                   "w,h,ncomp,prec,{s,u} (for .raw inputs)")
    p.add_argument("-K", "--in_format", help="input format override")
    p.add_argument("-O", "--out_format", default="J2K",
                   help="batch output format (J2K|J2C|JP2)")
    p.add_argument("-A", "--rate_control", type=int, choices=[0, 1], default=0,
                   help="0: all-pass bisection  1: convex-hull feasible only")
    p.add_argument("-Q", "--capture_res", help="capture resolution X,Y (JP2 res box)")
    p.add_argument("-D", "--display_res", help="display resolution X,Y (JP2 res box)")
    p.add_argument("-e", "--repetitions", type=int, default=1,
                   help="encode repeatedly (performance measurement)")
    p.add_argument("-W", "--logfile", help="append verbose output to this file")
    p.add_argument("-V", "--TransferExifTags", dest="transfer_exif",
                   action="store_true",
                   help="embed input EXIF tags in the JP2 (uuid box)")
    p.add_argument("-U", "--BROADCAST", dest="broadcast",
                   help="Broadcast profile: SINGLE|MULTI|MULTI_R"
                        "[,mainlevel=X][,framerate=FPS]")
    p.add_argument("-z", "--IMF", dest="imf",
                   help="IMF profile: 2K|4K|8K|2K_R|4K_R|8K_R"
                        "[,mainlevel=X][,sublevel=Y][,framerate=FPS]")
    p.add_argument("-J", "--duration", type=float,
                   help="repeat the encode for this many seconds (timing)")
    p.add_argument("-g", "--plugin_path",
                   help="load a T1 block-coder plugin shared library")
    p.add_argument("-G", "--device_id", type=int,
                   help="device index for the jax device pipeline")
    p.add_argument("--keep_palette", action="store_true",
                   help="encode palettized inputs as index + pclr/cmap JP2 "
                        "boxes instead of expanding to RGB (.jp2 output only)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def params_from_args(args) -> CompressParams:
    p = CompressParams()
    p.num_resolutions = args.resolutions
    p.irreversible = args.irreversible
    p.progression = ProgressionOrder[args.progression_order]
    p.use_sop = args.sop
    p.use_eph = args.eph
    p.write_tlm = args.tlm
    p.write_plt = args.plt
    p.guard_bits = args.guard_bits
    p.num_threads = args.num_threads
    p.mct = args.mct
    if args.comment is not None:
        p.comment = args.comment
    if args.mode:
        if args.mode & 0x40:
            p.ht = True
        p.cblk_style = args.mode & 0x3F
    if args.tile_dims:
        sep = "," if "," in args.tile_dims else "x"
        w, h = (int(v) for v in args.tile_dims.split(sep))
        p.tile_size = (w, h)
        p.tile_offset = tuple(int(v) for v in args.tile_offset.split(","))
    cbw, cbh = (int(v) for v in args.code_block_dims.split(","))
    p.cblk_width, p.cblk_height = cbw, cbh
    if args.precinct_dims:
        dims = args.precinct_dims.strip("[]").split(",")
        exps = []
        for i in range(0, len(dims), 2):
            pw = int(dims[i]).bit_length() - 1
            ph = int(dims[i + 1]).bit_length() - 1
            exps.append((pw, ph))
        p.precinct_sizes = exps * 33 if len(exps) == 1 else exps
        p.precinct_sizes = p.precinct_sizes[:33]
    p.rc_algorithm = args.rate_control
    if args.tp_divider:
        p.tp_divider = args.tp_divider
    if args.rsiz is not None:
        p.profile = args.rsiz
    if args.cinema2k:
        from . import compress as _self  # noqa: F401
        from ..core import params as prm

        p.profile = prm.PROFILE_CINEMA_2K
        p.framerate = args.cinema2k
        p.irreversible = True
    if args.cinema4k:
        from ..core import params as prm

        p.profile = prm.PROFILE_CINEMA_4K
        p.framerate = args.cinema4k
        p.irreversible = True
    if getattr(args, "broadcast", None):
        from ..core import params as prm

        base, opts = _profile_opts(args.broadcast)
        profiles = {"SINGLE": prm.PROFILE_BC_SINGLE,
                    "MULTI": prm.PROFILE_BC_MULTI,
                    "MULTI_R": prm.PROFILE_BC_MULTI_R}
        if base not in profiles:
            raise ValueError(
                "-U/--BROADCAST needs SINGLE|MULTI|MULTI_R"
                "[,mainlevel=X][,framerate=FPS]")
        p.profile = profiles[base] | int(opts.get("mainlevel", 0))
        if "framerate" in opts:
            p.framerate = int(opts["framerate"])
    if getattr(args, "imf", None):
        from ..core import params as prm

        base, opts = _profile_opts(args.imf)
        profiles = {"2K": prm.PROFILE_IMF_2K, "4K": prm.PROFILE_IMF_4K,
                    "8K": prm.PROFILE_IMF_8K, "2K_R": prm.PROFILE_IMF_2K_R,
                    "4K_R": prm.PROFILE_IMF_4K_R,
                    "8K_R": prm.PROFILE_IMF_8K_R}
        if base not in profiles:
            raise ValueError(
                "-z/--IMF needs 2K|4K|8K|2K_R|4K_R|8K_R"
                "[,mainlevel=X][,sublevel=Y][,framerate=FPS]")
        p.profile = (profiles[base] | (int(opts.get("sublevel", 0)) << 4)
                     | int(opts.get("mainlevel", 0)))
        if "framerate" in opts:
            p.framerate = int(opts["framerate"])
    if args.roi:
        kv = dict(f.split("=") for f in args.roi.split(","))
        p.roi_comp = int(kv.get("c", 0))
        p.roi_shift = int(kv.get("U", 0))
    if args.poc:
        from ..core.params import ProgressionChange

        for seg in args.poc.split("/"):
            f = seg.split(",")
            p.progression_changes.append(ProgressionChange(
                int(f[0]), int(f[1]), int(f[2]), int(f[3]), int(f[4]),
                ProgressionOrder[f[5].upper()],
            ))
    if args.custom_mct:
        import numpy as _np

        mat = _np.loadtxt(args.custom_mct, dtype=_np.float64)
        n2 = int(round(mat.size ** 0.5))
        p.mct_matrix = mat.reshape(n2, n2)
        p.mct = 2
    if args.compression_ratios:
        rates = [float(v) for v in args.compression_ratios.split(",")]
        p.layer_rates = rates
        p.num_layers = len(rates)
    elif args.quality:
        q = [float(v) for v in args.quality.split(",")]
        p.layer_psnrs = q
        p.num_layers = len(q)
    return p


def _profile_opts(val: str):
    """Parse '<BASE>[,k=v]...' (reference -U/-z syntax)."""
    parts = val.split(",")
    opts = dict(kv.split("=", 1) for kv in parts[1:] if "=" in kv)
    return parts[0].upper(), opts


def run_one(in_file: str, out_file: str, params: CompressParams, verbose: bool,
            args=None) -> None:
    raw_kw = {}
    if (args is not None and getattr(args, "keep_palette", False)
            and out_file.lower().endswith(".jp2")):
        raw_kw["keep_palette"] = True
    if args is not None and getattr(args, "raw", None):
        f = args.raw.split(",")  # w,h,ncomp,prec,{s,u}
        raw_kw = dict(w=int(f[0]), h=int(f[1]), nc=int(f[2]),
                      prec=int(f[3]), signed=f[4].lower().startswith("s"))
    img = load_image(in_file, **raw_kw)
    if args is not None and getattr(args, "capture_res", None):
        img.capture_resolution = tuple(
            float(v) for v in args.capture_res.split(","))
    if args is not None and getattr(args, "display_res", None):
        img.display_resolution = tuple(
            float(v) for v in args.display_res.split(","))
    if not (args is not None and getattr(args, "transfer_exif", False)):
        img.exif = None  # EXIF rides into the JP2 only under -V
    reps = getattr(args, "repetitions", 1) if args is not None else 1
    duration = getattr(args, "duration", None) if args is not None else None
    t0 = time.perf_counter()
    if duration:
        # -J: repeat for a fixed wall-clock budget (reference DurationArg)
        reps = 0
        while time.perf_counter() - t0 < duration or reps == 0:
            stream = compress(img, params)
            reps += 1
    else:
        for _ in range(max(1, reps)):
            stream = compress(img, params)
    if out_file.lower().endswith(".jp2"):
        stream = wrap_jp2(stream, img)
    with open(out_file, "wb") as f:
        f.write(stream)
    if verbose:
        dt = (time.perf_counter() - t0) / max(1, reps)
        mp = (img.x1 - img.x0) * (img.y1 - img.y0) / 1e6
        print(f"{in_file}: {len(stream)} bytes, {dt*1000:.1f} ms ({mp/dt:.2f} MP/s)")


def _cli_guard(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        params = params_from_args(args)
    except (ValueError, KeyError, IndexError) as e:
        print(f"error: invalid parameter value: {e}", file=sys.stderr)
        return 1
    if getattr(args, "plugin_path", None):
        from ..t1.plugin import load_plugin

        load_plugin(args.plugin_path)
    if getattr(args, "device_id", None) is not None:
        os.environ["GROK_TPU_DEVICE_ID"] = str(args.device_id)
    if args.in_file and os.path.splitext(args.in_file)[1].lower() in (
            ".raw", ".rawl") and not args.raw:
        print("error: raw input requires -F w,h,ncomp,prec,{s,u}",
              file=sys.stderr)
        return 1
    if args.batch_src:
        outdir = args.out_dir or args.batch_src
        exts = ("*.png", "*.pgm", "*.ppm", "*.tif", "*.tiff", "*.bmp", "*.pgx")
        files = sorted(sum((glob.glob(os.path.join(args.batch_src, e)) for e in exts), []))
        for f in files:
            out = os.path.join(outdir, os.path.splitext(os.path.basename(f))[0] + ".j2k")
            run_one(f, out, params, args.verbose, args)
        return 0
    if not args.in_file or not args.out_file:
        print("error: -i and -o required (or -y batch mode)", file=sys.stderr)
        return 2
    run_one(args.in_file, args.out_file, params, args.verbose, args)
    from ..core import trace

    if trace.enabled():
        trace.report()
    return 0


def main(argv=None) -> int:
    from ..core.errors import GrokTpuError

    try:
        return _cli_guard(argv)
    except GrokTpuError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
