"""grok-tpu-decompress — CLI decoder (parity target: src/bin/jp2/grk_decompress)."""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from ..core.params import DecompressParams
from ..codestream.decompress import decompress
from ..codestream.jp2 import apply_palette, is_jp2, unwrap_jp2
from ..io.formats import save_image


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="grok-tpu-decompress",
        description="JPEG 2000 / HTJ2K decoder",
    )
    p.add_argument("-i", "--in_file")
    p.add_argument("-o", "--out_file")
    p.add_argument("-y", "--batch_src", help="directory of .j2k/.jp2 files")
    p.add_argument("-a", "--out_dir", help="output directory (batch mode)")
    p.add_argument("-O", "--out_format", default="png",
                   help="batch output format (png/tif/bmp/pnm/pgx/raw)")
    p.add_argument("-r", "--reduce", type=int, default=0,
                   help="discard this many highest resolution levels")
    p.add_argument("-l", "--layers", type=int, default=0, help="max quality layers")
    p.add_argument("-t", "--tile", type=int, default=None, help="decode a single tile")
    p.add_argument("-d", "--region", help="decode window x0,y0,x1,y1")
    p.add_argument("-p", "--precision",
                   help="force component precision: <bits>[C|S][,...] "
                        "(C clips, S scales; 0 = keep)")
    p.add_argument("-f", "--force_rgb", action="store_true",
                   help="convert to RGB (sYCC/CMYK/gray)")
    p.add_argument("-u", "--upsample", action="store_true",
                   help="replicate subsampled components to full resolution")
    p.add_argument("-s", "--split_pnm", action="store_true",
                   help="write one PNM file per component")
    p.add_argument("-X", "--xml", metavar="BASE",
                   help="store embedded XML metadata to BASE.xml")
    p.add_argument("-e", "--repetitions", type=int, default=1,
                   help="decode repeatedly (performance measurement)")
    p.add_argument("-c", "--compression", default=None,
                   help="TIF output compression (NONE/LZW/ZIP/PACKBITS/...)")
    p.add_argument("-L", "--compression_level", type=int, default=None,
                   help="PNG output compression level 0-9")
    p.add_argument("-W", "--logfile", help="append verbose output to this file")
    p.add_argument("-V", "--TransferExifTags", dest="transfer_exif",
                   action="store_true",
                   help="copy EXIF from the JP2 uuid box into the output")
    p.add_argument("-z", "--Duration", dest="duration", type=float,
                   help="repeat the decode for this many seconds (timing)")
    p.add_argument("-g", "--plugin_path",
                   help="load a T1 block-coder plugin shared library")
    p.add_argument("-G", "--device_id", type=int,
                   help="device index for the jax device pipeline")
    p.add_argument("-H", "--num_threads", type=int, default=0)
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _apply_precision(img, spec: str):
    """Reference -p: force per-component bit depth, clipped or scaled."""
    items = spec.split(",")
    for ci, comp in enumerate(img.components):
        it = items[min(ci, len(items) - 1)]
        mode = "C"
        if it and it[-1] in "CScs":
            mode = it[-1].upper()
            it = it[:-1]
        bits = int(it)
        if bits <= 0 or bits == comp.prec:
            continue
        a = comp.data.astype(np.int64)
        if mode == "S":
            if bits > comp.prec:
                a = a << (bits - comp.prec)
            else:
                a = a >> (comp.prec - bits)
        else:  # clip
            hi = (1 << bits) - 1
            lo = -(1 << (bits - 1)) if comp.signed else 0
            if comp.signed:
                hi = (1 << (bits - 1)) - 1
            a = np.clip(a, lo, hi)
        comp.data = a.astype(np.int32)
        comp.prec = bits
    return img


def run_one(in_file: str, out_file: str, args) -> None:
    params = DecompressParams(
        reduce=args.reduce,
        max_layers=args.layers,
        tile_index=args.tile,
    )
    if args.region:
        params.window = tuple(int(v) for v in args.region.split(","))
    reps = max(1, args.repetitions)
    duration = getattr(args, "duration", None)
    t0 = time.perf_counter()
    if duration:
        reps = 0
        while time.perf_counter() - t0 < duration or reps == 0:
            img = decompress(in_file, params)
            reps += 1
    else:
        for _ in range(reps):
            img = decompress(in_file, params)
    dt = (time.perf_counter() - t0) / reps
    if args.xml and getattr(img, "xml", None):
        with open(args.xml + ".xml", "wb") as f:
            f.write(img.xml if isinstance(img.xml, bytes) else b"".join(img.xml))
    if args.precision:
        img = _apply_precision(img, args.precision)
    if args.force_rgb or args.upsample:
        from ..io.color import force_rgb, upsample_components

        if args.upsample:
            img = upsample_components(img)
        if args.force_rgb:
            img = force_rgb(img)
    if args.split_pnm and len(img.components) > 1:
        base, ext = os.path.splitext(out_file)
        from ..core.image import Image

        for ci, comp in enumerate(img.components):
            one = Image(img.x0, img.y0, img.x1, img.y1)
            one.components.append(comp)
            save_image(f"{base}_{ci}{ext or '.pgm'}", one)
    else:
        save_kw = {}
        if args.compression and out_file.lower().endswith((".tif", ".tiff")):
            save_kw["compression"] = args.compression.lower()
        if args.compression_level is not None and out_file.lower().endswith(".png"):
            save_kw["compress_level"] = args.compression_level
        if getattr(args, "transfer_exif", False) and getattr(img, "exif", None):
            # PNG/JPEG/TIFF/WebP writers accept the raw EXIF blob; PIL
            # strips/keeps the Exif\0\0 header per format
            save_kw["exif"] = b"Exif\x00\x00" + img.exif
        save_image(out_file, img, **save_kw)
    if args.verbose or args.logfile:
        mp = sum(c.w * c.h for c in img.components) / 1e6
        line = (f"{in_file}: decoded {mp:.2f} MP in {dt*1000:.1f} ms "
                f"({mp/dt:.2f} MP/s)")
        if args.verbose:
            print(line)
        if args.logfile:
            with open(args.logfile, "a") as f:
                f.write(line + "\n")


def _cli_guard(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "plugin_path", None):
        from ..t1.plugin import load_plugin

        load_plugin(args.plugin_path)
    if getattr(args, "device_id", None) is not None:
        os.environ["GROK_TPU_DEVICE_ID"] = str(args.device_id)
    if args.batch_src:
        outdir = args.out_dir or args.batch_src
        files = sorted(
            glob.glob(os.path.join(args.batch_src, "*.j2k"))
            + glob.glob(os.path.join(args.batch_src, "*.j2c"))
            + glob.glob(os.path.join(args.batch_src, "*.jp2"))
        )
        if not files:
            print("error: no codestreams found in batch directory",
                  file=sys.stderr)
            return 1
        for f in files:
            out = os.path.join(
                outdir,
                os.path.splitext(os.path.basename(f))[0]
                + "." + args.out_format.lstrip(".").lower(),
            )
            run_one(f, out, args)
        return 0
    if not args.in_file or not args.out_file:
        print("error: -i and -o are required (or -y for batch mode)",
              file=sys.stderr)
        return 1
    run_one(args.in_file, args.out_file, args)
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
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
