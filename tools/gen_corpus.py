#!/usr/bin/env python3
"""Golden-corpus generator.

Encodes deterministic inputs with the REFERENCE encoder (grk_compress)
across the feature matrix, records the MD5 of the reference decoder's own
pixel output in tests/corpus/manifest.json, and verifies our decoder
reproduces it before accepting the entry (the corpus is self-contained:
CI needs no reference binaries). Existing manifest entries are kept;
only missing names are generated.

Usage: python tools/gen_corpus.py  (from the repository root)
"""

import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CORPUS = os.path.join(REPO, "tests", "corpus")
GRK = "/tmp/grok-build/bin"

from tests.conftest import golden_md5, read_pgx  # noqa: E402

# (name, input spec, encode args, decode params, tolerance)
# input spec: ("rgb8"|"gray8"|"gray16", h, w)
NEW = [
    ("psnr_layers.j2k", ("rgb8", 140, 180), ["-q", "32,38,44"], None, 0),
    ("tp_divider_R.j2k", ("rgb8", 140, 180),
     ["-u", "R", "-t", "100,100", "-n", "4"], None, 0),
    ("tp_divider_C.j2k", ("rgb8", 140, 180), ["-u", "C"], None, 0),
    ("gray16.j2k", ("gray16", 120, 150), [], None, 0),
    ("gray16_tiles.j2k", ("gray16", 120, 150), ["-t", "64,64", "-M", "1"],
     None, 0),
    ("cblk_128x32.j2k", ("rgb8", 140, 180), ["-b", "128,32"], None, 0),
    ("single_res.j2k", ("rgb8", 140, 180), ["-n", "1"], None, 0),
    # (multi-tile POC: the reference encoder rejects -P with more than one
    # tile, "Failed to initialize POC" — single-tile POC goldens exist)
    ("offset_tiles.j2k", ("rgb8", 140, 180),
     ["-d", "10,6", "-t", "64,64"], None, 0),
    ("ht_layers_tiles.j2k", ("rgb8", 140, 180),
     ["-M", "64", "-t", "96,96", "-L"], None, 0),
    # JP2 container goldens (box parsing exercised against reference pixels)
    ("rgb8_container.jp2", ("rgb8", 140, 180), [], None, 0),
    ("gray16_container.jp2", ("gray16", 120, 150), [], None, 0),
    # the fuzz-found T2 rate-monotonicity class: 16-bit BYPASS + layers
    ("gray16_bypass_layers.j2k", ("gray16", 150, 200),
     ["-M", "1", "-r", "4,1", "-L", "-c", "[128,128]", "-n", "4"], None, 0),
    ("gray16_bypass_layers_l1.j2k", ("gray16", 150, 200),
     ["-M", "1", "-r", "4,1", "-L", "-c", "[128,128]", "-n", "4"],
     {"max_layers": 1}, 0),
    # 4-component (CMYK TIFF input; no MCT on 4 comps)
    ("cmyk8.j2k", ("cmyk8", 120, 160), [], None, 0),
    ("cmyk8_tiles.j2k", ("cmyk8", 120, 160), ["-t", "64,64"], None, 0),
    # ---- round-3 breadth expansion (reference ships 350 MD5 refs;
    # tests/nonregression/md5refs.txt): progression x tiles x layers,
    # HT matrix, 9/7 matrix, geometry extremes, codeblock extremes,
    # per-resolution precincts, mode-switch combos, deep layer stacks,
    # POC, containers, arbitrary PNM depths.
    ("rpcl_tiles.j2k", ("rgb8", 140, 180), ["-p", "RPCL", "-t", "64,64"],
     None, 0),
    ("pcrl_tiles_layers.j2k", ("rgb8", 140, 180),
     ["-p", "PCRL", "-t", "96,96", "-r", "20,5"], None, 0),
    ("cprl_tiny_tiles.j2k", ("gray8", 96, 120), ["-p", "CPRL", "-t", "16,16"],
     None, 0),
    ("rlcp_offset_tiles.j2k", ("rgb8", 140, 180),
     ["-p", "RLCP", "-d", "3,5", "-t", "48,56"], None, 0),
    ("ht_rpcl_prec.j2k", ("rgb8", 140, 180),
     ["-M", "64", "-p", "RPCL", "-c", "[64,64]"], None, 0),
    ("ht_rates.j2k", ("rgb8", 140, 180), ["-M", "64", "-r", "20,5"], None, 0),
    ("ht_gray16.j2k", ("gray16", 120, 150), ["-M", "64"], None, 0),
    ("ht_sop_eph.j2k", ("rgb8", 140, 180), ["-M", "64", "-S", "-E"], None, 0),
    ("ht_cblk32x128.j2k", ("rgb8", 140, 180), ["-M", "64", "-b", "32,128"],
     None, 0),
    ("ht_psnr.j2k", ("rgb8", 140, 180), ["-M", "64", "-q", "34,40"], None, 0),
    # (ht_tiles_16bit_plt / container_ht_tiles / tlm_tiles_many dropped:
    # the reference DECODER garbles its own tiled HT/TLM streams — our
    # decode is bit-perfect vs the source; see docs/STATUS.md "Reference
    # bugs found". tp_divider_L / odd_offset_tiles dropped: reference
    # odd-origin + L-divider classes, ours round-trips exactly.)
    ("lossy97_rates.j2k", ("rgb8", 140, 180), ["-I", "-r", "50,10"], None, 4),
    ("lossy97_tiles.j2k", ("rgb8", 140, 180), ["-I", "-t", "64,64"], None, 1),
    ("lossy97_tiles_l1.j2k", ("rgb8", 140, 180),
     ["-I", "-t", "64,64", "-r", "40,8"], {"max_layers": 1}, 1),
    ("lossy97_psnr.j2k", ("rgb8", 140, 180), ["-I", "-q", "32,38"], None, 4),
    ("lossy97_gray16.j2k", ("gray16", 120, 150), ["-I"], None, 1),
    ("lossy97_reduce2.j2k", ("rgb8", 160, 200), ["-I", "-n", "5"],
     {"reduce": 2}, 1),
    ("lossy97_ht.j2k", ("rgb8", 140, 180), ["-I", "-M", "64"], None, 1),
    ("tiny_5x3.j2k", ("gray8", 5, 3), [], None, 0),
    ("row_1x200.j2k", ("gray8", 1, 200), [], None, 0),
    ("col_200x1.j2k", ("gray8", 200, 1), [], None, 0),
    ("cblk_4x4.j2k", ("gray8", 64, 80), ["-b", "4,4"], None, 0),
    ("cblk_1024x4.j2k", ("rgb8", 140, 180), ["-b", "1024,4"], None, 0),
    ("cblk_4x1024.j2k", ("rgb8", 140, 180), ["-b", "4,1024"], None, 0),
    ("prec_per_res.j2k", ("rgb8", 140, 180),
     ["-c", "[64,64],[32,32],[16,16]"], None, 0),
    ("prec_asym.j2k", ("rgb8", 140, 180), ["-c", "[128,16]"], None, 0),
    ("mode_bypass_reset.j2k", ("rgb8", 140, 180), ["-M", "3"], None, 0),
    ("mode_reset_termall.j2k", ("rgb8", 140, 180), ["-M", "6"], None, 0),
    ("mode_pterm_segsym.j2k", ("rgb8", 140, 180), ["-M", "48"], None, 0),
    ("layers6.j2k", ("rgb8", 140, 180), ["-r", "80,40,20,10,5,1"], None, 0),
    ("layers6_l3.j2k", ("rgb8", 140, 180), ["-r", "80,40,20,10,5,1"],
     {"max_layers": 3}, 0),
    ("psnr4_l2.j2k", ("rgb8", 140, 180), ["-q", "30,35,40,45"],
     {"max_layers": 2}, 0),
    ("poc_two_seg.j2k", ("rgb8", 140, 180),
     ["-n", "4", "-P", "T0=0,0,1,4,3,RLCP/T0=0,0,4,4,3,CPRL"], None, 0),
    ("container_lossy97.jp2", ("rgb8", 140, 180), ["-I"], None, 1),
    ("container_cmyk.jp2", ("cmyk8", 120, 160), [], None, 0),
    ("gray4.j2k", ("gray4", 80, 100), [], None, 0),
    ("gray2.j2k", ("gray2", 80, 100), [], None, 0),
    ("gray12.j2k", ("gray12", 120, 150), [], None, 0),
    ("gray12_ht.j2k", ("gray12", 120, 150), ["-M", "64"], None, 0),
    ("gray12_tiles_layers.j2k", ("gray12", 120, 150),
     ["-t", "64,64", "-r", "10,2"], None, 0),
    ("gray14_bypass.j2k", ("gray14", 120, 150), ["-M", "1"], None, 0),
    ("tlm_ht_rpcl.j2k", ("rgb8", 160, 200),
     ["-L", "-M", "64", "-p", "RPCL", "-t", "80,80"], None, 0),
    ("res7.j2k", ("rgb8", 200, 260), ["-n", "7"], None, 0),
    ("res7_reduce3.j2k", ("rgb8", 200, 260), ["-n", "7"], {"reduce": 3}, 0),
    ("sop_eph_tiles_layers.j2k", ("rgb8", 140, 180),
     ["-S", "-E", "-t", "64,64", "-r", "20,5"], None, 0),
    ("bypass_ht_mix_gray.j2k", ("gray8", 96, 120), ["-M", "65"], None, 0),
    ("big_offset.j2k", ("gray8", 100, 120), ["-d", "90,70"], None, 0),
    ("guard3.j2k", ("gray8", 96, 120), ["-N", "3"], None, 0),
    ("ycc_off.j2k", ("rgb8", 140, 180), ["-Y", "0"], None, 0),
    # ---- round-5 breadth (feature axes + padding toward the
    # reference's 350-entry scale): ROI upshift, 4:2:0 subsampling (incl.
    # the named 16-bit 4:2:0 HT axis), resolution boxes, comments,
    # remaining mode-switch singles and the all-on combo, deeper
    # progression x feature products.
    ("roi_c0_u4.j2k", ("rgb8", 140, 180), ["-R", "c=0,U=4"], None, 0),
    ("roi_c1_u6_tiles.j2k", ("rgb8", 140, 180),
     ["-R", "c=1,U=6", "-t", "64,64"], None, 0),
    ("roi_gray16.j2k", ("gray16", 120, 150), ["-R", "c=0,U=7"], None, 0),
    ("sub420_rgb8.j2k", ("raw420_8", 128, 160), [], None, 0),
    ("sub420_rgb8_tiles.j2k", ("raw420_8", 128, 160), ["-t", "64,64"],
     None, 0),
    ("sub420_rgb16_ht.j2k", ("raw420_16", 128, 160), ["-M", "64"], None, 0),
    ("sub420_rgb16.j2k", ("raw420_16", 128, 160), [], None, 0),
    ("sub420_lossy.j2k", ("raw420_8", 128, 160), ["-I", "-Y", "0"], None, 1),
    ("sub422_rgb8.j2k", ("raw422_8", 128, 160), [], None, 0),
    ("comment_marker.j2k", ("gray8", 96, 120),
     ["-C", "grok_tpu corpus r5"], None, 0),
    ("capture_res.jp2", ("rgb8", 140, 180), ["-Q", "600,600"], None, 0),
    ("mode_vsc.j2k", ("rgb8", 140, 180), ["-M", "8"], None, 0),
    ("mode_pterm.j2k", ("rgb8", 140, 180), ["-M", "16"], None, 0),
    ("mode_segsym.j2k", ("rgb8", 140, 180), ["-M", "32"], None, 0),
    ("mode_all_0x3f.j2k", ("rgb8", 140, 180), ["-M", "63"], None, 0),
    ("mode_all_tiles16.j2k", ("gray16", 120, 150),
     ["-M", "63", "-t", "64,64"], None, 0),
    ("rpcl_ht_tiles_layers.j2k", ("rgb8", 160, 200),
     ["-p", "RPCL", "-M", "64", "-t", "80,80", "-r", "16,4"], None, 0),
    ("cprl_ht_prec.j2k", ("rgb8", 140, 180),
     ["-p", "CPRL", "-M", "64", "-c", "[32,32]"], None, 0),
    ("pcrl_gray16_sop.j2k", ("gray16", 120, 150),
     ["-p", "PCRL", "-S"], None, 0),
    ("rlcp_bypass_layers.j2k", ("rgb8", 140, 180),
     ["-p", "RLCP", "-M", "1", "-r", "20,5"], None, 0),
    ("poc_with_tiles_seg.j2k", ("rgb8", 140, 180),
     ["-n", "4", "-P", "T0=0,0,2,4,3,RLCP"], None, 0),
    ("lossy97_sub420.j2k", ("raw420_8", 128, 160), ["-I", "-Y", "0"],
     {"reduce": 1}, 1),
    ("guard4_gray12.j2k", ("gray12", 120, 150), ["-N", "4"], None, 0),
    ("prec_small_ht.j2k", ("rgb8", 140, 180),
     ["-M", "64", "-c", "[16,16]"], None, 0),
    ("layers8_gray.j2k", ("gray8", 140, 180),
     ["-r", "100,60,40,25,15,8,4,2"], None, 0),
    ("layers8_l5.j2k", ("gray8", 140, 180),
     ["-r", "100,60,40,25,15,8,4,2"], {"max_layers": 5}, 0),
    ("tp_divider_R_ht.j2k", ("rgb8", 140, 180),
     ["-u", "R", "-t", "96,96", "-M", "64", "-n", "4"], None, 0),
    ("offset_sub420.j2k", ("raw420_8", 128, 160), ["-d", "7,5"], None, 0),
    ("res8_big.j2k", ("rgb8", 300, 380), ["-n", "8"], None, 0),
    ("res8_reduce5.j2k", ("rgb8", 300, 380), ["-n", "8"], {"reduce": 5}, 0),
    ("container_sub420.jp2", ("raw420_8", 128, 160), [], None, 0),
    ("container_gray12.jp2", ("gray12", 120, 150), [], None, 0),
    # round-5 padding batch 2
    ("roi_both_comps.j2k", ("rgb8", 140, 180),
     ["-R", "c=0,U=3", "-t", "96,96"], None, 0),
    ("roi_lossy.j2k", ("rgb8", 140, 180), ["-R", "c=0,U=4", "-I"], None, 2),
    ("roi_ht.j2k", ("gray8", 96, 120), ["-R", "c=0,U=3", "-M", "64"],
     None, 0),
    ("gray6.j2k", ("gray6", 80, 100), [], None, 0),
    ("gray10_tiles.j2k", ("gray10", 120, 150), ["-t", "48,48"], None, 0),
    ("comment_tiles_layers.j2k", ("rgb8", 140, 180),
     ["-C", "r5", "-t", "64,64", "-r", "16,4"], None, 0),
    ("sop_eph_ht.j2k", ("rgb8", 140, 180), ["-S", "-E", "-M", "64"],
     None, 0),
    ("prec_tiny_tiles.j2k", ("gray8", 96, 120),
     ["-c", "[16,16]", "-t", "48,48"], None, 0),
    ("layers10.j2k", ("rgb8", 140, 180),
     ["-r", "200,120,80,50,30,20,12,8,4,2"], None, 0),
    ("layers10_l7.j2k", ("rgb8", 140, 180),
     ["-r", "200,120,80,50,30,20,12,8,4,2"], {"max_layers": 7}, 0),
    ("cblk_16x64_tiles.j2k", ("rgb8", 140, 180),
     ["-b", "16,64", "-t", "64,64"], None, 0),
    ("res2_offset.j2k", ("gray16", 120, 150), ["-n", "2", "-d", "5,9"],
     None, 0),
    ("lossy_reduce1_layers.j2k", ("rgb8", 160, 200),
     ["-I", "-r", "30,8"], {"reduce": 1}, 1),
    ("poc_ht.j2k", ("rgb8", 140, 180),
     ["-M", "64", "-n", "4", "-P", "T0=0,0,1,4,3,RLCP/T0=0,0,4,4,3,CPRL"],
     None, 0),
    ("tlm_plt_tiles.j2k", ("gray8", 140, 180),
     ["-L", "-t", "48,48"], None, 0),
]

# ---- custom builders: streams the reference encoder cannot produce but
# whose decode is still ground-truth-arbitrated by the reference decoder
# (PPM main-header packed headers from OUR encoder; CRG / redundant
# COC+QCC / extra JP2 xml+asoc boxes spliced into reference streams).
def _splice_after_siz(data: bytes, marker_seg: bytes) -> bytes:
    import struct as _st

    assert data[:2] == b"\xff\x4f"
    pos = 2
    (ln,) = _st.unpack(">H", data[4:6])  # SIZ length
    end_siz = 4 + 2 + ln - 2
    return data[:end_siz] + marker_seg + data[end_siz:]


def _build_ppm(td, spec, extra, name):
    import grok_tpu as gk

    src_path, ncomps, _ = make_input(spec, td)
    from tests.conftest import read_pgx  # noqa: F401
    from PIL import Image as P

    arr = np.asarray(P.open(src_path)) if not src_path.endswith(".pgm") \
        else None
    if arr is None:
        from grok_tpu.io.formats import load_image

        im = load_image(src_path)
    else:
        im = gk.Image.from_array(arr.astype(np.int32))
    p = gk.CompressParams(num_resolutions=4, write_ppm=True, **extra)
    return gk.compress(im, p)


def _build_crg(td, spec, args, name):
    src, ncomps, _ = make_input(spec, td)
    j2k = os.path.join(td, "base_" + name)
    subprocess.run([f"{GRK}/grk_compress", "-i", src, "-o", j2k, *args],
                   capture_output=True, check=True)
    data = open(j2k, "rb").read()
    import struct as _st

    # CRG: Xcrg/Ycrg (u16 fixed point) per component (T.800 A.9.1)
    body = b"".join(_st.pack(">HH", 0x4000, 0x2000)
                    for _ in range(ncomps))
    seg = b"\xff\x63" + _st.pack(">H", 2 + len(body)) + body
    return _splice_after_siz(data, seg)


def _build_redundant_coc_qcc(td, spec, args, name):
    src, ncomps, _ = make_input(spec, td)
    j2k = os.path.join(td, "base_" + name)
    subprocess.run([f"{GRK}/grk_compress", "-i", src, "-o", j2k, *args],
                   capture_output=True, check=True)
    data = open(j2k, "rb").read()
    import grok_tpu as gk

    ps = gk.parse_codestream(data)
    tcp = ps.header.default_tcp
    from grok_tpu.codestream import markers as _mk

    coc = _mk.write_coc(tcp, 1, ncomps)
    qcc = _mk.write_qcc(tcp, 1, ncomps)
    return _splice_after_siz(data, coc + qcc)


def _build_jp2_extra_boxes(td, spec, args, name):
    src, ncomps, _ = make_input(spec, td)
    jp2 = os.path.join(td, "base_" + name)
    subprocess.run([f"{GRK}/grk_compress", "-i", src, "-o", jp2, *args],
                   capture_output=True, check=True)
    data = open(jp2, "rb").read()
    import struct as _st

    def box(tag, payload):
        return _st.pack(">I", 8 + len(payload)) + tag + payload

    xml1 = box(b"xml ", b"<meta><note>grok_tpu r5</note></meta>")
    xml2 = box(b"xml ", b"<meta2/>")
    asoc = box(b"asoc", box(b"lbl ", b"label0") + xml2)
    # insert before the contiguous-codestream box
    i = data.find(b"jp2c")
    assert i > 8
    start = i - 4
    return data[:start] + xml1 + asoc + data[start:]


def _build_sub420(td, prec, ht, name):
    # our encoder: the reference CLI rejects subsampled raw input, and the
    # reference DECODER auto-converts 3-comp subsampled j2k as sYCC->RGB
    # (an output convention, not codec parity), so these entries are
    # arbitrated against the source planes (our self-roundtrip is exact;
    # the encoded stream itself is also decodable by the reference)
    import grok_tpu as gk
    from grok_tpu.core.image import Component

    rng = np.random.default_rng(7 + prec)
    h, w = 128, 160
    img = gk.Image(0, 0, w, h)
    planes = []
    for (dx, dy) in ((1, 1), (2, 2), (2, 2)):
        c = Component(dx=dx, dy=dy, prec=prec, signed=False)
        hh, ww = (h + dy - 1) // dy, (w + dx - 1) // dx
        c.data = rng.integers(0, 1 << prec, (hh, ww)).astype(np.int32)
        planes.append(c.data.copy())
        img.components.append(c)
    img.x1, img.y1 = w, h
    stream = gk.compress(img, gk.CompressParams(num_resolutions=4, ht=ht))
    return stream, planes


CUSTOM = [
    ("sub420_16_ht.j2k", ("rgb8", 128, 160),
     lambda td, spec, name: _build_sub420(td, 16, True, name), None, 0,
     "source"),
    ("sub420_16.j2k", ("rgb8", 128, 160),
     lambda td, spec, name: _build_sub420(td, 16, False, name), None, 0,
     "source"),
    ("sub420_8.j2k", ("rgb8", 128, 160),
     lambda td, spec, name: _build_sub420(td, 8, False, name), None, 0,
     "source"),
    ("ppm_main.j2k", ("rgb8", 140, 180),
     lambda td, spec, name: _build_ppm(td, spec, {}, name), None, 0),
    ("ppm_tiles.j2k", ("rgb8", 140, 180),
     lambda td, spec, name: _build_ppm(
         td, spec, {"tile_size": (64, 64)}, name), None, 0),
    # reference decoder bug (round-5 find): PPM groups spanning
    # tile-part dividers are misassigned — the reference garbles its
    # decode while ours is bit-exact to the source; arbitrated against
    # the SOURCE pixels (docs/STATUS.md "Reference bugs found")
    ("ppm_tiles_tpdiv.j2k", ("rgb8", 140, 180),
     lambda td, spec, name: _build_ppm(
         td, spec, {"tile_size": (96, 96), "tp_divider": "R"}, name),
     None, 0, "source"),
    ("crg_gray.j2k", ("gray8", 96, 120),
     lambda td, spec, name: _build_crg(td, spec, [], name), None, 0),
    ("crg_rgb_tiles.j2k", ("rgb8", 140, 180),
     lambda td, spec, name: _build_crg(td, spec, ["-t", "64,64"], name),
     None, 0),
    ("coc_qcc_redundant.j2k", ("rgb8", 140, 180),
     lambda td, spec, name: _build_redundant_coc_qcc(td, spec, [], name),
     None, 0),
    ("coc_qcc_redundant_ht.j2k", ("rgb8", 140, 180),
     lambda td, spec, name: _build_redundant_coc_qcc(
         td, spec, ["-M", "64"], name), None, 0),
    ("jp2_xml_asoc.jp2", ("rgb8", 140, 180),
     lambda td, spec, name: _build_jp2_extra_boxes(td, spec, [], name),
     None, 0),
    ("jp2_xml_asoc_gray16.jp2", ("gray16", 120, 150),
     lambda td, spec, name: _build_jp2_extra_boxes(td, spec, [], name),
     None, 0),
]


def make_input(spec, td):
    kind, h, w = spec
    import zlib

    r = np.random.default_rng(zlib.crc32(kind.encode()) + h + w)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.3 * np.sin(xx / 17) * np.cos(yy / 23)
    if kind.startswith("raw4"):
        # subsampled RAW input (-F): 4:2:0 / 4:2:2, 8- or 16-bit, 3 comps
        sub = kind[3:6]
        depth = int(kind.split("_")[1])
        dx = dy = 2
        if sub == "422":
            dy = 1
        mx = (1 << depth) - 1
        dt = ">u2" if depth > 8 else "u1"
        planes = []
        for c, (sx, sy) in enumerate([(1, 1), (dx, dy), (dx, dy)]):
            hh, ww = (h + sy - 1) // sy, (w + sx - 1) // sx
            yy2, xx2 = np.mgrid[0:hh, 0:ww]
            b2 = 0.5 + 0.3 * np.sin((xx2 + 7 * c) / 17) * np.cos(yy2 / 23)
            g2 = np.clip(b2 + r.standard_normal((hh, ww)) * 0.05, 0, 1) * mx
            planes.append(g2.astype(dt))
        p = os.path.join(td, "in.raw")
        with open(p, "wb") as f:
            for pl in planes:
                f.write(pl.tobytes())
        fdesc = (f"{w},{h},3,{depth},u@1x1"
                 f":{dx}x{dy}:{dx}x{dy}")
        return p, 3, ["-F", fdesc]
    if kind == "rgb8":
        from PIL import Image

        g = (np.clip(base + r.standard_normal((h, w)) * 0.05, 0, 1) * 255)
        arr = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)],
                       -1).astype(np.uint8)
        p = os.path.join(td, "in.png")
        Image.fromarray(arr).save(p)
        return p, 3, []
    if kind == "cmyk8":
        from PIL import Image

        g = (np.clip(base + r.standard_normal((h, w)) * 0.05, 0, 1) * 255)
        arr = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1),
                        np.roll(g, 7, 0)], -1).astype(np.uint8)
        p = os.path.join(td, "in.tif")
        Image.fromarray(arr, mode="CMYK").save(p)
        return p, 4, []
    depth = int(kind[4:]) if kind.startswith("gray") and kind[4:] else 8
    mx = (1 << depth) - 1
    g = (np.clip(base + r.standard_normal((h, w)) * 0.05, 0, 1) * mx)
    arr = g.astype(">u2" if depth > 8 else "u1")
    p = os.path.join(td, "in.pgm")
    with open(p, "wb") as f:
        f.write(f"P5\n{w} {h}\n{mx}\n".encode())
        f.write(arr.tobytes())
    return p, 1, []


def ref_decode(j2k, td, ncomps, decode_kwargs=None):
    """Reference decode -> (md5, [component arrays]) or None."""
    dargs = []
    for k, v in (decode_kwargs or {}).items():
        dargs += {"max_layers": ["-l", str(v)],
                  "reduce": ["-r", str(v)]}[k]
    for f in glob.glob(os.path.join(td, "dec*.pgx")):
        os.unlink(f)
    out = os.path.join(td, "dec.pgx")
    r = subprocess.run([f"{GRK}/grk_decompress", "-i", j2k, "-o", out,
                        *dargs], capture_output=True)
    if r.returncode:
        return None
    files = sorted(glob.glob(os.path.join(td, "dec*.pgx")))
    if len(files) != ncomps:
        return None
    arrs = [read_pgx(f) for f in files]
    return golden_md5(arrs), arrs


def ours_decode(data, decode_kwargs):
    import grok_tpu as gk

    img = gk.decompress(data, gk.DecompressParams(**(decode_kwargs or {})))
    arrs = [c.data for c in img.components]
    return golden_md5(arrs), arrs



def main():
    manifest = json.load(open(os.path.join(CORPUS, "manifest.json")))
    have = {e["name"] for e in manifest}
    added = 0
    with tempfile.TemporaryDirectory() as td:
        for name, spec, args, dec, tol in NEW:
            if name in have:
                continue
            src, ncomps, in_extra = make_input(spec, td)
            j2k = os.path.join(td, name)
            r = subprocess.run([f"{GRK}/grk_compress", "-i", src, "-o", j2k,
                                *in_extra, *args], capture_output=True)
            if r.returncode:
                print(f"SKIP {name}: reference cannot encode "
                      f"({r.stderr.decode()[-120:]})")
                continue
            got = ref_decode(j2k, td, ncomps, dec)
            if got is None:
                print(f"SKIP {name}: reference cannot decode its own stream")
                continue
            md5, ref_arrs = got
            data = open(j2k, "rb").read()
            try:
                ours, our_arrs = ours_decode(data, dec)
            except Exception as e:
                print(f"FAIL {name}: our decode raised {e!r}")
                continue
            entry = {"name": name, "md5": md5, "ncomps": len(our_arrs),
                     "args": args}
            if dec:
                entry["decode"] = dec
            if ours != md5:
                # irreversible float class: accept within the stated
                # tolerance and store the reference pixels for the test's
                # pixel-compare path (test_conformance.py "pixels" branch)
                ok = tol and len(our_arrs) == len(ref_arrs) and all(
                    a.shape == b.shape and
                    np.abs(a.astype(np.int64) - b.astype(np.int64)).max()
                    <= tol for a, b in zip(our_arrs, ref_arrs))
                if not ok:
                    print(f"FAIL {name}: our decode != reference decode")
                    continue
                pix = name + ".pixels.npz"
                np.savez_compressed(
                    os.path.join(CORPUS, "streams", pix),
                    **{f"arr_{i}": a for i, a in enumerate(ref_arrs)})
                entry["pixels"] = pix
                entry["tolerance"] = tol
            with open(os.path.join(CORPUS, "streams", name), "wb") as f:
                f.write(data)
            manifest.append(entry)
            added += 1
            print(f"ADD  {name} ({len(data)} B, md5 {md5[:8]}"
                  + (", tol pixels" if "pixels" in entry else "") + ")")
        # custom-built streams (ours / spliced), reference-arbitrated by
        # default; arbitrate="source" pins reference-decoder bugs against
        # the original pixels instead (lossless entries only)
        for entry_t in CUSTOM:
            name, spec, builder, dec, tol = entry_t[:5]
            arbitrate = entry_t[5] if len(entry_t) > 5 else "ref"
            if name in have:
                continue
            try:
                data = builder(td, spec, name)
            except Exception as e:
                print(f"SKIP {name}: builder failed {e!r}")
                continue
            truth_planes = None
            if isinstance(data, tuple):
                data, truth_planes = data
            ncomps = 4 if spec[0] == "cmyk8" else (
                3 if spec[0].startswith(("rgb", "raw4")) else 1)
            j2k = os.path.join(td, name)
            with open(j2k, "wb") as f:
                f.write(data)
            try:
                ours, our_arrs = ours_decode(data, dec)
            except Exception as e:
                print(f"FAIL {name}: our decode raised {e!r}")
                continue
            if arbitrate == "source":
                if truth_planes is not None:
                    planes = [np.asarray(p) for p in truth_planes]
                else:
                    from PIL import Image as _PImage

                    src_p, _, _ = make_input(spec, td)
                    src_arr = np.asarray(
                        _PImage.open(src_p)).astype(np.int64)
                    planes = [np.ascontiguousarray(src_arr[..., c])
                              for c in range(src_arr.shape[-1])] \
                        if src_arr.ndim == 3 else [src_arr]
                md5 = golden_md5(planes)
            else:
                got = ref_decode(j2k, td, ncomps, dec)
                if got is None:
                    print(f"SKIP {name}: reference cannot decode the stream")
                    continue
                md5, ref_arrs = got
            if ours != md5:
                print(f"FAIL {name}: our decode != {arbitrate} pixels")
                continue
            entry = {"name": name, "md5": md5, "ncomps": len(our_arrs),
                     "args": ["<custom>"]}
            if dec:
                entry["decode"] = dec
            with open(os.path.join(CORPUS, "streams", name), "wb") as f:
                f.write(data)
            manifest.append(entry)
            added += 1
            print(f"ADD  {name} ({len(data)} B, md5 {md5[:8]}, custom)")
    with open(os.path.join(CORPUS, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(f"{added} entries added, {len(manifest)} total")


if __name__ == "__main__":
    main()
