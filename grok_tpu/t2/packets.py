"""Packet header codec + packet assembly (T.800 B.9/B.10).

Parity targets: t2/T2Compress.cpp (compressPacket/compressHeader) and
t2/T2Decompress.cpp (readPacketHeader/readPacketData), re-derived from the
standard. Host-side serial work; the heavy payload bytes
come straight from the batched T1 coder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..codestream.bitio import BitReader, BitWriter
from ..core.errors import CorruptPacketError
from ..tile.geometry import BandGeom, PrecinctGeom
from .tagtree import TagTree


def _floor_log2(n: int) -> int:
    return n.bit_length() - 1


def _segment_splits(style: int, start_pass: int, npasses: int) -> list[int]:
    """Pass counts of the codeword segments covering passes
    [start_pass, start_pass + npasses) (T.800 D.4 termination rules)."""
    if style & 0x40:
        # HT (T.814): the cleanup pass terminates its segment; SigProp and
        # MagRef of the same HT set share the following segment
        out = []
        for p in range(start_pass, start_pass + npasses):
            if p % 3 == 2 and out and (p - 1) >= start_pass and (p - 1) % 3 == 1:
                out[-1] += 1  # MagRef joins its SigProp segment
            else:
                out.append(1)
        return out
    if style & 0x04:  # TERMALL: every pass is its own segment
        return [1] * npasses
    if style & 0x01:  # BYPASS: boundaries at MQ<->raw coder switches
        def typ(p):
            return 2 if p == 0 else (p - 1) % 3

        def term_after(p):
            t = typ(p)
            return p == 9 or (p > 9 and t in (1, 2))

        out = []
        cur = 0
        for p in range(start_pass, start_pass + npasses):
            cur += 1
            if term_after(p):
                out.append(cur)
                cur = 0
        if cur:
            out.append(cur)
        return out
    return [npasses]


def write_numpasses(bio: BitWriter, n: int) -> None:
    if n == 1:
        bio.write_bit(0)
    elif n == 2:
        bio.write_bits(0b10, 2)
    elif n <= 5:
        bio.write_bits(0b11, 2)
        bio.write_bits(n - 3, 2)
    elif n <= 36:
        bio.write_bits(0b1111, 4)
        bio.write_bits(n - 6, 5)
    else:
        bio.write_bits(0b111111111, 9)
        bio.write_bits(n - 37, 7)


def read_numpasses(bio: BitReader) -> int:
    if not bio.read_bit():
        return 1
    if not bio.read_bit():
        return 2
    v = bio.read_bits(2)
    if v < 3:
        return 3 + v
    v = bio.read_bits(5)
    if v < 31:
        return 6 + v
    return 37 + bio.read_bits(7)


@dataclass
class CblkEnc:
    """Encoder-side codeblock T2 record."""

    data: np.ndarray  # uint8 segment bytes
    total_len: int
    npasses: int
    numbps: int  # coded magnitude planes (imsb = band Mb - numbps)
    # layer split: (passes_added, bytes_added) per layer
    layer_passes: list[int] = field(default_factory=list)
    layer_bytes: list[int] = field(default_factory=list)
    # mutable header state
    lblock: int = 3
    included: bool = False
    passes_done: int = 0
    bytes_done: int = 0
    first_layer: int = 0
    style: int = 0  # codeblock style (segmentation: TERMALL/PTERM)
    pass_rates: object = None  # cumulative exact byte offsets per pass


@dataclass
class CblkDec:
    """Decoder-side codeblock T2 record."""

    segments: list[bytes] = field(default_factory=list)
    seg_passes: list[int] = field(default_factory=list)
    npasses: int = 0
    numbps: int = 0  # set on first inclusion from imsb tree
    lblock: int = 3
    included: bool = False
    style: int = 0


class PrecinctCtx:
    """Per-(band, precinct) mutable header-coding state."""

    def __init__(self, band: BandGeom, prc: PrecinctGeom):
        self.band = band
        self.prc = prc
        self.incl_tree = TagTree(prc.cblk_grid_w, prc.cblk_grid_h)
        self.imsb_tree = TagTree(prc.cblk_grid_w, prc.cblk_grid_h)
        self.cblks: list = [None] * len(prc.cblks)

    def set_encoder_trees(self, num_layers: int) -> None:
        gw, gh = self.prc.cblk_grid_w, self.prc.cblk_grid_h
        if gw == 0 or gh == 0:
            return
        incl = np.full((gh, gw), num_layers, dtype=np.int64)
        imsb = np.zeros((gh, gw), dtype=np.int64)
        for geom, cb in zip(self.prc.cblks, self.cblks):
            if cb is None:
                continue
            incl[geom.cy, geom.cx] = cb.first_layer if cb.npasses > 0 else num_layers
            imsb[geom.cy, geom.cx] = self.band.num_bps - cb.numbps
        self.incl_tree.set_values(incl)
        self.imsb_tree.set_values(imsb)


# ----------------------------------------------------------------- encode
def encode_packet(
    bio_parts: list[bytes],
    prc_ctxs: list[PrecinctCtx],
    layer: int,
    use_sop: bool = False,
    use_eph: bool = False,
    sop_index: int = 0,
    packed_headers: list[bytes] | None = None,
) -> bytes:
    """Encode one packet (all bands of one precinct of one res/comp/layer).

    Returns the packet bytes (header + body)."""
    bio = BitWriter()
    body = bytearray()
    any_data = False
    for ctx in prc_ctxs:
        for cb in ctx.cblks:
            if cb is None:
                continue
            if layer < len(cb.layer_passes) and cb.layer_passes[layer] > 0:
                any_data = True
                break
        if any_data:
            break

    if not any_data:
        bio.write_bit(0)
        bio.flush()
        out = bio.getvalue()
    else:
        bio.write_bit(1)
        for ctx in prc_ctxs:
            for geom, cb in zip(ctx.prc.cblks, ctx.cblks):
                if cb is None:
                    continue
                npl = cb.layer_passes[layer] if layer < len(cb.layer_passes) else 0
                if not cb.included:
                    ctx.incl_tree.encode(bio, geom.cx, geom.cy, layer + 1)
                else:
                    bio.write_bit(1 if npl > 0 else 0)
                if npl == 0:
                    continue
                if not cb.included:
                    # first inclusion: signal missing MSBs via the imsb tree
                    imsb = ctx.band.num_bps - cb.numbps
                    ctx.imsb_tree.encode(bio, geom.cx, geom.cy, imsb + 1)
                    cb.included = True
                write_numpasses(bio, npl)
                # length signalling: one length per codeword segment
                # (T.800 B.10.7.2), single comma-code for the contribution
                splits = _segment_splits(cb.style, cb.passes_done, npl)
                if len(splits) == 1:
                    seg_bytes = [cb.layer_bytes[layer]]
                else:
                    r = cb.pass_rates
                    p0 = cb.passes_done
                    seg_bytes = []
                    prev = int(r[p0 - 1]) if p0 > 0 else 0
                    pcur = p0
                    for np_s in splits:
                        pcur += np_s
                        cur = int(r[pcur - 1])
                        seg_bytes.append(cur - prev)
                        prev = cur
                inc = 0
                for np_s, nb_s in zip(splits, seg_bytes):
                    needed = max(1, int(nb_s).bit_length())
                    inc = max(inc, needed - (cb.lblock + _floor_log2(np_s)))
                for _ in range(inc):
                    bio.write_bit(1)
                cb.lblock += inc
                bio.write_bit(0)
                for np_s, nb_s in zip(splits, seg_bytes):
                    bio.write_bits(nb_s, cb.lblock + _floor_log2(np_s))
                nbytes = sum(seg_bytes)
                body += bytes(
                    cb.data[cb.bytes_done : cb.bytes_done + nbytes].tobytes()
                    if isinstance(cb.data, np.ndarray)
                    else cb.data[cb.bytes_done : cb.bytes_done + nbytes]
                )
                cb.bytes_done += nbytes
                cb.passes_done += npl
        bio.flush()
        out = bio.getvalue()

    pkt = bytearray()
    if use_sop:
        pkt += b"\xff\x91" + (4).to_bytes(2, "big") + (sop_index & 0xFFFF).to_bytes(2, "big")
    if packed_headers is not None:
        # PPT/PPM mode: header (+EPH) goes to the packed stream, only the
        # body (and SOP) stays in the bitstream
        hdr = bytearray(out)
        if use_eph:
            hdr += b"\xff\x92"
        packed_headers.append(bytes(hdr))
    else:
        pkt += out
        if use_eph:
            pkt += b"\xff\x92"
    pkt += body
    bio_parts.append(bytes(pkt))
    return bytes(pkt)


# ----------------------------------------------------------------- decode
def decode_packet(
    data: memoryview,
    pos: int,
    prc_ctxs: list[PrecinctCtx],
    layer: int,
    use_sop: bool = False,
    use_eph: bool = False,
    hdr_reader: BitReader | None = None,
    drop: bool = False,
) -> int:
    """Parse one packet starting at data[pos]; returns new position.

    With packed packet headers (PPM/PPT), hdr_reader supplies the header
    bits and ``data`` carries only the packet bodies.

    ``drop`` parses the packet (keeping stream position and PPT bit-stream
    alignment for later wanted packets of interleaving progressions) but
    discards its codeblock contributions — used for unwanted mid-stream
    packets, e.g. truncated layers in non-layer-outermost progressions."""
    n = len(data)
    if use_sop and pos + 6 <= n and data[pos] == 0xFF and data[pos + 1] == 0x91:
        pos += 6
    packed = hdr_reader is not None
    bio = hdr_reader if packed else BitReader(data, pos)
    contributions: list[tuple[CblkDec, int, int]] = []  # (cblk, npasses, nbytes)
    if not bio.read_bit():
        bio.align()
        if not packed:
            pos = bio.byte_pos
    else:
        for ctx in prc_ctxs:
            for geom, cb in zip(ctx.prc.cblks, ctx.cblks):
                if cb is None:
                    continue
                if not cb.included:
                    inc = ctx.incl_tree.decode(bio, geom.cx, geom.cy, layer + 1)
                else:
                    inc = bool(bio.read_bit())
                if not inc:
                    continue
                if not cb.included:
                    imsb = ctx.imsb_tree.decode_value(bio, geom.cx, geom.cy)
                    cb.numbps = ctx.band.num_bps - imsb
                    if cb.numbps < 0:
                        raise CorruptPacketError("negative numbps")
                    cb.included = True
                npl = read_numpasses(bio)
                while bio.read_bit():
                    cb.lblock += 1
                    if cb.lblock > 32:
                        raise CorruptPacketError("runaway lblock")
                if cb.npasses + npl > 165:
                    raise CorruptPacketError("too many coding passes")
                for np_s in _segment_splits(cb.style, cb.npasses, npl):
                    nbytes = bio.read_bits(cb.lblock + _floor_log2(np_s))
                    contributions.append((cb, np_s, nbytes))
        bio.align()
        if not packed:
            pos = bio.byte_pos
    if use_eph:
        if packed:
            hb = hdr_reader._data
            hp = hdr_reader.byte_pos
            if hp + 2 <= len(hb) and hb[hp] == 0xFF and hb[hp + 1] == 0x92:
                hdr_reader._pos = hp + 2
        elif pos + 2 <= n and data[pos] == 0xFF and data[pos + 1] == 0x92:
            pos += 2
    for cb, npl, nbytes in contributions:
        if pos + nbytes > n:
            raise CorruptPacketError("packet body truncated")
        if not drop:
            cb.segments.append(bytes(data[pos : pos + nbytes]))
            cb.seg_passes.append(npl)
            cb.npasses += npl
        pos += nbytes
    return pos
