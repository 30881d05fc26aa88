"""J2K marker segment read/write (T.800 Annex A; T.814 CAP extensions).

Parity targets: the reference's marker writers in
codestream/CodeStreamCompress.cpp:1058+ and the ~25 read_<marker> handlers in
codestream/CodeStreamDecompress.cpp:1148-2707, plus codestream/markers/.
Implemented from the standard's tables, host-side (serial byte work stays
on the host; the accelerator takes the array stages).
"""

from __future__ import annotations

import struct

from ..core.errors import CodestreamError, InvalidMarkerError
from ..core.params import ProgressionChange, ProgressionOrder, QuantStyle
from .structs import HeaderInfo, Siz, SizComponent, Tcp, TccpStyle

# ---------------------------------------------------------------- constants
SOC = 0xFF4F
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9
SIZ = 0xFF51
CAP = 0xFF50
PRF = 0xFF56
COD = 0xFF52
COC = 0xFF53
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
PPT = 0xFF61
TLM = 0xFF55
PLM = 0xFF57
PLT = 0xFF58
CPF = 0xFF59
CRG = 0xFF63
COM = 0xFF64
MCT = 0xFF74
MCC = 0xFF75
MCO = 0xFF77
SOP = 0xFF91
EPH = 0xFF92

_MARKER_NAMES = {
    v: k
    for k, v in globals().items()
    if isinstance(v, int) and k.isupper() and 0xFF00 <= v <= 0xFFFF
}


def marker_name(m: int) -> str:
    return _MARKER_NAMES.get(m, f"0x{m:04X}")


# ------------------------------------------------------------ byte helpers
def _u8(b: int) -> bytes:
    return struct.pack(">B", b)


def _u16(v: int) -> bytes:
    return struct.pack(">H", v)


def _u32(v: int) -> bytes:
    return struct.pack(">I", v)


def segment(marker: int, payload: bytes) -> bytes:
    """marker + Lxxx (payload length + 2) + payload."""
    return _u16(marker) + _u16(len(payload) + 2) + payload


class Cursor:
    """Bounded big-endian byte reader for marker payloads."""

    def __init__(self, data: memoryview | bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        if self.pos + 1 > self.end:
            raise CodestreamError("truncated marker payload")
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        if self.pos + 2 > self.end:
            raise CodestreamError("truncated marker payload")
        v = (self.data[self.pos] << 8) | self.data[self.pos + 1]
        self.pos += 2
        return v

    def u32(self) -> int:
        return (self.u16() << 16) | self.u16()

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise CodestreamError("truncated marker payload")
        v = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        return v


# ---------------------------------------------------------------- SIZ
def write_siz(siz: Siz) -> bytes:
    p = bytearray()
    p += _u16(siz.rsiz)
    p += _u32(siz.x1) + _u32(siz.y1) + _u32(siz.x0) + _u32(siz.y0)
    p += _u32(siz.tile_w) + _u32(siz.tile_h) + _u32(siz.tile_x0) + _u32(siz.tile_y0)
    p += _u16(len(siz.comps))
    for c in siz.comps:
        ssiz = (c.prec - 1) | (0x80 if c.signed else 0)
        p += _u8(ssiz) + _u8(c.dx) + _u8(c.dy)
    return segment(SIZ, bytes(p))


def read_siz(c: Cursor) -> Siz:
    siz = Siz()
    siz.rsiz = c.u16()
    siz.x1, siz.y1, siz.x0, siz.y0 = c.u32(), c.u32(), c.u32(), c.u32()
    siz.tile_w, siz.tile_h, siz.tile_x0, siz.tile_y0 = c.u32(), c.u32(), c.u32(), c.u32()
    ncomp = c.u16()
    if ncomp == 0 or ncomp > 16384:
        raise CodestreamError(f"SIZ: bad component count {ncomp}")
    if siz.x1 <= siz.x0 or siz.y1 <= siz.y0:
        raise CodestreamError("SIZ: empty image area")
    if siz.tile_w == 0 or siz.tile_h == 0:
        raise CodestreamError("SIZ: zero tile size")
    if siz.tile_x0 > siz.x0 or siz.tile_y0 > siz.y0:
        raise CodestreamError("SIZ: tile origin beyond image origin")
    # T.800 A.5.1 / A.4.2: SOT's Isot is 16-bit, so a grid of more than
    # 65535 tiles is structurally undecodable (also a decode-bomb guard:
    # a corrupt SIZ must not send the decoder over a ~10^5-tile grid)
    ntx = (siz.x1 - siz.tile_x0 + siz.tile_w - 1) // siz.tile_w
    nty = (siz.y1 - siz.tile_y0 + siz.tile_h - 1) // siz.tile_h
    if ntx * nty > 65535:
        raise CodestreamError(f"SIZ: tile grid {ntx}x{nty} exceeds 65535 tiles")
    for _ in range(ncomp):
        ssiz, dx, dy = c.u8(), c.u8(), c.u8()
        if dx == 0 or dy == 0:
            raise CodestreamError("SIZ: zero subsampling")
        siz.comps.append(
            SizComponent(dx=dx, dy=dy, prec=(ssiz & 0x7F) + 1, signed=bool(ssiz & 0x80))
        )
    return siz


# ---------------------------------------------------------------- COD / COC
def _write_spcod(tccp: TccpStyle, with_precincts: bool) -> bytes:
    p = bytearray()
    p += _u8(tccp.num_resolutions - 1)
    p += _u8(tccp.cblk_w_exp - 2)
    p += _u8(tccp.cblk_h_exp - 2)
    p += _u8(tccp.cblk_style)
    p += _u8(0 if tccp.irreversible else 1)  # Table A-20: 0 = 9/7, 1 = 5/3
    if with_precincts:
        for r in range(tccp.num_resolutions):
            px, py = tccp.precinct_exp(r)
            p += _u8((py << 4) | px)
    return bytes(p)


def _read_spcod(c: Cursor, tccp: TccpStyle, with_precincts: bool) -> None:
    tccp.num_resolutions = c.u8() + 1
    if tccp.num_resolutions > 33:
        raise CodestreamError("COD: too many resolutions")
    tccp.cblk_w_exp = c.u8() + 2
    tccp.cblk_h_exp = c.u8() + 2
    if not (2 <= tccp.cblk_w_exp <= 10) or not (2 <= tccp.cblk_h_exp <= 10):
        raise CodestreamError("COD: bad codeblock exponent")
    if tccp.cblk_w_exp + tccp.cblk_h_exp > 12:
        raise CodestreamError("COD: codeblock area > 4096")
    tccp.cblk_style = c.u8()
    tccp.irreversible = c.u8() == 0
    if with_precincts:
        tccp.precinct_exps = []
        for _ in range(tccp.num_resolutions):
            v = c.u8()
            tccp.precinct_exps.append((v & 0x0F, v >> 4))
    else:
        tccp.precinct_exps = None


def write_cod(tcp: Tcp) -> bytes:
    tccp = tcp.tccps[0]
    with_prec = tccp.precinct_exps is not None
    csty = tcp.csty | (0x01 if with_prec else 0)
    p = bytearray()
    p += _u8(csty)
    p += _u8(int(tcp.progression))
    p += _u16(tcp.num_layers)
    p += _u8(tcp.mct)
    p += _write_spcod(tccp, with_prec)
    return segment(COD, bytes(p))


def read_cod(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    csty = c.u8()
    tcp.csty = csty
    tcp.progression = ProgressionOrder(c.u8())
    tcp.num_layers = c.u16()
    if tcp.num_layers == 0:
        raise CodestreamError("COD: zero layers")
    tcp.mct = c.u8()
    base = TccpStyle()
    _read_spcod(c, base, bool(csty & 0x01))
    tcp.tccps = [base.copy() for _ in range(num_comps)]


def write_coc(tcp: Tcp, comp: int, num_comps: int) -> bytes:
    tccp = tcp.tccps[comp]
    with_prec = tccp.precinct_exps is not None
    p = bytearray()
    p += _u8(comp) if num_comps <= 256 else _u16(comp)
    p += _u8(0x01 if with_prec else 0)
    p += _write_spcod(tccp, with_prec)
    return segment(COC, bytes(p))


def read_coc(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    comp = c.u8() if num_comps <= 256 else c.u16()
    if comp >= num_comps:
        raise CodestreamError("COC: bad component index")
    scoc = c.u8()
    _read_spcod(c, tcp.tccps[comp], bool(scoc & 0x01))


# ---------------------------------------------------------------- QCD / QCC
def _num_band_entries(num_resolutions: int) -> int:
    return 3 * (num_resolutions - 1) + 1


def _write_sqcd(tccp: TccpStyle) -> bytes:
    p = bytearray()
    p += _u8(int(tccp.quant_style) | (tccp.guard_bits << 5))
    if tccp.quant_style == QuantStyle.NO_QUANT:
        for e in tccp.step_exps:
            p += _u8(e << 3)
    elif tccp.quant_style == QuantStyle.SCALAR_DERIVED:
        p += _u16((tccp.step_exps[0] << 11) | tccp.step_mants[0])
    else:
        for e, m in zip(tccp.step_exps, tccp.step_mants):
            p += _u16((e << 11) | m)
    return bytes(p)


def _read_sqcd(c: Cursor, tccp: TccpStyle, nbytes: int) -> None:
    sqcd = c.u8()
    tccp.quant_style = QuantStyle(sqcd & 0x1F)
    tccp.guard_bits = sqcd >> 5
    tccp.step_exps = []
    tccp.step_mants = []
    nbytes -= 1
    if tccp.quant_style == QuantStyle.NO_QUANT:
        for _ in range(nbytes):
            tccp.step_exps.append(c.u8() >> 3)
            tccp.step_mants.append(0)
    elif tccp.quant_style == QuantStyle.SCALAR_DERIVED:
        v = c.u16()
        tccp.step_exps.append(v >> 11)
        tccp.step_mants.append(v & 0x7FF)
    else:
        for _ in range(nbytes // 2):
            v = c.u16()
            tccp.step_exps.append(v >> 11)
            tccp.step_mants.append(v & 0x7FF)


def write_qcd(tcp: Tcp) -> bytes:
    return segment(QCD, _write_sqcd(tcp.tccps[0]))


def read_qcd(c: Cursor, tcp: Tcp) -> None:
    payload = c.remaining()
    base = tcp.tccps[0]
    _read_sqcd(c, base, payload)
    for t in tcp.tccps[1:]:
        t.quant_style = base.quant_style
        t.guard_bits = base.guard_bits
        t.step_exps = list(base.step_exps)
        t.step_mants = list(base.step_mants)


def write_qcc(tcp: Tcp, comp: int, num_comps: int) -> bytes:
    head = _u8(comp) if num_comps <= 256 else _u16(comp)
    return segment(QCC, head + _write_sqcd(tcp.tccps[comp]))


def read_qcc(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    comp = c.u8() if num_comps <= 256 else c.u16()
    if comp >= num_comps:
        raise CodestreamError("QCC: bad component index")
    _read_sqcd(c, tcp.tccps[comp], c.remaining())


# ---------------------------------------------------------------- POC
def write_poc(tcp: Tcp, num_comps: int) -> bytes:
    p = bytearray()
    for poc in tcp.pocs:
        p += _u8(poc.res_start)
        p += _u8(poc.comp_start) if num_comps <= 256 else _u16(poc.comp_start)
        p += _u16(poc.layer_end)
        p += _u8(poc.res_end)
        p += _u8(poc.comp_end) if num_comps <= 256 else _u16(poc.comp_end)
        p += _u8(int(poc.order))
    return segment(POC, bytes(p))


def read_poc(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    """POC segments ACCUMULATE across the main and tile-part headers
    (reference parity: CodeStreamDecompress::read_poc appends after
    oldNumProgressions rather than replacing) — the reference encoder
    relies on this: its tile-header POC copy carries a zeroed progression
    field, harmless only because the main-header entries already cover
    every packet. Exact duplicates are skipped so re-parsing a cached
    tile header stays idempotent."""
    comp_bytes = 1 if num_comps <= 256 else 2
    entry = 5 + 2 * comp_bytes
    n = c.remaining() // entry
    pocs = list(tcp.pocs)
    for _ in range(n):
        rs = c.u8()
        cs = c.u8() if comp_bytes == 1 else c.u16()
        le = c.u16()
        re = c.u8()
        ce = c.u8() if comp_bytes == 1 else c.u16()
        order = ProgressionOrder(c.u8())
        pc = ProgressionChange(rs, cs, le, re, ce, order)
        if pc not in pocs:
            pocs.append(pc)
    tcp.pocs = pocs


# ---------------------------------------------------------------- RGN
def write_rgn(comp: int, shift: int, num_comps: int) -> bytes:
    head = _u8(comp) if num_comps <= 256 else _u16(comp)
    return segment(RGN, head + _u8(0) + _u8(shift))


def read_rgn(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    comp = c.u8() if num_comps <= 256 else c.u16()
    if comp >= num_comps:
        raise CodestreamError("RGN: bad component index")
    srgn = c.u8()
    if srgn != 0:
        raise CodestreamError("RGN: unsupported style")
    tcp.tccps[comp].roi_shift = c.u8()


# ---------------------------------------------------------------- COM / CAP
def write_com(text: bytes, is_text: bool = True) -> bytes:
    return segment(COM, _u16(1 if is_text else 0) + text)


def write_cap(pcap: int, ccaps: list[int]) -> bytes:
    p = _u32(pcap)
    for cc in ccaps:
        p += _u16(cc)
    return segment(CAP, p)


def read_cap(c: Cursor) -> tuple[int, list[int]]:
    pcap = c.u32()
    ccaps = [c.u16() for _ in range(c.remaining() // 2)]
    return pcap, ccaps


# ---------------------------------------------------------------- SOT
def write_sot(tile_index: int, psot: int, tp_index: int, num_tps: int) -> bytes:
    return segment(SOT, _u16(tile_index) + _u32(psot) + _u8(tp_index) + _u8(num_tps))


def read_sot(c: Cursor) -> tuple[int, int, int, int]:
    return c.u16(), c.u32(), c.u8(), c.u8()


# ---------------------------------------------------------------- TLM / PLT
def write_tlm(entries: list[tuple[int, int]], ztlm: int = 0, st: int | None = None) -> bytes:
    """TLM with ST=1 (8-bit tile indices) unless >255 tiles, SP=1 (32-bit)."""
    if st is None:
        st = 2 if any(t > 255 for t, _ in entries) else 1
    stlm = (st << 4) | (1 << 6)
    p = bytearray(_u8(ztlm) + _u8(stlm))
    for t, ln in entries:
        p += _u8(t) if st == 1 else _u16(t)
        p += _u32(ln)
    return segment(TLM, bytes(p))


def read_tlm(c: Cursor) -> list[tuple[int | None, int]]:
    c.u8()  # Ztlm
    stlm = c.u8()
    st = (stlm >> 4) & 0x3
    sp = (stlm >> 6) & 0x1
    entry = st + (4 if sp else 2)
    out = []
    n = c.remaining() // entry
    for _ in range(n):
        t = None if st == 0 else (c.u8() if st == 1 else c.u16())
        ln = c.u32() if sp else c.u16()
        out.append((t, ln))
    return out


def write_plt(lengths: list[int], zplt: int = 0) -> bytes:
    p = bytearray(_u8(zplt))
    for ln in lengths:
        # 7-bit big-endian varint, continuation bit on all but the last byte
        chunks = []
        v = ln
        while True:
            chunks.append(v & 0x7F)
            v >>= 7
            if v == 0:
                break
        for i in range(len(chunks) - 1, 0, -1):
            p.append(0x80 | chunks[i])
        p.append(chunks[0])
    return segment(PLT, bytes(p))


def _comma7(lengths) -> bytes:
    """Comma-7-bit packet-length coding shared by PLT and PLM (A.7.2/A.7.3)."""
    out = bytearray()
    for ln in lengths:
        ln = int(ln)
        chunks = []
        while True:
            chunks.append(ln & 0x7F)
            ln >>= 7
            if ln == 0:
                break
        for i in range(len(chunks) - 1, 0, -1):
            out.append(0x80 | chunks[i])
        out.append(chunks[0])
    return bytes(out)


def write_plm(parts: list[list[int]], zplm: int = 0) -> bytes:
    """PLM (A.7.2): packet lengths per tile-part in the main header.

    parts: per tile-part (in codestream order) list of packet lengths.
    Splits across multiple PLM segments when a segment would overflow."""
    segs = bytearray()
    payload = bytearray([zplm])
    for plens in parts:
        blob = _comma7(plens)
        # Nplm is one byte: split oversized tile-part length runs
        chunks = [blob[i : i + 255] for i in range(0, max(len(blob), 1), 255)]
        for ch in chunks:
            if len(payload) + 1 + len(ch) > 65000:
                segs += segment(PLM, bytes(payload))
                zplm += 1
                payload = bytearray([zplm])
            payload += bytes([len(ch)]) + ch
    segs += segment(PLM, bytes(payload))
    return bytes(segs)


# ------------------------------------------------- custom MCT (Part 2)
# Layout parity: CodeStreamCompress.cpp write_mct_record / write_mcc_record /
# write_mco (T.801 A.3.7-A.3.9). One decorrelation float array (the DECODING
# matrix), one float offset array (DC level shifts), one collection, one
# ordering record.


def write_mct_markers(dec_matrix, offsets) -> bytes:
    """dec_matrix: [N,N] float decoding (inverse) matrix; offsets: [N]."""
    import struct as _st

    out = bytearray()
    n = len(offsets)

    def mct_record(index, array_type, values):
        data = b"".join(_st.pack(">f", float(v)) for v in values)
        imct = (index & 0xFF) | (array_type << 8) | (2 << 10)  # float elems
        payload = _u16(0) + _u16(imct) + _u16(0) + data
        return segment(MCT, payload)

    out += mct_record(1, 1, [v for row in dec_matrix for v in row])  # decorrelation
    out += mct_record(2, 2, offsets)  # offsets
    # MCC
    p = bytearray()
    p += _u16(0)          # Zmcc
    p += _u8(3)           # Imcc
    p += _u16(0)          # Ymcc
    p += _u16(1)          # Qmcc: one collection
    p += _u8(0x1)         # Xmcci: array-based decorrelation
    p += _u16(n)          # Nmcci (8-bit offsets)
    for i in range(n):
        p += _u8(i)
    p += _u16(n)          # Mmcci
    for i in range(n):
        p += _u8(i)
    tmcc = (0 << 16) | 1 | (2 << 8)  # irreversible; deco idx 1, offset idx 2
    p += bytes([(tmcc >> 16) & 0xFF, (tmcc >> 8) & 0xFF, tmcc & 0xFF])
    out += segment(MCC, bytes(p))
    # MCO
    out += segment(MCO, _u8(1) + _u8(3))
    return bytes(out)


def read_mct(c: Cursor, end: int, store: dict) -> None:
    """Parse one MCT marker into store[index] = (array_type, values)."""
    import struct as _st

    c.u16()  # Zmct
    imct = c.u16()
    c.u16()  # Ymct
    index = imct & 0xFF
    array_type = (imct >> 8) & 0x3
    elem_type = (imct >> 10) & 0x3
    raw = bytes(c.data[c.pos : end])
    c.pos = end
    sizes = {0: 2, 1: 4, 2: 4, 3: 8}
    fmts = {0: ">h", 1: ">i", 2: ">f", 3: ">d"}
    es = sizes[elem_type]
    vals = [
        _st.unpack(fmts[elem_type], raw[i : i + es])[0]
        for i in range(0, len(raw) - es + 1, es)
    ]
    store[index] = (array_type, vals)


def read_plm(c: Cursor, end: int) -> list[tuple[int, bytes]]:
    """Parse one PLM segment: returns (Zplm, raw Nplm/Iplm payload)."""
    z = c.u8()
    return [(z, bytes(c.data[c.pos : end]))]


def read_plt(c: Cursor) -> list[int]:
    c.u8()  # Zplt
    out = []
    v = 0
    while c.remaining():
        b = c.u8()
        v = (v << 7) | (b & 0x7F)
        if not (b & 0x80):
            out.append(v)
            v = 0
    return out


# ---------------------------------------------------------- main header I/O
def _apply_mct_arrays(hi) -> None:
    """Install parsed Part-2 MCT arrays into the default tcp."""
    import numpy as _np

    arrays = getattr(hi, "mct_arrays", {})
    n = hi.siz.num_comps
    for idx, (atype, vals) in arrays.items():
        if atype == 1 and len(vals) == n * n:
            hi.default_tcp.mct_dec_matrix = _np.asarray(
                vals, dtype=_np.float64
            ).reshape(n, n)
        elif atype == 2 and len(vals) == n:
            hi.default_tcp.mct_offsets = [float(v) for v in vals]


def parse_main_header(data: memoryview | bytes) -> tuple[HeaderInfo, int]:
    """Parse SOC..first-SOT. Returns (HeaderInfo, offset-of-first-SOT)."""
    c = Cursor(data)
    if c.u16() != SOC:
        raise InvalidMarkerError("no SOC marker")
    hi = HeaderInfo()
    siz_seen = False
    while True:
        m = c.u16()
        if m == SOT:
            if not siz_seen:
                raise CodestreamError("SOT before SIZ")
            return hi, c.pos - 2
        if m == EOC:
            raise CodestreamError("EOC before any tile")
        if m < 0xFF00:
            raise InvalidMarkerError(f"bad marker 0x{m:04X} in main header")
        ln = c.u16()
        if ln < 2:
            raise CodestreamError("bad marker length")
        sub = Cursor(c.data, c.pos, c.pos + ln - 2)
        if m == SIZ:
            hi.siz = read_siz(sub)
            hi.default_tcp.tccps = [TccpStyle() for _ in hi.siz.comps]
            siz_seen = True
        elif m == COD:
            read_cod(sub, hi.default_tcp, hi.siz.num_comps)
        elif m == COC:
            read_coc(sub, hi.default_tcp, hi.siz.num_comps)
        elif m == QCD:
            read_qcd(sub, hi.default_tcp)
        elif m == QCC:
            read_qcc(sub, hi.default_tcp, hi.siz.num_comps)
        elif m == POC:
            read_poc(sub, hi.default_tcp, hi.siz.num_comps)
        elif m == RGN:
            read_rgn(sub, hi.default_tcp, hi.siz.num_comps)
        elif m == COM:
            sub.u16()
            hi.comments.append(sub.take(sub.remaining()))
        elif m == CAP:
            hi.cap = read_cap(sub)
        elif m == TLM:
            entries = read_tlm(sub)
            if hi.tlm is None:
                hi.tlm = []
            seq = 0
            fixed = []
            for t, ln2 in entries:
                fixed.append((seq if t is None else t, ln2))
                seq += 1
            hi.tlm.extend(fixed)
            hi.has_tlm = True
        elif m == PPM:
            zppm = sub.u8()
            hi.ppm_segments.append((zppm, sub.take(sub.remaining())))
        elif m == MCT:
            if not hasattr(hi, "mct_arrays"):
                hi.mct_arrays = {}
            read_mct(sub, sub.end, hi.mct_arrays)
            _apply_mct_arrays(hi)
        # PLM/CRG/PRF/CPF/MCC/MCO: skip (tolerated; the default single
        # collection applies arrays 1 (decorrelation) and 2 (offsets))
        c.pos = c.pos + ln - 2
