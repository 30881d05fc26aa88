"""HTJ2K (FBCOT) cleanup-pass block coder — ITU-T T.814.

Brand-new implementation of the HT cleanup pass (MagSgn + MEL + VLC triple
bitstream), behavior-compatible with the reference's HT path
(t1/t1_ht/coding/ojph_block_encoder.cpp / ojph_block_decoder.cpp, studied
for format semantics; code written fresh). The normative CxtVLC codeword
assignments live in ht_tables_data.py.

Segment layout (Dcup): [MagSgn fwd][MEL fwd][VLC bwd], with the 12-bit
interface locator word Scup = len(MEL)+len(VLC) packed into the last
12 bits of the segment.

This scalar implementation is the correctness reference; the native C++
batch coder mirrors it for speed.
"""

from __future__ import annotations

import numpy as np

from .ht_tables_data import TABLE0, TABLE1

# MEL run-length state machine exponents (T.814 Table C.3)
MEL_EXP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5]


# --------------------------------------------------------------- VLC tables
def _build_enc_table(src):
    """2048-entry LUT keyed (c_q<<8)|(rho<<4)|emb -> (cwd<<8)|(len<<4)|e_k.

    For emb != 0 pick the entry with u_off=1 whose (e_k, e_1) is consistent
    with the emb pattern, preferring the most e_k bits; for emb == 0 pick
    the u_off=0 entry (T.814 C.3.4 selection rule)."""
    tbl = [0] * 2048
    for i in range(2048):
        c_q, rho, emb = i >> 8, (i >> 4) & 0xF, i & 0xF
        if (emb & rho) != emb or (rho == 0 and c_q == 0):
            continue
        best = None
        if emb:
            best_ones = -1
            for (ec, erho, u_off, e_k, e_1, cwd, ln) in src:
                if ec == c_q and erho == rho and u_off == 1:
                    if (emb & e_k) == e_1:
                        ones = bin(e_k).count("1")
                        if ones >= best_ones:
                            best = (cwd, ln, e_k)
                            best_ones = ones
        else:
            for (ec, erho, u_off, e_k, e_1, cwd, ln) in src:
                if ec == c_q and erho == rho and u_off == 0:
                    best = (cwd, ln, e_k)
                    break
        assert best is not None, (c_q, rho, emb)
        tbl[i] = (best[0] << 8) | (best[1] << 4) | best[2]
    return tbl


def _build_dec_table(src):
    """Per-context 128-entry LUT over 7 LSB-first bits ->
    (rho, u_off, e_k, e_1, cwd_len)."""
    tbl = [[None] * 128 for _ in range(8)]
    for (c_q, rho, u_off, e_k, e_1, cwd, ln) in src:
        for v in range(128):
            if (v & ((1 << ln) - 1)) == cwd:
                tbl[c_q][v] = (rho, u_off, e_k, e_1, ln)
    return tbl


ENC_TBL = (_build_enc_table(TABLE0), _build_enc_table(TABLE1))
DEC_TBL = (_build_dec_table(TABLE0), _build_dec_table(TABLE1))

# UVLC prefix/suffix codes (LSB-first codewords), T.814 C.3.5
_U_PRE = [0] * 33
_U_PRE_LEN = [0] * 33
_U_SUF = [0] * 33
_U_SUF_LEN = [0] * 33
for _i, (_p, _pl, _s, _sl) in enumerate(
    [(0, 0, 0, 0), (1, 1, 0, 0), (2, 2, 0, 0), (4, 3, 0, 1), (4, 3, 1, 1)]
):
    _U_PRE[_i], _U_PRE_LEN[_i], _U_SUF[_i], _U_SUF_LEN[_i] = _p, _pl, _s, _sl
for _i in range(5, 33):
    _U_PRE[_i], _U_PRE_LEN[_i] = 0, 3
    _U_SUF[_i], _U_SUF_LEN[_i] = _i - 5, 5


# ------------------------------------------------------------ bit machines
class MelEnc:
    def __init__(self):
        self.bytes = bytearray()
        self.tmp = 0
        self.rem = 8
        self.run = 0
        self.k = 0
        self.threshold = 1

    def _bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.bytes.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def encode(self, bit):
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << MEL_EXP[self.k]
        else:
            self._bit(0)
            t = MEL_EXP[self.k]
            while t > 0:
                t -= 1
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << MEL_EXP[self.k]


class VlcEnc:
    """Backward-growing LSB-first writer with the >0x8F stuffing rule."""

    def __init__(self):
        self.bytes = bytearray([0xFF])  # grows towards the front (we append)
        self.tmp = 0xF  # the 4 pre-filled locator bits
        self.used = 4
        self.last_gt_8f = True

    def encode(self, cwd, ln):
        while ln > 0:
            avail = 8 - (1 if self.last_gt_8f else 0) - self.used
            t = min(avail, ln)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            ln -= t
            cwd >>= t
            if avail == 0:
                if self.last_gt_8f and self.tmp != 0x7F:
                    self.last_gt_8f = False
                    continue  # one more usable bit in this byte
                self.bytes.append(self.tmp)
                self.last_gt_8f = self.tmp > 0x8F
                self.tmp = 0
                self.used = 0

    def tail_bytes(self) -> bytes:
        """Bytes in stream order (last-emitted first)."""
        return bytes(reversed(self.bytes))


class MsEnc:
    """Forward LSB-first writer with 0xFF stuffing."""

    def __init__(self):
        self.bytes = bytearray()
        self.max_bits = 8
        self.used = 0
        self.tmp = 0

    def encode(self, cwd, ln):
        while ln > 0:
            t = min(self.max_bits - self.used, ln)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            ln -= t
            if self.used >= self.max_bits:
                self.bytes.append(self.tmp)
                self.max_bits = 7 if self.tmp == 0xFF else 8
                self.tmp = 0
                self.used = 0

    def terminate(self):
        if self.used:
            t = self.max_bits - self.used
            self.tmp |= (0xFF & ((1 << t) - 1)) << self.used
            self.used += t
            if self.tmp != 0xFF:
                self.bytes.append(self.tmp)
        elif self.max_bits == 7:
            # last written byte was 0xFF with nothing after: drop it (the
            # decoder pads 0xFF beyond the segment end)
            self.bytes.pop()


def _terminate_mel_vlc(mel: MelEnc, vlc: VlcEnc) -> tuple[bytes, bytes]:
    if mel.run > 0:
        mel._bit(1)
    mel_tmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used) if vlc.used else 0
    if (mel_mask | vlc_mask) != 0:
        fuse = mel_tmp | vlc.tmp
        if (
            ((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)
        ) == 0 and fuse != 0xFF and len(vlc.bytes) > 1:
            mel_bytes = bytes(mel.bytes) + bytes([fuse])
            vlc_bytes = vlc.tail_bytes()
        else:
            mel_bytes = bytes(mel.bytes) + bytes([mel_tmp])
            vlc_bytes = bytes([vlc.tmp]) + vlc.tail_bytes()
    else:
        mel_bytes = bytes(mel.bytes)
        vlc_bytes = vlc.tail_bytes()
    return mel_bytes, vlc_bytes


# ================================================================== encoder
def encode_cleanup(coeffs: np.ndarray, h: int, w: int) -> bytes:
    """Encode one codeblock's quantized coefficients (signed ints) as an HT
    cleanup codeword segment."""
    mel = MelEnc()
    vlc = VlcEnc()
    ms = MsEnc()

    mag = np.abs(coeffs[:h, :w]).astype(np.int64)
    sgn = (coeffs[:h, :w] < 0).astype(np.int64)

    nqw = (w + 1) // 2  # quads per row

    def sample(qy, qx, k):
        # quad sample order: 0 TL, 1 BL, 2 TR, 3 BR
        y = 2 * qy + (k & 1)
        x = 2 * qx + (k >> 1)
        if y >= h or x >= w:
            return 0, 0
        return int(mag[y, x]), int(sgn[y, x])

    prev_e = [0] * (nqw + 2)  # E line buffer (above row)
    prev_cx = [0] * (nqw + 2)  # significance line buffer
    n_qrows = (h + 1) // 2

    for qy in range(n_qrows):
        line0 = qy == 0
        tbl = ENC_TBL[0] if line0 else ENC_TBL[1]
        cur_e = [0] * (nqw + 2)
        cur_cx = [0] * (nqw + 2)
        c_left = 0  # context contribution carried from the left quad

        qx = 0
        while qx < nqw:
            pair = []
            for j in range(2):
                qi = qx + j
                if qi >= nqw:
                    pair.append(None)
                    continue
                rho = 0
                e_q = [0, 0, 0, 0]
                s_q = [0, 0, 0, 0]
                emax = 0
                for k in range(4):
                    mu, s = sample(qy, qi, k)
                    if mu:
                        rho |= 1 << k
                        tv = 2 * mu - 1
                        e_q[k] = tv.bit_length()
                        emax = max(emax, e_q[k])
                        s_q[k] = 2 * (mu - 1) + s
                pair.append((rho, e_q, s_q, emax))

            u_vals = []
            for j in range(2):
                qi = qx + j
                if pair[j] is None:
                    u_vals.append(0)
                    continue
                rho, e_q, s_q, emax = pair[j]
                if line0:
                    c_q = c_left
                    kappa = 1
                else:
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left
                    max_e = max(prev_e[qi], prev_e[qi + 1]) - 1
                    kappa = max(1, max_e) if (rho & (rho - 1)) else 1
                uq = max(emax, kappa)
                u = uq - kappa
                eps = 0
                if u > 0:
                    for k in range(4):
                        eps |= (e_q[k] == emax) << k
                tup = tbl[(c_q << 8) + (rho << 4) + eps]
                vlc.encode(tup >> 8, (tup >> 4) & 7)
                if c_q == 0:
                    mel.encode(rho != 0)
                for k in range(4):
                    if rho & (1 << k):
                        m = uq - ((tup >> k) & 1)
                        ms.encode(s_q[k] & ((1 << m) - 1), m)
                # line buffers for the next quad row
                cur_e[qi] = max(cur_e[qi], e_q[1])
                cur_e[qi + 1] = e_q[3]
                cur_cx[qi] |= (rho & 2) >> 1
                cur_cx[qi + 1] = (rho & 8) >> 3
                # context carried to the quad on the right
                if line0:
                    c_left = (rho >> 1) | (rho & 1)
                else:
                    c_left = ((rho & 4) >> 1) | ((rho & 8) >> 2)
                u_vals.append(u)

            u0, u1 = u_vals[0], u_vals[1] if len(u_vals) > 1 else 0
            if line0:
                if u0 > 0 and u1 > 0:
                    mel.encode(min(u0, u1) > 2)
                if u0 > 2 and u1 > 2:
                    vlc.encode(_U_PRE[u0 - 2], _U_PRE_LEN[u0 - 2])
                    vlc.encode(_U_PRE[u1 - 2], _U_PRE_LEN[u1 - 2])
                    vlc.encode(_U_SUF[u0 - 2], _U_SUF_LEN[u0 - 2])
                    vlc.encode(_U_SUF[u1 - 2], _U_SUF_LEN[u1 - 2])
                elif u0 > 2 and u1 > 0:
                    vlc.encode(_U_PRE[u0], _U_PRE_LEN[u0])
                    vlc.encode(u1 - 1, 1)
                    vlc.encode(_U_SUF[u0], _U_SUF_LEN[u0])
                else:
                    vlc.encode(_U_PRE[u0], _U_PRE_LEN[u0])
                    vlc.encode(_U_PRE[u1], _U_PRE_LEN[u1])
                    vlc.encode(_U_SUF[u0], _U_SUF_LEN[u0])
                    vlc.encode(_U_SUF[u1], _U_SUF_LEN[u1])
            else:
                vlc.encode(_U_PRE[u0], _U_PRE_LEN[u0])
                vlc.encode(_U_PRE[u1], _U_PRE_LEN[u1])
                vlc.encode(_U_SUF[u0], _U_SUF_LEN[u0])
                vlc.encode(_U_SUF[u1], _U_SUF_LEN[u1])
            qx += 2

        prev_e = cur_e
        prev_cx = cur_cx

    mel_bytes, vlc_bytes = _terminate_mel_vlc(mel, vlc)
    ms.terminate()
    ms_bytes = bytes(ms.bytes)

    scup = len(mel_bytes) + len(vlc_bytes)
    seg = bytearray(ms_bytes + mel_bytes + vlc_bytes)
    seg[-1] = (scup >> 4) & 0xFF
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


# ================================================================== decoder
class MelDec:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.tmp = 0
        self.bits = 0
        self.prev_ff = False
        self.k = 0
        self.runs: list[int] = []

    def _bit(self) -> int:
        if self.bits == 0:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            self.bits = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
            self.tmp = b
        self.bits -= 1
        return (self.tmp >> self.bits) & 1

    def event(self) -> int:
        """Next MEL event (0 or 1)."""
        if self.runs:
            return self.runs.pop(0)
        if self._bit():
            n = 1 << MEL_EXP[self.k]
            self.k = min(12, self.k + 1)
            self.runs = [0] * n
        else:
            t = MEL_EXP[self.k]
            run = 0
            for _ in range(t):
                run = (run << 1) | self._bit()
            self.k = max(0, self.k - 1)
            self.runs = [0] * run + [1]
        return self.runs.pop(0)


class VlcDec:
    """Backward LSB-first reader; mirrors VlcEnc stuffing."""

    def __init__(self, data: bytes):
        # data = MEL+VLC chunk in stream order; VLC reads from the END
        # backwards. The last byte holds locator bits only; the second-to-
        # last byte's low nibble is locator, its high nibble starts the VLC
        # payload (3 bits only if its low 3 bits are all ones -- the
        # encoder's sentinel-stuffed first byte).
        self.data = data
        self.pos = len(data) - 2
        d = data[self.pos] if self.pos >= 0 else 0
        self.pos -= 1
        self.tmp = d >> 4
        self.bits = 4 - (1 if (self.tmp & 7) == 7 else 0)
        self.unstuff = (d | 0xF) > 0x8F

    def _read_byte(self):
        if self.pos >= 0:
            b = self.data[self.pos]
            self.pos -= 1
        else:
            b = 0
        # when the later (previously read) byte is > 0x8F and this byte's
        # low 7 bits are all ones, only 7 bits are payload
        if self.unstuff and (b & 0x7F) == 0x7F:
            nbits = 7
        else:
            nbits = 8
        self.unstuff = b > 0x8F
        return b & ((1 << nbits) - 1), nbits

    def _fill(self, need):
        while self.bits < need:
            b, nbits = self._read_byte()
            self.tmp |= b << self.bits
            self.bits += nbits

    def peek(self, n) -> int:
        self._fill(n)
        return self.tmp & ((1 << n) - 1)

    def advance(self, n):
        self._fill(n)
        self.tmp >>= n
        self.bits -= n

    def read(self, n) -> int:
        v = self.peek(n)
        self.advance(n)
        return v


class MsDec:
    """Forward LSB-first reader with 0xFF unstuffing; pads 0xFF beyond end."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.tmp = 0
        self.bits = 0
        self.prev_ff = False

    def _fill(self, need):
        while self.bits < need:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            nbits = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
            self.tmp |= (b & ((1 << nbits) - 1)) << self.bits
            self.bits += nbits

    def read(self, n) -> int:
        if n == 0:
            return 0
        self._fill(n)
        v = self.tmp & ((1 << n) - 1)
        self.tmp >>= n
        self.bits -= n
        return v


def _dec_u_pair(vlc: VlcDec, line0: bool, u_off0: int, u_off1: int,
                mel: MelDec) -> tuple[int, int]:
    """Decode the u values for a quad pair (mirrors the encoder cases)."""

    def read_prefix():
        # prefix codes (LSB first): 1 -> 1; 01 -> 2; 011? no:
        # cwd 2 len2 = bits '0','1'; cwd 4 len3 = '0','0','1'; 0 len3='000'
        if vlc.read(1):
            return 1
        if vlc.read(1):
            return 2
        return 3 if vlc.read(1) else 5  # 5 marks the 5-bit-suffix escape

    def read_suffix(pre):
        if pre == 3:
            return 3 + vlc.read(1)
        if pre == 5:
            return 5 + vlc.read(5)
        return pre

    if line0:
        both_gt2 = False
        if u_off0 and u_off1:
            both_gt2 = bool(mel.event())
        if u_off0 and u_off1 and both_gt2:
            p0 = read_prefix()
            p1 = read_prefix()
            u0 = read_suffix(p0) + 2
            u1 = read_suffix(p1) + 2
            return u0, u1
        if u_off0 and u_off1:
            # u0 may be > 2 (then u1 in {1,2} via 1 bit), else both small
            p0 = read_prefix()
            if p0 > 2:
                u1 = 1 + vlc.read(1)
                u0 = read_suffix(p0)
                return u0, u1
            p1 = read_prefix()
            u0 = read_suffix(p0)
            u1 = read_suffix(p1)
            return u0, u1
        u0 = u1 = 0
        if u_off0:
            p0 = read_prefix()
        if u_off1:
            p1 = read_prefix()
        if u_off0:
            u0 = read_suffix(p0)
        if u_off1:
            u1 = read_suffix(p1)
        return u0, u1
    else:
        u0 = u1 = 0
        p0 = p1 = 0
        if u_off0:
            p0 = read_prefix()
        if u_off1:
            p1 = read_prefix()
        if u_off0:
            u0 = read_suffix(p0)
        if u_off1:
            u1 = read_suffix(p1)
        return u0, u1


def decode_cleanup(seg: bytes, h: int, w: int) -> np.ndarray:
    """Decode an HT cleanup codeword segment into signed coefficients."""
    out = np.zeros((h, w), dtype=np.int64)
    if len(seg) < 2:
        return out
    scup = ((seg[-1] << 4) | (seg[-2] & 0xF))
    if scup < 2 or scup > len(seg):
        return out
    ms = MsDec(seg[: len(seg) - scup])
    mel = MelDec(seg[len(seg) - scup :])
    vlc = VlcDec(seg[len(seg) - scup :])

    nqw = (w + 1) // 2
    n_qrows = (h + 1) // 2
    prev_e = [0] * (nqw + 2)
    prev_cx = [0] * (nqw + 2)

    for qy in range(n_qrows):
        line0 = qy == 0
        tbl = DEC_TBL[0] if line0 else DEC_TBL[1]
        cur_e = [0] * (nqw + 2)
        cur_cx = [0] * (nqw + 2)
        c_left = 0

        qx = 0
        while qx < nqw:
            quads = []  # (rho, u_off, e_k, e_1, kappa, c_q)
            for j in range(2):
                qi = qx + j
                if qi >= nqw:
                    quads.append(None)
                    continue
                if line0:
                    c_q = c_left
                    kappa_base = None
                else:
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left
                    kappa_base = max(prev_e[qi], prev_e[qi + 1]) - 1
                if c_q == 0 and not mel.event():
                    rho, u_off, e_k, e_1, ln = 0, 0, 0, 0, 0
                else:
                    entry = tbl[c_q][vlc.peek(7)]
                    if entry is None:
                        raise ValueError("invalid VLC codeword")
                    rho, u_off, e_k, e_1, ln = entry
                    vlc.advance(ln)
                if line0:
                    kappa = 1
                else:
                    kappa = max(1, kappa_base) if (rho & (rho - 1)) else 1
                quads.append((rho, u_off, e_k, e_1, kappa, c_q))
                if line0:
                    c_left = (rho >> 1) | (rho & 1)
                else:
                    c_left = ((rho & 4) >> 1) | ((rho & 8) >> 2)

            u_off0 = quads[0][1] if quads[0] else 0
            u_off1 = quads[1][1] if quads[1] else 0
            u0, u1 = _dec_u_pair(vlc, line0, u_off0, u_off1, mel)

            for j, u in ((0, u0), (1, u1)):
                qi = qx + j
                q = quads[j]
                if q is None:
                    continue
                rho, u_off, e_k, e_1, kappa, c_q = q
                uq = kappa + u
                e_bl = 0
                e_br = 0
                for k in range(4):
                    if not (rho & (1 << k)):
                        continue
                    m = uq - ((e_k >> k) & 1)
                    v = ms.read(m)
                    v |= ((e_1 >> k) & 1) << m
                    sign = v & 1
                    mu = (v >> 1) + 1
                    e_n = (v | 1).bit_length()
                    y = 2 * qy + (k & 1)
                    x = 2 * qi + (k >> 1)
                    if y < h and x < w:
                        out[y, x] = -mu if sign else mu
                    if k == 1:
                        e_bl = e_n
                    elif k == 3:
                        e_br = e_n
                cur_e[qi] = max(cur_e[qi], e_bl)
                cur_e[qi + 1] = e_br
                cur_cx[qi] |= (rho & 2) >> 1
                cur_cx[qi + 1] = (rho & 8) >> 3
            qx += 2

        prev_e = cur_e
        prev_cx = cur_cx
    return out


# ========================================================== batch interface
def encode_cblks(coeffs, heights, widths, orients, num_threads: int = 0,
                 refine: bool = False, device: bool | None = None):
    """Batch API matching the Part-1 T1 backends.

    With ``refine``, blocks whose magnitudes span >= 2 bitplanes are coded
    as 3-pass HT sets (cleanup @ plane 1 + SigProp/MagRef @ plane 0), giving
    PCRD truncation points at the cleanup boundary.

    ``device`` selects the accelerator (jax/XLA) cleanup coder; defaults to
    the GROK_TPU_T1=ht-device env switch."""
    import os

    from .ebcot_np import T1EncodeResult
    from . import native as _native

    if device is None:
        device = os.environ.get("GROK_TPU_T1") == "ht-device"
    if device:
        from . import ht_jax

        return ht_jax.encode_cblks(coeffs, heights, widths, orients,
                                   num_threads, refine)
    if refine:
        return _encode_cblks_refine(coeffs, heights, widths, orients)
    if _native.available():
        return _native.ht_encode_cblks(coeffs, heights, widths, orients, num_threads)

    coeffs = np.asarray(coeffs, dtype=np.int64)
    n, h, w = coeffs.shape
    segs = []
    numbps = np.zeros(n, dtype=np.int64)
    dists = np.zeros((n, 1), dtype=np.float64)
    for i in range(n):
        hi, wi = int(heights[i]), int(widths[i])
        if hi == 0 or wi == 0:
            segs.append(b"")
            continue
        blk = coeffs[i, :hi, :wi]
        mx = int(np.abs(blk).max(initial=0))
        # HT convention (matches the reference, T1HT.cpp:125): magnitudes are
        # fully self-described by the MagSgn stream, so the signalled numbps
        # is always 1 for a non-empty block (imsb = Mb - 1)
        numbps[i] = 1 if mx else 0
        if mx == 0:
            segs.append(b"")
            continue
        segs.append(encode_cleanup(blk, hi, wi))
        dists[i, 0] = float((blk.astype(np.float64) ** 2).sum())
    lengths = np.array([len(s) for s in segs], dtype=np.int64)
    npasses = np.where(numbps > 0, 1, 0).astype(np.int64)
    maxlen = max(int(lengths.max(initial=0)), 1)
    data = np.zeros((n, maxlen), dtype=np.uint8)
    for i, s in enumerate(segs):
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    rates = lengths[:, None].astype(np.int64)
    return T1EncodeResult(
        data=data, lengths=lengths, numbps=numbps, npasses=npasses,
        pass_rates=rates, pass_dist=dists,
    )


def _encode_cblks_refine(coeffs, heights, widths, orients):
    from .ebcot_np import T1EncodeResult

    coeffs = np.asarray(coeffs, dtype=np.int64)
    n, h, w = coeffs.shape
    segs = []
    numbps = np.zeros(n, dtype=np.int64)
    npasses = np.zeros(n, dtype=np.int64)
    rates = np.zeros((n, 3), dtype=np.int64)
    dists = np.zeros((n, 3), dtype=np.float64)
    for i in range(n):
        hi, wi = int(heights[i]), int(widths[i])
        if hi == 0 or wi == 0:
            segs.append(b"")
            continue
        blk = coeffs[i, :hi, :wi]
        mx = int(np.abs(blk).max(initial=0))
        if mx == 0:
            segs.append(b"")
            continue
        e = float((blk.astype(np.float64) ** 2).sum())
        if mx < 2:
            # all magnitudes fit below the refinement plane: cleanup-only
            seg = encode_cleanup(blk, hi, wi)
            segs.append(seg)
            numbps[i] = 1
            npasses[i] = 1
            rates[i, 0] = len(seg)
            dists[i, 0] = e
            continue
        s1, s2 = encode_refinement(blk, hi, wi)
        segs.append(s1 + s2)
        numbps[i] = 2
        npasses[i] = 3
        rates[i] = (len(s1), len(s1) + len(s2), len(s1) + len(s2))
        # monotone heuristic split of the energy across the three passes
        dists[i] = (0.8 * e, 0.1 * e, 0.1 * e)
    lengths = np.array([len(s) for s in segs], dtype=np.int64)
    maxlen = max(int(lengths.max(initial=0)), 1)
    data = np.zeros((n, maxlen), dtype=np.uint8)
    for i, sg in enumerate(segs):
        data[i, : len(sg)] = np.frombuffer(sg, dtype=np.uint8)
    return T1EncodeResult(
        data=data, lengths=lengths, numbps=numbps, npasses=npasses,
        pass_rates=rates, pass_dist=dists,
    )


def decode_cblks(data, lengths, numbps, npasses, heights, widths, orients,
                 block_h, block_w, num_threads: int = 0, seg_lengths=None,
                 device: bool | None = None):
    import os

    from . import native as _native

    numbps = np.asarray(numbps, dtype=np.int64)
    npasses = np.asarray(npasses, dtype=np.int64)
    multi = (np.asarray(numbps) > 1) | (np.asarray(npasses) > 1)
    if device is None:
        device = os.environ.get("GROK_TPU_T1") == "ht-device"
    if device:
        from . import ht_jax_dec

        if not multi.any():
            out = ht_jax_dec.decode_cleanup_batch(
                np.asarray(data), lengths, heights, widths, block_h, block_w)
            zero = (np.asarray(npasses) <= 0) | (np.asarray(lengths) <= 0)
            out[zero] = 0
            return out, np.asarray(numbps, dtype=np.int64).copy()
        # multi-pass (refinement) sets decode on the host
        ht_jax_dec.STATS["host_fallbacks"] += int(data.shape[0])
    if _native.available() and not multi.any():
        return _native.ht_decode_cblks(
            data, lengths, numbps, npasses, heights, widths, orients,
            block_h, block_w, num_threads,
        )
    n = data.shape[0]
    if _native.available():
        # multi-pass blocks are decoded below; keep the native fast path for
        # the cleanup-only ones by hiding the others from it
        lengths_n = np.where(multi, 0, np.asarray(lengths, dtype=np.int64))
        out, planes = _native.ht_decode_cblks(
            data, lengths_n, numbps, npasses, heights, widths, orients,
            block_h, block_w, num_threads,
        )
        out = out.astype(np.int64, copy=False)
    else:
        out = np.zeros((n, block_h, block_w), dtype=np.int64)
        planes = np.asarray(numbps, dtype=np.int64).copy()
        for i in range(n):
            if npasses[i] <= 0 or lengths[i] <= 0 or multi[i]:
                continue
            hi, wi = int(heights[i]), int(widths[i])
            seg = bytes(data[i, : lengths[i]])
            out[i, :hi, :wi] = decode_cleanup(seg, hi, wi)
    for i in np.nonzero(multi)[0]:
        if npasses[i] <= 0 or lengths[i] <= 0:
            out[i] = 0
            continue
        hi, wi = int(heights[i]), int(widths[i])
        nb = int(numbps[i])
        if nb <= 1 and npasses[i] <= 1:
            continue
        if seg_lengths is not None and npasses[i] > 1:
            l1 = int(seg_lengths[i][0])
            l2 = int(seg_lengths[i][1]) if seg_lengths.shape[1] > 1 else 0
        else:
            l1 = int(lengths[i])
            l2 = 0
        seg1 = bytes(data[i, :l1])
        seg2 = bytes(data[i, l1 : l1 + l2])
        out[i, :hi, :wi] = decode_refinement(
            seg1, seg2, hi, wi, int(npasses[i]), nb
        )
        out[i, hi:, :] = 0
        out[i, :, wi:] = 0
    return out, np.asarray(numbps, dtype=np.int64).copy()


# ==================================== SigProp / MagRef refinement passes
# (T.814 7.4/7.5 — behavior cross-checked against the reference decoder's
# pipeline in t1_ht/coding/ojph_block_decoder.cpp; re-implemented scalar.)
#
# A 3-pass HT set codes the cleanup at bitplane 1 (magnitudes >> 1) and
# refines bitplane 0 with two raw-coded passes sharing one codeword segment:
# SigProp bits grow forward from its start, MagRef bits grow backward from
# its end (the same bidirectional packing the cleanup uses for MEL/VLC).


class SppEnc(MsEnc):
    """Forward LSB-first writer, zero-padded termination (decoder pads 0)."""

    def terminate(self) -> bytes:
        if self.used:
            self.bytes.append(self.tmp)
            self.max_bits = 8
            self.tmp = 0
            self.used = 0
        return bytes(self.bytes)


class SppDec(MsDec):
    """Forward LSB-first reader; pads 0 beyond the segment end."""

    def _fill(self, need):
        while self.bits < need:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0
            nbits = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
            self.tmp |= (b & ((1 << nbits) - 1)) << self.bits
            self.bits += nbits


class MrpEnc:
    """Backward-growing LSB-first writer with the >0x8F stuffing rule
    (the VLC scheme without the cleanup locator prefill)."""

    def __init__(self):
        self.bytes = bytearray()
        self.tmp = 0
        self.used = 0
        self.last_gt_8f = True  # the decoder starts with unstuff=True

    def encode(self, cwd, ln):
        while ln > 0:
            avail = 8 - (1 if self.last_gt_8f else 0) - self.used
            t = min(avail, ln)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            ln -= t
            cwd >>= t
            if avail == 0:
                if self.last_gt_8f and self.tmp != 0x7F:
                    self.last_gt_8f = False
                    continue
                self.bytes.append(self.tmp)
                self.last_gt_8f = self.tmp > 0x8F
                self.tmp = 0
                self.used = 0

    def terminate(self) -> bytes:
        out = bytearray(self.bytes)
        if self.used:
            out.append(self.tmp)
        return bytes(reversed(out))  # stream order: last-read byte last


class MrpDec:
    """Backward LSB-first reader from the end of the shared segment."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = len(data) - 1
        self.tmp = 0
        self.bits = 0
        self.unstuff = True

    def read(self, n) -> int:
        while self.bits < n:
            b = self.data[self.pos] if self.pos >= 0 else 0
            self.pos -= 1
            if self.unstuff and (b & 0x7F) == 0x7F:
                nbits = 7
            else:
                nbits = 8
            self.unstuff = b > 0x8F
            self.tmp |= (b & ((1 << nbits) - 1)) << self.bits
            self.bits += nbits
        v = self.tmp & ((1 << n) - 1)
        self.tmp >>= n
        self.bits -= n
        return v


def _sigprop_scan(h, w, sigma, visit):
    """Drive the SigProp scan order; ``visit(y, x, eligible)`` returns
    whether the sample became significant (updating ``new``). Eligibility =
    any 8-neighbor significant (cleanup or newly coded) at scan time; bits
    for each aligned 4-column group are emitted before that group's signs
    (the caller interleaves via its two callbacks)."""
    new = np.zeros_like(sigma)

    def any_nbr(y, x):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                yy, xx = y + dy, x + dx
                if 0 <= yy < h and 0 <= xx < w and (sigma[yy, xx] or new[yy, xx]):
                    return True
        return False

    for s in range(0, h, 4):
        rows = min(4, h - s)
        for g in range(0, w, 4):
            cols = range(g, min(g + 4, w))
            group = []
            for j in cols:
                for k in range(rows):
                    y = s + k
                    if sigma[y, j] or new[y, j]:
                        continue
                    if not any_nbr(y, j):
                        continue
                    became = visit(y, j)
                    if became:
                        new[y, j] = True
                        group.append((y, j))
            yield group  # caller codes this group's signs now
    return


def encode_refinement(coeffs: np.ndarray, h: int, w: int):
    """3-pass HT encode: returns (seg1, seg2).

    seg1 = cleanup at bitplane 1; seg2 = SigProp (fwd) + MagRef (bwd)
    refining bitplane 0."""
    mag = np.abs(coeffs)
    neg = coeffs < 0
    hi = mag >> 1
    cleanup_vals = np.where(neg, -hi, hi).astype(np.int64)
    seg1 = encode_cleanup(cleanup_vals, h, w)
    sigma = hi > 0

    spp = SppEnc()

    def visit(y, x):
        bit = int(mag[y, x] & 1)  # |v| in {0,1} here (hi == 0)
        spp.encode(bit, 1)
        return bit == 1

    scan = _sigprop_scan(h, w, sigma, visit)
    for group in scan:
        for (y, x) in group:
            spp.encode(int(neg[y, x]), 1)
    spp_bytes = spp.terminate()

    mrp = MrpEnc()
    for s in range(0, h, 4):
        rows = min(4, h - s)
        for j in range(w):
            for k in range(rows):
                y = s + k
                if sigma[y, j]:
                    mrp.encode(int(mag[y, j] & 1), 1)
    mrp_bytes = mrp.terminate()
    return seg1, spp_bytes + mrp_bytes


def decode_refinement(seg1: bytes, seg2: bytes, h: int, w: int,
                      npasses: int, numbps: int = 2) -> np.ndarray:
    """Decode an HT set with up to 3 passes (cleanup @ plane numbps-1 +
    SigProp + MagRef @ plane numbps-2). Missing refinement info
    reconstructs at the bin center (the reference's fixed-point
    convention: value = (mu << p) | (1 << (p-1)))."""
    p = max(numbps - 1, 1)
    hi = decode_cleanup(seg1, h, w)  # signed cleanup magnitudes (plane-p units)
    mag_hi = np.abs(hi)
    neg = hi < 0
    sigma = mag_hi > 0
    out_mag = np.where(sigma, (mag_hi << 1) | 1, 0).astype(np.int64)
    out_neg = neg.copy()

    if npasses >= 2 and len(seg2) > 0:
        spp = SppDec(seg2)

        def visit(y, x):
            return spp.read(1) == 1

        new_list = []
        for group in _sigprop_scan(h, w, sigma, visit):
            for (y, x) in group:
                out_neg[y, x] = spp.read(1) == 1
                out_mag[y, x] = 1
                new_list.append((y, x))

        if npasses >= 3:
            mrp = MrpDec(seg2)
            for s in range(0, h, 4):
                rows = min(4, h - s)
                for j in range(w):
                    for k in range(rows):
                        y = s + k
                        if sigma[y, j]:
                            bit = mrp.read(1)
                            # refine the plane below cleanup: replace center
                            out_mag[y, j] = (out_mag[y, j] & ~np.int64(1)) | bit

    out = np.where(out_neg, -out_mag, out_mag)
    if p > 1:
        # deeper truncation: scale to plane p-1 units and re-center
        mag = np.abs(out)
        mag = np.where(mag > 0, (mag << (p - 1)) | ((1 << (p - 1)) >> 1), 0)
        out = np.where(out < 0, -mag, mag)
    return out
