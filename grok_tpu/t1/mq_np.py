"""Batched MQ arithmetic coder (ITU-T T.88 / T.800 Annex C).

Lane-parallel formulation: one MQ encoder/decoder *per codeblock*, with all
register state held in [N]-shaped arrays so every ENCODE/DECODE step is a
handful of vectorized ops across the block batch. This is the batched
reformulation of the reference's per-thread scalar coder
(t1/t1_part1/mqc.h, mqc_enc.cpp, mqc_dec.cpp): lanes = codeblocks, the
per-bit state machine runs in lockstep with per-lane masks.

The same data layout carries over to jax.lax (t1/ebcot_jax.py); this numpy
version is the bit-exact host reference and fallback.
"""

from __future__ import annotations

import numpy as np

# T.88 Table E.1 — probability state machine.
QE = np.array(
    [
        0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
        0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
        0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
        0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
        0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
        0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601,
    ],
    dtype=np.int64,
)
NMPS = np.array(
    [
        1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
        20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46,
    ],
    dtype=np.uint8,
)
NLPS = np.array(
    [
        1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
        17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
        33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46,
    ],
    dtype=np.uint8,
)
SWITCH = np.array(
    [
        1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    ],
    dtype=np.uint8,
)

# Context indices (19 contexts, T.800 D.2).
NUM_CTX = 19
CTX_ZC0 = 0  # zero coding, zero-neighborhood context
CTX_SC0 = 9  # first sign-coding context
CTX_MR0 = 14  # first magnitude-refinement context
CTX_RL = 17  # run-length (aggregation) context
CTX_UNI = 18  # uniform context

# initial (state, mps) per context: all (0,0) except ZC0->4, RL->3, UNI->46
_INIT_STATES = np.zeros(NUM_CTX, dtype=np.uint8)
_INIT_STATES[CTX_ZC0] = 4
_INIT_STATES[CTX_RL] = 3
_INIT_STATES[CTX_UNI] = 46


def initial_ctx_states(n: int) -> tuple[np.ndarray, np.ndarray]:
    states = np.tile(_INIT_STATES, (n, 1))
    mps = np.zeros((n, NUM_CTX), dtype=np.uint8)
    return states, mps


class MQEncoder:
    """N independent MQ encoders advancing in lockstep.

    Output layout: per-lane byte buffer [N, max_bytes] plus a write position;
    the leading virtual byte absorbs carry propagation (dropped in data())."""

    def __init__(self, n: int, max_bytes: int):
        self.n = n
        self.a = np.full(n, 0x8000, dtype=np.int64)
        self.c = np.zeros(n, dtype=np.int64)
        self.ct = np.full(n, 12, dtype=np.int64)
        self.buf = np.zeros((n, max_bytes + 2), dtype=np.uint8)
        self.pos = np.zeros(n, dtype=np.int64)  # index of current byte B
        self.ctx_state, self.ctx_mps = initial_ctx_states(n)
        self._lanes = np.arange(n)
        # debug hook: when set to a list, every decision appends
        # (ctx, d, mask) — the grk_plugin_debug_mqc contextStream analogue
        # consumed by t1/debug.py (reference: plugin_interface.h:33-51)
        self.cxd_capture: list | None = None

    def reset_ctx(self, mask: np.ndarray) -> None:
        """Per-lane context reset (RESET codeblock style)."""
        init_s, init_m = initial_ctx_states(self.n)
        self.ctx_state = np.where(mask[:, None], init_s, self.ctx_state)
        self.ctx_mps = np.where(mask[:, None], init_m, self.ctx_mps)

    # -- internals ---------------------------------------------------------
    def _byteout(self, mask: np.ndarray) -> None:
        """Branch-free lockstep BYTEOUT for the masked lanes."""
        if not mask.any():
            return
        lanes = self._lanes
        pos = self.pos
        b = self.buf[lanes, pos].astype(np.int64)
        c = self.c

        is_ff = b == 0xFF
        carry = (c & 0x8000000) != 0

        # carry propagation into the previous byte (only when it isn't 0xFF)
        prop = mask & ~is_ff & carry
        b = np.where(prop, (b + 1) & 0xFF, b)
        self.buf[lanes, pos] = np.where(mask, b, self.buf[lanes, pos]).astype(np.uint8)
        c = np.where(prop & (b == 0xFF), c & 0x7FFFFFF, c)
        is_ff = b == 0xFF

        # stuffed (7-bit) emission after an 0xFF byte, else full 8-bit
        new_byte = np.where(is_ff, (c >> 20) & 0xFF, (c >> 19) & 0xFF)
        new_c = np.where(is_ff, c & 0xFFFFF, c & 0x7FFFF)
        new_ct = np.where(is_ff, 7, 8)

        wpos = np.where(mask, pos + 1, pos)
        prev = self.buf[lanes, wpos]
        self.buf[lanes, wpos] = np.where(mask, new_byte, prev).astype(np.uint8)
        self.pos = wpos
        self.c = np.where(mask, new_c, self.c)
        self.ct = np.where(mask, new_ct, self.ct)

    def _renorm(self, mask: np.ndarray) -> None:
        while mask.any():
            self.a = np.where(mask, self.a << 1, self.a)
            self.c = np.where(mask, self.c << 1, self.c)
            self.ct = np.where(mask, self.ct - 1, self.ct)
            self._byteout(mask & (self.ct == 0))
            mask = mask & ((self.a & 0x8000) == 0)

    # -- public ------------------------------------------------------------
    def encode(self, bit: np.ndarray, ctx: np.ndarray, mask: np.ndarray) -> None:
        """Encode one decision per masked lane. bit/ctx are [N] arrays."""
        if not mask.any():
            return
        if self.cxd_capture is not None:
            self.cxd_capture.append(
                (np.broadcast_to(ctx, (self.n,)).copy(),
                 np.broadcast_to(bit, (self.n,)).astype(np.uint8).copy(),
                 mask.copy()))
        lanes = self._lanes
        state = self.ctx_state[lanes, ctx]
        mps = self.ctx_mps[lanes, ctx]
        qe = QE[state]
        is_mps = (bit == mps) & mask
        is_lps = (bit != mps) & mask

        a = self.a
        a_sub = a - qe  # A - Qe, the MPS subinterval size

        # ---- MPS path (T.88 CODEMPS)
        no_renorm = is_mps & ((a_sub & 0x8000) != 0)
        renorm_mps = is_mps & ((a_sub & 0x8000) == 0)
        cond_ex = renorm_mps & (a_sub < qe)  # MPS takes the bottom interval
        # ---- LPS path (T.88 CODELPS)
        cond_ex_l = is_lps & (a_sub < qe)  # LPS takes the top interval

        self.c = np.where(
            no_renorm | (renorm_mps & ~cond_ex) | cond_ex_l, self.c + qe, self.c
        )
        # context update: one gather/scatter pair
        new_state = np.where(
            renorm_mps, NMPS[state], np.where(is_lps, NLPS[state], state)
        )
        self.ctx_state[lanes, ctx] = new_state.astype(np.uint8)
        sw = is_lps & (SWITCH[state] == 1)
        if sw.any():
            self.ctx_mps[lanes, ctx] = np.where(sw, 1 - mps, mps).astype(np.uint8)

        # ---- interval update (common)
        self.a = np.where(mask, a_sub, a)
        self.a = np.where(cond_ex | (is_lps & ~cond_ex_l), qe, self.a)

        self._renorm(renorm_mps | is_lps)

    def flush(self, mask: np.ndarray | None = None) -> None:
        """Standard FLUSH termination for the masked lanes."""
        if mask is None:
            mask = np.ones(self.n, dtype=bool)
        lanes_all = mask
        # SETBITS
        tempc = self.c + self.a
        c = self.c | 0xFFFF
        c = np.where(c >= tempc, c - 0x8000, c)
        self.c = np.where(lanes_all, c, self.c)
        # two byteouts with CT-shifted C (keep only the 32 register bits)
        for _ in range(2):
            self.c = np.where(lanes_all, (self.c << self.ct) & 0xFFFFFFFF, self.c)
            self._byteout(lanes_all)
        self.flushed = True

    def lengths(self) -> np.ndarray:
        """Flushed stream length per lane (current byte included unless 0xFF)."""
        b = self.buf[self._lanes, self.pos]
        return self.pos + np.where(b != 0xFF, 1, 0) - 1  # minus virtual byte

    # -- per-pass termination + raw (bypass) emission ----------------------
    # Lane-parallel mirrors of the native coder's TERMALL/BYPASS machinery
    # (terminate_restart / raw_* in native/t1_coder.cpp).

    def terminate_restart(self, mask: np.ndarray) -> np.ndarray:
        """FLUSH + restart the masked lanes; returns the stream lengths."""
        lens = self.lengths()
        if mask.any():
            self.flush(mask)
            lens = np.where(mask, self.lengths(), lens)
            # buf[len] (in buffer coords, incl. the virtual byte) is the
            # last counted byte — never 0xFF
            self.pos = np.where(mask, lens, self.pos)
            self.a = np.where(mask, 0x8000, self.a)
            self.c = np.where(mask, 0, self.c)
            b = self.buf[self._lanes, self.pos]
            self.ct = np.where(mask, np.where(b == 0xFF, 13, 12), self.ct)
        return lens

    def _ensure_raw_state(self):
        if not hasattr(self, "raw_tmp"):
            self.raw_tmp = np.zeros(self.n, dtype=np.int64)
            self.raw_used = np.zeros(self.n, dtype=np.int64)
            self.raw_avail = np.full(self.n, 8, dtype=np.int64)

    def raw_start(self, mask: np.ndarray) -> None:
        self._ensure_raw_state()
        b = self.buf[self._lanes, self.pos]
        self.raw_tmp = np.where(mask, 0, self.raw_tmp)
        self.raw_used = np.where(mask, 0, self.raw_used)
        self.raw_avail = np.where(mask, np.where(b == 0xFF, 7, 8),
                                  self.raw_avail)

    def raw_bit(self, bits: np.ndarray, mask: np.ndarray) -> None:
        """MSB-first raw bit with 0xFF stuffing (bypass segments)."""
        if not mask.any():
            return
        self._ensure_raw_state()
        self.raw_tmp = np.where(mask, (self.raw_tmp << 1) | bits, self.raw_tmp)
        self.raw_used = np.where(mask, self.raw_used + 1, self.raw_used)
        emit = mask & (self.raw_used == self.raw_avail)
        if emit.any():
            wpos = np.where(emit, self.pos + 1, self.pos)
            prev = self.buf[self._lanes, wpos]
            self.buf[self._lanes, wpos] = np.where(
                emit, self.raw_tmp & 0xFF, prev
            ).astype(np.uint8)
            self.pos = wpos
            b = self.buf[self._lanes, self.pos]
            self.raw_avail = np.where(emit, np.where(b == 0xFF, 7, 8),
                                      self.raw_avail)
            self.raw_tmp = np.where(emit, 0, self.raw_tmp)
            self.raw_used = np.where(emit, 0, self.raw_used)

    def raw_safe_len(self) -> np.ndarray:
        self._ensure_raw_state()
        return self.pos + np.where(self.raw_used > 0, 1, 0)

    def raw_terminate_restart_mq(self, mask: np.ndarray) -> np.ndarray:
        """Byte-align raw segments, restart MQ; returns stream lengths."""
        self._ensure_raw_state()
        lens = self.pos.copy()
        if not mask.any():
            return lens
        pend = mask & (self.raw_used > 0)
        if pend.any():
            tmp = (self.raw_tmp << (self.raw_avail - self.raw_used)) & 0xFF
            wpos = np.where(pend, self.pos + 1, self.pos)
            prev = self.buf[self._lanes, wpos]
            self.buf[self._lanes, wpos] = np.where(pend, tmp, prev).astype(
                np.uint8
            )
            self.pos = wpos
        b = self.buf[self._lanes, self.pos]
        fix = mask & (b == 0xFF)  # raw segments can't end 0xFF
        if fix.any():
            wpos = np.where(fix, self.pos + 1, self.pos)
            prev = self.buf[self._lanes, wpos]
            self.buf[self._lanes, wpos] = np.where(fix, 0, prev).astype(np.uint8)
            self.pos = wpos
        lens = np.where(mask, self.pos, lens)
        self.a = np.where(mask, 0x8000, self.a)
        self.c = np.where(mask, 0, self.c)
        b = self.buf[self._lanes, self.pos]
        self.ct = np.where(mask, np.where(b == 0xFF, 13, 12), self.ct)
        self.raw_used = np.where(mask, 0, self.raw_used)
        self.raw_tmp = np.where(mask, 0, self.raw_tmp)
        return lens

    def data(self, lane: int, length: int | None = None) -> bytes:
        if length is None:
            length = int(self.lengths()[lane])
        return bytes(self.buf[lane, 1 : 1 + length])


class MQDecoder:
    """N independent MQ decoders in lockstep over per-lane byte buffers."""

    def __init__(self, data: np.ndarray, lengths: np.ndarray):
        """data: [N, max_bytes] uint8; lengths: [N] actual segment lengths."""
        self.n = data.shape[0]
        # pad with 0xFF beyond each lane's end so BYTEIN feeds 1s
        self.data = data
        self.end = lengths.astype(np.int64)
        self._lanes = np.arange(self.n)
        self.bp = np.zeros(self.n, dtype=np.int64)
        b0 = self._byte_at(self.bp)
        self.c = b0.astype(np.int64) << 16
        self.ct = np.zeros(self.n, dtype=np.int64)
        self._bytein(np.ones(self.n, dtype=bool))
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = np.full(self.n, 0x8000, dtype=np.int64)
        self.ctx_state, self.ctx_mps = initial_ctx_states(self.n)

    def reset_ctx(self, mask: np.ndarray) -> None:
        init_s, init_m = initial_ctx_states(self.n)
        self.ctx_state = np.where(mask[:, None], init_s, self.ctx_state)
        self.ctx_mps = np.where(mask[:, None], init_m, self.ctx_mps)

    def _byte_at(self, idx: np.ndarray) -> np.ndarray:
        """Byte at idx (relative to the lane's segment base), or 0xFF
        beyond each lane's end."""
        base = getattr(self, "base", None)
        a = idx if base is None else idx + base
        clipped = np.minimum(np.maximum(a, 0), self.data.shape[1] - 1)
        vals = self.data[self._lanes, clipped]
        return np.where(idx < self.end, vals, np.uint8(0xFF)).astype(np.uint8)

    # -- per-segment re-init + raw reading (TERMALL/BYPASS decode) --------
    def init_registers(self, mask: np.ndarray, base: np.ndarray,
                       seg_len: np.ndarray) -> None:
        """Re-prime the MQ registers on a new codeword segment for the
        masked lanes (context states persist; native init_registers)."""
        if not hasattr(self, "base"):
            self.base = np.zeros(self.n, dtype=np.int64)
        if not mask.any():
            return
        self.base = np.where(mask, base, self.base)
        self.end = np.where(mask, seg_len, self.end)
        self.bp = np.where(mask, 0, self.bp)
        b0 = self._byte_at(np.zeros(self.n, dtype=np.int64)).astype(np.int64)
        self.c = np.where(mask, b0 << 16, self.c)
        save_c, save_ct, save_bp = self.c.copy(), self.ct.copy(), self.bp.copy()
        self._bytein(mask)
        self.c = np.where(mask, (self.c << 7) & 0xFFFFFFFF, self.c)
        self.ct = np.where(mask, self.ct - 7, self.ct)
        self.a = np.where(mask, 0x8000, self.a)

    def _ensure_raw_state(self):
        if not hasattr(self, "rtmp"):
            self.rtmp = np.zeros(self.n, dtype=np.int64)
            self.rbits = np.zeros(self.n, dtype=np.int64)
            self.rprev_ff = np.zeros(self.n, dtype=bool)
            self.rpos = np.zeros(self.n, dtype=np.int64)
            self.rbase = np.zeros(self.n, dtype=np.int64)
            self.rend = np.zeros(self.n, dtype=np.int64)

    def raw_init(self, mask: np.ndarray, base: np.ndarray,
                 seg_len: np.ndarray) -> None:
        self._ensure_raw_state()
        self.rbase = np.where(mask, base, self.rbase)
        self.rend = np.where(mask, seg_len, self.rend)
        self.rpos = np.where(mask, 0, self.rpos)
        self.rtmp = np.where(mask, 0, self.rtmp)
        self.rbits = np.where(mask, 0, self.rbits)
        self.rprev_ff = np.where(mask, False, self.rprev_ff)

    def raw_bit(self, mask: np.ndarray) -> np.ndarray:
        """MSB-first raw bit with unstuffing; 0xFF fed past segment end."""
        self._ensure_raw_state()
        out = np.zeros(self.n, dtype=np.uint8)
        if not mask.any():
            return out
        need = mask & (self.rbits == 0)
        if need.any():
            a = np.minimum(np.maximum(self.rbase + self.rpos, 0),
                           self.data.shape[1] - 1)
            vals = self.data[self._lanes, a]
            b = np.where(self.rpos < self.rend, vals, np.uint8(0xFF)).astype(np.int64)
            self.rpos = np.where(need, self.rpos + 1, self.rpos)
            nbits = np.where(self.rprev_ff, 7, 8)
            self.rbits = np.where(need, nbits, self.rbits)
            self.rprev_ff = np.where(need, b == 0xFF, self.rprev_ff)
            self.rtmp = np.where(need, b, self.rtmp)
        self.rbits = np.where(mask, self.rbits - 1, self.rbits)
        out = np.where(mask, (self.rtmp >> self.rbits) & 1, 0).astype(np.uint8)
        return out

    def _bytein(self, mask: np.ndarray) -> None:
        if not mask.any():
            return
        b = self._byte_at(self.bp)
        b1 = self._byte_at(self.bp + 1)
        is_ff = b == 0xFF
        marker = is_ff & (b1 > 0x8F)  # marker (or end): feed 1 bits
        adv7 = is_ff & ~marker

        c = self.c
        b1w = b1.astype(np.int64)
        new_c = np.where(
            marker, c + 0xFF00, np.where(adv7, c + (b1w << 9), c + (b1w << 8))
        )
        new_ct = np.where(marker, 8, np.where(adv7, 7, 8))
        new_bp = np.where(marker, self.bp, self.bp + 1)

        self.c = np.where(mask, new_c, c)
        self.ct = np.where(mask, new_ct, self.ct)
        self.bp = np.where(mask, new_bp, self.bp)

    def _renorm(self, mask: np.ndarray) -> None:
        while mask.any():
            self._bytein(mask & (self.ct == 0))
            self.a = np.where(mask, self.a << 1, self.a)
            self.c = np.where(mask, (self.c << 1) & 0xFFFFFFFF, self.c)
            self.ct = np.where(mask, self.ct - 1, self.ct)
            mask = mask & ((self.a & 0x8000) == 0)

    def decode(self, ctx: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Decode one decision per masked lane; returns bit [N] (0 where unmasked)."""
        if not mask.any():
            return np.zeros(self.n, dtype=np.uint8)
        lanes = self._lanes
        state = self.ctx_state[lanes, ctx]
        mps = self.ctx_mps[lanes, ctx]
        qe = QE[state]

        a = self.a - qe
        chigh = (self.c >> 16) & 0xFFFF

        lps_path = mask & (chigh < qe)
        mps_path = mask & ~lps_path

        # MPS region: Chigh -= Qe
        self.c = np.where(mps_path, self.c - (qe << 16), self.c)
        self.a = np.where(mask, a, self.a)

        need_renorm_mps = mps_path & ((a & 0x8000) == 0)
        ex_mps = need_renorm_mps & (a < qe)  # exchange: decode LPS symbol
        ex_lps = lps_path & (a < qe)  # exchange: decode MPS symbol
        nl = lps_path & ~ex_lps
        nmps_m = need_renorm_mps & ~ex_mps

        d = np.where(mps_path, mps, 1 - mps)
        d = np.where(ex_mps, 1 - mps, d)
        d = np.where(ex_lps, mps, d)

        new_state = np.where(
            nmps_m | ex_lps,
            NMPS[state],
            np.where(ex_mps | nl, NLPS[state], state),
        )
        self.ctx_state[lanes, ctx] = new_state.astype(np.uint8)
        sw = (ex_mps | nl) & (SWITCH[state] == 1)
        if sw.any():
            self.ctx_mps[lanes, ctx] = np.where(sw, 1 - mps, mps).astype(np.uint8)

        self.a = np.where(lps_path, qe, self.a)

        self._renorm(lps_path | need_renorm_mps)
        return np.where(mask, d, 0).astype(np.uint8)
