"""Per-tile encode/decode pipeline driver.

Parity target: tile/TileProcessor.cpp (doCompress / decompressT2T1) — the
orchestration of DC shift -> MCT -> DWT -> T1 -> T2 (and the mirror).

Structure is batch-first: all codeblocks of a tile are padded into one
[N, cbh, cbw] batch and entropy-coded by the lane-parallel coder in one
shot (the analogue of the reference's work-stealing block schedulers,
t1/T1CompressScheduler.cpp, without threads); DWT/MCT run as array ops
(numpy/native on the host, jax on the device via ops/jax_pipeline.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..codestream.quantizer import apply_band_quant, band_norm
from ..codestream.structs import Siz, Tcp
from ..core.params import QuantStyle
from ..core.rect import Rect, ceil_div
import time as _time

from ..core import trace
from ..ops import dwt as dwt_ops
from ..ops import mct as mct_ops
from ..t1 import select_backend
from ..t1.ebcot_np import T1EncodeResult
from ..t2.packets import CblkDec, CblkEnc, PrecinctCtx, decode_packet, encode_packet
from ..t2.progression import packet_order
from .geometry import BAND_LL, TileCompGeom, cached_tile_comp_geometry


def _band_origin_in_packed(geom: TileCompGeom, res_idx: int, orient: int):
    """Top-left of a band's data inside the Mallat-packed tile array."""
    if orient == BAND_LL:
        return 0, 0
    prev = geom.resolutions[res_idx - 1].rect
    ph, pw = prev.height, prev.width
    if orient == 1:  # HL
        return 0, pw
    if orient == 2:  # LH
        return ph, 0
    return ph, pw  # HH


def _reencode_blocks(t1res, mask, sub):
    """Splice a re-encoded subset (rows where mask is True) into a batched
    T1 result, widening the data / per-pass arrays if the deeper encode
    needs more room."""
    idx = np.flatnonzero(mask)
    n, mb = t1res.data.shape
    mb2 = sub.data.shape[1]
    raw, off = t1res.raw_data
    if mb2 > mb:
        raw2 = np.zeros((n, mb2 + off), dtype=np.uint8)
        raw2[:, : mb + off] = raw
        raw = raw2
    p1 = t1res.pass_rates.shape[1]
    p2 = sub.pass_rates.shape[1]
    rates, dists = t1res.pass_rates, t1res.pass_dist
    if p2 > p1:
        rates = np.zeros((n, p2), dtype=rates.dtype)
        rates[:, :p1] = t1res.pass_rates
        dists = np.zeros((n, p2), dtype=dists.dtype)
        dists[:, :p1] = t1res.pass_dist
    sraw, soff = sub.raw_data
    raw[idx, off : off + sub.data.shape[1]] = sraw[:, soff:]
    rates[idx] = 0
    rates[idx, : p2] = sub.pass_rates
    dists[idx] = 0.0
    dists[idx, : p2] = sub.pass_dist
    lengths = t1res.lengths.copy()
    lengths[idx] = sub.lengths
    numbps = t1res.numbps.copy()
    numbps[idx] = sub.numbps
    npasses = t1res.npasses.copy()
    npasses[idx] = sub.npasses
    return T1EncodeResult(
        data=raw[:, off:], raw_data=(raw, off), lengths=lengths,
        numbps=numbps, npasses=npasses, pass_rates=rates, pass_dist=dists)


def _batch_sq_sums(batch: np.ndarray) -> np.ndarray:
    """Per-block sum of squared coefficients (float64 exact for < 2^53),
    chunked so the float64 staging stays a few MB."""
    n = batch.shape[0]
    out = np.empty(n, dtype=np.float64)
    for i in range(0, n, 256):
        b = batch[i:i + 256].astype(np.float64)
        out[i:i + 256] = np.einsum("nij,nij->n", b, b)
    return out


def _repair_pass_rates(t1res) -> None:
    """Suffix-min monotone repair of conservative pass rates, in place.

    Non-terminated passes carry a conservative padding estimate that can
    exceed the NEXT terminated pass's exact length (the MQ flush emits
    fewer bytes than the mid-stream bound), making the cumulative rates
    locally decreasing. Any later rate is a valid byte bound for an
    earlier pass (its bytes cover the earlier prefix), so clamping each
    entry to the minimum of its suffix restores monotonicity without
    weakening the decodable-prefix guarantee. T2 multi-segment length
    signalling requires monotone rates (segment sizes are differences).
    """
    pr = t1res.pass_rates
    if pr.size == 0:
        return
    npass = np.asarray(t1res.npasses)
    cols = np.arange(pr.shape[1])
    pad = cols[None, :] >= npass[:, None]
    big = np.iinfo(pr.dtype).max
    work = np.where(pad, big, pr)
    work = np.minimum.accumulate(work[:, ::-1], axis=1)[:, ::-1]
    t1res.pass_rates[...] = np.where(pad, pr, work)


def _check_styles_supported(styles: np.ndarray, t1) -> None:
    """Reject codeblock styles the selected T1 backend cannot handle."""
    supported = getattr(t1, "SUPPORTED_STYLES", 0x3F)
    present = int(np.bitwise_or.reduce(np.asarray(styles, dtype=np.int64).ravel(), initial=0))
    bad = present & ~supported & 0x3F
    if bad:
        from ..core.errors import UnsupportedFeatureError

        raise UnsupportedFeatureError(
            f"T1 backend {t1.__name__} does not support codeblock style bits 0x{bad:02x}"
        )


@dataclass
class _CblkRef:
    comp: int
    res: int
    band_i: int
    prec: int
    cblk_i: int


class TileProcessor:
    def __init__(self, siz: Siz, tcp: Tcp, tile_index: int, enc_params=None):
        self.siz = siz
        self.tcp = tcp
        self.enc_params = enc_params  # CompressParams (encode side only)
        self.tile_index = tile_index
        self.tile_rect = siz.tile_bounds(tile_index)
        self.geoms: list[TileCompGeom] = []
        self._geom_keys: list[tuple] = []
        for c in range(siz.num_comps):
            comp = siz.comps[c]
            tc = Rect(
                ceil_div(self.tile_rect.x0, comp.dx),
                ceil_div(self.tile_rect.y0, comp.dy),
                ceil_div(self.tile_rect.x1, comp.dx),
                ceil_div(self.tile_rect.y1, comp.dy),
            )
            g, gkey = cached_tile_comp_geometry(c, tc, tcp.tccps[c])
            self.geoms.append(g)
            self._geom_keys.append(gkey)

    _FLAT_T2_CACHE: dict[tuple, object] = {}

    def _get_flat_t2(self, native_t2):
        """Process-wide FlatTileT2 cache (same key space as the geometry
        cache plus codeblock style; rebuilding the flat arrays per decode
        call costs ~50 ms on a 4K tile)."""
        flat = getattr(self, "_flat_t2", None)
        if flat is None:
            tcp = self.tcp
            key = (
                tuple(self._geom_keys),
                tuple(t.cblk_style & 0x7F for t in tcp.tccps),
                # the packet sequence (flat.order) depends on these
                tcp.num_layers, tcp.progression,
                tuple((p.res_start, p.comp_start, p.layer_end, p.res_end,
                       p.comp_end, p.order) for p in tcp.pocs),
            )
            cache = TileProcessor._FLAT_T2_CACHE
            flat = cache.get(key)
            if flat is None:
                flat = native_t2.FlatTileT2(
                    self.siz, self.tcp, self.geoms, self.tile_rect
                )
                if len(cache) >= 32:
                    try:  # concurrent tile workers may race the eviction
                        cache.pop(next(iter(cache)))
                    except (KeyError, StopIteration):
                        pass
                cache[key] = flat
            self._flat_t2 = flat
        return flat

    # ------------------------------------------------------------------ util
    def _comp_prec(self, c: int) -> int:
        """Bit depth incl. MCT range expansion (RCT chroma gains one bit)."""
        prec = self.siz.comps[c].prec
        if self.tcp.mct == 1 and not self.tcp.tccps[c].irreversible and c in (1, 2):
            prec += 1
        return prec

    def packet_part_counts(self, divider: str) -> list[int]:
        """Packet counts per tile-part for divider 'C'/'R'/'L' (the
        reference's newTilePartProgressionDivider boundaries)."""
        flat = getattr(self, "_flat_t2", None)
        if flat is not None:
            order = flat.order
        else:
            order = list(
                packet_order(self.siz, self.tcp, self.geoms, self.tile_rect)
            )
        key = {"C": lambda p: p.comp, "R": lambda p: p.res,
               "L": lambda p: p.layer}[divider]
        counts: list[int] = []
        cur = None
        cnt = 0
        for pk in order:
            k = key(pk)
            if cur is not None and k != cur:
                counts.append(cnt)
                cnt = 0
            cur = k
            cnt += 1
        if cnt:
            counts.append(cnt)
        return counts

    def _nominal_cblk(self) -> tuple[int, int]:
        h = max(1 << t.cblk_h_exp for t in self.tcp.tccps)
        w = max(1 << t.cblk_w_exp for t in self.tcp.tccps)
        return h, w

    # ==================================================================
    # encode
    # ==================================================================
    def compress(
        self, comp_arrays: list[np.ndarray], packed_headers: list[bytes] | None = None
    ) -> tuple[bytes, list[int]]:
        """comp_arrays: per-component int32 tile data (natural range).

        Returns (tile-part body bytes, per-packet lengths for PLT). With
        ``packed_headers`` (a list to append to), packet headers go there
        (PPT writing) and the body stream carries only packet bodies."""
        siz, tcp = self.siz, self.tcp
        ncomp = siz.num_comps
        irrev = tcp.tccps[0].irreversible

        # ---- device-resident transform chain (GROK_TPU_DEVICE=jax):
        # DC shift + MCT + DWT + quantization as one jitted XLA program
        from ..ops import jax_pipeline

        if jax_pipeline.device_enabled():
            for c in range(ncomp):
                apply_band_quant(self.geoms[c], tcp.tccps[c], self._comp_prec(c))
            fwd = getattr(self, "_dev_fwd", None)
            if fwd is None:
                enc_m = None
                if tcp.mct == 2:
                    enc_m = (
                        getattr(tcp, "_mct_enc_matrix", None)
                        if getattr(tcp, "_mct_enc_matrix", None) is not None
                        else np.linalg.inv(np.asarray(tcp.mct_dec_matrix))
                    )
                fwd = jax_pipeline.build_forward(
                    self.geoms, tcp.tccps, siz.comps, tcp.mct,
                    mct_enc_matrix=enc_m,
                )
                self._dev_fwd = fwd
            with trace.span("enc.device_fwd"), trace.device_trace():
                dev_out = fwd(*[
                    np.ascontiguousarray(comp_arrays[c], dtype=np.int32)
                    for c in range(ncomp)
                ])
                coeff_arrays = [np.asarray(x) for x in dev_out]
            return self._entropy_and_t2(coeff_arrays, packed_headers)

        # ---- DC shift + MCT (fused native kernel when available)
        _t_mct = _time.perf_counter() if trace.enabled() else 0.0
        from ..ops.native_ops import get_lib as _get_native

        _nlib = _get_native()
        shifted: list = [None] * ncomp
        fused_mct = (
            _nlib is not None
            and tcp.mct == 1
            and ncomp >= 3
            and comp_arrays[0].shape == comp_arrays[1].shape == comp_arrays[2].shape
        )
        if fused_mct:
            planes = [np.ascontiguousarray(comp_arrays[c], dtype=np.int32)
                      for c in range(3)]
            dcs = [0 if siz.comps[c].signed else 1 << (siz.comps[c].prec - 1)
                   for c in range(3)]
            nel = planes[0].size
            if irrev:
                outs = [np.empty(planes[0].shape, dtype=np.float32)
                        for _ in range(3)]
                _nlib.ict_dc_forward(planes[0], planes[1], planes[2],
                                     outs[0], outs[1], outs[2], nel,
                                     dcs[0], dcs[1], dcs[2], 0)
            else:
                outs = [np.empty(planes[0].shape, dtype=np.int32)
                        for _ in range(3)]
                _nlib.rct_dc_forward(planes[0], planes[1], planes[2],
                                     outs[0], outs[1], outs[2], nel,
                                     dcs[0], dcs[1], dcs[2], 0)
            shifted[0], shifted[1], shifted[2] = outs
            rest = range(3, ncomp)
        else:
            rest = range(ncomp)
        for c in rest:
            a = comp_arrays[c].astype(np.int32)
            a = mct_ops.dc_shift_forward(np, a, siz.comps[c].prec, siz.comps[c].signed)
            shifted[c] = a
        if not fused_mct and tcp.mct == 1 and ncomp >= 3:
            if irrev:
                r, g, b = (x.astype(np.float32) for x in shifted[:3])
                y, cb, cr = mct_ops.ict_forward(np, r, g, b)
                shifted[0], shifted[1], shifted[2] = y, cb, cr
            else:
                y, cb, cr = mct_ops.rct_forward(np, *shifted[:3])
                shifted[0], shifted[1], shifted[2] = y, cb, cr
        elif tcp.mct == 2:
            # Part-2 array-based MCT: the user's encoding matrix, float path
            m = np.asarray(
                getattr(tcp, "_mct_enc_matrix", None)
                if getattr(tcp, "_mct_enc_matrix", None) is not None
                else np.linalg.inv(np.asarray(tcp.mct_dec_matrix)),
                dtype=np.float32,
            )
            shifted = mct_ops.custom_mct_forward(
                np, [a.astype(np.float32) for a in shifted], m
            )

        # ---- per-component DWT + quantization to int coefficients
        if trace.enabled():
            trace.add("enc.mct_dc", _time.perf_counter() - _t_mct,
                      bytes_moved=2 * sum(a.nbytes for a in shifted))
        _t_dwt = _time.perf_counter() if trace.enabled() else 0.0
        coeff_arrays = []
        for c in range(ncomp):
            g = self.geoms[c]
            tccp = tcp.tccps[c]
            nl = tccp.num_resolutions - 1
            a = shifted[c]
            if irrev:
                a = a.astype(np.float32, copy=False)
            # every shifted[c] is an owned temporary (fused-MCT output /
            # dc_shift copy), so the DWT may scramble it in place — the
            # defensive .copy() here cost a full plane of memory traffic
            packed = dwt_ops.forward(np, a, g.rect, nl, irrev)
            apply_band_quant(g, tccp, self._comp_prec(c))
            if irrev:
                # deadzone scalar quantization per band
                bands = [
                    (*_band_origin_in_packed(g, res.r, band.orient),
                     band.rect.height, band.rect.width, band.step)
                    for res in g.resolutions
                    for band in res.bands
                ]
                from ..ops import native_ops

                q = native_ops.quant_bands(
                    np.ascontiguousarray(packed, dtype=np.float32),
                    bands, tccp.roi_shift,
                )
                if q is None:
                    q = np.zeros(packed.shape, dtype=np.int32)
                    for (oy, ox, bh, bw, step) in bands:
                        sl = (slice(oy, oy + bh), slice(ox, ox + bw))
                        vals = packed[sl]
                        q[sl] = (
                            np.sign(vals) * np.floor(np.abs(vals) / step)
                        ).astype(np.int32)
                    if tccp.roi_shift:
                        q = q << tccp.roi_shift
                coeff_arrays.append(q)
            else:
                if tccp.roi_shift:
                    packed = packed << tccp.roi_shift
                coeff_arrays.append(packed)

        if trace.enabled():
            trace.add("enc.dwt_quant", _time.perf_counter() - _t_dwt,
                      bytes_moved=4 * sum(a.nbytes for a in coeff_arrays))
        return self._entropy_and_t2(coeff_arrays, packed_headers)

    def compress_from_coeffs(self, coeff_arrays, packed_headers=None):
        """Entropy-code + T2 pre-transformed packed coefficient arrays
        (the distributed path: the DWT/MCT/quant ran sharded on a mesh)."""
        for c in range(self.siz.num_comps):
            apply_band_quant(self.geoms[c], self.tcp.tccps[c],
                             self._comp_prec(c))
        return self._entropy_and_t2(coeff_arrays, packed_headers)

    def _entropy_and_t2(self, coeff_arrays, packed_headers=None):
        """Codeblock gather -> T1 -> PCRD -> T2 packet emission."""
        siz, tcp = self.siz, self.tcp
        ncomp = siz.num_comps
        # ---- gather codeblocks into one preallocated batch
        cbh, cbw = self._nominal_cblk()
        import os

        from ..t2 import native_t2

        t2lib = native_t2.get_lib() if os.environ.get(
            "GROK_TPU_NATIVE_OPS", "1") != "0" else None
        refs = None
        _t_gather = _time.perf_counter() if trace.enabled() else 0.0
        if t2lib is not None:
            # flat path: entry order == ref order; native per-component gather
            flat = self._get_flat_t2(native_t2)
            n = len(flat.e_comp)
            if n == 0:
                return b"", []
            # np.empty + zero only partial slots: gather_rows overwrites
            # every element of full blocks, and only boundary blocks are
            # partial (zeroing the whole 100 MB batch costs ~15 ms at 4K)
            batch = np.empty((n, cbh, cbw), dtype=np.int32)
            partial = (flat.e_h < cbh) | (flat.e_w < cbw)
            if partial.any():
                batch[partial] = 0
            rows_all = np.arange(n, dtype=np.int32)
            nonempty = flat.e_h > 0
            for c in range(ncomp):
                mask = (flat.e_comp == c) & nonempty
                if not mask.any():
                    continue
                arr = np.ascontiguousarray(coeff_arrays[c], dtype=np.int32)
                t2lib.gather_rows(
                    arr, arr.shape[1],
                    np.ascontiguousarray(rows_all[mask]), int(mask.sum()),
                    np.ascontiguousarray(flat.e_py[mask]),
                    np.ascontiguousarray(flat.e_px[mask]),
                    np.ascontiguousarray(flat.e_h[mask]),
                    np.ascontiguousarray(flat.e_w[mask]),
                    batch, cbh, cbw, 0,
                )
            heights = flat.e_h.astype(np.int64)
            widths = flat.e_w.astype(np.int64)
            orients = flat.e_orient.astype(np.int64)
            styles = flat.cb_style
        else:
            refs = []
            slots = []  # (band array, y0, x0, h, w)
            hs, ws, ors = [], [], []
            for c in range(ncomp):
                g = self.geoms[c]
                arr = coeff_arrays[c]
                for res in g.resolutions:
                    for bi, band in enumerate(res.bands):
                        oy, ox = _band_origin_in_packed(g, res.r, band.orient)
                        for pi, prc in enumerate(band.precincts):
                            for ci, cg in enumerate(prc.cblks):
                                rect = cg.rect
                                refs.append(_CblkRef(c, res.r, bi, pi, ci))
                                ors.append(band.orient)
                                if rect.empty():
                                    slots.append(None)
                                    hs.append(0)
                                    ws.append(0)
                                    continue
                                y0 = rect.y0 - band.rect.y0 + oy
                                x0 = rect.x0 - band.rect.x0 + ox
                                slots.append((arr, y0, x0, rect.height, rect.width))
                                hs.append(rect.height)
                                ws.append(rect.width)

            n = len(refs)
            if n == 0:
                return b"", []
            batch = np.zeros((n, cbh, cbw), dtype=np.int32)
            for i, sl in enumerate(slots):
                if sl is None:
                    continue
                arr, y0, x0, bh2, bw2 = sl
                batch[i, :bh2, :bw2] = arr[y0 : y0 + bh2, x0 : x0 + bw2]
            heights = np.array(hs, dtype=np.int64)
            widths = np.array(ws, dtype=np.int64)
            orients = np.array(ors, dtype=np.int64)

            styles = np.array(
                [tcp.tccps[r.comp].cblk_style & 0x7F for r in refs], dtype=np.int32
            )
        if trace.enabled():
            trace.add("enc.gather", _time.perf_counter() - _t_gather,
                      bytes_moved=2 * batch.nbytes)
        use_ht = bool(tcp.tccps[0].cblk_style & 0x40)
        t1 = None if use_ht else select_backend()
        targets = self._layer_targets()

        # ---- rate-control plane skip: with byte budgets, the deep
        # magnitude bitplanes are coded only to be discarded by PCRD.
        # Encode the top K planes only; the coded pass data/rates/dists
        # are bit-identical to the full encode's prefix (plane p coding
        # never reads bits below p), then VERIFY per block that no
        # uncoded pass could have entered the allocation: the cut vertex
        # survives any extension iff the best possible slope from it to
        # an uncoded point — residual distortion over remaining-rate
        # floor — stays below the accepted lambda (convexity makes the
        # cut-vertex condition sufficient; see _plane_skip_unsafe).
        # Blocks that fail are re-encoded deeper and PCRD reruns.
        from ..t1 import native as _t1n

        plane_limits = None
        if (
            not use_ht
            and t1 is _t1n
            and _t1n.get_lib() is not None
            and hasattr(_t1n.get_lib(), "t1_encode_cblks_v2")
            and targets is not None
            and all(t is not None for t in targets)
            and not np.any(styles)
            # opt-in: at 1 bpp the deep planes are already quantized
            # away (measured: limited blocks 261/6321, T1 saving ~3%) and
            # the verify/deepen reallocation rounds cost more than they
            # save; higher-precision/higher-rate workloads with many deep
            # blocks are where this pays
            and os.environ.get("GROK_TPU_RATE_SKIP", "0") == "1"
        ):
            samples = int((heights * widths).sum())
            bpp = 8.0 * float(targets[-1]) / max(samples, 1)
            plane_limits = np.full(
                len(heights), max(3, int(np.ceil(bpp)) + 5), dtype=np.int32)

        def _encode(limits):
            with trace.span("enc.t1", bytes_moved=batch.nbytes):
                if use_ht:
                    from ..t1 import ht as t1h

                    refine = bool(getattr(self.enc_params, "ht_refine",
                                          False))
                    res = t1h.encode_cblks(batch, heights, widths, orients,
                                           refine=refine)
                else:
                    _check_styles_supported(styles, t1)
                    kw = {"plane_limits": limits} if limits is not None else {}
                    # pass distortions feed only the PCRD layer search; a
                    # single-layer untargeted encode takes every pass, so
                    # skip the per-event distortion accounting entirely
                    res = t1.encode_cblks(
                        batch, heights, widths, orients, styles=styles,
                        want_dist=self._needs_pass_dist(), **kw)
                _repair_pass_rates(res)
                return res

        def _encode_subset(mask, limits):
            # re-encode only the flagged blocks (typically a few deep
            # low-frequency ones); the caller splices them back
            idx = np.flatnonzero(mask)
            return t1.encode_cblks(
                np.ascontiguousarray(batch[idx]), heights[idx], widths[idx],
                orients[idx], styles=np.asarray(styles)[idx],
                want_dist=self._needs_pass_dist(),
                plane_limits=limits[idx])

        t1res = _encode(plane_limits)
        sq_sums = None

        # ---- PCRD layer allocation (iterative: re-run with a tightened
        # budget if the emitted packets overshoot the rate target, mirroring
        # the reference's simulate-then-write loop)
        with trace.span("enc.pcrd_t2"):
            for _round in range(4):
                lam_out: list = []
                w2_out: list = []
                shrink = 0
                for _attempt in range(4):
                    lam_out.clear()
                    w2_out.clear()
                    cum_passes = self._allocate_layers(
                        refs, t1res, extra_margin=shrink,
                        lam_out=lam_out, w2_out=w2_out)
                    if packed_headers is not None:
                        packed_headers.clear()
                    body, pkt_lens = self._emit_packets(
                        refs, t1res, cum_passes, packed_headers)
                    if targets is None or targets[-1] is None:
                        break
                    total = len(body)
                    if total <= targets[-1]:
                        break
                    shrink += total - targets[-1] + 16
                if plane_limits is None:
                    break
                if sq_sums is None:
                    sq_sums = _batch_sq_sums(batch)
                bad = self._plane_skip_unsafe(
                    sq_sums, t1res, cum_passes, lam_out, w2_out)
                if not bad.any():
                    break
                plane_limits = plane_limits.copy()
                if _round >= 2:
                    # give up on the stragglers: code them in full
                    plane_limits[bad] = np.asarray(
                        t1res.numbps, dtype=np.int64)[bad].astype(np.int32)
                else:
                    plane_limits[bad] += 3
                t1res = _reencode_blocks(
                    t1res, bad,
                    _encode_subset(bad, plane_limits))
        return body, pkt_lens

    def _plane_skip_unsafe(self, sq_sums, t1res, cum_passes, lam_out,
                           w2_out):
        """Blocks whose plane-limited encode might have changed the PCRD
        outcome: the final cut reached the coded ceiling, or an uncoded
        pass could present a hull slope >= the accepted lambda. The slope
        of ANY uncoded point u seen from the cut vertex is at most
        (residual distortion at the cut) / (R_ceiling - R_cut), because
        u's rate >= the ceiling rate and its distortion >= 0; when that
        bound < lambda the cut vertex's outgoing slope stays < lambda, so
        by convexity the included set is exactly the full encode's."""
        numbps = np.asarray(t1res.numbps)
        coded_np = np.asarray(t1res.npasses)
        full_np = np.where(numbps > 0, 3 * numbps - 2, 0)
        limited = coded_np < full_np
        n = len(coded_np)
        if not limited.any():
            return np.zeros(n, dtype=bool)
        lams = [l for l in lam_out if l is not None and np.isfinite(l)]
        lam = min(lams) if lams else 0.0
        if lam <= 0.0:
            return limited  # cannot verify: deepen every limited block
        w2 = w2_out[-1] if w2_out else np.ones(n)
        cut = np.asarray(cum_passes[-1], dtype=np.int64)
        rates = t1res.pass_rates
        idx_cut = np.maximum(cut - 1, 0)[:, None]
        R_cut = np.where(
            cut > 0, np.take_along_axis(rates, idx_cut, axis=1)[:, 0], 0)
        idx_ceil = np.maximum(coded_np - 1, 0)[:, None]
        R_ceil = np.where(
            coded_np > 0,
            np.take_along_axis(rates, idx_ceil.astype(np.int64),
                               axis=1)[:, 0], 0)
        wd = t1res.pass_dist * w2[:, None]
        csum = np.cumsum(wd, axis=1)
        D_gain = np.where(
            cut > 0, np.take_along_axis(csum, idx_cut, axis=1)[:, 0], 0.0)
        # sq_sums slightly overestimates the true residual (mid-bin
        # reconstruction leaves sub-unit error) -> bound is conservative
        resid = np.maximum(sq_sums * w2 - D_gain, 0.0)
        headroom = (R_ceil - R_cut).astype(np.float64)
        bound = resid / np.maximum(headroom, 1e-9)
        # headroom <= 0 also covers cuts sitting on a rate the limited
        # encode clamped to its own final length: those prefixes include
        # flush-touched bytes and must never be emitted
        return limited & ((cut >= coded_np) | (headroom <= 0)
                          | (bound >= lam * 0.99))

    def _emit_packets(self, refs, t1res, cum_passes, packed_headers=None):
        siz, tcp = self.siz, self.tcp
        ncomp = siz.num_comps
        # ---- native whole-tile packet emission (fast path)
        import os

        from ..t2 import native_t2

        lib = native_t2.get_lib() if os.environ.get(
            "GROK_TPU_NATIVE_OPS", "1") != "0" else None
        if lib is not None:
            flat = self._get_flat_t2(native_t2)
            use_sop = bool(tcp.csty & 0x02)
            use_eph = bool(tcp.csty & 0x04)
            body, pkt_lens, headers = native_t2.encode_packets(
                lib, flat, refs, t1res, cum_passes, tcp.num_layers,
                use_sop, use_eph, packed_headers is not None,
            )
            if packed_headers is not None:
                packed_headers.extend(headers)
            return body, pkt_lens
        # ---- build T2 state
        prc_ctx_map: dict[tuple[int, int, int, int], PrecinctCtx] = {}
        for c in range(ncomp):
            for res in self.geoms[c].resolutions:
                for bi, band in enumerate(res.bands):
                    for pi, prc in enumerate(band.precincts):
                        prc_ctx_map[(c, res.r, bi, pi)] = PrecinctCtx(band, prc)
        num_layers = tcp.num_layers
        for i, ref in enumerate(refs):
            key = (ref.comp, ref.res, ref.band_i, ref.prec)
            npasses = int(t1res.npasses[i])
            length = int(t1res.lengths[i])
            layer_passes: list[int] = []
            layer_bytes: list[int] = []
            first_layer = num_layers
            prev_k = 0
            prev_bytes = 0
            for li in range(num_layers):
                k = int(cum_passes[li, i])
                if k > prev_k:
                    nbytes = int(t1res.pass_rates[i, k - 1]) - prev_bytes
                    if first_layer == num_layers:
                        first_layer = li
                else:
                    nbytes = 0
                layer_passes.append(k - prev_k)
                layer_bytes.append(nbytes)
                prev_bytes += nbytes
                prev_k = k
            cb = CblkEnc(
                data=t1res.data[i],
                total_len=length,
                npasses=npasses,
                numbps=int(t1res.numbps[i]),
                layer_passes=layer_passes,
                layer_bytes=layer_bytes,
                first_layer=first_layer,
                style=int(tcp.tccps[ref.comp].cblk_style) & 0x3F,
                pass_rates=t1res.pass_rates[i],
            )
            prc_ctx_map[key].cblks[ref.cblk_i] = cb

        for ctx in prc_ctx_map.values():
            ctx.set_encoder_trees(tcp.num_layers)

        # ---- emit packets in progression order
        parts: list[bytes] = []
        use_sop = bool(tcp.csty & 0x02)
        use_eph = bool(tcp.csty & 0x04)
        sop = 0
        for pk in packet_order(siz, tcp, self.geoms, self.tile_rect):
            res = self.geoms[pk.comp].resolutions[pk.res]
            ctxs = [
                prc_ctx_map[(pk.comp, pk.res, bi, pk.prec)]
                for bi in range(len(res.bands))
            ]
            encode_packet(parts, ctxs, pk.layer, use_sop, use_eph, sop,
                          packed_headers)
            sop += 1
        return b"".join(parts), [len(p) for p in parts]

    def _layer_targets(self) -> list[float | None] | None:
        """Cumulative byte budgets per layer from the configured ratios."""
        p = self.enc_params
        rates_cfg = getattr(p, "layer_rates", None) if p is not None else None
        if not rates_cfg:
            return None
        tile_bits = 0
        for c in range(self.siz.num_comps):
            tile_bits += self.geoms[c].rect.area * self.siz.comps[c].prec
        tile_bytes = tile_bits / 8.0
        targets: list[float | None] = []
        for li in range(self.tcp.num_layers):
            ratio = rates_cfg[li] if li < len(rates_cfg) else 0
            targets.append(None if not ratio or ratio <= 1.0 else tile_bytes / float(ratio))
        return targets

    def _needs_pass_dist(self) -> bool:
        """Whether PCRD will read per-pass distortions: the single
        predicate behind both the T1 want_dist request and the
        _allocate_layers take-everything shortcut."""
        p = self.enc_params
        rates = getattr(p, "layer_rates", None) if p is not None else None
        psnrs = getattr(p, "layer_psnrs", None) if p is not None else None
        return not (self.tcp.num_layers == 1 and not rates and not psnrs)

    def _allocate_layers(self, refs, t1res, extra_margin: float = 0.0,
                         lam_out: list | None = None,
                         w2_out: list | None = None) -> np.ndarray:
        """PCRD: cumulative pass counts per layer [L, N] (parity:
        TileProcessor.cpp rateAllocate/pcrdBisectFeasible)."""
        from ..t2.rate_control import allocate_layers

        tcp = self.tcp
        num_layers = tcp.num_layers
        n = len(t1res.npasses)
        p = self.enc_params
        rates_cfg = getattr(p, "layer_rates", None) if p is not None else None
        psnrs_cfg = getattr(p, "layer_psnrs", None) if p is not None else None

        if not self._needs_pass_dist():
            return t1res.npasses[None, :].astype(np.int64)
        if psnrs_cfg and rates_cfg:
            raise ValueError("layer_rates and layer_psnrs are exclusive")

        # distortion weights: (step * band-synthesis-norm * mct-weight)^2
        mct_w = self._mct_weights()

        def band_w2(c, r, bi):
            band = self.geoms[c].resolutions[r].bands[bi]
            tccp = tcp.tccps[c]
            nl = tccp.num_resolutions - 1
            lvl = band.level if band.orient != 0 else nl
            bn = band_norm(tccp.irreversible, band.orient, lvl)
            return (band.step * bn * mct_w[c]) ** 2

        if refs is None:
            flat = self._flat_t2
            per_band = np.array(
                [band_w2(c, r, bi) for (c, r, bi) in flat.band_keys],
                dtype=np.float64,
            )
            w2 = per_band[flat.e_band]
        else:
            w2 = np.ones(n, dtype=np.float64)
            for i, ref in enumerate(refs):
                w2[i] = band_w2(ref.comp, ref.res, ref.band_i)
        dists = t1res.pass_dist * w2[:, None]
        if w2_out is not None:
            w2_out.append(w2)

        # cumulative byte targets per layer (minus any measured overshoot)
        targets = self._layer_targets() or [None] * num_layers
        targets = [None if t is None else max(t - extra_margin, 0.0) for t in targets]

        # fixed-quality (PSNR) layers: residual-distortion ceilings in the
        # weighted (image-domain) squared-error units of `dists`
        dist_targets = None
        if psnrs_cfg:
            samples = sum(g.rect.area for g in self.geoms)
            peak = max(
                (1 << self.siz.comps[c].prec) - 1
                for c in range(self.siz.num_comps)
            )
            dist_targets = [
                None if (q is None or q <= 0)
                else samples * float(peak) ** 2 / (10.0 ** (q / 10.0))
                for q in psnrs_cfg
            ]

        # exact rate simulation (reference compressPacketsSimulate parity)
        # when the native T2 is available and the flat encode path is active
        exact_rate_fn = None
        if refs is None and getattr(p, "rc_algorithm", 0) != 1:
            import os

            from ..t2 import native_t2

            lib = native_t2.get_lib() if os.environ.get(
                "GROK_TPU_NATIVE_OPS", "1") != "0" else None
            flat = getattr(self, "_flat_t2", None)
            if lib is not None and flat is not None:
                use_sop = bool(tcp.csty & 0x02)
                use_eph = bool(tcp.csty & 0x04)
                ppt = bool(getattr(p, "write_ppt", False)) if p else False

                def exact_rate_fn(rows):
                    return native_t2.encode_packets(
                        lib, flat, None, t1res,
                        np.ascontiguousarray(np.stack(rows), dtype=np.int64),
                        len(rows), use_sop, use_eph, ppt, simulate=True,
                    )

        n_prc = sum(
            res.num_precincts for g in self.geoms for res in g.resolutions
        )
        per_pkt = 1.2 + (2 if (tcp.csty & 0x04) else 0) + (6 if (tcp.csty & 0x02) else 0)

        def header_overhead(cum):
            # per-packet floor (incl. EPH/SOP markers) + ~4 bytes per
            # included block's header contribution
            included = int((cum > 0).sum())
            return n_prc * per_pkt + included * 4.0

        return allocate_layers(
            t1res.pass_rates, dists, t1res.npasses, targets, header_overhead,
            exact_rate_fn=exact_rate_fn, dist_targets=dist_targets,
            lam_out=lam_out,
        )

    def _mct_weights(self) -> list[float]:
        """L2 norms of the inverse MCT columns (error propagation weights)."""
        ncomp = self.siz.num_comps
        if self.tcp.mct != 1 or ncomp < 3:
            return [1.0] * ncomp
        if self.tcp.tccps[0].irreversible:
            m = mct_ops._ICT_INV
        else:
            # linearized inverse RCT, rows (R,G,B) x cols (Y,Cb,Cr)
            m = np.array(
                [[1.0, -0.25, 0.75], [1.0, -0.25, -0.25], [1.0, 0.75, -0.25]]
            )
        w = [float(np.linalg.norm(m[:, j])) for j in range(3)]
        return w + [1.0] * (ncomp - 3)

    # ==================================================================
    # decode
    # ==================================================================

    def _decompress_t1_flat(self, lib, body, max_layers, reduce,
                            packed_headers, use_sop, use_eph, cbh, cbw,
                            staging, comp_windows=None, fused_deq=False,
                            plt=None):
        """Array-driven T2 parse + T1 decode + scatter (no per-cblk objects)."""
        from ..t2 import native_t2

        siz, tcp = self.siz, self.tcp
        ncomp = siz.num_comps
        flat = self._get_flat_t2(native_t2)
        # entry "want" mask, known BEFORE the packet parse: geometry +
        # reduce + decode window. Feeds the T2 skip fast path — unwanted
        # packets are jumped via PLT lengths (reference parity:
        # PacketLengthMarkers + PacketParser skip) or parsed-and-dropped.
        te = len(flat.e_comp)
        want_entry = (flat.e_h > 0) & (flat.e_w > 0)
        if reduce:
            numres = np.array(
                [tcp.tccps[c].num_resolutions for c in range(ncomp)],
                dtype=np.int32,
            )
            want_entry &= flat.e_res < (numres[flat.e_comp] - reduce)
        if comp_windows is not None:
            # windowed decode: keep only codeblocks inside the per-level
            # filter supports (everything else never touches the T1 coder)
            want_entry &= self._window_entry_mask(flat, reduce, comp_windows)
        pkt_skip = None
        if reduce or comp_windows is not None:
            pkt_skip = self._pkt_skip_mask(flat, want_entry)
        with trace.span("dec.t2_parse", bytes_moved=len(body)):
            entry_numbps, (c_entry, c_np, c_nb, c_off), body_arr, n_skip = (
                native_t2.decode_packets(
                    lib, flat, bytes(body), max_layers, use_sop, use_eph,
                    bytes(packed_headers) if packed_headers is not None else None,
                    plt_lens=plt, pkt_skip=pkt_skip,
                )
            )
        self.last_t2_skipped = n_skip
        entry_np = np.zeros(te, dtype=np.int64)
        entry_bytes = np.zeros(te, dtype=np.int64)
        if len(c_entry):
            np.add.at(entry_np, c_entry, c_np.astype(np.int64))
            np.add.at(entry_bytes, c_entry, c_nb)
        keep = (entry_np > 0) & want_entry
        sel = np.nonzero(keep)[0]
        n = len(sel)
        # staging planes are np.empty on this path: every wanted entry
        # must be written. Blocks whose packets were rate-truncated to
        # zero passes (entry_np == 0) never reach the T1 scatter, so
        # their rects get a zero plane scattered here.
        self._scatter_zero_holes(lib, flat, want_entry & (entry_np == 0),
                                 staging, cbh, cbw, fused_deq)
        if n == 0:
            return
        row_of = np.full(te, -1, dtype=np.int32)
        row_of[sel] = np.arange(n, dtype=np.int32)
        lens = entry_bytes[sel]
        maxlen = int(lens.max(initial=0))
        # np.empty: the T1 decoders read only lens[i] bytes per lane
        data = np.empty((n, max(maxlen, 1)), dtype=np.uint8)
        cursors = np.zeros(n, dtype=np.int64)
        if len(c_entry):
            with trace.span("dec.gather_seg", bytes_moved=2 * int(lens.sum())):
                lib.gather_segments(
                    body_arr, np.ascontiguousarray(row_of[c_entry]),
                    np.ascontiguousarray(c_nb), np.ascontiguousarray(c_off),
                    len(c_entry), data, data.shape[1], cursors,
                )
        styles = flat.cb_style[sel]
        nbps = entry_numbps[sel].astype(np.int64)
        nps = entry_np[sel]
        hs = flat.e_h[sel].astype(np.int64)
        ws = flat.e_w[sel].astype(np.int64)
        ors = flat.e_orient[sel].astype(np.int64)

        seg_arr = None
        if (styles & 0x45).any():
            # native single-pass contribution->segment merge (stream order)
            msegs = int(min(nps.max(initial=0), 159)) + 1
            seg_arr = np.zeros((n, max(msegs, 1)), dtype=np.int64)
            lib.merge_contrib_segments(
                np.ascontiguousarray(row_of[c_entry]),
                np.ascontiguousarray(c_np.astype(np.int64)),
                np.ascontiguousarray(c_nb),
                len(c_entry),
                np.ascontiguousarray(styles.astype(np.int32)),
                np.ascontiguousarray(nps.astype(np.int64)),
                n, seg_arr, seg_arr.shape[1],
            )

        self._roi_in_t1 = False
        with trace.span("dec.t1", bytes_moved=int(lens.sum())
                        + n * cbh * cbw * 4):
            if tcp.tccps[0].cblk_style & 0x40:
                from ..t1 import ht as t1

                coeffs, planes = t1.decode_cblks(
                    data, lens, nbps, nps, hs, ws, ors, cbh, cbw,
                    seg_lengths=seg_arr,
                )
            else:
                t1 = select_backend()
                _check_styles_supported(styles, t1)
                styles64 = styles.astype(np.int64)
                roi_per_comp = np.array(
                    [t2.roi_shift for t2 in tcp.tccps], dtype=np.int64)
                if roi_per_comp.any():
                    # scaled-domain ROI downshift happens inside the T1
                    # writeout (reference RoiShiftFilter order); the roi
                    # shift rides style bits 8-15
                    styles64 = styles64 | (
                        roi_per_comp[flat.e_comp[sel]] << 8)
                    self._roi_in_t1 = True
                coeffs, planes = t1.decode_cblks(
                    data, lens, nbps, nps, hs, ws, ors, cbh, cbw,
                    styles=styles64, seg_lengths=seg_arr,
                )
        coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
        rows_all = np.arange(n, dtype=np.int32)
        comp_sel = flat.e_comp[sel]
        _t_scatter = _time.perf_counter() if trace.enabled() else 0.0
        if fused_deq:
            band_steps = np.array(
                [self.geoms[c].resolutions[r].bands[bi].step
                 for (c, r, bi) in flat.band_keys], dtype=np.float32,
            )
            row_steps = band_steps[flat.e_band[sel]]
        for c in range(ncomp):
            mask = comp_sel == c
            if not mask.any():
                continue
            if fused_deq:
                lib.scatter_rows_dequant(
                    coeffs, cbh, cbw,
                    np.ascontiguousarray(rows_all[mask]), int(mask.sum()),
                    np.ascontiguousarray(flat.e_py[sel][mask]),
                    np.ascontiguousarray(flat.e_px[sel][mask]),
                    np.ascontiguousarray(flat.e_h[sel][mask]),
                    np.ascontiguousarray(flat.e_w[sel][mask]),
                    np.ascontiguousarray(row_steps[mask]),
                    staging[c], staging[c].shape[1], 0,
                )
            elif not isinstance(staging[c], np.ndarray):
                # sparse canvas (windowed decode): python writes — the
                # window restriction keeps the block count small
                pys = flat.e_py[sel][mask]
                pxs = flat.e_px[sel][mask]
                hhs = flat.e_h[sel][mask]
                wws = flat.e_w[sel][mask]
                for r2, py2, px2, h2, w2 in zip(
                        rows_all[mask], pys, pxs, hhs, wws):
                    staging[c].write(int(py2), int(px2),
                                     coeffs[r2, :h2, :w2])
            else:
                lib.scatter_rows(
                    coeffs, cbh, cbw,
                    np.ascontiguousarray(rows_all[mask]), int(mask.sum()),
                    np.ascontiguousarray(flat.e_py[sel][mask]),
                    np.ascontiguousarray(flat.e_px[sel][mask]),
                    np.ascontiguousarray(flat.e_h[sel][mask]),
                    np.ascontiguousarray(flat.e_w[sel][mask]),
                    staging[c], staging[c].shape[1], 0,
                )
        if trace.enabled():
            trace.add("dec.scatter", _time.perf_counter() - _t_scatter,
                      bytes_moved=2 * coeffs.nbytes)

    @staticmethod
    def _scatter_zero_holes(lib, flat, hole_mask, staging, cbh, cbw,
                            fused_deq):
        holes = np.nonzero(hole_mask & (flat.e_h > 0) & (flat.e_w > 0))[0]
        if len(holes) == 0:
            return
        zero_plane = np.zeros((1, cbh, cbw), dtype=np.int32)
        zrows = np.zeros(len(holes), dtype=np.int32)
        for c in np.unique(flat.e_comp[holes]):
            m = flat.e_comp[holes] == c
            if not isinstance(staging[c], np.ndarray):
                continue  # sparse canvas: unwritten chunks read as zero
            if fused_deq:
                lib.scatter_rows_dequant(
                    zero_plane, cbh, cbw,
                    np.ascontiguousarray(zrows[m]), int(m.sum()),
                    np.ascontiguousarray(flat.e_py[holes][m]),
                    np.ascontiguousarray(flat.e_px[holes][m]),
                    np.ascontiguousarray(flat.e_h[holes][m]),
                    np.ascontiguousarray(flat.e_w[holes][m]),
                    np.zeros(int(m.sum()), dtype=np.float32),
                    staging[c], staging[c].shape[1], 0,
                )
            else:
                lib.scatter_rows(
                    zero_plane, cbh, cbw,
                    np.ascontiguousarray(zrows[m]), int(m.sum()),
                    np.ascontiguousarray(flat.e_py[holes][m]),
                    np.ascontiguousarray(flat.e_px[holes][m]),
                    np.ascontiguousarray(flat.e_h[holes][m]),
                    np.ascontiguousarray(flat.e_w[holes][m]),
                    staging[c], staging[c].shape[1], 0,
                )

    @staticmethod
    def _pkt_skip_mask(flat, want_entry):
        """Per-packet skip mask: a packet is unwanted when no codeblock of
        its precincts is wanted. Precinct-monotone by construction (reduce,
        window and layer truncation never re-want a precinct), which the
        native PLT skip path requires."""
        off = flat.prc_cb_off
        nprc = len(flat.prc_numbps)
        prc_any = np.zeros(nprc, dtype=bool)
        nonempty = off[1:] > off[:-1]
        if nonempty.any():
            # dropping empty segments' start offsets is safe for reduceat:
            # they span zero elements, so each retained segment still covers
            # exactly its own entries
            prc_any[nonempty] = np.bitwise_or.reduceat(
                want_entry, off[:-1][nonempty]
            )
        pkt_vals = prc_any[flat.pkt_prc_ids]
        po = flat.pkt_prc_off
        pkt_any = np.zeros(len(flat.pkt_layer), dtype=bool)
        pne = po[1:] > po[:-1]
        if pne.any():
            pkt_any[pne] = np.bitwise_or.reduceat(pkt_vals, po[:-1][pne])
        return (~pkt_any).astype(np.int32)

    def _window_entry_mask(self, flat, reduce, comp_windows):
        """Entry mask: codeblock rect intersects its band's needed region."""
        siz, tcp = self.siz, self.tcp
        mask = np.zeros(len(flat.e_comp), dtype=bool)
        band_need = {}
        for c in range(siz.num_comps):
            g = self.geoms[c]
            tccp = tcp.tccps[c]
            nl_red = max(tccp.num_resolutions - 1 - reduce, 0)
            rect_red = g.rect.ceil_div_pow2(reduce) if reduce else g.rect
            needs = dwt_ops.window_band_needs(
                rect_red, nl_red, tccp.irreversible, comp_windows[c]
            )
            for (rr, orient), r in needs.items():
                band_need[(c, rr, orient)] = r
        for e in range(len(flat.e_comp)):
            if flat.e_h[e] <= 0 or flat.e_w[e] <= 0:
                continue
            key = (int(flat.e_comp[e]), int(flat.e_res[e]),
                   int(flat.e_orient[e]))
            need = band_need.get(key)
            if need is None or need.empty():
                continue
            c = int(flat.e_comp[e])
            band = self.geoms[c].resolutions[int(flat.e_res[e])].bands[
                0 if flat.e_orient[e] == 0 else
                [b.orient for b in
                 self.geoms[c].resolutions[int(flat.e_res[e])].bands].index(
                    int(flat.e_orient[e]))
            ]
            cg = None  # rect from entry py/px is packed coords; use band rect
            # entry rect in band coords: reconstruct from packed offsets
            # (e_py/e_px are packed-array coords = band coords + band origin)
            oy, ox = _band_origin_in_packed(
                self.geoms[c], int(flat.e_res[e]), int(flat.e_orient[e])
            )
            by0 = int(flat.e_py[e]) - oy + band.rect.y0
            bx0 = int(flat.e_px[e]) - ox + band.rect.x0
            r = Rect(bx0, by0, bx0 + int(flat.e_w[e]), by0 + int(flat.e_h[e]))
            if not r.intersect(need).empty():
                mask[e] = True
        return mask

    def _decompress_t1_objects(self, body, max_layers, reduce,
                               packed_headers, use_sop, use_eph, cbh, cbw,
                               staging):
        """Reference per-object T2/T1 decode path (numpy fallback)."""
        siz, tcp = self.siz, self.tcp
        ncomp = siz.num_comps
        prc_ctx_map: dict[tuple[int, int, int, int], PrecinctCtx] = {}
        for c in range(ncomp):
            g = self.geoms[c]
            for res in g.resolutions:
                for bi, band in enumerate(res.bands):
                    for pi, prc in enumerate(band.precincts):
                        ctx = PrecinctCtx(band, prc)
                        sty = tcp.tccps[c].cblk_style & 0x7F
                        for ci in range(len(prc.cblks)):
                            ctx.cblks[ci] = CblkDec(style=sty)
                        prc_ctx_map[(c, res.r, bi, pi)] = ctx
        pos = 0
        hdr_reader = None
        if packed_headers is not None:
            from ..codestream.bitio import BitReader

            hdr_reader = BitReader(packed_headers, 0)
        order = list(packet_order(siz, tcp, self.geoms, self.tile_rect))
        last_wanted = -1
        for i, pk in enumerate(order):
            if not (max_layers and pk.layer >= max_layers):
                last_wanted = i
        for i, pk in enumerate(order):
            if i > last_wanted:
                break  # pure unwanted suffix: stop reading
            # mid-stream unwanted layers (non-layer-outermost progressions)
            # are parsed-and-dropped to keep the stream position aligned
            drop = bool(max_layers and pk.layer >= max_layers)
            res = self.geoms[pk.comp].resolutions[pk.res]
            ctxs = [
                prc_ctx_map[(pk.comp, pk.res, bi, pk.prec)]
                for bi in range(len(res.bands))
            ]
            if pos >= len(body) and hdr_reader is None:
                break  # truncated stream: remaining packets empty
            pos = decode_packet(
                body, pos, ctxs, pk.layer, use_sop, use_eph, hdr_reader,
                drop=drop,
            )

        refs, datas, lens, nps, nbps, hs, ws, ors = [], [], [], [], [], [], [], []
        seg_lists = []
        for (c, r, bi, pi), ctx in prc_ctx_map.items():
            if reduce and r >= tcp.tccps[c].num_resolutions - reduce:
                continue  # resolution discarded: never entropy-decode
            band = self.geoms[c].resolutions[r].bands[bi]
            for ci, (cg, cb) in enumerate(zip(ctx.prc.cblks, ctx.cblks)):
                if cb is None or cb.npasses == 0 or cg.rect.empty():
                    continue
                seg = b"".join(cb.segments)
                refs.append(_CblkRef(c, r, bi, pi, ci))
                datas.append(seg)
                lens.append(len(seg))
                nps.append(cb.npasses)
                nbps.append(cb.numbps)
                hs.append(cg.rect.height)
                ws.append(cg.rect.width)
                ors.append(band.orient)
                if cb.style & 0x45:
                    # merge contribution pieces into whole codeword
                    # segments (a layer boundary may split a segment)
                    from ..t2.packets import _segment_splits

                    targets = _segment_splits(cb.style, 0, cb.npasses)
                    merged = []
                    acc_b, acc_p = 0, 0
                    ti2 = 0
                    for chunk, np_c in zip(cb.segments, cb.seg_passes):
                        acc_b += len(chunk)
                        acc_p += np_c
                        while ti2 < len(targets) and acc_p >= targets[ti2]:
                            acc_p -= targets[ti2]
                            merged.append(acc_b)
                            acc_b = 0
                            ti2 += 1
                    if acc_b:
                        merged.append(acc_b)
                    seg_lists.append(merged)
                else:
                    seg_lists.append([])

        if not refs:
            return
        n = len(refs)
        maxlen = max(lens)
        data = np.zeros((n, max(maxlen, 1)), dtype=np.uint8)
        for i, d in enumerate(datas):
            data[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        styles = np.array(
            [tcp.tccps[r.comp].cblk_style & 0x3F for r in refs], dtype=np.int32
        )
        max_segs0 = max((len(sl) for sl in seg_lists), default=0)
        seg_arr0 = None
        if max_segs0:
            seg_arr0 = np.zeros((n, max(max_segs0, 1)), dtype=np.int64)
            for i2, sl in enumerate(seg_lists):
                if sl:
                    seg_arr0[i2, : len(sl)] = sl
        if tcp.tccps[0].cblk_style & 0x40:
            from ..t1 import ht as t1

            coeffs, planes = t1.decode_cblks(
                data,
                np.array(lens, dtype=np.int64),
                np.array(nbps, dtype=np.int64),
                np.array(nps, dtype=np.int64),
                np.array(hs, dtype=np.int64),
                np.array(ws, dtype=np.int64),
                np.array(ors, dtype=np.int64),
                cbh,
                cbw,
                seg_lengths=seg_arr0,
            )
        else:
            t1 = select_backend()
            _check_styles_supported(styles, t1)
            seg_arr = seg_arr0
            coeffs, planes = t1.decode_cblks(
                data,
                np.array(lens, dtype=np.int64),
                np.array(nbps, dtype=np.int64),
                np.array(nps, dtype=np.int64),
                np.array(hs, dtype=np.int64),
                np.array(ws, dtype=np.int64),
                np.array(ors, dtype=np.int64),
                cbh,
                cbw,
                styles=styles,
                seg_lengths=seg_arr,
            )
        coeffs = coeffs.astype(np.int32)
        for i, ref in enumerate(refs):
            g = self.geoms[ref.comp]
            band = g.resolutions[ref.res].bands[ref.band_i]
            cg = band.precincts[ref.prec].cblks[ref.cblk_i]
            oy, ox = _band_origin_in_packed(g, ref.res, band.orient)
            y0 = cg.rect.y0 - band.rect.y0 + oy
            x0 = cg.rect.x0 - band.rect.x0 + ox
            staging[ref.comp][
                y0 : y0 + cg.rect.height, x0 : x0 + cg.rect.width
            ] = coeffs[i, : cg.rect.height, : cg.rect.width]


    def decompress(
        self, body: memoryview, max_layers: int = 0, reduce: int = 0,
        packed_headers: bytes | None = None, window: Rect | None = None,
        plt: list[int] | None = None, staging_only: bool = False,
    ):
        """Decode a tile body into per-component arrays.

        ``reduce`` discards that many highest resolution levels (the
        cp_reduce fast path: high-res codeblocks are never entropy-decoded,
        the inverse DWT runs fewer levels).

        ``window`` (full-resolution reference-grid coords) restricts the
        decode to a sub-tile region: only codeblocks inside the per-level
        filter supports are entropy-decoded and the inverse DWT runs
        windowed with FILTER_WIDTH halos (parity:
        T1DecompressScheduler.cpp:47 + WaveletReverse.cpp:1890). With a
        window the return value is (arrays, rects) where rects give each
        array's origin in reduced component coordinates."""
        siz, tcp = self.siz, self.tcp
        ncomp = siz.num_comps
        irrev = tcp.tccps[0].irreversible

        # quantization info
        for c in range(ncomp):
            apply_band_quant(self.geoms[c], tcp.tccps[c], self._comp_prec(c))

        # ---- T2: parse packets
        use_sop = bool(tcp.csty & 0x02)
        use_eph = bool(tcp.csty & 0x04)
        import os

        from ..t2 import native_t2

        lib = native_t2.get_lib() if os.environ.get(
            "GROK_TPU_NATIVE_OPS", "1") != "0" else None

        cbh, cbw = self._nominal_cblk()
        sparse_win = window is not None and lib is not None
        coeff_arrays = []
        for c2, g in enumerate(self.geoms):
            top = max(g.num_resolutions - 1 - reduce, 0)
            rr = g.resolutions[top].rect
            dt = np.float32 if irrev else np.int32
            if sparse_win:
                # windowed decode: chunk-allocated sparse canvas (reference
                # SparseCanvas parity) — only touched regions materialize
                from .sparse import SparseCanvas

                coeff_arrays.append(SparseCanvas((rr.height, rr.width), dt))
            else:
                # np.empty on the flat path: the packed canvas is exactly
                # tiled by band rects, each tiled by its codeblock grid,
                # and the flat scatter writes every selected block
                # (missing/truncated blocks scatter the decoder's zero
                # plane), so every element is covered. The object path
                # writes only blocks that carried packet data -> zeros.
                alloc = np.empty if lib is not None else np.zeros
                coeff_arrays.append(alloc((rr.height, rr.width), dtype=dt))
        # fused scatter+dequant: decoded blocks land directly in the float
        # plane at their band step (no int32 staging pass); falls back when
        # ROI/window/object paths need the staged integers
        from ..ops import jax_pipeline

        import os as _os

        fused_deq = (
            irrev
            and lib is not None
            and window is None
            and not staging_only
            and not jax_pipeline.device_enabled()
            # opt-in: on this host the memcpy scatter + vectorized dequant
            # pass is as fast as the fused scalar loop; other memory systems
            # may prefer the single-pass variant
            and _os.environ.get("GROK_TPU_FUSED_DEQ", "0") == "1"
            and all(t.roi_shift == 0 for t in tcp.tccps)
        )
        if sparse_win:
            from .sparse import SparseCanvas

            staging = (
                coeff_arrays if not irrev
                else [SparseCanvas(a.shape, np.int32) for a in coeff_arrays]
            )
        else:
            staging = (
                coeff_arrays
                if not irrev or fused_deq
                else [(np.empty if lib is not None else np.zeros)(
                    a.shape, dtype=np.int32) for a in coeff_arrays]
            )

        comp_windows = None
        if window is not None:
            comp_windows = []
            for c in range(ncomp):
                sc = siz.comps[c]
                wc = window.ceil_div(sc.dx, sc.dy).ceil_div_pow2(reduce)
                comp_windows.append(wc)

        if lib is not None:
            self._decompress_t1_flat(
                lib, body, max_layers, reduce, packed_headers, use_sop,
                use_eph, cbh, cbw, staging, comp_windows,
                fused_deq=fused_deq, plt=plt,
            )
        else:
            self._decompress_t1_objects(
                body, max_layers, reduce, packed_headers, use_sop, use_eph,
                cbh, cbw, staging,
            )

        if staging_only:
            # distributed decode hook: hand the raw int32 staging planes
            # (post-T1, pre-ROI/dequant/inverse-DWT) to the caller — the
            # mesh-sharded inverse chain (parallel/distributed.py) runs
            # the exact same device program build_inverse would
            return [np.ascontiguousarray(s, dtype=np.int32) for s in staging]

        # ---- device-resident inverse chain (GROK_TPU_DEVICE=jax)
        if jax_pipeline.device_enabled():
            key = ("_dev_inv", reduce)
            inv = getattr(self, "_dev_inv_cache", {}).get(reduce)
            if inv is None:
                inv = jax_pipeline.build_inverse(
                    self.geoms, tcp.tccps, siz.comps, tcp.mct, reduce,
                    mct_dec_matrix=tcp.mct_dec_matrix,
                    mct_offsets=tcp.mct_offsets,
                )
                if not hasattr(self, "_dev_inv_cache"):
                    self._dev_inv_cache = {}
                self._dev_inv_cache[reduce] = inv
            with trace.span("dec.device_inv"), trace.device_trace():
                dev_out = inv(*[
                    np.ascontiguousarray(s, dtype=np.int32) for s in staging
                ])
                return [np.asarray(x) for x in dev_out]

        from ..ops import native_ops

        _t_deq = _time.perf_counter() if trace.enabled() else 0.0
        for c2 in range(ncomp):
            tccp2 = tcp.tccps[c2]
            if not isinstance(staging[c2], np.ndarray):
                # sparse canvas (windowed decode): chunk-wise ROI/dequant
                canvas = staging[c2]
                if tccp2.roi_shift and not getattr(self, "_roi_in_t1",
                                                   False):
                    sh = tccp2.roi_shift
                    th = np.int32(1) << sh

                    def _roi(v, sh=sh, th=th):
                        mag = np.abs(v)
                        mag = np.where(mag >= th, mag >> sh, mag)
                        return np.where(v < 0, -mag, mag)

                    canvas.apply(0, canvas.shape[0], 0, canvas.shape[1], _roi)
                if irrev:
                    g2 = self.geoms[c2]
                    top2 = max(g2.num_resolutions - 1 - reduce, 0)
                    fc = canvas.astype_canvas(np.float32)
                    for res2 in g2.resolutions[: top2 + 1]:
                        for band2 in res2.bands:
                            oy2, ox2 = _band_origin_in_packed(
                                g2, res2.r, band2.orient)
                            st2 = np.float32(band2.step)

                            def _deq(v, st2=st2):
                                mag2 = np.abs(v)
                                rec2 = np.where(
                                    mag2 > 0,
                                    (mag2 + np.float32(0.5)) * st2,
                                    np.float32(0.0))
                                return np.where(v < 0, -rec2, rec2)

                            fc.apply(oy2, oy2 + band2.rect.height,
                                     ox2, ox2 + band2.rect.width, _deq)
                    coeff_arrays[c2] = fc
                else:
                    coeff_arrays[c2] = canvas
                continue
            if tccp2.roi_shift and not getattr(self, "_roi_in_t1", False):
                a2 = np.ascontiguousarray(staging[c2], dtype=np.int32)
                if native_ops.roi_unshift(a2, tccp2.roi_shift) is not None:
                    staging[c2] = a2 if irrev else a2.astype(
                        staging[c2].dtype, copy=False
                    )
                else:
                    a2 = staging[c2]
                    mag = np.abs(a2)
                    thresh = np.int32(1) << tccp2.roi_shift
                    mag = np.where(
                        mag >= thresh, mag >> tccp2.roi_shift, mag
                    )
                    staging[c2] = np.where(a2 < 0, -mag, mag).astype(
                        a2.dtype if not irrev else np.int32
                    )
            if irrev and not fused_deq:
                g2 = self.geoms[c2]
                a2 = staging[c2]
                out2 = coeff_arrays[c2]
                top = max(g2.num_resolutions - 1 - reduce, 0)
                bands2 = [
                    (*_band_origin_in_packed(g2, res2.r, band2.orient),
                     band2.rect.height, band2.rect.width, band2.step)
                    for res2 in g2.resolutions[: top + 1]
                    for band2 in res2.bands
                ]
                deq = native_ops.dequant_bands(
                    np.ascontiguousarray(a2, dtype=np.int32), bands2
                )
                if deq is not None:
                    coeff_arrays[c2] = deq
                else:
                    for (oy2, ox2, bh2, bw2, step2) in bands2:
                        sl2 = (slice(oy2, oy2 + bh2),
                               slice(ox2, ox2 + bw2))
                        q2 = a2[sl2].astype(np.float32)
                        mag2 = np.abs(q2)
                        rec2 = np.where(
                            mag2 > 0,
                            (mag2 + np.float32(0.5)) * np.float32(step2),
                            np.float32(0.0),
                        )
                        out2[sl2] = np.where(q2 < 0, -rec2, rec2)

        if trace.enabled():
            trace.add("dec.dequant_roi", _time.perf_counter() - _t_deq,
                      bytes_moved=2 * sum(
                          getattr(a, "nbytes", 0) for a in coeff_arrays))

        # ---- inverse DWT (fewer levels under resolution reduction;
        # windowed with filter halos when a sub-tile region was requested)
        out = []
        out_rects = []
        with trace.span("dec.idwt", bytes_moved=4 * sum(
                getattr(a, "nbytes", 0) for a in coeff_arrays)):
            for c in range(ncomp):
                g = self.geoms[c]
                nl = max(self.tcp.tccps[c].num_resolutions - 1 - reduce, 0)
                rect = g.rect.ceil_div_pow2(reduce) if reduce else g.rect
                if comp_windows is not None:
                    rec, orect = dwt_ops.inverse_window(
                        np, coeff_arrays[c], rect, nl, irrev, comp_windows[c]
                    )
                    rec = np.ascontiguousarray(rec)
                    out_rects.append(orect)
                else:
                    rec = dwt_ops.inverse(np, coeff_arrays[c], rect, nl,
                                          irrev)
                    out_rects.append(rect)
                out.append(rec)

        # ---- inverse MCT + DC shift (+ final conversion, fused natively
        # when the first three components share precision/signedness)
        _t_fin = _time.perf_counter() if trace.enabled() else 0.0
        from ..ops.native_ops import get_lib as _gl2

        _fuse_lib = _gl2()
        if (
            _fuse_lib is not None
            and tcp.mct == 1
            and ncomp == 3
            and out[0].shape == out[1].shape == out[2].shape
            and all(o.flags.c_contiguous for o in out[:3])
            and len({(siz.comps[c].prec, siz.comps[c].signed)
                     for c in range(3)}) == 1
            and (out[0].dtype == np.float32 if irrev
                 else out[0].dtype == np.int32)
        ):
            prec0 = siz.comps[0].prec
            signed0 = siz.comps[0].signed
            lo = -(1 << (prec0 - 1)) if signed0 else 0
            hi = (1 << (prec0 - 1)) - 1 if signed0 else (1 << prec0) - 1
            nel = out[0].size
            res3 = [np.empty(out[0].shape, dtype=np.int32) for _ in range(3)]
            if irrev:
                addf = np.float32(0.5 + (0.0 if signed0 else float(1 << (prec0 - 1))))
                _fuse_lib.ict_finish(out[0], out[1], out[2],
                                     res3[0], res3[1], res3[2], nel,
                                     addf, lo, hi, 0)
            else:
                add = 0 if signed0 else 1 << (prec0 - 1)
                _fuse_lib.rct_finish(out[0], out[1], out[2],
                                     res3[0], res3[1], res3[2], nel,
                                     add, lo, hi, 0)
            if trace.enabled():
                trace.add("dec.mct_finish", _time.perf_counter() - _t_fin,
                          bytes_moved=2 * sum(a.nbytes for a in res3))
            if window is not None:
                return res3, out_rects
            return res3

        if tcp.mct == 2 and tcp.mct_dec_matrix is not None:
            dec_m = np.asarray(tcp.mct_dec_matrix, dtype=np.float32)
            out = mct_ops.custom_mct_inverse(
                np, [a.astype(np.float32) for a in out], dec_m
            )
        elif tcp.mct == 1 and ncomp >= 3:
            from ..ops.native_ops import get_lib as _get_native

            _nlib = _get_native()
            fused = (
                _nlib is not None
                and out[0].shape == out[1].shape == out[2].shape
                and all(o.flags.c_contiguous for o in out[:3])
                and (out[0].dtype == np.float32 if irrev
                     else out[0].dtype == np.int32)
            )
            if fused:
                # in place: the kernels are read-then-write per element
                nel = out[0].size
                if irrev:
                    _nlib.ict_inverse_c(out[0], out[1], out[2],
                                        out[0], out[1], out[2], nel, 0)
                else:
                    _nlib.rct_inverse_c(out[0], out[1], out[2],
                                        out[0], out[1], out[2], nel, 0)
            elif irrev:
                r, gg, b = mct_ops.ict_inverse(np, out[0], out[1], out[2])
                out[0], out[1], out[2] = r, gg, b
            else:
                r, gg, b = mct_ops.rct_inverse(np, out[0], out[1], out[2])
                out[0], out[1], out[2] = r, gg, b
        from ..ops import native_ops

        final = []
        for c in range(ncomp):
            a = out[c]
            prec2 = siz.comps[c].prec
            signed2 = siz.comps[c].signed
            if irrev:
                off = 0.0 if signed2 else float(1 << (prec2 - 1))
                if tcp.mct == 2 and tcp.mct_offsets is not None:
                    off = float(tcp.mct_offsets[c])
                lo = -(1 << (prec2 - 1)) if signed2 else 0
                hi = (1 << (prec2 - 1)) - 1 if signed2 else (1 << prec2) - 1
                fused = native_ops.finish_irrev(
                    np.ascontiguousarray(a, dtype=np.float32), off, lo, hi,
                    in_place=True,
                )
                if fused is not None:
                    a = fused
                else:
                    a = np.clip(
                        np.floor(a + np.float32(0.5 + off)), lo, hi
                    ).astype(np.int32)
            else:
                add = 0 if signed2 else 1 << (prec2 - 1)
                lo = -(1 << (prec2 - 1)) if signed2 else 0
                hi = (1 << (prec2 - 1)) - 1 if signed2 else (1 << prec2) - 1
                fused = None
                if a.dtype == np.int32:
                    fused = native_ops.finish_rev(
                        np.ascontiguousarray(a), add, lo, hi, in_place=True
                    )
                if fused is not None:
                    a = fused
                else:
                    a = mct_ops.dc_shift_inverse(np, a, prec2, signed2)
                    a = a.astype(np.int32, copy=False)
            final.append(a)
        if trace.enabled():
            trace.add("dec.mct_finish", _time.perf_counter() - _t_fin,
                      bytes_moved=2 * sum(a.nbytes for a in final))
        if window is not None:
            return final, out_rects
        return final
