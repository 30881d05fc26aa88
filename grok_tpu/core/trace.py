"""Stage tracing + roofline accounting for the codec pipeline.

The reference has no in-library tracer (profiling is external massif /
wall-clock timing — SURVEY §5); here the hot-loop accounting is
first-class: every pipeline stage records wall time and the bytes it must
move, so a report can show achieved GB/s against the host's measured copy
bandwidth.

Usage:
    GROK_TPU_TRACE=1            enable span collection (near-zero overhead
                                when disabled: one dict lookup per span)
    GROK_TPU_TRACE_JAX=<dir>    additionally wrap device work in a
                                jax.profiler trace written to <dir>
                                (view with tensorboard / xprof)

    from grok_tpu.core import trace
    with trace.span("t1.decode", bytes_moved=nbytes):
        ...
    trace.report()   # per-stage table; returns the rows

Thread-safe: spans aggregate under a lock keyed by stage name; nested
spans are fine (each records its own wall time).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def enabled() -> bool:
    return os.environ.get("GROK_TPU_TRACE", "0") not in ("0", "")


@dataclass
class _Agg:
    calls: int = 0
    seconds: float = 0.0
    bytes_moved: int = 0
    flops: int = 0


_LOCK = threading.Lock()
_SPANS: dict[str, _Agg] = {}
# measured once on first report; ~streaming memcpy bandwidth of this host
_HOST_BW: float | None = None


@contextmanager
def span(name: str, bytes_moved: int = 0, flops: int = 0):
    """Record one timed span. ``bytes_moved`` is the stage's minimum
    memory traffic (reads+writes) for roofline accounting; ``flops``
    likewise for compute-bound stages."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            agg = _SPANS.setdefault(name, _Agg())
            agg.calls += 1
            agg.seconds += dt
            agg.bytes_moved += bytes_moved
            agg.flops += flops


@contextmanager
def device_trace():
    """jax.profiler trace around device work when GROK_TPU_TRACE_JAX=<dir>
    is set (produces an xprof/tensorboard trace of the XLA execution)."""
    d = os.environ.get("GROK_TPU_TRACE_JAX", "")
    if not d:
        yield
        return
    import jax

    with jax.profiler.trace(d):
        yield


def add(name: str, seconds: float, bytes_moved: int = 0, flops: int = 0):
    """Record an externally-timed span (e.g. native-call internal timing)."""
    if not enabled():
        return
    with _LOCK:
        agg = _SPANS.setdefault(name, _Agg())
        agg.calls += 1
        agg.seconds += seconds
        agg.bytes_moved += bytes_moved
        agg.flops += flops


def reset():
    with _LOCK:
        _SPANS.clear()


def host_bandwidth() -> float:
    """Measured streaming copy bandwidth of this host in bytes/s (the
    roofline ceiling for memory-bound host stages). Cached."""
    global _HOST_BW
    if _HOST_BW is None:
        import numpy as np

        a = np.empty(1 << 25, dtype=np.uint8)  # 32 MB, beyond LLC
        a[::4096] = 1  # fault pages in
        b = np.empty_like(a)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            np.copyto(b, a)
            best = min(best, time.perf_counter() - t0)
        _HOST_BW = 2 * a.nbytes / best  # read + write
    return _HOST_BW


def rows() -> list[dict]:
    with _LOCK:
        items = sorted(_SPANS.items(), key=lambda kv: -kv[1].seconds)
    out = []
    for name, a in items:
        r = {
            "stage": name,
            "calls": a.calls,
            "ms": a.seconds * 1e3,
            "bytes": a.bytes_moved,
        }
        if a.bytes_moved and a.seconds > 0:
            r["gbps"] = a.bytes_moved / a.seconds / 1e9
        if a.flops and a.seconds > 0:
            r["gflops"] = a.flops / a.seconds / 1e9
        out.append(r)
    return out


def report(file=None) -> list[dict]:
    """Print the per-stage table with roofline utilization (fraction of
    the measured host copy bandwidth for stages that declared traffic)."""
    import sys

    f = file or sys.stderr
    rs = rows()
    if not rs:
        return rs
    bw = host_bandwidth()
    total = sum(r["ms"] for r in rs)
    print(f"-- grok_tpu trace (host copy BW {bw / 1e9:.1f} GB/s) --", file=f)
    print(f"{'stage':<28}{'calls':>6}{'ms':>10}{'GB/s':>8}{'roofline':>9}",
          file=f)
    for r in rs:
        gbps = r.get("gbps")
        util = f"{gbps * 1e9 / bw * 100:.0f}%" if gbps else ""
        print(
            f"{r['stage']:<28}{r['calls']:>6}{r['ms']:>10.1f}"
            f"{gbps if gbps else 0:>8.1f}{util:>9}",
            file=f,
        )
    print(f"{'total':<28}{'':>6}{total:>10.1f}", file=f)
    return rs
