"""Tier-1 entropy coding backends.

- ebcot_np: lane-parallel numpy reference (bit-exact, used by tests)
- native:   C++ batched coder (fast host path; bit-identical to ebcot_np)
- ebcot_jax: device lockstep coder (plain jax.lax)
- ht-device: the HT cleanup coder on the device (t1/ht_jax.py,
  t1/ht_jax_dec.py); Part-1 styles stay on the host coder

select_backend() resolves the implementation: GROK_TPU_T1 env var
("native" | "numpy" | "jax" | "ht-device" | a registered name) or
native-if-available.

register_backend() is the pluggable-accelerator hook (capability parity
with the reference's T1 plugin framework, plugin/plugin_interface.h:134 +
plugin_bridge.cpp: an external module supplies the block coder while the
host keeps rate control and T2). A backend is any module/object exposing::

    encode_cblks(coeffs, heights, widths, orients, styles=None, ...)
    decode_cblks(data, lengths, numbps, npasses, heights, widths,
                 orients, block_h, block_w, styles=None, seg_lengths=None)
    SUPPORTED_STYLES  (int bitmask of T.800 Table A-19 style bits)
"""

from __future__ import annotations

import os

_REGISTRY: dict[str, object] = {}


def register_backend(name: str, module) -> None:
    """Register an external T1 implementation under ``name``; select it
    with GROK_TPU_T1=<name> or select_backend(<name>)."""
    for attr in ("encode_cblks", "decode_cblks"):
        if not hasattr(module, attr):
            raise TypeError(f"T1 backend {name!r} lacks {attr}()")
    _REGISTRY[name] = module


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def select_backend(name: str | None = None):
    """Returns a module exposing encode_cblks/decode_cblks.

    GROK_TPU_T1_DEBUG=1 wraps the selection in DebugVerifyBackend: every
    batch is bit-checked against the numpy reference coder (the analogue
    of the reference's GRK_PLUGIN_STATE_DEBUG plugin-vs-host mode)."""
    backend = _select(name)
    if os.environ.get("GROK_TPU_T1_DEBUG"):
        from . import ebcot_np
        from .debug import DebugVerifyBackend

        if backend is not ebcot_np and not isinstance(
                backend, DebugVerifyBackend):
            label = name or os.environ.get("GROK_TPU_T1", "auto")
            return DebugVerifyBackend(backend, label)
    return backend


def _select(name: str | None = None):
    name = name or os.environ.get("GROK_TPU_T1", "auto")
    if name not in _REGISTRY and os.environ.get("GROK_TPU_T1_PLUGIN"):
        from . import plugin

        plugin.autoload_from_env()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in ("native", "auto"):
        from . import native

        if native.available():
            return native
        if name == "native":
            raise RuntimeError("native T1 backend unavailable (no compiler?)")
    if name == "jax":
        from . import ebcot_jax

        return ebcot_jax
    if name == "ht-device":
        # device HT cleanup coder; Part-1 styles stay on the default host
        # coder, the HT path (ht.encode_cblks) routes to ht_jax
        from . import native

        if native.available():
            return native
        from . import ebcot_np

        return ebcot_np
    if name not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown T1 backend {name!r} "
                         f"(registered: {sorted(_REGISTRY)})")
    from . import ebcot_np

    return ebcot_np
