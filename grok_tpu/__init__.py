"""grok_tpu — a JPEG 2000 / HTJ2K engine in JAX/XLA.

Brand-new implementation with the capabilities of the Grok codec
(reference: /root/reference, Grok 9.2.0): Part-1 EBCOT/MQ and HTJ2K block
coding, 5/3 + 9/7 lifting DWT, full Tier-2, profiles, windowed decode and
random access — re-architected for accelerators: batched lane-parallel
entropy coding, array-level lifting kernels, mesh-sharded tiles.

Public API (capability parity with grok.h's ~50 GRK_API functions, in
idiomatic Python):

    import grok_tpu as gk
    stream = gk.compress(image, gk.CompressParams(...))
    image = gk.decompress(stream, gk.DecompressParams(...))
"""

from .core.compile_cache import configure as _configure_compile_cache
from .core.cpu import tune_malloc as _tune_malloc

_configure_compile_cache()  # before any device program is compiled
_tune_malloc()  # arena reuse for per-frame plane allocations (see cpu.py)

from .core.image import Component, Image
from .core.params import (
    CompressParams,
    DecompressParams,
    ProgressionOrder,
    ColorSpace,
    QuantStyle,
)
from .core.logging import set_error_handler, set_info_handler, set_warning_handler
from .codestream.compress import TileEncoder, compress
from .codestream.decompress import Decoder, decompress, parse_codestream
from .codestream.stripe import StripCompressor

__version__ = "0.1.0"

__all__ = [
    "Component",
    "Image",
    "CompressParams",
    "DecompressParams",
    "ProgressionOrder",
    "ColorSpace",
    "QuantStyle",
    "compress",
    "TileEncoder",
    "StripCompressor",
    "Decoder",
    "decompress",
    "parse_codestream",
    "set_error_handler",
    "set_info_handler",
    "set_warning_handler",
]
