"""Multi-component transforms + DC level shift (T.800 Annex G).

Parity target: point_transform/mct.{h,cpp} (compress/decompress_{rev,irrev},
dc shift fused variants) — elementwise device kernels XLA fuses into the
surrounding DWT/quantization work.

Works with numpy or jax.numpy as ``xp``.
"""

from __future__ import annotations

import numpy as np

# ICT (irreversible component transform) coefficients, T.800 G-1/G-2.
_ICT_FWD = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float64,
)
_ICT_INV = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136, -0.714136],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float64,
)


def rct_forward(xp, r, g, b):
    """Reversible color transform (int32, exact)."""
    y = (r + 2 * g + b) >> 2
    cb = b - g
    cr = r - g
    return y, cb, cr


def rct_inverse(xp, y, cb, cr):
    g = y - ((cb + cr) >> 2)
    r = cr + g
    b = cb + g
    return r, g, b


def ict_forward(xp, r, g, b, dtype=np.float32):
    m = _ICT_FWD.astype(dtype)
    y = m[0, 0] * r + m[0, 1] * g + m[0, 2] * b
    cb = m[1, 0] * r + m[1, 1] * g + m[1, 2] * b
    cr = m[2, 0] * r + m[2, 1] * g + m[2, 2] * b
    return y, cb, cr


def ict_inverse(xp, y, cb, cr, dtype=np.float32):
    m = _ICT_INV.astype(dtype)
    r = y + m[0, 2] * cr
    g = y + m[1, 1] * cb + m[1, 2] * cr
    b = y + m[2, 1] * cb
    return r, g, b


def dc_shift_forward(xp, x, prec: int, signed: bool):
    """Center unsigned data about zero before the transform."""
    if signed:
        return x
    return x - (1 << (prec - 1))


def dc_shift_inverse(xp, x, prec: int, signed: bool, clip: bool = True):
    """Undo the DC shift and clamp to the component's legal range."""
    if not signed:
        x = x + (1 << (prec - 1))
        lo, hi = 0, (1 << prec) - 1
    else:
        lo, hi = -(1 << (prec - 1)), (1 << (prec - 1)) - 1
    if clip:
        x = xp.clip(x, lo, hi)
    return x


def custom_mct_forward(xp, comps, matrix):
    """Part-2 custom matrix MCT: comps is a list of float32 arrays, matrix
    [N, N]. out[i] = sum_j matrix[i, j] * comps[j], summed in j order with
    every product rounded to float32, like the ICT above: no matrix unit
    and no reduced-precision matmul, so host and device round alike."""
    m = np.asarray(matrix, dtype=np.float32)
    out = []
    for i in range(len(comps)):
        acc = m[i, 0] * comps[0]
        for j in range(1, len(comps)):
            acc = acc + m[i, j] * comps[j]
        out.append(acc)
    return out


def custom_mct_inverse(xp, comps, matrix_inv):
    return custom_mct_forward(xp, comps, matrix_inv)
