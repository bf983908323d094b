"""The split-bf16 banded product: one axis's Laplacian taps as the JAX
package's multi-pass bf16 matrix-unit tiers compute them, in float32 torch.

The JAX package's ``lap_impl="mxu"``/``"mxu6"`` tiers (``ops/pallas_fd.py``
``_make_lap`` :260-334, ``ops/pallas_stencil.py`` ``_kernel_padded_mxu``
:429) put one axis's taps on the TPU's matrix unit as a banded product in
manual multi-pass bfloat16 precision: the field is split into ``parts``
bf16 residuals (``split_lhs`` :311), the band of coefficients likewise
(``split_stack`` :257), and every cross term ``a_i @ S_j`` with ``i + j <
parts`` is formed in float32 (3 terms for parts = 2, 6 for parts = 3), then
summed in a fixed order (``mm3`` :335, ``mm_banded`` :346). These are the
plain versions of the CUDA ``mma`` kernels that do the same on Hopper's
tensor cores (``csrc/mma_bf16.cuh``).

Every product of two bf16 values is exact in float32, so the cross terms
differ from the JAX package's only in the order of their float32 sums. The
TPU's 128-lane band blocks and their first/middle/last windows
(``band_matrices`` :230) are layout: for a cell at least h from the edges
the banded product is the full (2h+1)-tap sum either way, so they are not
copied.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["round_bf16", "split", "split_coefs", "cross_terms",
           "combine", "banded_taps"]


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest bfloat16 value, ties to even,
    kept in float32: the JAX package's integer form ``_round_bf16_f32``
    (``pallas_stencil.py:288``) for every value that is not a NaN."""
    return t.to(torch.bfloat16).to(torch.float32)


def split(a: torch.Tensor, parts: int):
    """``parts`` bf16 residual splits of a float32 tensor, hi first, each
    held in float32 (``split_lhs``, ``pallas_stencil.py:311``): ``a_0 =
    bf16(a)``, ``a_1 = bf16(a - a_0)``, ..., each residual formed in
    float32."""
    out, r = [], a
    for _ in range(parts):
        hi = round_bf16(r)
        out.append(hi)
        r = r - hi
    return out


def split_coefs(c, parts: int):
    """The ``parts`` bf16 splits of each coefficient of ``c`` (numpy
    float32), as lists of python floats: ``split_stack``
    (``pallas_stencil.py:257``) applied to a band whose entries are the
    coefficients is this split, coefficient by coefficient."""
    t = torch.from_numpy(np.ascontiguousarray(c, np.float32))
    return [[float(v) for v in s] for s in split(t, parts)]


def cross_terms(parts: int):
    """The (i, j) pairs of ``a_i @ S_j`` the ``parts``-pass product forms,
    in the order :func:`combine` adds them (``mm3`` for parts = 2:
    ``(a0 S0 + a0 S1) + a1 S0``; ``mm_banded`` for parts >= 3: ascending
    magnitude, the deepest split level first)."""
    if parts == 2:
        return [(0, 0), (0, 1), (1, 0)]
    order = []
    for lvl in range(parts - 1, -1, -1):
        for i in range(min(lvl, parts - 1), -1, -1):
            if lvl - i < parts - i:
                order.append((i, lvl - i))
    return order


def combine(terms: dict, parts: int):
    """Sum the cross terms ``terms[(i, j)]`` in the JAX package's order."""
    acc = None
    for key in cross_terms(parts):
        acc = terms[key] if acc is None else acc + terms[key]
    return acc


def banded_taps(a: torch.Tensor, c, h: int, axis: int, parts: int):
    """The banded product of ``a`` with the (2h+1,) coefficients ``c``
    along ``axis``, centre tap included, in ``parts``-pass split bf16: for
    each cell at least h from both ends of the axis, ``sum_d c[h+d] *
    a[x+d]`` with both operands split. Returns the interior along
    ``axis`` (its length less 2h), the other axes whole.

    Each cross term ``a_i . S_j`` is its own float32 sum over the taps in
    ascending offset d = -h..h (every product exact); the terms are then
    combined in the JAX package's order (:func:`combine`)."""
    axis = axis % a.dim()
    n = a.shape[axis]
    a_s = split(a, parts)
    s = split_coefs(c, parts)
    terms = {}
    for i, j in cross_terms(parts):
        acc = None
        for d in range(-h, h + 1):
            t = s[j][h + d] * a_s[i].narrow(axis, h + d, n - 2 * h)
            acc = t if acc is None else acc + t
        terms[i, j] = acc
    return combine(terms, parts)
