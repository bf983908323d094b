"""The padded-layout Laplacian: applies that chain with no pad or slice.

The port of the JAX package's fixed-point padded stencil
(``ops/pallas_stencil.py``: ``padded_layout`` :485, ``to_padded``,
``from_padded``, ``laplacian_pallas_padded`` :580, with its kernels
``_kernel_padded`` :546 and ``_kernel_padded_mxu`` :429). An (R, W) padded
field goes in and an (R, W) padded field comes out, its pads zero, so the
output of one apply is the input of the next.

The layout is the port's own: the (nx, nz) field sits at rows [h, h + nx)
and columns [h, h + nz) of R = nx + 2h rows of W columns, h = order/2, zero
elsewhere. The row pitch W is nz + 2h rounded up to a multiple of 4 floats:
every row then starts 16-byte aligned, as the kernels' ``cp.async`` copies
of 16 bytes need, for the least padding. The TPU layout's 128-lane width,
``tile_rows`` and 8-row halo granularity are not copied.

| kernel | source | replaces (JAX package, ``ops/pallas_stencil.py``) |
|---|---|---|
| ``lap_padded`` | ``csrc/lap_padded.cu`` | ``_kernel_padded`` (:546), ``impl="vpu"`` |
| ``lap_padded_mma`` | ``csrc/lap_padded.cu`` | ``_kernel_padded_mxu`` (:429), ``impl="mxu"``/``"mxu6"`` |

:func:`laplacian_padded_cuda` routes by the device of its input: CPU
tensors go to the plain :func:`laplacian_padded`, CUDA tensors to the
kernels, with no fallback. ``LAUNCHES`` counts each kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import stencil
from .fd_kernels import _check_order, _on_cuda, _raise_on, _stream

__all__ = ["LAUNCHES", "reset_launches", "IMPLS", "padded_layout",
           "to_padded", "from_padded", "laplacian_padded",
           "laplacian_padded_cuda"]

LAUNCHES = {"lap_padded": 0, "lap_padded_mma": 0}
# impl -> bf16 parts of the z taps' banded product (0: the exact taps)
IMPLS = {"vpu": 0, "mxu": 2, "mxu6": 3}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def padded_layout(nx: int, nz: int, order: int):
    """``(R, W, row0, col0)`` of the padded layout of an (nx, nz) field: the
    field lives at ``[row0, row0 + nx) x [col0, col0 + nz)`` of an (R, W)
    array, R = nx + 2h, W = nz + 2h rounded up to a multiple of 4."""
    h = order // 2
    return nx + 2 * h, -(-(nz + 2 * h) // 4) * 4, h, h


def to_padded(p, order: int):
    """Embed an (nx, nz) field into its padded layout (a new tensor)."""
    nx, nz = p.shape
    R, W, r0, c0 = padded_layout(nx, nz, order)
    out = p.new_zeros((R, W))
    out[r0:r0 + nx, c0:c0 + nz] = p
    return out


def from_padded(p_pad, nx: int, nz: int, order: int):
    """The (nx, nz) field of a padded array (a view)."""
    _, _, r0, c0 = padded_layout(nx, nz, order)
    return p_pad[r0:r0 + nx, c0:c0 + nz]


def laplacian_padded(p_pad, coefs_x, coefs_z, order: int, nx: int, nz: int,
                     impl: str = "vpu"):
    """The plain version: ``to_padded(lap(from_padded(p_pad)))``, with
    ``lap`` the exact :func:`.stencil.laplacian` (``impl="vpu"``) or
    :func:`.stencil.laplacian_mxu` with the z taps as the banded product in
    2 (``"mxu"``) or 3 (``"mxu6"``) bf16 parts and the x taps exact,
    ``yz + accx``."""
    parts = _check_impl(impl)
    f = from_padded(p_pad, nx, nz, order)
    if parts:
        lap = stencil.laplacian_mxu(f, coefs_x, coefs_z, order, parts,
                                    axis="z")
    else:
        lap = stencil.laplacian(f, coefs_x, coefs_z, order)
    return to_padded(lap, order)


def _check_impl(impl: str) -> int:
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'vpu', 'mxu' or 'mxu6', got "
                         f"{impl!r}")
    return IMPLS[impl]


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * 4 and b0 < a0 + a.numel() * 4


def laplacian_padded_cuda(p_pad, coefs_x, coefs_z, order: int, nx: int,
                          nz: int, impl: str = "vpu", out=None):
    """One apply of the order-``order`` interior Laplacian on the padded
    layout: the counterpart of ``laplacian_pallas_padded``. ``lap_padded``
    (``impl="vpu"``, the exact taps) or ``lap_padded_mma`` (``"mxu"``,
    ``"mxu6"``: the z taps on the tensor cores) on the card; the plain
    :func:`laplacian_padded` on the CPU. Writes into ``out`` when given (an
    (R, W) float32 tensor that shares no memory with ``p_pad``), so that a
    chain of applies runs on two buffers with no allocation per apply.
    Returns the (R, W) result."""
    parts = _check_impl(impl)
    on_cuda = _on_cuda(p_pad)
    _check_order(order, on_cuda)
    R, W, _, _ = padded_layout(nx, nz, order)
    if nx <= order or nz <= order:
        raise ValueError(f"field {nx}x{nz} has no interior at order {order}")
    for name, t in (("p_pad", p_pad), ("out", out)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (R, W):
            raise ValueError(f"{name} must be a float32 ({R}, {W}) tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != p_pad.device:
            raise ValueError(f"{name} must be contiguous and on "
                             f"{p_pad.device}")
        if on_cuda and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    if out is not None and _overlap(out, p_pad):
        raise ValueError("out shares memory with p_pad: the apply reads "
                         "its input while it writes its output")
    cx = np.ascontiguousarray(coefs_x, np.float32)
    cz = np.ascontiguousarray(coefs_z, np.float32)
    if cx.shape != (order + 1,) or cz.shape != (order + 1,):
        raise ValueError(f"coefficients must be ({order + 1},) arrays")
    if not on_cuda:
        res = laplacian_padded(p_pad, cx, cz, order, nx, nz, impl)
        return res if out is None else out.copy_(res)
    from . import _build
    if out is None:
        out = torch.empty_like(p_pad)
    with torch.cuda.device(p_pad.device):
        rc = _build.library().pfdc_lap_padded_run(
            p_pad.data_ptr(), out.data_ptr(), R, W, nx, nz, order, parts,
            cx.ctypes.data, cz.ctypes.data, _stream(p_pad.device))
    name = "lap_padded_mma" if parts else "lap_padded"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
