"""The reference's six device kernels K1-K6 as torch eager ops.

Counterparts of the JAX package's ``ops/stencil.py`` (the lax formulation of
``cuda_reference_RTM/src/fd-code.cu:53-144``). They are the arithmetic of
the plain versions in :mod:`..solver`, and they fix the rounding that the
CUDA step kernels in ``csrc/`` reproduce: every op is one eager torch op,
rounded on its own, in the JAX package's association order.

Conventions: wavefields are (..., nx, nz) float32 tensors where nx/nz are the
*extended* dims, z contiguous, the reference's ``p[ix][iz]`` flattening.
Leading dims are shots. Coefficients are length-(order+1) float32 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "laplacian_interior", "laplacian", "laplacian_mxu", "lap_interior_mask",
    "leapfrog", "apply_taper", "inject_point", "inject_gaussian",
    "receiver_x0", "inject_receivers", "imaging_correlation",
]


def laplacian_interior(p, coefs_x, coefs_z, order: int):
    """Order-``order`` Laplacian on the interior ``[h:nx-h, h:nz-h]`` with
    premultiplied coefficients, kernel K1 (``kernel_lap``,
    ``fd-code.cu:53-78``). Returns the (..., nx-order, nz-order) block.

    The association order is the JAX package's (``stencil.py:56-73``):
    one accumulator per axis, symmetric pairs ``c[h+k]*(m+p)`` in
    descending k, the centre tap last, then ``accz + accx``.
    """
    nx, nz = p.shape[-2:]
    h = order // 2
    cx = [float(v) for v in np.asarray(coefs_x, np.float32)]
    cz = [float(v) for v in np.asarray(coefs_z, np.float32)]
    c = p[..., h:nx - h, h:nz - h]
    accz = None
    for k in range(h, 0, -1):
        zm = p[..., h:nx - h, h - k:nz - h - k]
        zp = p[..., h:nx - h, h + k:nz - h + k]
        term = cz[h + k] * (zm + zp)
        accz = term if accz is None else accz + term
    accz = accz + cz[h] * c
    accx = None
    for k in range(h, 0, -1):
        xm = p[..., h - k:nx - h - k, h:nz - h]
        xp = p[..., h + k:nx - h + k, h:nz - h]
        term = cx[h + k] * (xm + xp)
        accx = term if accx is None else accx + term
    accx = accx + cx[h] * c
    return accz + accx


def laplacian(p, coefs_x, coefs_z, order: int):
    """Full-grid Laplacian with zero borders: the reference's ``d_laplace``
    buffer is never written outside the interior."""
    h = order // 2
    out = torch.zeros_like(p)
    out[..., h:p.shape[-2] - h, h:p.shape[-1] - h] = laplacian_interior(
        p, coefs_x, coefs_z, order)
    return out


def _axis_taps(p, c, order: int, axis: int):
    """One axis's exact taps over the interior, centre included: the
    ``accz`` (axis -1) or ``accx`` (axis -2) of :func:`laplacian_interior`,
    in its order."""
    h = order // 2
    c = [float(v) for v in np.asarray(c, np.float32)]
    n = p.shape[axis]
    other = -1 if axis == -2 else -2
    q = p.narrow(other, h, p.shape[other] - 2 * h)
    acc = None
    for k in range(h, 0, -1):
        term = c[h + k] * (q.narrow(axis, h - k, n - 2 * h)
                           + q.narrow(axis, h + k, n - 2 * h))
        acc = term if acc is None else acc + term
    return acc + c[h] * q.narrow(axis, h, n - 2 * h)


def laplacian_mxu(p, coefs_x, coefs_z, order: int, parts: int,
                  axis: str = "x"):
    """The interior Laplacian with one axis's taps as the ``parts``-pass
    split-bf16 banded product (:func:`.banded.banded_taps`, 2 parts: the
    JAX package's ``lap_impl="mxu"``, 3: ``"mxu6"``) and the other axis's
    taps exact, zero border of width order/2.

    ``axis="x"``: ``yx + accz``, the MXU branch of the JAX whole-shot
    kernels' ``_make_lap`` (``ops/pallas_fd.py:260-334``), the plain version
    of the ``*_step_mma`` kernels. ``axis="z"``: ``yz + accx``, the padded
    stencil's ``_kernel_padded_mxu`` (``ops/pallas_stencil.py:429``), the
    plain version of ``lap_padded_mma``."""
    from .banded import banded_taps
    h = order // 2
    nx, nz = p.shape[-2:]
    if axis == "x":
        banded = banded_taps(p[..., :, h:nz - h], coefs_x, h, -2, parts)
        exact = _axis_taps(p, coefs_z, order, -1)
    elif axis == "z":
        banded = banded_taps(p[..., h:nx - h, :], coefs_z, h, -1, parts)
        exact = _axis_taps(p, coefs_x, order, -2)
    else:
        raise ValueError(f"axis must be 'x' or 'z', got {axis!r}")
    out = torch.zeros_like(p)
    out[..., h:nx - h, h:nz - h] = banded + exact
    return out


def lap_interior_mask(nx: int, nz: int, order: int) -> np.ndarray:
    """(nx, nz) float32 numpy mask of the Laplacian interior
    ``[h:nx-h, h:nz-h]``."""
    h = order // 2
    m = np.zeros((nx, nz), np.float32)
    m[h:nx - h, h:nz - h] = 1.0
    return m


def leapfrog(p, pp, v2, lap, dt2: float):
    """Two-step leapfrog ``pp' = 2p - pp + (v2*dt2)*lap`` over the full grid,
    kernel K2 (``kernel_time``, ``fd-code.cu:80-92``). ``v2*dt2`` rounds
    first, as in the JAX package (``stencil.py:171``); the CUDA kernels take
    that product precomputed."""
    return 2.0 * p - pp + v2 * dt2 * lap


def apply_taper(field, mask):
    """Absorbing-taper multiply, kernel K3 (``kernel_tapper``,
    ``fd-code.cu:94-117``; ``taper_apply``/``taper_apply2``,
    ``taper.c:47-84``), as a precomputed full-grid mask."""
    return field * mask


def _fields(out, sx):
    """(field, sx) pairs: one (nx, nz) field and an int, or a (ns, nx, nz)
    stack and one source x per shot."""
    if out.dim() == 2:
        return [(out, int(sx))]
    sxs = [int(s) for s in np.atleast_1d(np.asarray(sx))]
    if len(sxs) == 1:
        sxs = sxs * out.shape[0]
    return list(zip(out, sxs))


def inject_point(pp, sx, sz: int, amp: float):
    """Single-cell source injection ``pp[sx, sz] += amp``, kernel K4
    (``kernel_src``, ``fd-code.cu:119-122``). Returns a new tensor."""
    out = pp.clone()
    for f, x in _fields(out, sx):
        f[x, sz] += amp
    return out


def inject_gaussian(pp, sx, sz: int, amp: float, patch):
    """Gaussian source injection, CPU ``ptsrc`` (``ptsrc.c:51-57``): the
    (2r+1, 2r+1) ``patch`` times ``amp`` is added around (sx, sz). The
    source must lie at least r cells inside the grid. Returns a new
    tensor."""
    patch = torch.as_tensor(patch, dtype=pp.dtype, device=pp.device)
    r = patch.shape[0] // 2
    add = amp * patch
    out = pp.clone()
    for f, x in _fields(out, sx):
        f[x - r:x + r + 1, sz - r:sz + r + 1] += add
    return out


def receiver_x0(x_off: int, n: int, nx_ext: int) -> int:
    """Start row of an n-long receiver row at x offset ``x_off`` in a grid
    of ``nx_ext`` rows, clamped to ``[0, nx_ext - n]`` as the JAX package's
    ``dynamic_slice``/``dynamic_update_slice`` clamp it (``stencil.py:
    202-209`` there). ``rtm_main``'s nzb-for-nxb quirk with nzb > 2*nxb
    lands here: the row moves, it does not leave the grid."""
    return min(max(int(x_off), 0), nx_ext - n)


def inject_receivers(ppr, dobs_t, nxb: int, gz: int):
    """Receiver-row injection for the backward pass, kernel K5
    (``kernel_sism``, ``fd-code.cu:124-131``): adds ``dobs_t`` (..., n)
    along depth row ``gz`` at x in ``[x0, x0+n)``, ``x0`` being ``nxb``
    clamped by :func:`receiver_x0`. Returns a new tensor."""
    n = dobs_t.shape[-1]
    x0 = receiver_x0(nxb, n, ppr.shape[-2])
    out = ppr.clone()
    out[..., x0:x0 + n, gz] += dobs_t
    return out


def imaging_correlation(imloc, p, ppr, nxb: int, nzb: int):
    """Zero-lag cross-correlation imaging, kernel K6 (``kernel_img``,
    ``fd-code.cu:133-144``): ``imloc + p[interior] * ppr[interior]``."""
    nx, nz = p.shape[-2:]
    pi = p[..., nxb:nx - nxb, nzb:nz - nzb]
    ri = ppr[..., nxb:nx - nxb, nzb:nz - nzb]
    return imloc + pi * ri
