"""The exact forward K-step kernels that run the one-field strip body of
``csrc/fwd_strip.cuh`` (``kstep_mod``, ``kstep_gpu_fwd``) against their
plain passes on the card, bitwise: the kernels are built with -fmad=false
and sum in the plain version's order.

* ``kstep_mod`` (a Gaussian source under the all-edge taper and a point
  source under the top strip, with the trace row) and ``kstep_gpu_fwd``,
  one pass from random states against ``solver.mod_kstep`` /
  ``solver.fd_forward_kstep`` on the same CUDA tensors, at orders 4, 8,
  10, 12 and 16 and every K from 1 to 8 (each tile fits the forward
  body's shapes, ``fk.smem_bytes``), on two ragged grids (67 x 88 and
  101 x 139 extended, no multiple of the owned shapes) with the sources
  and the receiver row across tile edges.
* One pass of each at the Pluto grid (7040 x 1281 extended, K = 4).

Card-only: every case is marked ``cuda`` and skips where there is none
(``python -m pytest tests/test_torch_fwd_strip.py -m cuda --noconftest``
on a GPU machine; this file imports no JAX)."""

import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)

ORDERS = (4, 8, 10, 12, 16)
# (nx, nz, nxb, nzb); the shot positions, source depth and receiver row:
# the Gaussian window (radius 3) and the point sources across the x edges
# at 32 and 64 and the z edge at 64 of the 32 x 64 (and 32 x 32) tiles
GRIDS = [((53, 70, 7, 9), (31, 63), 62, 64),
         ((85, 113, 8, 13), (33, 96), 63, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _fields(rng, n, shape, device):
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device) for _ in range(n)]


def _velocity(rng, ctx, device, lo=1500.0, hi=2000.0):
    return torch.from_numpy(((lo + (hi - lo) * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(device)


def _bitwise(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


def _passes(device, order, grid, kernel, plain, name):
    """One pass of ``kernel`` against ``plain`` from random states at every
    K from 1 to 8, each of whose tiles fits the forward body's shapes."""
    (nx, nz, nxb, nzb), sxs, sz, gz = grid
    rng = np.random.default_rng(order + nx)
    ctx = solver.FDContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7)
    p, pp = _fields(rng, 2, (2, ctx.nxe, ctx.nze), device)
    v2 = _velocity(rng, ctx, device)
    stream.reset_launches()
    for k in range(1, stream.MAX_STEPS + 1):
        assert fk.smem_bytes(name, order, k) <= fk.SMEM_BYTES
        args = (ctx, p, pp, v2, rng.standard_normal(k).astype(np.float32),
                sxs, sz, gz)
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        _bitwise(got, want)
    assert stream.LAUNCHES[name] == stream.MAX_STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", [("gaussian", "all"), ("point", "top")])
def test_kstep_mod_is_bitwise_plain_on_the_card(cuda_device, order, grid,
                                                mode):
    def kernel(ctx, p, pp, v2, amps, sxs, sz, gz):
        return stream.mod_kstep_cuda(ctx, p, pp, v2[0], amps, sxs, sz, gz,
                                     *mode)

    def plain(ctx, p, pp, v2, amps, sxs, sz, gz):
        return solver.mod_kstep(ctx, p, pp, v2[0], amps, sxs, sz, gz, *mode)

    _passes(cuda_device, order, grid, kernel, plain, "kstep_mod")


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", GRIDS)
def test_kstep_gpu_fwd_is_bitwise_plain_on_the_card(cuda_device, order,
                                                    grid):
    def kernel(ctx, p, pp, v2, amps, sxs, sz, gz):
        return stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz)

    def plain(ctx, p, pp, v2, amps, sxs, sz, gz):
        return solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz)

    _passes(cuda_device, order, grid, kernel, plain, "kstep_gpu_fwd")


@pytest.mark.cuda
def test_fwd_kernels_are_bitwise_plain_at_the_pluto_grid(cuda_device):
    rng = np.random.default_rng(0)
    ctx = solver.FDContext.create(6960, 1201, 17, dx=7.62, dz=7.62,
                                  dt=0.0007, order=8, nxb=40, nzb=40,
                                  fac=0.75)
    p, pp = _fields(rng, 2, (2, ctx.nxe, ctx.nze), cuda_device)
    v2 = _velocity(rng, ctx, cuda_device, hi=4000.0)
    amps = rng.standard_normal(4).astype(np.float32)
    sxs, sz, gz = (2740, 2760), 40, 40
    for source, taper in (("gaussian", "all"), ("point", "top")):
        got = stream.mod_kstep_cuda(ctx, p, pp, v2[0], amps, sxs, sz, gz,
                                    source, taper)
        want = solver.mod_kstep(ctx, p, pp, v2[0], amps, sxs, sz, gz,
                                source, taper)
        torch.cuda.synchronize()
        _bitwise(got, want)
        del got, want
    got = stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz)
    want = solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz)
    torch.cuda.synchronize()
    _bitwise(got, want)
