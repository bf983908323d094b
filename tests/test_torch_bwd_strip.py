"""The exact backward kernels that run the strip body of
``csrc/bwd_strip.cuh`` (``kstep_gpu_bwd``, ``block_bwd``, ``block2_bwd``)
against their plain versions on the card, bitwise: the kernels are built
with -fmad=false and sum in the plain version's order.

* ``kstep_gpu_bwd`` one pass from random states against
  ``solver.fd_back_kstep`` on the same CUDA tensors, at orders 4, 8, 10,
  12 and 16 and every K from 1 to 8 whose tile fits
  (``fk.smem_bytes``), on two ragged grids (67 x 88 and 101 x 139
  extended, no multiple of the owned shapes), the receiver row across a
  tile edge; a K that fits no shape raises, naming the limit.
* ``block_bwd`` on the slabs of a (1, 2) mesh and ``block2_bwd`` on the
  tiles of a (1, 2, 2) mesh of the card against the plain block function,
  seeded and not, at the same orders and every K the tiles take (every
  one fits the shared memory: above 4 steps the kernel runs two passes,
  two launches).
* One pass of ``kstep_gpu_bwd`` at the Pluto grid (7040 x 1281 extended,
  K = 4), and one block of ``block_bwd`` and ``block2_bwd`` at the Pluto
  slabs and tiles (K = 8).

Card-only: every case is marked ``cuda`` and skips where there is none
(``python -m pytest tests/test_torch_bwd_strip.py -m cuda --noconftest``
on a GPU machine; this file imports no JAX)."""

import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain2d_kernels as d2k, domain_kernels as dk, make_mesh)
from parallel_finite_difference_computation_tpu_torch.parallel.domain import (
    embed_dobs)

ORDERS = (4, 8, 10, 12, 16)


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


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", [(53, 70, 7, 9), (85, 113, 8, 13)])
def test_kstep_gpu_bwd_is_bitwise_plain_on_the_card(cuda_device, order,
                                                    grid):
    nx, nz, nxb, nzb = grid
    rng = np.random.default_rng(order)
    ctx = solver.FDContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7)
    st = _fields(rng, 4, (2, ctx.nxe, ctx.nze), cuda_device)
    img = _fields(rng, 1, (2, ctx.nx, ctx.nz), cuda_device)[0]
    v2 = _velocity(rng, ctx, cuda_device)
    gz = 64                                   # a tile edge of 32 x 64
    stream.reset_launches()
    fitting = 0
    for k in range(1, stream.MAX_STEPS + 1):
        inj = _fields(rng, 1, (2, k, ctx.nx), cuda_device)[0]
        if fk.smem_bytes("kstep_gpu_bwd", order, k) > fk.SMEM_BYTES:
            with pytest.raises(ValueError, match=f"{fk.SMEM_BYTES} bytes"):
                stream.fd_back_kstep_cuda(ctx, *st, img.clone(), v2, inj, gz)
            continue
        fitting += 1
        got = stream.fd_back_kstep_cuda(ctx, *st, img.clone(), v2, inj, gz)
        want = solver.fd_back_kstep(ctx, *st, img.clone(), v2, inj, gz)
        torch.cuda.synchronize()
        _bitwise(got, want)
    assert stream.LAUNCHES["kstep_gpu_bwd"] == fitting
    assert fitting == (6 if order == 16 else 8)


def _tiles(ctx, shape, k, device, rng, nt):
    prep, geometry = ((dk.prepare_tiles, dk.slab_geometry) if len(shape) == 2
                      else (d2k.prepare_tiles, d2k.tile_geometry))
    geom = geometry(ctx, *shape[1:], k)
    grid = make_mesh(*shape, devices=[device] * int(np.prod(shape))).grid(0)
    d_ext = embed_dobs(ctx, rng.standard_normal((2, ctx.nx, nt)).astype(
        np.float32))
    return prep(ctx, grid, geom, _velocity(rng, ctx, "cpu"), "top",
                sxs=(33, 34), sz=42, dobs_ext=d_ext, gz=46)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
def test_block_bwd_is_bitwise_plain_on_the_card(cuda_device, order, shape):
    nt = 9
    rng = np.random.default_rng(order + len(shape))
    ctx = solver.FDContext.create(101, 120, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=9, nzb=11, fac=0.7)
    kernel = dk.block_bwd_cuda if len(shape) == 2 else d2k.block2_bwd_cuda
    launches = dk.LAUNCHES if len(shape) == 2 else d2k.LAUNCHES
    name = "block_bwd" if len(shape) == 2 else "block2_bwd"
    for n in launches:
        launches[n] = 0
    calls = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            tiles = _tiles(ctx, shape, k, cuda_device, rng, nt)
        except ValueError:                    # the halo outgrows the tiles
            break
        for c in tiles:
            f = _fields(rng, 6, (2, c.nxw, c.nzw), cuda_device)
            img = _fields(rng, 1, (2, c.nxl, c.nzl), cuda_device)[0]
            for snaps in ((None, f[4:]) if k > 1 else (None,)):
                assert fk.smem_bytes(name, order, k) <= fk.SMEM_BYTES
                got = kernel(c, *f[:4], img.clone(), 0, k, snaps)
                want = dk.block_bwd(c, *f[:4], img.clone(), 0, k, snaps)
                torch.cuda.synchronize()
                _bitwise(got, want)
                calls += len(fk.block_passes(k))
    assert launches[name] == calls > 0


@pytest.mark.cuda
def test_bwd_kernels_are_bitwise_plain_at_the_pluto_tiles(cuda_device):
    rng = np.random.default_rng(0)
    ctx = solver.FDContext.create(6960, 1201, 17, dx=7.62, dz=7.62,
                                  dt=0.0007, order=8, nxb=40, nzb=40,
                                  fac=0.75)
    st = _fields(rng, 4, (2, ctx.nxe, ctx.nze), cuda_device)
    img = _fields(rng, 1, (2, ctx.nx, ctx.nz), cuda_device)[0]
    v2 = _velocity(rng, ctx, cuda_device, hi=4000.0)
    inj = _fields(rng, 1, (2, 4, ctx.nx), cuda_device)[0]
    got = stream.fd_back_kstep_cuda(ctx, *st, img.clone(), v2, inj, 40)
    want = solver.fd_back_kstep(ctx, *st, img.clone(), v2, inj, 40)
    torch.cuda.synchronize()
    _bitwise(got, want)
    del st, got, want
    for shape in ((1, 4), (1, 2, 2)):
        kernel = dk.block_bwd_cuda if len(shape) == 2 else d2k.block2_bwd_cuda
        for c in _tiles(ctx, shape, 8, cuda_device, rng, ctx.nt):
            f = _fields(rng, 6, (2, c.nxw, c.nzw), cuda_device)
            img = _fields(rng, 1, (2, c.nxl, c.nzl), cuda_device)[0]
            for snaps in (None, f[4:]):
                got = kernel(c, *f[:4], img.clone(), 0, 8, snaps)
                want = dk.block_bwd(c, *f[:4], img.clone(), 0, 8, snaps)
                torch.cuda.synchronize()
                _bitwise(got, want)
