"""The split backward block kernels that run the strip body of
``csrc/bwd_strip.cuh`` with the x taps in bf16 parts (``block_bwd_mma``,
``block2_bwd_mma``) against their plain block functions with the same
parts on the card. Each mma sums its products in the card's own order, so
the gates are those of the split tiers: fields 1e-4 and image 1e-5 of the
plain result's max.

* ``block_bwd_cuda(..., parts=)`` on the slabs of a (1, 2) mesh and
  ``block2_bwd_cuda`` on the tiles of a (1, 2, 2) mesh of the card against
  ``dk.block_bwd`` with the same ``parts`` (2 and 3), seeded and not, at
  orders 4, 8, 10, 12 and 16 and every K from 1 to 8 that the tiles take,
  on two ragged grids (no multiple of the owned shapes); above 4 steps
  the kernel runs two passes, and ``LAUNCHES`` counts each.
* One block of K = 8 at the Pluto slabs and tiles (7040 x 1281 extended,
  order 8), parts 2 and 3, seeded and not.

Card-only: every case is marked ``cuda`` and skips where there is none
(``python -m pytest tests/test_torch_bwd_mma_strip.py -m cuda
--noconftest`` on a GPU machine; this file imports no JAX)."""

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
GATES = (1e-4,) * 4 + (1e-5,)         # ps, pps, pr, ppr; the image


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _fields(rng, n, shape, device):
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device) for _ in range(n)]


def _tiles(ctx, shape, k, device, rng, nt):
    prep, geometry = ((dk.prepare_tiles, dk.slab_geometry) if len(shape) == 2
                      else (d2k.prepare_tiles, d2k.tile_geometry))
    geom = geometry(ctx, *shape[1:], k)
    grid = make_mesh(*shape, devices=[device] * int(np.prod(shape))).grid(0)
    d_ext = embed_dobs(ctx, rng.standard_normal((2, ctx.nx, nt)).astype(
        np.float32))
    v2 = torch.from_numpy(((1500.0 + 2500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    return prep(ctx, grid, geom, v2, "top", sxs=(33, 34), sz=42,
                dobs_ext=d_ext, gz=46)


def _within(got, want):
    for a, b, gate in zip(got, want, GATES):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= gate, (err, gate)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("grid", [(101, 120, 9, 11), (53, 70, 7, 9)])
def test_block_bwd_mma_matches_plain_on_the_card(cuda_device, grid, shape,
                                                 order, parts):
    nx, nz, nxb, nzb = grid
    nt = 9
    rng = np.random.default_rng(order + 10 * parts + len(shape))
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7)
    kernel = dk.block_bwd_cuda if len(shape) == 2 else d2k.block2_bwd_cuda
    launches = dk.LAUNCHES if len(shape) == 2 else d2k.LAUNCHES
    name = ("block_bwd" if len(shape) == 2 else "block2_bwd") + "_mma"
    for n in launches:
        launches[n] = 0
    calls = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            tiles = _tiles(ctx, shape, k, cuda_device, rng, nt)
        except ValueError:                    # the halo outgrows the tiles
            break
        assert fk.smem_bytes(name, order, k, parts) <= fk.SMEM_BYTES
        for c in tiles:
            f = _fields(rng, 6, (2, c.nxw, c.nzw), cuda_device)
            img = _fields(rng, 1, (2, c.nxl, c.nzl), cuda_device)[0]
            for snaps in ((None, f[4:]) if k > 1 else (None,)):
                got = kernel(c, *f[:4], img.clone(), 0, k, snaps,
                             parts=parts)
                want = dk.block_bwd(c, *f[:4], img.clone(), 0, k, snaps,
                                    parts)
                torch.cuda.synchronize()
                _within(got, want)
                calls += len(fk.block_passes(k))
    assert launches == {n: calls if n == name else 0 for n in launches}
    assert calls > 0


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
def test_block_bwd_mma_matches_plain_at_the_pluto_tiles(cuda_device, parts):
    rng = np.random.default_rng(parts)
    ctx = solver.FDContext.create(6960, 1201, 17, dx=7.62, dz=7.62,
                                  dt=0.0007, order=8, nxb=40, nzb=40,
                                  fac=0.75)
    for shape in ((1, 4), (1, 2, 2)):
        kernel = dk.block_bwd_cuda if len(shape) == 2 else d2k.block2_bwd_cuda
        for c in _tiles(ctx, shape, 8, cuda_device, rng, ctx.nt):
            f = _fields(rng, 6, (2, c.nxw, c.nzw), cuda_device)
            img = _fields(rng, 1, (2, c.nxl, c.nzl), cuda_device)[0]
            for snaps in (None, f[4:]):
                got = kernel(c, *f[:4], img.clone(), 0, 8, snaps,
                             parts=parts)
                want = dk.block_bwd(c, *f[:4], img.clone(), 0, 8, snaps,
                                    parts)
                torch.cuda.synchronize()
                _within(got, want)
