"""The exact forward block kernels of the domain tiers, which run the
one-field strip body of ``csrc/fwd_strip.cuh`` in passes of at most 4
steps (``block_mod``, ``block_fwd`` on x-slabs; ``block2_mod``,
``block2_fwd`` on (x, z) tiles), against their plain block functions on
the card, bitwise: the kernels are built with -fmad=false and sum in the
plain version's order.

* Every slab of a (1, 2) mesh and every tile of a (1, 2, 2) mesh of the
  card, from random states (halos included), at orders 4, 8, 10, 12 and
  16 and every K from 1 to 8 that the tiles' halos take (above 4 steps a
  block is two passes, two launches, which ``LAUNCHES`` counts), on two
  ragged grids (67 x 88 and 101 x 139 extended, no multiple of the owned
  shapes): ``block_mod`` with a Gaussian source under the all-edge taper
  and with a one-hot source under the top strip, the shots across the x
  cut, the band across the z cut and the trace row in a later z part (on
  the slabs, across the slab edge); ``block_fwd`` with the point source.
* One K = 8 block of each kernel on every slab and tile of the Pluto grid
  (7040 x 1281 extended) over (1, 4) and (1, 2, 2) meshes.

Card-only: every case is marked ``cuda`` and skips where there is none
(``python -m pytest tests/test_torch_block_fwd_strip.py -m cuda
--noconftest`` on a GPU machine; this file imports no JAX)."""

import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain2d_kernels as d2k, domain_kernels as dk, make_mesh)

ORDERS = (4, 8, 10, 12, 16)
# (nx, nz, nxb, nzb) of the two ragged grids
GRIDS = [(53, 70, 7, 9), (85, 113, 8, 13)]
# the x tier's kernels and the (x, z) tier's: mesh shape, tile maker and
# geometry, wrappers, launch counts and names
TIERS = {
    "x": ((1, 2), dk.prepare_tiles, dk.slab_geometry, dk.block_mod_cuda,
          dk.block_fwd_cuda, dk.LAUNCHES, "block_mod", "block_fwd"),
    "xz": ((1, 2, 2), d2k.prepare_tiles, d2k.tile_geometry,
           d2k.block2_mod_cuda, d2k.block2_fwd_cuda, d2k.LAUNCHES,
           "block2_mod", "block2_fwd")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _fields(rng, n, shape, device):
    return [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device) for _ in range(n)]


def _velocity(rng, ctx, lo=1500.0, hi=2000.0):
    return torch.from_numpy(((lo + (hi - lo) * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)


def _bitwise(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


def _acquisition(ctx, shape):
    """Shot rows across the x cut, a source depth whose Gaussian band
    crosses the z cut, a receiver row in the later z part (on a slab: any
    row; it crosses the slab edge)."""
    nxl = -(-ctx.nxe // shape[1])
    nzl = -(-ctx.nze // shape[2]) if len(shape) > 2 else ctx.nze // 2
    return (nxl - 1, nxl), nzl - 1, nzl + 2


def _tiles(ctx, tier, k, device, v2, **operands):
    shape, prep, geometry = TIERS[tier][:3]
    geom = geometry(ctx, *shape[1:], k)
    grid = make_mesh(*shape, devices=[device] * int(np.prod(shape))).grid(0)
    return prep(ctx, grid, geom, v2, **operands)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_block_fwd_kernels_are_bitwise_plain_on_the_card(cuda_device, order,
                                                         grid, tier):
    nx, nz, nxb, nzb = grid
    rng = np.random.default_rng(order + nx + len(tier))
    ctx = solver.FDContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7)
    shape, _, _, kmod, kfwd, launches, nmod, nfwd = TIERS[tier]
    sxs, sz, gz = _acquisition(ctx, shape)
    v2 = _velocity(rng, ctx)
    for n in launches:
        launches[n] = 0
    calls, ks = {nmod: 0, nfwd: 0}, []
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            modes = [_tiles(ctx, tier, k, cuda_device, v2[0], taper="all",
                            sxs=sxs, sz=sz, source="gaussian", gz=gz),
                     _tiles(ctx, tier, k, cuda_device, v2, taper="top",
                            sxs=sxs, sz=sz, gz=gz)]
        except ValueError:                    # the halo outgrows the tiles
            break
        ks.append(k)
        amps = rng.standard_normal(k).astype(np.float32)
        passes = len(fk.block_passes(k))
        for name in (nmod, nfwd):
            assert fk.smem_bytes(name, order, k) <= fk.SMEM_BYTES
        for cm, cp in zip(*modes):
            p, pp = _fields(rng, 2, (2, cm.nxw, cm.nzw), cuda_device)
            for c in (cm, cp):
                got = kmod(c, p, pp, amps)
                want = dk.block_mod(c, p, pp, amps)
                torch.cuda.synchronize()
                _bitwise(got, want)
                calls[nmod] += passes
            got = kfwd(cp, p, pp, amps)
            want = dk.block_fwd(cp, p, pp, amps)
            torch.cuda.synchronize()
            _bitwise(got, want)
            calls[nfwd] += passes
    assert ks and ks == list(range(1, len(ks) + 1))
    assert {n: launches[n] for n in calls} == calls


@pytest.mark.cuda
def test_block_fwd_kernels_are_bitwise_plain_at_the_pluto_tiles(cuda_device):
    rng = np.random.default_rng(0)
    ctx = solver.FDContext.create(6960, 1201, 17, dx=7.62, dz=7.62,
                                  dt=0.0007, order=8, nxb=40, nzb=40,
                                  fac=0.75)
    v2 = _velocity(rng, ctx, hi=4000.0)
    amps = rng.standard_normal(8).astype(np.float32)
    for tier in sorted(TIERS):
        shape = (1, 4) if tier == "x" else (1, 2, 2)
        kmod, kfwd, launches, nmod, nfwd = TIERS[tier][3:]
        prep, geometry = TIERS[tier][1:3]
        grid = make_mesh(*shape, devices=[cuda_device] * 4).grid(0)
        geom = geometry(ctx, *shape[1:], 8)
        modes = [prep(ctx, grid, geom, v2[0], "all", sxs=(2740, 2760),
                      sz=40, source="gaussian", gz=40),
                 prep(ctx, grid, geom, v2, "top", sxs=(2740, 2760), sz=40,
                      gz=40)]
        for n in launches:
            launches[n] = 0
        for cm, cp in zip(*modes):
            p, pp = _fields(rng, 2, (2, cm.nxw, cm.nzw), cuda_device)
            for c in (cm, cp):
                got = kmod(c, p, pp, amps)
                want = dk.block_mod(c, p, pp, amps)
                torch.cuda.synchronize()
                _bitwise(got, want)
                del got, want
            got = kfwd(cp, p, pp, amps)
            want = dk.block_fwd(cp, p, pp, amps)
            torch.cuda.synchronize()
            _bitwise(got, want)
            del got, want, p, pp
        # two passes a block: 2 x 4 tiles x 2 source modes, 2 x 4 tiles
        assert launches[nmod] == 16 and launches[nfwd] == 8
