"""The split kernels on the strip bodies against their plain versions with
the same parts on the card: ``kstep_gpu_bwd_mma`` (the backward strip body
of ``csrc/bwd_strip.cuh`` with the z taps in bf16 parts),
``kstep_mod_mma`` and ``kstep_gpu_fwd_mma`` (the forward strip body of
``csrc/fwd_strip.cuh`` with the z taps in bf16 parts), and
``block_mod_mma`` / ``block2_mod_mma`` and ``block_fwd_mma`` /
``block2_fwd_mma`` (the forward strip body with the x taps in bf16 parts,
in passes). Each mma sums its products in the card's own order, so the
gates are those of the split tiers: fields 1e-4, traces and image 1e-5 of
the plain result's max.

* ``stream.fd_back_kstep_cuda(..., parts=)`` against the plain pass
  (``solver.fd_back_kstep`` with the same split z taps) at orders 4, 8,
  10, 12 and 16 and every K from 1 to 8 whose tile fits a block (a K
  that does not is refused), on two ragged grids (no multiple of the
  owned shapes), parts 2 and 3; one launch a pass.
* ``stream.mod_kstep_cuda(..., parts=)`` in both source modes (the
  Gaussian source with the all-edge taper, the point source with the top
  taper), the trace rows included, and ``stream.fd_forward_kstep_cuda(...,
  parts=)`` against ``solver.mod_kstep`` / ``solver.fd_forward_kstep``
  with the same split z taps, likewise.
* ``block_fwd_cuda(..., parts=)`` on the slabs of a (1, 2) mesh and
  ``block2_fwd_cuda`` on the tiles of a (1, 2, 2) mesh of the card against
  ``dk.block_fwd`` with the same parts at the same orders and every K the
  tiles take, on the same grids; above 4 steps the kernel runs two passes,
  and ``LAUNCHES`` counts each.
* ``block_mod_cuda(..., parts=)`` and ``block2_mod_cuda`` likewise against
  ``dk.block_mod``, in both source modes (the Gaussian source with the
  all-edge taper, the point source with the top taper), the trace rows
  included.
* One pass of K = 4 of each K-step kernel at the Pluto grid (7040 x 1281
  extended, order 8) and one block of K = 8 of the forward and modeling
  block twins on its slabs and tiles, parts 2 and 3.
* ``stream.fd_step_cuda(..., parts=)`` (``fd_step_mma``, the one-step
  split body of ``csrc/step_strip.cuh``) with both tapers and every
  injection (none, the Gaussian window, the point source, the receiver
  row), and ``stream.fd_step_gpu_cuda(..., parts=)`` (``gpu_step_mma``,
  the same body) without and with the trace row and the image, one step
  against the plain step with the same split z taps at every even order
  from 4 to 16 on the same grids, on a third one two owned shapes wide
  along x, and at the Pluto grid; one launch a step.
  One step's gate is 1e-6 of the plain result's max (``chip_smoke.py``
  phase 28's).
* ``stream.fd_update_cuda(..., parts=)`` (``fd_update_mma``, the same body
  without a taper) one step against ``solver.fd_update`` with the same
  split z taps, likewise, gate 1e-6; and ``fk.backward_recorded_cuda`` /
  ``fk.backward_image_cuda(..., lap_impl=)`` (``rec_bwd_step_mma`` in
  frame mode with both receiver offsets and in image mode, the same body
  without a taper, one launch a step) against
  ``solver.backward_recorded`` / ``solver.backward_image`` over 9 steps,
  on the same grids and orders, and on an 8-shot grid whose launcher takes
  64 x 64 owned cells; gates 1e-4 for the frames and fields, 1e-5 for the
  images (phase 28's).
* ``fk.forward_modeling_cuda(..., record="wavefield", lap_impl=)``
  (``rec_fwd_step_mma``, the same body without a taper, the point source's
  patch added at the cell) against ``solver.forward_modeling`` over 9
  steps on the same grids and orders and on the 8-shot grid, gates 1e-4
  for the fields and the frames; and ``fk._fd_back(..., parts)``
  (``rtm_bwd_step_mma``, the x taps split, staged by ``cp.async``) against
  ``solver.fd_back`` over 9 steps, its two seeded steps included, on the
  same grids and orders, gate 1e-5 for the image.

Card-only: every case is marked ``cuda`` and skips where there is none
(``python -m pytest tests/test_torch_split_strip.py -m cuda --noconftest``
on a GPU machine; this file imports no JAX). The one-step body's shared
memory is checked in ``tests/test_torch_tiled.py``
(``test_shared_memory_of_the_kernels``)."""


import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain2d_kernels as d2k, domain_kernels as dk, make_mesh)

ORDERS = (4, 8, 10, 12, 16)
GRIDS = [(101, 120, 9, 11), (53, 70, 7, 9)]
BWD_GATES = (1e-4,) * 4 + (1e-5,)        # ps, pps, pr, ppr; the image


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _v2(rng, ctx):
    return torch.from_numpy(((1500.0 + 2500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)


def _within(got, want, gates):
    for a, b, gate in zip(got, want, gates):
        # a tile that records no trace row returns zeros
        err = float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
        assert err <= gate, (err, gate)


def _ctx(grid, order, nt=9):
    nx, nz, nxb, nzb = grid
    return solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                   order=order, nxb=nxb, nzb=nzb, fac=0.7)


def _kstep_bwd(ctx, rng, device, k, parts, gz):
    """One pass of k steps of the split backward kernel against the plain
    pass (``solver.fd_back_kstep`` with the z taps in the same parts), on
    the same random state on the card."""
    st = [_f32(rng, 2, ctx.nxe, ctx.nze).to(device) for _ in range(4)]
    img = _f32(rng, 2, ctx.nx, ctx.nz).to(device)
    inj = _f32(rng, 2, k, ctx.nx).to(device)
    v2 = _v2(rng, ctx).to(device)
    want = solver.fd_back_kstep(ctx, *st, img.clone(), v2, inj, gz,
                                solver.laplacian_of(ctx, parts, axis="z"))
    got = stream.fd_back_kstep_cuda(ctx, *st, img.clone(), v2, inj, gz,
                                    parts=parts)
    torch.cuda.synchronize()
    _within(got, want, BWD_GATES)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", GRIDS)
def test_kstep_gpu_bwd_mma_matches_plain_on_the_card(cuda_device, grid,
                                                     order, parts):
    rng = np.random.default_rng(order + 10 * parts)
    ctx = _ctx(grid, order)
    stream.reset_launches()
    calls = 0
    for k in range(1, stream.MAX_STEPS + 1):
        if fk.smem_bytes("kstep_gpu_bwd", order, k, parts) > fk.SMEM_BYTES:
            with pytest.raises(ValueError, match="shared memory"):
                _kstep_bwd(ctx, rng, cuda_device, k, parts, grid[3] + 4)
            continue
        _kstep_bwd(ctx, rng, cuda_device, k, parts, grid[3] + 4)
        calls += 1
    assert calls >= 4                  # the pipelines' K = 4 at every order
    assert {n: v for n, v in stream.LAUNCHES.items() if v} == {
        "kstep_gpu_bwd_mma": calls}


def _kstep_fwd(ctx, rng, device, k, parts, mode, sxs=(31, 63), sz=62,
               gz=64):
    """One pass of k steps of a split forward K-step kernel against the
    plain pass with the z taps in the same parts, on the same random state
    on the card: ``kstep_mod_mma`` in the source mode ``mode`` (source,
    taper), recording row gz, or ``kstep_gpu_fwd_mma`` (mode None). The
    default sources and row lie across the edges of the 64 x 64 and 32 x
    64 owned shapes."""
    p, pp = (_f32(rng, 2, ctx.nxe, ctx.nze).to(device) for _ in range(2))
    v2 = _v2(rng, ctx).to(device)
    amps = np.float32(rng.standard_normal(k))
    lap = solver.laplacian_of(ctx, parts, axis="z")
    if mode is None:
        want = solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz, lap)
        got = stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz,
                                           parts=parts)
    else:
        want = solver.mod_kstep(ctx, p, pp, v2[0], amps, sxs, sz, gz, *mode,
                                lap)
        got = stream.mod_kstep_cuda(ctx, p, pp, v2[0], amps, sxs, sz, gz,
                                    *mode, parts=parts)
    torch.cuda.synchronize()
    _within(got, want, (1e-4, 1e-4, 1e-5))


def _kstep_fwd_passes(device, grid, order, parts, name, modes):
    """_kstep_fwd at every K from 1 to 8 in each mode of ``modes``, a K
    whose tile does not fit a block refused; one launch of ``name``_mma a
    pass."""
    rng = np.random.default_rng(order + 10 * parts + len(modes))
    ctx = _ctx(grid, order)
    stream.reset_launches()
    calls = 0
    for k in range(1, stream.MAX_STEPS + 1):
        for mode in modes:
            if fk.smem_bytes(name, order, k, parts) > fk.SMEM_BYTES:
                with pytest.raises(ValueError, match="shared memory"):
                    _kstep_fwd(ctx, rng, device, k, parts, mode)
                continue
            _kstep_fwd(ctx, rng, device, k, parts, mode)
            calls += 1
    # every K up to 7 at every order, and K = 8 up to order 14
    assert calls >= 7 * len(modes)
    assert {n: v for n, v in stream.LAUNCHES.items() if v} == {
        f"{name}_mma": calls}


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", GRIDS)
def test_kstep_mod_mma_matches_plain_on_the_card(cuda_device, grid, order,
                                                 parts):
    _kstep_fwd_passes(cuda_device, grid, order, parts, "kstep_mod",
                      [("gaussian", "all"), ("point", "top")])


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("grid", GRIDS)
def test_kstep_gpu_fwd_mma_matches_plain_on_the_card(cuda_device, grid,
                                                     order, parts):
    _kstep_fwd_passes(cuda_device, grid, order, parts, "kstep_gpu_fwd",
                      [None])


def _fwd_tiles(ctx, shape, k, device):
    prep, geometry = ((dk.prepare_tiles, dk.slab_geometry) if len(shape) == 2
                      else (d2k.prepare_tiles, d2k.tile_geometry))
    geom = geometry(ctx, *shape[1:], k)
    grid = make_mesh(*shape, devices=[device] * int(np.prod(shape))).grid(0)
    v2 = _v2(np.random.default_rng(k), ctx)
    return prep(ctx, grid, geom, v2, "top", sxs=(33, 34), sz=42, gz=46)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("grid", GRIDS)
def test_block_fwd_mma_matches_plain_on_the_card(cuda_device, grid, shape,
                                                 order, parts):
    rng = np.random.default_rng(order + 10 * parts + len(shape))
    ctx = _ctx(grid, order)
    kernel = dk.block_fwd_cuda if len(shape) == 2 else d2k.block2_fwd_cuda
    launches = dk.LAUNCHES if len(shape) == 2 else d2k.LAUNCHES
    name = ("block_fwd" if len(shape) == 2 else "block2_fwd") + "_mma"
    for n in launches:
        launches[n] = 0
    calls = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            tiles = _fwd_tiles(ctx, shape, k, cuda_device)
        except ValueError:                    # the halo outgrows the tiles
            break
        assert fk.smem_bytes(name, order, k, parts) <= fk.SMEM_BYTES
        amps = np.float32(rng.standard_normal(k))
        for c in tiles:
            f = [_f32(rng, 2, c.nxw, c.nzw).to(cuda_device)
                 for _ in range(2)]
            got = kernel(c, *f, amps, parts=parts)
            want = dk.block_fwd(c, *f, amps, parts)
            torch.cuda.synchronize()
            _within(got, want, (1e-4, 1e-4))
            calls += len(fk.block_passes(k))
    assert launches == {n: calls if n == name else 0 for n in launches}
    assert calls > 0


def _mod_tiles(ctx, shape, k, device, sxs=(33, 34), sz=42, gz=46):
    """The modeling tiles of a mesh of ``shape`` on ``device`` for blocks
    of k steps in both source modes: the Gaussian source with the all-edge
    taper and one velocity plane for every shot, then the point source
    with the top taper; both record row gz."""
    prep, geometry = ((dk.prepare_tiles, dk.slab_geometry) if len(shape) == 2
                      else (d2k.prepare_tiles, d2k.tile_geometry))
    geom = geometry(ctx, *shape[1:], k)
    grid = make_mesh(*shape, devices=[device] * int(np.prod(shape))).grid(0)
    v2 = _v2(np.random.default_rng(k), ctx)
    return (prep(ctx, grid, geom, v2[0], "all", sxs=sxs, sz=sz,
                 source="gaussian", gz=gz)
            + prep(ctx, grid, geom, v2, "top", sxs=sxs, sz=sz, gz=gz))


def _mod_block(kernel, c, rng, amps, parts, device):
    """One block of the split modeling kernel on tile c against the plain
    block: fields 1e-4, traces 1e-5."""
    f = [_f32(rng, 2, c.nxw, c.nzw).to(device) for _ in range(2)]
    got = kernel(c, *f, amps, parts=parts)
    want = dk.block_mod(c, *f, amps, parts)
    torch.cuda.synchronize()
    _within(got, want, (1e-4, 1e-4, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("grid", GRIDS)
def test_block_mod_mma_matches_plain_on_the_card(cuda_device, grid, shape,
                                                 order, parts):
    rng = np.random.default_rng(order + 10 * parts + len(shape))
    ctx = _ctx(grid, order)
    kernel = dk.block_mod_cuda if len(shape) == 2 else d2k.block2_mod_cuda
    launches = dk.LAUNCHES if len(shape) == 2 else d2k.LAUNCHES
    name = ("block_mod" if len(shape) == 2 else "block2_mod") + "_mma"
    for n in launches:
        launches[n] = 0
    calls = recording = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            tiles = _mod_tiles(ctx, shape, k, cuda_device)
        except ValueError:                    # the halo outgrows the tiles
            break
        assert fk.smem_bytes(name, order, k, parts) <= fk.SMEM_BYTES
        amps = np.float32(rng.standard_normal(k))
        for c in tiles:
            _mod_block(kernel, c, rng, amps, parts, cuda_device)
            calls += len(fk.block_passes(k))
            recording += c.records
    assert launches == {n: calls if n == name else 0 for n in launches}
    assert calls > 0 and recording > 0


PLUTO = dict(nx=6960, nz=1201, nt=17, dx=7.62, dz=7.62, dt=0.0007, order=8,
             nxb=40, nzb=40, fac=0.75)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
def test_split_strip_kernels_match_plain_at_pluto(cuda_device, parts):
    rng = np.random.default_rng(parts)
    ctx = solver.FDContext.create(**PLUTO)
    _kstep_bwd(ctx, rng, cuda_device, 4, parts, 40)
    for mode in (("gaussian", "all"), ("point", "top"), None):
        _kstep_fwd(ctx, rng, cuda_device, 4, parts, mode, sxs=(2740, 2760),
                   sz=40, gz=40)
    for shape in ((1, 4), (1, 2, 2)):
        kernel = dk.block_fwd_cuda if len(shape) == 2 else d2k.block2_fwd_cuda
        prep, geometry = ((dk.prepare_tiles, dk.slab_geometry)
                          if len(shape) == 2
                          else (d2k.prepare_tiles, d2k.tile_geometry))
        grid = make_mesh(*shape, devices=[cuda_device] * 4).grid(0)
        tiles = prep(ctx, grid, geometry(ctx, *shape[1:], 8), _v2(rng, ctx),
                     "top", sxs=(2740, 2760), sz=40, gz=40)
        amps = np.float32(rng.standard_normal(8))
        for c in tiles:
            f = [_f32(rng, 2, c.nxw, c.nzw).to(cuda_device)
                 for _ in range(2)]
            got = kernel(c, *f, amps, parts=parts)
            want = dk.block_fwd(c, *f, amps, parts)
            torch.cuda.synchronize()
            _within(got, want, (1e-4, 1e-4))
        kmod = dk.block_mod_cuda if len(shape) == 2 else d2k.block2_mod_cuda
        for c in _mod_tiles(ctx, shape, 8, cuda_device, sxs=(2740, 2760),
                            sz=40, gz=40):
            _mod_block(kmod, c, rng, amps, parts, cuda_device)


K1_ORDERS = (4, 6, 8, 10, 12, 14, 16)
# and a grid of two 128 x 64 owned shapes along x, with tails on both axes
K1_GRIDS = GRIDS + [(150, 60, 7, 9)]
STEP_GATE = 1e-6                   # one step, of the plain result's max


def _step_inputs(ctx, rng, device):
    """A random state (p, pp, src), trace row and image, and a velocity a
    shot, on the device."""
    st = [_f32(rng, 2, ctx.nxe, ctx.nze).to(device) for _ in range(3)]
    row = _f32(rng, 2, ctx.nx).to(device)
    img = _f32(rng, 2, ctx.nx, ctx.nz).to(device)
    return st, row, img, _v2(rng, ctx).to(device)


def _fd_steps(ctx, rng, device, parts, sxs=None, sz=62, gz=63):
    """fd_step_mma against the plain step with the same split z taps: both
    tapers, and no injection, the Gaussian window, the point source, the
    receiver row (one velocity plane for every shot). The default sources
    lie across the owned cells' edges at x = 64 and (on a grid wider than
    140) 128, the default row across the edge at z = 64. Returns the
    launches."""
    sxs = sxs or ((31, 61) if ctx.nxe < 140 else (61, 126))
    (p, pp, _), row, _, v2 = _step_inputs(ctx, rng, device)
    lap = solver.laplacian_of(ctx, parts, axis="z")
    n = 0
    for taper in ("all", "top"):
        for kw in ({}, dict(amp=0.7, sx=sxs, sz=sz),
                   dict(amp=0.7, sx=sxs, sz=sz, source="point"),
                   dict(inj_row=row, x0=ctx.nzb, gz=gz)):
            got = stream.fd_step_cuda(ctx, p, pp, v2[0], taper, parts=parts,
                                      **kw)
            want = solver.fd_step(ctx, p, pp, v2[0], taper, lap=lap, **kw)
            torch.cuda.synchronize()
            _within(got, want, (STEP_GATE,) * 2)
            n += 1
    return n


def _gpu_step(ctx, rng, device, parts, imaging, gz=63):
    """gpu_step_mma against the plain step with the same split z taps,
    with the trace row at depth gz and the image (imaging) or neither."""
    (y, x, src), row, img, v2 = _step_inputs(ctx, rng, device)
    lap = solver.laplacian_of(ctx, parts, axis="z")
    if imaging:
        got = stream.fd_step_gpu_cuda(ctx, y, x, v2, gz, row, img.clone(),
                                      src, parts=parts)
        want = solver.fd_step_gpu(ctx, y, x, v2, gz, row, img.clone(), src,
                                  lap)
    else:
        got = stream.fd_step_gpu_cuda(ctx, y, x, v2, parts=parts)
        want = solver.fd_step_gpu(ctx, y, x, v2, lap=lap)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (3 if imaging else 2)
    _within(got, want, (STEP_GATE,) * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", K1_ORDERS)
@pytest.mark.parametrize("grid", K1_GRIDS)
def test_fd_step_mma_matches_plain_on_the_card(cuda_device, grid, order,
                                               parts):
    rng = np.random.default_rng(order + 10 * parts)
    ctx = _ctx(grid, order)
    stream.reset_launches()
    n = _fd_steps(ctx, rng, cuda_device, parts)
    assert {k: v for k, v in stream.LAUNCHES.items() if v} == {
        "fd_step_mma": n}


@pytest.mark.cuda
@pytest.mark.parametrize("imaging", [False, True])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", K1_ORDERS)
@pytest.mark.parametrize("grid", K1_GRIDS)
def test_gpu_step_mma_matches_plain_on_the_card(cuda_device, grid, order,
                                                parts, imaging):
    rng = np.random.default_rng(order + 10 * parts + imaging)
    ctx = _ctx(grid, order)
    stream.reset_launches()
    _gpu_step(ctx, rng, cuda_device, parts, imaging)
    assert {k: v for k, v in stream.LAUNCHES.items() if v} == {
        "gpu_step_mma": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
def test_step_strip_kernels_match_plain_at_pluto(cuda_device, parts):
    rng = np.random.default_rng(20 + parts)
    ctx = solver.FDContext.create(**PLUTO)
    _fd_steps(ctx, rng, cuda_device, parts, sxs=(2740, 2760), sz=40, gz=40)
    for imaging in (False, True):
        _gpu_step(ctx, rng, cuda_device, parts, imaging, gz=40)


REC_GATES = (1e-4, 1e-4, 1e-4)            # p, pp, the frames
IMAGE_GATE = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", K1_ORDERS)
@pytest.mark.parametrize("grid", K1_GRIDS)
def test_fd_update_mma_matches_plain_on_the_card(cuda_device, grid, order,
                                                 parts):
    rng = np.random.default_rng(order + 10 * parts + 2)
    ctx = _ctx(grid, order)
    (p, pp, _), _, _, v2 = _step_inputs(ctx, rng, cuda_device)
    stream.reset_launches()
    got = stream.fd_update_cuda(ctx, p, pp, v2, parts=parts)
    want = solver.fd_update(ctx, p, pp, v2,
                            solver.laplacian_of(ctx, parts, axis="z"))
    torch.cuda.synchronize()
    _within((got,), (want,), (STEP_GATE,))
    assert {k: v for k, v in stream.LAUNCHES.items() if v} == {
        "fd_update_mma": 1}


def _rec_bwd(ctx, rng, device, parts, ns=2):
    """rec_bwd_step_mma over ctx.nt steps in frame mode (both receiver
    offsets) and in image mode against the plain loops with the same split
    z taps, on random gathers, source frames and velocity, the receiver
    row at nzb + 3; one launch a step."""
    v2 = _v2(rng, ctx)[0].to(device)
    dobs = _f32(rng, ns, ctx.nx, ctx.nt).to(device)
    swf = _f32(rng, ns, ctx.nt, ctx.nx, ctx.nz).to(device)
    nxt = (0.5,) + (0.0,) * (ns - 1)
    gz = ctx.nzb + 3
    lap = solver.laplacian_of(ctx, parts, axis="z")
    fk.reset_launches()
    for quirk in (True, False):
        got = fk.backward_recorded_cuda(ctx, v2, dobs, gz, x_off_quirk=quirk,
                                        next_shot_first=nxt, lap_impl=parts)
        want = solver.backward_recorded(ctx, v2, dobs, gz, x_off_quirk=quirk,
                                        next_shot_first=nxt, lap=lap)
        torch.cuda.synchronize()
        _within(got, want, REC_GATES)
    got = fk.backward_image_cuda(ctx, v2, swf, dobs, gz, next_shot_first=nxt,
                                 lap_impl=parts)
    want = solver.backward_image(ctx, v2, swf, dobs, gz, next_shot_first=nxt,
                                 lap=lap)
    torch.cuda.synchronize()
    _within((got,), (want,), (IMAGE_GATE,))
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "rec_bwd_step_mma": 3 * ctx.nt}


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", K1_ORDERS)
@pytest.mark.parametrize("grid", K1_GRIDS)
def test_rec_bwd_step_mma_matches_plain_on_the_card(cuda_device, grid,
                                                    order, parts):
    rng = np.random.default_rng(order + 10 * parts + 3)
    _rec_bwd(_ctx(grid, order), rng, cuda_device, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", [8, 16])
def test_rec_bwd_step_mma_on_its_middle_shape(cuda_device, order, parts):
    """8 shots of 360 x 360 extended: 144 blocks of 128 x 64 for the H100's
    132 SMs, 288 of 64 x 64, which the launcher takes."""
    rng = np.random.default_rng(order + 10 * parts + 4)
    _rec_bwd(_ctx((320, 320, 20, 20), order), rng, cuda_device, parts, ns=8)


def _rec_fwd(ctx, rng, device, parts, ns=2):
    """rec_fwd_step_mma over ctx.nt steps (the point source, the top
    taper, the interior frames) against the plain loop with the same split
    z taps, on a random velocity and wavelet, the sources across the owned
    shapes' edges at x = 64 and 128 and the source depth across z = 64;
    one launch a step."""
    v2 = _v2(rng, ctx)[0].to(device)
    wav = rng.standard_normal(ctx.nt).astype(np.float32)
    sxs = ((31, 61) if ctx.nxe < 140 else (61, 126)) if ns == 2 else tuple(
        30 + 40 * i for i in range(ns))
    sz, gz = 63, ctx.nzb + 3
    fk.reset_launches()
    got = fk.forward_modeling_cuda(ctx, v2, wav, sxs, sz, gz, "point", "top",
                                   "wavefield", lap_impl=parts)
    want = solver.forward_modeling(ctx, v2, wav, sxs, sz, gz, "point", "top",
                                   "wavefield", lap_impl=parts)
    torch.cuda.synchronize()
    _within(got, want, REC_GATES)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "rec_fwd_step_mma": ctx.nt}


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", K1_ORDERS)
@pytest.mark.parametrize("grid", K1_GRIDS)
def test_rec_fwd_step_mma_matches_plain_on_the_card(cuda_device, grid,
                                                    order, parts):
    rng = np.random.default_rng(order + 10 * parts + 5)
    _rec_fwd(_ctx(grid, order), rng, cuda_device, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", [8, 16])
def test_rec_fwd_step_mma_on_its_middle_shape(cuda_device, order, parts):
    """8 shots of 360 x 360 extended, where the launcher takes 64 x 64
    (test_rec_bwd_step_mma_on_its_middle_shape)."""
    rng = np.random.default_rng(order + 10 * parts + 6)
    _rec_fwd(_ctx((320, 320, 20, 20), order), rng, cuda_device, parts, ns=8)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", K1_ORDERS)
@pytest.mark.parametrize("grid", K1_GRIDS)
def test_rtm_bwd_step_mma_matches_plain_on_the_card(cuda_device, grid,
                                                    order, parts):
    """rtm_bwd_step_mma over ctx.nt steps, the two seeded steps (the
    snapshots as the source field) included, against the plain backward
    loop with the same split x taps, on grids that are no multiple of its
    owned shape; the receiver row across z = 32; one launch a step."""
    rng = np.random.default_rng(order + 10 * parts + 7)
    ctx = _ctx(grid, order)
    v2 = _v2(rng, ctx).to(cuda_device)
    snap_p, snap_pp = (_f32(rng, 2, ctx.nxe, ctx.nze).to(cuda_device)
                       for _ in range(2))
    dobs = _f32(rng, 2, ctx.nx, ctx.nt).to(cuda_device)
    gz = 31
    fk.reset_launches()
    got = fk._fd_back(ctx, v2, snap_p, snap_pp, dobs, gz, parts)
    want = solver.fd_back(ctx, v2, snap_p, snap_pp, dobs, gz,
                          solver.laplacian_of(ctx, parts))
    torch.cuda.synchronize()
    _within((got,), (want,), (IMAGE_GATE,))
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "rtm_bwd_step_mma": ctx.nt}
