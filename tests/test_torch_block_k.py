"""The block size K the pipelines and the shot-mesh makers choose: the
largest K, up to the JAX package's choice, whose staged tiles fit a
block's shared memory (``fk.smem_bytes``, the launchers' sizes; their C
sources are held against it in ``tests/test_torch_tiled.py``).

* The tiled tier takes ``TILED_BLOCK_K`` = 4, the domain tiers
  ``min(8, (nxe // n_x) // h, (nze // n_z) // h, limit)``; above order 10
  a smaller K where a kernel of the run would refuse that one. At orders
  <= 10 the choice is the JAX package's, exact and split.
* An explicit ``block_k`` whose tile does not fit still raises, naming the
  limit: on the CPU through a stand-in library that refuses as the
  kernels' launchers do.
* On the card (``-m cuda``), ``run_modeling`` and ``run_rtm_gpu`` at
  orders 12 and 16 over an x mesh and an (x, z) mesh of cuda:0 and
  through ``backend="tiled"``, against the per-step tier (1e-5 relative
  RMS, the tiers' contract); and a refused explicit K.

This file imports no JAX (``python -m pytest tests/test_torch_block_k.py
-m cuda --noconftest`` on a GPU machine)."""

import contextlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.models import (
    layered_model)
from parallel_finite_difference_computation_tpu_torch.ops import (
    _build, fd_kernels as fk, stream)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain2d_kernels as d2k, domain_kernels as dk, make_mesh, shots)

ORDERS = (8, 10, 12, 14, 16)
# 3lay's grid (231 x 231 extended): the slabs and tiles of these meshes
# leave the domain K at 8 up to order 16 before the shared-memory limit.
LAY3 = dict(nz=151, nx=151, nt=1001, dz=10.0, dx=10.0, dt=0.001,
            fpeak=30.0, ns=2, sz=0, fsx=0, ds=20, gz=0, nxb=40, nzb=40,
            fac=0.01)
SMALL = dict(nz=24, nx=28, nt=11, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
             ns=2, sz=4, fsx=6, ds=10, gz=1, nxb=8, nzb=8, fac=0.7)
TILED_RTM = ("kstep_gpu_fwd", "kstep_gpu_bwd")
# order: K, exact and split (lap_impl "mxu"), of each tier's run. The exact
# domain kernels take a block of more than 4 steps in two passes, each
# staging the halo of its own steps, so at order 16 the exact K is the JAX
# package's 8 (it was 7 while block_mod and block_fwd staged all K steps
# at once on 32 x 64 owned cells, whose K = 8 tile did not fit). The split
# runs rose to the JAX package's K once their kernels ran strip bodies:
# the tiled RTM from 3, 3, 2 at orders 12, 14, 16 (kstep_gpu_bwd_mma's
# staged tile of seven fields) to 4, the domain RTM from 7, 6, 5
# (block_fwd_mma's one-pass staged tile) to 8, and the domain modeling
# from 7, 6, 5 (block_mod_mma's) to 8.
WANT_TILED = {"mod": {o: (4, 4) for o in ORDERS},
              "rtm": {o: (4, 4) for o in ORDERS}}
WANT_DOMAIN = {"mod": {o: (8, 8) for o in ORDERS},
               "rtm": {o: (8, 8) for o in ORDERS}}
DOMAIN_KERNELS = {"mod": ("block_mod",), "rtm": ("block_fwd", "block_bwd")}


def _ctx(order, cfg=LAY3):
    return solver.FDContext.from_params(tpk.Params(order=order, **cfg))


def _fits(kernels, order, k, parts):
    return all(fk.smem_bytes(n, order, k, parts) <= fk.SMEM_BYTES
               for n in kernels)


@pytest.mark.parametrize("order", ORDERS)
def test_tiled_default_k_fits(order):
    ctx = _ctx(order)
    for run, kernels in (("mod", ("kstep_mod",)), ("rtm", TILED_RTM)):
        for i, lap_impl in enumerate((None, "mxu")):
            parts = fk.lap_parts(lap_impl, ctx)
            k = stream.tiled_block_k(ctx, kernels, lap_impl)
            assert k == WANT_TILED[run][order][i]
            assert _fits(kernels, order, k, parts)
            if k < tpipe.TILED_BLOCK_K:
                assert not _fits(kernels, order, k + 1, parts)
            if order <= 10:
                assert k == tpipe.TILED_BLOCK_K


# The tiled tier's K (modeling, RTM) on 3lay at orders 4-16 under each
# lap_impl, as chosen before kstep_mod and kstep_gpu_fwd ran the forward
# strip body: their tiles shrank, every K = 4 of theirs fit before and
# after. The RTM run's K is kstep_gpu_bwd's or its split twin's: the split
# one took 3 at orders 12 and 14 and 2 at 16 while it staged seven fields
# on 32 x 64 owned cells, and takes the JAX package's 4 on the backward
# strip body (16 x 32 owned cells at order 16).
LAP_IMPLS = (None, "vpu", "mxu", "mxu6", "auto")
TILED_K = {order: {li: (4, 4) for li in LAP_IMPLS}
           for order in range(4, 17, 2)}


@pytest.mark.parametrize("lap_impl", LAP_IMPLS)
@pytest.mark.parametrize("order", sorted(TILED_K))
def test_tiled_k_is_unchanged_by_the_forward_strip_body(order, lap_impl):
    ctx = _ctx(order)
    parts = fk.lap_parts(lap_impl, ctx)
    for kernels, want in zip((("kstep_mod",), TILED_RTM),
                             TILED_K[order][lap_impl]):
        assert stream.tiled_block_k(ctx, kernels, lap_impl) == want
        assert fk.largest_fitting_k(kernels, order, tpipe.TILED_BLOCK_K,
                                    parts) == want


# The domain tiers' K (modeling, RTM) on 3lay at orders 4-16 under each
# lap_impl, on every mesh shape alike: the JAX package's K = 8 everywhere.
# As chosen before block_mod and block_fwd ran the forward strip body in
# passes, it was 8 everywhere but the split kernels' above order 10 and the
# exact order-16 runs, which rose from 7 (the forward kernels' one-pass
# tile refused K = 8) to 8. The split RTM K at orders 12 and 14 rose from 6
# and 5 (block_bwd_mma's one-pass tile) to 7 and 6 once that kernel ran the
# backward strip body in passes, and at orders 12, 14 and 16 from 7, 6 and
# 5 (block_fwd_mma's one-pass tile) to 8 once block_fwd_mma ran the
# forward strip body in passes; the split modeling K at orders 12, 14 and
# 16 rose from 7, 6 and 5 (block_mod_mma's one-pass tile) to 8 once
# block_mod_mma did too.
DOMAIN_K = {order: {li: (8, 8) for li in LAP_IMPLS}
            for order in range(4, 17, 2)}


@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("lap_impl", LAP_IMPLS)
@pytest.mark.parametrize("order", sorted(DOMAIN_K))
def test_domain_k_is_unchanged_by_the_forward_strip_body(order, lap_impl,
                                                         shape):
    ctx = _ctx(order)
    mesh = make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))
    for run, want in zip(("mod", "rtm"), DOMAIN_K[order][lap_impl]):
        assert tpipe._block_k(ctx, mesh, ctx.nt // 2, DOMAIN_KERNELS[run],
                              lap_impl) == want


@pytest.mark.parametrize("k", range(1, stream.MAX_STEPS + 1))
def test_block_pass_split(k):
    """A block kernel's passes on a strip body (the exact ones and their
    split twins): all K steps in one up to 4, else (K + 1) // 2 then K // 2
    (the launches ``LAUNCHES`` counts), and the shared memory of the longer
    pass's tile."""
    passes = fk.block_passes(k)
    assert sum(passes) == k
    assert passes == ((k,) if k <= fk.BLOCK_PASS_STEPS
                      else ((k + 1) // 2, k // 2))
    assert max(passes) <= fk.BLOCK_PASS_STEPS
    for order in (4, 8, 16):
        for name in ("block_mod", "block_fwd", "block2_mod", "block2_fwd",
                     "block_bwd"):
            assert fk.smem_bytes(name, order, k) == fk.smem_bytes(
                name, order, passes[0]) <= fk.SMEM_BYTES
        # 64 x 96 owned cells, the field at two levels and the x ramp
        r = passes[0] * order // 2
        if order == 8:
            assert fk.smem_bytes("block_mod", order, k) == 4 * (
                2 * (64 + 2 * r) * (96 + 2 * r) + 64 + 2 * r)
        # the split twins run the strip bodies in the same passes
        for parts in (2, 3):
            for name in ("block_mod", "block2_mod", "block_fwd", "block2_fwd",
                         "block_bwd", "block2_bwd"):
                assert fk.smem_bytes(name, order, k, parts) == fk.smem_bytes(
                    name, order, passes[0], parts) <= fk.SMEM_BYTES
            # block_mod_mma and block_fwd_mma at order 8: 64 x 64 owned
            # cells, three staged fields (two and the x product) on padded
            # rows, the x ramp
            if order == 8:
                for name in ("block_mod", "block_fwd"):
                    assert fk.smem_bytes(name, order, k, parts) == 4 * (
                        3 * (64 + 2 * r) * ((64 + 2 * r + 3) // 8 * 8 + 4)
                        + 64 + 2 * r)
            # 32 x 64 owned cells, six staged fields (four and the two x
            # products) on rows padded to 4 mod 8 floats, the owned image
            # and the x ramp
            if order == 8:
                assert fk.smem_bytes("block_bwd", order, k, parts) == 4 * (
                    6 * (32 + 2 * r) * ((64 + 2 * r + 3) // 8 * 8 + 4)
                    + 32 * 64 + 32 + 2 * r)


def _stub_launches(monkeypatch):
    """Sends the block wrappers down their CUDA branch with CPU tensors
    into a stand-in entry point: returns the lists that collect each
    ``_scratch`` result (launches, scratch argument, buffer) and each
    entry-point call (name, arguments)."""
    seen, calls = [], []
    real = dk._scratch

    def scratch(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(dk, "_scratch", scratch)
    monkeypatch.setattr(dk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(dk, "_stream", lambda dev: 0)
    monkeypatch.setattr(dk, "_entry", lambda c, name, parts=0: (
        lambda *args: calls.append((name, args)) or 0, (0,)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return seen, calls


@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", range(4, 17, 2))
def test_split_backward_block_takes_passes_and_scratch(monkeypatch, order,
                                                       parts, shape):
    """The launch of ``block_bwd_mma`` (``block2_bwd_mma``): above 4 steps
    two passes, counted as two launches, through a scratch of the four
    fields and the image delta (4·ns·nxw·nzw + ns·nxl·nzl floats) handed
    to the entry point after ``img``; up to 4 steps one launch and a NULL
    scratch. The wrappers' CUDA branch runs on CPU tensors into a stand-in
    entry point that records its arguments."""
    ctx = solver.FDContext.create(150, 80, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=8, nzb=8, fac=0.7)
    kernels = (dk.block_bwd_cuda, dk.LAUNCHES, dk.prepare_tiles,
               dk.slab_geometry) if len(shape) == 2 else (
        d2k.block2_bwd_cuda, d2k.LAUNCHES, d2k.prepare_tiles,
        d2k.tile_geometry)
    kbwd, launches, prep, geometry = kernels
    seen, calls = _stub_launches(monkeypatch)
    rng = np.random.default_rng(order)
    v2 = torch.full((2, ctx.nxe, ctx.nze), 4.0e6)
    d_ext = np.zeros((2, ctx.nxe, ctx.nt), np.float32)
    grid = make_mesh(*shape, devices=["cpu"] * int(np.prod(shape))).grid(0)
    fitting = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            geom = geometry(ctx, *shape[1:], k)
        except ValueError:                    # the halo outgrows the tiles
            break
        fitting += 1
        c = prep(ctx, grid, geom, v2, "top", sxs=(60, 61), sz=10,
                 dobs_ext=d_ext, gz=12)[0]
        f = [torch.from_numpy(rng.standard_normal(
            (2, c.nxw, c.nzw)).astype(np.float32)) for _ in range(4)]
        img = torch.zeros((2, c.nxl, c.nzl))
        for n in launches:
            launches[n] = 0
        seen.clear()
        calls.clear()
        kbwd(c, *f, img, 0, k, parts=parts)
        ((passes, arg, buf),), ((name, args),) = seen, calls
        assert name.endswith("bwd_mma")
        if k > fk.BLOCK_PASS_STEPS:
            assert passes == 2 == len(fk.block_passes(k))
            assert buf.numel() == 4 * 2 * c.nxw * c.nzw + 2 * c.nxl * c.nzl
            assert arg == (buf.data_ptr(),) == args[11:12]
        else:
            assert (passes, arg, buf) == (1, (None,), None)
            assert args[11] is None
        assert args[10] == img.data_ptr()
        assert launches == {n: passes if n == name else 0 for n in launches}
    assert fitting > fk.BLOCK_PASS_STEPS          # two passes seen


@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", range(4, 17, 2))
def test_split_forward_block_takes_passes_and_scratch(monkeypatch, order,
                                                      parts, shape):
    """The launch of ``block_fwd_mma`` (``block2_fwd_mma``): above 4 steps
    two passes, counted as two launches, through a scratch of the two
    fields (2·ns·nxw·nzw floats) handed to the entry point after
    ``pp_out``; up to 4 steps one launch and a NULL scratch. The wrappers'
    CUDA branch runs on CPU tensors into a stand-in entry point that
    records its arguments."""
    ctx = solver.FDContext.create(150, 80, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=8, nzb=8, fac=0.7)
    kernels = (dk.block_fwd_cuda, dk.LAUNCHES, dk.prepare_tiles,
               dk.slab_geometry) if len(shape) == 2 else (
        d2k.block2_fwd_cuda, d2k.LAUNCHES, d2k.prepare_tiles,
        d2k.tile_geometry)
    kfwd, launches, prep, geometry = kernels
    seen, calls = _stub_launches(monkeypatch)
    rng = np.random.default_rng(order)
    v2 = torch.full((2, ctx.nxe, ctx.nze), 4.0e6)
    grid = make_mesh(*shape, devices=["cpu"] * int(np.prod(shape))).grid(0)
    fitting = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            geom = geometry(ctx, *shape[1:], k)
        except ValueError:                    # the halo outgrows the tiles
            break
        fitting += 1
        c = prep(ctx, grid, geom, v2, "top", sxs=(60, 61), sz=10, gz=12)[0]
        f = [torch.from_numpy(rng.standard_normal(
            (2, c.nxw, c.nzw)).astype(np.float32)) for _ in range(2)]
        out = [torch.zeros((2, c.nxw, c.nzw)) for _ in range(2)]
        for n in launches:
            launches[n] = 0
        seen.clear()
        calls.clear()
        kfwd(c, *f, np.ones(k, np.float32), out=out, parts=parts)
        ((passes, arg, buf),), ((name, args),) = seen, calls
        assert name.endswith("fwd_mma")
        assert args[2:4] == tuple(o.data_ptr() for o in out)
        if k > fk.BLOCK_PASS_STEPS:
            assert passes == 2 == len(fk.block_passes(k))
            assert buf.numel() == 2 * 2 * c.nxw * c.nzw
            assert arg == (buf.data_ptr(),) == args[4:5]
        else:
            assert (passes, arg, buf) == (1, (None,), None)
            assert args[4] is None
        assert args[5] == c.v2m.data_ptr()
        assert launches == {n: passes if n == name else 0 for n in launches}
    assert fitting > fk.BLOCK_PASS_STEPS          # two passes seen


@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("order", range(4, 17, 2))
def test_split_modeling_block_takes_passes_and_scratch(monkeypatch, order,
                                                       parts, shape):
    """The launch of ``block_mod_mma`` (``block2_mod_mma``), as of the exact
    kernel: above 4 steps two passes, counted as two launches, through a
    scratch of the two fields (2·ns·nxw·nzw floats) handed to the entry
    point after ``pp_out``; up to 4 steps one launch and a NULL scratch;
    the traces (ns, K, nxl) of both passes in one buffer. The wrappers'
    CUDA branch runs on CPU tensors into a stand-in entry point that
    records its arguments."""
    ctx = solver.FDContext.create(150, 80, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=8, nzb=8, fac=0.7)
    kernels = (dk.block_mod_cuda, dk.LAUNCHES, dk.prepare_tiles,
               dk.slab_geometry) if len(shape) == 2 else (
        d2k.block2_mod_cuda, d2k.LAUNCHES, d2k.prepare_tiles,
        d2k.tile_geometry)
    kmod, launches, prep, geometry = kernels
    seen, calls = _stub_launches(monkeypatch)
    rng = np.random.default_rng(order)
    v2 = torch.full((2, ctx.nxe, ctx.nze), 4.0e6)
    grid = make_mesh(*shape, devices=["cpu"] * int(np.prod(shape))).grid(0)
    fitting = 0
    for k in range(1, stream.MAX_STEPS + 1):
        try:
            geom = geometry(ctx, *shape[1:], k)
        except ValueError:                    # the halo outgrows the tiles
            break
        fitting += 1
        c = prep(ctx, grid, geom, v2, "all", sxs=(60, 61), sz=10,
                 source="gaussian", gz=12)[0]
        f = [torch.from_numpy(rng.standard_normal(
            (2, c.nxw, c.nzw)).astype(np.float32)) for _ in range(2)]
        out = [torch.zeros((2, c.nxw, c.nzw)) for _ in range(2)]
        for n in launches:
            launches[n] = 0
        seen.clear()
        calls.clear()
        p_out, pp_out, rec = kmod(c, *f, np.ones(k, np.float32), out=out,
                                  parts=parts)
        ((passes, arg, buf),), ((name, args),) = seen, calls
        assert name.endswith("mod_mma")
        assert p_out is out[0] and pp_out is out[1]
        assert args[2:4] == tuple(o.data_ptr() for o in out)
        if k > fk.BLOCK_PASS_STEPS:
            assert passes == 2 == len(fk.block_passes(k))
            assert buf.numel() == 2 * 2 * c.nxw * c.nzw
            assert arg == (buf.data_ptr(),) == args[4:5]
        else:
            assert (passes, arg, buf) == (1, (None,), None)
            assert args[4] is None
        assert args[5] == c.v2m.data_ptr()
        assert rec.shape == (2, k, c.nxl) and args[15] == rec.data_ptr()
        assert launches == {n: passes if n == name else 0 for n in launches}
    assert fitting > fk.BLOCK_PASS_STEPS          # two passes seen


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (its ``main`` does
    not run)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("k", range(1, stream.MAX_STEPS + 1))
@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
def test_chip_smoke_counts_block_launches_as_the_wrappers_do(monkeypatch,
                                                             shape, k):
    """``chip_smoke.block_launches``, which the card run holds the main
    path's launch counts to, against the counts of the wrappers
    (``LAUNCHES``, one a pass): each of a tier's six block kernels, exact
    and split, over nt = 2k + max(k - 1, 1) steps in blocks of k and a
    tail on every tile of a mesh of ``shape``, through a stand-in entry
    point."""
    smoke = _chip_smoke()
    nt = 2 * k + max(k - 1, 1)
    ctx = solver.FDContext.create(150, 80, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=8, nxb=8, nzb=8, fac=0.7)
    kmod, kfwd, kbwd, launches, prep, geometry = (
        dk.block_mod_cuda, dk.block_fwd_cuda, dk.block_bwd_cuda,
        dk.LAUNCHES, dk.prepare_tiles, dk.slab_geometry) if len(
        shape) == 2 else (
        d2k.block2_mod_cuda, d2k.block2_fwd_cuda, d2k.block2_bwd_cuda,
        d2k.LAUNCHES, d2k.prepare_tiles, d2k.tile_geometry)
    _stub_launches(monkeypatch)
    v2 = torch.full((2, ctx.nxe, ctx.nze), 4.0e6)
    grid = make_mesh(*shape, devices=["cpu"] * int(np.prod(shape))).grid(0)
    geom = geometry(ctx, *shape[1:], k)
    ms = prep(ctx, grid, geom, v2, "all", sxs=(60, 61), sz=10,
              source="gaussian", gz=12)
    rs = prep(ctx, grid, geom, v2, "top", sxs=(60, 61), sz=10, gz=12,
              dobs_ext=np.zeros((2, ctx.nxe, nt), np.float32))
    for n in launches:
        launches[n] = 0
    for parts in (0, 2):
        for it0 in range(0, nt, k):
            amps = np.ones(min(k, nt - it0), np.float32)
            for cm, cr in zip(ms, rs):
                f = [torch.zeros((2, cm.nxw, cm.nzw)) for _ in range(4)]
                img = torch.zeros((2, cm.nxl, cm.nzl))
                kmod(cm, f[0], f[1], amps, parts=parts)
                kfwd(cr, f[0], f[1], amps, parts=parts)
                kbwd(cr, *f, img, it0, len(amps), parts=parts)
    assert len(launches) == 6
    assert launches == {n: smoke.block_launches(n, nt, k, len(ms))
                        for n in launches}


@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
@pytest.mark.parametrize("order", ORDERS)
def test_domain_default_k_fits(order, shape):
    ctx = _ctx(order)
    mesh = make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))
    h = order // 2
    jax_k = min(8, (ctx.nxe // shape[1]) // h, ctx.nt // 2,
                *((ctx.nze // shape[2]) // h for _ in shape[2:]))
    assert jax_k == 8
    for run, kernels in DOMAIN_KERNELS.items():
        for i, lap_impl in enumerate((None, "mxu")):
            parts = fk.lap_parts(lap_impl, ctx)
            k = tpipe._block_k(ctx, mesh, ctx.nt // 2, kernels, lap_impl)
            assert k == WANT_DOMAIN[run][order][i]
            assert _fits(kernels, order, k, parts)
            if k < jax_k:
                assert not _fits(kernels, order, k + 1, parts)
            if order <= 10:
                assert k == jax_k


def test_domain_k_keeps_the_grid_limit():
    """Where the slab or tile is what bounds K, the JAX package's K stands
    (the small grid: 22 rows a slab at order 12 give K = 3)."""
    ctx = _ctx(12, SMALL)
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    assert tpipe._block_k(ctx, mesh, ctx.nt // 2, DOMAIN_KERNELS["rtm"],
                          None) == 3
    assert tpipe._block_k(ctx, mesh, 1, DOMAIN_KERNELS["rtm"], None) == 1


@pytest.mark.parametrize("order", [8, 12, 16])
def test_pipelines_and_makers_pass_the_fitting_k(monkeypatch, order):
    """``run_modeling``/``run_rtm_gpu`` with ``backend="tiled"`` and the
    shot-mesh makers hand the tiled drivers the chosen K, exact and
    split."""
    seen = []

    def spy(real):
        def call(*a, **kw):
            seen.append(kw["block_k"])
            return real(*a, **kw)
        return call

    for mod in (tpipe, shots):
        monkeypatch.setattr(mod, "forward_modeling_tiled",
                            spy(solver.forward_modeling_tiled))
        monkeypatch.setattr(mod, "rtm_shot_snapshot_tiled",
                            spy(solver.rtm_shot_snapshot_tiled))
    p = tpk.Params(order=order, **SMALL)
    vp = layered_model(p.nx, p.nz)
    for i, lap_impl in enumerate((None, "mxu")):
        want_mod = WANT_TILED["mod"][order][i]
        want_rtm = WANT_TILED["rtm"][order][i]
        for mesh in (None, make_mesh(2, devices=["cpu"] * 2)):
            seen.clear()
            dobs = tpipe.run_modeling(p, vp=vp, device="cpu",
                                      backend="tiled", mesh=mesh,
                                      lap_impl=lap_impl)
            assert seen and set(seen) == {want_mod}
            seen.clear()
            tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, device="cpu",
                              backend="tiled", mesh=mesh, lap_impl=lap_impl)
            assert seen and set(seen) == {want_rtm}


class _RefusingLibrary:
    """Stands in for the kernel library: every entry point refuses its
    launch as a launcher whose tile does not fit does
    (cudaErrorInvalidValue)."""

    def __getattr__(self, name):
        return lambda *args: 1


@contextlib.contextmanager
def _refusing_card():
    saved = [(stream, "_on_cuda", stream._on_cuda),
             (stream, "_stream", stream._stream),
             (_build, "library", _build.library),
             (torch.cuda, "device", torch.cuda.device)]
    try:
        stream._on_cuda = lambda t: True
        stream._stream = lambda dev: 0
        _build.library = lambda: _RefusingLibrary()
        torch.cuda.device = lambda dev: contextlib.nullcontext()
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def test_explicit_k_that_does_not_fit_raises():
    """kstep_gpu_bwd at order 16 and K = 8 (a halo of 64 cells) fits no
    owned shape; the maker's explicit block_k reaches the kernel's
    wrapper, which names the limit."""
    ctx = _ctx(16, SMALL)
    k = 8
    assert fk.smem_bytes("kstep_gpu_bwd", 16, k) > fk.SMEM_BYTES
    rng = np.random.default_rng(0)
    f = [torch.from_numpy(rng.standard_normal((2, ctx.nxe, ctx.nze)).astype(
        np.float32)) for _ in range(4)]
    img = torch.zeros((2, ctx.nx, ctx.nz))
    v2 = torch.full((2, ctx.nxe, ctx.nze), 2000.0 ** 2)
    inj = torch.zeros((2, k, ctx.nx))
    with _refusing_card():
        with pytest.raises(ValueError, match=f"{fk.SMEM_BYTES} bytes"):
            stream.fd_back_kstep_cuda(ctx, *f, img, v2, inj, 1)
    # the CPU runs any K: no shared memory to fit
    out = stream.fd_back_kstep_cuda(ctx, *f, img, v2, inj, 1)
    assert all(torch.isfinite(o).all() for o in out)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [12, 16])
def test_orders_above_10_run_on_the_card(cuda_device, order):
    """3lay (2 shots, nt = 1001) at order 12 or 16: the x tier over a
    (1, 2) mesh and the (x, z) tier over a (1, 2, 2) mesh of cuda:0, and
    the tiled tier, against the per-step tier: gathers and images within
    1e-5 relative RMS."""
    p = tpk.Params(order=order, **LAY3)
    vp = layered_model(p.nx, p.nz)
    dobs = tpipe.run_modeling(p, vp=vp, backend="pallas")
    img, _ = tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, backend="pallas")
    runs = {"tiled": dict(backend="tiled")}
    for shape in ((1, 2), (1, 2, 2)):
        runs[str(shape)] = dict(mesh=make_mesh(
            *shape, devices=[cuda_device] * int(np.prod(shape))))
    for label, kw in runs.items():
        got = tpipe.run_modeling(p, vp=vp, **kw)
        assert _rel_rms(got, dobs) <= 1e-5, label
        got_img, _ = tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, **kw)
        assert _rel_rms(got_img, img) <= 1e-5, label


@pytest.mark.cuda
def test_explicit_k_that_does_not_fit_raises_on_the_card(cuda_device):
    ctx = _ctx(16, SMALL)
    p = tpk.Params(order=16, **SMALL)
    mesh = make_mesh(1, devices=[cuda_device])
    run = shots.make_sharded_rtm_tiled(ctx, mesh, p.sz, p.gz, block_k=8)
    v2 = torch.full((2, ctx.nxe, ctx.nze), 2000.0 ** 2)
    dobs = torch.zeros((2, ctx.nx, ctx.nt))
    with pytest.raises(ValueError, match=f"{fk.SMEM_BYTES} bytes"):
        run(v2, dobs, (6, 16), np.ones(ctx.nt, np.float32))
