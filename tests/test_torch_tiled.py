"""The large-grid tier of the port against the JAX package, on the CPU.

* The taper rebuilt from its 1-D ramps is bitwise the mask plane at the
  3lay and Pluto shapes, so the K-step kernels need not read the plane.
* Each plain pass (``mod_kstep``, ``fd_forward_kstep``, ``fd_back_kstep``,
  ``fd_step_gpu``) against the Pallas kernel it stands for
  (``fd_kstep_padded``, ``fd_kstep_gpu_fwd_padded``,
  ``fd_kstep_gpu_bwd_padded``, ``fd_step_gpu_padded``) in interpret mode,
  one pass from a random state; the layout goes through the JAX package's
  own ``to_padded``/``from_padded``.
* The tiled loops, batched over two shots, against the JAX tiled loops
  (interpret mode, nt % K != 0) and the JAX lax path; and bitwise against
  the port's whole-grid plain loops, which run the same step bodies.
* The routing rule, the shot batching, and the slice as a whole
  (``run_modeling`` then ``run_rtm_gpu`` with ``backend="tiled"``).

Tolerance: ``max|port - jax| <= 1e-5 * max|jax|``: the JAX package's
contract between its tiers (``ops/pallas_stream.py:52-59``); the port
injects before the taper and sums the image in time order, the TPU kernels
do neither, and XLA contracts some multiply-adds. The kernels themselves
are held against these plain versions on the card (``cuda``-marked tests
of ``tests/test_torch_kernels.py``, and ``chip_smoke.py``)."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.ops.pallas_stream import (
    fd_kstep_gpu_bwd_padded, fd_kstep_gpu_fwd_padded, fd_kstep_padded,
    fd_step_gpu_padded, from_padded, injection_window,
    mask_ramps as j_mask_ramps, padded_layout, separable_mask_operands,
    to_padded)
from parallel_finite_difference_computation_tpu.ops.stencil import (
    lap_interior_mask)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext, forward_modeling as j_forward_modeling,
    forward_modeling_tiled as j_forward_modeling_tiled,
    rtm_shot_snapshot as j_rtm_shot_snapshot,
    rtm_shot_snapshot_tiled as j_rtm_shot_snapshot_tiled)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli as tcli, io as tio, numerics as tnum, pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)

GATE = 1e-5
TR = 16                      # tile_rows of the JAX streaming kernels


def assert_close(got, want):
    """``max|got - want| <= 1e-5 * max|want|``."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GATE * np.abs(want).max()


def _ctxs(order=8, nt=13, exact=True, nx=30, nz=40, nxb=6, nzb=5):
    jctx = JaxContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                             order=order, nxb=nxb, nzb=nzb, fac=0.7,
                             exact_taper=exact)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    return jctx, ctx


def _field(rng, ctx, ns=None):
    shape = (ctx.nxe, ctx.nze) if ns is None else (ns, ctx.nxe, ctx.nze)
    return rng.standard_normal(shape).astype(np.float32)


def _velocity(rng, ctx, ns=None):
    shape = (ctx.nxe, ctx.nze) if ns is None else (ns, ctx.nxe, ctx.nze)
    return ((1500.0 + 500.0 * rng.random(shape)).astype(np.float32)) ** 2


def _pad(a, ctx):
    return to_padded(jnp.asarray(a), ctx.order, TR)


def _unpad(a, ctx):
    return np.asarray(from_padded(a, ctx.nxe, ctx.nze, ctx.order, TR))


def _v2m(ctx, v2):
    """The JAX K-step kernels' ``v2 * dt2`` operand, premasked by the
    Laplacian interior."""
    return _pad(v2 * np.float32(ctx.dt2)
                * lap_interior_mask(ctx.nxe, ctx.nze, ctx.order), ctx)


# ------------------------------------------------------------ mask ramps

def _mask_from_ramps(xramp, zfac, strip):
    """The mask as the K-step kernels rebuild it (``csrc/kstep.cuh``,
    ``taper_at``): ``zfac[z] * (xramp[x] if strip[z] else 1)``, one float32
    multiply a cell."""
    sel = np.where(strip[None, :] != 0, xramp[:, None], np.float32(1.0))
    return (zfac[None, :] * sel.astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("shape", ["3lay", "pluto"])
@pytest.mark.parametrize("exact", [True, False])
def test_mask_from_ramps_is_bitwise_the_mask(shape, exact):
    nx, nz, fac = (151, 151, 0.01) if shape == "3lay" else (6960, 1201, 0.75)
    ctx = solver.FDContext.create(nx, nz, 1, dx=10.0, dz=10.0, dt=0.001,
                                  nxb=40, nzb=40, fac=fac, exact_taper=exact)
    for kind, mask in (("all", ctx.mask_all), ("top", ctx.mask_top)):
        ramps = tnum.mask_ramps(ctx.mask_all, ctx.mask_top, kind, ctx.nzb)
        for a, b in zip(ramps, j_mask_ramps(ctx.mask_all, ctx.mask_top, kind,
                                            ctx.nzb)):
            np.testing.assert_array_equal(a, b)
        rebuilt = _mask_from_ramps(*ramps)
        assert rebuilt.dtype == np.float32
        assert rebuilt.tobytes() == mask.tobytes()


# ------------------------------------------------ one pass against Pallas

@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_mod_kstep_matches_pallas(order, k):
    jctx, ctx = _ctxs(order, exact=False)
    rng = np.random.default_rng(10 * order + k)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _velocity(rng, ctx)
    amps = rng.standard_normal(k).astype(np.float32)
    sx, sz, gz = ctx.nxb + 10, ctx.nzb + 3, ctx.nzb + 1
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, TR)
    patch = jnp.asarray(ctx.source_patch)
    inj48, win0 = injection_window(patch, row0 + sx - 3, col0 + sz - 3,
                                   ctx.nxe, ctx.nze, order, TR,
                                   mask_pad=_pad(ctx.mask_all, ctx))
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "all", ctx.nzb), order, TR)
    jp, jpp, jrec = fd_kstep_padded(
        _pad(p, ctx), _pad(pp, ctx), _v2m(ctx, v2), mrow, mzp, inj48, win0,
        jnp.asarray(amps), col0 + gz, ctx.coefs_x, ctx.coefs_z, order,
        ctx.nxe, ctx.nze, k, TR, interpret=True)
    tp, tpp, trec = solver.mod_kstep(ctx, torch.from_numpy(p[None]),
                                     torch.from_numpy(pp[None]),
                                     torch.from_numpy(v2), amps, [sx], sz, gz)
    assert_close(tp[0], _unpad(jp, ctx))
    assert_close(tpp[0], _unpad(jpp, ctx))
    rows = np.asarray(jrec)[row0 + ctx.nxb:row0 + ctx.nxb + ctx.nx, :k]
    assert_close(trec[0], rows.T)


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_fd_forward_kstep_matches_pallas(order, k):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(20 * order + k)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _velocity(rng, ctx)
    amps = rng.standard_normal(k).astype(np.float32)
    sx, sz = ctx.nxb + 9, ctx.nzb + 2
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, TR)
    point48, win0 = injection_window(jnp.ones((1, 1), jnp.float32),
                                     row0 + sx, col0 + sz, ctx.nxe, ctx.nze,
                                     order, TR)
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "top", ctx.nzb), order, TR)
    jp, jpp = fd_kstep_gpu_fwd_padded(
        _pad(p, ctx), _pad(pp, ctx), _v2m(ctx, v2), mrow, mzp, point48, win0,
        jnp.asarray(amps), ctx.coefs_x, ctx.coefs_z, order, ctx.nxe, ctx.nze,
        k, TR, interpret=True)
    tp, tpp = solver.fd_forward_kstep(ctx, torch.from_numpy(p[None]),
                                      torch.from_numpy(pp[None]),
                                      torch.from_numpy(v2), amps, [sx], sz)
    assert_close(tp[0], _unpad(jp, ctx))
    assert_close(tpp[0], _unpad(jpp, ctx))


def _image_ext(ctx, img):
    ext = np.zeros((ctx.nxe, ctx.nze), np.float32)
    ext[ctx.nxb:ctx.nxb + ctx.nx, ctx.nzb:ctx.nzb + ctx.nz] = img
    return ext


def _image(ctx, ext):
    return ext[ctx.nxb:ctx.nxb + ctx.nx, ctx.nzb:ctx.nzb + ctx.nz]


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_fd_back_kstep_matches_pallas(order, k):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(30 * order + k)
    fields = [_field(rng, ctx) for _ in range(4)]
    v2 = _velocity(rng, ctx)
    img = rng.standard_normal((ctx.nx, ctx.nz)).astype(np.float32)
    inj = rng.standard_normal((k, ctx.nx)).astype(np.float32)
    gz = ctx.nzb + 1
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, TR)
    sism = np.zeros((R, 128), np.float32)
    sism[row0 + ctx.nxb:row0 + ctx.nxb + ctx.nx, :k] = inj.T
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "top", ctx.nzb), order, TR)
    jout = fd_kstep_gpu_bwd_padded(
        *(_pad(f, ctx) for f in fields), _v2m(ctx, v2), mrow, mzp,
        jnp.asarray(sism), _pad(_image_ext(ctx, img), ctx), col0 + gz,
        ctx.coefs_x, ctx.coefs_z, order, ctx.nxe, ctx.nze, ctx.nzb, ctx.nz,
        ctx.nxb, ctx.nx, k, TR, interpret=True)
    tout = solver.fd_back_kstep(
        ctx, *(torch.from_numpy(f[None]) for f in fields),
        torch.from_numpy(img[None]), torch.from_numpy(v2),
        torch.from_numpy(inj[None]), gz)
    for t, j in zip(tout[:4], jout[:4]):
        assert_close(t[0], _unpad(j, ctx))
    assert_close(tout[4][0], _image(ctx, _unpad(jout[4], ctx)))


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("imaging", [True, False])
def test_fd_step_gpu_matches_pallas(order, imaging):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(40 + order)
    y, x, src = _field(rng, ctx), _field(rng, ctx), _field(rng, ctx)
    v2 = _velocity(rng, ctx)
    img = rng.standard_normal((ctx.nx, ctx.nz)).astype(np.float32)
    row = rng.standard_normal(ctx.nx).astype(np.float32)
    gz = ctx.nzb + 1
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, TR)
    kw = dict(nxb=ctx.nxb, nzb=ctx.nzb, nx=ctx.nx, nz=ctx.nz, gz=gz,
              tile_rows=TR, interpret=True)
    targs = (ctx, torch.from_numpy(y[None]), torch.from_numpy(x[None]),
             torch.from_numpy(v2))
    if imaging:
        scol = np.zeros((R, 128), np.float32)
        scol[row0 + ctx.nxb:row0 + ctx.nxb + ctx.nx, 0] = row
        kw.update(sism_col=jnp.asarray(scol),
                  imloc_pad=_pad(_image_ext(ctx, img), ctx),
                  imsrc_pad=_pad(src, ctx))
        tout = solver.fd_step_gpu(*targs, gz, torch.from_numpy(row[None]),
                                  torch.from_numpy(img[None]),
                                  torch.from_numpy(src[None]))
    else:
        tout = solver.fd_step_gpu(*targs)
    jout = fd_step_gpu_padded(_pad(y, ctx), _pad(x, ctx), _pad(v2, ctx),
                              _pad(ctx.mask_top, ctx), ctx.coefs_x,
                              ctx.coefs_z, order, ctx.nxe, ctx.nze, ctx.dt2,
                              **kw)
    assert len(tout) == len(jout) == (3 if imaging else 2)
    assert_close(tout[0][0], _unpad(jout[0], ctx))
    assert_close(tout[1][0], _unpad(jout[1], ctx))
    if imaging:
        assert_close(tout[2][0], _image(ctx, _unpad(jout[2], ctx)))


# -------------------------------------------------------- the tiled loops

def _shots(ctx):
    return (ctx.nxb + 9, ctx.nxb + 17), ctx.nzb + 2, ctx.nzb + 1


@pytest.mark.parametrize("block_k", [2, 3])
def test_forward_modeling_tiled_matches_jax(block_k):
    jctx, ctx = _ctxs(exact=False)
    rng = np.random.default_rng(50 + block_k)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 30.0)
    sxs, sz, gz = _shots(ctx)
    got = solver.forward_modeling_tiled(ctx, torch.from_numpy(v2), wav, sxs,
                                        sz, gz, block_k=block_k)
    assert got[2].shape == (2, ctx.nt, ctx.nx)
    for s, sx in enumerate(sxs):
        tiled = j_forward_modeling_tiled(jctx, jnp.asarray(v2),
                                         jnp.asarray(wav), sx, sz, gz,
                                         tile_rows=TR, interpret=True,
                                         block_k=block_k)
        lax = j_forward_modeling(jctx, jnp.asarray(v2), jnp.asarray(wav), sx,
                                 sz, gz)
        for a, b, c in zip(got, tiled, lax):
            assert_close(a[s], b)
            assert_close(a[s], c)


@pytest.mark.parametrize("block_k", [2, 3])
def test_rtm_shot_snapshot_tiled_matches_jax(block_k):
    jctx, ctx = _ctxs()
    rng = np.random.default_rng(60 + block_k)
    v2 = _velocity(rng, ctx, ns=2)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 30.0)
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    sxs, sz, gz = _shots(ctx)
    got = solver.rtm_shot_snapshot_tiled(ctx, torch.from_numpy(v2), wav,
                                         torch.from_numpy(dobs), sxs, sz, gz,
                                         block_k=block_k)
    for s, sx in enumerate(sxs):
        args = (jnp.asarray(v2[s]), jnp.asarray(wav), jnp.asarray(dobs[s]),
                sx, sz, gz)
        assert_close(got[s], j_rtm_shot_snapshot_tiled(
            jctx, *args, tile_rows=TR, interpret=True, block_k=block_k))
        assert_close(got[s], j_rtm_shot_snapshot(jctx, *args))


@pytest.mark.parametrize("nt,block_k", [(13, 2), (13, 3), (13, 4), (8, 4),
                                        (3, 4), (2, 4), (1, 4)])
def test_tiled_plain_path_is_bitwise_the_whole_grid_path(nt, block_k):
    _, ctx = _ctxs(nt=nt)
    rng = np.random.default_rng(nt + block_k)
    v2 = torch.from_numpy(_velocity(rng, ctx, ns=2))
    wav = jnum.ricker_wavelet(nt, 0.001, 30.0)
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32))
    sxs, sz, gz = _shots(ctx)
    got = solver.forward_modeling_tiled(ctx, v2[0], wav, sxs, sz, gz,
                                        block_k=block_k)
    want = solver.forward_modeling(ctx, v2[0], wav, sxs, sz, gz)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(
        solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, sxs, sz, gz,
                                       block_k=block_k),
        solver.rtm_shot_snapshot(ctx, v2, wav, dobs, sxs, sz, gz))


# ------------------------------------------------ routing and the wrappers

def test_auto_takes_the_tiled_tier_above_1_5_mcell():
    assert tpipe.resolve_backend("auto", 1500, 1000) == "pallas"
    assert tpipe.resolve_backend("auto", 1500001, 1) == "tiled"
    assert tpipe.resolve_backend("auto", 231, 231) == "pallas"     # 3lay
    assert tpipe.resolve_backend("auto", 7040, 1281) == "tiled"    # Pluto
    for b in ("pallas", "tiled"):
        assert tpipe.resolve_backend(b, 7040, 1281) == b
        assert tpipe.resolve_backend(b, 231, 231) == b


def test_unknown_backend_and_block_k_raise():
    _, ctx = _ctxs(nt=4)
    v2 = torch.from_numpy(_velocity(np.random.default_rng(0), ctx))
    wav = jnum.ricker_wavelet(4, 0.001, 30.0)
    sxs, sz, gz = _shots(ctx)
    with pytest.raises(ValueError, match="backend"):
        tpipe.resolve_backend("lax", 10, 10)
    p = tpk.Params(nz=12, nx=14, nt=4, dz=10.0, dx=10.0, dt=0.001,
                   fpeak=25.0, ns=1, sz=3, fsx=4, gz=1, nxb=5, nzb=5)
    with pytest.raises(ValueError, match="backend"):
        tpipe.run_modeling(p, vp=np.full((14, 12), 2000.0, np.float32),
                           device="cpu", backend="lax")
    for fn, args in ((solver.forward_modeling_tiled, (wav, sxs, sz, gz)),
                     (solver.rtm_shot_snapshot_tiled,
                      (wav, torch.zeros((2, ctx.nx, 4)), sxs, sz, gz))):
        fn(ctx, v2, *args, block_k=1)      # the per-step streaming tier
        for bad in (0, 9):
            with pytest.raises(ValueError, match="block_k"):
                fn(ctx, v2, *args, block_k=bad)


def test_wrappers_on_cpu_are_the_plain_passes_and_count_nothing():
    _, ctx = _ctxs(nt=4)
    rng = np.random.default_rng(2)
    v2 = torch.from_numpy(_velocity(rng, ctx))
    p, pp, pr, ppr = (torch.from_numpy(_field(rng, ctx, ns=2))
                      for _ in range(4))
    img = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, ctx.nz)).astype(np.float32))
    inj = torch.from_numpy(rng.standard_normal(
        (2, 3, ctx.nx)).astype(np.float32))
    amps = np.float32([0.5, -1.0, 2.0])
    sxs, sz, gz = _shots(ctx)
    stream.reset_launches()
    pairs = [
        (stream.mod_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz, gz),
         solver.mod_kstep(ctx, p, pp, v2, amps, sxs, sz, gz)),
        (stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz),
         solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz)),
        (stream.fd_back_kstep_cuda(ctx, p, pp, pr, ppr, img, v2, inj, gz),
         solver.fd_back_kstep(ctx, p, pp, pr, ppr, img, v2, inj, gz)),
        (stream.fd_step_gpu_cuda(ctx, pr, ppr, v2, gz, inj[:, 0].contiguous(),
                                 img, p),
         solver.fd_step_gpu(ctx, pr, ppr, v2, gz, inj[:, 0], img, p))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert stream.LAUNCHES == {"fd_step": 0, "fd_update": 0,
                               "kstep_mod": 0, "kstep_gpu_fwd": 0,
                               "kstep_gpu_bwd": 0, "gpu_step": 0,
                               "kstep_mod_mma": 0, "kstep_gpu_fwd_mma": 0,
                               "kstep_gpu_bwd_mma": 0, "gpu_step_mma": 0,
                               "fd_step_mma": 0, "fd_update_mma": 0}


@pytest.mark.parametrize("bad", ["amps", "shape", "dtype", "rows", "gz",
                                 "window", "img"])
def test_wrappers_raise_on_bad_inputs(bad):
    _, ctx = _ctxs(nt=4)
    rng = np.random.default_rng(3)
    v2 = torch.from_numpy(_velocity(rng, ctx))
    p, pp = (torch.from_numpy(_field(rng, ctx, ns=2)) for _ in range(2))
    img = torch.zeros((2, ctx.nx, ctx.nz))
    inj = torch.zeros((2, 2, ctx.nx))
    amps = np.float32([1.0, 2.0])
    (sx0, sx1), sz, gz = _shots(ctx)
    sxs = [sx0, sx1]
    if bad == "amps":
        amps = np.zeros(9, np.float32)
    elif bad == "shape":
        pp = pp[:, 1:]
    elif bad == "dtype":
        p = p.double()
    elif bad == "rows":
        inj = torch.zeros((2, ctx.nx, 2)).transpose(1, 2)
    elif bad == "gz":
        gz = ctx.nze
    elif bad == "window":
        sxs = [1, sx1]
    elif bad == "img":
        img = img[:, 1:]
    with pytest.raises((TypeError, ValueError)):
        stream.mod_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz, gz)
        stream.fd_back_kstep_cuda(ctx, p, pp, p, pp, img, v2, inj, gz)
    if bad in ("rows", "img"):
        with pytest.raises(ValueError):
            stream.fd_back_kstep_cuda(ctx, p, pp, p, pp, img, v2, inj, gz)


def _rec_shapes():
    """rec_bwd_step_mma's owned shapes (kRecShapes, csrc/rec_step.cu)."""
    text = (pathlib.Path(stream.__file__).parents[1] / "csrc"
            / "rec_step.cu").read_text()
    return [(int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}",
            re.search(r"kRecShapes\[\] = \{(.*?)\};", text, re.S)[1])]


def _rec_shape(ns, nxe, nze, h, sms):
    """The launcher's choice (strip_shape_for_grid, csrc/step_strip.cuh):
    the first of kRecShapes that fits a block (at a halo of h) whose grid
    over ns shots gives each of sms SMs at least kStripBlocks blocks, else
    the last that fits; with the launch's blocks."""
    body = fk._Strip(tuple(_rec_shapes()), 2, False, True)
    last = None
    for tx, tz in body.shapes:
        if fk._strip_bytes((tx, tz), h, body) > fk.SMEM_BYTES:
            continue
        blocks = ns * -(-nxe // tx) * -(-nze // tz)
        if blocks >= 2 * sms:
            return (tx, tz), blocks
        last = (tx, tz), blocks
    return last


def test_rec_shape_fills_the_card():
    """rec_bwd_step_mma's launcher picks its owned shape by the grid, so
    that 3lay (8 shots of 231 x 231 extended: 64 blocks of 128 x 64 for an
    H100's 132 SMs) fills the card: the rule as step_strip.cuh writes it,
    mirrored; at least 132 blocks at 3lay at every order, and the largest
    shape, 128 x 64, on the Pluto rtm_main path (2 shots of 7040 x 1281
    extended, chip_smoke.py phase 30)."""
    csrc = pathlib.Path(stream.__file__).parents[1] / "csrc"
    step = " ".join((csrc / "step_strip.cuh").read_text().split())
    assert ("if (strip_bytes(s, g, r) > static_cast<size_t>(kMaxSmemBytes)) "
            "continue; const dim3 grid = strip_grid(s, ns, nx, nz); if "
            "(static_cast<long long>(grid.x) * grid.y * grid.z >= "
            "static_cast<long long>(kStripBlocks) * sms) { return s; } "
            "last = s;") in step
    assert re.search(r"constexpr int kStripBlocks = 2;",
                     (csrc / "strip.cuh").read_text())
    shapes = _rec_shapes()
    assert shapes[0] == (128, 64)
    assert shapes == sorted(shapes, key=lambda s: -s[0] * s[1])
    for order in range(4, fk.MAX_ORDER + 1, 2):
        h = order // 2
        shape, blocks = _rec_shape(8, 231, 231, h, 132)
        assert blocks >= 132, (order, shape, blocks)
        assert _rec_shape(8, 231, 231, h, 132)[0] != (128, 64)
        assert _rec_shape(2, 7040, 1281, h, 132) == ((128, 64), 2310)
    # a card of fewer SMs (or a larger batch) keeps the largest shape
    assert _rec_shape(8, 231, 231, 4, 32)[0] == (128, 64)



def test_rec_fwd_step_mma_takes_the_rec_shapes():
    """rec_fwd_step_mma runs the one-step body through a site of its own
    (RecFwdSite: no taper, three operands a cell) and launches on the shape
    the rec kernels' rule picks (rec_shape, mirrored by _rec_shape): 8
    shots of 3lay (231 x 231 extended) on 32 x 64 owned cells, 256 blocks
    for an H100's 132 SMs, and the Pluto rtm_main path (2 shots of 7040 x
    1281) on 128 x 64."""
    csrc = pathlib.Path(stream.__file__).parents[1] / "csrc"
    text = " ".join((csrc / "rec_step.cu").read_text().split())
    site = text[text.index("struct RecFwdSite {"):
                text.index("struct RecBwdSite {")
                if "struct RecBwdSite {" in text else None]
    for piece in ("static constexpr bool kTaper = false;",
                  "static constexpr bool kGpu = false;",
                  "struct Cell { float old, v, m; };",
                  "pfdc::step_strip<H, P>(smem, site, t, c);"):
        assert piece in site, piece
    run = text[text.index("struct RecFwdRun {"):text.index("struct RecBwdRun")]
    assert "rec_shape<H>(rec_fwd_step_mma<H, P>, ns, nxe, nze" in run
    assert "pfdc::strip_grid(shape, ns, nxe, nze);" in run
    assert "const dim3 block(pfdc::kStripThreads);" in run
    for order in (8, 16):
        assert _rec_shape(8, 231, 231, order // 2, 132) == ((32, 64), 256)
        assert _rec_shape(2, 7040, 1281, order // 2, 132) == ((128, 64),
                                                              2310)

def test_shared_memory_of_the_kernels():
    """The staging kernels' tiles, as their C sources size them, against
    the wrappers' mirror (``fk.smem_bytes``, which the pipelines' K choice
    reads): every staging kernel runs a strip body, on the first of its
    owned shapes that fits: kstep_mod, kstep_gpu_fwd, block_mod and
    block_fwd on fwd_strip.cuh's (the field at two time levels and the x
    ramp; the block kernels a shape list of their own), their split twins
    on the K-step kernels' shapes with the z product (kstep_mod_mma,
    kstep_gpu_fwd_mma) or the x product (block_mod_mma, block_fwd_mma)
    staged too, on padded rows;
    kstep_gpu_bwd and block_bwd on bwd_strip.cuh's (four staged fields,
    the owned image and the x ramp), kstep_gpu_bwd_mma and block_bwd_mma
    (the two z or x products staged too, on padded rows), the block kernels
    staging the steps of the longer of their passes; fd_step_mma,
    fd_update_mma, gpu_step_mma, rec_fwd_step_mma and rec_bwd_step_mma on
    step_strip.cuh's (the field and its z product, on padded rows, at a
    halo of H; the rec kernels on a shape list of their own, chosen by the
    grid); mma_tile.cuh's staged tile is gone; the three kernels of
    step_mma.cu stage one (mod_step_mma), two (rtm_fwd_step_mma) and three
    fields (rtm_bwd_step_mma) on padded rows into dynamic shared memory on
    one tile description, which fits at every even order 4-16, and the
    static tile they staged before is gone. Which (kernel, order,
    K) the card refuses up to order 16, and that every tile fits at the
    pipelines' K up to order 10; the wrappers' step limit is the
    kernels'."""
    csrc = pathlib.Path(stream.__file__).parents[1] / "csrc"
    const = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", (csrc / "kstep.cuh").read_text())}
    assert stream.MAX_STEPS == const["kMaxSteps"]
    limit = const["kMaxSmemBytes"]
    assert limit == fk.SMEM_BYTES
    # the staged-tile body of kstep.cuh is gone: no source defines or
    # calls its pieces
    # (lap_padded.cu has a Tile of its own)
    for src in csrc.iterdir():
        text = src.read_text()
        for gone in ("kTileThreads", "pfdc::Tile", "for_cells", "load_tile",
                     "store_tile", "z_band", "tile_lap", "kSplitFields",
                     "tile_cells", "tile_block"):
            assert not re.search(rf"\b{gone}\b", text), (src.name, gone)
    assert not re.search(r"\b(struct Tile|kTileX|kTileZ)\b",
                         (csrc / "kstep.cuh").read_text())

    # the strip bodies' shapes and stages (csrc/bwd_strip.cuh,
    # csrc/fwd_strip.cuh) and their bytes (csrc/strip.cuh), a padded
    # stage's rows at the next pitch of 4 mod 8 floats
    strip_h = " ".join((csrc / "strip.cuh").read_text().split())
    assert strip_h.count(
        "sizeof(float) * (g.fields * sx * pitch + (g.image ? "
        "static_cast<size_t>(s.tx) * s.tz : 0) + sx)") == 1
    assert strip_h.count("const size_t pitch = strip_pitch(s.tz + 2 * r, "
                         "g.padded);") == 1
    assert strip_h.count("return padded ? (sz + 3) / 8 * 8 + 4 : sz;") == 1

    def body(name, shapes_of=None, stage_of=None):
        """The shape list k{shapes_of}Shapes and the stage k{stage_of}Stage
        (by default the body's own) of the strip body ``name``."""
        text = (csrc / f"{name.lower()}_strip.cuh").read_text()
        shapes = [(int(a), int(b)) for a, b in re.findall(
            r"\{(\d+), (\d+)\}", re.search(
                rf"\bk{shapes_of or name}Shapes\[\] = \{{(.*?)\}};", text,
                re.S)[1])]
        fields, image, padded = re.search(
            rf"StripStage k{stage_of or name}Stage\{{(\d), (true|false)"
            rf"(?:, (true|false))?\}};", text).groups()
        return shapes, int(fields), image == "true", padded == "true"

    # the forward body's block kernels take a shape list of their own, its
    # split instances (K-step and block) a stage of their own on the
    # K-step kernels' shapes; the backward body's split instances a stage,
    # and kstep_gpu_bwd_mma a shape list of its own
    bodies = {"Bwd": body("Bwd"), "Fwd": body("Fwd"),
              "BlockFwd": body("Fwd", "BlockFwd"),
              "FwdMma": body("Fwd", stage_of="FwdMma"),
              "BwdMma": body("Bwd", stage_of="BwdMma"),
              "BwdZMma": body("Bwd", "BwdZMma", "BwdMma")}
    assert bodies == {
        "Bwd": ([(32, 64), (32, 32), (16, 32), (16, 16)], 4, True, False),
        "BwdMma": ([(32, 64), (32, 32), (16, 32), (16, 16)], 6, True, True),
        "BwdZMma": ([(32, 96), (32, 64), (32, 32), (16, 32), (16, 16)], 6,
                    True, True),
        "Fwd": ([(64, 64), (32, 64), (32, 32), (16, 32), (16, 16)], 2,
                False, False),
        "BlockFwd": ([(64, 96), (64, 64), (32, 64), (32, 32), (16, 32),
                      (16, 16)], 2, False, False),
        "FwdMma": ([(64, 64), (32, 64), (32, 32), (16, 32), (16, 16)], 3,
                   False, True)}

    def strip_smem(name, order, k):
        """strip_shape of the body ``name``: the first shape that fits;
        the smallest's bytes where none does."""
        shapes, fields, image, padded = bodies[name]
        r = k * (order // 2)
        pitch = ((lambda sz: (sz + 3) // 8 * 8 + 4) if padded
                 else (lambda sz: sz))
        sizes = [4 * (fields * (a + 2 * r) * pitch(b + 2 * r)
                      + (a * b if image else 0) + a + 2 * r)
                 for a, b in shapes]
        return next((n for n in sizes if n <= limit), sizes[-1])

    def smem(kernel, order, k):
        """Bytes of a block of ``kernel`` (``*_mma``: its split variant,
        P > 0 in the same source), from its launcher."""
        src = (csrc / f"{kernel.removesuffix('_mma')}.cu").read_text()
        # one launcher for every P, the stage of its P = 0 or P > 0
        # instances (the split one: kernel_mma); kstep_gpu_bwd_mma on
        # shapes of its own
        name = "Bwd" if kernel.startswith("kstep_gpu_bwd") else "Fwd"
        shapes = (rf"P \? pfdc::strip_shape\(pfdc::kBwdZMmaShapes, stage, "
                  rf"k \* H\)\s*: pfdc::strip_shape\(pfdc::kBwdShapes, "
                  rf"stage, k \* H\);" if name == "Bwd" else
                  rf"pfdc::strip_shape\(pfdc::kFwdShapes, stage, k \* H\);")
        assert re.search(
            rf"const pfdc::StripStage stage = P \? pfdc::k{name}MmaStage : "
            rf"pfdc::k{name}Stage;\s*const pfdc::StripShape shape =\s*"
            rf"{shapes}\s*if \(shape\.tx == 0\) return "
            rf"cudaErrorInvalidValue;\s*const size_t bytes = pfdc::"
            rf"strip_bytes\(shape, stage, k \* H\);", src), kernel
        if not kernel.endswith("_mma"):
            return strip_smem(name, order, k)
        return strip_smem("BwdZMma" if name == "Bwd" else "FwdMma", order, k)

    # order 8, K = 4: (32 + 32) x (64 + 32) cells a field, (64 + 32)^2 on
    # the forward body's 64 x 64 owned cells
    assert smem("kstep_mod", 8, 4) == 4 * (2 * 96 * 96 + 96)
    assert smem("kstep_gpu_fwd", 8, 4) == 4 * (2 * 96 * 96 + 96)
    assert smem("kstep_gpu_bwd", 8, 4) == 4 * (4 * 64 * 96 + 32 * 64 + 64)
    # the split forward: 64 x 64 owned cells, three fields at a pitch of
    # 100 (the staged tile took 4 * 4 * 64 * 96: four fields on 32 x 64)
    assert smem("kstep_mod_mma", 8, 4) == 4 * (3 * 96 * 100 + 96)
    assert smem("kstep_gpu_fwd_mma", 8, 4) == 4 * (3 * 96 * 100 + 96)
    assert 2 * (smem("kstep_mod_mma", 8, 4) + 1024) <= 228 * 1024
    # the split backward: 32 x 96 owned cells, six fields at a pitch of 132
    assert smem("kstep_gpu_bwd_mma", 8, 4) == 4 * (6 * 64 * 132 + 32 * 96
                                                   + 64)
    ksteps = ("kstep_mod", "kstep_gpu_fwd", "kstep_gpu_bwd")
    splits = tuple(f"{k}_mma" for k in ksteps)
    for kernel in ksteps + splits:
        assert smem(kernel, 10, tpipe.TILED_BLOCK_K) <= limit
    # two blocks of kstep_gpu_bwd share an SM at order 8, K = 4 (228 KB
    # and 1 KB reserved a block), three of the forward kernels; K = 8 fits
    # both strip bodies' first shape
    assert 2 * (smem("kstep_gpu_bwd", 8, 4) + 1024) <= 228 * 1024
    assert 3 * (smem("kstep_mod", 8, 4) + 1024) <= 228 * 1024
    assert smem("kstep_gpu_bwd", 8, 8) == 4 * (4 * 96 * 128 + 32 * 64 + 96)
    assert smem("kstep_gpu_fwd", 8, 8) == 4 * (2 * 128 * 128 + 128)

    # the one-step split body (csrc/step_strip.cuh): fd_step_mma,
    # fd_update_mma (stream_step.cu) and gpu_step_mma take the first of its
    # shapes that fits at a halo of H cells, with the staged field and its
    # z product on padded rows; rec_bwd_step_mma (rec_step.cu) one of its
    # own shapes, by the grid (test_rec_shape_fills_the_card), at the same
    # stage and halo; every one of those shapes fits two blocks an SM at
    # every order the kernels take
    for name, launchers in (("gpu_step.cu", 1), ("stream_step.cu", 2),
                            ("rec_step.cu", 0)):
        src = " ".join((csrc / name).read_text().split())
        assert src.count("pfdc::strip_shape(pfdc::kStepShapes, "
                         "pfdc::kStepStage, H);") == launchers, name
        assert src.count("pfdc::strip_bytes(shape, pfdc::kStepStage, "
                         "H);") == max(launchers, 1), name
    rec_src = " ".join((csrc / "rec_step.cu").read_text().split())
    assert rec_src.count("pfdc::strip_shape_for_grid(kRecShapes, "
                         "pfdc::kStepStage, H, ns, nxe, nze, sms);") == 1
    bodies["Step"] = body("Step")
    shapes, *stage = bodies["Step"]
    assert stage == [2, False, True]
    rec_shapes = _rec_shapes()
    for order in range(4, fk.MAX_ORDER + 1, 2):
        for shape in shapes + rec_shapes:
            b = fk._strip_bytes(shape, order // 2,
                                fk._Strip(tuple(shapes), *stage))
            assert b <= limit and 2 * (b + 1024) <= 228 * 1024, (order,
                                                                  shape)
        first = fk._strip_bytes(shapes[0], order // 2,
                                fk._Strip(tuple(shapes), *stage))
        assert strip_smem("Step", order, 1) == first, order
    # the staged 64 x 64 tile of mma_tile.cuh is gone: no source names it
    # or its pieces, and both rec kernels' launchers take their shape by
    # the grid (rec_shape: strip_shape_for_grid over kRecShapes)
    assert not (csrc / "mma_tile.cuh").exists()
    for src in csrc.iterdir():
        text = src.read_text()
        assert "mma_tile.cuh" not in text, src.name
        for piece in ("stage_tile", "tile_z_mma", "for_tile_cells",
                      "split_lap", "mma_grid", "MmaTile", "kMmaThreads"):
            assert not re.search(rf"\b{piece}\b", text), (src.name, piece)
    rec_text = " ".join((csrc / "rec_step.cu").read_text().split())
    runs = {name: rec_text[rec_text.index(f"struct {name} {{"):]
            for name in ("RecFwdRun", "RecBwdRun")}
    assert re.search(r"rec_shape<H>\(rec_fwd_step_mma<H, P>, ns, nxe, nze, "
                     r"shape, bytes\);", runs["RecFwdRun"][
                         :runs["RecFwdRun"].index("struct RecBwdRun")])
    assert re.search(r"rec_shape<H>\(rec_bwd_step_mma<H, P, kImage>, ns, "
                     r"nxe, nze, shape, bytes\);", runs["RecBwdRun"])
    shape_fn = rec_text[rec_text.index("cudaError_t rec_shape("):
                        rec_text.index("struct RecFwdRun {")]
    assert ("shape = pfdc::strip_shape_for_grid(kRecShapes, "
            "pfdc::kStepStage, H, ns, nxe, nze, sms);") in shape_fn
    assert "return pfdc::allow_smem(kernel, bytes);" in shape_fn

    # the kernels of step_mma.cu: each owned shape's rows and columns plus
    # the halo (the rows as far as the last x window reads), kFields fields
    # (mod_step_mma the field, rtm_fwd_step_mma the field and the mask,
    # rtm_bwd_step_mma the source, the receiver and the mask) on padded
    # rows, as dynamic shared memory sized from the one tile description;
    # every even order 4-16 fits, with blocks to spare; the static tile the
    # two forward kernels staged before is gone
    mma_text = (csrc / "step_mma.cu").read_text()
    flat = " ".join(mma_text.split())
    assert ("static constexpr int kPitch = pfdc::strip_pitch(kCols, true);"
            in flat)
    assert ("static constexpr size_t kBytes = sizeof(float) * kFields * "
            "kCells;" in flat)
    assert flat.count("template <int H, int kFields, int TX, int TZ> struct "
                      "StageTile {") == 1
    for src in csrc.iterdir():
        text = src.read_text()
        for gone in ("StepTile", "StepArray", "stage_field", "taps_z",
                     "x_taps", "tile_grid"):
            assert not re.search(rf"\b{gone}\b", text), (src.name, gone)
    assert "__shared__ float" not in mma_text.replace(
        "extern __shared__ float smem[];", "")
    for kernel, key, fields in (("mod_step_mma", "Mod", 1),
                                ("rtm_fwd_step_mma", "Fwd", 2),
                                ("rtm_bwd_step_mma", "Bwd", 3)):
        tx, tz = (int(re.search(rf"constexpr int k{key}Tile{a} = (\d+);",
                                mma_text)[1]) for a in "XZ")
        assert {tx, tz} <= {32, 64} and tx * tz <= 2048, kernel
        assert (f"template <int H> using {key}Tile = StageTile<H, {fields}, "
                f"k{key}TileX, k{key}TileZ>;" in flat), kernel
        assert (f"__global__ void __launch_bounds__({key}Tile<H>::"
                f"kBlockThreads) {kernel}(" in flat), kernel
        assert re.search(rf"using T = {key}Tile<H>; const size_t bytes = "
                         rf"T::kBytes; const cudaError_t e = pfdc::allow_smem"
                         rf"\({kernel}<H, P>, bytes\);", flat), kernel
        assert f"{kernel}<H, P><<<grid, block, bytes, stream>>>(" in flat
        for order in range(4, fk.MAX_ORDER + 1, 2):
            h = order // 2
            ks = (8 + 2 * h + 15) // 16
            rows = max(tx + 2 * h, tx - 8 + 16 * ks)
            pitch = (tz + 2 * h + 3) // 8 * 8 + 4
            assert pitch % 8 == 4 and pitch >= tz + 2 * h
            b = 4 * fields * rows * pitch
            assert 4 * (b + 1024) <= 228 * 1024, (kernel, order, b)

    # the block kernels of the domain tiers (csrc/domain_block.cuh), every
    # one on a strip body: the launcher takes the body's shape and bytes for
    # a pass of pass.k_steps, a block of K above kBlockPassSteps running in
    # two passes, the longer of (K + 1) / 2 steps (BlockPasses)
    cuh = (csrc / "domain_block.cuh").read_text()
    runs = {name: cuh[cuh.index(f"struct {run} {{"):][:cuh[cuh.index(
        f"struct {run} {{"):].index("\n};")]
        for name, run in (("block_mod", "BlockModRun"),
                          ("block_fwd", "BlockFwdRun"),
                          ("block_bwd", "BlockBwdRun"))}
    strip_of = {"block_mod": "BlockFwd", "block_fwd": "BlockFwd",
                "block_mod_mma": "FwdMma", "block_fwd_mma": "FwdMma",
                "block_bwd": "Bwd", "block_bwd_mma": "BwdMma"}
    # block_mod and block_fwd and their split twins: one pass launcher and
    # one pass rule for every P, the shapes and stage of its P = 0 or P > 0
    # instances (fwd_pass_tile)
    assert re.search(r"FwdPassTile fwd_pass_tile\(int k_steps\) \{\s*const "
                     r"pfdc::StripStage stage = P \? pfdc::kFwdMmaStage "
                     r": pfdc::kFwdStage;\s*const pfdc::StripShape shape =\s*"
                     r"P \? pfdc::strip_shape\(pfdc::kFwdShapes, stage, "
                     r"k_steps \* H\)\s*: pfdc::strip_shape\(pfdc::kBlock"
                     r"FwdShapes, stage, k_steps \* H\);\s*return \{shape, "
                     r"pfdc::strip_bytes\(shape, stage, k_steps \* H\)\};",
                     cuh)
    for name in ("block_mod", "block_fwd"):
        text = runs[name]
        assert re.search(r"const auto \[shape, bytes\] = fwd_pass_tile<H, P>"
                         r"\(pass\.k_steps\);\s*if \(shape\.tx == 0\) "
                         r"return cudaErrorInvalidValue;", text), name
        assert re.search(r"cudaError_t launch\(\) const \{\s*if \(!d\.fits"
                         r"\(k \* H\)\) return cudaErrorInvalidValue;\s*"
                         r"const BlockPasses<kZ> passes\(d, k, H\);",
                         text), name
        assert "if constexpr" not in text, name
    # block_bwd and block_bwd_mma: one pass launcher and one pass rule for
    # every P, the body's shapes, the stage of its P = 0 or P > 0 instances
    text = runs["block_bwd"]
    assert re.search(r"const pfdc::StripStage stage = P \? pfdc::kBwdMmaStage"
                     r" : pfdc::kBwdStage;\s*const pfdc::StripShape shape ="
                     r"\s*pfdc::strip_shape\(pfdc::kBwdShapes, stage, pass\."
                     r"k_steps \* H\);\s*if \(shape\.tx == 0\) return "
                     r"cudaErrorInvalidValue;\s*const size_t bytes = pfdc::"
                     r"strip_bytes\(shape, stage, pass\.k_steps \* H\);",
                     text)
    assert re.search(r"cudaError_t launch\(\) const \{\s*if \(!d\.fits\(k "
                     r"\* H\)\) return cudaErrorInvalidValue;\s*BlockPasses"
                     r"<kZ> passes\(d, k, H\);", text)
    assert "if constexpr" not in text
    assert re.search(r"const int k1 = k <= kBlockPassSteps \? k : \(k \+ 1\)"
                     r" / 2, k2 = k - k1;", cuh)
    pass_steps = int(re.search(r"kBlockPassSteps = (\d+);", cuh)[1])
    assert pass_steps == fk.BLOCK_PASS_STEPS == 4
    # no staged-tile body is left: every split twin is a strip body's split
    # instance
    for gone in ("block_mod_body", "block_bwd_body", "block_fwd_body",
                 "BlockTile", "tile_bytes", "kModTX"):
        assert gone not in cuh, gone
    for name in ("mod", "fwd", "bwd"):
        assert re.search(rf"static_assert\(P > 0, \"block_{name} is the "
                         rf"exact kernel\"\);", cuh)

    def block_smem(kernel, order, k):
        return strip_smem(strip_of[kernel], order,
                          k if k <= pass_steps else (k + 1) // 2)

    # order 8, K = 8: two passes of 4, the K = 4 tile of kstep_gpu_bwd,
    # and of block_mod 64 x 96 owned cells (two blocks an SM); K = 5: a
    # longer pass of 3; block_bwd_mma two passes of 4 on 32 x 64 owned
    # cells, rows of 96 cells at a pitch of 100 floats; at order 16 the
    # padded 32 x 32 tile (96 x 100 floats a field) outgrows a block, 16 x
    # 32 is taken
    assert block_smem("block_bwd", 8, 8) == smem("kstep_gpu_bwd", 8, 4)
    assert block_smem("block_mod", 8, 8) == 4 * (2 * 96 * 128 + 96)
    assert 2 * (block_smem("block_mod", 8, 8) + 1024) <= 228 * 1024
    assert block_smem("block_fwd", 8, 5) == 4 * (2 * 88 * 120 + 88)
    assert block_smem("block_bwd", 10, 8) == 4 * (4 * 72 * 104 + 32 * 64
                                                  + 72)
    # block_mod_mma and block_fwd_mma: two passes of 4 on 64 x 64 owned
    # cells, three fields of 96 rows at a pitch of 100 floats; at order 16
    # 64 x 64 still fits, at a pitch of 132 floats
    for kernel in ("block_mod_mma", "block_fwd_mma"):
        assert block_smem(kernel, 8, 8) == 4 * (3 * 96 * 100 + 96)
        assert block_smem(kernel, 16, 8) == 4 * (3 * 128 * 132 + 128)
    assert block_smem("block_bwd_mma", 8, 8) == 4 * (6 * 64 * 100 + 32 * 64
                                                     + 64)
    assert block_smem("block_bwd_mma", 10, 8) == 4 * (6 * 72 * 108 + 32 * 64
                                                      + 72)
    assert block_smem("block_bwd_mma", 16, 8) == 4 * (6 * 80 * 100 + 16 * 32
                                                      + 80)

    # the mirror the pipelines choose K by is the launchers' arithmetic
    for order in range(2, 17, 2):
        for k in range(1, stream.MAX_STEPS + 1):
            for kernel in ksteps:
                assert fk.smem_bytes(kernel, order, k) == smem(
                    kernel, order, k)
                for parts in (2, 3):
                    assert fk.smem_bytes(kernel, order, k, parts) == smem(
                        f"{kernel}_mma", order, k)
            for kernel in ("block_mod", "block_fwd", "block_bwd"):
                assert fk.smem_bytes(kernel, order, k) == block_smem(
                    kernel, order, k)
                assert fk.smem_bytes(kernel.replace("block_", "block2_"),
                                     order, k) == block_smem(kernel, order, k)
                assert fk.smem_bytes(kernel, order, k, 2) == block_smem(
                    f"{kernel}_mma", order, k)

    # The smallest K each order's tile is refused at (None: every K up to
    # 8 fits): orders above 10 run on the card, but with fewer steps a pass
    # or block; the wrappers then raise, naming the limit (fk._raise_on).
    def first_refused(size, kernel, order):
        ks = [k for k in range(1, stream.MAX_STEPS + 1)
              if size(kernel, order, k) > limit]
        return ks[0] if ks else None

    refused = {order: {kernel: first_refused(
        block_smem if kernel.startswith("block") else smem, kernel, order)
        for kernel in ("kstep_mod", "kstep_gpu_fwd", "kstep_gpu_bwd",
                       "block_mod", "block_fwd", "block_bwd")}
        for order in (8, 10, 12, 14, 16)}
    refused_split = {order: {kernel: first_refused(smem, kernel, order)
                             for kernel in splits}
                     for order in (8, 10, 12, 14, 16)}
    assert refused == {
        8: {"kstep_mod": None, "kstep_gpu_fwd": None, "kstep_gpu_bwd": None,
            "block_mod": None, "block_fwd": None, "block_bwd": None},
        10: {"kstep_mod": None, "kstep_gpu_fwd": None, "kstep_gpu_bwd": None,
             "block_mod": None, "block_fwd": None, "block_bwd": None},
        12: {"kstep_mod": None, "kstep_gpu_fwd": None, "kstep_gpu_bwd": None,
             "block_mod": None, "block_fwd": None, "block_bwd": None},
        14: {"kstep_mod": None, "kstep_gpu_fwd": None, "kstep_gpu_bwd": 8,
             "block_mod": None, "block_fwd": None, "block_bwd": None},
        16: {"kstep_mod": None, "kstep_gpu_fwd": None, "kstep_gpu_bwd": 7,
             "block_mod": None, "block_fwd": None, "block_bwd": None}}
    # the split tier at TILED_BLOCK_K = 4: RTM and modeling up to order 16
    # (the split backward on its strip body: at order 16, K = 4, 16 x 32
    # owned cells; its staged tile took K = 3 at most at orders 12 and 14,
    # 2 at 16). The split forward kernels on the forward strip body refuse
    # only order 16's K = 8 (16 x 16 owned cells: 256.3 KB); their staged
    # tile refused K = 8 at order 10, 7 at 12, 6 at 14, 5 at 16.
    assert refused_split == {
        8: {"kstep_mod_mma": None, "kstep_gpu_fwd_mma": None,
            "kstep_gpu_bwd_mma": None},
        10: {"kstep_mod_mma": None, "kstep_gpu_fwd_mma": None,
             "kstep_gpu_bwd_mma": None},
        12: {"kstep_mod_mma": None, "kstep_gpu_fwd_mma": None,
             "kstep_gpu_bwd_mma": 7},
        14: {"kstep_mod_mma": None, "kstep_gpu_fwd_mma": None,
             "kstep_gpu_bwd_mma": 6},
        16: {"kstep_mod_mma": 8, "kstep_gpu_fwd_mma": 8,
             "kstep_gpu_bwd_mma": 6}}
    assert smem("kstep_mod_mma", 16, 8) == 4 * (3 * 144 * 148 + 144)
    assert smem("kstep_gpu_fwd_mma", 16, 4) == 4 * (3 * 128 * 132 + 128)
    assert smem("kstep_gpu_bwd_mma", 16, 4) == 4 * (6 * 80 * 100 + 16 * 32
                                                    + 80)
    # the split block kernels, in two passes, fit every K up to order 16
    # (the one-pass staged tiles of block_mod_mma and block_fwd_mma took K
    # = 7 at most at order 12, 6 at 14, 5 at 16)
    assert {order: {kernel: first_refused(block_smem, kernel, order)
                    for kernel in ("block_mod_mma", "block_fwd_mma",
                                   "block_bwd_mma")}
            for order in (8, 10, 12, 14, 16)} == {
        8: {"block_mod_mma": None, "block_fwd_mma": None,
            "block_bwd_mma": None},
        10: {"block_mod_mma": None, "block_fwd_mma": None,
             "block_bwd_mma": None},
        12: {"block_mod_mma": None, "block_fwd_mma": None,
             "block_bwd_mma": None},
        14: {"block_mod_mma": None, "block_fwd_mma": None,
             "block_bwd_mma": None},
        16: {"block_mod_mma": None, "block_fwd_mma": None,
             "block_bwd_mma": None}}
    # the per-step kernels (fd_step, fd_update, gpu_step and the whole-grid
    # step kernels) stage nothing, gpu_step_mma a static tile under 48 KB
    # (a static_assert), and they take every order up to MAX_ORDER
    assert fk.MAX_ORDER == 2 * int(re.search(
        r"kMaxHalf = (\d+)", (csrc / "stencil.cuh").read_text())[1])


# ------------------------------------------------------- the slice, batches

CFG = dict(nz=24, nx=28, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0, ns=2, sz=4,
           fsx=6, ds=10, gz=1, nxb=8, nzb=8, fac=0.7, order=8)


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_tiled_slice_matches_jax(tmp_path):
    jp, tp = jpk.Params(nt=11, **CFG), tpk.Params(nt=11, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    base = np.zeros((tp.nxe, tp.nze), np.float32)
    base[tp.nxb:tp.nxb + tp.nx, tp.nzb:tp.nzb + tp.nz] = vp
    tio.write_f32(str(tmp_path / "vel_ext.bin"), np.stack([
        tnum.extendvel_random(base, tp.nx, tp.nz, tp.nxb, tp.nzb, seed=5 + i)
        for i in range(tp.ns)]))
    jp.vel_ext_file = tp.vel_ext_file = str(tmp_path / "vel_ext.bin")
    jd = jpipe.run_modeling(jp, vp=vp, backend="lax")
    td = tpipe.run_modeling(tp, vp=vp, device="cpu", backend="tiled")
    assert td.shape == jd.shape == (tp.ns, tp.nx, tp.nt)
    assert rel_rms(td, jd) <= GATE
    jimg, jlocs = jpipe.run_rtm_gpu(jp, vp=vp, dobs=jd, backend="lax")
    timg, tlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=jd, device="cpu",
                                    backend="tiled")
    assert rel_rms(timg, jimg) <= GATE
    for s in range(tp.ns):
        assert rel_rms(tlocs[s], jlocs[s]) <= GATE
    # the per-step tier's plain path gives the same bits on the CPU
    np.testing.assert_array_equal(
        td, tpipe.run_modeling(tp, vp=vp, device="cpu", backend="pallas"))


@pytest.mark.parametrize("backend", ["pallas", "tiled"])
def test_shot_batches_do_not_change_the_results(monkeypatch, backend):
    p = tpk.Params(nt=9, **dict(CFG, ns=3))
    vp = layered_model(p.nx, p.nz)
    one = tpipe.run_modeling(p, vp=vp, device="cpu", backend=backend)
    img1, locs1 = tpipe.run_rtm_gpu(p, vp=vp, dobs=one, seed=4,
                                    device="cpu", backend=backend)
    monkeypatch.setattr(tpipe, "_SHOT_BATCH_BYTES", 1)
    assert tpipe._batch_shots(p, planes=12, traces=2) == 1
    many = tpipe.run_modeling(p, vp=vp, device="cpu", backend=backend)
    img2, locs2 = tpipe.run_rtm_gpu(p, vp=vp, dobs=one, seed=4,
                                    device="cpu", backend=backend)
    np.testing.assert_array_equal(many, one)
    np.testing.assert_array_equal(locs2, locs1)
    np.testing.assert_array_equal(img2, img1)


def test_cli_backend_option(tmp_path):
    p = tpk.Params(nt=6, **CFG)
    tio.write_f32(str(tmp_path / "vp.bin"), layered_model(p.nx, p.nz))
    cfg = tmp_path / "input.dat"
    cfg.write_text("".join(f"{k}={v}\n" for k, v in dict(CFG, nt=6).items())
                   + "vpfile=vp.bin\n")
    outs = {}
    for backend in ("pallas", "tiled", "auto"):
        out = tmp_path / f"{backend}.bin"
        tcli.main(["mod", str(cfg), "--device", "cpu", "--backend", backend,
                   "--output", str(out)])
        outs[backend] = tio.read_f32(str(out))
    assert outs["pallas"].size == p.ns * p.nx * p.nt
    np.testing.assert_array_equal(outs["tiled"], outs["pallas"])
    np.testing.assert_array_equal(outs["auto"], outs["pallas"])
    with pytest.raises(SystemExit):
        tcli.main(["rtm_gpu", str(cfg), "--device", "cpu", "--backend",
                   "lax"])
