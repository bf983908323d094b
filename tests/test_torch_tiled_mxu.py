"""The split-bf16 lowering of the large-grid tier at K >= 2 (``lap_impl``
``"mxu"``, ``"mxu6"``; kernel-table rows 10-13) against the JAX package on
the CPU, pass by pass: each plain pass with the z taps in bf16 parts
(``mod_kstep``, ``fd_forward_kstep``, ``fd_back_kstep``, ``fd_step_gpu``
with ``solver.laplacian_of(..., axis="z")``, what the wrappers of
``ops.stream`` run for CPU tensors) against the Pallas kernel it stands for
with ``lap_impl`` (``fd_kstep_padded``, ``fd_kstep_gpu_fwd_padded``,
``fd_kstep_gpu_bwd_padded``, ``fd_step_gpu_padded``) in interpret mode, one
pass from a random state; and the wrappers' ``parts`` routing. The tiled
drivers, the slice and ``auto`` are in ``tests/test_torch_tiled_mxu_
drivers.py``.

Tolerance: ``max|port - jax| <= 5e-6 * max|jax|`` (PARITY): both form the
same exact bf16 products and differ only in the order of their float32
sums, and XLA contracts some multiply-adds. The kernels are held against
these plain versions on the card (``cuda``-marked tests of
``tests/test_torch_kernels.py``, and ``chip_smoke.py`` phase 25)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu.ops.pallas_stream import (
    fd_kstep_gpu_bwd_padded, fd_kstep_gpu_fwd_padded, fd_kstep_padded,
    fd_step_gpu_padded, from_padded, injection_window,
    mask_ramps as j_mask_ramps, padded_layout, separable_mask_operands,
    to_padded)
from parallel_finite_difference_computation_tpu.ops.stencil import (
    lap_interior_mask)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext)

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)

PARITY = 5e-6
TR = 16                      # tile_rows of the JAX streaming kernels


def _tile_rows(order, k):
    """TR, or the JAX kernels' least tile_rows for a halo of k*h rows (a
    multiple of 8 at least as large)."""
    return max(TR, -(-k * (order // 2) // 8) * 8)


def max_rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ctxs(order=8, nt=13, exact=True, nx=30, nz=40, nxb=6, nzb=5, dt=0.001):
    jctx = JaxContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=dt,
                             order=order, nxb=nxb, nzb=nzb, fac=0.7,
                             exact_taper=exact)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    return jctx, ctx


def _field(rng, ctx):
    return rng.standard_normal((ctx.nxe, ctx.nze)).astype(np.float32)


def _velocity(rng, ctx, ns=None):
    shape = (ctx.nxe, ctx.nze) if ns is None else (ns, ctx.nxe, ctx.nze)
    return ((1500.0 + 500.0 * rng.random(shape)).astype(np.float32)) ** 2


def _pad(a, ctx, tr=TR):
    return to_padded(jnp.asarray(a), ctx.order, tr)


def _unpad(a, ctx, tr=TR):
    return np.asarray(from_padded(a, ctx.nxe, ctx.nze, ctx.order, tr))


def _v2m(ctx, v2, tr=TR):
    return _pad(v2 * np.float32(ctx.dt2)
                * lap_interior_mask(ctx.nxe, ctx.nze, ctx.order), ctx, tr)


def _lap(ctx, lap_impl):
    """The Laplacian the wrappers hand the plain passes for CPU tensors."""
    return solver.laplacian_of(ctx, fk.lap_parts(lap_impl, ctx), axis="z")


def _shots(ctx):
    return (ctx.nxb + 9, ctx.nxb + 17), ctx.nzb + 2, ctx.nzb + 1


# Each axis a few times, not the full product: order 8 at K = 2, 3, 4 with
# both split tiers; orders 4 and 16 (two k-steps of 16 a window) at K = 2;
# the tiled tier's K = 4 at orders 12 and 16, and order 8 at K = 8, which
# the split kernels' tiles take on the forward strip body.
CASES = [(8, 2, "mxu"), (8, 3, "mxu"), (8, 4, "mxu"), (8, 2, "mxu6"),
         (8, 3, "mxu6"), (8, 4, "mxu6"), (4, 2, "mxu"), (4, 2, "mxu6"),
         (16, 2, "mxu"), (16, 2, "mxu6"), (12, 4, "mxu"), (16, 4, "mxu6"),
         (8, 8, "mxu")]


# ------------------------------------------------ one pass against Pallas

@pytest.mark.parametrize("order,k,lap_impl", CASES)
def test_mod_kstep_split_matches_pallas(order, k, lap_impl):
    tr = _tile_rows(order, k)
    jctx, ctx = _ctxs(order, exact=False)
    rng = np.random.default_rng(10 * order + k)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _velocity(rng, ctx)
    amps = rng.standard_normal(k).astype(np.float32)
    sx, sz, gz = ctx.nxb + 10, ctx.nzb + 3, ctx.nzb + 1
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, tr)
    inj48, win0 = injection_window(jnp.asarray(ctx.source_patch),
                                   row0 + sx - 3, col0 + sz - 3, ctx.nxe,
                                   ctx.nze, order, tr,
                                   mask_pad=_pad(ctx.mask_all, ctx, tr))
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "all", ctx.nzb), order, tr)
    jp, jpp, jrec = fd_kstep_padded(
        _pad(p, ctx, tr), _pad(pp, ctx, tr), _v2m(ctx, v2, tr), mrow, mzp,
        inj48, win0, jnp.asarray(amps), col0 + gz, ctx.coefs_x, ctx.coefs_z,
        order, ctx.nxe, ctx.nze, k, tr, interpret=True, lap_impl=lap_impl)
    tp, tpp, trec = solver.mod_kstep(
        ctx, torch.from_numpy(p[None]), torch.from_numpy(pp[None]),
        torch.from_numpy(v2), amps, [sx], sz, gz, lap=_lap(ctx, lap_impl))
    assert max_rel(tp[0], _unpad(jp, ctx, tr)) <= PARITY
    assert max_rel(tpp[0], _unpad(jpp, ctx, tr)) <= PARITY
    rows = np.asarray(jrec)[row0 + ctx.nxb:row0 + ctx.nxb + ctx.nx, :k]
    assert max_rel(trec[0], rows.T) <= PARITY


@pytest.mark.parametrize("order,k,lap_impl", CASES)
def test_fd_forward_kstep_split_matches_pallas(order, k, lap_impl):
    tr = _tile_rows(order, k)
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(20 * order + k)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _velocity(rng, ctx)
    amps = rng.standard_normal(k).astype(np.float32)
    sx, sz = ctx.nxb + 9, ctx.nzb + 2
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, tr)
    point48, win0 = injection_window(jnp.ones((1, 1), jnp.float32),
                                     row0 + sx, col0 + sz, ctx.nxe, ctx.nze,
                                     order, tr)
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "top", ctx.nzb), order, tr)
    jp, jpp = fd_kstep_gpu_fwd_padded(
        _pad(p, ctx, tr), _pad(pp, ctx, tr), _v2m(ctx, v2, tr), mrow, mzp,
        point48, win0, jnp.asarray(amps), ctx.coefs_x, ctx.coefs_z, order,
        ctx.nxe, ctx.nze, k, tr, interpret=True, lap_impl=lap_impl)
    tp, tpp = solver.fd_forward_kstep(
        ctx, torch.from_numpy(p[None]), torch.from_numpy(pp[None]),
        torch.from_numpy(v2), amps, [sx], sz, _lap(ctx, lap_impl))
    assert max_rel(tp[0], _unpad(jp, ctx, tr)) <= PARITY
    assert max_rel(tpp[0], _unpad(jpp, ctx, tr)) <= PARITY


def _image_ext(ctx, img):
    ext = np.zeros((ctx.nxe, ctx.nze), np.float32)
    ext[ctx.nxb:ctx.nxb + ctx.nx, ctx.nzb:ctx.nzb + ctx.nz] = img
    return ext


def _image(ctx, ext):
    return ext[ctx.nxb:ctx.nxb + ctx.nx, ctx.nzb:ctx.nzb + ctx.nz]


@pytest.mark.parametrize("order,k,lap_impl", CASES)
def test_fd_back_kstep_split_matches_pallas(order, k, lap_impl):
    tr = _tile_rows(order, k)
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(30 * order + k)
    fields = [_field(rng, ctx) for _ in range(4)]
    v2 = _velocity(rng, ctx)
    img = rng.standard_normal((ctx.nx, ctx.nz)).astype(np.float32)
    inj = rng.standard_normal((k, ctx.nx)).astype(np.float32)
    gz = ctx.nzb + 1
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, tr)
    sism = np.zeros((R, 128), np.float32)
    sism[row0 + ctx.nxb:row0 + ctx.nxb + ctx.nx, :k] = inj.T
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "top", ctx.nzb), order, tr)
    jout = fd_kstep_gpu_bwd_padded(
        *(_pad(f, ctx, tr) for f in fields), _v2m(ctx, v2, tr), mrow, mzp,
        jnp.asarray(sism), _pad(_image_ext(ctx, img), ctx, tr), col0 + gz,
        ctx.coefs_x, ctx.coefs_z, order, ctx.nxe, ctx.nze, ctx.nzb, ctx.nz,
        ctx.nxb, ctx.nx, k, tr, interpret=True, lap_impl=lap_impl)
    tout = solver.fd_back_kstep(
        ctx, *(torch.from_numpy(f[None]) for f in fields),
        torch.from_numpy(img[None]), torch.from_numpy(v2),
        torch.from_numpy(inj[None]), gz, _lap(ctx, lap_impl))
    for t, j in zip(tout[:4], jout[:4]):
        assert max_rel(t[0], _unpad(j, ctx, tr)) <= PARITY
    assert max_rel(tout[4][0], _image(ctx, _unpad(jout[4], ctx, tr))) <= PARITY


@pytest.mark.parametrize("order", [4, 6, 8, 10, 12, 14, 16])
@pytest.mark.parametrize("lap_impl", ["mxu", "mxu6"])
@pytest.mark.parametrize("imaging", [True, False])
def test_fd_step_gpu_split_matches_pallas(order, lap_impl, imaging):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(40 + order)
    y, x, src = _field(rng, ctx), _field(rng, ctx), _field(rng, ctx)
    v2 = _velocity(rng, ctx)
    img = rng.standard_normal((ctx.nx, ctx.nz)).astype(np.float32)
    row = rng.standard_normal(ctx.nx).astype(np.float32)
    gz = ctx.nzb + 1
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, order, TR)
    kw = dict(nxb=ctx.nxb, nzb=ctx.nzb, nx=ctx.nx, nz=ctx.nz, gz=gz,
              tile_rows=TR, interpret=True, lap_impl=lap_impl)
    targs = (ctx, torch.from_numpy(y[None]), torch.from_numpy(x[None]),
             torch.from_numpy(v2))
    lap = _lap(ctx, lap_impl)
    if imaging:
        scol = np.zeros((R, 128), np.float32)
        scol[row0 + ctx.nxb:row0 + ctx.nxb + ctx.nx, 0] = row
        kw.update(sism_col=jnp.asarray(scol),
                  imloc_pad=_pad(_image_ext(ctx, img), ctx),
                  imsrc_pad=_pad(src, ctx))
        tout = solver.fd_step_gpu(*targs, gz, torch.from_numpy(row[None]),
                                  torch.from_numpy(img[None]),
                                  torch.from_numpy(src[None]), lap)
    else:
        tout = solver.fd_step_gpu(*targs, lap=lap)
    jout = fd_step_gpu_padded(_pad(y, ctx), _pad(x, ctx), _pad(v2, ctx),
                              _pad(ctx.mask_top, ctx), ctx.coefs_x,
                              ctx.coefs_z, order, ctx.nxe, ctx.nze, ctx.dt2,
                              **kw)
    assert len(tout) == len(jout) == (3 if imaging else 2)
    assert max_rel(tout[0][0], _unpad(jout[0], ctx)) <= PARITY
    assert max_rel(tout[1][0], _unpad(jout[1], ctx)) <= PARITY
    if imaging:
        assert max_rel(tout[2][0], _image(ctx, _unpad(jout[2], ctx))) \
            <= PARITY


def test_wide_frame_pass_matches_pallas():
    """A grid 270 cells deep: the JAX kernels' 384-lane frame takes the z
    taps in three 128-lane band blocks (first, middle, last); the port's
    product has no blocks, and agrees across theirs."""
    jctx, ctx = _ctxs(8, nz=260)
    rng = np.random.default_rng(5)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _velocity(rng, ctx)
    amps = rng.standard_normal(2).astype(np.float32)
    sx, sz = ctx.nxb + 9, ctx.nzb + 130
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, 8, TR)
    assert W == 384
    point48, win0 = injection_window(jnp.ones((1, 1), jnp.float32),
                                     row0 + sx, col0 + sz, ctx.nxe, ctx.nze,
                                     8, TR)
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "top", ctx.nzb), 8, TR)
    jp, jpp = fd_kstep_gpu_fwd_padded(
        _pad(p, ctx), _pad(pp, ctx), _v2m(ctx, v2), mrow, mzp, point48, win0,
        jnp.asarray(amps), ctx.coefs_x, ctx.coefs_z, 8, ctx.nxe, ctx.nze, 2,
        TR, interpret=True, lap_impl="mxu")
    tp, tpp = solver.fd_forward_kstep(
        ctx, torch.from_numpy(p[None]), torch.from_numpy(pp[None]),
        torch.from_numpy(v2), amps, [sx], sz, _lap(ctx, "mxu"))
    assert max_rel(tp[0], _unpad(jp, ctx)) <= PARITY
    assert max_rel(tpp[0], _unpad(jpp, ctx)) <= PARITY


@pytest.mark.parametrize("parts", [2, 3])
def test_wrappers_with_parts_on_cpu_are_the_split_passes(parts):
    """The wrappers take ``parts`` (0, 2 or 3; others raise) and route CPU
    tensors to the plain passes with the z taps in that many bf16 parts,
    counting no launch."""
    _, ctx = _ctxs(8, nt=4)
    rng = np.random.default_rng(parts)
    v2 = torch.from_numpy(_velocity(rng, ctx))
    p, pp, pr, ppr = (torch.from_numpy(np.stack([_field(rng, ctx)] * 2))
                      for _ in range(4))
    img = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, ctx.nz)).astype(np.float32))
    inj = torch.from_numpy(rng.standard_normal(
        (2, 3, ctx.nx)).astype(np.float32))
    amps = np.float32([0.5, -1.0, 2.0])
    sxs, sz, gz = _shots(ctx)
    lap = solver.laplacian_of(ctx, parts, axis="z")
    stream.reset_launches()
    pairs = [
        (stream.mod_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz, gz,
                               parts=parts),
         solver.mod_kstep(ctx, p, pp, v2, amps, sxs, sz, gz, lap=lap)),
        (stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz,
                                      parts=parts),
         solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz, lap)),
        (stream.fd_back_kstep_cuda(ctx, p, pp, pr, ppr, img, v2, inj, gz,
                                   parts=parts),
         solver.fd_back_kstep(ctx, p, pp, pr, ppr, img, v2, inj, gz, lap)),
        (stream.fd_step_gpu_cuda(ctx, pr, ppr, v2, gz, inj[:, 0].contiguous(),
                                 img, p, parts=parts),
         solver.fd_step_gpu(ctx, pr, ppr, v2, gz, inj[:, 0], img, p, lap))]
    exact = solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz)
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(pairs[1][0][1], exact[1])
    assert stream.LAUNCHES == dict.fromkeys(stream.LAUNCHES, 0)
    assert {"kstep_mod_mma", "kstep_gpu_fwd_mma", "kstep_gpu_bwd_mma",
            "gpu_step_mma"} <= set(stream.LAUNCHES)
    for bad in (1, 4):
        with pytest.raises(ValueError, match="bf16 parts"):
            stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz,
                                         parts=bad)
