"""The split-bf16 lowering of the per-step streaming tier (K = 1) and of
``rtm_main``'s recording kernels (``lap_impl`` ``"mxu"``, ``"mxu6"``;
kernel-table rows 8, 9 and 14) against the JAX package on the CPU.

* The plain steps with the z taps in bf16 parts (``solver.fd_step``,
  ``solver.fd_update`` and the ``rtm_main`` step loop with
  ``solver.laplacian_of(..., axis="z")``, what the wrappers run for CPU
  tensors) against the Pallas kernels they stand for with ``lap_impl``
  (``fd_step_padded``, ``fd_update_padded``, ``fd_kstep_rec_padded`` in
  source and column mode) in interpret mode, from random states.
  Tolerance ``max|port - jax| <= 5e-6 * max|jax|`` (PARITY of
  ``tests/test_torch_tiled_mxu.py``): both form the same exact bf16
  products and differ in the order of their float32 sums, and the JAX
  kernels add a pre-tapered injection after the taper.
* The four tiled drivers at K = 1, and ``backward_recorded_tiled`` and
  ``rtm_shot_full_tiled`` at K = 2 and 3, against the JAX tiled drivers
  in interpret mode: ``max|port - jax| <= 1e-5 * max|jax|``, the JAX
  package's contract between its tiers (``ops/pallas_stream.py:52-59``).
  Split results differ from the exact ones, mxu6 lies closer to them.
* A shot mesh of two CPU positions through ``make_sharded_rtm_full_tiled``,
  ``run_rtm_cpu(backend="tiled")`` under a split ``PFDC_LAP_IMPL``, and
  the whole-grid ``rtm_main`` tier, which keeps the exact taps whatever
  ``PFDC_LAP_IMPL`` says, as the JAX lax ``rtm_shot_full`` does.

The kernels are held against these plain versions on the card
(``cuda``-marked tests of ``tests/test_torch_kernels.py``, and
``chip_smoke.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.ops.pallas_stream import (
    fd_kstep_rec_padded, fd_step_padded, fd_update_padded, from_padded,
    injection_window, mask_ramps as j_mask_ramps, padded_layout,
    separable_mask_operands, to_padded)
from parallel_finite_difference_computation_tpu.ops.stencil import (
    lap_interior_mask)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext,
    backward_recorded_tiled as j_backward_recorded_tiled,
    forward_modeling_tiled as j_forward_modeling_tiled,
    rtm_shot_full_tiled as j_rtm_shot_full_tiled,
    rtm_shot_snapshot_tiled as j_rtm_shot_snapshot_tiled)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    make_mesh, make_sharded_rtm_full_tiled)

PARITY = 5e-6
GATE = 1e-5
TR = 16                      # tile_rows of the JAX streaming kernels
NT = 10
SXS, SZ, GZ = (12, 20), 14, 12


def max_rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ctxs(order=8, nt=NT, exact=True, nx=24, nz=30, nxb=6, nzb=9):
    """JAX and port contexts of one grid (36 x 48 extended by default;
    nzb <= 2 nxb, so that the JAX tiled tiers' unclamped receiver row stays
    where the port puts it)."""
    jctx = JaxContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                             order=order, nxb=nxb, nzb=nzb, fac=0.7,
                             exact_taper=exact)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    return jctx, ctx


def _inputs(ctx, seed, ns=2):
    rng = np.random.default_rng(seed)
    v2 = ((1500.0 + 500.0 * rng.random((ctx.nxe, ctx.nze)))
          .astype(np.float32)) ** 2
    wav = rng.standard_normal(ctx.nt).astype(np.float32)
    dobs = rng.standard_normal((ns, ctx.nx, ctx.nt)).astype(np.float32)
    return v2, wav, dobs


def _field(rng, ctx):
    return rng.standard_normal((ctx.nxe, ctx.nze)).astype(np.float32)


def _pad(a, ctx):
    return to_padded(jnp.asarray(a), ctx.order, TR)


def _unpad(a, ctx):
    return np.asarray(from_padded(a, ctx.nxe, ctx.nze, ctx.order, TR))


def _lap(ctx, lap_impl):
    """The Laplacian the wrappers hand the plain steps for CPU tensors."""
    return solver.laplacian_of(ctx, fk.lap_parts(lap_impl, ctx), axis="z")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


STEP_CASES = [(4, "mxu"), (4, "mxu6"), (8, "mxu"), (8, "mxu6"),
              (12, "mxu"), (16, "mxu"), (16, "mxu6")]
# fd_step also at the orders between (fd_step_mma's one-step strip body
# tiles every order the same way)
FD_STEP_CASES = STEP_CASES + [(6, "mxu"), (6, "mxu6"), (10, "mxu"),
                              (10, "mxu6"), (14, "mxu"), (14, "mxu6")]


# ------------------------------------------------ one step against Pallas

@pytest.mark.parametrize("order,lap_impl", FD_STEP_CASES)
@pytest.mark.parametrize("taper", ["all", "top"])
def test_fd_step_split_matches_pallas(order, lap_impl, taper):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(order)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _inputs(ctx, order)[0]
    mask = ctx.mask_all if taper == "all" else ctx.mask_top
    jp, jpp = fd_step_padded(_pad(p, ctx), _pad(pp, ctx), _pad(v2, ctx),
                             _pad(mask, ctx), ctx.coefs_x, ctx.coefs_z,
                             order, ctx.nxe, ctx.nze, ctx.dt2, tile_rows=TR,
                             interpret=True, lap_impl=lap_impl)
    tp, tpp = solver.fd_step(ctx, _t(p[None]), _t(pp[None]), _t(v2), taper,
                             lap=_lap(ctx, lap_impl))
    np.testing.assert_array_equal(tp[0].numpy(), _unpad(jp, ctx))
    assert max_rel(tpp[0], _unpad(jpp, ctx)) <= PARITY
    exact = solver.fd_step(ctx, _t(p[None]), _t(pp[None]), _t(v2), taper)[1]
    assert not torch.equal(tpp, exact)


@pytest.mark.parametrize("order,lap_impl", STEP_CASES)
def test_fd_update_split_matches_pallas(order, lap_impl):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(20 + order)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _inputs(ctx, order)[0]
    want = _unpad(fd_update_padded(_pad(p, ctx), _pad(pp, ctx),
                                   _pad(v2, ctx), ctx.coefs_x, ctx.coefs_z,
                                   order, ctx.nxe, ctx.nze, ctx.dt2,
                                   tile_rows=TR, interpret=True,
                                   lap_impl=lap_impl), ctx)
    got = solver.fd_update(ctx, _t(p[None]), _t(pp[None]), _t(v2),
                           _lap(ctx, lap_impl))
    assert max_rel(got[0], want) <= PARITY


def _rec_pass_operands(ctx, v2):
    R, W, row0, col0 = padded_layout(ctx.nxe, ctx.nze, ctx.order, TR)
    v2m = _pad(v2 * np.float32(ctx.dt2)
               * lap_interior_mask(ctx.nxe, ctx.nze, ctx.order), ctx)
    mrow, mzp = separable_mask_operands(
        *j_mask_ramps(ctx.mask_all, ctx.mask_top, "top", ctx.nzb),
        ctx.order, TR)
    return R, row0, col0, v2m, mrow, mzp


# order 16 runs K = 2: a K = 3 pass needs a halo of 24 rows, more than the
# 16-row tiles of these small grids
REC_CASES = [(4, 3, "mxu"), (8, 2, "mxu"), (8, 3, "mxu6"), (16, 2, "mxu"),
             (16, 2, "mxu6")]


@pytest.mark.parametrize("order,k,lap_impl", REC_CASES)
def test_rec_source_pass_split_matches_pallas(order, k, lap_impl):
    """``rec_fwd_step``'s plain steps (the point source at (sx, sz), the
    top-strip taper, frame m*p) against ``fd_kstep_rec_padded`` in source
    mode, one pass of k steps."""
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(30 + order + k)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _inputs(ctx, order)[0]
    amps = rng.standard_normal(k).astype(np.float32)
    sx, sz = SXS[0], SZ
    R, row0, col0, v2m, mrow, mzp = _rec_pass_operands(ctx, v2)
    inj48, win0 = injection_window(jnp.ones((1, 1), jnp.float32), row0 + sx,
                                   col0 + sz, ctx.nxe, ctx.nze, order, TR,
                                   mask_pad=_pad(ctx.mask_top, ctx))
    jp, jpp, frames = fd_kstep_rec_padded(
        _pad(p, ctx), _pad(pp, ctx), v2m, mrow, mzp, inj48, jnp.asarray(amps),
        ctx.coefs_x, ctx.coefs_z, order, ctx.nxe, ctx.nze, k,
        column_inj=False, win0=win0, tile_rows=TR, interpret=True,
        lap_impl=lap_impl)
    lap = _lap(ctx, lap_impl)
    tp, tpp = _t(p[None]), _t(pp[None])
    for i in range(k):
        pm, new = solver.fd_step(ctx, tp, tpp, _t(v2), "top",
                                 amp=float(amps[i]), sx=[sx], sz=sz,
                                 source="point", lap=lap)
        assert max_rel(pm[0], np.asarray(frames[i])[
            row0:row0 + ctx.nxe, col0:col0 + ctx.nze]) <= PARITY
        tp, tpp = new, pm
    assert max_rel(tp[0], _unpad(jp, ctx)) <= PARITY
    assert max_rel(tpp[0], _unpad(jpp, ctx)) <= PARITY


@pytest.mark.parametrize("order,k,lap_impl", REC_CASES)
def test_rec_column_pass_split_matches_pallas(order, k, lap_impl):
    """``rec_bwd_step``'s plain steps (the receiver row on row gz from x0,
    the top-strip taper, frame m*p) against ``fd_kstep_rec_padded`` in
    column mode, one pass of k steps."""
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(40 + order + k)
    p, pp, v2 = _field(rng, ctx), _field(rng, ctx), _inputs(ctx, order)[0]
    rows = rng.standard_normal((k, ctx.nx)).astype(np.float32)
    x0 = ctx.nzb
    R, row0, col0, v2m, mrow, mzp = _rec_pass_operands(ctx, v2)
    cgz = col0 + GZ
    mask_col = _pad(ctx.mask_top, ctx)[:, cgz:cgz + 1]
    sism = jnp.zeros((R, 128), jnp.float32).at[
        row0 + x0:row0 + x0 + ctx.nx, 0:k].set(jnp.asarray(rows.T)) * mask_col
    jp, jpp, frames = fd_kstep_rec_padded(
        _pad(p, ctx), _pad(pp, ctx), v2m, mrow, mzp, sism, cgz,
        ctx.coefs_x, ctx.coefs_z, order, ctx.nxe, ctx.nze, k,
        column_inj=True, tile_rows=TR, interpret=True, lap_impl=lap_impl)
    lap = _lap(ctx, lap_impl)
    tp, tpp = _t(p[None]), _t(pp[None])
    for i in range(k):
        pm, new = solver.fd_step(ctx, tp, tpp, _t(v2), "top",
                                 inj_row=_t(rows[i][None]), x0=x0, gz=GZ,
                                 lap=lap)
        assert max_rel(pm[0], np.asarray(frames[i])[
            row0:row0 + ctx.nxe, col0:col0 + ctx.nze]) <= PARITY
        tp, tpp = new, pm
    assert max_rel(tp[0], _unpad(jp, ctx)) <= PARITY
    assert max_rel(tpp[0], _unpad(jpp, ctx)) <= PARITY


# ------------------------------------------- the tiled drivers against JAX

@pytest.mark.parametrize("record", ["trace", "wavefield"])
def test_forward_modeling_tiled_k1_split_matches_jax(record):
    jctx, ctx = _ctxs(exact=False)
    v2, wav, _ = _inputs(ctx, 1)
    source, taper = (("gaussian", "all") if record == "trace"
                     else ("point", "top"))
    runs = {}
    for lap_impl in (None, "mxu", "mxu6"):
        runs[lap_impl] = solver.forward_modeling_tiled(
            ctx, _t(v2), wav, SXS, SZ, GZ, source, taper, record,
            lap_impl=lap_impl)[2]
        if lap_impl is None:
            continue
        # the whole-grid path splits the z taps for the wavefield (rtm_main's
        # recording kernel), the x taps for traces (the whole-shot kernel)
        assert torch.equal(runs[lap_impl], fk.forward_modeling_cuda(
            ctx, _t(v2), wav, SXS, SZ, GZ, source, taper, record,
            lap_impl=lap_impl)[2]) == (record == "wavefield")
        want = j_forward_modeling_tiled(
            jctx, jnp.asarray(v2), jnp.asarray(wav), SXS[1], SZ, GZ,
            source=source, taper=taper, record=record, tile_rows=TR,
            interpret=True, lap_impl=lap_impl)[2]
        assert max_rel(runs[lap_impl][1], want) <= GATE
    exact = runs[None]
    d3, d6 = (float((runs[k] - exact).abs().max()) for k in ("mxu", "mxu6"))
    assert 0 < d6 < d3


@pytest.mark.parametrize("block_k", [1, 2, 3])
def test_backward_recorded_tiled_split_matches_jax(block_k):
    jctx, ctx = _ctxs(exact=False)
    v2, _, dobs = _inputs(ctx, 2)
    nxt = (0.75, -0.5)
    runs = {}
    for lap_impl in (None, "mxu", "mxu6"):
        runs[lap_impl] = solver.backward_recorded_tiled(
            ctx, _t(v2), _t(dobs), GZ, next_shot_first=nxt, block_k=block_k,
            lap_impl=lap_impl)
    want = solver.backward_recorded(ctx, _t(v2), _t(dobs), GZ,
                                    next_shot_first=nxt,
                                    lap=_lap(ctx, "mxu6"))
    for a, b in zip(runs["mxu6"], want):       # the plain steps' bits
        assert torch.equal(a, b)
    jout = j_backward_recorded_tiled(
        jctx, jnp.asarray(v2), jnp.asarray(dobs[0]), GZ,
        next_shot_first=nxt[0], tile_rows=TR, interpret=True,
        block_k=block_k, lap_impl="mxu6")
    for a, b in zip(runs["mxu6"], jout):
        assert max_rel(a[0], b) <= GATE
    rwf = {k: v[2] for k, v in runs.items()}
    d3, d6 = (float((rwf[k] - rwf[None]).abs().max()) for k in ("mxu", "mxu6"))
    assert 0 < d6 < d3


@pytest.mark.parametrize("block_k", [1, 2, 3])
def test_rtm_shot_full_tiled_split_matches_jax(block_k):
    jctx, ctx = _ctxs(exact=False)
    v2, wav, dobs = _inputs(ctx, 3)
    nxt = (0.25, 0.0)
    imgs = {}
    for lap_impl in (None, "mxu", "mxu6"):
        imgs[lap_impl] = solver.rtm_shot_full_tiled(
            ctx, _t(v2), wav, _t(dobs), SXS, SZ, GZ, next_shot_first=nxt,
            block_k=block_k, lap_impl=lap_impl)
    for lap_impl in ("mxu", "mxu6"):
        plain = solver.rtm_shot_full(ctx, _t(v2), wav, _t(dobs), SXS, SZ, GZ,
                                     next_shot_first=nxt, lap_impl=lap_impl)
        assert max_rel(imgs[lap_impl], plain) <= 1e-6
        for s, sx in enumerate(SXS):
            assert max_rel(imgs[lap_impl][s], j_rtm_shot_full_tiled(
                jctx, jnp.asarray(v2), jnp.asarray(wav),
                jnp.asarray(dobs[s]), sx, SZ, GZ, next_shot_first=nxt[s],
                tile_rows=TR, interpret=True, block_k=block_k,
                lap_impl=lap_impl)) <= GATE
    d3, d6 = (float((imgs[k] - imgs[None]).abs().max())
              for k in ("mxu", "mxu6"))
    assert 0 < d6 < d3


def test_rtm_shot_snapshot_tiled_k1_split_matches_jax():
    jctx, ctx = _ctxs()
    v2, wav, dobs = _inputs(ctx, 4)
    v2s = np.stack([v2, v2 * np.float32(1.1)])
    imgs = {}
    for lap_impl in (None, "mxu", "mxu6"):
        imgs[lap_impl] = solver.rtm_shot_snapshot_tiled(
            ctx, _t(v2s), wav, _t(dobs), SXS, SZ, GZ, block_k=1,
            lap_impl=lap_impl)
    for lap_impl in ("mxu", "mxu6"):
        lap = _lap(ctx, lap_impl)
        snaps = solver.fd_forward(ctx, _t(v2s), wav, SXS, SZ, lap)
        assert torch.equal(imgs[lap_impl], solver.fd_back(
            ctx, _t(v2s), *snaps, _t(dobs), GZ, lap))
        for s, sx in enumerate(SXS):
            assert max_rel(imgs[lap_impl][s], j_rtm_shot_snapshot_tiled(
                jctx, jnp.asarray(v2s[s]), jnp.asarray(wav),
                jnp.asarray(dobs[s]), sx, SZ, GZ, tile_rows=TR,
                interpret=True, lap_impl=lap_impl)) <= GATE
    d3, d6 = (float((imgs[k] - imgs[None]).abs().max())
              for k in ("mxu", "mxu6"))
    assert 0 < d6 < d3


def test_wrappers_with_parts_on_cpu_are_the_split_steps():
    """``fd_step_cuda`` and ``fd_update_cuda`` take ``parts`` and route CPU
    tensors to the plain steps with the z taps in that many bf16 parts;
    the ``rtm_main`` wrappers take ``lap_impl``; none counts a launch."""
    jctx, ctx = _ctxs()
    v2, wav, dobs = _inputs(ctx, 5)
    rng = np.random.default_rng(5)
    p, pp = (_t(np.stack([_field(rng, ctx)] * 2)) for _ in range(2))
    fk.reset_launches()
    stream.reset_launches()
    for parts in (2, 3):
        lap = solver.laplacian_of(ctx, parts, axis="z")
        got = stream.fd_step_cuda(ctx, p, pp, _t(v2), amp=0.5, sx=SXS, sz=SZ,
                                  parts=parts)
        for a, b in zip(got, solver.fd_step(ctx, p, pp, _t(v2), amp=0.5,
                                            sx=SXS, sz=SZ, lap=lap)):
            assert torch.equal(a, b)
        assert torch.equal(stream.fd_update_cuda(ctx, p, pp, _t(v2),
                                                 parts=parts),
                           solver.fd_update(ctx, p, pp, _t(v2), lap))
        swf = fk.forward_modeling_cuda(ctx, _t(v2), wav, SXS, SZ, GZ,
                                       "point", "top", "wavefield",
                                       lap_impl=parts)[2]
        assert torch.equal(swf, solver.forward_modeling(
            ctx, _t(v2), wav, SXS, SZ, GZ, "point", "top", "wavefield",
            lap_impl=parts)[2])
        assert torch.equal(
            fk.backward_image_cuda(ctx, _t(v2), swf, _t(dobs), GZ,
                                   lap_impl=parts),
            solver.backward_image(ctx, _t(v2), swf, _t(dobs), GZ, lap=lap))
        assert torch.equal(
            fk.rtm_full_cuda(ctx, _t(v2), wav, _t(dobs), SXS, SZ, GZ,
                             lap_impl=parts),
            solver.rtm_shot_full(ctx, _t(v2), wav, _t(dobs), SXS, SZ, GZ,
                                 lap_impl=parts))
    assert not any(fk.LAUNCHES.values()) and not any(stream.LAUNCHES.values())
    assert {"fd_step_mma", "fd_update_mma"} <= set(stream.LAUNCHES)
    assert {"rec_fwd_step_mma", "rec_bwd_step_mma"} <= set(fk.LAUNCHES)
    for bad in (1, 4):
        with pytest.raises(ValueError, match="bf16 parts"):
            stream.fd_update_cuda(ctx, p, pp, _t(v2), parts=bad)


# ---------------------------------------------- shot mesh and pipeline

def test_sharded_rtm_full_tiled_split_over_two_cpu_positions():
    jctx, ctx = _ctxs(exact=False)
    v2, wav, dobs = _inputs(ctx, 6)
    nxt = np.float32([0.5, 0.0])
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    for block_k in (1, 2):
        fn = make_sharded_rtm_full_tiled(ctx, mesh, SZ, GZ, block_k=block_k,
                                         lap_impl="mxu6")
        got = fn(_t(v2), _t(dobs), SXS, nxt, wav)
        assert torch.equal(got, solver.rtm_shot_full_tiled(
            ctx, _t(v2), wav, _t(dobs), SXS, SZ, GZ, next_shot_first=nxt,
            block_k=block_k, lap_impl="mxu6"))
        assert max_rel(got[1], j_rtm_shot_full_tiled(
            jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[1]),
            SXS[1], SZ, GZ, next_shot_first=0.0, tile_rows=TR,
            interpret=True, block_k=block_k, lap_impl="mxu6")) <= GATE


CFG = dict(nz=24, nx=28, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0, ns=3, sz=4,
           fsx=6, ds=7, gz=1, nxb=8, nzb=6, fac=0.7, order=8)


def test_run_rtm_cpu_whole_grid_tier_keeps_the_exact_taps(monkeypatch):
    """With ``PFDC_LAP_IMPL=auto`` (resolving to mxu here) the whole-grid
    tier still returns the JAX package's image: it stands for the JAX lax
    ``rtm_shot_full``, which has the exact taps only. The tiled tier takes
    the split taps and the shot mesh the exact ones."""
    jp, tp = jpk.Params(nt=NT, **CFG), tpk.Params(nt=NT, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    dobs = jpipe.run_modeling(jp, vp=vp, backend="lax")
    jimg, jlocs = jpipe.run_rtm_cpu(jp, vp=vp, dobs=dobs, backend="lax")
    exact = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu")
    monkeypatch.setattr(fk, "_ENV_LAP_IMPL", "auto")
    ctx = solver.FDContext.from_params(tp, exact_taper=False)
    assert fk.lap_parts(None, ctx) == 2
    img, locs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu")
    assert max_rel(img, jimg) <= GATE
    for s in range(tp.ns):
        assert max_rel(locs[s], jlocs[s]) <= GATE
    np.testing.assert_array_equal(img, exact[0])
    mesh = make_mesh(3, 1, devices=["cpu"] * 3)
    np.testing.assert_array_equal(
        tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, mesh=mesh)[1], exact[1])
    tiled = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu",
                              backend="tiled")[1]
    assert not np.array_equal(tiled, exact[1])
    assert max_rel(tiled, exact[1]) <= 1e-4
