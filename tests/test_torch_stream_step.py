"""The per-step streaming tier of the port (``block_k=1``) against the JAX
package, on the CPU.

* The plain ``fd_step`` and ``fd_update`` against the Pallas kernels they
  stand for, ``fd_step_padded`` and ``fd_update_padded``, in interpret
  mode, through the JAX package's own ``to_padded``/``from_padded``, at
  orders 4 to 16 and with both tapers. Tolerance ``4 ulp * scale``, as
  ``tests/test_pallas_stream.py`` holds the kernel against the lax update
  (XLA contracts some multiply-adds on the CPU).
* The four tiled loops at K = 1 against the JAX tiled loops
  (interpret mode) in every source, taper and record mode, with the
  receiver-row quirks; and bitwise against the port's whole-grid plain
  loops, which run the same step bodies.
* ``rtm_shot_full_tiled`` at K = 1, 2 and 3 against the JAX lax
  ``rtm_shot_full``; ``run_rtm_cpu(backend="tiled")`` and the shot-sharded
  maker against the JAX ``run_rtm_cpu(backend="lax")``.
* On the CPU the wrappers run the plain versions and count no launch. On
  a card the kernels are held against the plain versions by the
  ``cuda``-marked tests of ``tests/test_torch_kernels.py`` (no JAX there)
  and by ``chip_smoke.py``.

Tolerance of the tiled loops: ``max|port - jax| <= 1e-5 * max|jax|``, the JAX
package's contract between its tiers (``ops/pallas_stream.py:52-59``): the
port injects before the taper and the JAX tiled tier after it, and the
port sums the full-wavefield image in time order."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.ops.pallas_stream import (
    fd_step_padded, fd_update_padded, from_padded, to_padded)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext,
    backward_recorded_tiled as j_backward_recorded_tiled,
    forward_modeling_tiled as j_forward_modeling_tiled,
    rtm_shot_full as j_rtm_shot_full,
    rtm_shot_full_tiled as j_rtm_shot_full_tiled,
    rtm_shot_snapshot_tiled as j_rtm_shot_snapshot_tiled)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    stream)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    make_mesh, make_sharded_rtm_full_tiled)

GATE = 1e-5
TR = 16                      # tile_rows of the JAX streaming kernels
NT = 10
SXS, SZ, GZ = (12, 20), 14, 12


def assert_close(got, want):
    """``max|got - want| <= 1e-5 * max|want|``."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GATE * np.abs(want).max()


def _ctxs(order=8, nt=NT, exact=True, nx=24, nz=30, nxb=6, nzb=9):
    """JAX and port contexts of one grid (36 x 48 extended by default;
    nxb != nzb, and nzb <= 2 nxb so that the JAX tiled tiers' unclamped
    receiver row stays in the grid)."""
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


def _pad(a, ctx):
    return to_padded(jnp.asarray(a), ctx.order, TR)


def _unpad(a, ctx):
    return np.asarray(from_padded(a, ctx.nxe, ctx.nze, ctx.order, TR))


# ------------------------------------------------ one step against Pallas

@pytest.mark.parametrize("order", [4, 8, 10, 12, 16])
@pytest.mark.parametrize("taper", ["all", "top"])
def test_fd_step_matches_pallas(order, taper):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(order)
    p, pp = (rng.standard_normal((ctx.nxe, ctx.nze)).astype(np.float32)
             for _ in range(2))
    v2 = _inputs(ctx, order)[0]
    mask = ctx.mask_all if taper == "all" else ctx.mask_top
    jp, jpp = fd_step_padded(_pad(p, ctx), _pad(pp, ctx), _pad(v2, ctx),
                             _pad(mask, ctx), ctx.coefs_x, ctx.coefs_z,
                             order, ctx.nxe, ctx.nze, ctx.dt2, tile_rows=TR,
                             interpret=True)
    tp, tpp = solver.fd_step(ctx, torch.from_numpy(p[None]),
                             torch.from_numpy(pp[None]), torch.from_numpy(v2),
                             taper)
    want = _unpad(jpp, ctx)
    tol = 4 * np.finfo(np.float32).eps * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(tpp[0].numpy(), want, atol=tol, rtol=0)
    np.testing.assert_array_equal(tp[0].numpy(), _unpad(jp, ctx))


@pytest.mark.parametrize("order", [4, 8, 10, 12, 16])
def test_fd_update_matches_pallas(order):
    jctx, ctx = _ctxs(order)
    rng = np.random.default_rng(20 + order)
    p, pp = (rng.standard_normal((ctx.nxe, ctx.nze)).astype(np.float32)
             for _ in range(2))
    v2 = _inputs(ctx, order)[0]
    want = _unpad(fd_update_padded(_pad(p, ctx), _pad(pp, ctx),
                                   _pad(v2, ctx), ctx.coefs_x, ctx.coefs_z,
                                   order, ctx.nxe, ctx.nze, ctx.dt2,
                                   tile_rows=TR, interpret=True), ctx)
    got = solver.fd_update(ctx, torch.from_numpy(p[None]),
                           torch.from_numpy(pp[None]), torch.from_numpy(v2))
    tol = 4 * np.finfo(np.float32).eps * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got[0].numpy(), want, atol=tol, rtol=0)


def test_fd_step_injects_before_the_taper():
    """The source window and the receiver row go into the new field before
    the taper, as the reference's loops do (``mod_main.cpp:146-168``)."""
    _, ctx = _ctxs()
    rng = np.random.default_rng(3)
    p, pp = (torch.from_numpy(rng.standard_normal(
        (2, ctx.nxe, ctx.nze)).astype(np.float32)) for _ in range(2))
    v2 = torch.from_numpy(_inputs(ctx, 3)[0])
    row = torch.from_numpy(rng.standard_normal((2, ctx.nx)).astype(
        np.float32))
    mask = torch.from_numpy(ctx.mask_top)
    u = solver.fd_update(ctx, p, pp, v2)
    _, got = solver.fd_step(ctx, p, pp, v2, "top", amp=0.5, sx=SXS, sz=SZ)
    want = u.clone()
    for s, sx in enumerate(SXS):
        want[s, sx - 3:sx + 4, SZ - 3:SZ + 4] += 0.5 * torch.from_numpy(
            ctx.source_patch)
    assert torch.equal(got, want * mask)
    _, got = solver.fd_step(ctx, p, pp, v2, "top", amp=0.5, sx=SXS, sz=SZ,
                            source="point")
    want = u.clone()
    for s, sx in enumerate(SXS):
        want[s, sx, SZ] += 0.5
    assert torch.equal(got, want * mask)
    x0 = ctx.nxe - ctx.nx              # clamped from nxe
    _, got = solver.fd_step(ctx, p, pp, v2, "top", inj_row=row, x0=ctx.nxe,
                            gz=GZ)
    want = u.clone()
    want[:, x0:, GZ] += row
    assert torch.equal(got, want * mask)


# --------------------------------------------- the K = 1 loops against JAX

@pytest.mark.parametrize("source,taper",
                         list(itertools.product(["gaussian", "point"],
                                                ["all", "top"])))
def test_forward_modeling_tiled_k1_matches_jax(source, taper):
    jctx, ctx = _ctxs(exact=False)
    v2, wav, _ = _inputs(ctx, 1)
    tv2 = torch.from_numpy(v2)
    for record in solver.RECORD_MODES:
        got = solver.forward_modeling_tiled(ctx, tv2, wav, SXS, SZ, GZ,
                                            source, taper, record)
        want = solver.forward_modeling(ctx, tv2, wav, SXS, SZ, GZ, source,
                                       taper, record)
        for a, b in zip(got, want):       # the whole-grid loop's bits
            assert (a is None and b is None) or torch.equal(a, b)
        jax_out = j_forward_modeling_tiled(
            jctx, jnp.asarray(v2), jnp.asarray(wav), SXS[0], SZ, GZ,
            source=source, taper=taper, record=record, tile_rows=TR,
            interpret=True)
        for a, b in zip(got, jax_out):
            assert (a is None) == (b is None)
            if a is not None:
                assert_close(a[0], b)


@pytest.mark.parametrize("x_off_quirk", [True, False])
def test_backward_recorded_tiled_k1_matches_jax(x_off_quirk):
    jctx, ctx = _ctxs(exact=False)
    v2, _, dobs = _inputs(ctx, 2)
    nxt = (0.75, -0.5)
    got = solver.backward_recorded_tiled(ctx, torch.from_numpy(v2),
                                         torch.from_numpy(dobs), GZ,
                                         x_off_quirk=x_off_quirk,
                                         next_shot_first=nxt)
    want = solver.backward_recorded(ctx, torch.from_numpy(v2),
                                    torch.from_numpy(dobs), GZ,
                                    x_off_quirk=x_off_quirk,
                                    next_shot_first=nxt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for s in range(2):
        jout = j_backward_recorded_tiled(
            jctx, jnp.asarray(v2), jnp.asarray(dobs[s]), GZ,
            x_off_quirk=x_off_quirk, next_shot_first=nxt[s], tile_rows=TR,
            interpret=True)
        for a, b in zip(got, jout):
            assert_close(a[s], b)


def test_rtm_shot_full_tiled_k1_matches_jax():
    jctx, ctx = _ctxs(exact=False)
    v2, wav, dobs = _inputs(ctx, 3)
    got = solver.rtm_shot_full_tiled(ctx, torch.from_numpy(v2), wav,
                                     torch.from_numpy(dobs), SXS, SZ, GZ,
                                     next_shot_first=(0.25, 0.0))
    for s, sx in enumerate(SXS):
        assert_close(got[s], j_rtm_shot_full_tiled(
            jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[s]),
            sx, SZ, GZ, next_shot_first=(0.25, 0.0)[s], tile_rows=TR,
            interpret=True))


def test_rtm_shot_snapshot_tiled_k1_matches_jax():
    jctx, ctx = _ctxs()
    v2, wav, dobs = _inputs(ctx, 4)
    v2s = np.stack([v2, v2 * np.float32(1.1)])
    got = solver.rtm_shot_snapshot_tiled(ctx, torch.from_numpy(v2s), wav,
                                         torch.from_numpy(dobs), SXS, SZ, GZ)
    assert torch.equal(got, solver.rtm_shot_snapshot(
        ctx, torch.from_numpy(v2s), wav, torch.from_numpy(dobs), SXS, SZ,
        GZ))
    for s, sx in enumerate(SXS):
        assert_close(got[s], j_rtm_shot_snapshot_tiled(
            jctx, jnp.asarray(v2s[s]), jnp.asarray(wav), jnp.asarray(dobs[s]),
            sx, SZ, GZ, tile_rows=TR, interpret=True))


@pytest.mark.parametrize("block_k", [1, 2, 3])
def test_rtm_shot_full_tiled_matches_jax_lax(block_k):
    """K = 1 through ``fd_step``, K = 2 and 3 (nt % K != 0) through the
    ``rec_step`` path, against the JAX lax flavor; nzb > 2 nxb, where the
    receiver row is clamped into the grid as the lax path clamps it."""
    jctx, ctx = _ctxs(exact=False, nt=11, nxb=4, nzb=9)
    v2, wav, dobs = _inputs(ctx, 5)
    got = solver.rtm_shot_full_tiled(ctx, torch.from_numpy(v2), wav,
                                     torch.from_numpy(dobs), SXS, SZ, GZ,
                                     next_shot_first=(0.5, 0.0),
                                     block_k=block_k)
    assert solver.receiver_offset(ctx) == ctx.nxe - ctx.nx     # clamped
    for s, sx in enumerate(SXS):
        assert_close(got[s], j_rtm_shot_full(
            jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[s]),
            sx, SZ, GZ, next_shot_first=(0.5, 0.0)[s]))


# ------------------------------------------- rtm_main's pipeline and maker

CFG = dict(nz=24, nx=28, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0, ns=3, sz=4,
           fsx=6, ds=7, gz=1, nxb=8, nzb=6, fac=0.7, order=8)


def test_run_rtm_cpu_tiled_and_its_maker_match_jax():
    jp, tp = jpk.Params(nt=9, **CFG), tpk.Params(nt=9, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    dobs = jpipe.run_modeling(jp, vp=vp, backend="lax")
    jimg, jlocs = jpipe.run_rtm_cpu(jp, vp=vp, dobs=dobs, backend="lax")
    timg, tlocs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu",
                                    backend="tiled")
    assert_close(timg, jimg)
    assert_close(tlocs, jlocs)
    mimg, mlocs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, backend="tiled",
                                    mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    np.testing.assert_array_equal(mlocs, tlocs)
    np.testing.assert_array_equal(mimg, timg)
    # the maker at K = 1 (fd_step) on real shot groups of 2 and 1 shots
    ctx = solver.FDContext.from_params(tp, exact_taper=False)
    g = tpk.Geometry.from_params(tp)
    v2 = torch.from_numpy(tpipe.prepare_velocity_cpu(tp, vp))
    wav = tpk.numerics.ricker_wavelet(tp.nt, tp.dt, tp.fpeak, truncated=True)
    nxt = np.concatenate([dobs[1:, 0, 0], [0.0]]).astype(np.float32)
    fn = make_sharded_rtm_full_tiled(ctx, make_mesh(2, 1, devices=["cpu"] * 2),
                                     g.sz, g.gz, block_k=1)
    d = torch.from_numpy(np.ascontiguousarray(dobs))
    assert_close(fn(v2, d, g.sx, nxt, wav), jlocs)


def test_run_rtm_cpu_backend_routing(monkeypatch):
    tp = tpk.Params(nt=6, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    dobs = tpipe.run_modeling(tp, vp=vp, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu", backend="lax")
    calls = []
    full = tpipe.rtm_shot_full_tiled
    monkeypatch.setattr(tpipe, "rtm_shot_full_tiled",
                        lambda *a, **kw: calls.append(kw["block_k"])
                        or full(*a, **kw))
    pallas = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu",
                               backend="pallas")
    assert calls == []
    tiled = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu",
                              backend="tiled")
    assert calls == [tpipe.TILED_BLOCK_K]
    for a, b in zip(tiled, pallas):    # K >= 2 is rtm_full_cuda's path
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ the wrappers

def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    _, ctx = _ctxs()
    rng = np.random.default_rng(6)
    v2 = torch.from_numpy(_inputs(ctx, 6)[0])
    p, pp, q, r = (torch.from_numpy(rng.standard_normal(
        (2, ctx.nxe, ctx.nze)).astype(np.float32)) for _ in range(4))
    row = torch.from_numpy(rng.standard_normal((2, ctx.nx)).astype(
        np.float32))
    stream.reset_launches()
    for kw in ({}, dict(amp=0.5, sx=SXS, sz=SZ),
               dict(amp=0.5, sx=SXS, sz=SZ, source="point"),
               dict(inj_row=row, x0=ctx.nxb, gz=GZ)):
        for taper in ("all", "top"):
            got = stream.fd_step_cuda(ctx, p, pp, v2, taper, out=(q, r),
                                      **kw)
            for a, b in zip(got, solver.fd_step(ctx, p, pp, v2, taper, **kw)):
                assert torch.equal(a, b)
    assert torch.equal(stream.fd_update_cuda(ctx, p, pp, v2, out=q),
                       solver.fd_update(ctx, p, pp, v2))
    assert stream.LAUNCHES == dict.fromkeys(stream.LAUNCHES, 0)
    assert set(stream.LAUNCHES) >= {"fd_step", "fd_update"}


@pytest.mark.parametrize("bad", ["shape", "dtype", "window", "gz", "row",
                                 "out_alias", "out_count", "taper", "order"])
def test_stream_step_wrappers_raise_on_bad_inputs(bad):
    _, ctx = _ctxs()
    v2 = torch.from_numpy(_inputs(ctx, 7)[0])
    p = torch.zeros((2, ctx.nxe, ctx.nze))
    pp = torch.zeros_like(p)
    row = torch.zeros((2, ctx.nx))
    kw = dict(amp=1.0, sx=SXS, sz=SZ)
    out = None
    taper = "all"
    if bad == "shape":
        pp = pp[:, 1:]
    elif bad == "dtype":
        p = p.double()
    elif bad == "window":
        kw["sx"] = (2, SXS[1])
    elif bad == "gz":
        kw = dict(inj_row=row, gz=ctx.nze)
    elif bad == "row":
        kw = dict(inj_row=row[:, 1:], gz=GZ)
    elif bad == "out_alias":
        out = (p, torch.zeros_like(p))
    elif bad == "out_count":
        out = (torch.zeros_like(p),)
    elif bad == "taper":
        taper = "left"
    else:
        ctx = dataclasses.replace(ctx, order=5)
    with pytest.raises((TypeError, ValueError)):
        stream.fd_step_cuda(ctx, p, pp, v2, taper, out=out, **kw)
    if bad in ("shape", "dtype", "out_alias", "order"):
        with pytest.raises((TypeError, ValueError)):
            stream.fd_update_cuda(ctx, p, pp, v2,
                                  out=None if out is None else out[0])


def test_block_k_bounds():
    assert [stream.check_block_k(k) for k in (1, 2, 8)] == [1, 2, 8]
    for bad in (0, 9, -1):
        with pytest.raises(ValueError, match="block_k"):
            stream.check_block_k(bad)
    _, ctx = _ctxs()
    v2, wav, dobs = _inputs(ctx, 8)
    for fn, args in (
            (solver.backward_recorded_tiled, (torch.from_numpy(dobs), GZ)),
            (solver.rtm_shot_full_tiled,
             (wav, torch.from_numpy(dobs), SXS, SZ, GZ))):
        with pytest.raises(ValueError, match="block_k"):
            fn(ctx, torch.from_numpy(v2), *args, block_k=9)
