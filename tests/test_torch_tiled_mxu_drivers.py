"""The split-bf16 lowering of the large-grid tier at K >= 2 (``lap_impl``
``"mxu"``, ``"mxu6"``, ``"auto"``; kernel-table rows 10-13) against the JAX
package on the CPU, as a whole (the passes one by one are in
``tests/test_torch_tiled_mxu.py``):

* the two tiled drivers, batched over two shots, against the JAX tiled
  drivers (interpret mode, nt % K != 0); split differs from exact, mxu6
  lies closer to it than mxu, both within the JAX tests' own gates;
* the slice: ``run_modeling`` and ``run_rtm_gpu`` with ``backend="tiled"``
  and the CLI, per shot against the JAX tiled drivers; ``auto`` resolving
  as the JAX package resolves it.

Tolerance: ``max|port - jax| <= 5e-6 * max|jax|`` (PARITY), as pass by
pass. The slice's RTM images are held to the JAX package's contract between
its tiers, 1e-5 (``ops/pallas_stream.py:52-59``; ``tests/test_torch_tiled.
py`` holds the exact slice to it): the two-snapshot RTM rebuilds the source
field backward in time without the taper, which amplifies the forward
snapshots' rounding differences (~4e-8 of max) 100-200x in the image. From
common snapshots the two backward halves agree within 7e-7 of max. The
tiers that keep the exact taps only are tested to raise in
``tests/test_torch_mxu.py`` and ``tests/test_torch_kernels.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.ops.pallas_fd import (
    resolve_lap_impl as j_resolve_lap_impl)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext, forward_modeling as j_forward_modeling,
    forward_modeling_tiled as j_forward_modeling_tiled,
    rtm_shot_snapshot as j_rtm_shot_snapshot,
    rtm_shot_snapshot_tiled as j_rtm_shot_snapshot_tiled)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli as tcli, io as tio, numerics as tnum, pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.config import Geometry
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk)

PARITY = 5e-6
TIERS = 1e-5                 # the JAX contract between its tiers
JAX_GATE = {"mxu": 1e-4, "mxu6": 1e-6}
TR = 16                      # tile_rows of the JAX streaming kernels
PARTS = {"mxu": 2, "mxu6": 3}


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


def _velocity(rng, ctx, ns=None):
    shape = (ctx.nxe, ctx.nze) if ns is None else (ns, ctx.nxe, ctx.nze)
    return ((1500.0 + 500.0 * rng.random(shape)).astype(np.float32)) ** 2


# -------------------------------------------------------- the tiled loops

def _shots(ctx):
    return (ctx.nxb + 9, ctx.nxb + 17), ctx.nzb + 2, ctx.nzb + 1


@pytest.mark.parametrize("block_k,lap_impl", [(3, "mxu"), (2, "mxu6")])
def test_forward_modeling_tiled_split_matches_jax(block_k, lap_impl):
    jctx, ctx = _ctxs(exact=False)
    rng = np.random.default_rng(50 + block_k)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 30.0)
    sxs, sz, gz = _shots(ctx)
    got = solver.forward_modeling_tiled(ctx, torch.from_numpy(v2), wav, sxs,
                                        sz, gz, block_k=block_k,
                                        lap_impl=lap_impl)
    assert got[2].shape == (2, ctx.nt, ctx.nx)
    for s, sx in enumerate(sxs):
        want = j_forward_modeling_tiled(jctx, jnp.asarray(v2),
                                        jnp.asarray(wav), sx, sz, gz,
                                        tile_rows=TR, interpret=True,
                                        block_k=block_k, lap_impl=lap_impl)
        for a, b in zip(got, want):
            assert max_rel(a[s], b) <= PARITY


@pytest.mark.parametrize("block_k,lap_impl", [(2, "mxu"), (3, "mxu6")])
def test_rtm_shot_snapshot_tiled_split_matches_jax(block_k, lap_impl):
    jctx, ctx = _ctxs()
    rng = np.random.default_rng(60 + block_k)
    v2 = _velocity(rng, ctx, ns=2)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 30.0)
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    sxs, sz, gz = _shots(ctx)
    got = solver.rtm_shot_snapshot_tiled(ctx, torch.from_numpy(v2), wav,
                                         torch.from_numpy(dobs), sxs, sz, gz,
                                         block_k=block_k, lap_impl=lap_impl)
    for s, sx in enumerate(sxs):
        want = j_rtm_shot_snapshot_tiled(
            jctx, jnp.asarray(v2[s]), jnp.asarray(wav), jnp.asarray(dobs[s]),
            sx, sz, gz, tile_rows=TR, interpret=True, block_k=block_k,
            lap_impl=lap_impl)
        assert max_rel(got[s], want) <= PARITY


def test_split_tiers_differ_from_exact_and_mxu6_lies_closer():
    """The tiled drivers with split taps are not the exact ones; mxu6 lies
    closer to the exact taps than mxu, and both lie within the JAX tests'
    gates of the exact lax path (1e-4 for mxu, 1e-6 for mxu6, of max)."""
    jctx, ctx = _ctxs(nt=11)
    rng = np.random.default_rng(70)
    v2 = _velocity(rng, ctx, ns=2)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 30.0)
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    sxs, sz, gz = _shots(ctx)
    runs = {li: (solver.forward_modeling_tiled(
                     ctx, torch.from_numpy(v2[0]), wav, sxs, sz, gz,
                     block_k=4, lap_impl=li)[2],
                 solver.rtm_shot_snapshot_tiled(
                     ctx, torch.from_numpy(v2), wav, torch.from_numpy(dobs),
                     sxs, sz, gz, block_k=4, lap_impl=li))
            for li in ("vpu", "mxu", "mxu6")}
    lax = (np.stack([np.asarray(j_forward_modeling(
                jctx, jnp.asarray(v2[0]), jnp.asarray(wav), sx, sz, gz)[2])
                for sx in sxs]),
           np.stack([np.asarray(j_rtm_shot_snapshot(
               jctx, jnp.asarray(v2[s]), jnp.asarray(wav),
               jnp.asarray(dobs[s]), sx, sz, gz)) for s, sx in enumerate(sxs)]))
    for i in range(2):
        exact = runs["vpu"][i]
        errs = {li: max_rel(runs[li][i], exact) for li in ("mxu", "mxu6")}
        assert 0 < errs["mxu6"] < errs["mxu"]
        for li in ("mxu", "mxu6"):
            d = np.abs(runs[li][i].numpy() - lax[i]).max()
            assert d <= JAX_GATE[li] * max(1.0, np.abs(lax[i]).max())


# ------------------------------------------------------- the slice, auto

CFG = dict(nz=24, nx=28, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0, ns=2, sz=4,
           fsx=6, ds=10, gz=1, nxb=8, nzb=8, fac=0.7, order=8)


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    """The 3lay-like slice at nt = 11 with pre-extended velocities (the
    parity path of the GPU suite's random boundaries), and its gathers."""
    tmp = tmp_path_factory.mktemp("slice")
    p = tpk.Params(nt=11, **CFG)
    vp = layered_model(p.nx, p.nz)
    base = np.zeros((p.nxe, p.nze), np.float32)
    base[p.nxb:p.nxb + p.nx, p.nzb:p.nzb + p.nz] = vp
    tio.write_f32(str(tmp / "vel_ext.bin"), np.stack([
        tnum.extendvel_random(base, p.nx, p.nz, p.nxb, p.nzb, seed=5 + i)
        for i in range(p.ns)]))
    p.vel_ext_file = str(tmp / "vel_ext.bin")
    dobs = np.random.default_rng(8).standard_normal(
        (p.ns, p.nx, p.nt)).astype(np.float32)
    return p, vp, dobs, tmp


@pytest.mark.parametrize("lap_impl", ["mxu6", "auto"])
def test_tiled_slice_split_matches_jax_per_shot(slice_case, lap_impl):
    p, vp, dobs, _ = slice_case
    jctx_m, ctx_m = _ctxs(8, p.nt, exact=False, nx=p.nx, nz=p.nz,
                          nxb=p.nxb, nzb=p.nzb)
    jctx_r, _ = _ctxs(8, p.nt, nx=p.nx, nz=p.nz, nxb=p.nxb, nzb=p.nzb)
    assert fk.resolve_lap_impl(ctx_m, lap_impl) == (
        "mxu" if lap_impl == "auto" else lap_impl)
    g = Geometry.from_params(p)
    data = tpipe.run_modeling(p, vp=vp, device="cpu", backend="tiled",
                              lap_impl=lap_impl)
    img, locs = tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, device="cpu",
                                  backend="tiled", lap_impl=lap_impl)
    v2_m = tpipe.prepare_velocity_cpu(p, vp)
    v2_r = tpipe.prepare_velocities_gpu(p, vp, device="cpu").numpy()
    kw = dict(tile_rows=TR, interpret=True, block_k=tpipe.TILED_BLOCK_K,
              lap_impl=lap_impl)
    for s, sx in enumerate(g.sx):
        want = j_forward_modeling_tiled(
            jctx_m, jnp.asarray(v2_m),
            jnp.asarray(jnum.ricker_wavelet(p.nt, p.dt, p.fpeak,
                                            truncated=True)),
            int(sx), g.sz, g.gz, **kw)[2]
        assert max_rel(data[s].T, want) <= PARITY
        want = j_rtm_shot_snapshot_tiled(
            jctx_r, jnp.asarray(v2_r[s]),
            jnp.asarray(jnum.ricker_wavelet(p.nt, p.dt, p.fpeak)),
            jnp.asarray(dobs[s]), int(sx), g.sz, g.gz, **kw)
        assert max_rel(locs[s], want) <= TIERS
    np.testing.assert_array_equal(img, locs.sum(axis=0))


def test_cli_tiled_split_runs(slice_case):
    """CLI ``mod``/``rtm_gpu --backend tiled --lap-impl mxu6`` run, as the
    pipelines do."""
    p, vp, dobs, tmp = slice_case
    tio.write_f32(str(tmp / "vp.bin"), vp)
    cfg = tmp / "input.dat"
    cfg.write_text("".join(f"{k}={v}\n" for k, v in dict(CFG, nt=11).items())
                   + f"vpfile={tmp / 'vp.bin'}\nvel_ext_flag=1\n"
                   f"vel_ext_file={p.vel_ext_file}\n")
    tcli.main(["mod", str(cfg), "--device", "cpu", "--backend", "tiled",
               "--lap-impl", "mxu6", "--output", str(tmp / "d.bin")])
    d = tio.read_f32(str(tmp / "d.bin")).reshape(p.ns, p.nx, p.nt)
    np.testing.assert_array_equal(d, tpipe.run_modeling(
        p, vp=vp, device="cpu", backend="tiled", lap_impl="mxu6"))
    out = tmp / "out"
    out.mkdir()
    cfg.write_text(cfg.read_text() + f"datfile={tmp / 'd.bin'}\n")
    tcli.main(["rtm_gpu", str(cfg), "--device", "cpu", "--backend", "tiled",
               "--lap-impl", "mxu6", "--outdir", str(out)])
    img = tio.read_f32(str(out / "dir.image")).reshape(p.nx, p.nz)
    want, _ = tpipe.run_rtm_gpu(p, vp=vp, dobs=d, device="cpu",
                                backend="tiled", lap_impl="mxu6")
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("nt,resolved", [(1001, "mxu"), (4500, "mxu6"),
                                         (4501, "vpu")])
def test_auto_resolves_as_jax_on_the_tiled_tier(nt, resolved):
    """``auto`` on an isotropic grid: mxu up to nt 1500, mxu6 up to
    ``MXU6_NT_MAX`` = 4500, the exact taps beyond, as the JAX package
    resolves it; the tiled driver with ``auto`` is bitwise the one with the
    resolved value (a tiny grid, so that thousands of steps stay cheap)."""
    jctx, ctx = _ctxs(2, nt, exact=False, nx=3, nz=2, nxb=3, nzb=3,
                      dt=0.0002)
    assert fk.resolve_lap_impl(ctx, "auto") == resolved
    assert j_resolve_lap_impl(jctx, "auto") == resolved
    assert fk.lap_parts("auto", ctx) == PARTS.get(resolved, 0)
    v2 = torch.full((ctx.nxe, ctx.nze), 1500.0 ** 2)
    wav = jnum.ricker_wavelet(nt, 0.0002, 25.0)
    run = lambda li: solver.forward_modeling_tiled(
        ctx, v2, wav, [4], 4, 3, source="point", block_k=8, lap_impl=li)[2]
    got = run("auto")
    assert torch.equal(got, run(resolved))
    assert torch.isfinite(got).all() and float(got.abs().max()) > 0
