"""The ``rtm_main`` flavor (full-wavefield RTM) of the port against the JAX
package: ``forward_modeling(record="wavefield")``, ``_injection_rows``,
``backward_recorded``, ``rtm_shot_full`` and ``run_rtm_cpu``, and the
``rtm`` CLI command. The same inputs, made with numpy from a seed, go to
both; the constants cross over through ``convert.context_from_arrays``.
``rtm_shot_full`` is also held against ``rtm_shot_full_tiled`` in interpret
mode, which runs the Pallas kernel ``_kstep_rec_kernel`` that the port's
``rec_fwd_step``/``rec_bwd_step`` replace.

Tolerance: ``max|port - jax| <= 1e-5 * max(1, max|jax|)``, as the JAX
package holds its own tiers to each other (``tests/test_pallas_stream.py``).
The port rounds each op on its own; XLA on the CPU contracts some
multiply-adds. The wrappers' CPU route is the plain version, bitwise.

The kernels themselves are held against these plain versions on the card
by the ``cuda``-marked tests of ``tests/test_torch_kernels.py``, which
import no JAX."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import cli as jcli
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext, _injection_rows as j_injection_rows,
    backward_recorded as j_backward_recorded,
    forward_modeling as j_forward_modeling, rtm_shot_full as j_rtm_shot_full,
    rtm_shot_full_tiled as j_rtm_shot_full_tiled)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import cli as tcli
from parallel_finite_difference_computation_tpu_torch import (
    io as tio, pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk)

GATE = 1e-5
NXT = (0.25, -0.5)          # next_shot_first per shot


def assert_close(got, want):
    """``max|got - want| <= 1e-5 * max(1, max|want|)``."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GATE * max(1.0, np.abs(want).max())


def _setup(nt=10, order=8, nxb=6, nzb=5, seed=4, nx=26, nz=34):
    """JAX and port contexts (exact_taper=False, as run_rtm_cpu builds
    them), one velocity, two shots' data and geometry."""
    rng = np.random.default_rng(seed)
    jctx = JaxContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                             order=order, nxb=nxb, nzb=nzb, fac=0.7,
                             exact_taper=False)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    v2 = (1500.0 + 500.0 * rng.random((ctx.nxe, ctx.nze))
          ).astype(np.float32) ** 2
    wav = jnum.ricker_wavelet(nt, 0.001, 30.0)
    dobs = rng.standard_normal((2, ctx.nx, nt)).astype(np.float32)
    sxs = (nxb + 9, nxb + 15)
    return jctx, ctx, v2, wav, dobs, sxs, nzb + 2, nzb + 1


@pytest.mark.parametrize("nt", [10, 11])
@pytest.mark.parametrize("source,taper", [("point", "top"),
                                          ("gaussian", "all")])
def test_forward_modeling_wavefield(nt, source, taper):
    jctx, ctx, v2, wav, _, sxs, sz, gz = _setup(nt)
    tv2 = torch.from_numpy(v2)
    got = solver.forward_modeling(ctx, tv2, wav, sxs, sz, gz, source=source,
                                  taper=taper, record="wavefield")
    assert got[2].shape == (2, nt, ctx.nx, ctx.nz)
    wrapped = fk.forward_modeling_cuda(ctx, tv2, wav, sxs, sz, gz,
                                       source=source, taper=taper,
                                       record="wavefield")
    for a, b in zip(got, wrapped):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    none = solver.forward_modeling(ctx, tv2, wav, sxs, sz, gz, source=source,
                                   taper=taper, record="none")
    assert none[2] is None
    np.testing.assert_array_equal(none[0].numpy(), got[0].numpy())
    for s, sx in enumerate(sxs):
        ref = j_forward_modeling(jctx, jnp.asarray(v2), jnp.asarray(wav), sx,
                                 sz, gz, source=source, taper=taper,
                                 record="wavefield")
        for a, b in zip(got, ref):
            assert_close(a[s], b)


def test_unknown_record_mode_raises():
    _, ctx, v2, wav, _, sxs, sz, gz = _setup()
    for fn in (solver.forward_modeling, fk.forward_modeling_cuda):
        with pytest.raises(ValueError, match="record"):
            fn(ctx, torch.from_numpy(v2), wav, sxs, sz, gz, record="frames")


@pytest.mark.parametrize("nt", [10, 11])
def test_injection_rows(nt):
    jctx, ctx, _, _, dobs, _, _, _ = _setup(nt)
    got = solver._injection_rows(ctx, torch.from_numpy(dobs),
                                 torch.tensor(NXT))
    assert got.shape == (2, nt, ctx.nx)
    for s in range(2):
        np.testing.assert_array_equal(
            got[s].numpy(),
            np.asarray(j_injection_rows(jctx, jnp.asarray(dobs[s]), NXT[s])))
    # one number for every shot
    one = solver._injection_rows(ctx, torch.from_numpy(dobs), 0.75)
    assert (one[:, 0, -1] == 0.75).all()


@pytest.mark.parametrize("nt", [10, 11])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("nxb,nzb", [(6, 5), (3, 8)])   # (3, 8): clamped row
def test_backward_recorded(nt, quirk, nxb, nzb):
    jctx, ctx, v2, _, dobs, _, _, gz = _setup(nt, nxb=nxb, nzb=nzb)
    if quirk and nzb > 2 * nxb:
        # the row nzb would leave the grid; the JAX slice clamps it
        assert solver.receiver_offset(ctx, quirk) == 2 * nxb
    tv2, td = torch.from_numpy(v2), torch.from_numpy(dobs)
    got = solver.backward_recorded(ctx, tv2, td, gz, x_off_quirk=quirk,
                                   next_shot_first=NXT)
    assert got[2].shape == (2, nt, ctx.nx, ctx.nz)
    wrapped = fk.backward_recorded_cuda(ctx, tv2, td, gz, x_off_quirk=quirk,
                                        next_shot_first=NXT)
    for a, b in zip(got, wrapped):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for s in range(2):
        ref = j_backward_recorded(jctx, jnp.asarray(v2), jnp.asarray(dobs[s]),
                                  gz, x_off_quirk=quirk,
                                  next_shot_first=NXT[s])
        for a, b in zip(got, ref):
            assert_close(a[s], b)


@pytest.mark.parametrize("nt", [10, 11])
@pytest.mark.parametrize("quirk", [True, False])
def test_rtm_shot_full_vs_lax(nt, quirk):
    jctx, ctx, v2, wav, dobs, sxs, sz, gz = _setup(nt)
    tv2, td = torch.from_numpy(v2), torch.from_numpy(dobs)
    got = solver.rtm_shot_full(ctx, tv2, wav, td, sxs, sz, gz,
                               x_off_quirk=quirk, next_shot_first=NXT)
    assert got.shape == (2, ctx.nx, ctx.nz)
    np.testing.assert_array_equal(
        got.numpy(), fk.rtm_full_cuda(ctx, tv2, wav, td, sxs, sz, gz,
                                      x_off_quirk=quirk,
                                      next_shot_first=NXT).numpy())
    for s, sx in enumerate(sxs):
        assert_close(got[s], j_rtm_shot_full(
            jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[s]), sx,
            sz, gz, x_off_quirk=quirk, next_shot_first=NXT[s]))


@pytest.mark.parametrize("block_k", [2, 3])
def test_rtm_shot_full_vs_pallas_kstep_rec_interpret(block_k):
    """Against ``_kstep_rec_kernel`` (the TPU kernel rec_fwd_step and
    rec_bwd_step replace) in interpret mode, both quirk settings."""
    jctx, ctx, v2, wav, dobs, sxs, sz, gz = _setup(10, seed=11)
    for quirk in (True, False):
        got = solver.rtm_shot_full(ctx, torch.from_numpy(v2), wav,
                                   torch.from_numpy(dobs), sxs, sz, gz,
                                   x_off_quirk=quirk, next_shot_first=NXT)
        for s, sx in enumerate(sxs):
            ref = j_rtm_shot_full_tiled(
                jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[s]),
                sx, sz, gz, x_off_quirk=quirk, next_shot_first=NXT[s],
                tile_rows=16, interpret=True, block_k=block_k)
            assert_close(got[s], ref)


def test_clamped_receiver_row_follows_the_lax_path():
    """With nzb > 2*nxb the quirk's receiver row is clamped into the grid
    by the lax path's dynamic_update_slice; the JAX tiled tier does not
    clamp it and gives another image. The port follows the lax path."""
    jctx, ctx, v2, wav, dobs, sxs, sz, gz = _setup(10, nxb=3, nzb=8)
    got = solver.rtm_shot_full(ctx, torch.from_numpy(v2), wav,
                               torch.from_numpy(dobs[:1]), sxs[:1], sz, gz)
    args = (jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[0]),
            sxs[0], sz, gz)
    lax = np.asarray(j_rtm_shot_full(*args))
    assert_close(got[0], lax)
    for block_k in (1, 2):
        tiled = np.asarray(j_rtm_shot_full_tiled(
            *args, tile_rows=16, interpret=True, block_k=block_k))
        assert np.abs(tiled - lax).max() / np.abs(lax).max() > 0.5


@pytest.mark.parametrize("order", [2, 4, 6, 10])
def test_rtm_shot_full_other_orders(order):
    jctx, ctx, v2, wav, dobs, sxs, sz, gz = _setup(10, order=order)
    got = solver.rtm_shot_full(ctx, torch.from_numpy(v2), wav,
                               torch.from_numpy(dobs), sxs, sz, gz,
                               next_shot_first=NXT)
    for s, sx in enumerate(sxs):
        assert_close(got[s], j_rtm_shot_full(
            jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[s]), sx,
            sz, gz, next_shot_first=NXT[s]))


@pytest.mark.parametrize("bad", ["dobs_shape", "dobs_dtype", "nxt", "gz",
                                 "swf_shape", "order"])
def test_rec_wrappers_raise_on_bad_inputs(bad):
    _, ctx, v2, wav, dobs, sxs, sz, gz = _setup()
    tv2, td = torch.from_numpy(v2), torch.from_numpy(dobs)
    nxt = NXT
    swf = torch.zeros((2, ctx.nt, ctx.nx, ctx.nz))
    if bad == "dobs_shape":
        td = td[..., 1:]
    elif bad == "dobs_dtype":
        td = td.double()
    elif bad == "nxt":
        nxt = (0.1, 0.2, 0.3)
    elif bad == "gz":
        gz = ctx.nze
    elif bad == "swf_shape":
        swf = swf[:, 1:]
    else:                              # every even order runs on the CPU
        ctx = dataclasses.replace(ctx, order=7)
    with pytest.raises((TypeError, ValueError)):
        fk.backward_image_cuda(ctx, tv2, swf, td, gz, next_shot_first=nxt)
    if bad != "swf_shape":
        with pytest.raises((TypeError, ValueError)):
            fk.backward_recorded_cuda(ctx, tv2, td, gz, next_shot_first=nxt)


# ------------------------------------------------------------- pipeline, CLI

CFG = dict(nz=24, nx=28, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0, ns=3, sz=4,
           fsx=6, ds=7, gz=1, nxb=8, nzb=6, fac=0.7, order=8)


@pytest.mark.parametrize("nt", [10, 11])
def test_run_rtm_cpu_matches_jax(tmp_path, nt):
    jp, tp = jpk.Params(nt=nt, **CFG), tpk.Params(nt=nt, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    dobs = jpipe.run_modeling(jp, vp=vp, backend="lax")
    for sel in (None, [1, 2]):
        jout, tout = tmp_path / f"j{sel}", tmp_path / f"t{sel}"
        jout.mkdir()
        tout.mkdir()
        jimg, jlocs = jpipe.run_rtm_cpu(jp, vp=vp, dobs=dobs,
                                        outdir=str(jout), backend="lax",
                                        shot_indices=sel)
        timg, tlocs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs,
                                        outdir=str(tout), device="cpu",
                                        shot_indices=sel)
        n = tp.ns if sel is None else len(sel)
        assert tlocs.shape == (n, tp.nx, tp.nz) and timg.dtype == np.float32
        assert_close(timg, jimg)
        for s in range(n):
            assert_close(tlocs[s], jlocs[s])
        assert sorted(os.listdir(tout)) == ["dir.image", "dir.img"]
        # the files hold the returned arrays, byte for byte
        assert (tout / "dir.image").read_bytes() == timg.tobytes()
        assert (tout / "dir.img").read_bytes() == tlocs.tobytes()
        for name in ("dir.image", "dir.img"):
            assert_close(tio.read_f32(str(tout / name)),
                         tio.read_f32(str(jout / name)))
    # a subset reproduces those shots of the whole run (the cross-shot
    # sample of shot 1 is shot 2's, not 0)
    _, whole = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu")
    np.testing.assert_array_equal(tlocs, whole[1:])


def test_run_rtm_cpu_batches_shots(monkeypatch):
    """Shots beyond the device budget run in batches, with the same
    result."""
    tp = tpk.Params(nt=10, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    dobs = np.random.default_rng(2).standard_normal(
        (tp.ns, tp.nx, tp.nt)).astype(np.float32)
    _, whole = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu")
    calls = []
    real = tpipe.rtm_full_cuda
    monkeypatch.setattr(tpipe, "rtm_full_cuda",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    monkeypatch.setattr(tpipe, "_RTM_BATCH_BYTES",
                        2 * tp.nt * tp.nx * tp.nz * 4)
    _, batched = tpipe.run_rtm_cpu(tp, vp=vp, dobs=dobs, device="cpu")
    assert [len(c) for c in calls] == [2, 1]
    np.testing.assert_array_equal(batched, whole)


def test_cli_rtm_matches_jax(tmp_path, capsys):
    p = tpk.Params(nt=10, **CFG)
    vp = layered_model(p.nx, p.nz)
    tio.write_f32(str(tmp_path / "vp.bin"), vp)
    cfg = tmp_path / "input.dat"
    cfg.write_text("".join(f"{k}={v}\n" for k, v in dict(CFG, nt=10).items())
                   + "vpfile=vp.bin\ndatfile=dobs.bin\n")
    jcli.main(["mod", f"par={cfg}", "--backend", "lax"])
    capsys.readouterr()
    jout, tout = tmp_path / "jout", tmp_path / "tout"
    jout.mkdir()
    tout.mkdir()
    jcli.main(["rtm", f"par={cfg}", "--outdir", str(jout)])
    j_out = capsys.readouterr().out
    tcli.main(["rtm", f"par={cfg}", "--outdir", str(tout), "--device", "cpu"])
    t_out = capsys.readouterr().out
    echo = lambda out: [ln for ln in out.splitlines() if ln.startswith("##")]
    assert echo(t_out) == echo(j_out) and len(echo(j_out)) == 5
    assert any(ln.startswith("Execution Time: ") and ln.endswith(" seconds")
               for ln in t_out.splitlines())
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for name in ("dir.image", "dir.img"):
        assert_close(tio.read_f32(str(tout / name)),
                     tio.read_f32(str(jout / name)))


@pytest.mark.parametrize("entry", ["run_modeling", "run_rtm_gpu",
                                   "run_rtm_cpu", "cli_rtm"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Called with no device, the entry points go to the card: without CUDA
    they raise torch's own error and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default call would run")
    p = tpk.Params(nt=6, **CFG)
    vp = layered_model(p.nx, p.nz)
    dobs = np.zeros((p.ns, p.nx, p.nt), np.float32)
    call = {
        "run_modeling": lambda: tpipe.run_modeling(p, vp=vp),
        "run_rtm_gpu": lambda: tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs),
        "run_rtm_cpu": lambda: tpipe.run_rtm_cpu(p, vp=vp, dobs=dobs),
    }.get(entry)
    if call is None:
        tio.write_f32(str(tmp_path / "vp.bin"), vp)
        tio.write_f32(str(tmp_path / "dobs.bin"), dobs)
        cfg = tmp_path / "input.dat"
        cfg.write_text("".join(f"{k}={v}\n" for k, v in dict(CFG, nt=6).items())
                       + "vpfile=vp.bin\ndatfile=dobs.bin\n")
        call = lambda: tcli.main(["rtm", f"par={cfg}", "--outdir",
                                  str(tmp_path)])
    fk.reset_launches()
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
        call()
    assert not (tmp_path / "dir.image").exists()
