"""The kernel wrappers, the build, and the port's independence from JAX.

On the CPU the wrappers route to the plain versions, so these tests check
what surrounds the CUDA kernels: routing, launch counters, input checks,
the C signatures the ctypes bindings declare, and that a missing ``nvcc``
raises rather than falls back. The tests marked ``cuda`` run the kernels
against their plain versions on the card and skip where there is none
(``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest`` on
a GPU machine; this file imports no JAX)."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli as tcli, numerics, pipeline, solver)
from parallel_finite_difference_computation_tpu_torch.models import (
    layered_model)
from parallel_finite_difference_computation_tpu_torch.ops import (
    _build, fd_kernels as fk, stream)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "parallel_finite_difference_computation_tpu_torch"
SXS, SZ, GZ = (20, 14), 12, 9
GATE = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _setup(nt=6, order=8, device="cpu", seed=5):
    rng = np.random.default_rng(seed)
    ctx = solver.FDContext.create(28, 24, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=8, nzb=8, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (len(SXS), ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(device)
    wav = numerics.ricker_wavelet(nt, 0.001, 25.0)
    dobs = torch.from_numpy(rng.standard_normal(
        (len(SXS), ctx.nx, nt)).astype(np.float32)).to(device)
    return ctx, v2, wav, dobs


def test_port_imports_and_runs_without_jax(tmp_path):
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["parallel_finite_difference_computation_tpu"] = None
sys.path.insert(0, {str(REPO)!r})
import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli, config, convert, io, numerics, pipeline, solver)
from parallel_finite_difference_computation_tpu_torch.models import zoo
from parallel_finite_difference_computation_tpu_torch.ops import (
    _build, banded, fd_kernels, padded, stencil)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain, domain2d, domain2d_kernels, domain_kernels, mesh, shots)
import numpy as np
p = tpk.Params(nz=12, nx=14, nt=6, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
               ns=2, sz=3, fsx=4, ds=5, gz=1, nxb=5, nzb=5, fac=0.7)
vp = zoo.layered_model(p.nx, p.nz)
d = pipeline.run_modeling(p, vp=vp, device="cpu")
dm6 = pipeline.run_modeling(p, vp=vp, device="cpu", lap_impl="mxu6")
assert np.abs(dm6 - d).max() <= 1e-5 * np.abs(d).max()
img, _ = pipeline.run_rtm_gpu(p, vp=vp, dobs=d, outdir={str(tmp_path)!r},
                              device="cpu")
m = mesh.make_mesh(1, 2, devices=["cpu", "cpu"])
dm = pipeline.run_modeling(p, vp=vp, mesh=m)
imgm, _ = pipeline.run_rtm_gpu(p, vp=vp, dobs=d, mesh=m)
assert dm.shape == d.shape and np.abs(dm - d).max() <= 1e-5 * np.abs(d).max()
assert np.abs(imgm - img).max() <= 1e-5 * np.abs(img).max()
ctx = solver.FDContext.from_params(p, exact_taper=False)
g = config.Geometry.from_params(p)
seis = domain_kernels.make_sharded_forward_modeling_cuda(
    ctx, m, g.sz, g.gz, block_k=2)(
    pipeline.prepare_velocity_cpu(p, vp), g.sx,
    numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True))
assert np.array_equal(seis[:, :, p.nxb:p.nxb + p.nx].transpose(1, 2), d)
m4 = mesh.make_mesh(1, 2, 2, devices=["cpu"] * 4)    # (x, z) tiles
dz = pipeline.run_modeling(p, vp=vp, mesh=m4)
imgz, _ = pipeline.run_rtm_gpu(p, vp=vp, dobs=d, mesh=m4)
assert np.array_equal(dz, d)
assert np.abs(imgz - img).max() <= 1e-5 * np.abs(img).max()
seis2 = domain2d_kernels.make_sharded_forward_modeling_2d_cuda(
    ctx, m4, g.sz, g.gz, block_k=2)(
    pipeline.prepare_velocity_cpu(p, vp), g.sx,
    numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True))
assert np.array_equal(seis2[:, :, p.nxb:p.nxb + p.nx].transpose(1, 2), d)
img2, _ = pipeline.run_rtm_cpu(p, vp=vp, dobs=d, device="cpu")
p.tmpdir = {str(tmp_path / "field.bin")!r}
io.write_f32(p.tmpdir, np.ones((p.nxe, p.nze), np.float32))
lap = pipeline.run_stencil(p, device="cpu")
assert d.shape == (2, 14, 6) and img.shape == img2.shape == (14, 12)
assert lap.shape == (p.nxe, p.nze)
assert not any(m == "jax" or m.startswith("jax.") for m, v in
               sys.modules.items() if v is not None)
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_no_port_file_imports_jax():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|"
        r"(import|from)\s+parallel_finite_difference_computation_tpu\b(?!_))",
        re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_cpu_tensors_leave_launch_counters_at_zero():
    ctx, v2, wav, dobs = _setup()
    fk.reset_launches()
    fk.forward_modeling_cuda(ctx, v2[0], wav, SXS, SZ, GZ)
    p, pp = fk.fd_forward_cuda(ctx, v2, wav, SXS, SZ)
    fk.fd_back_cuda(ctx, v2, p, pp, dobs, GZ)
    fk.rtm_snapshot_cuda(ctx, v2, wav, dobs, SXS, SZ, GZ)
    fk.forward_modeling_cuda(ctx, v2[0], wav, SXS, SZ, GZ, record="wavefield")
    fk.backward_recorded_cuda(ctx, v2, dobs, GZ)
    fk.rtm_full_cuda(ctx, v2, wav, dobs, SXS, SZ, GZ)
    fk.laplacian_cuda(v2[0], ctx.coefs_x, ctx.coefs_z, ctx.order)
    stream.reset_launches()
    for lap_impl in ("mxu", "mxu6"):
        fk.forward_modeling_cuda(ctx, v2[0], wav, SXS, SZ, GZ,
                                 lap_impl=lap_impl)
        fk.rtm_snapshot_cuda(ctx, v2, wav, dobs, SXS, SZ, GZ,
                             lap_impl=lap_impl)
        solver.forward_modeling_tiled(ctx, v2[0], wav, SXS, SZ, GZ,
                                      block_k=4, lap_impl=lap_impl)
        solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, SXS, SZ, GZ,
                                       block_k=4, lap_impl=lap_impl)
        solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, SXS, SZ, GZ,
                                       block_k=1, lap_impl=lap_impl)
        solver.rtm_shot_full_tiled(ctx, v2[0], wav, dobs, SXS, SZ, GZ,
                                   block_k=1, lap_impl=lap_impl)
        fk.rtm_full_cuda(ctx, v2[0], wav, dobs, SXS, SZ, GZ,
                         lap_impl=lap_impl)
        fk.backward_recorded_cuda(ctx, v2, dobs, GZ, lap_impl=lap_impl)
    assert fk.LAUNCHES == {"mod_step": 0, "rtm_fwd_step": 0,
                           "rtm_bwd_step": 0, "rtm_fwd_cluster": 0,
                           "rtm_bwd_cluster": 0, "mod_cluster": 0,
                           "rec_fwd_cluster": 0, "rec_bwd_cluster": 0,
                           "rec_fwd_step": 0, "rec_bwd_step": 0,
                           "lap_apply": 0,
                           "mod_step_mma": 0, "rtm_fwd_step_mma": 0,
                           "rtm_bwd_step_mma": 0, "rec_fwd_step_mma": 0,
                           "rec_bwd_step_mma": 0}
    assert stream.LAUNCHES == {"fd_step": 0, "fd_update": 0,
                               "kstep_mod": 0, "kstep_gpu_fwd": 0,
                               "kstep_gpu_bwd": 0, "gpu_step": 0,
                               "kstep_mod_mma": 0, "kstep_gpu_fwd_mma": 0,
                               "kstep_gpu_bwd_mma": 0, "gpu_step_mma": 0,
                               "fd_step_mma": 0, "fd_update_mma": 0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "wavelet",
                                 "order", "source", "gz"])
def test_wrappers_raise_on_bad_inputs(bad):
    ctx, v2, wav, dobs = _setup()
    sxs, gz = list(SXS), GZ
    if bad == "dtype":
        v2 = v2.double()
    elif bad == "shape":
        v2 = v2[:, :-1]
    elif bad == "strides":
        v2 = v2.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "wavelet":
        wav = wav[:-1]
    elif bad == "order":               # every even order runs on the CPU
        ctx = dataclasses.replace(ctx, order=7)
    elif bad == "source":
        sxs = [1, 20]                  # the 7x7 window leaves the grid
    elif bad == "gz":
        gz = ctx.nze
    with pytest.raises((TypeError, ValueError)):
        fk.forward_modeling_cuda(ctx, v2[0], wav, sxs, SZ, gz)
    if bad not in ("source", "gz"):
        with pytest.raises((TypeError, ValueError)):
            fk.fd_forward_cuda(ctx, v2, wav, SXS, SZ)


@pytest.mark.parametrize("bad", ["snap_shape", "dobs_shape", "dobs_dtype"])
def test_fd_back_raises_on_bad_inputs(bad):
    ctx, v2, wav, dobs = _setup()
    p, pp = fk.fd_forward_cuda(ctx, v2, wav, SXS, SZ)
    if bad == "snap_shape":
        pp = pp[:, 1:]
    elif bad == "dobs_shape":
        dobs = dobs[..., 1:]
    else:
        dobs = dobs.half()
    with pytest.raises((TypeError, ValueError)):
        fk.fd_back_cuda(ctx, v2, p, pp, dobs, GZ)


@pytest.mark.parametrize("lap_impl", ["mxu", "mxu6", "auto"])
def test_mxu_lap_impl_raises(lap_impl, tmp_path):
    """The per-step tier runs the split-bf16 tiers (on the CPU through the
    plain mxu path, which differs from the exact one), and so do the
    large-grid tier at every K and rtm_main's kernels (the z taps split,
    not the x taps: another result), each call its plain path with that
    Laplacian; only the domain tiers raise (``tests/test_torch_mxu.py``).
    ``auto`` resolves to ``mxu`` here (nt = 6, dx = dz)."""
    ctx, v2, wav, dobs = _setup()
    got = fk.forward_modeling_cuda(ctx, v2[0], wav, SXS, SZ, GZ,
                                   lap_impl=lap_impl)
    want = solver.forward_modeling(ctx, v2[0], wav, SXS, SZ, GZ,
                                   lap_impl=lap_impl)
    exact = solver.forward_modeling(ctx, v2[0], wav, SXS, SZ, GZ)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], exact[0])
    img = fk.rtm_snapshot_cuda(ctx, v2, wav, dobs, SXS, SZ, GZ,
                               lap_impl=lap_impl)
    assert torch.equal(img, solver.rtm_shot_snapshot(
        ctx, v2, wav, dobs, SXS, SZ, GZ, lap_impl=lap_impl))
    lap = solver.laplacian_of(ctx, fk.lap_parts(lap_impl, ctx), axis="z")
    snaps = solver.fd_forward(ctx, v2, wav, SXS, SZ, lap)
    wavefield = dict(source="point", taper="top", record="wavefield")
    pairs = (
        (solver.forward_modeling_tiled(ctx, v2[0], wav, SXS, SZ, GZ,
                                       lap_impl=lap_impl)[2],
         solver.forward_modeling_tiled(ctx, v2[0], wav, SXS, SZ, GZ,
                                       lap_impl=fk.lap_parts(lap_impl,
                                                             ctx))[2]),
        (solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, SXS, SZ, GZ,
                                        block_k=1, lap_impl=lap_impl),
         solver.fd_back(ctx, v2, *snaps, dobs, GZ, lap)),
        (solver.forward_modeling_tiled(ctx, v2[0], wav, SXS, SZ, GZ,
                                       block_k=2, lap_impl=lap_impl,
                                       **wavefield)[2],
         solver.forward_modeling(ctx, v2[0], wav, SXS, SZ, GZ,
                                 lap_impl=lap_impl, **wavefield)[2]),
        (fk.rtm_full_cuda(ctx, v2[0], wav, dobs, SXS, SZ, GZ,
                          lap_impl=lap_impl),
         solver.rtm_shot_full(ctx, v2[0], wav, dobs, SXS, SZ, GZ,
                              lap_impl=lap_impl)))
    for a, b in pairs:
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(pairs[3][0], fk.rtm_full_cuda(
        ctx, v2[0], wav, dobs, SXS, SZ, GZ))
    tiled = solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, SXS, SZ, GZ,
                                           block_k=2, lap_impl=lap_impl)
    assert torch.isfinite(tiled).all() and not torch.equal(tiled, img)
    p = tpk.Params(nz=12, nx=14, nt=4, dz=10.0, dx=10.0, dt=0.001,
                   fpeak=25.0, ns=1, sz=3, fsx=4, gz=1, nxb=5, nzb=5)
    vp = np.full((14, 12), 2000.0, np.float32)
    d = pipeline.run_modeling(p, vp=vp, device="cpu", lap_impl=lap_impl)
    assert d.shape == (1, 14, 4) and np.isfinite(d).all()
    dt = pipeline.run_modeling(p, vp=vp, device="cpu", backend="tiled",
                               lap_impl=lap_impl)
    assert dt.shape == d.shape and np.isfinite(dt).all()
    assert not np.array_equal(dt, d)


def test_vpu_lap_impl_is_the_exact_path():
    ctx, v2, wav, dobs = _setup()
    a = fk.rtm_snapshot_cuda(ctx, v2, wav, dobs, SXS, SZ, GZ, lap_impl="vpu")
    b = solver.rtm_shot_snapshot(ctx, v2, wav, dobs, SXS, SZ, GZ)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unsupported_device_raises():
    ctx, v2, wav, _ = _setup()
    with pytest.raises(ValueError, match="device"):
        fk.fd_forward_cuda(ctx, v2.to("meta"), wav, SXS, SZ)


def _c_signatures():
    """``extern "C"`` entry points of csrc/*.cu as lists of ctypes types."""
    sigs = {}
    for f in sorted((PORT / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       f.read_text()):
            types = []
            for prm in params.split(","):
                prm = " ".join(prm.split())
                types.append(_build._P if "*" in prm else _build._I)
                assert "*" in prm or prm.startswith("int "), prm
            sigs[name] = types
    return sigs


def test_ctypes_bindings_match_the_c_entry_points():
    assert _c_signatures() == _build._SIGNATURES


def test_build_flags_and_missing_nvcc_raise(monkeypatch, tmp_path):
    flags = " ".join(_build.NVCC_FLAGS)
    for f in ("arch=compute_90a,code=sm_90a", "-fmad=false", "-O3",
              "-std=c++17", "-shared"):
        assert f in flags
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.library()
    finally:
        _build.library.cache_clear()
    assert not (tmp_path / "_build").exists()


def test_cli_lap_impl_and_device_options(tmp_path):
    cfg = tmp_path / "input.dat"
    tpk.io.write_f32(str(tmp_path / "vp.bin"),
                     np.full((14, 12), 2000.0, np.float32))
    cfg.write_text("nz=12\nnx=14\nnt=4\ndz=10\ndx=10\ndt=0.001\nfpeak=25\n"
                   "ns=1\nsz=3\nfsx=4\ngz=1\nnxb=5\nnzb=5\nvpfile=vp.bin\n")
    # an x mesh of the CPU: the per-step loops with the exact taps, as the
    # JAX package's lax domain path runs there
    tcli.main(["mod", str(cfg), "--device", "cpu", "--lap-impl", "mxu",
               "--shards-x", "2", "--output", str(tmp_path / "x.bin")])
    tcli.main(["mod", str(cfg), "--device", "cpu", "--lap-impl", "mxu",
               "--backend", "tiled", "--output", str(tmp_path / "t.bin")])
    tcli.main(["mod", str(cfg), "--device", "cpu", "--lap-impl", "mxu",
               "--output", str(tmp_path / "m.bin")])
    tcli.main(["mod", str(cfg), "--device", "cpu", "--lap-impl", "vpu",
               "--output", str(tmp_path / "d.bin")])
    assert os.path.getsize(tmp_path / "d.bin") == 14 * 4 * 4
    d, m, t = (np.fromfile(tmp_path / f, np.float32)
               for f in ("d.bin", "m.bin", "t.bin"))
    assert d.shape == m.shape == t.shape and not np.array_equal(d, m)
    assert np.abs(m - d).max() <= 1e-4 * np.abs(d).max()
    assert not np.array_equal(t, d) and not np.array_equal(t, m)
    assert np.abs(t - d).max() <= 1e-4 * np.abs(d).max()
    assert np.array_equal(np.fromfile(tmp_path / "x.bin", np.float32), d)


# ---------------------------------------------------------------- card only

@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4, 6, 8, 10])
@pytest.mark.parametrize("nt", [10, 11])
def test_kernels_match_plain_on_the_card(cuda_device, order, nt):
    ctx, v2, wav, dobs = _setup(nt, order, device=cuda_device)
    fk.reset_launches()
    got = fk.forward_modeling_cuda(ctx, v2[0], wav, SXS, SZ, GZ)
    want = solver.forward_modeling(ctx, v2[0], wav, SXS, SZ, GZ)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= GATE
    kp = fk.fd_forward_cuda(ctx, v2, wav, SXS, SZ)
    pp = solver.fd_forward(ctx, v2, wav, SXS, SZ)
    for a, b in zip(kp, pp):
        assert float((a - b).abs().max() / b.abs().max()) <= GATE
    ki = fk.fd_back_cuda(ctx, v2, *pp, dobs, GZ)
    pi = solver.fd_back(ctx, v2, *pp, dobs, GZ)
    torch.cuda.synchronize()
    assert float((ki - pi).abs().max() / pi.abs().max()) <= GATE
    # the 44 x 40 extended shots fit a cluster: one resident launch a pass,
    # the modeling's too
    assert fk.resident_plan(ctx.nxe, ctx.nze, order) is not None
    assert fk.LAUNCHES == {"mod_step": 0, "rtm_fwd_step": 0,
                           "rtm_bwd_step": 0, "rtm_fwd_cluster": 1,
                           "rtm_bwd_cluster": 1, "mod_cluster": 1,
                           "rec_fwd_cluster": 0, "rec_bwd_cluster": 0,
                           "rec_fwd_step": 0, "rec_bwd_step": 0,
                           "lap_apply": 0,
                           "mod_step_mma": 0, "rtm_fwd_step_mma": 0,
                           "rtm_bwd_step_mma": 0, "rec_fwd_step_mma": 0,
                           "rec_bwd_step_mma": 0}


@pytest.mark.cuda
def test_cuda_wrapper_checks_device_of_every_input(cuda_device):
    ctx, v2, wav, dobs = _setup(device=cuda_device)
    p, pp = fk.fd_forward_cuda(ctx, v2, wav, SXS, SZ)
    with pytest.raises(ValueError):
        fk.fd_back_cuda(ctx, v2, p, pp, dobs.cpu(), GZ)


def _rec_setup(nt, order, nxb, nzb, device, seed=4):
    """One velocity and two shots' data for the rtm_main kernels, on a
    grid where the receiver row is clamped when nzb > 2 * nxb."""
    rng = np.random.default_rng(seed)
    ctx = solver.FDContext.create(26, 34, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7,
                                  exact_taper=False)
    v2 = torch.from_numpy((1500.0 + 500.0 * rng.random(
        (ctx.nxe, ctx.nze))).astype(np.float32) ** 2).to(device)
    wav = numerics.ricker_wavelet(nt, 0.001, 30.0)
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32)).to(device)
    return ctx, v2, wav, dobs, (nxb + 9, nxb + 15), nzb + 2, nzb + 1


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4, 6, 8, 10])
@pytest.mark.parametrize("nt", [10, 11])
@pytest.mark.parametrize("nxb,nzb", [(6, 5), (3, 8)])
def test_rec_kernels_match_plain_on_the_card(cuda_device, order, nt, nxb,
                                             nzb):
    ctx, v2, wav, dobs, sxs, sz, gz = _rec_setup(nt, order, nxb, nzb,
                                                 cuda_device)
    nxt = (0.25, -0.5)
    fk.reset_launches()
    got = fk.forward_modeling_cuda(ctx, v2, wav, sxs, sz, gz, source="point",
                                   taper="top", record="wavefield")
    want = solver.forward_modeling(ctx, v2, wav, sxs, sz, gz, source="point",
                                   taper="top", record="wavefield")
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= GATE
    for quirk in (True, False):
        kb = fk.backward_recorded_cuda(ctx, v2, dobs, gz, x_off_quirk=quirk,
                                       next_shot_first=nxt)
        pb = solver.backward_recorded(ctx, v2, dobs, gz, x_off_quirk=quirk,
                                      next_shot_first=nxt)
        for a, b in zip(kb, pb):
            assert float((a - b).abs().max() / b.abs().max()) <= GATE
        ki = fk.rtm_full_cuda(ctx, v2, wav, dobs, sxs, sz, gz,
                              x_off_quirk=quirk, next_shot_first=nxt)
        pi = solver.rtm_shot_full(ctx, v2, wav, dobs, sxs, sz, gz,
                                  x_off_quirk=quirk, next_shot_first=nxt)
        torch.cuda.synchronize()
        assert float((ki - pi).abs().max() / pi.abs().max()) <= GATE
    # the shots fit a cluster: rec_fwd_cluster and rec_bwd_cluster, one
    # launch a pass
    assert fk.resident_plan(ctx.nxe, ctx.nze, order) is not None
    assert fk.LAUNCHES["rec_fwd_cluster"] == 3
    assert fk.LAUNCHES["rec_fwd_step"] == 0
    assert fk.LAUNCHES["rec_bwd_cluster"] == 4
    assert fk.LAUNCHES["rec_bwd_step"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4, 6, 8, 10])
@pytest.mark.parametrize("shape", [(45, 139), (300, 257)])
def test_lap_apply_matches_plain_on_the_card(cuda_device, order, shape):
    rng = np.random.default_rng(order)
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cx, cz = numerics.scaled_coefficients(order, 10.0, 12.5)
    fk.reset_launches()
    got = fk.laplacian_cuda(f.to(cuda_device), cx, cz, order)
    want = fk.laplacian_cuda(f, cx, cz, order)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert fk.LAUNCHES["lap_apply"] == 1


@pytest.mark.cuda
def test_run_rtm_cpu_and_run_stencil_card_match_cpu(cuda_device, tmp_path):
    p = tpk.Params(nz=24, nx=28, nt=11, dz=10.0, dx=10.0, dt=0.001,
                   fpeak=25.0, ns=3, sz=4, fsx=6, ds=7, gz=1, nxb=8, nzb=6,
                   fac=0.7, order=8)
    vp = layered_model(p.nx, p.nz)
    dobs = np.random.default_rng(3).standard_normal(
        (p.ns, p.nx, p.nt)).astype(np.float32)
    _, locs_k = pipeline.run_rtm_cpu(p, vp=vp, dobs=dobs, device=cuda_device)
    _, locs_p = pipeline.run_rtm_cpu(p, vp=vp, dobs=dobs, device="cpu")
    assert np.abs(locs_k - locs_p).max() <= GATE * np.abs(locs_p).max()
    p.tmpdir = str(tmp_path / "field.bin")
    tpk.io.write_f32(p.tmpdir, np.random.default_rng(5).standard_normal(
        (p.nxe, p.nze)).astype(np.float32))
    np.testing.assert_array_equal(pipeline.run_stencil(p, device=cuda_device),
                                  pipeline.run_stencil(p, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10])
@pytest.mark.parametrize("block_k", [2, 4])
def test_kstep_kernels_match_plain_on_the_card(cuda_device, order, block_k):
    """The large-grid tier's kernels (kstep_mod, kstep_gpu_fwd, gpu_step,
    kstep_gpu_bwd) through the tiled loops against the whole-grid plain
    loops, on a 67 x 88 grid that is no multiple of the 32 x 64 tiles, with
    the sources and the receiver row across tile edges and nt % K != 0."""
    from parallel_finite_difference_computation_tpu_torch.ops import stream
    nt = 11
    rng = np.random.default_rng(order + block_k)
    ctx = solver.FDContext.create(53, 70, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(cuda_device)
    wav = numerics.ricker_wavelet(nt, 0.001, 30.0)
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32)).to(cuda_device)
    sxs, sz, gz = (31, ctx.nxe - 6), 62, 63
    stream.reset_launches()
    got = solver.forward_modeling_tiled(ctx, v2[0], wav, sxs, sz, gz,
                                        block_k=block_k)
    want = solver.forward_modeling(ctx, v2[0], wav, sxs, sz, gz)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= GATE
    ki = solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, sxs, sz, gz,
                                        block_k=block_k)
    pi = solver.rtm_shot_snapshot(ctx, v2, wav, dobs, sxs, sz, gz)
    torch.cuda.synchronize()
    assert float((ki - pi).abs().max() / pi.abs().max()) <= GATE
    passes = -(-nt // block_k)
    assert stream.LAUNCHES == {"fd_step": 0, "fd_update": 0,
                               "kstep_mod": passes, "kstep_gpu_fwd": passes,
                               "kstep_gpu_bwd": -(-(nt - 2) // block_k),
                               "gpu_step": 2, "kstep_mod_mma": 0,
                               "kstep_gpu_fwd_mma": 0, "kstep_gpu_bwd_mma": 0,
                               "gpu_step_mma": 0, "fd_step_mma": 0,
                               "fd_update_mma": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10, 16])
@pytest.mark.parametrize("parts", [2, 3])
def test_split_kstep_kernels_match_plain_on_the_card(cuda_device, order,
                                                     parts):
    """kstep_mod_mma (both sources and tapers), kstep_gpu_fwd_mma,
    gpu_step_mma and kstep_gpu_bwd_mma against the plain passes with the z
    taps in ``parts`` bf16 splits, pass by pass from random states and
    through the tiled loops, on the 67 x 88 grid with the sources and the
    receiver row across tile edges (they differ in the order of the tensor
    cores' float32 sums only). Order 16 runs K = 2: its split backward
    tile is refused at K = 4."""
    nt = 11
    rng = np.random.default_rng(10 * order + parts)
    ctx = solver.FDContext.create(53, 70, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(cuda_device)
    v2 = on(((1500.0 + 500.0 * rng.random((2, ctx.nxe, ctx.nze))) ** 2))
    p, pp, pr, ppr = (on(rng.standard_normal((2, ctx.nxe, ctx.nze)))
                      for _ in range(4))
    img = on(rng.standard_normal((2, ctx.nx, ctx.nz)))
    inj = on(rng.standard_normal((2, 4, ctx.nx)))
    wav = numerics.ricker_wavelet(nt, 0.001, 30.0)
    dobs = on(rng.standard_normal((2, ctx.nx, nt)))
    sxs, sz, gz = (31, ctx.nxe - 6), 62, 63
    lap = solver.laplacian_of(ctx, parts, axis="z")
    close = lambda got, want: all(
        float((a - b).abs().max() / b.abs().max()) <= GATE
        for a, b in zip(got, want))
    v2m = v2[0]
    for k in ((2,) if order == 16 else (2, 4)):
        amps = rng.standard_normal(k).astype(np.float32)
        for source, taper in (("gaussian", "all"), ("point", "top")):
            assert close(
                stream.mod_kstep_cuda(ctx, p, pp, v2m, amps, sxs, sz, gz,
                                      source, taper, parts=parts),
                solver.mod_kstep(ctx, p, pp, v2m, amps, sxs, sz, gz, source,
                                 taper, lap))
        assert close(
            stream.fd_forward_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz,
                                         parts=parts),
            solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz, lap))
        assert close(
            stream.fd_back_kstep_cuda(ctx, p, pp, pr, ppr, img.clone(), v2,
                                      inj[:, :k].contiguous(), gz,
                                      parts=parts),
            solver.fd_back_kstep(ctx, p, pp, pr, ppr, img, v2, inj[:, :k],
                                 gz, lap))
    assert close(
        stream.fd_step_gpu_cuda(ctx, pr, ppr, v2, gz, inj[:, 0].contiguous(),
                                img.clone(), p, parts=parts),
        solver.fd_step_gpu(ctx, pr, ppr, v2, gz, inj[:, 0], img, p, lap))
    block_k = 2 if order == 16 else 4
    stream.reset_launches()
    got = solver.forward_modeling_tiled(ctx, v2m, wav, sxs, sz, gz,
                                        block_k=block_k, lap_impl=parts)
    want = solver.forward_modeling_tiled(ctx, v2m.cpu(), wav, sxs, sz, gz,
                                         block_k=block_k, lap_impl=parts)
    assert close([g.cpu() for g in got], want)
    ki = solver.rtm_shot_snapshot_tiled(ctx, v2, wav, dobs, sxs, sz, gz,
                                        block_k=block_k, lap_impl=parts)
    pf = solver.fd_forward(ctx, v2, wav, sxs, sz, lap)
    pi = solver.fd_back(ctx, v2, *pf, dobs, gz, lap)
    torch.cuda.synchronize()
    assert close((ki,), (pi,))
    passes = -(-nt // block_k)
    assert {k: v for k, v in stream.LAUNCHES.items() if v} == {
        "kstep_mod_mma": passes, "kstep_gpu_fwd_mma": passes,
        "kstep_gpu_bwd_mma": -(-(nt - 2) // block_k), "gpu_step_mma": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10])
@pytest.mark.parametrize("block_k", [2, 3])
def test_block_kernels_match_plain_on_the_card(cuda_device, order, block_k):
    """The x-domain tier's kernels (block_mod, block_fwd, block_bwd) against
    their plain versions on the same CUDA tensors, launch by launch on
    random states of the slabs of a (1, 3) mesh, seeded and tail blocks
    included, block_mod with both source modes; then the two makers on a
    (2, 3) mesh of the card, and on one whose positions alternate between
    the card and the CPU (the exchange copies between devices), against
    the same makers on a CPU mesh. The grid (84 x 77 extended) is no
    multiple of 3 nor of the tiles, and the sources sit at the first slab
    edge."""
    from parallel_finite_difference_computation_tpu_torch.parallel import (
        domain_kernels as dk, make_mesh)
    from parallel_finite_difference_computation_tpu_torch.parallel.domain \
        import embed_dobs
    nt = 9
    rng = np.random.default_rng(order + block_k)
    ctx = solver.FDContext.create(70, 63, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=7, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    wav = numerics.ricker_wavelet(nt, 0.001, 30.0)
    d_ext = embed_dobs(ctx, rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32))
    sxs, sz, gz = (27, 28), 62, 63
    k = block_k
    ms = dk.prepare_slabs(ctx, [cuda_device] * 3, k, v2[0], "all", sxs=sxs,
                          sz=sz, source="gaussian", gz=gz)
    rs = dk.prepare_slabs(ctx, [cuda_device] * 3, k, v2, "top", sxs=sxs,
                          sz=sz, dobs_ext=d_ext, gz=gz)
    dk.reset_launches()

    def same(got, want):
        for a, b in zip(got, want):
            assert float((a - b).abs().max() / b.abs().max()) <= GATE

    for cm, cr in zip(ms, rs):
        f = [torch.from_numpy(rng.standard_normal(
            (2, cm.nxw, ctx.nze)).astype(np.float32)).to(cuda_device)
             for _ in range(6)]
        img = torch.from_numpy(rng.standard_normal(
            (2, cm.nxl, ctx.nze)).astype(np.float32)).to(cuda_device)
        for kk in (k, k - 1):
            a = wav[:kk]
            for c in (cm, cr):            # gaussian/all, point/top
                same(dk.block_mod_cuda(c, f[0], f[1], a),
                     dk.block_mod(c, f[0], f[1], a))
            same(dk.block_fwd_cuda(cr, f[0], f[1], a),
                 dk.block_fwd(cr, f[0], f[1], a))
            same(dk.block_bwd_cuda(cr, *f[:4], img.clone(), k, kk),
                 dk.block_bwd(cr, *f[:4], img, k, kk))
        same(dk.block_bwd_cuda(cr, *f[:4], img.clone(), 0, k, f[4:]),
             dk.block_bwd(cr, *f[:4], img, 0, k, f[4:]))
    torch.cuda.synchronize()
    assert dk.LAUNCHES == {"block_mod": 12, "block_fwd": 6, "block_bwd": 9,
                           "block_mod_mma": 0, "block_fwd_mma": 0,
                           "block_bwd_mma": 0}
    outs = []
    for devices in ([cuda_device] * 6, [cuda_device, "cpu"] * 3,
                    ["cpu"] * 6):
        mesh = make_mesh(2, 3, devices=devices)
        outs.append((
            dk.make_sharded_forward_modeling_cuda(ctx, mesh, sz, gz,
                                                  block_k=k)(v2[0], sxs, wav),
            dk.make_sharded_rtm_snapshot_cuda(ctx, mesh, sz, gz, block_k=k)(
                v2, sxs, wav, d_ext)))
    for got in outs[:2]:
        same([t.cpu() for t in got], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10])
@pytest.mark.parametrize("block_k", [2, 3])
def test_block2_kernels_match_plain_on_the_card(cuda_device, order, block_k):
    """The (x, z)-domain tier's kernels (block2_mod, block2_fwd,
    block2_bwd) against their plain versions on the same CUDA tensors,
    launch by launch on random states of the tiles of a (1, 2, 2) mesh,
    seeded and tail blocks included, block2_mod with both source modes;
    then the two makers on a (2, 2, 2) mesh of the card, and on one whose
    positions alternate between the card and the CPU, against the same
    makers on a CPU mesh. The grid (84 x 77 extended) is no multiple of
    the mesh nor of the tiles; the sources sit at the x cut and across the
    z cut, the receiver row in the second z part."""
    from parallel_finite_difference_computation_tpu_torch.parallel import (
        domain2d_kernels as d2k, make_mesh)
    from parallel_finite_difference_computation_tpu_torch.parallel.domain \
        import embed_dobs
    nt = 9
    rng = np.random.default_rng(order + block_k)
    ctx = solver.FDContext.create(70, 63, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=7, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    wav = numerics.ricker_wavelet(nt, 0.001, 30.0)
    d_ext = embed_dobs(ctx, rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32))
    sxs, sz, gz = (41, 42), 38, 40
    k = block_k
    geom = d2k.tile_geometry(ctx, 2, 2, k)
    grid = make_mesh(1, 2, 2, devices=[cuda_device] * 4).grid(0)
    ms = d2k.prepare_tiles(ctx, grid, geom, v2[0], "all", sxs=sxs, sz=sz,
                           source="gaussian", gz=gz)
    rs = d2k.prepare_tiles(ctx, grid, geom, v2, "top", sxs=sxs, sz=sz,
                           dobs_ext=d_ext, gz=gz)
    d2k.reset_launches()

    def same(got, want):      # (the traces of a tile that records none: 0)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= GATE * float(b.abs().max())

    for cm, cr in zip(ms, rs):
        f = [torch.from_numpy(rng.standard_normal(
            (2, cm.nxw, cm.nzw)).astype(np.float32)).to(cuda_device)
             for _ in range(6)]
        img = torch.from_numpy(rng.standard_normal(
            (2, cm.nxl, cm.nzl)).astype(np.float32)).to(cuda_device)
        for kk in (k, k - 1):
            a = wav[:kk]
            for c in (cm, cr):            # gaussian/all, point/top
                same(d2k.block2_mod_cuda(c, f[0], f[1], a),
                     d2k.block2_mod(c, f[0], f[1], a))
            same(d2k.block2_fwd_cuda(cr, f[0], f[1], a),
                 d2k.block2_fwd(cr, f[0], f[1], a))
            same(d2k.block2_bwd_cuda(cr, *f[:4], img.clone(), k, kk),
                 d2k.block2_bwd(cr, *f[:4], img, k, kk))
        same(d2k.block2_bwd_cuda(cr, *f[:4], img.clone(), 0, k, f[4:]),
             d2k.block2_bwd(cr, *f[:4], img, 0, k, f[4:]))
    torch.cuda.synchronize()
    assert d2k.LAUNCHES == {"block2_mod": 16, "block2_fwd": 8,
                            "block2_bwd": 12, "block2_mod_mma": 0,
                            "block2_fwd_mma": 0, "block2_bwd_mma": 0}
    outs = []
    for devices in ([cuda_device] * 8, [cuda_device, "cpu"] * 4,
                    ["cpu"] * 8):
        mesh = make_mesh(2, 2, 2, devices=devices)
        outs.append((
            d2k.make_sharded_forward_modeling_2d_cuda(
                ctx, mesh, sz, gz, block_k=k)(v2[0], sxs, wav),
            d2k.make_sharded_rtm_snapshot_2d_cuda(ctx, mesh, sz, gz,
                                                  block_k=k)(
                v2, sxs, wav, d_ext)))
    for got in outs[:2]:
        same([t.cpu() for t in got], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10])
@pytest.mark.parametrize("parts", [2, 3])
def test_split_block_kernels_match_plain_on_the_card(cuda_device, order,
                                                     parts):
    """The split-bf16 twins of both domain tiers' block kernels
    (block_*_mma on the slabs of a (1, 3) mesh, block2_*_mma on the tiles
    of a (1, 2, 2) mesh) against their plain versions with the x taps in
    the same bf16 parts, on the same CUDA tensors, launch by launch from
    random states, K = 3 and a tail of 2, the seeded backward block; then
    the makers on meshes of the card against the same makers on a CPU
    mesh. Gates: traces and images 1e-5 of max, fields 1e-4 (each mma sums
    its products in the card's order: ~1e-7 a step)."""
    from parallel_finite_difference_computation_tpu_torch.parallel import (
        domain2d_kernels as d2k, domain_kernels as dk, make_mesh)
    from parallel_finite_difference_computation_tpu_torch.parallel.domain \
        import embed_dobs
    nt, k = 9, 3
    rng = np.random.default_rng(order + parts)
    ctx = solver.FDContext.create(70, 63, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=7, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    wav = numerics.ricker_wavelet(nt, 0.001, 30.0)
    d_ext = embed_dobs(ctx, rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32))
    sxs, sz, gz = (27, 28), 38, 40

    def same(got, want, gates):
        for a, b, gate in zip(got, want, gates):
            assert float((a - b).abs().max()) <= gate * float(b.abs().max())

    fields, traces = (1e-4,) * 4, (1e-4, 1e-4, 1e-5)
    tiers = (((1, 3), dk.slab_geometry(ctx, 3, k), dk.block_mod_cuda,
              dk.block_fwd_cuda, dk.block_bwd_cuda, dk.LAUNCHES, "block_"),
             ((1, 2, 2), d2k.tile_geometry(ctx, 2, 2, k),
              d2k.block2_mod_cuda, d2k.block2_fwd_cuda, d2k.block2_bwd_cuda,
              d2k.LAUNCHES, "block2_"))
    for shape, geom, km, kf, kb, launches, stem in tiers:
        grid = make_mesh(*shape, devices=[cuda_device] * int(
            np.prod(shape))).grid(0)
        ms = dk.prepare_tiles(ctx, grid, geom, v2[0], "all", sxs=sxs, sz=sz,
                              source="gaussian", gz=gz)
        rs = dk.prepare_tiles(ctx, grid, geom, v2, "top", sxs=sxs, sz=sz,
                              dobs_ext=d_ext, gz=gz)
        for name in launches:
            launches[name] = 0
        for cm, cr in zip(ms, rs):
            f = [torch.from_numpy(rng.standard_normal(
                (2, cm.nxw, cm.nzw)).astype(np.float32)).to(cuda_device)
                 for _ in range(6)]
            img = torch.from_numpy(rng.standard_normal(
                (2, cm.nxl, cm.nzl)).astype(np.float32)).to(cuda_device)
            for kk in (k, k - 1):
                a = wav[:kk]
                for c in (cm, cr):        # gaussian/all, point/top
                    same(km(c, f[0], f[1], a, parts=parts),
                         dk.block_mod(c, f[0], f[1], a, parts), traces)
                same(kf(cr, f[0], f[1], a, parts=parts),
                     dk.block_fwd(cr, f[0], f[1], a, parts), fields)
                same(kb(cr, *f[:4], img.clone(), k, kk, parts=parts),
                     dk.block_bwd(cr, *f[:4], img, k, kk, None, parts),
                     fields + (1e-5,))
            same(kb(cr, *f[:4], img.clone(), 0, k, f[4:], parts=parts),
                 dk.block_bwd(cr, *f[:4], img, 0, k, f[4:], parts),
                 fields + (1e-5,))
        torch.cuda.synchronize()
        n = len(ms)
        assert launches == {f"{stem}mod": 0, f"{stem}fwd": 0,
                            f"{stem}bwd": 0, f"{stem}mod_mma": 4 * n,
                            f"{stem}fwd_mma": 2 * n, f"{stem}bwd_mma": 3 * n}
    lap_impl = "mxu" if parts == 2 else "mxu6"
    for shape, mod, rtm in (
            ((2, 3), dk.make_sharded_forward_modeling_cuda,
             dk.make_sharded_rtm_snapshot_cuda),
            ((2, 2, 2), d2k.make_sharded_forward_modeling_2d_cuda,
             d2k.make_sharded_rtm_snapshot_2d_cuda)):
        outs = []
        for devices in ([cuda_device] * 12, ["cpu"] * 12):
            mesh = make_mesh(*shape, devices=devices)
            outs.append((
                mod(ctx, mesh, sz, gz, block_k=k, lap_impl=lap_impl)(
                    v2[0], sxs, wav).cpu(),
                rtm(ctx, mesh, sz, gz, block_k=k, lap_impl=lap_impl)(
                    v2, sxs, wav, d_ext).cpu()))
        same(outs[0], outs[1], (1e-5, 1e-5))


def _stream_case(order, nt, device):
    """A 67 x 88 grid (nxb 7, nzb 9), random velocity, wavelet, gathers and
    states on ``device``."""
    ctx = solver.FDContext.create(53, 70, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    rng = np.random.default_rng(order)
    v2 = ((1500.0 + 500.0 * rng.random((ctx.nxe, ctx.nze)))
          .astype(np.float32)) ** 2
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device)
    return (ctx, on(v2), rng.standard_normal(nt).astype(np.float32),
            on(rng.standard_normal((2, ctx.nx, nt))),
            [on(rng.standard_normal((2, ctx.nxe, ctx.nze))) for _ in range(2)],
            on(rng.standard_normal((2, ctx.nx))))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10, 12, 16])
def test_stream_step_kernels_match_plain_on_the_card(cuda_device, order):
    ctx, v2, _, _, (p, pp), row = _stream_case(order, 4, cuda_device)
    stream.reset_launches()
    for kw in ({}, dict(amp=0.7, sx=(31, 40), sz=62),
               dict(amp=0.7, sx=(31, 40), sz=62, source="point"),
               dict(inj_row=row, x0=ctx.nzb, gz=63),
               dict(inj_row=row, x0=ctx.nxe, gz=63)):      # x0 clamped
        for taper in ("all", "top"):
            got = stream.fd_step_cuda(ctx, p, pp, v2, taper, **kw)
            for a, b in zip(got, solver.fd_step(ctx, p, pp, v2, taper, **kw)):
                assert torch.equal(a, b)
    v2s = torch.stack([v2, v2 * 1.1])
    assert torch.equal(stream.fd_update_cuda(ctx, p, pp, v2s),
                       solver.fd_update(ctx, p, pp, v2s))
    torch.cuda.synchronize()
    assert stream.LAUNCHES["fd_step"] == 10
    assert stream.LAUNCHES["fd_update"] == 1


@pytest.mark.cuda
def test_k1_tiled_loops_match_plain_on_the_card(cuda_device):
    ctx, v2, wav, dobs, _, _ = _stream_case(8, 12, cuda_device)
    sxs, sz, gz = (31, 40), 53, 54
    for a, b in zip(
            solver.forward_modeling_tiled(ctx, v2, wav, sxs, sz, gz),
            solver.forward_modeling(ctx, v2, wav, sxs, sz, gz)):
        assert torch.equal(a, b)
    for a, b in zip(solver.backward_recorded_tiled(ctx, v2, dobs, gz),
                    solver.backward_recorded(ctx, v2, dobs, gz)):
        assert torch.equal(a, b)
    assert torch.equal(
        solver.rtm_shot_full_tiled(ctx, v2, wav, dobs, sxs, sz, gz),
        fk.rtm_full_cuda(ctx, v2, wav, dobs, sxs, sz, gz))
    v2s = torch.stack([v2, v2 * 1.1])
    assert torch.equal(
        solver.rtm_shot_snapshot_tiled(ctx, v2s, wav, dobs, sxs, sz, gz),
        solver.rtm_shot_snapshot(ctx, v2s, wav, dobs, sxs, sz, gz))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [4, 8, 10, 12, 16])
@pytest.mark.parametrize("parts", [2, 3])
def test_split_stream_and_rec_kernels_match_plain_on_the_card(cuda_device,
                                                              order, parts):
    """fd_step_mma (no injection, both sources, the receiver row),
    fd_update_mma, rec_fwd_step_mma and rec_bwd_step_mma (frame and image
    mode) against the plain steps with the z taps in ``parts`` bf16 splits
    on the same CUDA tensors (they differ in the order of the tensor cores'
    float32 sums only), on the 67 x 88 grid, no multiple of the 64 x 64
    tiles; then the K = 1 drivers and rtm_full_cuda, with their launch
    counts."""
    nt = 11
    ctx, v2, wav, dobs, (p, pp), row = _stream_case(order, nt, cuda_device)
    sxs, sz, gz = (31, 40), 62, 63
    lap = solver.laplacian_of(ctx, parts, axis="z")
    close = lambda got, want: all(
        float((a - b).abs().max() / b.abs().max()) <= GATE
        for a, b in zip(got, want))
    stream.reset_launches()
    fk.reset_launches()
    for kw in ({}, dict(amp=0.7, sx=sxs, sz=sz),
               dict(amp=0.7, sx=sxs, sz=sz, source="point"),
               dict(inj_row=row, x0=ctx.nzb, gz=gz)):
        for taper in ("all", "top"):
            assert close(
                stream.fd_step_cuda(ctx, p, pp, v2, taper, parts=parts, **kw),
                solver.fd_step(ctx, p, pp, v2, taper, lap=lap, **kw))
    v2s = torch.stack([v2, v2 * 1.1])
    assert close((stream.fd_update_cuda(ctx, p, pp, v2s, parts=parts),),
                 (solver.fd_update(ctx, p, pp, v2s, lap),))
    wavefield = dict(source="point", taper="top", record="wavefield")
    swf = fk.forward_modeling_cuda(ctx, v2, wav, sxs, sz, gz, **wavefield,
                                   lap_impl=parts)
    swp = solver.forward_modeling(ctx, v2, wav, sxs, sz, gz, **wavefield,
                                  lap_impl=parts)
    assert close(swf, swp)
    assert close(fk.backward_recorded_cuda(ctx, v2, dobs, gz,
                                           lap_impl=parts),
                 solver.backward_recorded(ctx, v2, dobs, gz, lap=lap))
    assert close((fk.backward_image_cuda(ctx, v2, swp[2], dobs, gz,
                                         lap_impl=parts),),
                 (solver.backward_image(ctx, v2, swp[2], dobs, gz,
                                        lap=lap),))
    torch.cuda.synchronize()
    assert {k: v for k, v in stream.LAUNCHES.items() if v} == {
        "fd_step_mma": 8, "fd_update_mma": 1}
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "rec_fwd_step_mma": nt, "rec_bwd_step_mma": 2 * nt}
    stream.reset_launches()
    fk.reset_launches()
    cpu = lambda a: a.cpu()
    for block_k in (1, 2):
        assert close((solver.rtm_shot_full_tiled(
                          ctx, v2, wav, dobs, sxs, sz, gz, block_k=block_k,
                          lap_impl=parts).cpu(),),
                     (solver.rtm_shot_full_tiled(
                          ctx, cpu(v2), wav, cpu(dobs), sxs, sz, gz,
                          block_k=block_k, lap_impl=parts),))
    assert close(map(cpu, solver.forward_modeling_tiled(
                     ctx, v2, wav, sxs, sz, gz, lap_impl=parts)),
                 solver.forward_modeling_tiled(ctx, cpu(v2), wav, sxs, sz,
                                               gz, lap_impl=parts))
    assert close((solver.rtm_shot_snapshot_tiled(
                      ctx, v2s, wav, dobs, sxs, sz, gz,
                      lap_impl=parts).cpu(),),
                 (solver.rtm_shot_snapshot_tiled(
                      ctx, cpu(v2s), wav, cpu(dobs), sxs, sz, gz,
                      lap_impl=parts),))
    torch.cuda.synchronize()
    assert {k: v for k, v in stream.LAUNCHES.items() if v} == {
        "fd_step_mma": 3 * nt, "fd_update_mma": nt - 2,
        "gpu_step_mma": 2 * nt}
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "rec_fwd_step_mma": nt, "rec_bwd_step_mma": nt}


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4, 8, 10, 16])
@pytest.mark.parametrize("shape", [(45, 139), (300, 257)])
def test_lap_padded_kernels_match_plain_on_the_card(cuda_device, order,
                                                    shape):
    """lap_padded bitwise its plain version and chained applies of
    stencil.laplacian, on two buffers through out=; lap_padded_mma (2 and 3
    parts) within 1e-6 of max of its plain version, within 2e-5 / 2e-7 of
    the exact taps, pads zero."""
    from parallel_finite_difference_computation_tpu_torch.ops import (
        padded, stencil)
    nx, nz = shape
    rng = np.random.default_rng(order)
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda_device)
    cx, cz = numerics.scaled_coefficients(order, 10.0, 12.5)
    pf = padded.to_padded(f, order)
    padded.reset_launches()
    exact = padded.laplacian_padded(pf, cx, cz, order, nx, nz)
    for impl, tol in (("vpu", 0.0), ("mxu", 2e-5), ("mxu6", 2e-7)):
        got = padded.laplacian_padded_cuda(pf, cx, cz, order, nx, nz, impl)
        want = padded.laplacian_padded(pf, cx, cz, order, nx, nz, impl)
        torch.cuda.synchronize()
        scale = float(exact.abs().max())
        assert float((got - want).abs().max()) <= (0.0 if impl == "vpu"
                                                   else 1e-6 * scale)
        assert float((got - exact).abs().max()) <= tol * scale
        padded.from_padded(got, nx, nz, order).zero_()
        assert float(got.abs().max()) == 0.0           # the pads stay zero
    bufs = (pf.clone(), torch.empty_like(pf))
    ref = f
    for i in range(3):
        padded.laplacian_padded_cuda(bufs[i % 2], cx, cz, order, nx, nz,
                                     out=bufs[1 - i % 2])
        ref = stencil.laplacian(ref, cx, cz, order)
    torch.cuda.synchronize()
    assert torch.equal(padded.from_padded(bufs[1], nx, nz, order), ref)
    assert padded.LAUNCHES == {"lap_padded": 4, "lap_padded_mma": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4, 8, 10, 16])
@pytest.mark.parametrize("lap_impl", ["mxu", "mxu6"])
@pytest.mark.parametrize("nt", [10, 11])
def test_mma_step_kernels_match_plain_on_the_card(cuda_device, order,
                                                  lap_impl, nt):
    """mod_step_mma, rtm_fwd_step_mma and rtm_bwd_step_mma against the
    plain split-bf16 loops on the same CUDA tensors (they differ in the
    order of the tensor cores' float32 sums only)."""
    ctx, v2, wav, dobs = _setup(nt, order, device=cuda_device)
    fk.reset_launches()
    got = fk.forward_modeling_cuda(ctx, v2[0], wav, SXS, SZ, GZ,
                                   lap_impl=lap_impl)
    want = solver.forward_modeling(ctx, v2[0], wav, SXS, SZ, GZ,
                                   lap_impl=lap_impl)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= GATE
    ki = fk.rtm_snapshot_cuda(ctx, v2, wav, dobs, SXS, SZ, GZ,
                              lap_impl=lap_impl)
    pi = solver.rtm_shot_snapshot(ctx, v2, wav, dobs, SXS, SZ, GZ,
                                  lap_impl=lap_impl)
    torch.cuda.synchronize()
    assert float((ki - pi).abs().max() / pi.abs().max()) <= GATE
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "mod_step_mma": nt, "rtm_fwd_step_mma": nt, "rtm_bwd_step_mma": nt}
