"""The split-bf16 Laplacian tiers of the whole-shot kernels (``lap_impl``
``"mxu"``, ``"mxu6"``, ``"auto"``; kernel-table row 5) against the JAX
package on the CPU: the split arithmetic, the ``auto`` routing, the plain
``forward_modeling``/``rtm_shot_snapshot`` against ``forward_modeling_
pallas``/``rtm_snapshot_pallas`` in interpret mode, the pipelines, the
CLI, and the tiers that still have the exact taps only.

Tolerances: the split values are bitwise JAX's. The plain tiers form the
same exact bf16 products as the JAX kernels and differ from them only in
the order of their float32 sums: within 5e-6 of max (measured: <= 1.6e-6
for the whole-shot calls over 10-11 steps at orders 4-16, 2.6e-6 for the
pipelines' gathers); against the exact lax path within the JAX tests' own
gates (1e-4 for mxu, 1e-6 for mxu6, of max(1, max|ref|))."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.ops import (
    pallas_fd as jfd, pallas_stencil as jps, stencil as jst)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext, forward_modeling as jfwd,
    rtm_shot_snapshot as jrtm)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli as tcli, io as tio, numerics as tnum, pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    banded, fd_kernels as fk)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    make_mesh)

PARITY = 5e-6
JAX_GATE = {"mxu": 1e-4, "mxu6": 1e-6}


def _ctxs(nx, nz, nt, order=8, nxb=8, nzb=8, dx=10.0, dz=10.0,
          exact=True):
    jctx = JaxContext.create(nx, nz, nt, dx=dx, dz=dz, dt=0.001,
                             order=order, nxb=nxb, nzb=nzb, fac=0.7,
                             exact_taper=exact)
    return jctx, context_from_arrays(**{f.name: getattr(jctx, f.name)
                                        for f in dataclasses.fields(jctx)})


# ----------------------------------------------------------- split helpers

def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "random":
        v = rng.standard_normal(4096) * 10.0 ** rng.uniform(-8, 8, 4096)
    elif kind == "tiny":            # every split level stays normal
        v = (rng.choice([-1.0, 1.0], 4096) * rng.uniform(0.5, 1.0, 4096)
             * 2.0 ** rng.integers(-95, -80, 4096))
    elif kind == "huge":            # large, but not rounding up to inf
        v = rng.uniform(-1.0, 1.0, 4096) * 3.3e38
    else:                           # "ties": exactly between two bf16 values
        bits = (rng.integers(0x0800, 0x7F00, 4096).astype(np.uint32) << 16
                | np.uint32(0x8000))
        v = bits.view(np.float32) * rng.choice([-1.0, 1.0], 4096)
    return np.asarray(v, np.float32)


@pytest.mark.parametrize("kind", ["random", "tiny", "huge", "ties"])
def test_round_and_split_bitwise_jax(kind):
    """round_bf16, split and split_coefs bitwise the JAX package's integer
    rounding, split_lhs and split_stack. Subnormals: the rounding alone
    (XLA on the CPU flushes subnormal float32 results, such as a split's
    residual, to zero; torch and the card keep them)."""
    v = _values(kind)
    got = banded.round_bf16(torch.from_numpy(v)).numpy()
    want = np.asarray(jps._round_bf16_f32(jnp.asarray(v)))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    sub = (v * np.float32(2.0 ** -60)).astype(np.float32)
    assert np.array_equal(
        banded.round_bf16(torch.from_numpy(sub)).numpy().view(np.uint32),
        np.asarray(jps._round_bf16_f32(jnp.asarray(sub))).view(np.uint32))
    for parts in (2, 3):
        got = [t.numpy() for t in banded.split(torch.from_numpy(v), parts)]
        want = [np.asarray(t.astype(jnp.float32))
                for t in jps.split_lhs(jnp.asarray(v), parts)]
        for g, w in zip(got, want):
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
        stack = jps.split_stack(v[None, :], parts).astype(np.float32)
        for j, s in enumerate(banded.split_coefs(v, parts)):
            assert np.array_equal(np.asarray(s, np.float32),
                                  stack[0, j * v.size:(j + 1) * v.size])


@pytest.mark.parametrize("order", [2, 8, 16])
@pytest.mark.parametrize("parts", [2, 3])
def test_banded_taps_match_jax_band_product(order, parts):
    """banded_taps against the JAX kernels' own band product (a 128-lane
    band matrix, split_lhs, split_stack, mm3/mm_banded) on the columns
    at least h from the window's edges."""
    h = order // 2
    a = np.random.default_rng(order).standard_normal((40, 128)).astype(
        np.float32)
    c = tnum.scaled_coefficients(order, 10.0, 7.5)[1]
    s = jps.band_matrices([float(x) for x in c], h, 128)[0]
    want = np.asarray(jps.mm_banded(jps.split_lhs(jnp.asarray(a), parts),
                                    jnp.asarray(jps.split_stack(s, parts))))
    got = banded.banded_taps(torch.from_numpy(a), c, h, -1, parts).numpy()
    want = want[:, h:128 - h]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    exact = sum(float(c[h + d]) * a[:, h + d:128 - h + d].astype(np.float64)
                for d in range(-h, h + 1))
    assert np.abs(got - exact).max() > 1e-9 * np.abs(exact).max()
    assert banded.cross_terms(parts) == ([(0, 0), (0, 1), (1, 0)]
                                         if parts == 2 else
                                         [(2, 0), (1, 1), (0, 2), (1, 0),
                                          (0, 1), (0, 0)])


# ----------------------------------------------------------------- routing

@pytest.mark.parametrize("env", ["padded", "roll", "auto", "mxu", "mxu6"])
def test_routing_matches_jax(env, monkeypatch):
    monkeypatch.setattr(jst, "_ENV_LAP_IMPL", env)
    monkeypatch.setattr(fk, "_ENV_LAP_IMPL", env)
    for nt in (1499, 1500, 1501, 4499, 4500, 4501):
        for dx, dz in ((10.0, 10.0), (25.0, 8.0)):
            jctx, ctx = _ctxs(12, 10, nt, dx=dx, dz=dz)
            for lap_impl in (None, "vpu", "auto", "mxu", "mxu6"):
                with warnings.catch_warnings(record=True) as jw:
                    warnings.simplefilter("always")
                    jr = jfd.resolve_lap_impl(jctx, lap_impl)
                    jp = jfd._use_mxu_lap(lap_impl, jctx)
                with warnings.catch_warnings(record=True) as tw:
                    warnings.simplefilter("always")
                    tr = fk.resolve_lap_impl(ctx, lap_impl)
                    tp = fk.lap_parts(lap_impl, ctx)
                assert (tr, tp) == (jr, jp), (nt, dx, dz, lap_impl)
                assert ([str(w.message) for w in tw]
                        == [str(w.message) for w in jw])
                assert all(w.category is UserWarning for w in tw)


def test_routing_errors_and_resolved_parts():
    _, ctx = _ctxs(12, 10, 1501)
    with pytest.warns(UserWarning, match="outside its validated"):
        assert fk.lap_parts("mxu", ctx) == 2
    with pytest.raises(ValueError, match="unknown lap_impl"):
        fk.lap_parts("mxu3", ctx)
    assert [fk.lap_parts(p, ctx) for p in (0, 2, 3)] == [0, 2, 3]
    with pytest.raises(ValueError, match="0, 2 or 3"):
        fk.lap_parts(1, ctx)
    assert fk.resolve_lap_impl(ctx, "auto") == "mxu6"
    assert fk.lap_parts("auto", ctx) == 3
    assert fk.lap_parts("auto", _ctxs(12, 10, 4501)[1]) == 0


# -------------------------------------------------------- whole-shot parity

def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("lap_impl", ["mxu", "mxu6"])
@pytest.mark.parametrize("nx,nt,order", [(28, 10, 4), (160, 11, 8),
                                         (280, 10, 16), (28, 11, 8)])
def test_whole_shot_parity_with_pallas(nx, nt, order, lap_impl):
    """The plain loops with the split tiers against the JAX whole-shot
    kernels in interpret mode (the JAX tests' shapes: nxb 8, nz 24), and
    each against the exact lax path at the JAX tests' own gates. The split
    tier differs from the exact taps, and mxu6 lies closer to them."""
    jctx, ctx = _ctxs(nx, 24, nt, order=order)
    rng = np.random.default_rng(nx + order)
    v2 = ((1500.0 + 500.0 * rng.random((ctx.nxe, ctx.nze))).astype(
        np.float32)) ** 2
    wav = tnum.ricker_wavelet(nt, 0.001, 25.0)
    dobs = rng.standard_normal((ctx.nx, nt)).astype(np.float32)
    sx, sz, gz = 8 + nx // 2, 12, 9
    tv2 = torch.from_numpy(v2)

    got = solver.forward_modeling(ctx, tv2, wav, [sx], sz, gz,
                                  lap_impl=lap_impl)
    want = jfd.forward_modeling_pallas(jctx, jnp.asarray(v2),
                                       jnp.asarray(wav), sx, sz, gz,
                                       interpret=True, lap_impl=lap_impl)
    lax = jfwd(jctx, jnp.asarray(v2), jnp.asarray(wav), sx, sz, gz,
               source="gaussian", taper="all", record="trace")
    for g, w, x in zip(got, want, lax):
        g = g[0].numpy()
        assert _max_rel(g, w) <= PARITY
        tol = JAX_GATE[lap_impl] * max(1.0, float(np.abs(x).max()))
        assert np.abs(g - np.asarray(x)).max() <= tol

    imgs = {}
    for li in (lap_impl, "mxu" if lap_impl == "mxu6" else "mxu6", None):
        imgs[li] = solver.rtm_shot_snapshot(
            ctx, tv2[None], wav, torch.from_numpy(dobs)[None], [sx], sz, gz,
            lap_impl=li)[0].numpy()
    want = np.asarray(jfd.rtm_snapshot_pallas(
        jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs), sx, sz,
        gz, interpret=True, lap_impl=lap_impl))
    exact = np.asarray(jrtm(jctx, jnp.asarray(v2), jnp.asarray(wav),
                            jnp.asarray(dobs), sx, sz, gz))
    assert _max_rel(imgs[lap_impl], want) <= PARITY
    scale = max(1.0, float(np.abs(exact).max()))
    assert np.abs(imgs[lap_impl] - exact).max() <= JAX_GATE[lap_impl] * scale
    err = {li: np.abs(imgs[li] - imgs[None]).max() for li in ("mxu", "mxu6")}
    assert err["mxu"] > 1e-9 * np.abs(imgs[None]).max()
    assert err["mxu6"] < err["mxu"]


# --------------------------------------------------------------- pipelines

CFG = dict(nz=24, nx=28, nt=10, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
           ns=2, sz=4, fsx=6, ds=10, gz=1, nxb=8, nzb=8, fac=0.7, order=8)


def _vel_ext(path, p, vp):
    base = np.zeros((p.nxe, p.nze), np.float32)
    base[p.nxb:p.nxb + p.nx, p.nzb:p.nzb + p.nz] = vp
    tio.write_f32(str(path), np.stack([
        tnum.extendvel_random(base, p.nx, p.nz, p.nxb, p.nzb, seed=5 + i)
        for i in range(p.ns)]))
    return str(path)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """run_modeling then run_rtm_gpu on the CPU with each tier, on a small
    3lay-like config (the boundaries from a vel_ext_file), with and without
    a shot-only mesh."""
    tmp = tmp_path_factory.mktemp("mxu_slice")
    p = tpk.Params(**CFG)
    vp = layered_model(p.nx, p.nz)
    p.vel_ext_file = _vel_ext(tmp / "vel_ext.bin", p, vp)
    runs = {}
    for li in ("auto", "mxu", "mxu6"):
        d = tpipe.run_modeling(p, vp=vp, device="cpu", lap_impl=li)
        img, locs = tpipe.run_rtm_gpu(p, vp=vp, dobs=d, device="cpu",
                                      lap_impl=li)
        runs[li] = (d, locs)
    mesh = make_mesh(2, 1, devices=["cpu", "cpu"])
    d = tpipe.run_modeling(p, vp=vp, mesh=mesh, lap_impl="auto")
    runs["auto mesh"] = (d, tpipe.run_rtm_gpu(p, vp=vp, dobs=d, mesh=mesh,
                                              lap_impl="auto")[1])
    return p, vp, runs


@pytest.mark.parametrize("lap_impl", ["auto", "mxu6"])
def test_pipelines_match_pallas_per_shot(slice_runs, lap_impl):
    """run_modeling and run_rtm_gpu through the split tiers against the JAX
    whole-shot kernels in interpret mode, shot by shot: ``auto`` resolves to
    ``mxu`` on this config (nt = 10, dx == dz), as in the JAX package."""
    p, vp, runs = slice_runs
    jp = jpk.Params(**CFG)
    jp.vel_ext_file = p.vel_ext_file
    g = jpk.Geometry.from_params(jp)
    jmod = JaxContext.from_params(jp, exact_taper=False)
    jrt = JaxContext.from_params(jp, exact_taper=True)
    assert jfd.resolve_lap_impl(jmod, lap_impl) == fk.resolve_lap_impl(
        context_from_arrays(**{f.name: getattr(jmod, f.name)
                               for f in dataclasses.fields(jmod)}),
        lap_impl) == ("mxu" if lap_impl == "auto" else "mxu6")
    vel2 = jnp.asarray(jpipe.prepare_velocity_cpu(jp, vp))
    v2s = jnp.asarray(jpipe.prepare_velocities_gpu(jp, vp))
    wav_m = jnp.asarray(jnum.ricker_wavelet(jp.nt, jp.dt, jp.fpeak,
                                            truncated=True))
    wav_r = jnp.asarray(jnum.ricker_wavelet(jp.nt, jp.dt, jp.fpeak))
    d, locs = runs[lap_impl]
    for s, sx in enumerate(g.sx):
        seis = jfd.forward_modeling_pallas(jmod, vel2, wav_m, int(sx), g.sz,
                                           g.gz, interpret=True,
                                           lap_impl=lap_impl)[2]
        assert _max_rel(d[s], np.asarray(seis).T) <= PARITY
        img = jfd.rtm_snapshot_pallas(jrt, v2s[s], wav_r, jnp.asarray(d[s]),
                                      int(sx), g.sz, g.gz, interpret=True,
                                      lap_impl=lap_impl)
        assert _max_rel(locs[s], img) <= PARITY


def test_auto_is_mxu_here_and_meshes_agree(slice_runs):
    _, _, runs = slice_runs
    for a, b in zip(runs["auto"], runs["mxu"]):
        assert np.array_equal(a, b)
    for a, b in zip(runs["auto mesh"], runs["auto"]):
        assert np.array_equal(a, b)
    assert not np.array_equal(runs["mxu6"][1], runs["mxu"][1])


def test_cli_lap_impl_auto(slice_runs, tmp_path):
    """``--lap-impl auto`` through the port's CLI: the gathers and the
    image of the pipelines' mxu run (the same boundaries, from the config's
    vel_ext_file)."""
    p, vp, runs = slice_runs
    tio.write_f32(str(tmp_path / "vp.bin"), vp)
    keys = ("nz", "nx", "nt", "dz", "dx", "dt", "fpeak", "ns", "sz", "fsx",
            "ds", "gz", "nxb", "nzb", "fac", "order")
    cfg = tmp_path / "input.dat"
    cfg.write_text("".join(f"{k}={CFG[k]}\n" for k in keys)
                   + f"vpfile=vp.bin\nvel_ext_flag=1\n"
                   f"vel_ext_file={p.vel_ext_file}\n")
    tcli.main(["mod", str(cfg), "--device", "cpu", "--lap-impl", "auto",
               "--output", str(tmp_path / "d.bin")])
    d = tio.read_f32(str(tmp_path / "d.bin")).reshape(runs["mxu"][0].shape)
    assert np.array_equal(d, runs["mxu"][0])
    out = tmp_path / "out"
    out.mkdir()
    cfg.write_text(cfg.read_text() + f"datfile={tmp_path / 'd.bin'}\n")
    tcli.main(["rtm_gpu", str(cfg), "--device", "cpu", "--lap-impl", "auto",
               "--outdir", str(out)])
    img = tio.read_f32(str(out / "dir.image")).reshape(p.nx, p.nz)
    assert np.array_equal(img, runs["mxu"][1].sum(axis=0))


# ------------------------------------------------ the other tiers' routing

def test_other_tiers_run_a_resolved_split_tier():
    """The domain tiers (x and (x, z) meshes) on CPU devices run a resolved
    split tier with the exact taps, the JAX package's lax domain path on
    the CPU (their block kernels' split twins run on the card,
    ``tests/test_torch_domain_mxu.py``). The large-grid tier at K = 1 and
    rtm_main's kernels (the wavefield recording, its backward, the whole
    rtm_main shot) at every K run them, the z taps split: each call equals
    its plain path with that Laplacian (``tests/test_torch_stream_mxu.py``
    holds them against the JAX package)."""
    p = tpk.Params(**CFG)
    vp = layered_model(p.nx, p.nz)
    dobs = np.zeros((p.ns, p.nx, p.nt), np.float32)
    x_mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    xz_mesh = make_mesh(1, 2, 2, devices=["cpu"] * 4)
    runs = {
        "mod xz": lambda li: tpipe.run_modeling(p, vp=vp, mesh=xz_mesh,
                                                lap_impl=li),
        "rtm_gpu x": lambda li: tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs,
                                                  mesh=x_mesh, lap_impl=li),
        "mod x": lambda li: tpipe.run_modeling(p, vp=vp, mesh=x_mesh,
                                               lap_impl=li),
        "rtm_gpu xz": lambda li: tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs,
                                                   mesh=xz_mesh,
                                                   lap_impl=li)}
    for label, run in runs.items():
        exact = run(None)
        for lap_impl in ("mxu", "mxu6", "auto"):
            for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                              for o in (run(lap_impl), exact))):
                np.testing.assert_array_equal(a, b, err_msg=label)
    _, ctx = _ctxs(20, 16, 9)
    v2 = torch.full((ctx.nxe, ctx.nze), 2000.0 ** 2)
    wav = tnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    d = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, ctx.nx, ctx.nt)).astype(np.float32))
    lap = lambda li: solver.laplacian_of(ctx, fk.lap_parts(li, ctx),
                                         axis="z")
    plain_fwd = lambda li, **kw: solver.forward_modeling(
        ctx, v2, wav, [14], 10, 9, lap_impl=fk.lap_parts(li, ctx), **kw)
    pairs = (
        (lambda: solver.forward_modeling_tiled(
            ctx, v2, wav, [14], 10, 9, record="wavefield", block_k=1,
            lap_impl="mxu"),
         lambda: plain_fwd("mxu", record="wavefield")),
        (lambda: solver.rtm_shot_snapshot_tiled(
            ctx, v2[None], wav, d, [14], 10, 9, block_k=1, lap_impl="mxu6"),
         lambda: solver.fd_back(
             ctx, v2[None], *solver.fd_forward(ctx, v2[None], wav, [14], 10,
                                               lap("mxu6")),
             d, 9, lap("mxu6"))),
        (lambda: solver.backward_recorded_tiled(
            ctx, v2, d, 9, block_k=1, lap_impl="auto"),
         lambda: solver.backward_recorded(ctx, v2, d, 9, lap=lap("auto"))),
        (lambda: solver.backward_recorded_tiled(
            ctx, v2, d, 9, block_k=4, lap_impl="mxu"),
         lambda: solver.backward_recorded(ctx, v2, d, 9, lap=lap("mxu"))),
        (lambda: solver.rtm_shot_full_tiled(
            ctx, v2, wav, d, [14], 10, 9, block_k=4, lap_impl="mxu6"),
         lambda: solver.rtm_shot_full(ctx, v2, wav, d, [14], 10, 9,
                                      lap_impl="mxu6")),
        (lambda: solver.forward_modeling_tiled(
            ctx, v2, wav, [14], 10, 9, record="wavefield", block_k=4,
            lap_impl="auto"),
         lambda: plain_fwd("auto", record="wavefield")),
        (lambda: fk.forward_modeling_cuda(
            ctx, v2, wav, [14], 10, 9, record="wavefield", lap_impl="mxu"),
         lambda: plain_fwd("mxu", record="wavefield")))
    exact = solver.forward_modeling(ctx, v2, wav, [14], 10, 9,
                                    record="wavefield")[2]
    for run, plain in pairs:
        got, want = run(), plain()
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(pairs[0][0]()[2], exact)


def test_auto_past_the_envelope_runs_the_exact_tiers():
    """At nt > MXU6_NT_MAX ``auto`` resolves to the exact taps (as at
    Pluto): the large-grid tier at K = 1 and the x-domain tier on a CPU
    mesh run, bitwise the runs without lap_impl."""
    p = tpk.Params(nz=8, nx=10, nt=fk.MXU6_NT_MAX + 1, dz=10.0, dx=10.0,
                   dt=0.0005, fpeak=20.0, ns=1, sz=3, fsx=4, ds=5, gz=1,
                   nxb=4, nzb=4, fac=0.7, order=4)
    vp = np.full((p.nx, p.nz), 1500.0, np.float32)
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    for kw in (dict(device="cpu", backend="tiled"), dict(mesh=mesh)):
        assert np.array_equal(
            tpipe.run_modeling(p, vp=vp, lap_impl="auto", **kw),
            tpipe.run_modeling(p, vp=vp, **kw))
