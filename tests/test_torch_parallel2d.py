"""The port's (x, z) domain tier against the JAX package, on the CPU: the
mesh, the exchanges, the per-step loops, the errors, the pipelines and the
CLI. The block makers are in ``test_torch_parallel2d_blocks.py``.

The JAX side runs as its own tests run it (``tests/test_parallel2d.py``,
``tests/test_parallel2d_pallas.py``): on 8 virtual CPU devices, the lax
makers and ``halo_exchange_2d`` under ``shard_map``. The port's meshes put
every position on the CPU (a device may repeat), so its makers run the
plain per-step loops (``parallel/domain2d.py``) and its tile machinery the
plain torch copies.

Tolerances: ``max|port - jax| <= 2e-6 * max|jax|`` for the makers, the JAX
tests' own; bitwise against the unsharded solver where the operations are
the same. Pipelines: 1e-5 relative RMS, the port's gate between tiers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.parallel import (
    embed_source_fields as j_embed_source_fields, halo_exchange_2d,
    halo_exchange_axis as j_halo_axis, make_mesh as j_make_mesh,
    make_sharded_forward_modeling_2d as j_lax_modeling,
    make_sharded_rtm_snapshot_2d as j_lax_rtm,
    sharded_laplacian_2d as j_sharded_laplacian_2d)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli as tcli, io as tio, numerics as tnum, pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import stencil
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain, domain2d, domain2d_kernels as d2k, make_mesh)

GATE = 1e-5
MAKER_TOL = 2e-6


@pytest.fixture(scope="module")
def jmeshes():
    """The JAX meshes by shape, on the 8 virtual devices."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return {s: j_make_mesh(*s) for s in ((2, 2, 2), (1, 2, 2), (1, 2, 4),
                                         (1, 1, 4))}


def cpu_mesh(*shape):
    return make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _ctxs(nx=56, nz=48, nt=24, order=8, nxb=4, nzb=4, exact=True):
    jctx = JaxContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                             order=order, nxb=nxb, nzb=nzb, fac=0.7,
                             exact_taper=exact)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    return jctx, ctx


def _velocity(rng, ctx, ns=2):
    return ((1500.0 + 500.0 * rng.random(
        (ns, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2


def assert_close(got, want, tol=MAKER_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# ------------------------------------------------------------------ mesh

def test_make_mesh_three_axes():
    m = cpu_mesh(2, 2, 2)
    assert m.shape == {"shot": 2, "x": 2, "z": 2}
    assert m.axis_names == ("shot", "x", "z")
    assert m.devices.shape == (2, 2, 2)
    assert m.grid(1).shape == (2, 2) and m.lead(1) == torch.device("cpu")
    assert cpu_mesh(1, 1, 4).shape == {"shot": 1, "x": 1, "z": 4}
    # n_z = 1 keeps the (shot, x) mesh of the x tier
    assert cpu_mesh(2, 2, 1).axis_names == ("shot", "x")
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 4"):
        make_mesh(2, 2, 2, devices=["cpu"] * 4)
    # the same device at several positions, in row-major order
    m = make_mesh(1, 2, 2, devices=["cpu", "meta", "cpu", "meta"])
    assert [d.type for d in m.grid(0).flat] == ["cpu", "meta", "cpu", "meta"]


# ------------------------------------------------- exchanges and Laplacian

@pytest.mark.parametrize("axis", [0, 1])
def test_halo_exchange_axis_matches_jax(jmeshes, axis):
    jmesh = jmeshes[(1, 2, 4)]
    nxe, nze, h = 16, 24, 3
    n_x, n_z = 2, 4
    p = np.arange(nxe * nze, dtype=np.float32).reshape(nxe, nze) + 1.0
    name, n = (("x", n_x), ("z", n_z))[axis]
    f = jax.shard_map(lambda pl: j_halo_axis(pl, h, axis, name, n),
                      mesh=jmesh, in_specs=P("x", "z"),
                      out_specs=P("x", "z"), check_vma=False)
    want = np.asarray(jax.jit(f)(p))
    got = domain2d.halo_exchange_axis(
        domain2d.to_tiles(p, cpu_mesh(1, n_x, n_z).grid(0)), h, axis)
    a = nxe // n_x + 2 * h * (axis == 0)
    b = nze // n_z + 2 * h * (axis == 1)
    for j in range(n_x):
        for l in range(n_z):
            np.testing.assert_array_equal(
                got[j][l].numpy(), want[j * a:(j + 1) * a, l * b:(l + 1) * b])


@pytest.mark.parametrize("shape", [(1, 2, 4), (1, 2, 2), (1, 1, 4)])
def test_exchange_2d_matches_halo_exchange_2d(jmeshes, shape):
    """:func:`domain2d_kernels.exchange_2d` fills the tile buffers' halos,
    the corners included, as ``halo_exchange_2d`` fills the z-major
    tiles; the grid (59 x 53 extended) is padded on both axes, and a
    single-part x axis carries no x halo."""
    _, ctx = _ctxs(nx=51, nz=45)
    _, n_x, n_z = shape
    geom = d2k.tile_geometry(ctx, n_x, n_z, 2)
    nxl, nzl, _, hx, hz = geom
    f = np.random.default_rng(1).standard_normal(
        (ctx.nxe, ctx.nze)).astype(np.float32) + 2.0
    fpad = np.pad(f, ((0, n_x * nxl - ctx.nxe), (0, n_z * nzl - ctx.nze)))
    g = jax.shard_map(lambda pl: halo_exchange_2d(pl, hz, hx, n_z, n_x),
                      mesh=jmeshes[shape], in_specs=P("z", "x"),
                      out_specs=P("z", "x"), check_vma=False)
    want = np.asarray(jax.jit(g)(fpad.T))
    mesh = cpu_mesh(*shape)
    tiles = d2k.prepare_tiles(ctx, mesh.grid(0), geom,
                              np.ones((ctx.nxe, ctx.nze), np.float32), "top",
                              sxs=[10], sz=6)
    bufs = []
    for c, part in zip(tiles, (t for row in domain2d.to_tiles(
            f[None], mesh.grid(0)) for t in row)):
        b = torch.zeros((1, c.nxw, c.nzw))
        b[:, c.owned[0], c.owned[1]] = part
        bufs.append(b)
    d2k.exchange_2d(tiles, bufs)
    nxw, nzw = nxl + 2 * hx, nzl + 2 * hz
    for c, b in zip(tiles, bufs):
        np.testing.assert_array_equal(
            b[0].numpy(),
            want[c.l * nzw:(c.l + 1) * nzw, c.j * nxw:(c.j + 1) * nxw].T)
    if hx and hz:                       # a corner from the diagonal tile
        np.testing.assert_array_equal(
            bufs[n_z + 1][0, :hx, :hz].numpy(),
            f[nxl - hx:nxl, nzl - hz:nzl])


@pytest.mark.parametrize("order", [2, 4, 8, 10])
def test_sharded_laplacian_2d_is_the_unsharded_laplacian(jmeshes, order):
    nxe, nze = 32, 28
    p = np.random.default_rng(order).standard_normal(
        (nxe, nze)).astype(np.float32)
    cx, cz = tnum.scaled_coefficients(order, 10.0, 8.0)
    got = domain2d.from_tiles(domain2d.sharded_laplacian_2d(
        domain2d.to_tiles(p, cpu_mesh(1, 2, 4).grid(0)), cx, cz, order, nxe,
        nze), nxe, nze, "cpu")
    assert torch.equal(got, stencil.laplacian(torch.from_numpy(p), cx, cz,
                                              order))
    f = jax.shard_map(
        lambda pl: j_sharded_laplacian_2d(pl, jnp.asarray(cx),
                                          jnp.asarray(cz), order, nxe, nze,
                                          2, 4),
        mesh=jmeshes[(1, 2, 4)], in_specs=P("x", "z"),
        out_specs=P("x", "z"), check_vma=False)
    assert_close(got, np.asarray(jax.jit(f)(p)))
    # padded on both axes (31 x 27 over 2 x 4 tiles): still bitwise
    q = p[:31, :27]
    got = domain2d.from_tiles(domain2d.sharded_laplacian_2d(
        domain2d.to_tiles(q, cpu_mesh(1, 2, 4).grid(0)), cx, cz, order, 31,
        27), 31, 27, "cpu")
    assert torch.equal(got, stencil.laplacian(torch.from_numpy(q), cx, cz,
                                              order))


# ------------------------------------------------------- per-step makers

@pytest.mark.parametrize("source,taper,shape", [
    ("point", "all", (2, 2, 2)), ("gaussian", "top", (1, 2, 4))])
def test_per_step_modeling_matches_jax_lax_and_unsharded(jmeshes, source,
                                                         taper, shape):
    jctx, ctx = _ctxs(nx=24, nz=19, nt=24)   # nze = 27: padded
    rng = np.random.default_rng(2)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    sxs, sz, gz = [10, 14], 13, 9            # sz, gz below the first z cut
    gauss = source == "gaussian"
    got = domain2d.make_sharded_forward_modeling_2d(
        ctx, cpu_mesh(*shape), gz, source=source, taper=taper)(
        v2, domain.embed_source_fields(ctx, sxs, sz, gauss), wav)
    want = j_lax_modeling(jctx, jmeshes[shape], gz, source=source,
                          taper=taper)(
        v2, j_embed_source_fields(jctx, sxs, sz, gauss), jnp.asarray(wav))
    assert_close(got, want)
    ref = torch.stack([solver.forward_modeling(
        ctx, torch.from_numpy(v2[s]), wav, sxs[s], sz, gz, source=source,
        taper=taper)[2][0] for s in range(2)])
    assert torch.equal(got[:, :, ctx.nxb:ctx.nxb + ctx.nx], ref)


def test_per_step_rtm_matches_jax_lax_and_unsharded(jmeshes):
    jctx, ctx = _ctxs(nx=24, nz=19, nt=24)
    rng = np.random.default_rng(3)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    sxs, sz, gz = [10, 14], 15, 14           # across the z cut at 14
    srcf = domain.embed_source_fields(ctx, sxs, sz)
    d_ext = domain.embed_dobs(ctx, dobs)
    got = domain2d.make_sharded_rtm_snapshot_2d(ctx, cpu_mesh(2, 2, 2), gz)(
        v2, srcf, wav, d_ext)
    want = j_lax_rtm(jctx, jmeshes[(2, 2, 2)], gz)(v2, srcf,
                                                    jnp.asarray(wav), d_ext)
    assert_close(got, want)
    ref = solver.rtm_shot_snapshot(ctx, torch.from_numpy(v2), wav,
                                   torch.from_numpy(dobs), sxs, sz, gz)
    assert torch.equal(got[:, ctx.nxb:ctx.nxe - ctx.nxb,
                           ctx.nzb:ctx.nze - ctx.nzb], ref)


# ---------------------------------------------------------------- errors

def test_block_maker_errors():
    _, ctx = _ctxs(nt=6)                     # 64 x 56; h = 4
    mesh = cpu_mesh(1, 2, 4)                 # tiles 32 x 14
    with pytest.raises(ValueError, match="exceeds the local tile .* fewer "
                                         "x or z shards"):
        d2k.make_sharded_forward_modeling_2d_cuda(ctx, mesh, 8, 5, block_k=4)
    with pytest.raises(ValueError, match="exceeds the local tile"):
        d2k.make_sharded_rtm_snapshot_2d_cuda(ctx, mesh, 8, 5, block_k=4)
    # a single-part x axis carries no halo: only the z tiles bound K
    assert d2k.tile_geometry(ctx, 1, 4, 3) == (64, 14, 3, 0, 12)
    with pytest.raises(ValueError, match="block_k must be >= 2"):
        d2k.make_sharded_rtm_snapshot_2d_cuda(ctx, mesh, 8, 5, block_k=1)
    with pytest.raises(ValueError, match="nt=6 < 2\\*block_k=8.*"
                                         "make_sharded_rtm_snapshot_2d"):
        d2k.make_sharded_rtm_snapshot_2d_cuda(ctx, cpu_mesh(1, 2, 2), 8, 5,
                                              block_k=4)
    # a split lap_impl runs the plain split block function (auto is mxu
    # here: nt = 6, dx == dz)
    v2 = np.full((ctx.nxe, ctx.nze), 2000.0 ** 2, np.float32)
    wav = np.float32(np.random.default_rng(0).standard_normal(ctx.nt))
    seis = {lap_impl: d2k.make_sharded_forward_modeling_2d_cuda(
        ctx, cpu_mesh(1, 2, 2), 30, 35, block_k=2, lap_impl=lap_impl)(
            v2, [20], wav) for lap_impl in (None, "mxu", "mxu6", "auto")}
    assert torch.equal(seis["auto"], seis["mxu"])
    assert not torch.equal(seis["mxu"], seis[None])
    assert not torch.equal(seis["mxu6"], seis["mxu"])


CFG = dict(nz=24, nx=24, nt=40, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
           ns=3, sz=0, fsx=2, ds=8, gz=0, nxb=4, nzb=4, fac=0.7, order=8)


def test_pipeline_mesh_errors(monkeypatch):
    p = tpk.Params(**CFG)
    vp = layered_model(p.nx, p.nz, (1500.0, 2500.0), interfaces=[12])
    dobs = np.zeros((p.ns, p.nx, p.nt), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.run_rtm_cpu(p, vp=vp, dobs=dobs, mesh=cpu_mesh(1, 1, 2))
    # nze = 32 over 8 z parts: K = (4 // 4) = 1 < 2 for RTM
    with pytest.raises(NotImplementedError, match="fewer x or z shards"):
        tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, mesh=cpu_mesh(1, 1, 8))
    # a CPU mesh keeps the exact taps under a split lap_impl, as the JAX
    # lax domain path does on the CPU
    np.testing.assert_array_equal(
        tpipe.run_modeling(p, vp=vp, mesh=cpu_mesh(1, 2, 2), lap_impl="mxu"),
        tpipe.run_modeling(p, vp=vp, mesh=cpu_mesh(1, 2, 2)))
    # tiles of 3 columns < h = 4: the modeling rule still gives K = 1, whose
    # halo outgrows the tile; it raises before anything runs, on any mesh
    ran = []
    monkeypatch.setattr(domain2d, "make_sharded_forward_modeling_2d",
                        lambda *a, **k: ran.append(a))
    q = tpk.Params(**dict(CFG, nz=16))     # nze = 24 over 8: 3 columns
    with pytest.raises(ValueError, match="exceeds the local tile.*fewer x "
                                         "or z shards"):
        tpipe.run_modeling(q, vp=layered_model(q.nx, q.nz),
                           mesh=cpu_mesh(1, 1, 8))
    assert not ran


# ------------------------------------------------------------- pipelines

@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """The JAX and port Params of one small survey, its velocity, its
    per-shot boundary velocities in a vel_ext_file (the two packages'
    generators draw different numbers) and the port's no-mesh outputs."""
    tmp = tmp_path_factory.mktemp("survey2d")
    jp, tp = jpk.Params(**CFG), tpk.Params(**CFG)
    vp = layered_model(tp.nx, tp.nz, (1500.0, 2500.0), interfaces=[12])
    base = np.zeros((tp.nxe, tp.nze), np.float32)
    base[tp.nxb:tp.nxb + tp.nx, tp.nzb:tp.nzb + tp.nz] = vp
    tio.write_f32(str(tmp / "vel_ext.bin"), np.stack([
        tnum.extendvel_random(base, tp.nx, tp.nz, tp.nxb, tp.nzb, seed=5 + i)
        for i in range(tp.ns)]))
    jp.vel_ext_file = tp.vel_ext_file = str(tmp / "vel_ext.bin")
    td = tpipe.run_modeling(tp, vp=vp, device="cpu")
    timg, tlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=td, device="cpu")
    return jp, tp, vp, td, timg, tlocs


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 4)])
def test_pipelines_with_xz_meshes_match_jax(jmeshes, survey, shape):
    jp, tp, vp, td0, timg0, tlocs0 = survey
    mesh = cpu_mesh(*shape)
    td = tpipe.run_modeling(tp, vp=vp, mesh=mesh)
    assert td.shape == (tp.ns, tp.nx, tp.nt)
    np.testing.assert_array_equal(td, td0)
    jd = jpipe.run_modeling(jp, vp=vp, backend="lax", mesh=jmeshes[shape])
    assert rel_rms(td, jd) <= GATE
    timg, tlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=td, mesh=mesh)
    jimg, jlocs = jpipe.run_rtm_gpu(jp, vp=vp, dobs=td, backend="lax",
                                    mesh=jmeshes[shape])
    assert rel_rms(timg, jimg) <= GATE
    for s in range(tp.ns):
        assert rel_rms(tlocs[s], jlocs[s]) <= GATE
    assert rel_rms(timg, timg0) <= GATE and rel_rms(tlocs, tlocs0) <= GATE


def test_cli_shards_z(tmp_path, survey):
    _, tp, vp, td0, timg0, _ = survey
    tio.write_f32(str(tmp_path / "vp.bin"), vp)
    cfg = tmp_path / "input.dat"
    cfg.write_text("".join(f"{k}={v}\n" for k, v in CFG.items())
                   + f"vpfile=vp.bin\ndatfile=d.bin\n"
                   f"vel_ext_file={tp.vel_ext_file}\n")
    out = tmp_path / "d.bin"
    tcli.main(["mod", str(cfg), "--device", "cpu", "--shards-x", "2",
               "--shards-z", "2", "--output", str(out)])
    np.testing.assert_array_equal(
        tio.read_f32(str(out)).reshape(tp.ns, tp.nx, tp.nt), td0)
    tcli.main(["rtm_gpu", str(cfg), "--device", "cpu", "--shards-x", "2",
               "--shards-z", "2", "--outdir", str(tmp_path)])
    img = tio.read_f32(str(tmp_path / "dir.image"))
    assert rel_rms(img.reshape(tp.nx, tp.nz), timg0) <= GATE
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["rtm", str(cfg), "--device", "cpu", "--shards-z", "2",
                   "--outdir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh needs"):
            tcli.main(["mod", str(cfg), "--shards-z", "2",
                       "--output", str(out)])
