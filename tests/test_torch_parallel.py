"""The port's shot and x-domain parallelism against the JAX package, on the
CPU.

The JAX side runs as its own tests run it (``tests/test_parallel.py``): on 8
virtual CPU devices, a (2, 4) mesh, the Pallas makers in interpret mode.
The port's meshes put every position on the CPU (a device may repeat), so
its makers run the plain block functions (``parallel/domain_kernels.py``)
and the plain per-step loops (``parallel/domain.py``).

* Mesh: shapes, the too-few-devices error, repeated devices, z > 1
  (a three-axis mesh).
* The halo exchanges and the sharded Laplacian, bitwise against the JAX
  ones (the row exchange against ``halo_exchange_lanes``) and the unsharded
  Laplacian.
* The per-step makers against the JAX lax makers and the unsharded solver.
* The block makers against ``make_sharded_*_pallas`` in interpret mode at
  orders 4, 8 and 10, K = 2, 3 and 4, with forward and backward tails
  (nt 40, 42, 21), point/top and gaussian/all sources, a source across a
  slab edge and nxe no multiple of the x axis.
* The errors; the pipelines with shot-only and x meshes against the JAX
  pipelines with the same meshes and the port's own no-mesh run; no dummy
  shots; the CLI's ``--shards-*``.

Tolerances: ``max|port - jax| <= 2e-6 * max|jax|`` for the makers, the JAX
tests' own (``test_parallel.py:278``): XLA contracts some multiply-adds and
the JAX kernels form the Gaussian rows with a float32 ``exp``; bitwise
where the operands and the order are the same. Pipelines: 1e-5 relative
RMS, the port's gate between tiers.
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
    embed_source_fields as j_embed_source_fields, halo_exchange as j_halo,
    make_mesh as j_make_mesh,
    make_sharded_forward_modeling as j_lax_modeling,
    make_sharded_rtm_snapshot as j_lax_rtm,
    sharded_laplacian as j_sharded_laplacian)
from parallel_finite_difference_computation_tpu.parallel.domain_pallas import (
    halo_exchange_lanes, make_sharded_forward_modeling_pallas,
    make_sharded_rtm_snapshot_pallas)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    cli as tcli, io as tio, numerics as tnum, pipeline as tpipe, solver)
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import stencil
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain, domain_kernels as dk, make_mesh, shots)

GATE = 1e-5
MAKER_TOL = 2e-6


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return j_make_mesh(n_shot=2, n_x=4)


def cpu_mesh(n_shot, n_x):
    return make_mesh(n_shot, n_x, devices=["cpu"] * (n_shot * n_x))


def _ctxs(nx=56, nz=20, nt=40, order=8, nxb=4, nzb=4, exact=True):
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

def test_make_mesh_shapes_and_errors():
    m = cpu_mesh(2, 4)
    assert m.shape == {"shot": 2, "x": 4}
    assert m.axis_names == ("shot", "x")
    assert m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_mesh(devices=["cpu"]).shape == {"shot": 1, "x": 1}
    with pytest.raises(ValueError, match="mesh needs 3 devices, have 2"):
        make_mesh(3, 1, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh needs 2 devices, have 0"):
            make_mesh(1, 2)
    # n_z > 1: a (shot, x, z) mesh, the (x, z) tier's
    m3 = make_mesh(1, 2, n_z=2, devices=["cpu"] * 4)
    assert m3.shape == {"shot": 1, "x": 2, "z": 2}
    assert m3.axis_names == ("shot", "x", "z")
    assert m3.grid(0).shape == (2, 2) and m3.lead() == torch.device("cpu")
    assert m.grid(1).shape == (4, 1)


def test_split_and_pad_shots():
    """Shot groups take their real shots only: nothing is padded."""
    assert [list(g) for g in shots.split_shots(5, 2)] == [[0, 1, 2], [3, 4]]
    assert [len(g) for g in shots.split_shots(1, 3)] == [1, 0, 0]
    assert not hasattr(shots, "pad_shots")
    parts, tparts = shots.distribute_shots(cpu_mesh(2, 1), np.arange(5),
                                           torch.arange(10.0).reshape(5, 2))
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4]]
    assert [p.shape[0] for p in tparts] == [3, 2]
    assert torch.equal(torch.cat(tparts), torch.arange(10.0).reshape(5, 2))


# ------------------------------------------------- exchanges and Laplacian

def test_halo_exchange_matches_jax(jmesh):
    nxe, h = 32, 3
    p = np.arange(nxe * 4, dtype=np.float32).reshape(nxe, 4)
    f = jax.shard_map(lambda pl: j_halo(pl, h, "x", 4), mesh=jmesh,
                      in_specs=P("x", None), out_specs=P("x", None),
                      check_vma=False)
    want = np.asarray(jax.jit(f)(p)).reshape(4, nxe // 4 + 2 * h, 4)
    got = domain.halo_exchange(domain.to_slabs(p, ["cpu"] * 4), h)
    for j in range(4):
        np.testing.assert_array_equal(got[j].numpy(), want[j])


def test_row_exchange_matches_halo_exchange_lanes(jmesh):
    """:func:`domain_kernels.exchange` fills the extended slab buffers'
    halo rows as ``halo_exchange_lanes`` fills the z-major lanes."""
    _, ctx = _ctxs(nx=51)                 # nxe = 59: padded to 60
    rng = np.random.default_rng(1)
    f = rng.standard_normal((ctx.nxe, ctx.nze)).astype(np.float32)
    K, h = 2, 4
    H = K * h
    nxl = -(-ctx.nxe // 4)
    fpad = np.pad(f, ((0, 4 * nxl - ctx.nxe), (0, 0)))
    g = jax.shard_map(lambda pl: halo_exchange_lanes(pl.T, H, "x", 4).T,
                      mesh=jmesh, in_specs=P("x", None),
                      out_specs=P("x", None), check_vma=False)
    want = np.asarray(jax.jit(g)(fpad)).reshape(4, nxl + 2 * H, ctx.nze)
    slabs = dk.prepare_slabs(ctx, ["cpu"] * 4, K,
                             np.ones((ctx.nxe, ctx.nze), np.float32), "top",
                             sxs=[10], sz=6)
    bufs = []
    for j, part in enumerate(domain.to_slabs(f[None], ["cpu"] * 4)):
        b = torch.zeros((1, nxl + 2 * H, ctx.nze))
        b[:, H:H + nxl] = part
        bufs.append(b)
    dk.exchange(slabs, bufs)
    for j in range(4):
        np.testing.assert_array_equal(bufs[j][0].numpy(), want[j])


@pytest.mark.parametrize("order", [2, 4, 8, 10])
def test_sharded_laplacian_is_the_unsharded_laplacian(jmesh, order):
    nxe, nze = 30, 28                    # padded to 32 over x = 4
    p = np.random.default_rng(order).standard_normal(
        (nxe, nze)).astype(np.float32)
    cx, cz = tnum.scaled_coefficients(order, 10.0, 12.5)
    got = domain.from_slabs(domain.sharded_laplacian(
        domain.to_slabs(p, ["cpu"] * 4), cx, cz, order, nxe), nxe, "cpu")
    want = stencil.laplacian(torch.from_numpy(p), cx, cz, order)
    assert torch.equal(got, want)
    pad = np.pad(p, ((0, 2), (0, 0)))
    f = jax.shard_map(
        lambda pl: j_sharded_laplacian(pl, jnp.asarray(cx), jnp.asarray(cz),
                                       order, nxe, "x", 4),
        mesh=jmesh, in_specs=P("x", None), out_specs=P("x", None),
        check_vma=False)
    assert_close(got, np.asarray(jax.jit(f)(pad))[:nxe])


# ------------------------------------------------------- per-step makers

@pytest.mark.parametrize("source,taper", [("point", "all"),
                                          ("gaussian", "top")])
def test_per_step_modeling_matches_jax_lax_and_unsharded(jmesh, source,
                                                         taper):
    jctx, ctx = _ctxs(nx=23, nt=24)      # nxe = 31: padded
    rng = np.random.default_rng(2)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    sxs, sz, gz = [10, 14], 8, 5
    gauss = source == "gaussian"
    got = domain.make_sharded_forward_modeling(
        ctx, cpu_mesh(2, 4), gz, source=source, taper=taper)(
        v2, domain.embed_source_fields(ctx, sxs, sz, gauss), wav)
    want = j_lax_modeling(jctx, jmesh, gz, source=source, taper=taper)(
        v2, j_embed_source_fields(jctx, sxs, sz, gauss), jnp.asarray(wav))
    assert_close(got, want)
    ref = torch.stack([solver.forward_modeling(
        ctx, torch.from_numpy(v2[s]), wav, sxs[s], sz, gz, source=source,
        taper=taper)[2][0] for s in range(2)])
    assert torch.equal(got[:, :, ctx.nxb:ctx.nxb + ctx.nx], ref)


def test_per_step_rtm_matches_jax_lax_and_unsharded(jmesh):
    jctx, ctx = _ctxs(nx=23, nt=24)
    rng = np.random.default_rng(3)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    sxs, sz, gz = [10, 14], 6, 5
    srcf = domain.embed_source_fields(ctx, sxs, sz)
    d_ext = domain.embed_dobs(ctx, dobs)
    got = domain.make_sharded_rtm_snapshot(ctx, cpu_mesh(2, 4), gz)(
        v2, srcf, wav, d_ext)
    want = j_lax_rtm(jctx, jmesh, gz)(v2, srcf, jnp.asarray(wav), d_ext)
    assert_close(got, want)
    ref = solver.rtm_shot_snapshot(ctx, torch.from_numpy(v2), wav,
                                   torch.from_numpy(dobs), sxs, sz, gz)
    assert torch.equal(got[:, ctx.nxb:ctx.nxe - ctx.nxb,
                           ctx.nzb:ctx.nze - ctx.nzb], ref)


# ---------------------------------------------------------- block makers

MOD_CASES = [  # order, K, nt, source, taper, nx
    (8, 4, 40, "point", "top", 56),
    (8, 3, 42, "gaussian", "all", 56),
    (4, 2, 21, "gaussian", "all", 56),
    (10, 4, 42, "point", "top", 120),
    (8, 3, 24, "gaussian", "all", 51),       # nxe = 59, padded to 60
]


@pytest.mark.parametrize("order,k,nt,source,taper,nx", MOD_CASES)
def test_block_modeling_matches_pallas(jmesh, order, k, nt, source, taper,
                                       nx):
    jctx, ctx = _ctxs(nx=nx, nt=nt, order=order)
    rng = np.random.default_rng(order * 100 + k)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    sxs, sz, gz = np.asarray([18, 34], np.int32), 8, 5
    got = dk.make_sharded_forward_modeling_cuda(
        ctx, cpu_mesh(2, 4), sz, gz, source=source, taper=taper,
        block_k=k)(v2, sxs, wav)
    want = make_sharded_forward_modeling_pallas(
        jctx, jmesh, sz, gz, source=source, taper=taper, block_k=k,
        interpret=True)(v2, sxs, jnp.asarray(wav))
    assert got.shape == (2, nt, ctx.nxe)
    assert_close(got, want)
    # the same gathers as the unsharded plain loop, bitwise
    ref = torch.stack([solver.forward_modeling(
        ctx, torch.from_numpy(v2[s]), wav, int(sxs[s]), sz, gz,
        source=source, taper=taper)[2][0] for s in range(2)])
    assert torch.equal(got[:, :, ctx.nxb:ctx.nxb + ctx.nx], ref)


RTM_CASES = [  # order, K, nt, nx
    (8, 4, 40, 56),         # no tails
    (8, 4, 42, 56),         # forward tail 2, backward 9 blocks + tail 2
    (8, 3, 21, 56),         # odd K
    (4, 2, 21, 56),
    (10, 3, 42, 120),
    (8, 3, 24, 51),         # nxe = 59, padded to 60
]


def _rtm_inputs(ctx, seed, sxs=(18, 34)):
    rng = np.random.default_rng(seed)
    v2 = _velocity(rng, ctx)
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    return v2, wav, dobs, np.asarray(sxs, np.int32)


@pytest.mark.parametrize("order,k,nt,nx", RTM_CASES)
def test_block_rtm_matches_pallas(jmesh, order, k, nt, nx):
    jctx, ctx = _ctxs(nx=nx, nt=nt, order=order)
    v2, wav, dobs, sxs = _rtm_inputs(ctx, order * 100 + k)
    sz, gz = 6, 5
    d_ext = domain.embed_dobs(ctx, dobs)
    got = dk.make_sharded_rtm_snapshot_cuda(ctx, cpu_mesh(2, 4), sz, gz,
                                            block_k=k)(v2, sxs, wav, d_ext)
    want = make_sharded_rtm_snapshot_pallas(jctx, jmesh, sz, gz, block_k=k,
                                            interpret=True)(
        v2, sxs, jnp.asarray(wav), d_ext)
    assert got.shape == (2, ctx.nxe, ctx.nze)
    assert_close(got, want)
    ref = solver.rtm_shot_snapshot(ctx, torch.from_numpy(v2), wav,
                                   torch.from_numpy(dobs), sxs.tolist(), sz,
                                   gz)
    assert_close(got[:, ctx.nxb:ctx.nxe - ctx.nxb, ctx.nzb:ctx.nze - ctx.nzb],
                 ref)


def test_block_rtm_source_across_a_slab_edge(jmesh):
    """Sources on both sides of a slab boundary: the injection reaches the
    neighbour through its recomputed halo (``test_parallel.py:317-341``)."""
    jctx, ctx = _ctxs(nt=24)
    nxl = ctx.nxe // 4
    v2, wav, dobs, sxs = _rtm_inputs(ctx, 7, sxs=(nxl - 1, nxl))
    d_ext = domain.embed_dobs(ctx, dobs)
    got = dk.make_sharded_rtm_snapshot_cuda(ctx, cpu_mesh(2, 4), 6, 5,
                                            block_k=2)(v2, sxs, wav, d_ext)
    want = make_sharded_rtm_snapshot_pallas(jctx, jmesh, 6, 5, block_k=2,
                                            interpret=True)(
        v2, sxs, jnp.asarray(wav), d_ext)
    assert_close(got, want)
    # every (shot, x) split of the same work gives the same images
    for shape in ((1, 4), (2, 2), (1, 3)):
        again = dk.make_sharded_rtm_snapshot_cuda(ctx, cpu_mesh(*shape), 6, 5,
                                                  block_k=2)(v2, sxs, wav,
                                                             d_ext)
        assert_close(again, got, 1e-6)


def test_block_functions_keep_zero_halos_and_sum_the_image_per_block():
    """The plain block functions' contract: owned rows out, zero halo rows;
    ``block_bwd`` adds its block's delta, summed from 0, to the image."""
    _, ctx = _ctxs(nt=12)
    v2, wav, dobs, sxs = _rtm_inputs(ctx, 9)
    slabs = dk.prepare_slabs(ctx, ["cpu"] * 2, 3, v2, "top", sxs=sxs, sz=6,
                             dobs_ext=domain.embed_dobs(ctx, dobs), gz=5)
    c = slabs[1]
    rng = np.random.default_rng(0)
    f = [torch.from_numpy(rng.standard_normal(
        (2, c.nxw, ctx.nze)).astype(np.float32)) for _ in range(4)]
    img = torch.zeros((2, c.nxl, ctx.nze))
    out = dk.block_bwd(c, *f, img, 3, 3)
    for o in out[:4]:
        assert not o[:, :c.hs].any() and not o[:, c.hs + c.nxl:].any()
    out2 = dk.block_bwd(c, *f, out[4], 3, 3)
    assert torch.equal(out2[4], out[4] + out[4])
    dk.reset_launches()
    spare = [torch.zeros_like(t) for t in f]
    got = dk.block_bwd_cuda(c, *f, img, 3, 3, out=spare)
    assert all(torch.equal(a, b) for a, b in zip(got, out))
    assert dk.LAUNCHES == {"block_mod": 0, "block_fwd": 0, "block_bwd": 0,
                           "block_mod_mma": 0, "block_fwd_mma": 0,
                           "block_bwd_mma": 0}
    # the kernels' output buffers: four, distinct, none an input
    for bad in (spare[:3], [spare[0]] * 4, [f[0]] + spare[1:],
                [spare[0][:1]] + spare[1:]):
        with pytest.raises(ValueError):
            dk.block_bwd_cuda(c, *f, img, 3, 3, out=bad)


def test_block_makers_swap_buffers_as_the_kernels_need(monkeypatch):
    """The makers as they run on the card, where a kernel writes only the
    owned rows of the output buffers it is given (the spare set, whose
    inner halos hold an older exchange): wrappers that do just that on the
    CPU give the plain makers' gathers and images bitwise."""
    _, ctx = _ctxs(nt=21)
    v2, wav, dobs, sxs = _rtm_inputs(ctx, 5, sxs=(13, 14))
    d_ext = domain.embed_dobs(ctx, dobs)
    mesh = cpu_mesh(1, 4)

    def makers():
        return (dk.make_sharded_forward_modeling_cuda(
                    ctx, mesh, 6, 5, block_k=3)(v2[0], sxs, wav),
                dk.make_sharded_rtm_snapshot_cuda(ctx, mesh, 6, 5, block_k=3)(
                    v2, sxs, wav, d_ext))

    want = makers()
    seen = []

    def owned_rows_only(plain, n):
        def run(c, *args, out=None, parts=0):
            assert out is not None and parts == 0
            dk._check_out(c, args[:n if n == 2 else 5], out, n)
            got = plain(c, *args)
            rows = slice(c.hs, c.hs + c.nxl)
            for o, g in zip(out, got[:n]):
                seen.append(bool(o[:, :c.hs].any() or o[:, rows.stop:].any()))
                o[:, rows] = g[:, rows]
            return (*out, *got[n:])
        return run
    monkeypatch.setattr(dk, "block_mod_cuda", owned_rows_only(dk.block_mod, 2))
    monkeypatch.setattr(dk, "block_fwd_cuda", owned_rows_only(dk.block_fwd, 2))
    monkeypatch.setattr(dk, "block_bwd_cuda", owned_rows_only(dk.block_bwd, 4))
    got = makers()
    assert any(seen)            # stale inner halos were handed out
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- errors

def test_block_maker_errors():
    _, ctx = _ctxs(nt=6)
    mesh = cpu_mesh(1, 4)                # nxl = 16, h = 4
    with pytest.raises(ValueError, match="exceeds the local slab width"):
        dk.make_sharded_forward_modeling_cuda(ctx, mesh, 8, 5, block_k=5)
    with pytest.raises(ValueError, match="exceeds the local slab width"):
        dk.make_sharded_rtm_snapshot_cuda(ctx, mesh, 8, 5, block_k=5)
    with pytest.raises(ValueError, match="block_k must be >= 2"):
        dk.make_sharded_rtm_snapshot_cuda(ctx, mesh, 8, 5, block_k=1)
    with pytest.raises(ValueError, match="nt=6 < 2\\*block_k=8"):
        dk.make_sharded_rtm_snapshot_cuda(ctx, mesh, 8, 5, block_k=4)
    # a split lap_impl runs the plain split block function (auto is mxu
    # here: nt = 6, dx == dz); an unknown one raises
    v2 = np.full((ctx.nxe, ctx.nze), 2000.0 ** 2, np.float32)
    wav = np.float32(np.random.default_rng(0).standard_normal(ctx.nt))
    seis = {lap_impl: dk.make_sharded_forward_modeling_cuda(
        ctx, mesh, 8, 5, block_k=2, lap_impl=lap_impl)(v2, [20], wav)
        for lap_impl in (None, "mxu", "mxu6", "auto")}
    assert torch.equal(seis["auto"], seis["mxu"])
    assert not torch.equal(seis["mxu"], seis[None])
    assert not torch.equal(seis["mxu6"], seis["mxu"])
    with pytest.raises(ValueError, match="unknown lap_impl"):
        dk.make_sharded_forward_modeling_cuda(ctx, mesh, 8, 5, block_k=2,
                                              lap_impl="mxu3")
    fn = dk.make_sharded_forward_modeling_cuda(ctx, mesh, 2, 5, block_k=2)
    with pytest.raises(ValueError, match="source window"):
        fn(np.ones((ctx.nxe, ctx.nze), np.float32), [20], ctx.source_patch)


CFG = dict(nz=24, nx=24, nt=40, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
           ns=3, sz=0, fsx=2, ds=8, gz=0, nxb=4, nzb=4, fac=0.7, order=8)


def test_pipeline_mesh_errors():
    p = tpk.Params(**CFG)
    vp = layered_model(p.nx, p.nz, (1500.0, 2500.0), interfaces=[12])
    dobs = np.zeros((p.ns, p.nx, p.nt), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.run_rtm_cpu(p, vp=vp, dobs=dobs, mesh=cpu_mesh(1, 2))
    # nxe = 32 over 8 slabs: K = 4 // 4 = 1 < 2 for RTM
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, mesh=cpu_mesh(1, 8))
    # a CPU mesh keeps the exact taps under a split lap_impl, as the JAX
    # lax domain path does on the CPU
    np.testing.assert_array_equal(
        tpipe.run_modeling(p, vp=vp, mesh=cpu_mesh(1, 2), lap_impl="mxu"),
        tpipe.run_modeling(p, vp=vp, mesh=cpu_mesh(1, 2)))
    with pytest.raises(ValueError, match="unknown lap_impl"):
        tpipe.run_rtm_gpu(p, vp=vp, dobs=dobs, mesh=cpu_mesh(1, 2),
                          lap_impl="mxu3")


# ------------------------------------------------------------- pipelines

@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """The JAX and port Params of one small survey, its velocity, its
    per-shot boundary velocities in a vel_ext_file (the two packages'
    generators draw different numbers) and the JAX pipelines' outputs
    without a mesh."""
    tmp = tmp_path_factory.mktemp("survey")
    jp, tp = jpk.Params(**CFG), tpk.Params(**CFG)
    vp = layered_model(tp.nx, tp.nz, (1500.0, 2500.0), interfaces=[12])
    base = np.zeros((tp.nxe, tp.nze), np.float32)
    base[tp.nxb:tp.nxb + tp.nx, tp.nzb:tp.nzb + tp.nz] = vp
    tio.write_f32(str(tmp / "vel_ext.bin"), np.stack([
        tnum.extendvel_random(base, tp.nx, tp.nz, tp.nxb, tp.nzb, seed=5 + i)
        for i in range(tp.ns)]))
    jp.vel_ext_file = tp.vel_ext_file = str(tmp / "vel_ext.bin")
    jd = jpipe.run_modeling(jp, vp=vp, backend="lax")
    return jp, tp, vp, jd


@pytest.mark.parametrize("shape", [(2, 4), (3, 1), (1, 2)])
def test_pipelines_with_meshes_match_jax(jmesh, survey, shape):
    jp, tp, vp, jd = survey
    mesh = cpu_mesh(*shape)
    td = tpipe.run_modeling(tp, vp=vp, mesh=mesh)
    assert td.shape == (tp.ns, tp.nx, tp.nt)
    assert rel_rms(td, jd) <= GATE
    np.testing.assert_array_equal(
        td, tpipe.run_modeling(tp, vp=vp, device="cpu"))
    timg, tlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=jd, mesh=mesh)
    jmesh_here = jmesh if shape == (2, 4) else j_make_mesh(*shape)
    jimg, jlocs = jpipe.run_rtm_gpu(jp, vp=vp, dobs=jd, backend="lax",
                                    mesh=jmesh_here)
    assert rel_rms(timg, jimg) <= GATE
    for s in range(tp.ns):
        assert rel_rms(tlocs[s], jlocs[s]) <= GATE
    nimg, nlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=jd, device="cpu")
    assert rel_rms(timg, nimg) <= GATE and rel_rms(tlocs, nlocs) <= GATE


def test_run_rtm_cpu_with_a_shot_mesh_matches_jax(survey):
    jp, tp, vp, jd = survey
    jimg, jlocs = jpipe.run_rtm_cpu(jp, vp=vp, dobs=jd, backend="lax",
                                    mesh=j_make_mesh(n_shot=2))
    timg, tlocs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=jd, mesh=cpu_mesh(2, 1))
    assert rel_rms(timg, jimg) <= GATE and rel_rms(tlocs, jlocs) <= GATE
    nimg, nlocs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=jd, device="cpu")
    assert rel_rms(tlocs, nlocs) <= 1e-7


def test_no_dummy_shots(monkeypatch, survey):
    """3 shots over a shot axis of 2 run 3 shots, not 4: the per-step
    runners get 2 + 1 shots, the per-step domain loops of a CPU x mesh step
    groups of 2 + 1 shots, and the block functions' launches carry 2 + 1
    shots a block."""
    _, tp, vp, jd = survey
    seen = []
    real = shots.forward_modeling_cuda

    def counting(ctx, v2, wav, sxs, *a, **k):
        seen.append(len(sxs))
        return real(ctx, v2, wav, sxs, *a, **k)
    monkeypatch.setattr(shots, "forward_modeling_cuda", counting)
    tpipe.run_modeling(tp, vp=vp, mesh=cpu_mesh(2, 1))
    assert seen == [2, 1]
    stepped = []
    real_update = domain._sharded_update
    monkeypatch.setattr(domain, "_sharded_update", lambda ctx, p, pp, v2: (
        stepped.append(p[0].shape[0]), real_update(ctx, p, pp, v2))[1])
    data = tpipe.run_modeling(tp, vp=vp, mesh=cpu_mesh(2, 2))
    assert sorted(stepped) == [1] * tp.nt + [2] * tp.nt
    launched = []
    real_mod = dk.block_mod
    monkeypatch.setattr(dk, "block_mod", lambda c, p, pp, a, parts: (
        launched.append(p.shape[0]), real_mod(c, p, pp, a, parts))[1])
    ctx = solver.FDContext.from_params(tp, exact_taper=False)
    g = tpk.Geometry.from_params(tp)
    k = 4                              # min(8, (32 // 2) // 4, nt)
    seis = dk.make_sharded_forward_modeling_cuda(
        ctx, cpu_mesh(2, 2), g.sz, g.gz, block_k=k)(
        torch.from_numpy(tpipe.prepare_velocity_cpu(tp, vp)), g.sx,
        tnum.ricker_wavelet(tp.nt, tp.dt, tp.fpeak, truncated=True))
    blocks = -(-tp.nt // k)
    assert sorted(launched) == [1] * 2 * blocks + [2] * 2 * blocks
    assert seis.shape == (tp.ns, tp.nt, ctx.nxe)
    np.testing.assert_array_equal(
        seis[:, :, ctx.nxb:ctx.nxb + ctx.nx].transpose(1, 2).numpy(), data)


def test_cli_shards_options(tmp_path, survey):
    _, tp, vp, jd = survey
    tio.write_f32(str(tmp_path / "vp.bin"), vp)
    cfg = tmp_path / "input.dat"
    cfg.write_text("".join(f"{k}={v}\n" for k, v in CFG.items())
                   + "vpfile=vp.bin\ndatfile=d.bin\n")
    out = tmp_path / "d.bin"
    tcli.main(["mod", str(cfg), "--device", "cpu", "--shards-x", "2",
               "--output", str(out)])
    np.testing.assert_array_equal(
        tio.read_f32(str(out)).reshape(tp.ns, tp.nx, tp.nt),
        tpipe.run_modeling(tpk.Params(**CFG), vp=vp, device="cpu"))
    tcli.main(["mod", str(cfg), "--device", "cpu", "--shards-shot", "2",
               "--output", str(out)])
    tcli.main(["rtm_gpu", str(cfg), "--device", "cpu", "--shards-x", "2",
               "--outdir", str(tmp_path)])
    assert (tmp_path / "dir.image").stat().st_size == tp.nx * tp.nz * 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["rtm", str(cfg), "--device", "cpu", "--shards-x", "2",
                   "--outdir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="mesh needs"):
            tcli.main(["mod", str(cfg), "--shards-x", "2",
                       "--output", str(out)])
