"""The split-bf16 lowering of the domain tiers' block kernels (``lap_impl``
"mxu", "mxu6") against the JAX package, on the CPU.

The port's block makers on CPU meshes run the plain block functions with
the x taps in 2 or 3 bf16 parts (``parts``; :func:`.ops.stencil.
laplacian_mxu`, ``axis="x"``), the plain versions of ``block_*_mma`` and
``block2_*_mma``. The JAX side runs as its own tests run it
(``tests/test_parallel.py:254-315, :370-389``,
``tests/test_parallel2d_pallas.py:43-100``): 8 virtual CPU devices, the
Pallas block makers with ``lap_impl`` in interpret mode, which lowers the
x taps as ``_make_lap``'s MXU branch does on the TPU.

* The modeling and RTM makers of both tiers against the JAX makers at
  orders 4, 8 and 10, odd K, forward and backward tails, nxe (and nze)
  padded, sources across the cuts, acquisition rows in a later z part;
  and the modeling makers in blocks of 8 steps, the pipelines' K, which
  the split kernels on the card take in two passes of 4.
* The split is not the exact taps, and mxu6 lies closer to them than mxu.
* The wrappers: ``parts`` on CPU tensors runs the plain split functions
  and leaves the six ``*_mma`` launch counters at zero; a bad part count
  raises.
* The pipelines on CPU meshes under a split ``lap_impl``: the per-step
  loops with the exact taps, equal to the JAX pipelines there (the JAX
  package runs its lax domain path on the CPU, which ignores
  ``lap_impl``) and bitwise to the port's own exact run.

Tolerances: gathers within 5e-6 of ``max(1, max|jax|)``, images within
1e-5 of ``max|jax|``, the split K-step tier's gates: every product
of two bf16 parts is exact in float32, but the port sums each cross term
over the taps in ascending offset and XLA's dot in its own order, and the
steps compound the difference. Pipelines: 1e-5 relative RMS.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.parallel import (
    make_mesh as j_make_mesh)
from parallel_finite_difference_computation_tpu.parallel.domain2d_pallas \
    import (make_sharded_forward_modeling_2d_pallas,
            make_sharded_rtm_snapshot_2d_pallas)
from parallel_finite_difference_computation_tpu.parallel.domain_pallas import (
    make_sharded_forward_modeling_pallas, make_sharded_rtm_snapshot_pallas)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import pipeline as tpipe
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain, domain2d_kernels as d2k, domain_kernels as dk, make_mesh)

GATHER_TOL = 5e-6
IMAGE_TOL = 1e-5
GATE = 1e-5


@pytest.fixture(scope="module")
def jmeshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return {s: j_make_mesh(*s) for s in ((2, 4), (2, 2, 2), (1, 2, 2),
                                         (1, 2))}


def cpu_mesh(*shape):
    return make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _ctxs(nx=56, nz=20, nt=21, order=8):
    jctx = JaxContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                             order=order, nxb=4, nzb=4, fac=0.7,
                             exact_taper=True)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    return jctx, ctx


def _inputs(ctx, seed, ns=2):
    rng = np.random.default_rng(seed)
    v2 = ((1500.0 + 500.0 * rng.random(
        (ns, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2
    wav = jnum.ricker_wavelet(ctx.nt, 0.001, 25.0)
    dobs = rng.standard_normal((ns, ctx.nx, ctx.nt)).astype(np.float32)
    return v2, wav, dobs


def assert_close(got, want, tol, floor=0.0):
    """max |got - want| <= tol * max(floor, max |want|)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(floor, np.abs(want).max()), err


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# --------------------------------------------------------------- x tier

MOD_CASES = [  # order, K, nt, source, taper, nx, lap_impl
    (8, 3, 22, "gaussian", "all", 56, "mxu"),     # forward tail 1
    (4, 2, 21, "point", "top", 51, "mxu6"),       # nxe = 59, padded to 60
    (10, 3, 21, "point", "top", 120, "mxu"),
]


@pytest.mark.parametrize("order,k,nt,source,taper,nx,lap_impl", MOD_CASES)
def test_split_block_modeling_matches_pallas(jmeshes, order, k, nt, source,
                                             taper, nx, lap_impl):
    jctx, ctx = _ctxs(nx=nx, nt=nt, order=order)
    v2, wav, _ = _inputs(ctx, order * 100 + k)
    sxs, sz, gz = np.asarray([18, 34], np.int32), 8, 5
    got = dk.make_sharded_forward_modeling_cuda(
        ctx, cpu_mesh(2, 4), sz, gz, source=source, taper=taper, block_k=k,
        lap_impl=lap_impl)(v2, sxs, wav)
    want = make_sharded_forward_modeling_pallas(
        jctx, jmeshes[(2, 4)], sz, gz, source=source, taper=taper,
        block_k=k, interpret=True, lap_impl=lap_impl)(
        v2, sxs, jnp.asarray(wav))
    assert got.shape == (2, nt, ctx.nxe)
    assert_close(got, want, GATHER_TOL, 1.0)


RTM_CASES = [  # order, K, nt, nx, lap_impl
    (8, 4, 22, 56, "mxu"),      # forward tail 2, backward 5 blocks + 2
    (8, 3, 21, 56, "mxu6"),     # odd K
    (4, 2, 21, 51, "mxu"),      # nxe = 59, padded to 60
    (10, 3, 21, 120, "mxu6"),
]


@pytest.mark.parametrize("order,k,nt,nx,lap_impl", RTM_CASES)
def test_split_block_rtm_matches_pallas(jmeshes, order, k, nt, nx, lap_impl):
    jctx, ctx = _ctxs(nx=nx, nt=nt, order=order)
    v2, wav, dobs = _inputs(ctx, order * 100 + k)
    sxs, sz, gz = np.asarray([18, 34], np.int32), 6, 5
    d_ext = domain.embed_dobs(ctx, dobs)
    got = dk.make_sharded_rtm_snapshot_cuda(
        ctx, cpu_mesh(2, 4), sz, gz, block_k=k, lap_impl=lap_impl)(
        v2, sxs, wav, d_ext)
    want = make_sharded_rtm_snapshot_pallas(
        jctx, jmeshes[(2, 4)], sz, gz, block_k=k, interpret=True,
        lap_impl=lap_impl)(v2, sxs, jnp.asarray(wav), d_ext)
    assert got.shape == (2, ctx.nxe, ctx.nze)
    assert_close(got, want, IMAGE_TOL)


# ---------------------------------------------------------- (x, z) tier

MOD2_CASES = [  # order, K, nt, source, taper, nx, nz, mesh, sz, gz, sxs, li
    # the 7 x 7 patch across the x cut (32) and the z cut (28)
    (8, 3, 24, "gaussian", "all", 56, 48, (1, 2, 2), 26, 29, (30,), "mxu"),
    # both axes padded: nxe 59 -> 60, nze 53 -> 54
    (4, 2, 21, "gaussian", "all", 51, 45, (1, 2, 2), 6, 5, (18, 34),
     "mxu6"),
    (10, 3, 25, "point", "top", 56, 48, (1, 2, 2), 8, 5, (18, 34), "mxu"),
]


@pytest.mark.parametrize(
    "order,k,nt,source,taper,nx,nz,shape,sz,gz,sxs,lap_impl", MOD2_CASES)
def test_split_block2_modeling_matches_pallas(jmeshes, order, k, nt, source,
                                              taper, nx, nz, shape, sz, gz,
                                              sxs, lap_impl):
    jctx, ctx = _ctxs(nx=nx, nz=nz, nt=nt, order=order)
    v2, wav, _ = _inputs(ctx, order * 100 + k, ns=len(sxs))
    sxs = np.asarray(sxs, np.int32)
    got = d2k.make_sharded_forward_modeling_2d_cuda(
        ctx, cpu_mesh(*shape), sz, gz, source=source, taper=taper,
        block_k=k, lap_impl=lap_impl)(v2, sxs, wav)
    want = make_sharded_forward_modeling_2d_pallas(
        jctx, jmeshes[shape], sz, gz, source=source, taper=taper, block_k=k,
        interpret=True, lap_impl=lap_impl)(v2, sxs, jnp.asarray(wav))
    assert got.shape == (len(sxs), nt, ctx.nxe)
    assert_close(got, want, GATHER_TOL, 1.0)


# Blocks of K = 8 at order 8 (a 32-cell halo) on a 64 x 64 extended grid:
# 32-row slabs of a (1, 2) mesh, 32 x 32 tiles of a (1, 2, 2) mesh, two
# blocks and a tail of 1; the Gaussian source and the trace row across the
# cuts (32).
BLOCK8_CASES = [  # mesh, lap_impl
    ((1, 2), "mxu"),
    ((1, 2, 2), "mxu6"),
]


@pytest.mark.parametrize("shape,lap_impl", BLOCK8_CASES)
def test_split_modeling_blocks_of_8_steps_match_pallas(jmeshes, shape,
                                                       lap_impl):
    jctx, ctx = _ctxs(nx=56, nz=56, nt=17, order=8)
    assert (ctx.nxe, ctx.nze) == (64, 64)
    v2, wav, _ = _inputs(ctx, 800 + len(shape))
    sxs, sz, gz = np.asarray([30, 34], np.int32), 29, 31
    mod, jmod = ((dk.make_sharded_forward_modeling_cuda,
                  make_sharded_forward_modeling_pallas) if len(shape) == 2
                 else (d2k.make_sharded_forward_modeling_2d_cuda,
                       make_sharded_forward_modeling_2d_pallas))
    got = mod(ctx, cpu_mesh(*shape), sz, gz, source="gaussian", taper="all",
              block_k=8, lap_impl=lap_impl)(v2, sxs, wav)
    want = jmod(jctx, jmeshes[shape], sz, gz, source="gaussian", taper="all",
                block_k=8, interpret=True, lap_impl=lap_impl)(
        v2, sxs, jnp.asarray(wav))
    assert got.shape == (2, 17, ctx.nxe)
    assert_close(got, want, GATHER_TOL, 1.0)


RTM2_CASES = [  # order, K, nt, nx, nz, mesh, sz, gz, lap_impl
    (8, 3, 22, 56, 48, (2, 2, 2), 6, 5, "mxu"),     # tails both ways
    # sz, gz below the z cut (28): the rows in z part 1
    (4, 2, 21, 51, 45, (1, 2, 2), 31, 30, "mxu6"),
    (10, 3, 24, 56, 48, (1, 2, 2), 6, 5, "mxu6"),
]


@pytest.mark.parametrize("order,k,nt,nx,nz,shape,sz,gz,lap_impl",
                         RTM2_CASES)
def test_split_block2_rtm_matches_pallas(jmeshes, order, k, nt, nx, nz,
                                         shape, sz, gz, lap_impl):
    jctx, ctx = _ctxs(nx=nx, nz=nz, nt=nt, order=order)
    v2, wav, dobs = _inputs(ctx, order * 100 + k)
    sxs = np.asarray([18, 34], np.int32)
    d_ext = domain.embed_dobs(ctx, dobs)
    got = d2k.make_sharded_rtm_snapshot_2d_cuda(
        ctx, cpu_mesh(*shape), sz, gz, block_k=k, lap_impl=lap_impl)(
        v2, sxs, wav, d_ext)
    want = make_sharded_rtm_snapshot_2d_pallas(
        jctx, jmeshes[shape], sz, gz, block_k=k, interpret=True,
        lap_impl=lap_impl)(v2, sxs, jnp.asarray(wav), d_ext)
    assert got.shape == (2, ctx.nxe, ctx.nze)
    assert_close(got, want, IMAGE_TOL)


# ------------------------------------------------------ split vs exact

@pytest.mark.parametrize("tier", ["x", "x, z"])
def test_split_is_not_exact_and_mxu6_is_closer(tier):
    """The split gathers and images differ from the exact ones, and the
    6-pass split (mxu6) lies closer to them than the 3-pass (mxu)."""
    _, ctx = _ctxs(nx=56, nz=48, nt=21)
    v2, wav, dobs = _inputs(ctx, 5)
    sxs, sz, gz = [18, 34], 6, 5
    d_ext = domain.embed_dobs(ctx, dobs)
    if tier == "x":
        mesh, mod, rtm = (cpu_mesh(1, 4), dk.make_sharded_forward_modeling_cuda,
                          dk.make_sharded_rtm_snapshot_cuda)
    else:
        mesh, mod, rtm = (cpu_mesh(1, 2, 2),
                          d2k.make_sharded_forward_modeling_2d_cuda,
                          d2k.make_sharded_rtm_snapshot_2d_cuda)
    runs = {li: (mod(ctx, mesh, sz, gz, block_k=3, lap_impl=li)(
                     v2[0], sxs, wav),
                 rtm(ctx, mesh, sz, gz, block_k=3, lap_impl=li)(
                     v2, sxs, wav, d_ext))
            for li in (None, "mxu", "mxu6")}
    for i in range(2):
        exact = runs[None][i]
        d3 = float((runs["mxu"][i] - exact).abs().max())
        d6 = float((runs["mxu6"][i] - exact).abs().max())
        assert 0.0 < d6 < d3 <= 1e-4 * float(exact.abs().max())


# ------------------------------------------------------------ wrappers

def test_split_wrappers_route_cpu_tensors_and_check_parts():
    """``parts`` on CPU tensors runs the plain split block functions,
    launches nothing, and leaves the ``*_mma`` counters at zero; a part
    count other than 0, 2 or 3 raises before anything runs."""
    _, ctx = _ctxs(nx=56, nz=48, nt=12)
    v2, wav, dobs = _inputs(ctx, 9)
    d_ext = domain.embed_dobs(ctx, dobs)
    rng = np.random.default_rng(2)
    dk.reset_launches()
    d2k.reset_launches()
    for mesh, cuda_fns in (
            (cpu_mesh(1, 2), (dk.block_mod_cuda, dk.block_fwd_cuda,
                              dk.block_bwd_cuda)),
            (cpu_mesh(1, 2, 2), (d2k.block2_mod_cuda, d2k.block2_fwd_cuda,
                                 d2k.block2_bwd_cuda))):
        geom = (dk.slab_geometry(ctx, 2, 3) if len(mesh.shape) == 2
                else d2k.tile_geometry(ctx, 2, 2, 3))
        c = dk.prepare_tiles(ctx, mesh.grid(0), geom, v2, "top",
                             sxs=[18, 34], sz=6, dobs_ext=d_ext, gz=5)[1]
        f = [torch.from_numpy(rng.standard_normal(
            (2, c.nxw, c.nzw)).astype(np.float32)) for _ in range(6)]
        img = torch.zeros((2, c.nxl, c.nzl))
        km, kf, kb = cuda_fns
        for parts in (2, 3):
            pairs = ((km(c, f[0], f[1], wav[:3], parts=parts),
                      dk.block_mod(c, f[0], f[1], wav[:3], parts)),
                     (kf(c, f[0], f[1], wav[:3], parts=parts),
                      dk.block_fwd(c, f[0], f[1], wav[:3], parts)),
                     (kb(c, *f[:4], img, 0, 3, f[4:], parts=parts),
                      dk.block_bwd(c, *f[:4], img, 0, 3, f[4:], parts)))
            for got, want in pairs:
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert not torch.equal(pairs[1][0][1],
                                   dk.block_fwd(c, f[0], f[1], wav[:3])[1])
        for bad in (1, 4):
            with pytest.raises(ValueError, match="0, 2 or 3"):
                km(c, f[0], f[1], wav[:3], parts=bad)
    assert dk.LAUNCHES == dict.fromkeys(
        ("block_mod", "block_fwd", "block_bwd", "block_mod_mma",
         "block_fwd_mma", "block_bwd_mma"), 0)
    assert d2k.LAUNCHES == dict.fromkeys(
        ("block2_mod", "block2_fwd", "block2_bwd", "block2_mod_mma",
         "block2_fwd_mma", "block2_bwd_mma"), 0)
    assert not hasattr(fk, "check_exact_taps")


# ------------------------------------------------------------ pipelines

CFG = dict(nz=24, nx=24, nt=40, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
           ns=3, sz=0, fsx=2, ds=8, gz=0, nxb=4, nzb=4, fac=0.7, order=8)


@pytest.mark.parametrize("shape", [(1, 2), (1, 2, 2)])
def test_cpu_mesh_pipelines_under_a_split_lap_impl_match_jax(jmeshes,
                                                             tmp_path,
                                                             shape):
    """``run_modeling`` and ``run_rtm_gpu`` over a CPU mesh with
    ``lap_impl="mxu"`` run the per-step loops with the exact taps, as the
    JAX pipelines do on the CPU (their lax domain path ignores
    ``lap_impl``): against the JAX pipelines with the same mesh and
    ``lap_impl``, and bitwise the port's run without one."""
    jp, tp = jpk.Params(**CFG), tpk.Params(**CFG)
    vp = layered_model(tp.nx, tp.nz, (1500.0, 2500.0), interfaces=[12])
    base = np.zeros((tp.nxe, tp.nze), np.float32)
    base[tp.nxb:tp.nxb + tp.nx, tp.nzb:tp.nzb + tp.nz] = vp
    from parallel_finite_difference_computation_tpu_torch import (
        io as tio, numerics as tnum)
    tio.write_f32(str(tmp_path / "vel_ext.bin"), np.stack([
        tnum.extendvel_random(base, tp.nx, tp.nz, tp.nxb, tp.nzb, seed=5 + i)
        for i in range(tp.ns)]))
    jp.vel_ext_file = tp.vel_ext_file = str(tmp_path / "vel_ext.bin")
    mesh, jmesh = cpu_mesh(*shape), jmeshes[shape]
    td = tpipe.run_modeling(tp, vp=vp, mesh=mesh, lap_impl="mxu")
    jd = jpipe.run_modeling(jp, vp=vp, mesh=jmesh, lap_impl="mxu")
    assert rel_rms(td, jd) <= GATE
    np.testing.assert_array_equal(td, tpipe.run_modeling(tp, vp=vp,
                                                         mesh=mesh))
    timg, tlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=jd, mesh=mesh,
                                    lap_impl="mxu")
    jimg, jlocs = jpipe.run_rtm_gpu(jp, vp=vp, dobs=jd, mesh=jmesh,
                                    lap_impl="mxu")
    assert rel_rms(timg, jimg) <= GATE and rel_rms(tlocs, jlocs) <= GATE
    eimg, elocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=jd, mesh=mesh)
    np.testing.assert_array_equal(timg, eimg)
    np.testing.assert_array_equal(tlocs, elocs)
