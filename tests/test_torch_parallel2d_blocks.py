"""The port's (x, z) block makers against the JAX package's 2D blocked
Pallas makers, on the CPU.

The JAX side runs as ``tests/test_parallel2d_pallas.py`` runs it: on 8
virtual CPU devices, ``make_sharded_*_2d_pallas`` in interpret mode. The
port's meshes put every position on the CPU, so its makers
(``parallel/domain2d_kernels.py``) run the plain block functions through
the wrappers, with the tile set-up, the two-stage exchange and the buffer
swaps that the card runs.

The cases: orders 4, 8 and 10; K = 2, 3 and 4; forward and backward
tails; nxe and nze no multiples of the mesh axes; sz and gz in a non-root
z shard, and gz within the halo of the next; a Gaussian source across
both cuts; a single-part x axis (no x halo). Tolerance: ``max|port - jax|
<= 2e-6 * max|jax|``, the JAX tests' own (XLA contracts some
multiply-adds, and the JAX kernels form the Gaussian with a float32
``exp``); the gathers bitwise the unsharded plain loop's, the images
within the same 2e-6 of it (they are summed per block).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu.parallel import (
    make_mesh as j_make_mesh)
from parallel_finite_difference_computation_tpu.parallel.domain2d_pallas \
    import (make_sharded_forward_modeling_2d_pallas,
            make_sharded_rtm_snapshot_2d_pallas)
from parallel_finite_difference_computation_tpu.solver import (
    FDContext as JaxContext)

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.convert import (
    context_from_arrays)
from parallel_finite_difference_computation_tpu_torch.parallel import (
    domain, domain_kernels as dk, domain2d_kernels as d2k, make_mesh)

MAKER_TOL = 2e-6


@pytest.fixture(scope="module")
def jmeshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return {s: j_make_mesh(*s) for s in ((2, 2, 2), (1, 2, 2), (1, 2, 4),
                                         (1, 1, 4))}


def cpu_mesh(*shape):
    return make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _ctxs(nx=56, nz=48, nt=24, order=8):
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


def assert_close(got, want, tol=MAKER_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


MOD_CASES = [  # order, K, nt, source, taper, nx, nz, mesh, sz, gz, sxs
    (8, 4, 40, "point", "top", 56, 48, (2, 2, 2), 8, 5, (18, 34)),
    (8, 4, 42, "gaussian", "all", 56, 48, (2, 2, 2), 8, 5, (18, 34)),
    (4, 2, 21, "gaussian", "all", 51, 45, (1, 2, 2), 6, 5, (18, 34)),
    (10, 3, 25, "point", "top", 56, 48, (1, 2, 2), 8, 5, (18, 34)),
    # sz, gz in the second z shard (rows 28..55)
    (8, 3, 24, "gaussian", "all", 56, 48, (1, 2, 2), 31, 30, (18, 34)),
    # the 7 x 7 patch across the x cut (32) and the z cut (28)
    (8, 3, 24, "gaussian", "all", 56, 48, (1, 2, 2), 26, 29, (30,)),
    # no x halo; gz in z shard 1 (rows 14..27)
    (8, 2, 21, "gaussian", "all", 56, 48, (1, 1, 4), 6, 17, (18, 34)),
    # gz in shard 0 and in the halo of shard 1; sz in shard 1
    (8, 3, 21, "gaussian", "all", 56, 48, (1, 2, 4), 16, 13, (18, 34)),
]


@pytest.mark.parametrize(
    "order,k,nt,source,taper,nx,nz,shape,sz,gz,sxs", MOD_CASES)
def test_block2_modeling_matches_pallas(jmeshes, order, k, nt, source, taper,
                                        nx, nz, shape, sz, gz, sxs):
    jctx, ctx = _ctxs(nx=nx, nz=nz, nt=nt, order=order)
    v2, wav, _ = _inputs(ctx, order * 100 + k, ns=len(sxs))
    sxs = np.asarray(sxs, np.int32)
    got = d2k.make_sharded_forward_modeling_2d_cuda(
        ctx, cpu_mesh(*shape), sz, gz, source=source, taper=taper,
        block_k=k)(v2, sxs, wav)
    want = make_sharded_forward_modeling_2d_pallas(
        jctx, jmeshes[shape], sz, gz, source=source, taper=taper, block_k=k,
        interpret=True)(v2, sxs, jnp.asarray(wav))
    assert got.shape == (len(sxs), nt, ctx.nxe)
    assert_close(got, want)
    # the same gathers as the unsharded plain loop, bitwise
    ref = torch.stack([solver.forward_modeling(
        ctx, torch.from_numpy(v2[s]), wav, int(sxs[s]), sz, gz,
        source=source, taper=taper)[2][0] for s in range(len(sxs))])
    assert torch.equal(got[:, :, ctx.nxb:ctx.nxb + ctx.nx], ref)


RTM_CASES = [  # order, K, nt, nx, nz, mesh, sz, gz, sxs
    (8, 4, 40, 56, 48, (2, 2, 2), 6, 5, (18, 34)),    # no tails
    (8, 4, 42, 56, 48, (2, 2, 2), 6, 5, (18, 34)),    # tails of 2
    (8, 3, 21, 56, 48, (1, 2, 2), 6, 5, (18, 34)),    # odd K
    (4, 2, 21, 56, 48, (1, 2, 4), 16, 13, (18, 34)),
    (10, 3, 42, 56, 48, (1, 2, 2), 6, 5, (18, 34)),
    (8, 3, 24, 51, 45, (2, 2, 2), 6, 5, (18, 34)),    # 59 x 53: padded
    (8, 3, 24, 56, 48, (1, 2, 2), 31, 30, (18, 34)),  # second z shard
    (8, 2, 24, 56, 48, (1, 2, 2), 27, 28, (31, 32)),  # across both cuts
    (8, 3, 21, 56, 48, (1, 1, 4), 6, 17, (18, 34)),   # no x halo
]


@pytest.mark.parametrize("order,k,nt,nx,nz,shape,sz,gz,sxs", RTM_CASES)
def test_block2_rtm_matches_pallas(jmeshes, order, k, nt, nx, nz, shape, sz,
                                   gz, sxs):
    jctx, ctx = _ctxs(nx=nx, nz=nz, nt=nt, order=order)
    v2, wav, dobs = _inputs(ctx, order * 100 + k)
    sxs = np.asarray(sxs, np.int32)
    d_ext = domain.embed_dobs(ctx, dobs)
    got = d2k.make_sharded_rtm_snapshot_2d_cuda(
        ctx, cpu_mesh(*shape), sz, gz, block_k=k)(v2, sxs, wav, d_ext)
    want = make_sharded_rtm_snapshot_2d_pallas(
        jctx, jmeshes[shape], sz, gz, block_k=k, interpret=True)(
        v2, sxs, jnp.asarray(wav), d_ext)
    assert got.shape == (2, ctx.nxe, ctx.nze)
    assert_close(got, want)
    ref = solver.rtm_shot_snapshot(ctx, torch.from_numpy(v2), wav,
                                   torch.from_numpy(dobs), sxs.tolist(), sz,
                                   gz)
    assert_close(got[:, ctx.nxb:ctx.nxe - ctx.nxb, ctx.nzb:ctx.nze - ctx.nzb],
                 ref)


def test_block2_functions_keep_zero_halos_and_route_cpu_tensors():
    """The plain block functions on an (x, z) tile: owned cells out, zero
    halos on both axes; ``block2_bwd`` adds its block's delta, summed from
    0, to the image. The wrappers leave the counters at 0 on the CPU, and
    refuse what the kernels cannot take."""
    _, ctx = _ctxs(nt=12)
    v2, wav, dobs = _inputs(ctx, 9)
    geom = d2k.tile_geometry(ctx, 2, 2, 3)
    tiles = d2k.prepare_tiles(ctx, cpu_mesh(1, 2, 2).grid(0), geom, v2,
                              "top", sxs=[18, 34], sz=30,
                              dobs_ext=domain.embed_dobs(ctx, dobs), gz=45)
    # tiles (x, z) hold columns [-12, 40) and [16, 68): only z part 1 holds
    # gz = 45 and injects there
    c = tiles[3]
    assert (c.j, c.l, c.sz, c.gz) == (1, 1, 14, 29)
    assert tiles[0].gz == -1 and tiles[0].inj is None
    rng = np.random.default_rng(0)
    f = [torch.from_numpy(rng.standard_normal(
        (2, c.nxw, c.nzw)).astype(np.float32)) for _ in range(4)]
    img = torch.zeros((2, c.nxl, c.nzl))
    out = d2k.block2_bwd(c, *f, img, 3, 3)
    rows, cols = c.owned
    for o in out[:4]:
        halo = o.clone()
        halo[:, rows, cols] = 0
        assert not halo.any() and o[:, rows, cols].any()
    out2 = d2k.block2_bwd(c, *f, out[4], 3, 3)
    assert torch.equal(out2[4], out[4] + out[4])
    d2k.reset_launches()
    spare = [torch.zeros_like(t) for t in f]
    got = d2k.block2_bwd_cuda(c, *f, img, 3, 3, out=spare)
    assert all(torch.equal(a, b) for a, b in zip(got, out))
    assert d2k.LAUNCHES == {"block2_mod": 0, "block2_fwd": 0, "block2_bwd": 0,
                            "block2_mod_mma": 0, "block2_fwd_mma": 0,
                            "block2_bwd_mma": 0}
    for bad in (spare[:3], [spare[0]] * 4, [f[0]] + spare[1:],
                [spare[0][:, :-1]] + spare[1:]):
        with pytest.raises(ValueError):
            d2k.block2_bwd_cuda(c, *f, img, 3, 3, out=bad)
    with pytest.raises(ValueError, match="do not fit"):
        d2k.block2_fwd_cuda(c, f[0], f[1], wav[:4])
    # an (x, z) tile is not the x tier's: its wrappers refuse it on the card
    with pytest.raises(ValueError, match="block2_bwd"):
        dk._entry(c, "block_bwd")
    # block2_mod records only on the tile that owns gz: zeros elsewhere
    mt = d2k.prepare_tiles(ctx, cpu_mesh(1, 2, 2).grid(0), geom, v2[0],
                           "all", sxs=[18, 34], sz=30, source="gaussian",
                           gz=29)
    assert [t.gz for t in mt] == [-1, 13, -1, 13]
    rec = d2k.block2_mod(mt[0], f[0], f[1], wav[:3])[2]
    assert rec.shape == (2, 3, c.nxl) and not rec.any()


def test_block2_makers_swap_buffers_as_the_kernels_need(monkeypatch):
    """The makers as they run on the card, where a kernel writes only the
    owned cells of the output buffers it is given (the spare set, whose
    halos hold an older exchange): wrappers that do just that on the CPU
    give the plain makers' gathers and images bitwise, so the two-stage
    exchange refills every halo cell, the corners included."""
    _, ctx = _ctxs(nt=21)
    v2, wav, dobs = _inputs(ctx, 5)
    sxs = np.asarray((31, 32), np.int32)
    d_ext = domain.embed_dobs(ctx, dobs)
    mesh = cpu_mesh(1, 2, 2)

    def makers():
        return (d2k.make_sharded_forward_modeling_2d_cuda(
                    ctx, mesh, 27, 28, block_k=3)(v2[0], sxs, wav),
                d2k.make_sharded_rtm_snapshot_2d_cuda(
                    ctx, mesh, 27, 28, block_k=3)(v2, sxs, wav, d_ext))

    want = makers()
    seen = []

    def owned_only(plain, n):
        def run(c, *args, out=None, parts=0):
            assert out is not None and parts == 0
            got = plain(c, *args)
            rows, cols = c.owned
            for o, g in zip(out, got[:n]):
                stale = o.clone()
                stale[:, rows, cols] = 0
                seen.append(bool(stale.any()))
                o[:, rows, cols] = g[:, rows, cols]
            return (*out, *got[n:])
        return run
    monkeypatch.setattr(d2k, "block2_mod_cuda",
                        owned_only(d2k.block2_mod, 2))
    monkeypatch.setattr(d2k, "block2_fwd_cuda",
                        owned_only(d2k.block2_fwd, 2))
    monkeypatch.setattr(d2k, "block2_bwd_cuda",
                        owned_only(d2k.block2_bwd, 4))
    got = makers()
    assert any(seen)            # stale halos were handed out
    for a, b in zip(got, want):
        assert torch.equal(a, b)
