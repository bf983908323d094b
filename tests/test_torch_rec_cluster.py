"""The cluster-resident route of rtm_main's exact backward, on the CPU.

``rec_bwd_cluster`` runs all nt steps of the receiver-mode step
(``backward_recorded_cuda``: the interior frames; ``backward_image_cuda``
and the second pass of ``rtm_full_cuda``: the image, the frames correlated
with the source wavefield read back in reverse) in one launch where a shot
fits a thread-block cluster (``mod_loop`` with the injection row,
``csrc/cluster_loop.cuh``). Here it runs through the CPU shim
(``scripts/cuda_cpu_shim.py``: a cluster's CTAs as threads,
``cluster.sync()`` a barrier, ``map_shared_rank`` into the sibling CTA's
NaN-filled shared memory), built once for the module from
``MOD_SOURCES``, and is held bitwise against ``solver.backward_recorded``
(the frames and the returned pair) and against its frames' correlation
summed in time order (the image), which ``tests/test_torch_rtm_main.py``
holds against the JAX package: orders 4, 8 and 16 on clusters of 8, 4 and
2 CTAs, nt of both parities, both ``x_off_quirk`` settings with nxb !=
nzb (the quirk's row clamped into the grid), ``next_shot_first`` != 0,
the receiver row crossing every slab. The per-step route forced beside
it, ``rtm_full_cuda`` end to end against ``solver.rtm_shot_full`` and the
JAX package's lax ``rtm_shot_full``, with the launches the wrapper counts
from the route the entry point reports; a cluster launch the device
refuses raises. Skips where ``g++`` is missing. On the card
``chip_smoke.py`` and the ``cuda``-marked test below hold both routes to
plain.
"""

import ctypes
import dataclasses
import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk)

REPO = pathlib.Path(__file__).resolve().parents[1]
NXT = (0.25, -0.5)          # next_shot_first per shot


def _shim_module():
    spec = importlib.util.spec_from_file_location(
        "cuda_cpu_shim", REPO / "scripts" / "cuda_cpu_shim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The shim module and its library of the modeling and rtm_main
    sources, built within 150 s."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU shim cannot be built")
    mod = _shim_module()
    lib = mod.load(mod.build(tmp_path_factory.mktemp("shim_rec"),
                             mod.MOD_SOURCES, timeout=150))
    return mod, lib


def _check(res):
    assert res["plan"] is not None, res["label"]
    assert res["equal"], f"{res['label']}: max abs diff {res['diff']:.3e}"
    assert res["launches"] == res["want"], res["label"]


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("nt", [8, 9])
@pytest.mark.parametrize("image", [False, True], ids=["frames", "image"])
@pytest.mark.parametrize("order", [4, 8, 16])
def test_resident_receiver_route_bitwise_through_the_cpu_shim(
        shim, order, image, nt, quirk):
    mod, lib = shim
    res = mod.rec_bwd_case(lib, order, image, nt, quirk)
    _check(res)
    assert res["plan"].cluster == {4: 8, 8: 4, 16: 2}[order]


def test_receiver_row_crosses_every_slab(shim):
    """On the cases' grid the receiver row without the quirk (at nxb)
    reaches every slab of every cluster size the cases take; the quirk's
    row (at nzb > 2 * nxb) is clamped into the grid, to its last x row."""
    mod, _ = shim
    nx, nz, nxb, nzb = mod.REC_GRID
    ctx = solver.FDContext.create(nx, nz, 8, dx=10.0, dz=10.0, dt=0.001,
                                  nxb=nxb, nzb=nzb)
    assert nzb > 2 * nxb
    assert solver.receiver_offset(ctx, True) == ctx.nxe - nx
    x0 = solver.receiver_offset(ctx, False)
    assert x0 == nxb
    for cs in (8, 4, 2):
        starts = [k * (ctx.nxe // cs) + min(k, ctx.nxe % cs)
                  for k in range(cs)] + [ctx.nxe]
        assert all(x0 < b and x0 + nx > a
                   for a, b in zip(starts, starts[1:]))


@pytest.mark.parametrize("image", [False, True], ids=["frames", "image"])
def test_per_step_receiver_route_forced_through_the_cpu_shim(shim, image):
    """``per_step=True`` runs ``rec_bwd_step``, nt launches, bitwise the
    plain version and so the resident route."""
    mod, lib = shim
    _check(mod.rec_bwd_case(lib, 8, image, 9, per_step=True))


def test_refused_receiver_cluster_launch_raises(shim):
    """No fallback: where the device holds no cluster of the plan, the
    entry point returns the launch's error and the wrapper raises; nothing
    is counted."""
    mod, lib = shim
    refused = ctypes.c_int.in_dll(lib, "pfdc_shim_clusters")
    refused.value = 0
    try:
        with pytest.raises(RuntimeError, match="rec_bwd_cluster"):
            mod.rec_bwd_case(lib, 8, True, 8)
    finally:
        refused.value = 1
    assert not any(fk.LAUNCHES.values())


def _rtm_inputs(mod, order, seed):
    nx, nz, nxb, nzb = mod.REC_GRID
    rng = np.random.default_rng(seed)
    ctx = solver.FDContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7,
                                  exact_taper=False)
    v2 = ((1500.0 + 500.0 * rng.random((ctx.nxe, ctx.nze))).astype(
        np.float32)) ** 2
    wav = np.float32(rng.standard_normal(ctx.nt))
    dobs = rng.standard_normal((2, ctx.nx, ctx.nt)).astype(np.float32)
    return ctx, v2, wav, dobs, (nxb + 5, ctx.nxe - 4), nzb + 1, nzb + 2


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("order", [4, 8, 16])
def test_rtm_full_resident_through_the_cpu_shim(shim, order, quirk):
    """rtm_main's two passes on the resident route, ``rec_fwd_cluster``
    then ``rec_bwd_cluster``, one launch each: the image bitwise the forced
    per-step backward's from the same source frames, and within 1e-5 of
    max of the plain ``rtm_shot_full`` (which sums the image in another
    order)."""
    mod, lib = shim
    ctx, v2, wav, dobs, sxs, sz, gz = _rtm_inputs(mod, order, 7)
    tv2, td = torch.from_numpy(v2), torch.from_numpy(dobs)
    want = solver.rtm_shot_full(ctx, tv2, wav, td, sxs, sz, gz,
                                x_off_quirk=quirk, next_shot_first=NXT)
    swf = solver.forward_modeling(ctx, tv2, wav, sxs, sz, gz, source="point",
                                  taper="top", record="wavefield")[2]
    with mod.emulated(lib):
        fk.reset_launches()
        got = fk.rtm_full_cuda(ctx, tv2, wav, td, sxs, sz, gz,
                               x_off_quirk=quirk, next_shot_first=NXT)
        launches = {k: v for k, v in fk.LAUNCHES.items() if v}
        step = fk._rec_bwd(ctx, tv2, td, gz, quirk, NXT, 0, swf=swf,
                           per_step=True)
    assert launches == {"rec_fwd_cluster": 1, "rec_bwd_cluster": 1}
    assert torch.equal(got, step)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_rtm_full_resident_against_the_jax_package(shim):
    """The resident ``rtm_full_cuda`` through the shim against the JAX
    package's lax ``rtm_shot_full``, shot by shot, the same inputs,
    ``max|port - jax| <= 1e-5 * max(1, max|jax|)`` as
    ``tests/test_torch_rtm_main.py`` holds the plain version."""
    import jax.numpy as jnp
    from parallel_finite_difference_computation_tpu.solver import (
        FDContext as JaxContext, rtm_shot_full as j_rtm_shot_full)
    from parallel_finite_difference_computation_tpu_torch.convert import (
        context_from_arrays)
    mod, lib = shim
    _, v2, wav, dobs, sxs, sz, gz = _rtm_inputs(mod, 8, 9)
    nx, nz, nxb, nzb = mod.REC_GRID
    jctx = JaxContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001, order=8,
                             nxb=nxb, nzb=nzb, fac=0.7, exact_taper=False)
    ctx = context_from_arrays(**{f.name: getattr(jctx, f.name)
                                 for f in dataclasses.fields(jctx)})
    with mod.emulated(lib):
        fk.reset_launches()
        got = fk.rtm_full_cuda(ctx, torch.from_numpy(v2), wav,
                               torch.from_numpy(dobs), sxs, sz, gz,
                               next_shot_first=NXT)
    assert fk.LAUNCHES["rec_bwd_cluster"] == 1
    for s, sx in enumerate(sxs):
        ref = np.asarray(j_rtm_shot_full(
            jctx, jnp.asarray(v2), jnp.asarray(wav), jnp.asarray(dobs[s]),
            sx, sz, gz, next_shot_first=NXT[s]))
        assert np.abs(got[s].numpy() - ref).max() <= 1e-5 * max(
            1.0, np.abs(ref).max())


@pytest.mark.parametrize("image", [False, True], ids=["frames", "image"])
def test_private_per_step_keyword_keeps_the_plain_path_on_the_cpu(image):
    """On CPU tensors both routes of ``_rec_bwd`` are the plain version,
    and count no launch."""
    rng = np.random.default_rng(6)
    ctx = solver.FDContext.create(14, 10, 7, dx=10.0, dz=10.0, dt=0.001,
                                  order=8, nxb=6, nzb=4, fac=0.7,
                                  exact_taper=False)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, ctx.nt)).astype(np.float32))
    swf = (torch.from_numpy(rng.standard_normal(
        (2, ctx.nt, ctx.nx, ctx.nz)).astype(np.float32)) if image else None)
    want = (solver.backward_image(ctx, v2, swf, dobs, 5, next_shot_first=NXT)
            if image else solver.backward_recorded(ctx, v2, dobs, 5,
                                                   next_shot_first=NXT))
    want = want if isinstance(want, tuple) else (want,)
    fk.reset_launches()
    for per_step in (False, True):
        got = fk._rec_bwd(ctx, v2, dobs, 5, True, NXT, None, swf=swf,
                          per_step=per_step)
        got = got if isinstance(got, tuple) else (got,)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(fk.LAUNCHES.values())


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("image", [False, True], ids=["frames", "image"])
@pytest.mark.parametrize("order", [2, 4, 8, 10, 16])
@pytest.mark.parametrize("grid", [(22, 10, 2, 8, 9), (151, 151, 40, 40, 10)])
def test_both_receiver_routes_bitwise_on_the_card(cuda_device, grid, order,
                                                  image):
    """Both routes of rtm_main's exact backward against the plain version
    on the card, bitwise, 2 shots, ``next_shot_first`` != 0, with launch
    counts: the shim's grid (nt 9, the quirk's row clamped) and the 3lay
    one (nt 10); the frames and the returned pair, or the image from
    random source frames against the plain frames' correlation summed in
    time order."""
    nx, nz, nxb, nzb, nt = grid
    rng = np.random.default_rng(order)
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7,
                                  exact_taper=False)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(cuda_device)
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, nt)).astype(np.float32)).to(cuda_device)
    gz = nzb + 1
    want = solver.backward_recorded(ctx, v2, dobs, gz, next_shot_first=NXT)
    swf = None
    if image:
        swf = torch.randn((2, nt, ctx.nx, ctx.nz), device=cuda_device,
                          generator=torch.Generator(
                              device=cuda_device).manual_seed(order))
        img = torch.zeros((2, ctx.nx, ctx.nz), device=cuda_device)
        for it in range(nt):
            img = img + swf[:, nt - 1 - it] * want[2][:, it]
        want = (img,)
    assert fk.resident_plan(ctx.nxe, ctx.nze, order) is not None
    for per_step in (False, True):
        fk.reset_launches()
        got = fk._rec_bwd(ctx, v2, dobs, gz, True, NXT, 0, swf=swf,
                          per_step=per_step)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert {k: v for k, v in fk.LAUNCHES.items() if v} == (
            {"rec_bwd_step": nt} if per_step else {"rec_bwd_cluster": 1})
