"""The cluster-resident route of the exact modeling kernels, on the CPU.

``mod_cluster`` (the trace row, or nothing) and ``rec_fwd_cluster`` (the
interior frames) run all nt steps of ``forward_modeling_cuda`` in one
launch where a shot fits a thread-block cluster (``mod_loop``,
``csrc/cluster_loop.cuh``). Here they run through the CPU shim
(``scripts/cuda_cpu_shim.py``: a cluster's CTAs as threads,
``cluster.sync()`` a barrier, ``map_shared_rank`` into the sibling CTA's
NaN-filled shared memory), built once for the module from
``MOD_SOURCES``, and are held bitwise against ``solver.forward_modeling``,
which ``tests/test_torch_solver.py`` and ``tests/test_torch_rtm_main.py``
hold against the JAX package: both sources and both tapers, the three
record modes, nt of both parities (the final pair in either buffer),
orders 4, 8 and 16 on clusters of 8, 4 and 2 CTAs, the Gaussian window
across a slab edge, the trace row through every slab. The per-step route
forced beside them, and ``rtm_full_cuda`` (``rec_fwd_cluster`` then
``rec_bwd_cluster``; ``tests/test_torch_rec_cluster.py`` holds the
backward's resident route), with the launches the wrapper counts from the
route the entry point reports; a cluster launch the device refuses raises.
Skips where ``g++`` is missing. On the card ``chip_smoke.py`` holds both
routes to plain.
"""

import ctypes
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
KINDS = [("gaussian", "all"), ("point", "top"), ("gaussian", "top"),
         ("point", "all")]


def _shim_module():
    spec = importlib.util.spec_from_file_location(
        "cuda_cpu_shim", REPO / "scripts" / "cuda_cpu_shim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The shim module and its library of the modeling sources, built
    within 150 s."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU shim cannot be built")
    mod = _shim_module()
    lib = mod.load(mod.build(tmp_path_factory.mktemp("shim_mod"),
                             mod.MOD_SOURCES, timeout=150))
    return mod, lib


def _check(res):
    assert res["plan"] is not None, res["label"]
    assert res["equal"], f"{res['label']}: max abs diff {res['diff']:.3e}"
    assert res["launches"] == res["want"], res["label"]


@pytest.mark.parametrize("nt", [8, 9])
@pytest.mark.parametrize("record", ["trace", "none", "wavefield"])
@pytest.mark.parametrize("source, taper", KINDS)
@pytest.mark.parametrize("order", [4, 8, 16])
def test_resident_route_bitwise_through_the_cpu_shim(shim, order, source,
                                                     taper, record, nt):
    mod, lib = shim
    res = mod.mod_case(lib, order, source, taper, record, nt)
    _check(res)
    assert res["plan"].cluster == {4: 8, 8: 4, 16: 2}[order]


@pytest.mark.parametrize("record", ["trace", "none", "wavefield"])
def test_per_step_route_forced_through_the_cpu_shim(shim, record):
    """``per_step=True`` runs ``mod_step`` or ``rec_fwd_step``, nt
    launches, bitwise the plain version and so the resident route."""
    mod, lib = shim
    _check(mod.mod_case(lib, 8, "gaussian", "all", record, 9,
                        per_step=True))


def test_refused_cluster_launch_raises(shim):
    """No fallback: where the device holds no cluster of the plan, the
    entry point returns the launch's error and the wrapper raises; nothing
    is counted."""
    mod, lib = shim
    refused = ctypes.c_int.in_dll(lib, "pfdc_shim_clusters")
    refused.value = 0
    try:
        with pytest.raises(RuntimeError, match="rec_fwd_cluster"):
            mod.mod_case(lib, 8, "point", "top", "wavefield", 8)
    finally:
        refused.value = 1
    assert not any(fk.LAUNCHES.values())


def test_rtm_full_through_the_cpu_shim(shim):
    """rtm_main's two passes: ``rec_fwd_cluster`` once, then
    ``rec_bwd_cluster`` in image mode once. The image is bitwise the
    backward's from the plain version's frames (the resident frames are
    the plain ones), and within 1e-5 of the plain ``rtm_shot_full`` (the
    backward sums the image in another order: ``chip_smoke.py`` holds it
    to the same gate)."""
    mod, lib = shim
    rng = np.random.default_rng(5)
    nx, nz, nxb, nzb = mod.MOD_GRID
    ctx = solver.FDContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=8, nxb=nxb, nzb=nzb, fac=0.7,
                                  exact_taper=False)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    wav = np.float32(rng.standard_normal(ctx.nt))
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, ctx.nt)).astype(np.float32))
    sxs, sz, gz, nxt = (7, 18), nzb + 1, nzb + 2, (0.25, 0.0)
    swf = solver.forward_modeling(ctx, v2, wav, sxs, sz, gz, source="point",
                                  taper="top", record="wavefield")[2]
    want = solver.rtm_shot_full(ctx, v2, wav, dobs, sxs, sz, gz,
                                next_shot_first=nxt)
    with mod.emulated(lib):
        ref = fk.backward_image_cuda(ctx, v2, swf, dobs, gz,
                                     next_shot_first=nxt)
        fk.reset_launches()
        got = fk.rtm_full_cuda(ctx, v2, wav, dobs, sxs, sz, gz,
                               next_shot_first=nxt)
    assert torch.equal(got, ref)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "rec_fwd_cluster": 1, "rec_bwd_cluster": 1}


def test_private_per_step_keyword_keeps_the_plain_path_on_the_cpu():
    """On CPU tensors both routes of ``_forward_modeling`` are the plain
    version, and count no launch."""
    rng = np.random.default_rng(6)
    ctx = solver.FDContext.create(14, 10, 7, dx=10.0, dz=10.0, dt=0.001,
                                  order=8, nxb=6, nzb=6, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    wav = np.float32(rng.standard_normal(ctx.nt))
    fk.reset_launches()
    for record in ("trace", "wavefield"):
        want = solver.forward_modeling(ctx, v2, wav, (7, 12), 7, 9,
                                       record=record)
        for per_step in (False, True):
            got = fk._forward_modeling(ctx, v2, wav, (7, 12), 7, 9,
                                       "gaussian", "all", record, 0,
                                       per_step=per_step)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(fk.LAUNCHES.values())


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("record", ["trace", "none", "wavefield"])
@pytest.mark.parametrize("order", [2, 4, 8, 10, 16])
@pytest.mark.parametrize("grid", [(14, 10, 6, 6, 9), (151, 151, 40, 40, 10)])
def test_both_routes_bitwise_on_the_card(cuda_device, grid, order, record):
    """Both routes of the exact modeling against the plain version on the
    card, bitwise, 2 shots, with launch counts: a small grid (nt 9) and
    the 3lay one (nt 10); the Gaussian source and the all-edge taper with
    the trace or nothing, the point source and the top taper with the
    frames."""
    nx, nz, nxb, nzb, nt = grid
    rng = np.random.default_rng(order)
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7,
                                  exact_taper=False)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(cuda_device)
    wav = np.float32(rng.standard_normal(ctx.nt))
    source, taper = (("point", "top") if record == "wavefield"
                     else ("gaussian", "all"))
    sxs, sz, gz = (nxb + 1, ctx.nxe - nxb - 2), nzb + 1, nzb + 2
    want = solver.forward_modeling(ctx, v2, wav, sxs, sz, gz, source=source,
                                   taper=taper, record=record)
    names = (("rec_fwd_cluster", "rec_fwd_step") if record == "wavefield"
             else ("mod_cluster", "mod_step"))
    assert fk.resident_plan(ctx.nxe, ctx.nze, order) is not None
    for per_step in (False, True):
        fk.reset_launches()
        got = fk._forward_modeling(ctx, v2, wav, sxs, sz, gz, source, taper,
                                   record, 0, per_step=per_step)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)
                   if b is not None)
        assert (got[2] is None) == (want[2] is None)
        assert {k: v for k, v in fk.LAUNCHES.items() if v} == (
            {names[1]: nt} if per_step else {names[0]: 1})
