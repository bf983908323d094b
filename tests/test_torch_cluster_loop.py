"""The cluster-resident route of the exact two-snapshot RTM, on the CPU.

* The route rule (``cluster_plan``, ``csrc/cluster_loop.cuh``), as the
  CPU shim's build of the entry points reports it (``pfdc_cluster_plan``),
  against the constants of the C source, read as
  ``tests/test_torch_tiled.py`` reads the launchers: the 3lay shots (231 x
  231 extended) take the resident route at orders 4-16 on clusters of 16,
  1lay's too, Pluto's (7040 x 1281), new_mod's, marmousi's and spluto's
  the per-step kernels, and every slab of every plan holds at least H
  rows, its threads one strip each.
* ``rtm_fwd_cluster`` and ``rtm_bwd_cluster`` through the CPU shim
  (``scripts/cuda_cpu_shim.py --cluster --quick``: a cluster's CTAs as
  threads, ``cluster.sync()`` a barrier, ``map_shared_rank`` into the
  sibling CTA's NaN-filled shared memory), bitwise against the plain
  versions, which ``tests/test_torch_solver.py`` holds against the JAX
  package; the per-step route forced beside them, with the launches the
  wrappers count from the route the entry points report. Skips where
  ``g++`` is missing. On the card ``chip_smoke.py`` holds both routes to
  plain.
"""

import ast
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu_torch import solver
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "parallel_finite_difference_computation_tpu_torch" / "csrc"
ORDERS = [4, 6, 8, 10, 12, 14, 16]


def _constants():
    """The route rule's constants, from the C source."""
    src = (CSRC / "cluster_loop.cuh").read_text()
    const = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (kCluster\w+) = (\d+);", src)}
    const["kMaxSmemBytes"] = int(re.search(
        r"constexpr int kMaxSmemBytes = (\d+);",
        (CSRC / "kstep.cuh").read_text())[1])
    return const


def _slabs(nxe: int, cs: int):
    """The rows of each slab, as make_slab splits nxe."""
    return [nxe // cs + (r < nxe % cs) for r in range(cs)]


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """One run of the CPU shim's ``--cluster --quick`` mode, its own limit
    120 s with the build: its output lines and the route rule's plans,
    {(nxe, nze, order): ResidentPlan or None}."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU shim cannot be built")
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "cuda_cpu_shim.py"),
         "--cluster", "--quick", "--build-dir",
         str(tmp_path_factory.mktemp("shim"))],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    lines = out.stdout.splitlines()
    plans = next((ast.literal_eval(line.removeprefix("plans: "))
                  for line in lines if line.startswith("plans: ")), [])
    return out, lines, {
        (nxe, nze, order): fk.ResidentPlan(*p) if p[0] else None
        for nxe, nze, order, *p in plans}


def test_route_rule_mirrors_the_c_source(shim):
    """Every plan the C rule gives: slabs of at least H rows that cover
    nxe, one strip of kClusterRows x kClusterCols cells a thread within
    kClusterThreads, the backward's kClusterLevels levels (H halo rows on
    each side, rows of nze and kClusterZPad zeros on each side rounded up
    to 4 floats) within a CTA's shared memory, the forward's half that;
    refused orders and shots too large for any cluster take the per-step
    route."""
    const = _constants()
    plans = shim[2]
    assert len(plans) > 500
    resident = 0
    for (nxe, nze, order), plan in plans.items():
        h = order // 2
        if order % 2 or order > 16 or nxe < 2 * h:
            assert plan is None, (nxe, nze, order)
        if plan is None:
            continue
        resident += 1
        slabs = _slabs(nxe, plan.cluster)
        assert sum(slabs) == nxe and min(slabs) >= h
        assert max(slabs) == plan.rows
        strips = (-(-plan.rows // const["kClusterRows"])
                  * -(-nze // const["kClusterCols"]))
        assert plan.threads % 32 == 0
        assert strips <= plan.threads < strips + 32
        assert plan.threads <= const["kClusterThreads"]
        pitch = -(-(nze + 2 * const["kClusterZPad"]) // 4) * 4
        assert plan.bwd_bytes == (4 * const["kClusterLevels"]
                                  * (plan.rows + 2 * h) * pitch)
        assert plan.bwd_bytes <= const["kMaxSmemBytes"] == fk.SMEM_BYTES
        assert plan.fwd_bytes * 2 == plan.bwd_bytes
    assert resident > 100
    assert {"rtm_fwd_cluster", "rtm_bwd_cluster"} <= set(fk.LAUNCHES)


@pytest.mark.parametrize("order", ORDERS)
def test_3lay_takes_the_resident_route(shim, order):
    """3lay (151 x 151, borders of 40): one cluster of 16 CTAs a shot, one
    strip of 4 x 2 cells a thread, the four backward levels inside a CTA's
    shared memory."""
    plan = shim[2][231, 231, order]
    assert plan is not None and plan.cluster == 16
    assert min(_slabs(231, 16)) >= order // 2 and plan.rows == 15
    assert plan.threads == 480      # 4 x 116 strips
    assert plan.bwd_bytes == 4 * 4 * (15 + order) * 248 <= fk.SMEM_BYTES
    assert plan.fwd_bytes * 2 == plan.bwd_bytes


@pytest.mark.parametrize("order", [2, 8, 16])
def test_pluto_takes_the_per_step_route(shim, order):
    assert shim[2][7040, 1281, order] is None


@pytest.mark.parametrize("shape, cluster", [
    ((281, 181), 16),              # 1lay: 18 rows a CTA, 455 strips
    ((256, 256), 16),              # the last square 3lay-like shot
    ((260, 260), 0),               # past it: 650 strips a CTA
    ((395, 275), 0),               # new_mod
    ((449, 455), 0),               # marmousi
    ((447, 431), 0)])              # spluto
def test_zoo_shapes_route(shim, shape, cluster):
    plan = shim[2][(*shape, 8)]
    assert (plan.cluster if plan else 0) == cluster, plan


def test_every_slab_holds_h_rows(shim):
    """The plans of the sweep hold H rows a slab at every order, and a shot
    of fewer than 2H rows is refused."""
    plans = shim[2]
    for (nxe, nze, order), plan in plans.items():
        if plan is not None:
            assert min(_slabs(nxe, plan.cluster)) >= order // 2
    assert plans[231, 231, 18] is None and plans[231, 231, 7] is None
    assert plans[5, 231, 2] is not None and plans[5, 231, 6] is None


def test_private_per_step_keyword_keeps_the_plain_path_on_the_cpu():
    """On CPU tensors both routes of the private wrappers are the plain
    versions, and count no launch."""
    rng = np.random.default_rng(2)
    ctx = solver.FDContext.create(14, 10, 6, dx=10.0, dz=10.0, dt=0.001,
                                  order=8, nxb=6, nzb=6, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    wav = np.float32(rng.standard_normal(ctx.nt))
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, ctx.nt)).astype(np.float32))
    fk.reset_launches()
    want = solver.fd_forward(ctx, v2, wav, (7, 12), 7)
    for per_step in (False, True):
        got = fk._fd_forward(ctx, v2, wav, (7, 12), 7, 0, per_step=per_step)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        img = fk._fd_back(ctx, v2, *want, dobs, 2, 0, per_step=per_step)
        assert torch.equal(img, solver.fd_back(ctx, v2, *want, dobs, 2))
    assert not any(fk.LAUNCHES.values())


def test_cluster_kernels_bitwise_through_the_cpu_shim(shim):
    """The resident kernels on a 26 x 22 grid (order 4: clusters of 8
    CTAs, slabs of 4 and 3 rows; order 8: of 4, slabs of 7 and 6 rows) and
    the per-step ones, 2 shots, nt 8 and 9, bitwise their plain versions,
    one launch a resident pass; at most 120 s with the build."""
    out, lines, _ = shim
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert lines[-1] == "0 mismatches"
    assert sum(line.startswith("ok  rtm_fwd resident order") for line in
               lines) == 4
    assert sum(line.startswith("ok  rtm_bwd per-step order") for line in
               lines) == 4
    assert any("(cluster 4)" in line for line in lines)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 4, 8, 10, 16])
@pytest.mark.parametrize("grid", [(14, 10, 6, 6), (151, 151, 40, 40)])
def test_both_routes_bitwise_on_the_card(cuda_device, order, grid):
    """Both routes of the exact two-snapshot RTM against the plain versions
    on the card, bitwise, 2 shots, nt = 9, with launch counts: a small grid
    and the 3lay one."""
    nx, nz, nxb, nzb = grid
    rng = np.random.default_rng(order)
    ctx = solver.FDContext.create(nx, nz, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=nxb, nzb=nzb, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(cuda_device)
    wav = np.float32(rng.standard_normal(ctx.nt))
    dobs = torch.from_numpy(rng.standard_normal(
        (2, ctx.nx, ctx.nt)).astype(np.float32)).to(cuda_device)
    sxs, sz, gz = (nxb + 1, ctx.nxe - nxb - 2), nzb + 1, 2
    want = solver.fd_forward(ctx, v2, wav, sxs, sz)
    want_img = solver.fd_back(ctx, v2, *want, dobs, gz)
    for per_step in (False, True):
        fk.reset_launches()
        got = fk._fd_forward(ctx, v2, wav, sxs, sz, 0, per_step=per_step)
        img = fk._fd_back(ctx, v2, *want, dobs, gz, 0, per_step=per_step)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(img, want_img)
        counts = {k: v for k, v in fk.LAUNCHES.items() if v}
        assert counts == ({"rtm_fwd_step": 9, "rtm_bwd_step": 9} if per_step
                          else {"rtm_fwd_cluster": 1, "rtm_bwd_cluster": 1})
