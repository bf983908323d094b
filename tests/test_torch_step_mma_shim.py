"""The split per-step kernels of ``csrc/step_mma.cu``, on the CPU.

``mod_step_mma``, ``rtm_fwd_step_mma`` and ``rtm_bwd_step_mma`` (the x
taps as the banded product in bf16 parts, the fields staged by
``cp.async`` into dynamic shared memory on one tile description,
``StageTile``) run here through the CPU shim (``scripts/cuda_cpu_shim.py``:
a block's threads as ``std::thread``s, ``cp.async`` a copy or a zero fill,
dynamic shared memory filled with NaNs, the tensor-core instruction a
scalar loop in the plain version's order), built once for the module from
``step_mma.cu`` and ``lap_padded.cu``, and are held bitwise against the
plain versions with the same parts (``solver.forward_modeling``,
``solver.fd_forward``, ``solver.fd_back``), which
``tests/test_torch_solver.py`` holds against the JAX package: orders 2, 8
and 16, mxu and mxu6, on two grids whose tails cut every owned shape of the
file along both axes, nt launches of each kernel; and the Gaussian window
across ``mod_step_mma``'s owned-shape edge along x and along z, and the
point source with the top taper. Skips where ``g++`` is missing. On the
card ``chip_smoke.py`` phase 23 holds the kernels to plain.
"""

import importlib.util
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _shim_module():
    spec = importlib.util.spec_from_file_location(
        "cuda_cpu_shim", REPO / "scripts" / "cuda_cpu_shim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """The shim module and its library of ``step_mma.cu``, built within
    150 s."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU shim cannot be built")
    mod = _shim_module()
    lib = mod.load(mod.build(tmp_path_factory.mktemp("shim_step_mma"),
                             ("step_mma.cu",), timeout=150))
    return mod, lib


def _check(res):
    assert res["equal"], f"{res['label']}: max abs diff {res['diff']:.3e}"
    assert res["launches"] == res["want"], res["label"]


@pytest.mark.parametrize("grid", [0, 1])
@pytest.mark.parametrize("lap_impl", ["mxu", "mxu6"])
@pytest.mark.parametrize("order", [2, 8, 16])
def test_step_mma_bitwise_through_the_cpu_shim(shim, order, lap_impl, grid):
    mod, lib = shim
    _check(mod.step_mma_case(lib, order, lap_impl, mod.STEP_MMA_GRIDS[grid]))


@pytest.mark.parametrize("edge", ["x", "z"])
def test_gaussian_window_across_an_owned_shape_edge(shim, edge):
    """The window's cells lie in two blocks of ``mod_step_mma``: each
    block adds its own cells' patch values, loaded before the stage
    completes."""
    mod, lib = shim
    tx, tz = mod.owned_shapes()["mod_step_mma"]
    res = mod.step_mma_case(lib, 8, "mxu", mod.STEP_MMA_GRIDS[1], edge=edge)
    r = 3   # the 7 x 7 Gaussian patch
    if edge == "x":
        assert "shots at x (%d, %d)" % (tx - 2, tx + 1) in res["label"]
        assert tx - 2 - r < tx <= tx + 1 + r
    else:
        assert f"z {tz - 1}" in res["label"]
        assert tz - 1 - r < tz <= tz - 1 + r
    _check(res)


def test_point_source_top_taper_through_the_cpu_shim(shim):
    mod, lib = shim
    _check(mod.step_mma_case(lib, 8, "mxu6", mod.STEP_MMA_GRIDS[1],
                             source="point", taper="top"))


def test_owned_shapes_are_cut_by_both_grids(shim):
    """Each grid leaves a partial block of every kernel's owned shape along
    both axes, so that the tail lanes (no loads past the grid) and the
    zero-filled halo run."""
    mod, _ = shim
    shapes = mod.owned_shapes()
    assert set(shapes) == {"mod_step_mma", "rtm_fwd_step_mma",
                           "rtm_bwd_step_mma"}
    for nx, nz in mod.STEP_MMA_GRIDS:
        nxe, nze = nx + 2 * 9, nz + 2 * 7
        for tx, tz in shapes.values():
            assert nxe % tx and nze % tz, (nxe, nze, tx, tz)
