"""The stencil program's kernel, ``lap_apply`` of ``csrc/laplacian.cu``, on
the CPU.

``lap_apply`` (a band of output columns a CTA walking down a run of rows,
its input rows staged by ``cp.async`` into a ring in dynamic shared memory,
the x taps in a register window) runs here through the CPU shim
(``scripts/cuda_cpu_shim.py``: a block's threads as ``std::thread``s,
dynamic shared memory filled with NaNs, the output too), built once for the
module from ``laplacian.cu``, and ``laplacian_cuda``'s CUDA branch is held
bitwise against ``stencil.laplacian``, which
``tests/test_torch_stencil_program.py`` holds against the JAX package: at
orders 2, 8 and 16, on grids with nz % 4 = 0, 1, 2, 3 whose tails cut the
band and the run, the field on 16 bytes (16-byte copies from each row's
aligned floor) and one float off them (4-byte copies), on a device of 132
SMs and of 1 (longer runs), with the copies landing as late and as early
as ``cp.async`` allows; and at the smallest field, order + 1 square.
Skips where ``g++`` is missing. On the card ``chip_smoke.py`` phase 7
holds the kernel to plain, bitwise.
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
    """The shim module and its library of ``laplacian.cu``, built within
    150 s."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CPU shim cannot be built")
    mod = _shim_module()
    lib = mod.load(mod.build(tmp_path_factory.mktemp("shim_lap_apply"),
                             mod.STENCIL_SOURCES, timeout=150))
    return mod, lib


def _check(res):
    assert res["equal"], f"{res['label']}: max abs diff {res['diff']:.3e}"
    assert res["launches"] == res["want"], res["label"]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("grid", [0, 1, 2, 3])
@pytest.mark.parametrize("order", [2, 8, 16])
def test_lap_apply_bitwise_through_the_cpu_shim(shim, order, grid, offset):
    mod, lib = shim
    for sms in (132, 1):
        for early in (False, True):
            _check(mod.lap_case(lib, order, mod.LAP_GRIDS[grid], offset, sms,
                                early, seed=grid))


@pytest.mark.parametrize("order", [2, 8, 16])
def test_lap_apply_on_the_smallest_field(shim, order):
    """nx = nz = order + 1: one interior cell, the rest the zero border."""
    mod, lib = shim
    for early in (False, True):
        res = mod.lap_case(lib, order, (order + 1, order + 1), early=early)
        _check(res)
        assert res["shape"].bands == 1


def test_grids_cut_the_band_and_the_run(shim):
    """Each grid leaves a partial band along z and a partial run along x,
    at 132 SMs and at 1, so that the tail lanes and rows run; together
    the grids take every nz % 4."""
    mod, lib = shim
    assert sorted(nz % 4 for _, nz in mod.LAP_GRIDS) == [0, 1, 2, 3]
    runs = set()
    for grid in mod.LAP_GRIDS:
        for sms in (132, 1):
            shape = mod.lap_case(lib, 8, grid, sms=sms)["shape"]
            nx, nz = grid
            assert nz % shape.band and nx % shape.run, (grid, sms, shape)
            assert shape.bands * shape.band >= nz > (shape.bands - 1) * \
                shape.band
            assert shape.runs * shape.run >= nx > (shape.runs - 1) * \
                shape.run
            runs.add(shape.run)
    assert len(runs) > 1      # a longer run than the shortest at 1 SM


def test_launch_shape_of_the_stencil_grids(shim):
    """The run rule at the stencil program's grids on an H100's 132 SMs:
    thousands of CTAs at 8192 x 8192, more than a handful at 415 x 295,
    and a ring of input rows within the 48 KB a block takes without an
    opt-in, at every order."""
    mod, lib = shim
    from parallel_finite_difference_computation_tpu_torch.ops import (
        fd_kernels as fk)
    with mod.emulated(lib):
        big = fk.lap_shape(8192, 8192, 8)
        small = fk.lap_shape(415, 295, 8)
        ring = [fk.lap_shape(8192, 8192, order).smem_bytes
                for order in range(2, 18, 2)]
        with pytest.raises(RuntimeError):
            fk.lap_shape(8192, 8192, 18)
    assert big.bands * big.runs >= 1000 and big.run >= 64
    assert small.bands * small.runs >= 32
    assert max(ring) <= 48 * 1024
