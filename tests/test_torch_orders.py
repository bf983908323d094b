"""Orders above 10 and the source window at the grid's edge, on the CPU.

* The JAX package takes every even order; so does the port on the CPU,
  where its wrappers run the plain versions before any check of the
  kernels' limits. ``run_modeling``, ``run_rtm_gpu`` and ``run_rtm_cpu``
  with ``device="cpu"`` at orders 12 and 16, and ``laplacian_cuda`` on a
  CPU tensor, against the JAX lax path (tolerance: ``1e-5`` relative, the
  JAX package's contract between its tiers; the Laplacian bitwise, as
  ``tests/test_torch_stencil_program.py`` holds it at orders 2-10).
* The Gaussian source's 7 x 7 window must lie inside the extended grid:
  ``run_modeling`` raises with a border of 2 at the source, where the JAX
  package shifts the patch instead."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.models import layered_model
from parallel_finite_difference_computation_tpu.ops.stencil import (
    laplacian as j_laplacian)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import (
    io as tio, numerics as tnum, pipeline as tpipe)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stream)

GATE = 1e-5
CFG = dict(nz=24, nx=28, nt=11, dz=10.0, dx=10.0, dt=0.001, fpeak=25.0,
           ns=2, sz=4, fsx=6, ds=10, gz=1, nxb=8, nzb=8, fac=0.7)


def assert_close(got, want):
    """``max|got - want| <= 1e-5 * max|want|``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GATE * np.abs(want).max()


@pytest.mark.parametrize("order", [12, 16])
def test_pipelines_match_jax_above_order_10(tmp_path, order):
    jp, tp = jpk.Params(order=order, **CFG), tpk.Params(order=order, **CFG)
    vp = layered_model(tp.nx, tp.nz)
    base = np.zeros((tp.nxe, tp.nze), np.float32)
    base[tp.nxb:tp.nxb + tp.nx, tp.nzb:tp.nzb + tp.nz] = vp
    tio.write_f32(str(tmp_path / "vel_ext.bin"), np.stack([
        tnum.extendvel_random(base, tp.nx, tp.nz, tp.nxb, tp.nzb, seed=3 + i)
        for i in range(tp.ns)]))
    jp.vel_ext_file = tp.vel_ext_file = str(tmp_path / "vel_ext.bin")
    jd = jpipe.run_modeling(jp, vp=vp, backend="lax")
    for backend in ("pallas", "tiled"):
        td = tpipe.run_modeling(tp, vp=vp, device="cpu", backend=backend)
        assert_close(td, jd)
        timg, tlocs = tpipe.run_rtm_gpu(tp, vp=vp, dobs=jd, device="cpu",
                                        backend=backend)
        jimg, jlocs = jpipe.run_rtm_gpu(jp, vp=vp, dobs=jd, backend="lax")
        assert_close(timg, jimg)
        assert_close(tlocs, jlocs)
        cimg, clocs = tpipe.run_rtm_cpu(tp, vp=vp, dobs=jd, device="cpu",
                                        backend=backend)
        jcimg, jclocs = jpipe.run_rtm_cpu(jp, vp=vp, dobs=jd, backend="lax")
        assert_close(cimg, jcimg)
        assert_close(clocs, jclocs)


@pytest.mark.parametrize("order", [12, 14, 16])
def test_laplacian_cuda_on_a_cpu_tensor_above_order_10(order):
    rng = np.random.default_rng(order)
    f = rng.standard_normal((61, 47)).astype(np.float32)
    cx, cz = jnum.scaled_coefficients(order, 10.0, 12.5)
    got = fk.laplacian_cuda(torch.from_numpy(f), cx, cz, order)
    want = np.asarray(j_laplacian(jnp.asarray(f), jnp.asarray(cx),
                                  jnp.asarray(cz), order))
    np.testing.assert_array_equal(got.numpy(), want)
    assert fk.LAUNCHES["lap_apply"] == 0


def test_odd_orders_raise_on_every_device():
    f = torch.zeros((30, 30))
    cx, cz = tnum.scaled_coefficients(8, 10.0, 10.0)
    with pytest.raises(ValueError, match="even"):
        fk.laplacian_cuda(f, cx, cz, 7)
    with pytest.raises(ValueError, match="even"):
        fk._check_order(0, on_cuda=False)
    fk._check_order(fk.MAX_ORDER + 2, on_cuda=False)
    with pytest.raises(ValueError, match=str(fk.MAX_ORDER)):
        fk._check_order(fk.MAX_ORDER + 2, on_cuda=True)


def test_refused_tile_names_the_shared_memory_limit():
    fk._raise_on(0, "kstep_mod", 16, 8)
    with pytest.raises(ValueError, match=f"{fk.SMEM_BYTES} bytes"):
        fk._raise_on(1, "kstep_gpu_bwd", 16, 4)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fk._raise_on(700, "kstep_gpu_bwd", 16, 4)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fk._raise_on(1, "fd_step")
    assert stream.MAX_STEPS == 8


@pytest.mark.parametrize("border", ["nxb", "nzb"])
def test_source_window_at_the_grid_edge_raises(border):
    """A border of 2 with the source on the grid's first row (``fsx=0``) or
    column (``sz=0``) puts the Gaussian window outside the extended grid;
    ``run_modeling`` raises, whatever the tier."""
    cfg = dict(CFG, order=4, fsx=0, sz=0, **{border: 2})
    p = tpk.Params(**cfg)
    vp = layered_model(p.nx, p.nz)
    for backend in ("pallas", "tiled"):
        with pytest.raises(ValueError, match="source window"):
            tpipe.run_modeling(p, vp=vp, device="cpu", backend=backend)
    ok = tpk.Params(**dict(cfg, **{border: 3}))
    assert np.isfinite(tpipe.run_modeling(ok, vp=vp, device="cpu")).all()
