"""The stencil program of the port against the JAX package: ``run_stencil``
and the ``stencil`` CLI command against theirs, and ``laplacian_cuda``'s
plain route against ``laplacian_pallas`` in interpret mode (the Pallas
kernel that ``lap_apply`` replaces) and the lax Laplacian, at orders 2-10
on shapes that are not multiples of 128.

Tolerance: ``max|port - jax| <= 1e-5 * max(1, max|jax|)``. Each tap sum
runs in the same order in both packages; XLA on the CPU contracts some
multiply-adds, so they may differ by an ulp."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_finite_difference_computation_tpu as jpk
from parallel_finite_difference_computation_tpu import cli as jcli
from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu import pipeline as jpipe
from parallel_finite_difference_computation_tpu.ops.pallas_stencil import (
    laplacian_pallas)
from parallel_finite_difference_computation_tpu.ops.stencil import (
    laplacian as j_laplacian)

import parallel_finite_difference_computation_tpu_torch as tpk
from parallel_finite_difference_computation_tpu_torch import cli as tcli
from parallel_finite_difference_computation_tpu_torch import (
    io as tio, pipeline as tpipe)
from parallel_finite_difference_computation_tpu_torch.ops import (
    fd_kernels as fk, stencil as tstencil)

GATE = 1e-5
# the stencil program keeps its data path in tmpdir (fd-source-code.cu:43-50)
CFG = dict(nz=111, nx=29, nt=1, dz=12.5, dx=10.0, dt=0.001, fpeak=25.0,
           ns=1, sz=0, fsx=0, ds=0, gz=0, nxb=8, nzb=8, order=8)


def assert_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GATE * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("order", [2, 4, 6, 8, 10])
@pytest.mark.parametrize("shape", [(45, 139), (130, 257)])
def test_laplacian_cuda_plain_route_vs_pallas_interpret(order, shape):
    rng = np.random.default_rng(order + shape[0])
    f = rng.standard_normal(shape).astype(np.float32)
    cx, cz = jnum.scaled_coefficients(order, 10.0, 12.5)
    got = fk.laplacian_cuda(torch.from_numpy(f), cx, cz, order)
    h = order // 2
    assert not got[:h].any() and not got[-h:].any()
    assert not got[:, :h].any() and not got[:, -h:].any()
    np.testing.assert_array_equal(
        got.numpy(), tstencil.laplacian(torch.from_numpy(f), cx, cz,
                                        order).numpy())
    assert_close(got, laplacian_pallas(jnp.asarray(f), cx, cz, order,
                                       interpret=True))
    assert_close(got, j_laplacian(jnp.asarray(f), jnp.asarray(cx),
                                  jnp.asarray(cz), order))


@pytest.mark.parametrize("bad", ["order", "dims", "dtype", "coefs", "small"])
def test_laplacian_cuda_raises_on_bad_inputs(bad):
    order = 8
    f = torch.zeros((40, 50))
    cx, cz = jnum.scaled_coefficients(order, 10.0, 10.0)
    if bad == "order":
        order = 7
    elif bad == "dims":
        f = f[None]
    elif bad == "dtype":
        f = f.double()
    elif bad == "coefs":
        cx = cx[:-1]
    else:
        f = f[:8]
    fk.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        fk.laplacian_cuda(f, cx, cz, order)
    assert fk.LAUNCHES["lap_apply"] == 0


def _field(tmp_path, p, seed=0):
    path = tmp_path / "field.bin"
    tio.write_f32(str(path), np.random.default_rng(seed).standard_normal(
        (p.nxe, p.nze)).astype(np.float32))
    return str(path)


@pytest.mark.parametrize("order", [4, 8, 10])
def test_run_stencil_matches_jax(tmp_path, order):
    jp = jpk.Params(**dict(CFG, order=order))
    tp = tpk.Params(**dict(CFG, order=order))
    path = _field(tmp_path, tp, seed=order)
    want = jpipe.run_stencil(jp, input_path=path,
                             output_path=str(tmp_path / "j.bin"),
                             backend="lax")
    got = tpipe.run_stencil(tp, input_path=path,
                            output_path=str(tmp_path / "t.bin"), device="cpu")
    assert got.shape == (tp.nxe, tp.nze) and got.dtype == np.float32
    assert_close(got, want)
    assert (tmp_path / "t.bin").read_bytes() == got.tobytes()
    # without input_path, the data path is tmpdir
    tp.tmpdir = path
    np.testing.assert_array_equal(tpipe.run_stencil(tp, device="cpu"), got)


def test_cli_stencil_matches_jax(tmp_path, capsys):
    p = tpk.Params(**CFG)
    path = _field(tmp_path, p)
    cfg = tmp_path / "input.dat"
    cfg.write_text("".join(f"{k}={v}\n" for k, v in CFG.items())
                   + f"tmpdir={path}\n")
    jcli.main(["stencil", str(cfg), "--output", str(tmp_path / "j.bin"),
               "--backend", "lax"])
    tcli.main(["stencil", f"par={cfg}", "--output", str(tmp_path / "t.bin"),
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"Laplacian ({p.nxe}, {p.nze}) written to" in out
    assert_close(tio.read_f32(str(tmp_path / "t.bin")),
                 tio.read_f32(str(tmp_path / "j.bin")))
    assert os.path.getsize(tmp_path / "t.bin") == p.nxe * p.nze * 4


@pytest.mark.parametrize("entry", ["run_stencil", "cli_stencil"])
def test_stencil_defaults_to_cuda(entry, tmp_path):
    """With no device, the stencil goes to the card: without CUDA it raises
    torch's own error and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default call would run")
    p = tpk.Params(**CFG)
    path = _field(tmp_path, p)
    out = tmp_path / "out.bin"
    if entry == "run_stencil":
        call = lambda: tpipe.run_stencil(p, input_path=path,
                                         output_path=str(out))
    else:
        cfg = tmp_path / "input.dat"
        cfg.write_text("".join(f"{k}={v}\n" for k, v in CFG.items())
                       + f"tmpdir={path}\n")
        call = lambda: tcli.main(["stencil", str(cfg), "--output", str(out)])
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
        call()
    assert not out.exists()
