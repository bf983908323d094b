"""The padded-layout stencil (``ops/padded.py``, kernel-table row 7)
against the JAX package's ``laplacian_pallas_padded`` in interpret mode,
both on the CPU: the layout round trip, the exact taps (``impl="vpu"``) and
the split-bf16 z taps (``"mxu"``, ``"mxu6"``), chains of applies, and the
wrapper's checks. Each side's own ``from_padded`` takes the field out of
its own layout (the JAX layout is the TPU's; the port's has no 128-lane
width or tile rows).

Tolerances: the vpu result is bitwise the port's ``stencil.laplacian`` and
within 4 float32 eps of max of the JAX one (XLA on the CPU may contract
multiply-adds); the mxu tiers form the same exact bf16 products as the JAX
kernel and differ only in the order of their float32 sums: within 1e-6 of
max of it (measured <= 1.6e-7), and within the JAX tests' own 2e-5 / 2e-7
of the exact taps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_finite_difference_computation_tpu import numerics as jnum
from parallel_finite_difference_computation_tpu.ops import (
    pallas_stencil as jps, stencil as jst)

from parallel_finite_difference_computation_tpu_torch import numerics
from parallel_finite_difference_computation_tpu_torch.ops import (
    padded, stencil)

EPS = float(np.finfo(np.float32).eps)


def _field(nx, nz, seed=0):
    return np.random.default_rng(seed).standard_normal((nx, nz)).astype(
        np.float32)


def _jax_padded(base, order, tile_rows, impl, dx=10.0, dz=7.5):
    nx, nz = base.shape
    cx, cz = jnum.scaled_coefficients(order, dx, dz)
    out = jps.laplacian_pallas_padded(
        jps.to_padded(jnp.asarray(base), order, tile_rows), cx, cz, order,
        nx, nz, tile_rows, interpret=True, impl=impl)
    return np.asarray(jps.from_padded(out, nx, nz, order, tile_rows))


def _port_padded(base, order, impl, dx=10.0, dz=7.5):
    nx, nz = base.shape
    cx, cz = numerics.scaled_coefficients(order, dx, dz)
    out = padded.laplacian_padded_cuda(
        padded.to_padded(torch.from_numpy(base), order), cx, cz, order, nx,
        nz, impl)
    return out, padded.from_padded(out, nx, nz, order).numpy()


@pytest.mark.parametrize("nx,nz,order", [(256, 256, 8), (151, 151, 8),
                                         (101, 333, 4), (64, 200, 2),
                                         (90, 140, 16), (7, 9, 16)])
def test_layout_round_trip(nx, nz, order):
    h = order // 2
    base = torch.from_numpy(_field(nx, nz))
    R, W, r0, c0 = padded.padded_layout(nx, nz, order)
    assert (R, r0, c0) == (nx + 2 * h, h, h)
    assert W % 4 == 0 and nz + 2 * h <= W < nz + 2 * h + 4
    p = padded.to_padded(base, order)
    assert p.shape == (R, W) and p.dtype == torch.float32
    assert torch.equal(padded.from_padded(p, nx, nz, order), base)
    padded.from_padded(p, nx, nz, order).zero_()
    assert float(p.abs().max()) == 0.0


@pytest.mark.parametrize("nx,nz,order,tile_rows", [
    (256, 256, 8, 64),
    (151, 151, 8, 64),
    (101, 333, 4, 32),
    (64, 200, 2, 16),
    (90, 140, 16, 64),
])
def test_vpu_matches_jax_and_laplacian(nx, nz, order, tile_rows):
    base = _field(nx, nz)
    out, got = _port_padded(base, order, "vpu")
    cx, cz = numerics.scaled_coefficients(order, 10.0, 7.5)
    assert np.array_equal(got, stencil.laplacian(torch.from_numpy(base), cx,
                                                 cz, order).numpy())
    ref = np.asarray(jst.laplacian(jnp.asarray(base), jnp.asarray(cx),
                                   jnp.asarray(cz), order))
    tol = 4 * EPS * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got, _jax_padded(base, order, tile_rows,
                                                "vpu"), atol=tol, rtol=0)
    padded.from_padded(out, nx, nz, order).zero_()
    assert float(out.abs().max()) == 0.0


def test_chain_is_fixed_point_and_pads_stay_zero():
    """Applies chain with no glue: n applies equal n applies of
    stencil.laplacian bitwise (and two equal the JAX chain to 8 eps), on
    two buffers through out=, with the pads zero after every apply."""
    nx = nz = 192
    order = 8
    base = _field(nx, nz, 1)
    cx, cz = numerics.scaled_coefficients(order, 10.0, 10.0)
    bufs = (padded.to_padded(torch.from_numpy(base), order),
            torch.full(padded.padded_layout(nx, nz, order)[:2], np.nan))
    ref = torch.from_numpy(base)
    for i in range(3):
        src, dst = bufs[i % 2], bufs[1 - i % 2]
        assert padded.laplacian_padded_cuda(src, cx, cz, order, nx, nz,
                                            out=dst) is dst
        ref = stencil.laplacian(ref, cx, cz, order)
        assert torch.equal(padded.from_padded(dst, nx, nz, order), ref)
        pads = dst.clone()
        padded.from_padded(pads, nx, nz, order).zero_()
        assert float(pads.abs().max()) == 0.0
        if i == 1:
            jcx, jcz = jnum.scaled_coefficients(order, 10.0, 10.0)
            j = jps.to_padded(jnp.asarray(base), order, 64)
            for _ in range(2):
                j = jps.laplacian_pallas_padded(j, jcx, jcz, order, nx, nz,
                                                64, interpret=True)
            j = np.asarray(jps.from_padded(j, nx, nz, order, 64))
            np.testing.assert_allclose(
                padded.from_padded(dst, nx, nz, order).numpy(), j,
                atol=8 * EPS * max(1.0, np.abs(j).max()), rtol=0)


@pytest.mark.parametrize("impl,rel_tol", [("mxu", 2e-5), ("mxu6", 2e-7)])
@pytest.mark.parametrize("nx,nz,order,tile_rows", [
    (96, 100, 8, 64),
    (151, 151, 8, 64),
    (200, 300, 8, 64),
    (120, 520, 4, 32),
])
def test_mxu_impls_match_jax(nx, nz, order, tile_rows, impl, rel_tol):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((nx, nz)).astype(np.float32)
    out, got = _port_padded(base, order, impl)
    want = _jax_padded(base, order, tile_rows, impl)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    cx, cz = numerics.scaled_coefficients(order, 10.0, 7.5)
    exact = stencil.laplacian(torch.from_numpy(base), cx, cz, order).numpy()
    err = np.abs(got - exact).max()
    assert 1e-9 * scale < err <= rel_tol * np.abs(exact).max()
    padded.from_padded(out, nx, nz, order).zero_()
    assert float(out.abs().max()) == 0.0


def test_wrapper_checks():
    nx, nz, order = 20, 18, 4
    cx, cz = numerics.scaled_coefficients(order, 10.0, 10.0)
    p = padded.to_padded(torch.from_numpy(_field(nx, nz)), order)
    with pytest.raises(ValueError, match="impl"):
        padded.laplacian_padded_cuda(p, cx, cz, order, nx, nz, "exact")
    with pytest.raises(ValueError, match="impl"):
        padded.laplacian_padded(p, cx, cz, order, nx, nz, "mxu3")
    with pytest.raises(ValueError, match="shares memory"):
        padded.laplacian_padded_cuda(p, cx, cz, order, nx, nz, out=p)
    buf = torch.zeros(p.numel() + 4)
    shifted = (buf[:p.numel()].view(p.shape), buf[4:].view(p.shape))
    shifted[0].copy_(p)
    with pytest.raises(ValueError, match="shares memory"):
        padded.laplacian_padded_cuda(shifted[0], cx, cz, order, nx, nz,
                                     out=shifted[1])
    with pytest.raises(ValueError, match="float32"):
        padded.laplacian_padded_cuda(p[:, :-4], cx, cz, order, nx, nz)
    with pytest.raises(ValueError, match="float32"):
        padded.laplacian_padded_cuda(p.double(), cx, cz, order, nx, nz)
    with pytest.raises(ValueError, match="contiguous"):
        padded.laplacian_padded_cuda(p.t().contiguous().t(), cx, cz, order,
                                     nx, nz)
    with pytest.raises(ValueError, match="even"):
        padded.laplacian_padded_cuda(p, cx, cz, 5, nx, nz)
    with pytest.raises(ValueError, match="coefficients"):
        padded.laplacian_padded_cuda(p, cx[:-1], cz, order, nx, nz)
    padded.reset_launches()
    out = torch.empty_like(p)
    for impl in padded.IMPLS:
        padded.laplacian_padded_cuda(p, cx, cz, order, nx, nz, impl, out=out)
    assert padded.LAUNCHES == {"lap_padded": 0, "lap_padded_mma": 0}
