#!/usr/bin/env python3
"""How far the split-bf16 Laplacian tiers move when only the order of their
float32 sums changes: the floor under any comparison of two versions of the
same tier that sum in different orders (the ``*_step_mma`` kernels on the
tensor cores against their plain versions).

    python scripts/torch_sum_order_floor.py [--shots 2] [--device cpu]

Runs the plain ``solver.forward_modeling`` on the 3lay config (231 x 231
extended, nt=1001, order 8) with ``lap_impl="mxu"`` and ``"mxu6"``, once
as it is and once with every cross term of the banded product summed over
its taps in descending instead of ascending offset, and prints the max and
RMS relative differences of the final fields ``p``, ``pp`` and of the
gathers; then each tier against the exact taps. About a minute on a CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from parallel_finite_difference_computation_tpu_torch import (  # noqa: E402
    numerics, pipeline, solver)
from parallel_finite_difference_computation_tpu_torch.config import (  # noqa: E402
    Geometry, Params)
from parallel_finite_difference_computation_tpu_torch.models import (  # noqa: E402
    layered_model)
from parallel_finite_difference_computation_tpu_torch.ops import banded  # noqa: E402

THREE_LAY = Params(nz=151, nx=151, nt=1001, dz=10.0, dx=10.0, dt=0.001,
                   fpeak=30.0, ns=8, sz=0, fsx=0, ds=20, gz=0, nxb=40,
                   nzb=40, fac=0.01, order=8)


def banded_taps_descending(a, c, h, axis, parts):
    """:func:`banded.banded_taps` with each cross term summed from d = h
    down to -h."""
    axis = axis % a.dim()
    n = a.shape[axis]
    a_s, s = banded.split(a, parts), banded.split_coefs(c, parts)
    terms = {}
    for i, j in banded.cross_terms(parts):
        acc = None
        for d in range(h, -h - 1, -1):
            t = s[j][h + d] * a_s[i].narrow(axis, h + d, n - 2 * h)
            acc = t if acc is None else acc + t
        terms[i, j] = acc
    return banded.combine(terms, parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shots", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    p = THREE_LAY
    g = Geometry.from_params(p)
    ctx = solver.FDContext.from_params(p, exact_taper=False)
    v2 = torch.from_numpy(pipeline.prepare_velocity_cpu(
        p, layered_model(p.nx, p.nz))).to(args.device)
    wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)
    sx = list(g.sx[:args.shots])

    def run(lap_impl):
        return solver.forward_modeling(ctx, v2, wav, sx, g.sz, g.gz,
                                       lap_impl=lap_impl)

    def diffs(a, b):
        return ", ".join(
            f"{name} max rel {float((x - y).abs().max() / y.abs().max()):.3e}"
            f" rms rel {float((x - y).square().mean().sqrt() / y.square().mean().sqrt()):.3e}"
            for name, x, y in zip(("p", "pp", "gathers"), a, b))

    exact = run(None)
    for lap_impl in ("mxu", "mxu6"):
        asc = run(lap_impl)
        banded.banded_taps, keep = banded_taps_descending, banded.banded_taps
        try:
            desc = run(lap_impl)
        finally:
            banded.banded_taps = keep
        print(f"3lay modeling, {len(sx)} shots, nt={p.nt}, {lap_impl}: "
              f"descending vs ascending tap sums: {diffs(desc, asc)}")
        print(f"3lay modeling, {len(sx)} shots, nt={p.nt}, {lap_impl} vs the "
              f"exact taps: {diffs(asc, exact)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
