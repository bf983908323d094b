#!/usr/bin/env python3
"""How far the split-bf16 lowerings of the large-grid tier drift from the
exact taps, through the plain path, at the Pluto config's sampling.

    python scripts/torch_split_drift.py [--nx 400] [--nz 300] [--nt 1001]
        [--parts 2 3] [--device cpu]

Runs ``forward_modeling_tiled`` then ``rtm_shot_snapshot_tiled`` (K = 4,
one shot, the data of the exact modeling run) on the Pluto config
(``chip_smoke.PLUTO``: dx = dz = 7.62, dt = 0.0007, fpeak 6, order 8, its
four-layer model), its grid cut to nx x nz, once with the exact taps and
once per split lowering (2 parts: ``lap_impl="mxu"``, 3: ``"mxu6"``), and
prints the gathers' and the image's rel RMS from the exact run. On the CPU
the tiled drivers run their plain passes, which agree with the JAX
package's K-step kernels in interpret mode pass by pass
(``tests/test_torch_tiled_mxu.py``), so the drift is the lowering's own,
not a kernel's. About a minute at the defaults on the CPU (nt = 1001).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--nz", type=int, default=300)
    ap.add_argument("--nt", type=int, default=1001)
    ap.add_argument("--parts", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke
    from parallel_finite_difference_computation_tpu_torch import (
        numerics, pipeline, solver)
    from parallel_finite_difference_computation_tpu_torch.config import (
        Geometry, Params)
    from parallel_finite_difference_computation_tpu_torch.models import (
        layered_model)

    dev = torch.device(args.device)
    p = Params(**dict(chip_smoke.PLUTO, nx=args.nx, nz=args.nz, nt=args.nt,
                      ns=1, fsx=args.nx // 2))
    vp = layered_model(p.nx, p.nz, velocities=chip_smoke.PLUTO_VELOCITIES)
    ctx_m = solver.FDContext.from_params(p, exact_taper=False)
    ctx_r = solver.FDContext.from_params(p, exact_taper=True)
    g = Geometry.from_params(p)
    v2_m = torch.from_numpy(pipeline.prepare_velocity_cpu(p, vp)).to(dev)
    v2_r = pipeline.prepare_velocities_gpu(p, vp, device=dev, seed=0)
    wav_m = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)
    wav_r = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak)
    t0 = time.perf_counter()
    data, image = {}, {}
    for parts in [0] + args.parts:
        data[parts] = solver.forward_modeling_tiled(
            ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz, block_k=4,
            lap_impl=parts)[2]
        dobs = data[0].transpose(1, 2).contiguous()
        image[parts] = solver.rtm_shot_snapshot_tiled(
            ctx_r, v2_r, wav_r, dobs, g.sx, g.sz, g.gz, block_k=4,
            lap_impl=parts)
    for parts in args.parts:
        rr_d = chip_smoke.rel_rms(data[parts].cpu(), data[0].cpu())
        rr_i = chip_smoke.rel_rms(image[parts].cpu(), image[0].cpu())
        print(f"Pluto sampling, {p.nxe} x {p.nze} extended, nt {p.nt}, K 4, "
              f"{args.device}: parts {parts} "
              f"({'mxu' if parts == 2 else 'mxu6'}) from the exact taps: "
              f"gathers rel RMS {rr_d:.3e}, image rel RMS {rr_i:.3e}",
              flush=True)
    print(f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
