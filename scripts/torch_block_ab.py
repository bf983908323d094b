#!/usr/bin/env python3
"""Time the x-domain tier's block kernels of two checkouts of the PyTorch
port in turns on one CUDA card.

    python3 scripts/torch_block_ab.py TREE_A TREE_B [--rounds N]

Each round runs A, B, B, A, each in a process of its own that imports the
port from that tree (building its kernels there), prepares the four slabs
of a (1, 4) mesh of cuda:0 at the Pluto grid (7040 x 1281 extended, order
8, 2 shots, K = 8), and times ``block_mod``, ``block_fwd`` and
``block_bwd`` over nt=1001 (126 blocks of K on each slab, fixed random
states, the kernels writing into output buffers made once), median of 5
CUDA-event samples after a warm-up. Prints one JSON line per process and
the medians per tree, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

CHILD = r'''
import json, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
numerics = __import__(pkg + ".numerics", fromlist=["x"])
dk = __import__(pkg + ".parallel.domain_kernels", fromlist=["x"])
dev = torch.device("cuda", 0)
ctx = solver.FDContext.create(6960, 1201, 1001, dx=7.62, dz=7.62, dt=0.0007,
                              order=8, nxb=40, nzb=40, fac=0.75)
rng = np.random.default_rng(0)
v2 = torch.from_numpy(((1500.0 + 2500.0 * rng.random(
    (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(dev)
wav = numerics.ricker_wavelet(ctx.nt, 0.0007, 6.0)
d_ext = np.zeros((2, ctx.nxe, ctx.nt), np.float32)
d_ext[:, 40:7000] = rng.standard_normal((2, 6960, ctx.nt))
K, sxs, sz, gz = 8, (2740, 2760), 40, 40
ms = dk.prepare_slabs(ctx, [dev] * 4, K, v2[0], "all", sxs=sxs, sz=sz,
                      source="gaussian", gz=gz)
rs = dk.prepare_slabs(ctx, [dev] * 4, K, v2, "top", sxs=sxs, sz=sz,
                      dobs_ext=d_ext, gz=gz)
st = [[torch.from_numpy(rng.standard_normal((2, c.nxw, ctx.nze)).astype(
    np.float32)).to(dev) for _ in range(4)] for c in rs]
img = [torch.zeros((2, c.nxl, ctx.nze), device=dev) for c in rs]
out = [[torch.zeros_like(f[0]) for _ in range(4)] for f in st]

def run(kind):
    def go():
        for it0 in range(0, ctx.nt, K):
            k = min(K, ctx.nt - it0)
            for j in range(4):
                if kind == "block_mod":
                    dk.block_mod_cuda(ms[j], *st[j][:2], wav[it0:it0 + k],
                                      out=out[j][:2])
                elif kind == "block_fwd":
                    dk.block_fwd_cuda(rs[j], *st[j][:2], wav[it0:it0 + k],
                                      out=out[j][:2])
                else:
                    dk.block_bwd_cuda(rs[j], *st[j], img[j], it0, k,
                                      out=out[j])
    return go

res = {}
for kind in ("block_mod", "block_fwd", "block_bwd"):
    fn = run(kind)
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    res[kind] = statistics.median(ts)
print(json.dumps(res))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    times = {args.tree_a: [], args.tree_b: []}
    for _ in range(args.rounds):
        for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
            out = subprocess.run(
                [sys.executable, "-c", f"TREE = {tree!r}\n" + CHILD],
                capture_output=True, text=True, check=True, timeout=900)
            res = json.loads(out.stdout.strip().splitlines()[-1])
            times[tree].append(res)
            print(json.dumps({"tree": tree, "ms": res, "card": smi}),
                  flush=True)
    for tree, runs in times.items():
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"{tree}: median ms per 2-shot, 1001-step call over four "
              f"slabs {json.dumps(med)} ({len(runs)} processes); {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
