#!/usr/bin/env python3
"""Build, check and time the exact forward K-step kernels of checkouts of
the PyTorch port on one CUDA card: ``kstep_mod`` and ``kstep_gpu_fwd`` (the
large-grid tier's forward passes), beside ``kstep_gpu_bwd`` and the two
tiled calls that run them.

    python3 scripts/torch_fwd_probe.py TREE [TREE ...]
                                       [--variants NAME ...] [--rounds N]

Each tree runs in a process of its own that imports the port from that
tree (building its kernels there). The process prints the compiler's
register, shared-memory and spill lines of the forward kernels, holds
them against their plain passes on a small ragged grid (67 x 88 extended,
two shots, orders 4, 8 and 16, K = 1, 4 and 8; ``kstep_mod`` with a
Gaussian source under the all-edge taper and a point source under the top
strip), bitwise, and then times them at the Pluto grid (7040 x 1281
extended, order 8, 2 shots, nt = 1001, fixed random states): ``kstep_mod``
and ``kstep_gpu_fwd`` as the tiled calls run them (251 passes of K = 4,
the last of one step), ``kstep_gpu_bwd`` as 250 passes of K = 4, and the
whole tiled modeling and RTM calls (``forward_modeling_tiled``,
``rtm_shot_snapshot_tiled``, K = 4); median of 3 CUDA-event samples after
a warm-up.

``--variants`` adds copies of the last tree with other constants of
``csrc/strip.cuh`` (the strip's rows, the warps of a block, the blocks an
SM that ``__launch_bounds__`` asks for) or ``csrc/fwd_strip.cuh`` (the
first owned shape),
made under a temporary directory. The trees run in turns, ``--rounds``
times (A, B, ..., then in reverse), as ``scripts/torch_bwd_probe.py``
runs them. Prints one JSON line per process and the medians per tree,
beside the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch_bwd_probe

# name: (a header of csrc/, a text in it, its replacement); the constants
# of the tree these copies start from. The strip's rows, warps and blocks
# an SM are strip.cuh's, which the backward body shares.
VARIANTS = {
    "rows8": ("strip.cuh", "constexpr int kStripRows = 4;",
              "constexpr int kStripRows = 8;"),
    "warps8": ("strip.cuh", "constexpr int kStripWarps = 16;",
               "constexpr int kStripWarps = 8;"),
    "blocks3": ("strip.cuh", "constexpr int kStripBlocks = 2;",
                "constexpr int kStripBlocks = 3;"),
    "blocks4": ("strip.cuh", "constexpr int kStripBlocks = 2;",
                "constexpr int kStripBlocks = 4;"),
    "tile32x64": ("fwd_strip.cuh", "    {64, 64}, {32, 64},", "    {32, 64},"),
    "tile96x64": ("fwd_strip.cuh", "    {64, 64}, {32, 64},",
                  "    {96, 64}, {64, 64}, {32, 64},"),
    "tile64x96": ("fwd_strip.cuh", "    {64, 64}, {32, 64},",
                  "    {64, 96}, {64, 64}, {32, 64},"),
}

CHILD = r'''
import json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
numerics = __import__(pkg + ".numerics", fromlist=["x"])
stream = __import__(pkg + ".ops.stream", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
build.library()
fn = None
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    exact = fn and re.search(r"kstep_(mod|gpu_fwd)(_strip|ILi\d+ELi0EE)", fn)
    if exact and ("registers" in line or "spill" in line):
        print(f"[ptxas] {fn[:48]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
rng = np.random.default_rng(0)

def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

for order in (4, 8, 16):
    ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    p, pp = f32(2, ctx.nxe, ctx.nze), f32(2, ctx.nxe, ctx.nze)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    sxs, sz, gz = (31, 63), 62, 64
    for k in (1, 4, 8):
        amps = rng.standard_normal(k).astype(np.float32)
        calls = {
            "kstep_mod gaussian all": lambda p, pp, v2: stream.mod_kstep_cuda(
                ctx, p, pp, v2[0], amps, sxs, sz, gz),
            "kstep_mod point top": lambda p, pp, v2: stream.mod_kstep_cuda(
                ctx, p, pp, v2[0], amps, sxs, sz, gz, "point", "top"),
            "kstep_gpu_fwd": lambda p, pp, v2: stream.fd_forward_kstep_cuda(
                ctx, p, pp, v2, amps, sxs, sz)}
        for name, call in calls.items():
            want = call(p, pp, v2)
            try:
                got = call(p.to(dev), pp.to(dev), v2.to(dev))
            except ValueError:           # a tile beyond the shared memory
                print(f"[check] {name} order {order} K {k}: refused",
                      file=sys.stderr)
                continue
            same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
            res["bitwise"] &= same
            print(f"[check] {name} order {order} K {k}: "
                  f"{'bitwise' if same else 'DIFFERS'}", file=sys.stderr)

ctx = solver.FDContext.create(6960, 1201, 1001, dx=7.62, dz=7.62, dt=0.0007,
                              order=8, nxb=40, nzb=40, fac=0.75)
v2 = torch.from_numpy(((1500.0 + 2500.0 * rng.random(
    (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(dev)
v2m = v2[0]
wav = numerics.ricker_wavelet(ctx.nt, 0.0007, 6.0)
sxs, sz, gz, K = (2740, 2760), 40, 40, 4

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

st = [torch.from_numpy(rng.standard_normal((2, ctx.nxe, ctx.nze)).astype(
    np.float32)).to(dev) for _ in range(4)]
cm = stream.prepare(ctx, v2m, sxs, source="gaussian", taper="all")
cr = stream.prepare(ctx, v2, sxs, source="point", taper="top")

def mod():
    for it0 in range(0, ctx.nt, K):
        stream.mod_kstep_cuda(ctx, st[0], st[1], v2m, wav[it0:it0 + K], sxs,
                              sz, gz, consts=cm)

def fwd():
    for it0 in range(0, ctx.nt, K):
        stream.fd_forward_kstep_cuda(ctx, st[0], st[1], v2,
                                     wav[it0:it0 + K], sxs, sz, consts=cr)

img = torch.zeros((2, ctx.nx, ctx.nz), device=dev)
inj = torch.from_numpy(rng.standard_normal((2, K, ctx.nx)).astype(
    np.float32)).to(dev)

def bwd():
    for _ in range(250):
        stream.fd_back_kstep_cuda(ctx, *st, img, v2, inj, gz, cr)

res["kstep_mod"] = median_ms(mod)
res["kstep_gpu_fwd"] = median_ms(fwd)
res["kstep_gpu_bwd"] = median_ms(bwd)
del st, img, inj
torch.cuda.empty_cache()
dobs = torch.from_numpy(rng.standard_normal((2, ctx.nx, ctx.nt)).astype(
    np.float32)).to(dev)
res["modeling tiled"] = median_ms(lambda: solver.forward_modeling_tiled(
    ctx, v2m, wav, sxs, sz, gz, block_k=K))
res["RTM tiled"] = median_ms(lambda: solver.rtm_shot_snapshot_tiled(
    ctx, v2, wav, dobs, sxs, sz, gz, block_k=K))
print(json.dumps(res))
'''


if __name__ == "__main__":
    sys.exit(torch_bwd_probe.main(CHILD, VARIANTS, __doc__))
