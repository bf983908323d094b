#!/usr/bin/env python3
"""Build, check and time the split backward block kernels of checkouts of
the PyTorch port on one CUDA card: ``block_bwd_mma`` (x-slabs) and
``block2_bwd_mma`` ((x, z) tiles), with the x taps in 2 and 3 bf16 parts,
beside the exact kernels that share their strip body (``block_bwd``,
``block2_bwd``, ``kstep_gpu_bwd``).

    python3 scripts/torch_bwd_mma_probe.py TREE [TREE ...]
                                           [--variants NAME ...]
                                           [--rounds N]

Each tree runs in a process of its own that imports the port from that
tree (building its kernels there). The process prints the compiler's
register, shared-memory and spill lines of the backward kernels, holds the
split kernels against their plain block functions with the same parts on
a small ragged grid (67 x 88 extended, two shots; the slabs of a (1, 2)
and the tiles of a (1, 2, 2) mesh of cuda:0; orders 8 and 16, K = 3, 5 and
8 where the tiles take them, seeded and not; fields 1e-4 and image 1e-5
max rel) and the exact ones bitwise, and then times them at the Pluto
grid (7040 x 1281 extended, order 8, 2 shots, nt = 1001) as
``chip_smoke.py`` times them: each block kernel as 126 blocks of K = 8
(the last of one step) on the four slabs of a (1, 4) mesh of cuda:0 or the
four tiles of a (1, 2, 2) mesh, from fixed random states;
``kstep_gpu_bwd`` as 250 passes of K = 4. Median of 3 CUDA-event samples
after a warm-up.

``--variants`` adds copies of the last tree with other constants of
``csrc/bwd_strip.cuh`` (``tile32x32``, ``tile16x32``: the backward
body's first owned shape; ``unpadded``: the split instances' rows at the
tile's pitch), ``csrc/strip.cuh`` (``blocks1``: the strip kernels'
launch bounds, one block an SM) or ``csrc/domain_block.cuh``
(``one_pass``: a block of K = 8 in one pass),
made under a temporary directory. The trees run in turns, ``--rounds``
times (A, B, ..., then in reverse), as ``scripts/torch_bwd_probe.py`` runs
them. Prints one JSON line per process and the medians per tree, beside the
card's name and power limit.
"""

from __future__ import annotations

import sys

import torch_bwd_probe

# name: (a header of csrc/, a text in it, its replacement). The split
# instances share the exact body's shapes and launch bounds, so the shape
# and bounds variants change block_bwd's and kstep_gpu_bwd's too.
_FIRST = "kBwdShapes[] = {{32, 64}, {32, 32}, "
VARIANTS = {
    "tile32x32": ("bwd_strip.cuh", _FIRST, "kBwdShapes[] = {{32, 32}, "),
    "tile16x32": ("bwd_strip.cuh", _FIRST, "kBwdShapes[] = {"),
    "unpadded": ("bwd_strip.cuh", "StripStage kBwdMmaStage{6, true, true};",
                 "StripStage kBwdMmaStage{6, true};"),
    "blocks1": ("strip.cuh", "constexpr int kStripBlocks = 2;",
                "constexpr int kStripBlocks = 1;"),
    "one_pass": ("domain_block.cuh", "constexpr int kBlockPassSteps = 4;",
                 "constexpr int kBlockPassSteps = 8;"),
}

CHILD = r'''
import json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
stream = __import__(pkg + ".ops.stream", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dk = __import__(pkg + ".parallel.domain_kernels", fromlist=["x"])
d2k = __import__(pkg + ".parallel.domain2d_kernels", fromlist=["x"])
dom = __import__(pkg + ".parallel.domain", fromlist=["x"])
mesh_mod = __import__(pkg + ".parallel", fromlist=["x"])
dev = torch.device("cuda", 0)
build.library()
log = build.build_log()
fn = None
for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    # the order-8 and order-16 instances (H = 4, 8)
    if fn and re.search(r"(kstep_gpu_bwd\w*|block_bwd\w*)ILi[48]E", fn) and (
            "registers" in line or "spill" in line):
        name = re.search(r"(kstep_gpu_bwd\w*|block_bwd\w*I\w*?)EEv", fn)
        print(f"[ptxas] {name[1] if name else fn[:64]}: {line.strip()}",
              file=sys.stderr)
res = {"bitwise": True}
n_checks = 0
rng = np.random.default_rng(0)

def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

def max_rel(a, b):
    return float((a.cpu() - b).abs().max()) / float(b.abs().max())

for order in (8, 16):
    ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    d_ext = dom.embed_dobs(ctx, rng.standard_normal((2, ctx.nx, 9)).astype(
        np.float32))
    for name, shape, prep, kern, geometry in (
            ("block_bwd", (1, 2), dk.prepare_tiles, dk.block_bwd_cuda,
             dk.slab_geometry),
            ("block2_bwd", (1, 2, 2), d2k.prepare_tiles, d2k.block2_bwd_cuda,
             d2k.tile_geometry)):
        for k in (3, 5, 8):
            try:
                geom = geometry(ctx, *shape[1:], k)
            except ValueError:                  # beyond the tiles' width
                continue
            n = int(np.prod(shape))
            tiles = [prep(ctx, mesh_mod.make_mesh(*shape, devices=[d] * n
                                                  ).grid(0),
                          geom, v2, "top", sxs=(33, 34), sz=42,
                          dobs_ext=d_ext, gz=46) for d in ("cpu", dev)]
            for j, (cc, cg) in enumerate(zip(*tiles)):
                f = [f32(2, cc.nxw, cc.nzw) for _ in range(6)]
                img = f32(2, cc.nxl, cc.nzl)
                for parts in (0, 2, 3):
                    for snaps in (None, f[4:6]):
                        want = kern(cc, *f[:4], img.clone(), 0, k, snaps,
                                    parts=parts)
                        got = kern(cg, *(a.to(dev) for a in f[:4]),
                                   img.to(dev), 0, k, None if snaps is None
                                   else [a.to(dev) for a in snaps],
                                   parts=parts)
                        if parts:
                            rel = [max_rel(a, b) for a, b in zip(got, want)]
                            ok = max(rel[:4]) <= 1e-4 and rel[4] <= 1e-5
                            what = (f"fields {max(rel[:4]):.2e}, image "
                                    f"{rel[4]:.2e}")
                        else:
                            ok = all(torch.equal(a.cpu(), b)
                                     for a, b in zip(got, want))
                            what = "bitwise" if ok else "DIFFERS"
                        res["bitwise"] &= ok
                        n_checks += 1
                        if not ok or (k == 8 and j == 0):
                            print(f"[check] {name} parts {parts} order "
                                  f"{order} K {k} tile {j} "
                                  f"{'seeded' if snaps else 'unseeded'}: "
                                  f"{what}{'' if ok else ' FAILS'}",
                                  file=sys.stderr)
print(f"[check] {n_checks} cases, {'all held' if res['bitwise'] else 'FAILED'}",
      file=sys.stderr)

ctx = solver.FDContext.create(6960, 1201, 1001, dx=7.62, dz=7.62, dt=0.0007,
                              order=8, nxb=40, nzb=40, fac=0.75)
v2 = torch.from_numpy(((1500.0 + 2500.0 * rng.random(
    (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(dev)

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
img = torch.zeros((2, ctx.nx, ctx.nz), device=dev)
inj = torch.from_numpy(rng.standard_normal((2, 4, ctx.nx)).astype(
    np.float32)).to(dev)
consts = stream.prepare(ctx, v2, [0, 0], source="point", taper="top")

def kstep():
    for _ in range(250):
        stream.fd_back_kstep_cuda(ctx, *st, img, v2, inj, 40, consts)

res["kstep_gpu_bwd"] = median_ms(kstep)
del st, img, inj, consts
d_ext = np.zeros((2, ctx.nxe, ctx.nt), np.float32)
d_ext[:, 40:7000] = rng.standard_normal((2, 6960, ctx.nt))
K = 8
for name, shape, prep, kern, geometry in (
        ("block_bwd", (1, 4), dk.prepare_tiles, dk.block_bwd_cuda,
         dk.slab_geometry),
        ("block2_bwd", (1, 2, 2), d2k.prepare_tiles, d2k.block2_bwd_cuda,
         d2k.tile_geometry)):
    geom = geometry(ctx, *shape[1:], K)
    grid = mesh_mod.make_mesh(*shape, devices=[dev] * 4).grid(0)
    rs = prep(ctx, grid, geom, v2, "top", sxs=(2740, 2760), sz=40,
              dobs_ext=d_ext, gz=40)
    sts = [[torch.from_numpy(rng.standard_normal((2, c.nxw, c.nzw)).astype(
        np.float32)).to(dev) for _ in range(4)] for c in rs]
    imgs = [torch.zeros((2, c.nxl, c.nzl), device=dev) for c in rs]
    outs = [[torch.zeros_like(f[0]) for _ in range(4)] for f in sts]
    for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):

        def blocks():
            for it0 in range(0, ctx.nt, K):
                k = min(K, ctx.nt - it0)
                for j, c in enumerate(rs):
                    kern(c, *sts[j], imgs[j], it0, k, out=outs[j],
                         parts=parts)

        res[name + sfx] = median_ms(blocks)
    del rs, sts, imgs, outs
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


if __name__ == "__main__":
    sys.exit(torch_bwd_probe.main(CHILD, VARIANTS, __doc__))
