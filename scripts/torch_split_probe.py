#!/usr/bin/env python3
"""Build, check and time the split kernels on the strip bodies of
checkouts of the PyTorch port on one CUDA card: ``kstep_gpu_bwd_mma``,
``kstep_mod_mma`` and ``kstep_gpu_fwd_mma`` (the z taps in bf16 parts),
``block_fwd_mma`` / ``block2_fwd_mma`` and ``block_mod_mma`` /
``block2_mod_mma`` (the x taps in bf16 parts), each beside its exact twin.

    python3 scripts/torch_split_probe.py TREE [TREE ...]
                                         [--variants NAME ...]
                                         [--rounds N]

Each tree runs in a process of its own that imports the port from that
tree (building its kernels there). The process prints the compiler's
register, shared-memory and spill lines of these kernels at orders 8 and
16, holds the split kernels against their plain versions with the same
parts (2 and 3) on a small ragged grid (67 x 88 extended, two shots;
the K-step kernels pass by pass, ``kstep_mod_mma`` in both source modes
with its traces, the forward and modeling block kernels on the slabs of a (1, 2) and the tiles of a (1, 2, 2) mesh of
cuda:0, the modeling ones in both source modes with their traces; orders
8 and 16, K = 3, 4, 5 and 8 where the kernel takes them; fields 1e-4,
traces and image 1e-5 max rel) and the exact ones bitwise, and then times
them at the Pluto grid (7040 x 1281 extended, order 8, 2 shots, nt =
1001) as ``chip_smoke.py`` times them: ``kstep_gpu_bwd`` as 250 passes of
K = 4, ``kstep_mod`` (the Gaussian source, the all-edge taper, the trace
row) and ``kstep_gpu_fwd`` as 251; each forward and modeling block kernel as 126 blocks of K = 8 (the
last of one step) on the four slabs of a (1, 4) mesh of cuda:0 or the
four tiles of a (1, 2, 2) mesh, from fixed random states (the modeling
kernels with the Gaussian source, the all-edge taper and the trace row);
exact, mxu and mxu6. Median of 3
CUDA-event samples after a warm-up. A tree whose kernel refuses a K
(an older one's staged tile) reports the refusal and goes on.

``--variants`` adds copies of the last tree with other constants:
``unpadded`` (the split backward instances' rows at the tile's pitch,
``csrc/bwd_strip.cuh``), ``kstep48x64`` and ``kstep32x64``
(``kstep_gpu_bwd_mma``'s first owned shape), ``blocks1`` (the strip
kernels' launch bounds, one block an SM, ``csrc/strip.cuh``),
``kstep_blocks2`` (``kstep_gpu_bwd_mma``'s, two blocks an SM),
``fwd64x96``, ``fwd48x64``, ``fwd64x48`` and
``fwd32x64`` and ``fwd32x96`` (the first owned shape of the forward
body's split instances, ``block_fwd_mma``, ``block_mod_mma``,
``kstep_mod_mma`` and ``kstep_gpu_fwd_mma``, that of ``kFwdShapes`` in
``csrc/fwd_strip.cuh``, which the exact forward K-step kernels share),
``fwd_blocks1`` (the launch bounds of ``block_fwd_mma``, one block an
SM), ``fwd_unpadded`` (the rows of the forward body's split instances at
the tile's pitch) and ``zmod_blocks1`` / ``zfwd_blocks1`` (the launch
bounds of ``kstep_mod_mma`` / ``kstep_gpu_fwd_mma``, one block an SM),
made under a
temporary directory. The trees run in turns, ``--rounds`` times (A, B,
..., then in reverse), as ``scripts/torch_bwd_probe.py`` runs them.
Prints one JSON line per process and the medians per tree, beside the
card's name and power limit.
"""

from __future__ import annotations

import sys

import torch_bwd_probe

_FWD_FIRST = "kFwdShapes[] = {\n    {64, 64}, "
_ZMMA_FIRST = "kBwdZMmaShapes[] = {\n    {32, 96}, "
_LB = "__launch_bounds__(pfdc::kStripThreads, "
VARIANTS = {
    "unpadded": ("bwd_strip.cuh", "StripStage kBwdMmaStage{6, true, true};",
                 "StripStage kBwdMmaStage{6, true};"),
    "blocks1": ("strip.cuh", "constexpr int kStripBlocks = 2;",
                "constexpr int kStripBlocks = 1;"),
    "kstep_blocks2": ("kstep_gpu_bwd.cu", _LB + "1)\n    kstep_gpu_bwd_mma(",
                      _LB + "pfdc::kStripBlocks)\n    kstep_gpu_bwd_mma("),
    "kstep48x64": ("bwd_strip.cuh", _ZMMA_FIRST,
                   "kBwdZMmaShapes[] = {\n    {48, 64}, {32, 96}, "),
    "kstep32x64": ("bwd_strip.cuh", _ZMMA_FIRST,
                   "kBwdZMmaShapes[] = {\n    "),
    "fwd64x96": ("fwd_strip.cuh", _FWD_FIRST,
                 "kFwdShapes[] = {\n    {64, 96}, {64, 64}, "),
    "fwd48x64": ("fwd_strip.cuh", _FWD_FIRST,
                 "kFwdShapes[] = {\n    {48, 64}, {64, 64}, "),
    "fwd64x48": ("fwd_strip.cuh", _FWD_FIRST,
                 "kFwdShapes[] = {\n    {64, 48}, {64, 64}, "),
    "fwd32x64": ("fwd_strip.cuh", _FWD_FIRST,
                 "kFwdShapes[] = {\n    "),
    "fwd_blocks1": ("domain_block.cuh",
                    _LB + "pfdc::kStripBlocks)\n    block_fwd_mma(",
                    _LB + "1)\n    block_fwd_mma("),
    "fwd_unpadded": ("fwd_strip.cuh",
                     "StripStage kFwdMmaStage{3, false, true};",
                     "StripStage kFwdMmaStage{3, false};"),
    "fwd32x96": ("fwd_strip.cuh", _FWD_FIRST,
                 "kFwdShapes[] = {\n    {32, 96}, {64, 64}, "),
    "zmod_blocks1": ("kstep_mod.cu",
                     _LB + "pfdc::kStripBlocks)\n    kstep_mod_mma(",
                     _LB + "1)\n    kstep_mod_mma("),
    "zfwd_blocks1": ("kstep_gpu_fwd.cu",
                     _LB + "pfdc::kStripBlocks)\n    kstep_gpu_fwd_mma(",
                     _LB + "1)\n    kstep_gpu_fwd_mma("),
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
mesh_mod = __import__(pkg + ".parallel", fromlist=["x"])
dev = torch.device("cuda", 0)
build.library()
fn = None
ptxas = []        # printed after the checks, whose lines stderr's tail keeps
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    # the order-8 and order-16 instances (H = 4, 8)
    pat = r"\d(kstep_\w*|block2?_(?:fwd|mod)\w*)ILi[48]E"
    if fn and re.search(pat, fn) and ("registers" in line or "spill" in line):
        name = re.search(r"\d(kstep_\w*?|block2?_(?:fwd|mod)\w*?)EEv", fn)
        ptxas.append(f"[ptxas] {name[1] if name else fn[:60]}: "
                     f"{line.strip()}")
res = {"bitwise": True}
n_checks = 0
rng = np.random.default_rng(0)

def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

def max_rel(a, b):
    # a tile that records no trace row returns zeros
    return float((a.cpu() - b).abs().max()) / (float(b.abs().max()) or 1.0)

def judge(label, got, want, parts, gates):
    global n_checks
    if parts:
        rel = [max_rel(a, b) for a, b in zip(got, want)]
        ok = all(r <= g for r, g in zip(rel, gates))
        what = f"max rel {max(rel):.2e}"
    else:
        ok = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        what = "bitwise" if ok else "DIFFERS"
    res["bitwise"] &= ok
    n_checks += 1
    if not ok or "K 8" in label:
        print(f"[check] {label}: {what}{'' if ok else ' FAILS'}",
              file=sys.stderr)

for order in (8, 16):
    ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    st = [f32(2, ctx.nxe, ctx.nze) for _ in range(4)]
    img = f32(2, ctx.nx, ctx.nz)
    for k in (3, 4, 5, 8):
        inj = f32(2, k, ctx.nx)
        for parts in (0, 2, 3):
            call = lambda s, i, v, j: stream.fd_back_kstep_cuda(
                ctx, *s, i, v, j, 40, parts=parts)
            want = call(st, img.clone(), v2, inj)
            try:
                got = call([a.to(dev) for a in st], img.to(dev), v2.to(dev),
                           inj.to(dev))
            except ValueError as e:
                print(f"[check] kstep_gpu_bwd parts {parts} order {order} K "
                      f"{k}: refused ({str(e)[:50]})", file=sys.stderr)
                continue
            judge(f"kstep_gpu_bwd parts {parts} order {order} K {k}", got,
                  want, parts, (1e-4,) * 4 + (1e-5,))
        # the forward K-step kernels: kstep_mod in both source modes (its
        # traces within 1e-5), kstep_gpu_fwd
        a = np.float32(rng.standard_normal(k))
        for name, mode in (("kstep_mod", ("gaussian", "all")),
                           ("kstep_mod", ("point", "top")),
                           ("kstep_gpu_fwd", None)):
            for parts in (0, 2, 3):
                if mode is None:
                    call = lambda s, v: stream.fd_forward_kstep_cuda(
                        ctx, *s[:2], v, a, (31, 63), 62, parts=parts)
                else:
                    call = lambda s, v: stream.mod_kstep_cuda(
                        ctx, *s[:2], v[0], a, (31, 63), 62, 64, *mode,
                        parts=parts)
                want = call(st, v2)
                try:
                    got = call([x.to(dev) for x in st], v2.to(dev))
                except ValueError as e:
                    print(f"[check] {name} parts {parts} order {order} K "
                          f"{k}: refused ({str(e)[:50]})", file=sys.stderr)
                    continue
                judge(f"{name} {mode} parts {parts} order {order} K {k}",
                      got, want, parts, (1e-4, 1e-4, 1e-5))
    # the forward kernels; the modeling ones with the Gaussian source and
    # the all-edge taper (one velocity plane) and with the point source
    # and the top taper, their traces within 1e-5
    for name, shape, prep, kern, geometry, modes in (
            ("block_fwd", (1, 2), dk.prepare_tiles, dk.block_fwd_cuda,
             dk.slab_geometry, (("top", "point"),)),
            ("block2_fwd", (1, 2, 2), d2k.prepare_tiles, d2k.block2_fwd_cuda,
             d2k.tile_geometry, (("top", "point"),)),
            ("block_mod", (1, 2), dk.prepare_tiles, dk.block_mod_cuda,
             dk.slab_geometry, (("all", "gaussian"), ("top", "point"))),
            ("block2_mod", (1, 2, 2), d2k.prepare_tiles, d2k.block2_mod_cuda,
             d2k.tile_geometry, (("all", "gaussian"), ("top", "point")))):
        for k in (3, 5, 8):
            try:
                geom = geometry(ctx, *shape[1:], k)
            except ValueError:                  # beyond the tiles' width
                continue
            n = int(np.prod(shape))
            for taper, source in modes:
                vv = v2[0] if source == "gaussian" else v2
                tiles = [prep(ctx, mesh_mod.make_mesh(
                    *shape, devices=[d] * n).grid(0), geom, vv, taper,
                    sxs=(33, 34), sz=42, source=source, gz=46)
                         for d in ("cpu", dev)]
                a = np.float32(rng.standard_normal(k))
                for j, (cc, cg) in enumerate(zip(*tiles)):
                    f = [f32(2, cc.nxw, cc.nzw) for _ in range(2)]
                    for parts in (0, 2, 3):
                        want = kern(cc, *f, a, parts=parts)
                        try:
                            got = kern(cg, *(x.to(dev) for x in f), a,
                                       parts=parts)
                        except ValueError as e:
                            print(f"[check] {name} parts {parts} order "
                                  f"{order} K {k}: refused "
                                  f"({str(e)[:50]})", file=sys.stderr)
                            continue
                        judge(f"{name} {source} parts {parts} order "
                              f"{order} K {k} tile {j}", got, want, parts,
                              (1e-4, 1e-4, 1e-5))
print("\n".join(ptxas), file=sys.stderr)
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
for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):

    def kstep():
        for _ in range(250):
            stream.fd_back_kstep_cuda(ctx, *st, img, v2, inj, 40, consts,
                                      parts=parts)

    res["kstep_gpu_bwd" + sfx] = median_ms(kstep)
wav = np.float32(rng.standard_normal(ctx.nt))
v2m = v2[0]                     # one plane: consts hold to the tensor
cm = stream.prepare(ctx, v2m, [2740, 2760], source="gaussian", taper="all")
cf = stream.prepare(ctx, v2, [2740, 2760], source="point", taper="top")
for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):

    def kmod():
        for it0 in range(0, ctx.nt, 4):
            stream.mod_kstep_cuda(ctx, *st[:2], v2m, wav[it0:it0 + 4],
                                  [2740, 2760], 40, 40, consts=cm,
                                  parts=parts)

    def kfwd():
        for it0 in range(0, ctx.nt, 4):
            stream.fd_forward_kstep_cuda(ctx, *st[:2], v2, wav[it0:it0 + 4],
                                         [2740, 2760], 40, consts=cf,
                                         parts=parts)

    res["kstep_mod" + sfx] = median_ms(kmod)
    res["kstep_gpu_fwd" + sfx] = median_ms(kfwd)
del st, img, inj, consts, cm, cf, v2m
K = 8
for name, shape, prep, kern, geometry in (
        ("block_fwd", (1, 4), dk.prepare_tiles, dk.block_fwd_cuda,
         dk.slab_geometry),
        ("block2_fwd", (1, 2, 2), d2k.prepare_tiles, d2k.block2_fwd_cuda,
         d2k.tile_geometry),
        ("block_mod", (1, 4), dk.prepare_tiles, dk.block_mod_cuda,
         dk.slab_geometry),
        ("block2_mod", (1, 2, 2), d2k.prepare_tiles, d2k.block2_mod_cuda,
         d2k.tile_geometry)):
    geom = geometry(ctx, *shape[1:], K)
    grid = mesh_mod.make_mesh(*shape, devices=[dev] * 4).grid(0)
    if name.endswith("mod"):
        rs = prep(ctx, grid, geom, v2[0], "all", sxs=(2740, 2760), sz=40,
                  source="gaussian", gz=40)
    else:
        rs = prep(ctx, grid, geom, v2, "top", sxs=(2740, 2760), sz=40, gz=40)
    sts = [[torch.from_numpy(rng.standard_normal((2, c.nxw, c.nzw)).astype(
        np.float32)).to(dev) for _ in range(2)] for c in rs]
    outs = [[torch.zeros_like(f[0]) for _ in range(2)] for f in sts]
    wav = np.float32(rng.standard_normal(ctx.nt))
    for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):

        def blocks():
            for it0 in range(0, ctx.nt, K):
                a = wav[it0:it0 + K]
                for j, c in enumerate(rs):
                    kern(c, *sts[j], a, out=outs[j], parts=parts)

        res[name + sfx] = median_ms(blocks)
    del rs, sts, outs
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


if __name__ == "__main__":
    sys.exit(torch_bwd_probe.main(CHILD, VARIANTS, __doc__))
