#!/usr/bin/env python3
"""Build, check and time the exact forward block kernels of the domain
tiers in checkouts of the PyTorch port on one CUDA card: ``block_mod`` and
``block_fwd`` (x-slabs) and ``block2_mod`` and ``block2_fwd`` ((x, z)
tiles), beside the kernels that share their bodies (``kstep_mod``,
``kstep_gpu_fwd``; ``block_bwd``, ``block2_bwd``) and the domain calls that
run them.

    python3 scripts/torch_block_fwd_probe.py TREE [TREE ...]
                                             [--variants NAME ...]
                                             [--rounds N]

Each tree runs in a process of its own that imports the port from that
tree (building its kernels there). The process prints the compiler's
register, shared-memory and spill lines of the forward block kernels,
holds them against their plain block functions on a small ragged grid
(67 x 88 extended, two shots, orders 4, 8 and 16, K = 3, 5 and 8 where the
tiles take them; the slabs of a (1, 2) and the tiles of a (1, 2, 2) mesh
of cuda:0; ``block_mod`` with a Gaussian source under the all-edge taper
and a point source under the top strip), bitwise, and then times them at
the Pluto grid (7040 x 1281 extended, order 8, 2 shots, nt = 1001): each
block kernel as 126 blocks of K = 8 (the last of one step) on the four
slabs of a (1, 4) mesh of cuda:0 or the four tiles of a (1, 2, 2) mesh,
from fixed random states, as ``chip_smoke.py`` times them; ``block_bwd``
and ``block2_bwd`` the same way; ``kstep_mod`` and ``kstep_gpu_fwd`` as the
tiled calls run them (251 passes of K = 4); and the domain tiers' whole
modeling and RTM calls (K = 8) on each mesh, whose gathers and images it
also hashes (SHA-256 of their bytes: equal digests across trees are
bitwise equal results). Median of 3 CUDA-event samples after a warm-up.

``--variants`` adds copies of the last tree with other constants of
``csrc/domain_block.cuh`` (``one_pass``: a block of K = 8 in one pass) or
``csrc/fwd_strip.cuh`` (``blockAxB``: the block kernels' first owned
shape; ``tile64x96``: the K-step kernels'), made under a temporary
directory. The trees run in turns,
``--rounds`` times (A, B, ..., then in reverse), as
``scripts/torch_bwd_probe.py`` runs them. Prints one JSON line per process
and the medians per tree, beside the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch_bwd_probe

# name: (a header of csrc/, a text in it, its replacement): a block of
# K = 8 in one pass; the block kernels' first owned shape; the K-step
# kernels' (kFwdShapes)
_BLOCK_FIRST = "    {64, 96}, {64, 64},"
VARIANTS = {
    "one_pass": ("domain_block.cuh", "constexpr int kBlockPassSteps = 4;",
                 "constexpr int kBlockPassSteps = 8;"),
    "block64x64": ("fwd_strip.cuh", _BLOCK_FIRST, "    {64, 64},"),
    **{f"block{a}x{b}": ("fwd_strip.cuh", _BLOCK_FIRST,
                          f"    {{{a}, {b}}},{_BLOCK_FIRST[3:]}")
       for a, b in ((64, 128), (32, 128), (64, 112), (48, 96))},
    "tile64x96": ("fwd_strip.cuh", "    {64, 64}, {32, 64},",
                  "    {64, 96}, {64, 64}, {32, 64},"),
}

CHILD = r'''
import hashlib, json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
numerics = __import__(pkg + ".numerics", fromlist=["x"])
stream = __import__(pkg + ".ops.stream", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dk = __import__(pkg + ".parallel.domain_kernels", fromlist=["x"])
d2k = __import__(pkg + ".parallel.domain2d_kernels", fromlist=["x"])
dom = __import__(pkg + ".parallel.domain", fromlist=["x"])
mesh_mod = __import__(pkg + ".parallel", fromlist=["x"])
dev = torch.device("cuda", 0)
build.library()
fn = None
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    if fn and re.search(r"block_(mod|fwd)ILi\d+ELb[01]EE", fn) and (
            "registers" in line or "spill" in line):
        print(f"[ptxas] {fn[:48]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
rng = np.random.default_rng(0)
TIERS = {"x": ((1, 2), (1, 4), dk.prepare_tiles, dk.slab_geometry,
               dk.block_mod_cuda, dk.block_fwd_cuda, dk.block_bwd_cuda,
               dk.make_sharded_forward_modeling_cuda,
               dk.make_sharded_rtm_snapshot_cuda),
         "xz": ((1, 2, 2), (1, 2, 2), d2k.prepare_tiles, d2k.tile_geometry,
                d2k.block2_mod_cuda, d2k.block2_fwd_cuda,
                d2k.block2_bwd_cuda,
                d2k.make_sharded_forward_modeling_2d_cuda,
                d2k.make_sharded_rtm_snapshot_2d_cuda)}

def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

for order in (4, 8, 16):
    ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    for tier, (shape, _, prep, geometry, kmod, kfwd, *_) in TIERS.items():
        n = int(np.prod(shape))
        for k in (3, 5, 8):
            try:
                geom = geometry(ctx, *shape[1:], k)
            except ValueError:           # the halo outgrows the tiles
                continue
            amps = rng.standard_normal(k).astype(np.float32)
            tiles = {}
            for d in ("cpu", dev):
                grid = mesh_mod.make_mesh(*shape, devices=[d] * n).grid(0)
                tiles[d] = (
                    prep(ctx, grid, geom, v2[0], "all", sxs=(33, 34), sz=42,
                         source="gaussian", gz=46),
                    prep(ctx, grid, geom, v2, "top", sxs=(33, 34), sz=42,
                         gz=46))
            for j in range(n):
                (mc, pc), (mg, pg) = ((t[0][j], t[1][j])
                                      for t in (tiles["cpu"], tiles[dev]))
                p, pp = f32(2, mc.nxw, mc.nzw), f32(2, mc.nxw, mc.nzw)
                for name, call, cc, cg in (
                        ("mod gaussian", kmod, mc, mg),
                        ("mod point", kmod, pc, pg),
                        ("fwd", kfwd, pc, pg)):
                    want = call(cc, p, pp, amps)
                    try:
                        got = call(cg, p.to(dev), pp.to(dev), amps)
                    except ValueError:   # beyond the shared memory
                        print(f"[check] {tier} {name} order {order} K {k}: "
                              f"refused", file=sys.stderr)
                        continue
                    same = all(torch.equal(a.cpu(), b)
                               for a, b in zip(got, want))
                    res["bitwise"] &= same
                    print(f"[check] {tier} {name} order {order} K {k} tile "
                          f"{j}: {'bitwise' if same else 'DIFFERS'}",
                          file=sys.stderr)

ctx = solver.FDContext.create(6960, 1201, 1001, dx=7.62, dz=7.62, dt=0.0007,
                              order=8, nxb=40, nzb=40, fac=0.75)
v2 = torch.from_numpy(((1500.0 + 2500.0 * rng.random(
    (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(dev)
wav = numerics.ricker_wavelet(ctx.nt, 0.0007, 6.0)
sxs, sz, gz, K = (2740, 2760), 40, 40, 8

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

d_ext = np.zeros((2, ctx.nxe, ctx.nt), np.float32)
d_ext[:, 40:7000] = rng.standard_normal((2, 6960, ctx.nt))
for tier, (_, shape, prep, geometry, kmod, kfwd, kbwd, mk_mod,
           mk_rtm) in TIERS.items():
    geom = geometry(ctx, *shape[1:], K)
    grid = mesh_mod.make_mesh(*shape, devices=[dev] * 4).grid(0)
    ms = prep(ctx, grid, geom, v2[0], "all", sxs=sxs, sz=sz,
              source="gaussian", gz=gz)
    rs = prep(ctx, grid, geom, v2, "top", sxs=sxs, sz=sz, dobs_ext=d_ext,
              gz=gz)
    sts = [[torch.from_numpy(rng.standard_normal((2, c.nxw, c.nzw)).astype(
        np.float32)).to(dev) for _ in range(4)] for c in rs]
    imgs = [torch.zeros((2, c.nxl, c.nzl), device=dev) for c in rs]
    outs = [[torch.zeros_like(f[0]) for _ in range(4)] for f in sts]

    def blocks(i):
        def go():
            for it0 in range(0, ctx.nt, K):
                k = min(K, ctx.nt - it0)
                for j in range(len(rs)):
                    if i == 0:
                        kmod(ms[j], *sts[j][:2], wav[it0:it0 + k],
                             out=outs[j][:2])
                    elif i == 1:
                        kfwd(rs[j], *sts[j][:2], wav[it0:it0 + k],
                             out=outs[j][:2])
                    else:
                        kbwd(rs[j], *sts[j], imgs[j], it0, k, out=outs[j])
        return go

    two = "2" if tier == "xz" else ""
    for i, name in enumerate(("mod", "fwd", "bwd")):
        res[f"block{two}_{name}"] = median_ms(blocks(i))
    del ms, rs, sts, imgs, outs
    torch.cuda.empty_cache()
    mesh = mesh_mod.make_mesh(*shape, devices=[dev] * 4)
    fmod = mk_mod(ctx, mesh, sz, gz, block_k=K)
    frtm = mk_rtm(ctx, mesh, sz, gz, block_k=K)
    calls = {f"modeling {tier}": lambda: fmod(v2[0], sxs, wav),
             f"RTM {tier}": lambda: frtm(v2, sxs, wav, d_ext)}
    for name, call in calls.items():
        out = call()
        out = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for t in out:
            h.update(t.contiguous().cpu().numpy().tobytes())
        print(f"[digest] {name}: {h.hexdigest()}", file=sys.stderr)
        res[f"digest {name}"] = h.hexdigest()[:16]
        del out
        res[name] = median_ms(call)
    del fmod, frtm
    torch.cuda.empty_cache()

st = [torch.from_numpy(rng.standard_normal((2, ctx.nxe, ctx.nze)).astype(
    np.float32)).to(dev) for _ in range(2)]
v2m = v2[0]
cm = stream.prepare(ctx, v2m, sxs, source="gaussian", taper="all")
cr = stream.prepare(ctx, v2, sxs, source="point", taper="top")

def kmod_passes():
    for it0 in range(0, ctx.nt, 4):
        stream.mod_kstep_cuda(ctx, st[0], st[1], v2m, wav[it0:it0 + 4],
                              sxs, sz, gz, consts=cm)

def kfwd_passes():
    for it0 in range(0, ctx.nt, 4):
        stream.fd_forward_kstep_cuda(ctx, st[0], st[1], v2,
                                     wav[it0:it0 + 4], sxs, sz, consts=cr)

res["kstep_mod"] = median_ms(kmod_passes)
res["kstep_gpu_fwd"] = median_ms(kfwd_passes)
print(json.dumps(res))
'''


if __name__ == "__main__":
    sys.exit(torch_bwd_probe.main(CHILD, VARIANTS, __doc__))
