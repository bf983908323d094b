#!/usr/bin/env python3
"""Build, check and time the exact backward kernels of checkouts of the
PyTorch port on one CUDA card: ``kstep_gpu_bwd`` (the large-grid tier) and
``block_bwd`` / ``block2_bwd`` (the domain tiers).

    python3 scripts/torch_bwd_probe.py TREE [TREE ...]
                                       [--variants NAME ...] [--rounds N]

Each tree runs in a process of its own that imports the port from that
tree (building its kernels there). The process prints the compiler's
register, shared-memory and spill lines of the three kernels, holds each
against its plain version on a small ragged grid (67 x 88 extended, two
shots, orders 4, 8 and 16, K = 2 and 4 for ``kstep_gpu_bwd``; the slabs of
a (1, 2) and the tiles of a (1, 2, 2) mesh of cuda:0, order 8, K = 3 and
8, seeded and not, for ``block_bwd`` and ``block2_bwd``), bitwise, and
then times them at the Pluto grid (7040 x 1281 extended, order 8, 2
shots, nt = 1001): ``kstep_gpu_bwd`` as 250 passes of K = 4, ``block_bwd``
as 126 blocks of K = 8 on the four slabs of a (1, 4) mesh of cuda:0 and
``block2_bwd`` on the four tiles of a (1, 2, 2) mesh, fixed random
states, median of 3 CUDA-event samples after a warm-up.

``--variants`` adds copies of the last tree with other constants of
``csrc/strip.cuh``, ``csrc/bwd_strip.cuh`` and ``csrc/domain_block.cuh``
(the strip's rows, the warps of a block, the first owned shape, the
block kernels' passes of up to 8 steps instead of 4, ``kBlockPassSteps``:
one pass a block of ``block_bwd``; the wrappers still count two),
made under a temporary directory. The trees run in turns,
``--rounds`` times (A, B, ..., then in reverse). Prints one JSON line per
process and the medians per tree, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

PKG = "parallel_finite_difference_computation_tpu_torch"
# name: (a header of csrc/, a text in it, its replacement); the constants
# of the tree these copies start from
VARIANTS = {
    "rows8": ("strip.cuh", "constexpr int kStripRows = 4;",
              "constexpr int kStripRows = 8;"),
    "rows16": ("strip.cuh", "constexpr int kStripRows = 4;",
               "constexpr int kStripRows = 16;"),
    "warps8": ("strip.cuh", "constexpr int kStripWarps = 16;",
               "constexpr int kStripWarps = 8;"),
    "warps12": ("strip.cuh", "constexpr int kStripWarps = 16;",
                "constexpr int kStripWarps = 12;"),
    "tile64x64": ("bwd_strip.cuh", "{32, 64}, {32, 32}, {16, 32}, {16, 16}};",
                  "{64, 64}, {32, 64}, {32, 32}, {16, 32}, {16, 16}};"),
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
    if fn and ("kstep_gpu_bwd" in fn or "block_bwd" in fn) and (
            "registers" in line or "spill" in line):
        print(f"[ptxas] {fn[:48]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
rng = np.random.default_rng(0)

def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

for order in (4, 8, 16):
    ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    st = [f32(2, ctx.nxe, ctx.nze) for _ in range(4)]
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    img = f32(2, ctx.nx, ctx.nz)
    for k in (2, 4):
        inj = f32(2, k, ctx.nx)
        want = stream.fd_back_kstep_cuda(ctx, *st, img.clone(), v2, inj, 63)
        try:
            got = stream.fd_back_kstep_cuda(
                ctx, *(f.to(dev) for f in st), img.to(dev), v2.to(dev),
                inj.to(dev), 63)
        except ValueError as e:          # a tile beyond the shared memory
            print(f"[check] kstep_gpu_bwd order {order} K {k}: refused",
                  file=sys.stderr)
            continue
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        res["bitwise"] &= same
        print(f"[check] kstep_gpu_bwd order {order} K {k}: "
              f"{'bitwise' if same else 'DIFFERS'}", file=sys.stderr)

ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                              order=8, nxb=7, nzb=9, fac=0.7)
v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
    (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
d_ext = dom.embed_dobs(ctx, rng.standard_normal((2, ctx.nx, 9)).astype(
    np.float32))
for name, shape, prep, kern, geometry in (
        ("block_bwd", (1, 2), dk.prepare_tiles, dk.block_bwd_cuda,
         dk.slab_geometry),
        ("block2_bwd", (1, 2, 2), d2k.prepare_tiles, d2k.block2_bwd_cuda,
         d2k.tile_geometry)):
    for k in (3, 8):
        geom = geometry(ctx, *shape[1:], k)
        n = int(np.prod(shape))
        tiles = [prep(ctx, mesh_mod.make_mesh(*shape, devices=[d] * n).grid(0),
                      geom, v2, "top", sxs=(33, 34), sz=42, dobs_ext=d_ext,
                      gz=46) for d in ("cpu", dev)]
        for j, (cc, cg) in enumerate(zip(*tiles)):
            f = [f32(2, cc.nxw, cc.nzw) for _ in range(6)]
            img = f32(2, cc.nxl, cc.nzl)
            for snaps in (None, f[4:6]):
                want = kern(cc, *f[:4], img.clone(), 0, k, snaps)
                got = kern(cg, *(a.to(dev) for a in f[:4]), img.to(dev), 0,
                           k, None if snaps is None else
                           [a.to(dev) for a in snaps])
                same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
                res["bitwise"] &= same
                print(f"[check] {name} K {k} tile {j} "
                      f"{'seeded' if snaps else 'unseeded'}: "
                      f"{'bitwise' if same else 'DIFFERS'}", file=sys.stderr)

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

    def blocks():
        for it0 in range(0, ctx.nt, K):
            k = min(K, ctx.nt - it0)
            for j, c in enumerate(rs):
                kern(c, *sts[j], imgs[j], it0, k, out=outs[j])

    res[name] = median_ms(blocks)
    del rs, sts, imgs, outs
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def variant_trees(tree: str, names, tmp: pathlib.Path,
                  variants=None) -> dict:
    """Copies of the port in ``tree`` with each of the ``variants`` (by
    default VARIANTS) ``names`` applied: a variant is one (header, text,
    replacement) or a list of them."""
    variants = VARIANTS if variants is None else variants
    out = {}
    for name in names:
        edits = variants[name]
        dst = tmp / name
        shutil.copytree(pathlib.Path(tree) / PKG, dst / PKG,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for header, old, new in ([edits] if isinstance(edits[0], str)
                                 else edits):
            header = dst / PKG / "csrc" / header
            text = header.read_text()
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in {header}")
            header.write_text(text.replace(old, new))
        out[name] = str(dst)
    return out


def main(child: str = CHILD, variants=None, doc: str = __doc__) -> int:
    """Runs ``child`` (Python source that reads ``TREE`` and prints its
    times as the last line of JSON, with ``"bitwise"``) once per tree and
    round, the trees in turns; ``variants`` (by default VARIANTS) name the
    copies ``--variants`` may ask for."""
    variants = VARIANTS if variants is None else variants
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(variants), metavar="NAME",
                    help=f"copies of the last tree: {', '.join(variants)}")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", default="",
                    help="a regular expression: the child times only the "
                         "cases whose names it finds (children that read "
                         "ONLY; default: every case)")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        trees = {t: t for t in args.trees}
        trees.update(variant_trees(args.trees[-1], args.variants,
                                   pathlib.Path(tmp), variants))
        times = {name: [] for name in trees}
        bad = 0
        for r in range(args.rounds):
            order = list(trees) if r % 2 == 0 else list(reversed(trees))
            for name in order:
                out = subprocess.run(
                    [sys.executable, "-c",
                     f"TREE = {trees[name]!r}\nONLY = {args.only!r}\n"
                     + child],
                    capture_output=True, text=True, timeout=1200)
                sys.stderr.write(out.stderr[-6000:])
                if out.returncode != 0:
                    print(f"{name}: exit {out.returncode}", flush=True)
                    bad += 1
                    continue
                res = json.loads(out.stdout.strip().splitlines()[-1])
                bad += not res.pop("bitwise")
                times[name].append(res)
                print(json.dumps({"tree": name, "ms": res, "card": smi}),
                      flush=True)
        for name, runs in times.items():
            if runs:
                # the medians of the times; the distinct values of any
                # other entry (a digest of results)
                med = {k: statistics.median(r[k] for r in runs)
                       if isinstance(runs[0][k], (int, float))
                       else sorted({r[k] for r in runs}) for k in runs[0]}
                print(f"{name}: median ms per 2-shot, 1001-step Pluto call "
                      f"{json.dumps(med)} ({len(runs)} processes); {smi}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
