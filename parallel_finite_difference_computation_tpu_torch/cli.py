"""Command-line interface of the port: the reference's four programs.

Usage (the reference's invocations):

    python -m parallel_finite_difference_computation_tpu_torch.cli stencil ./input.dat
    python -m parallel_finite_difference_computation_tpu_torch.cli mod     par=input.dat
    python -m parallel_finite_difference_computation_tpu_torch.cli rtm     par=input.dat
    python -m parallel_finite_difference_computation_tpu_torch.cli rtm_gpu ./models/<m>/input.dat

``stencil`` replaces ``stencil_code`` (``cuda_reference_stencil_computation``),
``mod`` replaces ``mod_main`` and ``rtm`` replaces ``rtm_main`` (both
``dpct_gpu_rtm_domain_division``), ``rtm_gpu`` replaces ``rtm_code``
(``cuda_reference_RTM``). ``par=file`` and bare config paths are both
accepted. ``--device`` picks where the work runs (default ``cuda``: the
CUDA kernels, built with ``nvcc`` at first use; ``cpu`` runs the plain
torch version). ``mod`` and ``rtm_gpu`` take ``--backend``: ``pallas`` (the
per-step kernels), ``tiled`` (the large-grid tier of K-step passes) or
``auto`` (the default: ``tiled`` above 1.5 M extended cells, such as the
Pluto grid). ``mod``, ``rtm_gpu`` and ``rtm`` take ``--shards-shot S``,
``--shards-x X`` and ``--shards-z Z``: the shots split over S groups and,
for ``mod`` and ``rtm_gpu``, the grid into X x-slabs or, with Z > 1, into
X x Z tiles (``rtm`` takes X = Z = 1 only). With ``--device cpu`` every
position of the mesh is the CPU; with ``cuda`` the mesh takes the visible
cards, and too few raise. The JAX package's ``psnr`` and ``laplace`` tools
and its checkpointed surveys (``--checkpoint-dir``, ``--chunk-shots``) are
still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import time

from . import pipeline
from .config import parse_input_dat
from .parallel import make_mesh


def _config_arg(arg: str) -> str:
    return arg.split("=", 1)[1] if arg.startswith("par=") else arg


def _echo(p):
    print(f"## vp = {p.vpfile} \n## nz = {p.nz}, nx = {p.nx}, nt = {p.nt} ")
    print(f"## dz = {p.dz}, dx = {p.dx}, dt = {p.dt} ")
    print(f"## ns = {p.ns}, sz = {p.sz}, fsx = {p.fsx}, ds = {p.ds}, gz = {p.gz} ")
    print(f"## order = {p.order}, nzb = {p.nzb}, nxb = {p.nxb}, F = {p.fac} ")


def _mesh(args):
    """The mesh of ``--shards-shot``/``--shards-x``/``--shards-z``, or None
    for none of them."""
    n = args.shards_shot * args.shards_x * args.shards_z
    if n == 1:
        return None
    devices = [args.device] * n if args.device == "cpu" else None
    return make_mesh(args.shards_shot, args.shards_x, args.shards_z,
                     devices=devices)


def cmd_stencil(args):
    p = parse_input_dat(_config_arg(args.config))
    out = args.output or "output_tpu.bin"
    t0 = time.time()
    lap = pipeline.run_stencil(p, output_path=out, device=args.device)
    print(f"Laplacian {lap.shape} written to {out} "
          f"({time.time() - t0:.3f}s incl. build)")


def cmd_mod(args):
    p = parse_input_dat(_config_arg(args.config))
    _echo(p)
    out = args.output or p.datfile or "dobs.bin"
    t0 = time.time()
    data = pipeline.run_modeling(p, out_datfile=out, device=args.device,
                                 backend=args.backend, mesh=_mesh(args),
                                 lap_impl=args.lap_impl)
    print(f"> Exec time = {time.time() - t0:.2f} (s)")
    print(f"wrote {data.shape} shot gathers to {out}")


def cmd_rtm(args):
    p = parse_input_dat(_config_arg(args.config))
    _echo(p)
    outdir = args.outdir or (p.tmpdir if p.tmpdir and os.path.isdir(p.tmpdir)
                             else ".")
    t0 = time.time()
    pipeline.run_rtm_cpu(p, outdir=outdir, device=args.device,
                         mesh=_mesh(args))
    print(f"Execution Time: {time.time() - t0:.2f} seconds")
    print(f"wrote dir.image / dir.img to {outdir}")


def cmd_rtm_gpu(args):
    p = parse_input_dat(_config_arg(args.config))
    _echo(p)
    outdir = args.outdir or (p.tmpdir if p.tmpdir and os.path.isdir(p.tmpdir)
                             else ".")
    t0 = time.time()
    pipeline.run_rtm_gpu(p, seed=args.seed, outdir=outdir,
                         write_image_num=args.image_num, device=args.device,
                         backend=args.backend, mesh=_mesh(args),
                         lap_impl=args.lap_impl)
    print(f"> Exec time = {time.time() - t0:.2f} (s)")
    print(f"wrote dir.image to {outdir}"
          + (" (+ image.num)" if args.image_num else ""))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pfdc-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("stencil", cmd_stencil), ("mod", cmd_mod),
                     ("rtm", cmd_rtm), ("rtm_gpu", cmd_rtm_gpu)):
        s = sub.add_parser(name)
        s.add_argument("config", help="input.dat path or par=path")
        s.add_argument("--output", default=None)
        s.add_argument("--outdir", default=None)
        s.add_argument("--device", default="cuda",
                       help="torch device: cuda (the CUDA kernels) or cpu "
                            "(the plain torch version)")
        if name != "stencil":
            s.add_argument("--shards-shot", type=int, default=1,
                           dest="shards_shot",
                           help="shot groups of the mesh (default 1)")
            s.add_argument("--shards-x", type=int, default=1,
                           dest="shards_x",
                           help="x-slabs of the grid (default 1); > 1 runs "
                                "the block kernels of the x-domain tier")
            s.add_argument("--shards-z", type=int, default=1,
                           dest="shards_z",
                           help="z parts of the grid (default 1); > 1 cuts "
                                "it into (x, z) tiles on the block kernels "
                                "of the (x, z) tier")
        if name in ("mod", "rtm_gpu"):
            s.add_argument("--backend", default="auto",
                           choices=list(pipeline.BACKENDS),
                           help="pallas: the per-step kernels; tiled: the "
                                "K-step passes of the large-grid tier; auto: "
                                "tiled above 1.5 M extended cells")
            s.add_argument("--lap-impl", default=None, dest="lap_impl",
                           choices=["auto", "vpu", "mxu", "mxu6"],
                           help="Laplacian: the exact taps (vpu, the "
                                "default), split-bf16 tensor-core tiers "
                                "(mxu: 3 passes, mxu6: 6), or auto (mxu for "
                                "nt <= 1500 and dx == dz, mxu6 for nt <= "
                                "4500, else vpu). Every tier on the card "
                                "runs all of them; the domain tiers on CPU "
                                "devices keep the exact taps, as the JAX "
                                "package does there")
        if name == "rtm_gpu":
            s.add_argument("--seed", type=int, default=0)
            s.add_argument("--image-num", action="store_true",
                           dest="image_num")
        s.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
