"""Application pipelines: the reference's four programs as library calls.

* :func:`run_stencil`: the one-shot Laplacian program
  (``cuda_reference_stencil_computation/fd-source-code.cu:277-352``).
* :func:`run_modeling`: synthetic shot gathers, ``mod_main``
  (``dpct_gpu_rtm_domain_division/src/mod_main.cpp:42-208``).
* :func:`run_rtm_cpu`: full-wavefield-storage RTM, ``rtm_main``
  (``src/rtm_main.cpp:45-282``).
* :func:`run_rtm_gpu`: two-snapshot RTM with random (or file-loaded)
  boundary velocities, ``rtm_code`` (``cuda_reference_RTM/src/fd-code.cu:380-584``).

Every entry point takes ``device=``, ``"cuda"`` unless the caller asks for
the CPU. On a CUDA device the shots run in batches through the CUDA kernels
(:mod:`.ops.fd_kernels`, :mod:`.ops.stream`); on the CPU they run through
the plain torch version. ``run_modeling``, ``run_rtm_gpu`` and
``run_rtm_cpu`` choose their tier explicitly with ``backend``
(:func:`resolve_backend`): the per-step kernels (``"pallas"``) or the
large-grid tier at up to ``TILED_BLOCK_K`` steps a pass (``"tiled"``, the
largest K whose tiles fit a block's shared memory); ``"auto"`` decides by
the grid's size alone. There is no
fallback between tiers, and without CUDA a default call raises torch's own
error.

With ``mesh=`` (:func:`.parallel.make_mesh`) the mesh's devices say where
the work runs: a shot-only mesh splits the shots over its shot axis, each
group on the tiers above (:mod:`.parallel.shots`); a mesh whose x axis is
> 1 also cuts the grid into x-slabs, and a (shot, x, z) mesh whose z axis
is > 1 into (x, z) tiles, for ``run_modeling`` and ``run_rtm_gpu``: K steps
a block on the block kernels (:mod:`.parallel.domain_kernels`,
:mod:`.parallel.domain2d_kernels`), or, on a mesh of CPU devices only, one
step at a time on the plain per-step loops (:mod:`.parallel.domain`,
:mod:`.parallel.domain2d`, as the JAX package runs its lax makers off the
TPU). Not ported yet (ROADMAP.md): ``run_rtm_cpu`` over a domain mesh and
the checkpointed survey.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import io, numerics
from .config import Params, Geometry
from .ops.fd_kernels import (forward_modeling_cuda, laplacian_cuda,
                             largest_fitting_k, lap_parts,
                             resolve_lap_impl, rtm_full_cuda,
                             rtm_snapshot_cuda)
from .ops.stream import MAX_STEPS, TILED_BLOCK_K, tiled_block_k
from .solver import (FDContext, forward_modeling_tiled, rtm_shot_full_tiled,
                     rtm_shot_snapshot_tiled)

__all__ = ["run_stencil", "run_modeling", "run_rtm_cpu", "run_rtm_gpu",
           "prepare_velocity_cpu", "prepare_velocities_gpu",
           "resolve_backend", "BACKENDS"]

BACKENDS = ("auto", "pallas", "tiled")
# backend="auto" takes the large-grid tier above this many extended cells:
# the one size rule the JAX package states (_tiled_rtm_wins, its
# pipeline.py:324-331). 3lay (231 x 231, 53 K cells) keeps the per-step
# kernels; Pluto (7040 x 1281, 9.0 M cells) takes the tiled tier.
TILED_MIN_CELLS = 1_500_000

# Device budget of one shot batch of run_modeling and run_rtm_gpu. A shot
# holds, besides its velocity plane (all shots' planes are drawn first, in
# shot order, so that the results do not depend on the batch size): for
# modeling 4 field planes (the state and a pass's outputs) and its
# seismogram twice (as recorded, and transposed for the host); for
# rtm_gpu 12 planes (v2*dt2, the two snapshots, the four backward fields
# and a pass's four outputs, and the forward pair) and its gather twice
# (as given, and time-reversed). At Pluto (36.1 MB a plane, gathers of
# 6960 x 12860 floats, 358 MB) that is 0.86 GB a modeling shot and 1.15 GB
# an RTM shot: 16 GiB, a fifth of the H100's 80 GB, holds 19 and 14 of
# them and leaves room for the allocator's freed pass buffers.
_SHOT_BATCH_BYTES = 16 << 30


def resolve_backend(backend: str, nxe: int, nze: int) -> str:
    """The tier ``backend`` selects for an nxe x nze extended grid:
    ``"pallas"`` (the per-step kernels) or ``"tiled"`` (the K-step passes
    of the large-grid tier). ``"auto"`` is ``"tiled"`` above
    ``TILED_MIN_CELLS`` cells."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if backend == "auto":
        return "tiled" if nxe * nze > TILED_MIN_CELLS else "pallas"
    return backend


def _batch_shots(p: Params, planes: int, traces: int) -> int:
    """Shots per batch under ``_SHOT_BATCH_BYTES``: each holds ``planes``
    (nxe, nze) planes and ``traces`` (nx, nt) gathers of float32."""
    per_shot = 4 * (planes * p.nxe * p.nze + traces * p.nx * p.nt)
    return max(1, _SHOT_BATCH_BYTES // per_shot)

# Device budget for one batch of run_rtm_cpu's stored source wavefields,
# ns * nt * nx * nz float32: one 3lay shot holds 91 MB, one marmousi-size
# shot (449 x 455, nt=3004) 2.5 GB. The kernels keep this one volume; the
# plain version holds it three times over (the source and receiver
# wavefields and their product), which 16 GiB keeps inside an 80 GB card.
_RTM_BATCH_BYTES = 16 << 30


def run_stencil(p: Params, input_path: Optional[str] = None,
                output_path: Optional[str] = None, *,
                device="cuda") -> np.ndarray:
    """Single-launch Laplacian of an (nxe, nze) field read from
    ``input_path``, or from ``p.tmpdir``, which the stencil program abuses
    as its data path (``fd-source-code.cu:43-50``). Returns the host
    Laplacian (zero border of width order/2) and, with ``output_path``,
    writes it raw float32 like ``output_cuda.bin``."""
    field = io.read_velocity(input_path or p.tmpdir, p.nxe, p.nze)
    cx, cz = numerics.scaled_coefficients(p.order, p.dx, p.dz)
    lap = laplacian_cuda(torch.from_numpy(field).to(device), cx, cz,
                         p.order).cpu().numpy()
    if output_path:
        io.write_f32(output_path, lap)
    return lap


def prepare_velocity_cpu(p: Params, vp: np.ndarray) -> np.ndarray:
    """CPU-pipeline velocity prep (``mod_main.cpp:118-126``): square the
    interior into the extended grid, then clamp-extend the *squared* field.
    Returns a host (nxe, nze) float32 array."""
    vel2 = np.zeros((p.nxe, p.nze), np.float32)
    vel2[p.nxb:p.nxb + p.nx, p.nzb:p.nzb + p.nz] = vp * vp
    return numerics.extendvel_clamp(vel2, p.nx, p.nz, p.nxb, p.nzb)


def prepare_velocities_gpu(p: Params, vp: np.ndarray, *, device,
                           seed: int = 0,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """GPU-suite per-shot velocity prep (``fd-code.cu:442-494``): embed vp in
    the extended grid, then per shot either load the pre-extended model from
    ``vel_ext_file`` (the parity path) or draw the random linear-ramp
    boundary on ``device`` (:func:`..numerics.extendvel_random_torch`), in
    shot order from ``generator`` (default: a new one on ``device`` seeded
    with ``seed``); square last. Returns (ns, nxe, nze) squared velocities
    on ``device``."""
    device = torch.device(device)
    if p.vel_ext_flag:
        vpe = io.read_vel_ext(p.vel_ext_file, p.ns, p.nxe, p.nze)
        return torch.from_numpy((vpe * vpe).astype(np.float32)).to(device)
    base = np.zeros((p.nxe, p.nze), np.float32)
    base[p.nxb:p.nxb + p.nx, p.nzb:p.nzb + p.nz] = vp
    base_t = torch.from_numpy(base).to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    ext = torch.stack([
        numerics.extendvel_random_torch(base_t, p.nx, p.nz, p.nxb, p.nzb,
                                        generator)
        for _ in range(p.ns)])
    return ext * ext


def _mesh_decomposes_grid(mesh) -> bool:
    """True when the mesh's x or z axis is > 1: a domain tier applies."""
    return mesh.shape.get("x", 1) > 1 or mesh.shape.get("z", 1) > 1


def _mesh_cuts_z(mesh) -> bool:
    """True when the mesh's z axis is > 1: the (x, z) tier applies."""
    return mesh.shape.get("z", 1) > 1


def _mesh_shots(mesh) -> int:
    return 1 if mesh is None else mesh.shape["shot"]


def run_modeling(p: Params, vp: Optional[np.ndarray] = None,
                 out_datfile: Optional[str] = None, *, device="cuda",
                 backend: str = "auto", mesh=None,
                 lap_impl=None) -> np.ndarray:
    """``mod_main``: model all shots on ``device``, in batches under
    ``_SHOT_BATCH_BYTES``, through the tier ``backend`` selects
    (:func:`resolve_backend`); return the (ns, nx, nt) gathers and
    optionally write the raw ``datfile`` blob the RTM programs read.

    The Gaussian source (a 7 x 7 patch) must lie at least 3 cells inside
    the extended grid: a border ``nxb``, ``nzb`` of 2 with the source on the
    grid's first row or column (``fsx = 0``, ``sz = 0``) raises
    ``ValueError`` on every device. The JAX package shifts the patch there
    and the reference clips it (``ptsrc.c``); neither is reproduced.

    With a ``mesh`` its devices run the work: the shots split over its
    shot axis; an x axis > 1 decomposes the grid into x-slabs, a z axis > 1
    into (x, z) tiles, on the block kernels (``backend`` is then not read),
    with blocks of K = ``max(1, min(8, (nxe // n_x) // h, (nze // n_z) //
    h, nt))`` steps (the z term on a z axis > 1 only), or on a mesh of CPU
    devices one step at a time (:func:`_modeling_domain`).

    ``lap_impl`` selects the Laplacian as in the JAX package
    (:func:`.ops.fd_kernels.resolve_lap_impl`): the exact taps (None,
    ``"vpu"``), the split-bf16 tensor-core tiers ``"mxu"`` (3 passes) and
    ``"mxu6"`` (6), or ``"auto"``, which takes ``"mxu"`` for nt <= 1500 on
    a grid with dx == dz (3lay), ``"mxu6"`` for nt <= 4500, else the exact
    taps (Pluto at its nt = 12860). The per-step tier (``backend="pallas"``,
    with or without a shot-only mesh) runs every value, through
    ``mod_step_mma`` where it resolves to a split tier (the x taps in bf16
    parts), and so does the large-grid tier (``"tiled"``, K =
    :func:`.ops.stream.tiled_block_k`), through ``kstep_mod_mma`` (the z
    taps in bf16 parts, as the JAX K-step kernels split them), and so do
    the domain tiers on the card, through ``block_mod_mma`` or
    ``block2_mod_mma`` (the x taps in bf16 parts, as the JAX block kernels
    split them). On a mesh of CPU devices the domain tiers run the
    per-step loops with the exact taps whatever ``lap_impl`` says, as the
    JAX package's lax domain path does on the CPU."""
    tier = resolve_backend(backend, p.nxe, p.nze)
    if vp is None:
        vp = io.read_velocity(p.vpfile, p.nx, p.nz)
    vel2 = torch.from_numpy(prepare_velocity_cpu(p, vp))
    ctx = FDContext.from_params(p, exact_taper=False)
    g = Geometry.from_params(p)
    wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)
    if mesh is not None and _mesh_decomposes_grid(mesh):
        run = _modeling_domain(ctx, g, mesh, lap_impl)
    elif mesh is not None:
        from .parallel import shots
        make = (shots.make_sharded_modeling_tiled if tier == "tiled"
                else shots.make_sharded_modeling_cuda)
        run = make(ctx, mesh, g.sz, g.gz, lap_impl=lap_impl)
    else:
        vel2 = vel2.to(device)
        k = tiled_block_k(ctx, ("kstep_mod",), lap_impl)
        fwd, kw = ((forward_modeling_tiled, {"block_k": k})
                   if tier == "tiled" else (forward_modeling_cuda, {}))
        run = lambda v2, sxs, wav: fwd(ctx, v2, wav, sxs, g.sz, g.gz,
                                       lap_impl=lap_impl, **kw)[2]
    per = _batch_shots(p, planes=4, traces=2) * _mesh_shots(mesh)
    parts = []
    for s0 in range(0, p.ns, per):
        seis = run(vel2, g.sx[s0:s0 + per], wav)
        parts.append(seis.transpose(1, 2).contiguous().cpu().numpy())
    data = np.concatenate(parts, axis=0)                  # (ns, nx, nt)
    if out_datfile:
        io.write_f32(out_datfile, data)
    return data


def _mesh_on_cpu(mesh) -> bool:
    """True when every position of the mesh is the CPU."""
    return all(d.type == "cpu" for d in mesh.devices.flat)


def _block_k(ctx, mesh, limit: int, kernels, lap_impl) -> int:
    """The JAX pipelines' block size of the domain tiers (its
    pipeline.py:278, :298-299, :652, :666-668): ``min(8, (nxe // n_x) //
    h, (nze // n_z) // h, limit)``, the z term on a z axis > 1 only, or
    below it the largest K whose tiles of ``kernels`` (the block kernels
    the run launches, under ``lap_impl``) fit a block's shared memory
    (orders above 10: :func:`..ops.fd_kernels.largest_fitting_k`)."""
    h = ctx.order // 2
    parts = [(ctx.nxe // mesh.shape["x"]) // h]
    if _mesh_cuts_z(mesh):
        parts.append((ctx.nze // mesh.shape["z"]) // h)
    k = min(MAX_STEPS, *parts, limit)
    if k < 2:
        return k
    return largest_fitting_k(kernels, ctx.order, k, lap_parts(lap_impl, ctx))


def _modeling_domain(ctx, g, mesh, lap_impl):
    """``run(v2, sxs, wav) -> (ns, nt, nx)`` traces of the x- or (x, z)-
    domain tier (the JAX package's ``_run_modeling_domain``, its
    pipeline.py:268-321): the block kernels with K = ``max(1,``
    :func:`_block_k` ``(nt))``, their ``*_mma`` twins where ``lap_impl``
    resolves to a split tier, or the per-step loops on a CPU mesh, which
    keep the exact taps: the JAX package runs its lax domain path there
    (``_use_pallas`` is False on the CPU) and that path ignores
    ``lap_impl``. A tile too small for even K = 1 (fewer than h owned rows
    or columns) raises on every mesh, before anything runs."""
    from .parallel import (domain, domain2d, domain_kernels as dk,
                           domain2d_kernels as d2k)
    resolve_lap_impl(ctx, lap_impl)      # an unknown value raises on any mesh
    two_d = _mesh_cuts_z(mesh)
    block_k = max(1, _block_k(ctx, mesh, ctx.nt, ("block_mod",),
                              lap_impl))
    if two_d:
        d2k.tile_geometry(ctx, mesh.shape["x"], mesh.shape["z"], block_k)
    if _mesh_on_cpu(mesh):
        make = (domain2d.make_sharded_forward_modeling_2d if two_d
                else domain.make_sharded_forward_modeling)
        fn = make(ctx, mesh, g.gz, source="gaussian", taper="all")
        srcf = lambda sxs: domain.embed_source_fields(ctx, sxs, g.sz,
                                                      gaussian=True)
    else:
        make = (d2k.make_sharded_forward_modeling_2d_cuda if two_d
                else dk.make_sharded_forward_modeling_cuda)
        fn = make(ctx, mesh, g.sz, g.gz, source="gaussian", taper="all",
                  block_k=block_k, lap_impl=lap_impl)
        srcf = lambda sxs: sxs
    return lambda v2, sxs, wav: fn(v2, srcf(sxs), wav)[
        :, :, ctx.nxb:ctx.nxb + ctx.nx]


def run_rtm_cpu(p: Params, vp: Optional[np.ndarray] = None,
                dobs: Optional[np.ndarray] = None,
                outdir: Optional[str] = None, *, device="cuda", mesh=None,
                backend: str = "auto", shot_indices=None):
    """``rtm_main``: migrate the shots with full-wavefield storage on
    ``device``, in batches whose stored source wavefields fit
    ``_RTM_BATCH_BYTES``, through the tier ``backend`` selects
    (:func:`resolve_backend`): ``"pallas"`` runs ``rtm_full_cuda``,
    ``"tiled"`` runs :func:`..solver.rtm_shot_full_tiled` at
    ``TILED_BLOCK_K``. At K >= 2 both tiers run the ``rec_step`` kernels on
    the card (``rec_fwd_step``, ``rec_bwd_step``), the port of the kernel
    the JAX tiled tier runs (``_kstep_rec_kernel``); at K = 1 the tiled
    tier runs ``fd_step``.

    The Laplacian follows the JAX package's tiers: ``"pallas"`` stands for
    its lax ``rtm_shot_full``, which has the exact taps only, so it runs
    them whatever ``PFDC_LAP_IMPL`` says; ``"tiled"`` resolves the
    ``PFDC_LAP_IMPL`` snapshot (``lap_impl=None``, as the JAX tiled tier
    does) and runs the ``*_mma`` twins under a split tier.

    Returns host ``(img, imlocs)``: the stacked (nx, nz) image and the
    (ns, nx, nz) per-shot images. With ``outdir``, writes ``dir.image``
    (stack) and ``dir.img`` (the per-shot images one after another), as
    ``rtm_main.cpp:232,247`` does.

    ``shot_indices`` migrates only the given *global* shot indices
    (``dobs`` stays the full survey's gathers). Each shot's it=0 flat-read
    sample (``rtm_main.cpp:202``) is the first sample of its successor in
    the full survey (0 for the last), worked out before the subset is
    taken, so a subset reproduces those shots of the whole run.

    With a shot-only ``mesh`` the shots split over its shot axis, each
    group on the selected tier on its device. An x or z axis > 1,
    ``rtm_main`` over a decomposed grid, is still to be ported and
    raises."""
    if mesh is not None and _mesh_decomposes_grid(mesh):
        raise NotImplementedError(
            "run_rtm_cpu over a mesh whose x or z axis is > 1 (rtm_main's "
            "domain tiers, make_sharded_rtm_full and make_sharded_rtm_full_"
            "2d) is still to be ported (see ROADMAP.md, Queue 1, \"rtm_main "
            "over a decomposed grid\"); use a shot-only mesh")
    tier = resolve_backend(backend, p.nxe, p.nze)
    if vp is None:
        vp = io.read_velocity(p.vpfile, p.nx, p.nz)
    if dobs is None:
        dobs = io.read_shot_gathers(p.datfile, p.ns, p.nx, p.nt)
    vel2 = torch.from_numpy(prepare_velocity_cpu(p, vp))
    ctx = FDContext.from_params(p, exact_taper=False)
    g = Geometry.from_params(p)
    wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)

    idx = (np.arange(p.ns) if shot_indices is None
           else np.asarray(shot_indices, np.int64))
    dobs_full = np.asarray(dobs, np.float32)
    nxt_full = np.concatenate([dobs_full[1:, 0, 0], np.zeros(1, np.float32)])
    sx_sel = np.asarray(g.sx, np.int64)[idx]
    dobs_sel = dobs_full[idx]
    nxt = nxt_full[idx]

    if mesh is not None:
        from .parallel import shots
        make = (shots.make_sharded_rtm_full_tiled if tier == "tiled"
                else shots.make_sharded_rtm_full_cuda)
        sharded = make(ctx, mesh, g.sz, g.gz)
        run = lambda d, sxs, nx1: sharded(vel2, d, sxs, nx1, wav)
    else:
        vel2 = vel2.to(device)
        rtm, kw = ((rtm_shot_full_tiled, {"block_k": TILED_BLOCK_K})
                   if tier == "tiled"
                   else (rtm_full_cuda, {"lap_impl": "vpu"}))
        run = lambda d, sxs, nx1: rtm(
            ctx, vel2, wav, d.to(device), sxs, g.sz, g.gz,
            next_shot_first=nx1, **kw)
    per = max(1, int(_RTM_BATCH_BYTES // (p.nt * p.nx * p.nz * 4)))
    per *= _mesh_shots(mesh)
    parts = []
    for s0 in range(0, len(idx), per):
        b = slice(s0, s0 + per)
        d = torch.from_numpy(np.ascontiguousarray(dobs_sel[b]))
        parts.append(run(d, sx_sel[b], nxt[b]).cpu().numpy())
    imlocs = np.concatenate(parts, axis=0)
    img = imlocs.sum(axis=0)
    if outdir:
        io.write_image(os.path.join(outdir, "dir.image"), img)
        io.write_f32(os.path.join(outdir, "dir.img"), imlocs)
    return img, imlocs


def run_rtm_gpu(p: Params, vp: Optional[np.ndarray] = None,
                dobs: Optional[np.ndarray] = None,
                seed: int = 0, outdir: Optional[str] = None,
                write_image_num: bool = False, *, device="cuda",
                generator: Optional[torch.Generator] = None,
                backend: str = "auto", mesh=None, lap_impl=None):
    """``rtm_code``: two-snapshot RTM of all shots on ``device``, with random
    (``seed``/``generator``) or file-loaded boundary velocities, in batches
    under ``_SHOT_BATCH_BYTES``, through the tier ``backend`` selects
    (:func:`resolve_backend`). Every shot's boundary is drawn first, in
    shot order, so the images do not depend on the batch size.

    Returns host ``(img, imlocs)``: the stacked (nx, nz) image and the
    (ns, nx, nz) per-shot images. With ``outdir``, writes ``dir.image``,
    ``dir.image_lap`` (zeros, as the reference leaves it,
    ``fd-code.cu:542``) and optionally the ``image.num`` text dump
    (``fd-code.cu:522-528``).

    With a ``mesh`` its devices run the work (the boundaries are drawn on
    its first device): the shots split over its shot axis; an x axis > 1
    decomposes the grid into x-slabs, a z axis > 1 into (x, z) tiles, on
    the block kernels (``backend`` is then not read), with blocks of K =
    ``min(8, (nxe // n_x) // h, (nze // n_z) // h, nt // 2)`` steps (the z
    term on a z axis > 1 only), which must be >= 2, or on a mesh of CPU
    devices one step at a time (:func:`_rtm_gpu_domain`).

    ``lap_impl`` as in :func:`run_modeling`: the per-step tier runs every
    value (``rtm_fwd_step_mma`` and ``rtm_bwd_step_mma`` for a resolved
    ``"mxu"``/``"mxu6"``), the large-grid tier too (``kstep_gpu_fwd_mma``,
    ``gpu_step_mma`` and ``kstep_gpu_bwd_mma``), and the domain tiers on
    the card (``block_fwd_mma`` and ``block_bwd_mma``, or their ``block2_``
    twins); on a CPU mesh they keep the exact taps, as in
    :func:`run_modeling`."""
    tier = resolve_backend(backend, p.nxe, p.nze)
    if vp is None:
        vp = io.read_velocity(p.vpfile, p.nx, p.nz)
    if dobs is None:
        dobs = io.read_shot_gathers(p.datfile, p.ns, p.nx, p.nt)
    ctx = FDContext.from_params(p, exact_taper=True)
    g = Geometry.from_params(p)
    if mesh is not None and _mesh_decomposes_grid(mesh):
        run = _rtm_gpu_domain(ctx, g, mesh, lap_impl)
    elif mesh is not None:
        from .parallel import shots
        make = (shots.make_sharded_rtm_tiled if tier == "tiled"
                else shots.make_sharded_rtm_cuda)
        run = make(ctx, mesh, g.sz, g.gz, lap_impl=lap_impl)
    else:
        k = tiled_block_k(ctx, ("kstep_gpu_fwd", "kstep_gpu_bwd"), lap_impl)
        rtm, kw = ((rtm_shot_snapshot_tiled, {"block_k": k})
                   if tier == "tiled" else (rtm_snapshot_cuda, {}))
        run = lambda v2, d, sxs, wav: rtm(ctx, v2, wav, d.to(device), sxs,
                                          g.sz, g.gz, lap_impl=lap_impl, **kw)
    vel2 = prepare_velocities_gpu(
        p, vp, device=device if mesh is None else mesh.lead(),
        seed=seed, generator=generator)
    wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak)
    dobs = np.asarray(dobs, np.float32)
    per = _batch_shots(p, planes=12, traces=2) * _mesh_shots(mesh)
    parts = []
    for s0 in range(0, p.ns, per):
        b = slice(s0, s0 + per)
        d = torch.from_numpy(np.ascontiguousarray(dobs[b]))
        parts.append(run(vel2[b], d, g.sx[b], wav).cpu().numpy())
    imlocs = np.concatenate(parts, axis=0)
    img = imlocs.sum(axis=0)
    _write_rtm_gpu_outputs(outdir, img, imlocs, write_image_num)
    return img, imlocs


def _write_rtm_gpu_outputs(outdir, img, imlocs, write_image_num):
    if not outdir:
        return
    io.write_image(os.path.join(outdir, "dir.image"), img)
    io.write_image(os.path.join(outdir, "dir.image_lap"),
                   np.zeros_like(img))
    # the reference opens these snapshot files but never writes them
    # (fd-code.cu:466-470)
    for fname in ("dir.snaps", "dir.snaps_rec", "dir.snapr"):
        open(os.path.join(outdir, fname), "w").close()
    if write_image_num:
        io.write_image_num(os.path.join(outdir, "image.num"),
                           list(np.cumsum(imlocs, axis=0)))


def _rtm_gpu_domain(ctx, g, mesh, lap_impl):
    """``run(v2, dobs, sxs, wav) -> (ns, nx, nz)`` images of the x- or
    (x, z)-domain tier (the JAX package's ``_run_rtm_gpu_domain``, its
    pipeline.py:632-685): the block kernels with K = :func:`_block_k`
    ``(nt // 2)``, their ``*_mma`` twins where ``lap_impl`` resolves to a
    split tier, or the per-step loops with the exact taps on a CPU mesh,
    as in :func:`_modeling_domain`. K < 2 raises on every mesh, so that a
    CPU run meets the card's limits."""
    from .parallel import (domain, domain2d, domain_kernels as dk,
                           domain2d_kernels as d2k)
    resolve_lap_impl(ctx, lap_impl)      # an unknown value raises on any mesh
    two_d = _mesh_cuts_z(mesh)
    block_k = _block_k(ctx, mesh, ctx.nt // 2, ("block_fwd", "block_bwd"),
                       lap_impl)
    if block_k < 2:
        raise NotImplementedError(
            f"the domain RTM needs blocks of K >= 2 steps, this grid and "
            f"mesh give K={block_k} (nxe={ctx.nxe}, nze={ctx.nze}, mesh "
            f"{mesh.shape}, nt={ctx.nt}); the JAX package's per-step "
            f"fallback on the card is not ported (see ROADMAP.md, Queue 1, "
            f"\"rtm_main over a decomposed grid\"): use fewer x or z shards")
    if _mesh_on_cpu(mesh):
        run = (domain2d.make_sharded_rtm_snapshot_2d if two_d
               else domain.make_sharded_rtm_snapshot)(ctx, mesh, g.gz)
        fn = lambda v2, sxs, wav, d_ext: run(
            v2, domain.embed_source_fields(ctx, sxs, g.sz), wav, d_ext)
    else:
        make = (d2k.make_sharded_rtm_snapshot_2d_cuda if two_d
                else dk.make_sharded_rtm_snapshot_cuda)
        fn = make(ctx, mesh, g.sz, g.gz, block_k=block_k, lap_impl=lap_impl)
    return lambda v2, d, sxs, wav: fn(v2, sxs, wav, domain.embed_dobs(
        ctx, d.numpy()))[:, ctx.nxb:ctx.nxe - ctx.nxb,
                         ctx.nzb:ctx.nze - ctx.nzb]
