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
(:mod:`.ops.fd_kernels`); on the CPU they run through the plain torch
version. The path is chosen by the device and nothing else: there is no
fallback between tiers, and without CUDA a default call raises torch's own
error.

Not ported yet (ROADMAP.md): the mesh and domain-decomposed branches, the
``backend`` choice, the host chunking of large gathers, and the
checkpointed survey.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import io, numerics
from .config import Params, Geometry
from .ops.fd_kernels import (forward_modeling_cuda, laplacian_cuda,
                             rtm_full_cuda, rtm_snapshot_cuda)
from .solver import FDContext

__all__ = ["run_stencil", "run_modeling", "run_rtm_cpu", "run_rtm_gpu",
           "prepare_velocity_cpu", "prepare_velocities_gpu"]

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


def run_modeling(p: Params, vp: Optional[np.ndarray] = None,
                 out_datfile: Optional[str] = None, *, device="cuda",
                 lap_impl=None) -> np.ndarray:
    """``mod_main``: model all shots as one batch on ``device``; return the
    (ns, nx, nt) gathers and optionally write the raw ``datfile`` blob the
    RTM programs read."""
    if vp is None:
        vp = io.read_velocity(p.vpfile, p.nx, p.nz)
    vel2 = torch.from_numpy(prepare_velocity_cpu(p, vp)).to(device)
    ctx = FDContext.from_params(p, exact_taper=False)
    g = Geometry.from_params(p)
    wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)
    _, _, seis = forward_modeling_cuda(ctx, vel2, wav, g.sx, g.sz, g.gz,
                                       source="gaussian", taper="all",
                                       lap_impl=lap_impl)
    data = seis.transpose(1, 2).contiguous().cpu().numpy()   # (ns, nx, nt)
    if out_datfile:
        io.write_f32(out_datfile, data)
    return data


def run_rtm_cpu(p: Params, vp: Optional[np.ndarray] = None,
                dobs: Optional[np.ndarray] = None,
                outdir: Optional[str] = None, *, device="cuda",
                shot_indices=None):
    """``rtm_main``: migrate the shots with full-wavefield storage on
    ``device``, in batches whose stored source wavefields fit
    ``_RTM_BATCH_BYTES``.

    Returns host ``(img, imlocs)``: the stacked (nx, nz) image and the
    (ns, nx, nz) per-shot images. With ``outdir``, writes ``dir.image``
    (stack) and ``dir.img`` (the per-shot images one after another), as
    ``rtm_main.cpp:232,247`` does.

    ``shot_indices`` migrates only the given *global* shot indices
    (``dobs`` stays the full survey's gathers). Each shot's it=0 flat-read
    sample (``rtm_main.cpp:202``) is the first sample of its successor in
    the full survey (0 for the last), worked out before the subset is
    taken, so a subset reproduces those shots of the whole run."""
    if vp is None:
        vp = io.read_velocity(p.vpfile, p.nx, p.nz)
    if dobs is None:
        dobs = io.read_shot_gathers(p.datfile, p.ns, p.nx, p.nt)
    vel2 = torch.from_numpy(prepare_velocity_cpu(p, vp)).to(device)
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

    per = max(1, int(_RTM_BATCH_BYTES // (p.nt * p.nx * p.nz * 4)))
    parts = []
    for s0 in range(0, len(idx), per):
        b = slice(s0, s0 + per)
        d = torch.from_numpy(np.ascontiguousarray(dobs_sel[b])).to(device)
        parts.append(rtm_full_cuda(ctx, vel2, wav, d, sx_sel[b], g.sz, g.gz,
                                   next_shot_first=nxt[b]).cpu().numpy())
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
                lap_impl=None):
    """``rtm_code``: two-snapshot RTM of all shots as one batch on
    ``device``, with random (``seed``/``generator``) or file-loaded
    boundary velocities.

    Returns host ``(img, imlocs)``: the stacked (nx, nz) image and the
    (ns, nx, nz) per-shot images. With ``outdir``, writes ``dir.image``,
    ``dir.image_lap`` (zeros, as the reference leaves it,
    ``fd-code.cu:542``) and optionally the ``image.num`` text dump
    (``fd-code.cu:522-528``)."""
    if vp is None:
        vp = io.read_velocity(p.vpfile, p.nx, p.nz)
    if dobs is None:
        dobs = io.read_shot_gathers(p.datfile, p.ns, p.nx, p.nt)
    vel2 = prepare_velocities_gpu(p, vp, device=device, seed=seed,
                                  generator=generator)
    ctx = FDContext.from_params(p, exact_taper=True)
    g = Geometry.from_params(p)
    wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak)
    d = torch.from_numpy(np.ascontiguousarray(dobs, np.float32)).to(device)
    imlocs = rtm_snapshot_cuda(ctx, vel2, wav, d, g.sx, g.sz, g.gz,
                               lap_impl=lap_impl).cpu().numpy()
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
