"""Shot parallelism over a mesh: the port's counterpart of the JAX package's
``parallel/shots.py``.

Shots are independent given their velocities, so a shot-batched
computation splits over the mesh's ``shot`` axis with no communication
until the results are joined. Each shot group runs on the device of its
row of the mesh (its first grid position, :meth:`.Mesh.lead`) through the
tiers that already exist: the per-step kernels, the large-grid tier, or
``rtm_main``'s ``rtm_full_cuda``. Groups on different devices run at once:
their launches are queued on each device's stream before any result is
read back.

Unlike the JAX package, a shot count that does not divide the shot axis
is not padded with dummy shots, each of which costs a whole shot there
(ROADMAP.md, Queue 3): every group takes its real shots only
(:func:`split_shots`, :func:`distribute_shots`), and the results are joined
back in shot order; the JAX package's ``pad_shots`` has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fd_kernels import (forward_modeling_cuda, rtm_full_cuda,
                              rtm_snapshot_cuda)
from ..ops.stream import TILED_BLOCK_K, tiled_block_k
from ..solver import (forward_modeling_tiled, host_wavelet,
                      rtm_shot_full_tiled, rtm_shot_snapshot_tiled,
                      shot_positions)

__all__ = ["split_shots", "distribute_shots",
           "make_sharded_modeling_cuda", "make_sharded_modeling_tiled",
           "make_sharded_rtm_cuda", "make_sharded_rtm_tiled",
           "make_sharded_rtm_full_cuda", "make_sharded_rtm_full_tiled"]


def split_shots(ns: int, n_groups: int) -> list:
    """Shot indices of each of ``n_groups`` groups: contiguous, in shot
    order, sizes differing by at most one (empty when ns < n_groups)."""
    return [np.asarray(a, np.int64)
            for a in np.array_split(np.arange(ns), n_groups)]


def distribute_shots(mesh, *arrays):
    """Splits shot-batched arrays or tensors (leading axis = shot) over the
    mesh's ``shot`` axis (:func:`split_shots`), each part on its group's
    lead device. Returns one list of tensors per array."""
    groups = split_shots(len(arrays[0]), mesh.shape["shot"])
    return tuple([torch.as_tensor(a)[torch.as_tensor(idx)].to(
        mesh.lead(i)) for i, idx in enumerate(groups)] for a in arrays)


def _run_groups(mesh, ns: int, run, *per_shot):
    """``run(device, idx, *parts)`` for each non-empty shot group, ``idx``
    its shot indices and ``parts`` its parts of the ``per_shot`` arrays
    (:func:`distribute_shots`), all queued before any is read; returns the
    results joined in shot order on the mesh's first device."""
    groups = split_shots(ns, mesh.shape["shot"])
    parts = (list(zip(*distribute_shots(mesh, *per_shot))) if per_shot
             else [()] * len(groups))
    outs = [run(mesh.lead(i), idx, *parts[i])
            for i, idx in enumerate(groups) if len(idx)]
    return torch.cat([o.to(mesh.lead()) for o in outs])


def _on(v2, device):
    return torch.as_tensor(v2, dtype=torch.float32).to(device)


def make_sharded_modeling_cuda(ctx, mesh, sz: int, gz: int, lap_impl=None):
    """Shot-sharded forward modeling on the per-step kernels (the
    counterpart of ``make_sharded_modeling_pallas``): ``fn(v2, sxs,
    wavelet) -> (ns, nt, nx)`` traces, ``v2`` (nxe, nze) shared by the
    shots (``mod_main.cpp:118-126``)."""
    def fn(v2, sxs, wavelet):
        sxs, wav = shot_positions(sxs), host_wavelet(wavelet)
        return _run_groups(mesh, len(sxs), lambda dev, idx: forward_modeling_cuda(
            ctx, _on(v2, dev), wav, [sxs[s] for s in idx], sz, gz,
            lap_impl=lap_impl)[2])
    return fn


def make_sharded_modeling_tiled(ctx, mesh, sz: int, gz: int,
                                block_k=None, lap_impl=None):
    """Shot-sharded forward modeling on the large-grid tier's K-step passes
    (the counterpart of ``make_sharded_modeling_tiled``); as
    :func:`make_sharded_modeling_cuda`. ``block_k=None``: K = 4, or the
    largest K below it whose tiles fit (:func:`..ops.stream.
    tiled_block_k`)."""
    if block_k is None:
        block_k = tiled_block_k(ctx, ("kstep_mod",), lap_impl)

    def fn(v2, sxs, wavelet):
        sxs, wav = shot_positions(sxs), host_wavelet(wavelet)
        return _run_groups(mesh, len(sxs), lambda dev, idx: forward_modeling_tiled(
            ctx, _on(v2, dev), wav, [sxs[s] for s in idx], sz, gz,
            block_k=block_k, lap_impl=lap_impl)[2])
    return fn


def make_sharded_rtm_cuda(ctx, mesh, sz: int, gz: int, lap_impl=None):
    """Shot-sharded two-snapshot RTM on the per-step kernels (the
    counterpart of ``make_sharded_rtm_pallas``): ``fn(v2, dobs, sxs,
    wavelet) -> (ns, nx, nz)`` images, ``v2`` (ns, nxe, nze) (the GPU
    suite's random boundaries differ by shot), ``dobs`` (ns, nx, nt)."""
    def fn(v2, dobs, sxs, wavelet):
        sxs, wav = shot_positions(sxs), host_wavelet(wavelet)
        return _run_groups(mesh, len(sxs), lambda dev, idx, v, d: rtm_snapshot_cuda(
            ctx, v, wav, d, [sxs[s] for s in idx], sz, gz,
            lap_impl=lap_impl), v2, dobs)
    return fn


def make_sharded_rtm_tiled(ctx, mesh, sz: int, gz: int, block_k=None,
                           lap_impl=None):
    """Shot-sharded two-snapshot RTM on the K-step passes (the counterpart
    of ``make_sharded_rtm_tiled``); as :func:`make_sharded_rtm_cuda`.
    ``block_k=None``: K = 4, or the largest K below it whose tiles fit."""
    if block_k is None:
        block_k = tiled_block_k(ctx, ("kstep_gpu_fwd", "kstep_gpu_bwd"),
                                lap_impl)

    def fn(v2, dobs, sxs, wavelet):
        sxs, wav = shot_positions(sxs), host_wavelet(wavelet)
        return _run_groups(mesh, len(sxs), lambda dev, idx, v, d: rtm_shot_snapshot_tiled(
            ctx, v, wav, d, [sxs[s] for s in idx], sz, gz, block_k=block_k,
            lap_impl=lap_impl), v2, dobs)
    return fn


def make_sharded_rtm_full_cuda(ctx, mesh, sz: int, gz: int):
    """Shot-sharded full-wavefield RTM (``rtm_main``) on ``rtm_full_cuda``
    (the counterpart of ``make_sharded_rtm_full_tiled``): ``fn(v2, dobs,
    sxs, nxts, wavelet) -> (ns, nx, nz)`` images, ``v2`` (nxe, nze) shared
    (``rtm_main.cpp:113-132``), ``nxts`` each shot's cross-shot it=0
    flat-read sample (``rtm_main.cpp:202``). The exact taps, whatever
    ``PFDC_LAP_IMPL`` says, as the JAX lax ``rtm_shot_full`` this tier
    stands for."""
    def fn(v2, dobs, sxs, nxts, wavelet):
        sxs, wav = shot_positions(sxs), host_wavelet(wavelet)
        nxts = np.asarray(nxts, np.float32)
        return _run_groups(mesh, len(sxs), lambda dev, idx, d: rtm_full_cuda(
            ctx, _on(v2, dev), wav, d, [sxs[s] for s in idx], sz, gz,
            next_shot_first=nxts[idx], lap_impl="vpu"), dobs)
    return fn


def make_sharded_rtm_full_tiled(ctx, mesh, sz: int, gz: int,
                                block_k: int = TILED_BLOCK_K, lap_impl=None):
    """Shot-sharded full-wavefield RTM (``rtm_main``) on the large-grid
    tier, :func:`..solver.rtm_shot_full_tiled` (the counterpart of
    ``make_sharded_rtm_full_tiled``, the JAX ``parallel/shots.py:128-160``),
    over real shot groups only; as :func:`make_sharded_rtm_full_cuda`. Its
    kernels at K >= 2 (``rec_step``) stage no tile of K steps, so the
    default K fits at every order."""
    def fn(v2, dobs, sxs, nxts, wavelet):
        sxs, wav = shot_positions(sxs), host_wavelet(wavelet)
        nxts = np.asarray(nxts, np.float32)
        return _run_groups(mesh, len(sxs), lambda dev, idx, d: rtm_shot_full_tiled(
            ctx, _on(v2, dev), wav, d, [sxs[s] for s in idx], sz, gz,
            next_shot_first=nxts[idx], block_k=block_k, lap_impl=lap_impl),
            dobs)
    return fn
