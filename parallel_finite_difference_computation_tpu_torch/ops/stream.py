"""Wrappers of the large-grid tier's CUDA kernels: the port's counterpart of
the JAX package's ``ops/pallas_stream.py``.

Grids far beyond the L2 cache (the reference's full-resolution Pluto
config, 7040 x 1281 extended, 36 MB a field) run either one step a launch
(``block_k=1``, the per-step streaming tier: ``fd_step``, ``fd_update``
and ``gpu_step``) or in passes of K fused time steps: each pass reads and
writes every field once (temporal blocking, as the JAX package's K-step
kernels do). One wrapper call is one step or one pass, one kernel launch
for every shot of the batch; the tiled entry points
:func:`..solver.forward_modeling_tiled`,
:func:`..solver.backward_recorded_tiled`,
:func:`..solver.rtm_shot_full_tiled` and
:func:`..solver.rtm_shot_snapshot_tiled` loop over them.

Each wrapper routes by the device of its input. A CPU tensor goes to the
plain version in :mod:`..solver`; a CUDA tensor goes to the kernel, and any
failure (no ``nvcc``, a build error, a refused launch) raises. The state
goes in and comes out as the plain versions carry it; on the card the
outputs are new buffers, or the buffers ``out`` names (which the launch
must not read), except the image, which the kernels add into in place
(pass a copy to keep the old one). ``LAUNCHES`` counts one per kernel
launch and is added to only where a kernel is launched.

Per-run constants (``v2*dt2``, the taper ramps, the source patch and
positions) are made on the card once by :func:`prepare` and handed to every
call, so that a step or pass copies nothing from the host. The kernels
rebuild the taper from its 1-D ramps (``numerics.mask_ramps``), bitwise
the mask plane, and so read no mask plane. A block's shared memory is
sized, and a tile too large for it refused, by the K-step kernels' C entry
points (``csrc/kstep.cuh``, ``allow_smem``); the wrappers raise on that
refusal, naming the limit.

Every wrapper takes ``parts``, the bf16 splits of the Laplacian's z taps
(:func:`.fd_kernels.lap_parts`): 0 runs the exact kernels; 2
(``lap_impl="mxu"``) and 3 (``"mxu6"``) the ``*_mma`` kernels, which take
the z taps as the split-bf16 banded product on the tensor cores as the JAX
kernels' ``use_mxu`` branch does, and the plain versions with
:func:`..solver.laplacian_of` (``axis="z"``) on the CPU.

| kernel | source | replaces (JAX package, ``ops/pallas_stream.py``) |
|---|---|---|
| ``fd_step`` | ``csrc/stream_step.cu`` | ``_kernel`` (:76) |
| ``fd_update`` | ``csrc/stream_step.cu`` | ``_kernel_update`` (:171) |
| ``kstep_mod`` | ``csrc/kstep_mod.cu`` | ``_kstep_kernel`` (:574) |
| ``kstep_gpu_fwd`` | ``csrc/kstep_gpu_fwd.cu`` | ``_kstep_gpu_fwd_kernel`` (:740) |
| ``kstep_gpu_bwd`` | ``csrc/kstep_gpu_bwd.cu`` | ``_kstep_gpu_bwd_kernel`` (:857) |
| ``gpu_step`` | ``csrc/gpu_step.cu`` | ``_kernel_gpu`` (:207) |
| ``kstep_mod_mma`` | ``csrc/kstep_mod.cu`` | ``_kstep_kernel``'s ``use_mxu`` branch (:600-608) |
| ``kstep_gpu_fwd_mma`` | ``csrc/kstep_gpu_fwd.cu`` | ``_kstep_gpu_fwd_kernel``'s (:753-761) |
| ``kstep_gpu_bwd_mma`` | ``csrc/kstep_gpu_bwd.cu`` | ``_kstep_gpu_bwd_kernel``'s (:875-883) |
| ``gpu_step_mma`` | ``csrc/gpu_step.cu`` | ``_kernel_gpu``'s (:220, ``_lap_dispatch`` :64) |
| ``fd_step_mma`` | ``csrc/stream_step.cu`` | ``_kernel``'s (:79, ``_lap_dispatch`` :64) |
| ``fd_update_mma`` | ``csrc/stream_step.cu`` | ``_kernel_update``'s (:177) |

Every function of the JAX package that reaches ``pl.pallas_call``, and
where the port stands with it (``PERF.md``, section 6, has the times):

| row | TPU kernel (file:line) | computes | port |
|---|---|---|---|
| 1 | ``ops/pallas_fd.py:423`` ``_fwd_mod_kernel`` | whole-shot ``mod_main`` loop | ``mod_step`` |
| 2 | ``ops/pallas_fd.py:534`` ``_rtm_kernel`` | whole two-snapshot RTM shot | ``rtm_fwd_step`` + ``rtm_bwd_step`` |
| 3 | ``ops/pallas_fd.py:702`` ``_fwd_gpu_kernel`` | ``fd_forward`` | ``rtm_fwd_step`` |
| 4 | ``ops/pallas_fd.py:729`` ``_bwd_gpu_kernel`` | ``fd_back`` + imaging | ``rtm_bwd_step`` |
| 5 | ``ops/pallas_fd.py:260-334`` MXU ``_make_lap`` | banded-matmul Laplacian | ``*_step_mma`` |
| 6 | ``ops/pallas_stencil.py:60`` ``_kernel`` | interior Laplacian | ``lap_apply`` |
| 7 | ``ops/pallas_stencil.py:546``, ``:429`` | padded-layout Laplacian | ``lap_padded``, ``lap_padded_mma`` (:mod:`.padded`) |
| 8 | ``ops/pallas_stream.py:76`` ``_kernel`` | one fused CPU-flavor step | ``fd_step``, ``fd_step_mma`` |
| 9 | ``ops/pallas_stream.py:171`` ``_kernel_update`` | untapered leapfrog | ``fd_update``, ``fd_update_mma`` |
| 10 | ``ops/pallas_stream.py:207`` ``_kernel_gpu`` | taper-first step, K5, K6 | ``gpu_step``, ``gpu_step_mma`` |
| 11 | ``ops/pallas_stream.py:574`` ``_kstep_kernel`` | K CPU-flavor steps + trace | ``kstep_mod``, ``kstep_mod_mma`` |
| 12 | ``ops/pallas_stream.py:740`` ``_kstep_gpu_fwd_kernel`` | K ``fd_forward`` steps | ``kstep_gpu_fwd``, ``kstep_gpu_fwd_mma`` |
| 13 | ``ops/pallas_stream.py:857`` ``_kstep_gpu_bwd_kernel`` | K ``fd_back`` steps + K5/K6 | ``kstep_gpu_bwd``, ``kstep_gpu_bwd_mma`` |
| 14 | ``ops/pallas_stream.py:1002`` ``_kstep_rec_kernel`` | K steps writing frames | ``rec_fwd_step``, ``rec_bwd_step``, their ``*_mma`` |
| 15 | ``parallel/domain_pallas.py:115, :136, :189`` | x-slab blocked fwd/bwd/mod | ``block_fwd``, ``block_bwd``, ``block_mod`` and their ``*_mma`` twins (:mod:`..parallel.domain_kernels`) |
| 16 | ``parallel/domain2d_pallas.py:99, :124, :178`` | (x, z) blocked fwd/bwd/mod | ``block2_fwd``, ``block2_bwd``, ``block2_mod`` and their ``*_mma`` twins (:mod:`..parallel.domain2d_kernels`) |
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import numerics, solver
from ..solver import FDContext, host_wavelet, shot_positions
from .fd_kernels import (_check, _check_gz, _check_order, _check_v2,
                         _check_window, _coef_args, _dev_f32, _on_cuda,
                         _raise_on, _stream, lap_parts, largest_fitting_k)
from .stencil import receiver_x0

__all__ = ["LAUNCHES", "reset_launches", "check_block_k", "TILED_BLOCK_K",
           "tiled_block_k", "Consts",
           "prepare", "fd_step_cuda", "fd_update_cuda", "mod_kstep_cuda",
           "fd_forward_kstep_cuda", "fd_back_kstep_cuda", "fd_step_gpu_cuda"]

LAUNCHES = {"fd_step": 0, "fd_update": 0, "kstep_mod": 0,
            "kstep_gpu_fwd": 0, "kstep_gpu_bwd": 0, "gpu_step": 0,
            "kstep_mod_mma": 0, "kstep_gpu_fwd_mma": 0,
            "kstep_gpu_bwd_mma": 0, "gpu_step_mma": 0, "fd_step_mma": 0,
            "fd_update_mma": 0}

# The most steps a pass takes (kMaxSteps of csrc/kstep.cuh).
MAX_STEPS = 8
# The large-grid tier's K a pass by default: this, or the largest K below
# it whose tiles fit a block's shared memory (tiled_block_k).
TILED_BLOCK_K = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_block_k(block_k) -> int:
    """``block_k`` as an int in [1, 8]: 1 selects the per-step streaming
    tier, 2..8 the K-step passes."""
    K = int(block_k)
    if not 1 <= K <= MAX_STEPS:
        raise ValueError(f"block_k must be in [1, {MAX_STEPS}], got {K}")
    return K


def tiled_block_k(ctx: FDContext, kernels, lap_impl=None) -> int:
    """The large-grid tier's default K for a run of ``kernels`` (names of
    :func:`.fd_kernels.smem_bytes`) under ``lap_impl``: ``TILED_BLOCK_K``,
    or the largest K below it whose tiles fit a block's shared memory
    (above order 10 only: every tile of K = 4 fits up to there)."""
    return largest_fitting_k(kernels, ctx.order, TILED_BLOCK_K,
                             lap_parts(lap_impl, ctx))


@dataclasses.dataclass(frozen=True, eq=False)
class Consts:
    """Device constants of one run, shared by all its passes."""

    ctx: FDContext
    v2: torch.Tensor           # the velocity they were made from
    sxs: tuple
    source: str
    taper: str
    v2dt2: torch.Tensor
    v2_stride: int
    ramps: tuple               # (xramp, zfac, strip) of the taper
    patch: torch.Tensor
    sx: torch.Tensor           # (ns,) int32
    coefs: tuple               # host coefficient arrays, kept alive
    coef_ptrs: tuple


def prepare(ctx: FDContext, v2, sx, source: str = "gaussian",
            taper: str = "all"):
    """The device constants of a run of passes over the shots ``sx`` with
    velocity ``v2``; None for a CPU tensor, whose passes need none."""
    if not _on_cuda(v2):
        return None
    sxs = tuple(shot_positions(sx))
    dev = v2.device
    ramps = numerics.mask_ramps(ctx.mask_all, ctx.mask_top, taper, ctx.nzb)
    patch = ctx.source_patch if source == "gaussian" else np.ones((1, 1))
    keep, ptrs = _coef_args(ctx)
    return Consts(ctx=ctx, v2=v2, sxs=sxs, source=source, taper=taper,
                  v2dt2=v2 * ctx.dt2,
                  v2_stride=0 if v2.dim() == 2 else ctx.nxe * ctx.nze,
                  ramps=tuple(_dev_f32(a, dev) for a in ramps),
                  patch=_dev_f32(patch, dev),
                  sx=torch.tensor(sxs, dtype=torch.int32, device=dev),
                  coefs=keep, coef_ptrs=ptrs)


def _consts(consts, ctx, v2, sxs=None, source=None, taper="top"):
    """``consts``, or new ones; raises if they were made for other inputs."""
    if consts is None:
        return prepare(ctx, v2, sxs if sxs is not None else [0],
                       source or "point", taper)
    if (consts.ctx is not ctx or consts.v2 is not v2
            or consts.taper != taper
            or (sxs is not None and consts.sxs != tuple(sxs))
            or (source is not None and consts.source != source)):
        raise ValueError("consts were prepared for other inputs")
    return consts


def _check_amps(amps) -> np.ndarray:
    amps = host_wavelet(amps)
    if amps.ndim != 1 or not 1 <= amps.shape[0] <= MAX_STEPS:
        raise ValueError(f"a pass takes 1 to {MAX_STEPS} wavelet samples, "
                         f"got shape {amps.shape}")
    return amps


def _check_state(ctx: FDContext, v2, **fields) -> int:
    """Checks the (ns, nxe, nze) state fields and v2; returns ns."""
    first = next(iter(fields.values()))
    dev, ns = first.device, first.shape[0]
    for name, f in fields.items():
        _check(name, f, (ns, ctx.nxe, ctx.nze), dev)
    if v2.device != dev:
        raise ValueError(f"v2 is on {v2.device}, expected {dev}")
    _check_v2(ctx, v2, ns)
    return ns


def _rows(name: str, rows, ns: int, n: int, nx: int, device) -> int:
    """Checks trace rows (ns, n, nx) whose rows are contiguous; returns the
    shot stride."""
    if rows.device != device or rows.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}")
    if tuple(rows.shape) != (ns, n, nx):
        raise ValueError(f"{name} has shape {tuple(rows.shape)}, expected "
                         f"{(ns, n, nx)}")
    if rows.stride(2) != 1 or (n > 1 and rows.stride(1) != nx):
        raise ValueError(f"{name} must have contiguous rows")
    return rows.stride(0)


def _check_out(like, n: int, out, *inputs) -> None:
    """``out``, if given, names ``n`` buffers shaped as ``like``, none of
    them one of ``inputs`` (the launch reads those)."""
    if out is None:
        return
    if len(out) != n:
        raise ValueError(f"out must name {n} buffers, got {len(out)}")
    for o in out:
        _check("out", o, like.shape, like.device)
        if any(o.data_ptr() == t.data_ptr() for t in inputs):
            raise ValueError("an output buffer is an input of the launch")


def _split(ctx: FDContext, parts, name: str):
    """``parts`` checked (0, 2 or 3); the kernel a launch with them runs
    (``name`` or its ``*_mma`` sibling) and the plain passes' Laplacian
    (None for the exact taps)."""
    parts = lap_parts(int(parts), ctx)
    return (parts, f"{name}_mma" if parts else name,
            solver.laplacian_of(ctx, parts, axis="z"))


def _outputs(like, n: int, out):
    """The buffers ``out`` names, or ``n`` new ones shaped as ``like``."""
    return list(out) if out is not None else [torch.empty_like(like)
                                              for _ in range(n)]


def fd_step_cuda(ctx: FDContext, p, pp, v2, taper: str = "all", amp=None,
                 sx=None, sz: int = 0, source: str = "gaussian",
                 inj_row=None, x0: int = 0, gz: int = 0, consts=None,
                 out=None, parts: int = 0):
    """One fused CPU-flavor step from the state ``(p, pp)`` (ns, nxe, nze),
    ``pp`` tapered, with the optional injection before the taper: the
    source window ``amp * patch`` at ``(sx[s], sz)`` (``source`` Gaussian
    or point) when ``amp`` is given, the receiver row ``inj_row`` (ns, nx)
    on row gz from x0 (clamped into the grid) when it is given.
    ``fd_step`` (``fd_step_mma`` with the z taps in ``parts`` bf16 splits)
    on the card, into the buffers ``out`` if given; :func:`..solver.fd_step`
    on the CPU. Returns ``(p*m, (u + inj)*m)``."""
    if taper not in ("all", "top"):
        raise ValueError(f"unknown taper {taper!r}")
    ns = _check_state(ctx, v2, p=p, pp=pp)
    sxs = None
    if amp is not None:
        sxs = shot_positions(sx)
        if ns != len(sxs):
            raise ValueError(f"{len(sxs)} source positions for {ns} shots")
        _check_window(ctx, sxs, sz, ctx.source_patch.shape[0] // 2
                      if source == "gaussian" else 0)
    inj_stride = 0
    if inj_row is not None:
        _check_gz(ctx, gz)
        inj_stride = _rows("inj_row", inj_row[:, None], ns, 1, ctx.nx,
                           p.device)
        x0 = receiver_x0(x0, ctx.nx, ctx.nxe)
    _check_out(p, 2, out, p, pp)
    parts, name, lap = _split(ctx, parts, "fd_step")
    _check_order(ctx.order, _on_cuda(p))
    if not _on_cuda(p):
        return solver.fd_step(ctx, p, pp, v2, taper, amp, sxs, sz, source,
                              inj_row, x0, gz, lap)
    from . import _build
    outs = _outputs(p, 2, out)
    c = _consts(consts, ctx, v2, sxs, None if amp is None else source, taper)
    amps = np.float32([0.0 if amp is None else amp])
    xr, zf, st = c.ramps
    args = (p.data_ptr(), pp.data_ptr(), *(o.data_ptr() for o in outs),
            c.v2dt2.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), c.patch.data_ptr(), c.patch.shape[0] // 2,
            c.sx.data_ptr(), sz, None if amp is None else amps.ctypes.data,
            None if inj_row is None else inj_row.data_ptr(), inj_stride, x0,
            gz, ctx.nx, ns, ctx.nxe, ctx.nze, ctx.order)
    with torch.cuda.device(p.device):
        lib = _build.library()
        if parts:
            rc = lib.pfdc_fd_step_mma_run(*args, parts, *c.coef_ptrs,
                                          _stream(p.device))
        else:
            rc = lib.pfdc_fd_step_run(*args, *c.coef_ptrs, _stream(p.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return tuple(outs)


def fd_update_cuda(ctx: FDContext, p, pp, v2, consts=None, out=None,
                   parts: int = 0):
    """The untapered leapfrog update ``2p - pp + v2*dt2*lap(p)`` of the
    state ``(p, pp)`` (ns, nxe, nze), ``fd_back``'s source reconstruction:
    ``fd_update`` (``fd_update_mma`` with the z taps in ``parts`` bf16
    splits) on the card, into the buffer ``out`` if given;
    :func:`..solver.fd_update` on the CPU."""
    ns = _check_state(ctx, v2, p=p, pp=pp)
    out = None if out is None else (out,)
    _check_out(p, 1, out, p, pp)
    parts, name, lap = _split(ctx, parts, "fd_update")
    _check_order(ctx.order, _on_cuda(p))
    if not _on_cuda(p):
        return solver.fd_update(ctx, p, pp, v2, lap)
    from . import _build
    (res,) = _outputs(p, 1, out)
    c = _consts(consts, ctx, v2,
                taper="top" if consts is None else consts.taper)
    args = (p.data_ptr(), pp.data_ptr(), res.data_ptr(), c.v2dt2.data_ptr(),
            c.v2_stride, ns, ctx.nxe, ctx.nze, ctx.order)
    with torch.cuda.device(p.device):
        lib = _build.library()
        if parts:
            rc = lib.pfdc_fd_update_mma_run(*args, parts, *c.coef_ptrs,
                                            _stream(p.device))
        else:
            rc = lib.pfdc_fd_update_run(*args, *c.coef_ptrs,
                                        _stream(p.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return res


def mod_kstep_cuda(ctx: FDContext, p, pp, v2, amps, sx, sz: int, gz: int,
                   source: str = "gaussian", taper: str = "all",
                   consts=None, parts: int = 0):
    """One pass of K = ``len(amps)`` ``mod_main`` steps (``source``
    Gaussian or point, ``taper`` all-edge or top strip) from the state
    ``(p, pp)`` (ns, nxe, nze): ``kstep_mod`` (``kstep_mod_mma`` with the z
    taps in ``parts`` bf16 splits) on the card, :func:`..solver.mod_kstep`
    on the CPU. Returns ``(p, pp, rec)`` with rec (ns, K, nx), the traces
    at depth gz."""
    sxs = shot_positions(sx)
    amps = _check_amps(amps)
    ns = _check_state(ctx, v2, p=p, pp=pp)
    if ns != len(sxs):
        raise ValueError(f"{len(sxs)} source positions for {ns} shots")
    r = ctx.source_patch.shape[0] // 2 if source == "gaussian" else 0
    _check_window(ctx, sxs, sz, r)
    _check_gz(ctx, gz)
    parts, name, lap = _split(ctx, parts, "kstep_mod")
    _check_order(ctx.order, _on_cuda(p))
    if not _on_cuda(p):
        return solver.mod_kstep(ctx, p, pp, v2, amps, sxs, sz, gz, source,
                                taper, lap)
    from . import _build
    k = len(amps)
    c = _consts(consts, ctx, v2, sxs, source, taper)
    p_out, pp_out = torch.empty_like(p), torch.empty_like(pp)
    rec = torch.empty((ns, k, ctx.nx), dtype=torch.float32, device=p.device)
    xr, zf, st = c.ramps
    args = (p.data_ptr(), pp.data_ptr(), p_out.data_ptr(), pp_out.data_ptr(),
            c.v2dt2.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), c.patch.data_ptr(), r, c.sx.data_ptr(), sz, gz,
            amps.ctypes.data, k, rec.data_ptr(), ns, ctx.nxe, ctx.nze,
            ctx.nxb, ctx.order)
    with torch.cuda.device(p.device):
        lib = _build.library()
        if parts:
            rc = lib.pfdc_kstep_mod_mma_run(*args, parts, *c.coef_ptrs,
                                            _stream(p.device))
        else:
            rc = lib.pfdc_kstep_mod_run(*args, *c.coef_ptrs,
                                        _stream(p.device))
    _raise_on(rc, name, ctx.order, k)
    LAUNCHES[name] += 1
    return p_out, pp_out, rec


def fd_forward_kstep_cuda(ctx: FDContext, p, pp, v2, amps, sx, sz: int,
                          consts=None, parts: int = 0):
    """One pass of K = ``len(amps)`` ``fd_forward`` steps from the state
    ``(p, pp)`` (ns, nxe, nze): ``kstep_gpu_fwd`` (``kstep_gpu_fwd_mma``
    with the z taps in ``parts`` bf16 splits) on the card,
    :func:`..solver.fd_forward_kstep` on the CPU. Returns ``(p, pp)``."""
    sxs = shot_positions(sx)
    amps = _check_amps(amps)
    ns = _check_state(ctx, v2, p=p, pp=pp)
    if ns != len(sxs):
        raise ValueError(f"{len(sxs)} source positions for {ns} shots")
    _check_window(ctx, sxs, sz, 0)
    parts, name, lap = _split(ctx, parts, "kstep_gpu_fwd")
    _check_order(ctx.order, _on_cuda(p))
    if not _on_cuda(p):
        return solver.fd_forward_kstep(ctx, p, pp, v2, amps, sxs, sz, lap)
    from . import _build
    k = len(amps)
    c = _consts(consts, ctx, v2, sxs)
    p_out, pp_out = torch.empty_like(p), torch.empty_like(pp)
    xr, zf, st = c.ramps
    args = (p.data_ptr(), pp.data_ptr(), p_out.data_ptr(), pp_out.data_ptr(),
            c.v2dt2.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), c.sx.data_ptr(), sz, amps.ctypes.data, k, ns,
            ctx.nxe, ctx.nze, ctx.order)
    with torch.cuda.device(p.device):
        lib = _build.library()
        if parts:
            rc = lib.pfdc_kstep_gpu_fwd_mma_run(*args, parts, *c.coef_ptrs,
                                                _stream(p.device))
        else:
            rc = lib.pfdc_kstep_gpu_fwd_run(*args, *c.coef_ptrs,
                                            _stream(p.device))
    _raise_on(rc, name, ctx.order, k)
    LAUNCHES[name] += 1
    return p_out, pp_out


def fd_back_kstep_cuda(ctx: FDContext, ps, pps, pr, ppr, img, v2, inj_rows,
                       gz: int, consts=None, parts: int = 0):
    """One pass of K ``fd_back`` steps (it >= 2) from the state ``(ps, pps,
    pr, ppr, img)``; ``inj_rows`` (ns, K, nx) are the pass's time-reversed
    trace rows, ``img`` (ns, nx, nz). ``kstep_gpu_bwd`` (``kstep_gpu_bwd_mma``
    with the z taps in ``parts`` bf16 splits) on the card, which adds into
    ``img`` in place; :func:`..solver.fd_back_kstep` on the CPU. Returns the
    next state."""
    ns = _check_state(ctx, v2, ps=ps, pps=pps, pr=pr, ppr=ppr)
    _check("img", img, (ns, ctx.nx, ctx.nz), ps.device)
    _check_gz(ctx, gz)
    k = inj_rows.shape[1] if inj_rows.dim() == 3 else 0
    if not 1 <= k <= MAX_STEPS:
        raise ValueError(f"a pass takes 1 to {MAX_STEPS} trace rows, got "
                         f"shape {tuple(inj_rows.shape)}")
    inj_stride = _rows("inj_rows", inj_rows, ns, k, ctx.nx, ps.device)
    parts, name, lap = _split(ctx, parts, "kstep_gpu_bwd")
    _check_order(ctx.order, _on_cuda(ps))
    if not _on_cuda(ps):
        return solver.fd_back_kstep(ctx, ps, pps, pr, ppr, img, v2, inj_rows,
                                    gz, lap)
    from . import _build
    c = _consts(consts, ctx, v2)
    outs = [torch.empty_like(f) for f in (ps, pps, pr, ppr)]
    xr, zf, st = c.ramps
    args = (ps.data_ptr(), pps.data_ptr(), pr.data_ptr(), ppr.data_ptr(),
            *(o.data_ptr() for o in outs), img.data_ptr(),
            c.v2dt2.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), inj_rows.data_ptr(), inj_stride, gz, k, ctx.nxb,
            ctx.nzb, ns, ctx.nxe, ctx.nze, ctx.order)
    with torch.cuda.device(ps.device):
        lib = _build.library()
        if parts:
            rc = lib.pfdc_kstep_gpu_bwd_mma_run(*args, parts, *c.coef_ptrs,
                                                _stream(ps.device))
        else:
            rc = lib.pfdc_kstep_gpu_bwd_run(*args, *c.coef_ptrs,
                                            _stream(ps.device))
    _raise_on(rc, name, ctx.order, k)
    LAUNCHES[name] += 1
    return (*outs, img)


def fd_step_gpu_cuda(ctx: FDContext, y, x, v2, gz: int = 0, inj_row=None,
                     img=None, src=None, consts=None, out=None,
                     parts: int = 0):
    """One taper-first step from the state ``(x, y)`` (ns, nxe, nze), with
    the trace row ``inj_row`` (ns, nx) at depth gz and ``img += src * new``
    (``img`` (ns, nx, nz), ``src`` (ns, nxe, nze)) when given: ``gpu_step``
    (``gpu_step_mma`` with the z taps in ``parts`` bf16 splits) on the card,
    into the buffers ``out`` if given, adding into ``img`` in place;
    :func:`..solver.fd_step_gpu` on the CPU. Returns ``(t, new)`` or
    ``(t, new, img)``."""
    ns = _check_state(ctx, v2, y=y, x=x)
    _check_gz(ctx, gz)
    inj_stride = 0
    if inj_row is not None:
        inj_stride = _rows("inj_row", inj_row[:, None], ns, 1, ctx.nx,
                           y.device)
    if (img is None) != (src is None):
        raise ValueError("img and src go together")
    if img is not None:
        _check("img", img, (ns, ctx.nx, ctx.nz), y.device)
        _check("src", src, (ns, ctx.nxe, ctx.nze), y.device)
    _check_out(y, 2, out, y, x, *(() if src is None else (src,)))
    parts, name, lap = _split(ctx, parts, "gpu_step")
    _check_order(ctx.order, _on_cuda(y))
    if not _on_cuda(y):
        return solver.fd_step_gpu(ctx, y, x, v2, gz, inj_row, img, src, lap)
    from . import _build
    t, new = _outputs(y, 2, out)
    c = _consts(consts, ctx, v2)
    ptr = lambda a: None if a is None else a.data_ptr()
    xr, zf, st = c.ramps
    args = (y.data_ptr(), x.data_ptr(), t.data_ptr(), new.data_ptr(),
            c.v2dt2.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), ptr(inj_row), inj_stride, gz, ptr(src), ptr(img),
            ctx.nxb, ctx.nzb, ns, ctx.nxe, ctx.nze, ctx.order)
    with torch.cuda.device(y.device):
        lib = _build.library()
        if parts:
            rc = lib.pfdc_gpu_step_mma_run(*args, parts, *c.coef_ptrs,
                                           _stream(y.device))
        else:
            rc = lib.pfdc_gpu_step_run(*args, *c.coef_ptrs,
                                       _stream(y.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return (t, new) if img is None else (t, new, img)
