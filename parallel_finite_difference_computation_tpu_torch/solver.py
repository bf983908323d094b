"""Propagation loops: torch time loops for modeling and RTM.

These are the **plain versions** of the CUDA step kernels in ``csrc/``: the
JAX package's ``lax.scan`` loops (``solver.py:52-178, 534-604, 833-924``
there) written as Python loops of eager torch ops over a leading shot axis.
They run on any device; the CPU tests hold them against the JAX package,
and ``chip_smoke.py`` holds the kernels against them on the card. The
kernel wrappers in :mod:`.ops.fd_kernels` route CPU tensors here.

* :func:`forward_modeling`: ``mod_main``'s loop (``mod_main.cpp:146-168``):
  update, inject into the new field, taper both fields, record from the
  tapered old field, swap. It records traces, or the whole interior
  wavefield for ``rtm_main``.
* :func:`backward_recorded` / :func:`rtm_shot_full`: ``rtm_main``'s
  backward half and shot body (``rtm_main.cpp:158-247``): the same step
  driven by the time-reversed data at the receiver row, and the zero-lag
  correlation of the two stored wavefields.
* :func:`fd_forward` / :func:`fd_back`: the GPU suite's ``fd_forward``
  (``fd-code.cu:247-288``) and ``fd_back`` (``:290-341``): swap, taper,
  update, inject; and the untapered source reconstruction from the two
  snapshots beside the tapered receiver field with imaging.
* The large-grid tier's steps and passes, which take a state in and give
  it out: :func:`fd_step` (one CPU-flavor step with an optional source
  window or receiver row), :func:`fd_update` (the untapered leapfrog),
  :func:`fd_step_gpu` (one taper-first step with optional trace injection
  and imaging), :func:`mod_kstep` (K ``mod_main`` steps),
  :func:`fd_forward_kstep` (K ``fd_forward`` steps) and
  :func:`fd_back_kstep` (K ``fd_back`` steps), the plain versions of the
  kernels in :mod:`.ops.stream`. The whole-grid loops above run the same
  step bodies, so the tiled loops :func:`forward_modeling_tiled`,
  :func:`backward_recorded_tiled`, :func:`rtm_shot_full_tiled` and
  :func:`rtm_shot_snapshot_tiled` give bitwise their results on the CPU
  (the full-wavefield image at K = 1 up to its summation order).

Shots: ``v2`` is (nxe, nze), shared by every shot, or (ns, nxe, nze);
``sx`` is one int or a sequence of one int per shot. Fields and outputs
always carry the shot axis first. The wavelet is a host float32 array.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import numerics
from .config import Params
from .ops.stencil import (
    laplacian, laplacian_mxu, leapfrog, inject_point, inject_gaussian,
    inject_receivers, imaging_correlation, receiver_x0,
)

__all__ = ["FDContext", "forward_modeling", "fd_forward", "fd_back",
           "rtm_shot_snapshot", "backward_recorded", "backward_image",
           "rtm_shot_full", "receiver_offset", "laplacian_of", "fd_update",
           "fd_step", "mod_kstep", "fd_forward_kstep", "fd_back_kstep", "fd_step_gpu",
           "forward_modeling_tiled", "backward_recorded_tiled",
           "rtm_shot_full_tiled", "rtm_shot_snapshot_tiled"]

_F = np.float32


@dataclasses.dataclass(frozen=True, eq=False)
class FDContext:
    """Per-run constants of the propagation loops (``fd_init``/``taper_init``
    globals, ``fd-code.cu:146-224``). The arrays are host numpy float32, the
    same fields as the JAX package's ``FDContext``
    (:func:`..convert.context_from_arrays` carries one across)."""

    nxe: int
    nze: int
    nt: int
    nxb: int
    nzb: int
    order: int
    dt2: float                 # dt*dt, float32
    coefs_x: np.ndarray        # (order+1,) premultiplied by 1/dx^2
    coefs_z: np.ndarray        # (order+1,) premultiplied by 1/dz^2
    mask_top: np.ndarray       # (nxe, nze) top-strip taper multiplier (K3)
    mask_all: np.ndarray       # (nxe, nze) all-edge taper multiplier
    source_patch: np.ndarray   # (7, 7) Gaussian injection patch

    @property
    def nx(self) -> int:
        return self.nxe - 2 * self.nxb

    @property
    def nz(self) -> int:
        return self.nze - 2 * self.nzb

    @staticmethod
    def create(nx: int, nz: int, nt: int, dx: float, dz: float, dt: float,
               order: int = 8, nxb: int = 40, nzb: int = 40,
               fac: float = 0.7, exact_taper: bool = True) -> "FDContext":
        """Build a context from base (unextended) grid dims. ``exact_taper``
        selects the GPU suite's taper profile (``functions.c:361-379``);
        False selects the CPU pipeline's ``fac``-scaled one
        (``taper.c:25-45``)."""
        nxe, nze = nx + 2 * nxb, nz + 2 * nzb
        cx, cz = numerics.scaled_coefficients(order, dx, dz)
        tx = numerics.taper_profile(nxb, fac, exact=exact_taper)
        tz = numerics.taper_profile(nzb, fac, exact=exact_taper)
        return FDContext(
            nxe=nxe, nze=nze, nt=nt, nxb=nxb, nzb=nzb, order=order,
            dt2=float(_F(dt) * _F(dt)),
            coefs_x=cx, coefs_z=cz,
            mask_top=numerics.taper_mask_top(nxe, nze, nxb, nzb, tx, tz),
            mask_all=numerics.taper_mask_all(nxe, nze, nxb, nzb, tx, tz),
            source_patch=numerics.gaussian_source_patch(),
        )

    @staticmethod
    def from_params(p: Params, exact_taper: bool = True) -> "FDContext":
        return FDContext.create(p.nx, p.nz, p.nt, p.dx, p.dz, p.dt,
                                order=p.order, nxb=p.nxb, nzb=p.nzb,
                                fac=p.fac, exact_taper=exact_taper)


def shot_positions(sx) -> list:
    """Source x positions as a list of ints, one per shot."""
    return [int(s) for s in np.atleast_1d(np.asarray(sx))]


def host_wavelet(wavelet) -> np.ndarray:
    """The wavelet as a host float32 array (it is read one sample per step
    on the host)."""
    if isinstance(wavelet, torch.Tensor):
        wavelet = wavelet.detach().cpu().numpy()
    return np.ascontiguousarray(wavelet, dtype=np.float32)


def laplacian_of(ctx: FDContext, lap_impl=None, axis: str = "x"):
    """The Laplacian ``p -> lap(p)`` the steps apply under ``lap_impl``
    (:func:`.ops.fd_kernels.lap_parts`): None for the exact taps
    (:func:`.ops.stencil.laplacian`, which the steps then call as they
    always have), else :func:`.ops.stencil.laplacian_mxu` with the taps of
    ``axis`` in 2 or 3 bf16 parts: ``"x"``, the JAX whole-shot kernels'
    MXU branch; ``"z"``, the streaming and K-step kernels' ``use_mxu``
    branch (``ops/pallas_stream.py:600-608``, ``_lap_dispatch`` :64)."""
    from .ops.fd_kernels import lap_parts
    parts = lap_parts(lap_impl, ctx)
    if not parts:
        return None
    return lambda p: laplacian_mxu(p, ctx.coefs_x, ctx.coefs_z, ctx.order,
                                   parts, axis)


def fd_update(ctx: FDContext, p, pp, v2, lap=None):
    """One Laplacian + leapfrog update ``2p - pp + v2*dt2*lap(p)`` (K1+K2;
    CPU ``fd_step``, ``timestep/fd.c:24-46``): the plain version of the
    ``fd_update`` kernel and of the JAX package's ``_kernel_update``
    (``ops/pallas_stream.py:171-204``), ``fd_back``'s untapered source
    reconstruction. ``lap``: the Laplacian (:func:`laplacian_of`); None
    is the exact one."""
    if lap is None:
        lap_p = laplacian(p, ctx.coefs_x, ctx.coefs_z, ctx.order)
    else:
        lap_p = lap(p)
    return leapfrog(p, pp, v2, lap_p, ctx.dt2)


def _zero_fields(ctx: FDContext, ns: int, like):
    return like.new_zeros((ns, ctx.nxe, ctx.nze))


RECORD_MODES = ("trace", "wavefield", "none")


def _interior(ctx: FDContext, f):
    return f[:, ctx.nxb:ctx.nxb + ctx.nx, ctx.nzb:ctx.nzb + ctx.nz]


def _mask(ctx: FDContext, taper: str, device):
    return torch.as_tensor(ctx.mask_all if taper == "all" else ctx.mask_top,
                           device=device)


def _step(ctx: FDContext, p, pp, v2, mask, amp=None, sxs=None, sz: int = 0,
          patch=None, inj_row=None, x0: int = 0, gz: int = 0, lap=None):
    """One CPU-flavor step from the state ``(p, pp)``, pp tapered: update
    (with the Laplacian ``lap``, :func:`fd_update`), inject into the new
    field (``amp * patch`` around each shot's source, or ``amp`` at it
    without a patch; the receiver row ``inj_row`` on row gz from x0), taper
    both. Returns ``(p * m, new * m)``."""
    new = fd_update(ctx, p, pp, v2, lap)
    if amp is not None:
        new = (inject_point(new, sxs, sz, amp) if patch is None
               else inject_gaussian(new, sxs, sz, amp, patch))
    if inj_row is not None:
        new = inject_receivers(new, inj_row, x0, gz)
    return p * mask, new * mask


def _patch(ctx: FDContext, source: str, device):
    """The Gaussian source patch on ``device``, or None for a point
    source."""
    if source not in ("gaussian", "point"):
        raise ValueError(f"unknown source {source!r}")
    return (torch.as_tensor(ctx.source_patch, device=device)
            if source == "gaussian" else None)


def _mod_step(ctx: FDContext, p, pp, v2, mask, amp: float, sxs, sz: int,
              patch, lap=None):
    """One ``mod_main`` step from the state ``(p, pp)``: update, inject into
    the new field, taper both. Returns the next state ``(new * m, p * m)``;
    its second field is the one the step records."""
    pm, new = _step(ctx, p, pp, v2, mask, amp, sxs, sz, patch, lap=lap)
    return new, pm


def fd_step(ctx: FDContext, p, pp, v2, taper: str = "all", amp=None,
            sx=None, sz: int = 0, source: str = "gaussian", inj_row=None,
            x0: int = 0, gz: int = 0, lap=None):
    """One fused CPU-flavor step from the state ``(p, pp)`` (ns, nxe, nze),
    pp tapered: the plain version of the ``fd_step`` kernel and of the JAX
    package's ``_kernel`` (``ops/pallas_stream.py:76-108``),
    ``(p*m, (u + inj)*m)`` with ``u = 2p - pp + v2*dt2*lap(p)`` and ``m`` the
    ``taper`` (``"all"`` or ``"top"``) mask. ``inj``, added before the taper
    in the reference's order: with ``amp``, the ``source`` window
    (Gaussian patch or point) scaled by ``amp`` at ``(sx[s], sz)``; with
    ``inj_row`` (ns, nx), the receiver row on row gz from x0 (clamped into
    the grid, :func:`.ops.stencil.receiver_x0`). ``lap``: the Laplacian
    (:func:`fd_update`)."""
    patch = _patch(ctx, source, p.device)
    return _step(ctx, p, pp, v2, _mask(ctx, taper, p.device), amp,
                 None if amp is None else shot_positions(sx), sz, patch,
                 inj_row, x0, gz, lap)


def forward_modeling(ctx: FDContext, v2, wavelet, sx, sz: int, gz: int,
                     source: str = "gaussian", taper: str = "all",
                     record: str = "trace", lap_impl=None):
    """Forward modeling: ``mod_main``'s time loop (``mod_main.cpp:146-168``)
    and ``rtm_main``'s forward half (``rtm_main.cpp:166-188``). Per step:
    leapfrog update, source injection into the *new* field, taper both
    fields, record from the tapered *old* field, swap. ``lap_impl`` selects
    the Laplacian (:func:`laplacian_of`): the exact taps, or split bf16 as
    the JAX package's tier for the record mode runs them: for traces (or
    none) the x taps, as ``forward_modeling_pallas(lap_impl=...)`` does;
    for the wavefield the z taps, as ``forward_modeling_tiled(record=
    "wavefield", lap_impl=...)`` does (``rtm_main``'s recording kernel).

    Returns ``(p, pp, recorded)``: the final fields (ns, nxe, nze) and, by
    ``record``, the (ns, nt, nx) seismograms ``seis[s, it, ix] =
    p[ix + nxb, gz]`` (``"trace"``), the (ns, nt, nx, nz) interior of the
    tapered time-t field (``"wavefield"``, ``rtm_main.cpp:177-181``), or
    None (``"none"``)."""
    if record not in RECORD_MODES:
        raise ValueError(f"unknown record mode {record!r}")
    sxs = shot_positions(sx)
    wav = host_wavelet(wavelet)
    mask = _mask(ctx, taper, v2.device)
    patch = _patch(ctx, source, v2.device)
    lap = laplacian_of(ctx, lap_impl,
                       axis="z" if record == "wavefield" else "x")
    p = _zero_fields(ctx, len(sxs), v2)
    pp = _zero_fields(ctx, len(sxs), v2)
    rec = None
    if record == "trace":
        rec = v2.new_empty((len(sxs), ctx.nt, ctx.nx))
    elif record == "wavefield":
        rec = v2.new_empty((len(sxs), ctx.nt, ctx.nx, ctx.nz))
    for it in range(ctx.nt):
        p, pp = _mod_step(ctx, p, pp, v2, mask, float(wav[it]), sxs, sz,
                          patch, lap)
        if record == "trace":
            rec[:, it] = pp[:, ctx.nxb:ctx.nxb + ctx.nx, gz]
        elif record == "wavefield":
            rec[:, it] = _interior(ctx, pp)
    return p, pp, rec


def mod_kstep(ctx: FDContext, p, pp, v2, amps, sx, sz: int, gz: int,
              source: str = "gaussian", taper: str = "all", lap=None):
    """K ``mod_main`` steps from the state ``(p, pp)`` (ns, nxe, nze), K =
    ``len(amps)``: the plain version of the ``kstep_mod`` kernel and the
    body of the JAX package's ``_kstep_kernel`` (``ops/pallas_stream.py:
    637-647``: update, inject, taper, record the trace at gz), with the
    ``source`` (Gaussian or point) and ``taper`` (all-edge or top strip)
    of :func:`forward_modeling`. ``amps`` are the K wavelet samples of
    this pass; ``lap``: the Laplacian (:func:`fd_update`). Returns ``(p,
    pp, rec)`` with rec (ns, K, nx): row gz of each step's tapered old
    field, as :func:`forward_modeling` records it."""
    sxs = shot_positions(sx)
    amps = host_wavelet(amps)
    mask = _mask(ctx, taper, p.device)
    patch = _patch(ctx, source, p.device)
    rec = p.new_empty((p.shape[0], len(amps), ctx.nx))
    for k, amp in enumerate(amps):
        p, pp = _mod_step(ctx, p, pp, v2, mask, float(amp), sxs, sz, patch,
                          lap)
        rec[:, k] = pp[:, ctx.nxb:ctx.nxb + ctx.nx, gz]
    return p, pp, rec


def _injection_rows(ctx: FDContext, dobs, next_shot_first):
    """Receiver-injection rows with ``rtm_main``'s flat-read quirk, for a
    batch of shots (the JAX package's ``_injection_rows``, ``solver.py:
    534-551``).

    The reference injects ``dobs[is][ix][nt-it]`` (``rtm_main.cpp:202``),
    which at it=0 reads one float past each trace: the next trace's first
    sample, and for the shot's last trace the next shot's first sample,
    given here per shot as ``next_shot_first`` (ns,). ``dobs`` is
    (ns, nx, nt). Returns (ns, nt, nx) rows with ``inj[s, it, ix] =
    dpad[s, ix, nt - it]``, ``dpad`` being ``dobs`` with one zero sample
    appended per trace, and row 0 ``dobs[s, 1:, 0]`` then
    ``next_shot_first[s]``."""
    ns = dobs.shape[0]
    dpad = torch.cat([dobs, dobs.new_zeros((ns, ctx.nx, 1))], dim=2)
    inj = dpad.flip(2)[:, :, :ctx.nt].transpose(1, 2).contiguous()
    nxt = torch.as_tensor(next_shot_first, dtype=dobs.dtype,
                          device=dobs.device).reshape(-1).expand(ns)
    inj[:, 0] = torch.cat([dobs[:, 1:, 0], nxt[:, None]], dim=1)
    return inj


def receiver_offset(ctx: FDContext, x_off_quirk: bool = True) -> int:
    """First x row of ``rtm_main``'s receiver injection: ``nzb`` where
    ``nxb`` is meant with the quirk on (``rtm_main.cpp:202``), else
    ``nxb``; clamped into the grid as the JAX package's
    ``dynamic_update_slice`` clamps it (:func:`.ops.stencil.receiver_x0`)."""
    return receiver_x0(ctx.nzb if x_off_quirk else ctx.nxb, ctx.nx, ctx.nxe)


def backward_recorded(ctx: FDContext, v2, dobs, gz: int,
                      x_off_quirk: bool = True, next_shot_first=0.0,
                      lap=None):
    """``rtm_main``'s backward half (``rtm_main.cpp:196-220``) for a batch
    of shots: propagate the time-reversed observed data ``dobs`` (ns, nx,
    nt), injected along row ``gz`` (:func:`_injection_rows`, at the x
    offset of :func:`receiver_offset`), with the CPU-flavor step and the
    top-strip taper, and record the interior of the tapered time-t field.
    ``next_shot_first`` is one number or one per shot; ``lap``: the
    Laplacian (:func:`fd_update`). The plain version of ``rec_bwd_step``
    and ``rec_bwd_step_mma`` in frame mode.

    Returns ``(p, pp, rwf)`` with rwf (ns, nt, nx, nz)."""
    mask = torch.as_tensor(ctx.mask_top, device=v2.device)
    x0 = receiver_offset(ctx, x_off_quirk)
    inj = _injection_rows(ctx, dobs, next_shot_first)
    ns = dobs.shape[0]
    p = _zero_fields(ctx, ns, dobs)
    pp = _zero_fields(ctx, ns, dobs)
    rwf = dobs.new_empty((ns, ctx.nt, ctx.nx, ctx.nz))
    for it in range(ctx.nt):
        pm, new = _step(ctx, p, pp, v2, mask, inj_row=inj[:, it], x0=x0,
                        gz=gz, lap=lap)
        rwf[:, it] = _interior(ctx, pm)
        p, pp = new, pm
    return p, pp, rwf


def backward_image(ctx: FDContext, v2, swf, dobs, gz: int,
                   x_off_quirk: bool = True, next_shot_first=0.0, lap=None):
    """:func:`backward_recorded` (with the Laplacian ``lap``) then
    ``rtm_main``'s zero-lag correlation with the stored source wavefield
    ``swf`` (ns, nt, nx, nz): ``imloc = sum_it swf[nt-1-it] * rwf[it]``
    (``rtm_main.cpp:223-229``), summed as ``jnp.sum(swf[::-1] * rwf,
    axis=0)`` sums. Returns the (ns, nx, nz) per-shot images."""
    _, _, rwf = backward_recorded(ctx, v2, dobs, gz, x_off_quirk=x_off_quirk,
                                  next_shot_first=next_shot_first, lap=lap)
    return (swf.flip(1) * rwf).sum(1)


def rtm_shot_full(ctx: FDContext, v2, wavelet, dobs, sx, sz: int, gz: int,
                  x_off_quirk: bool = True, next_shot_first=0.0,
                  lap_impl=None):
    """Full-wavefield-storage RTM, the ``rtm_main`` shot body
    (``rtm_main.cpp:158-247``): :func:`forward_modeling` with a point
    source, the top-strip taper and ``record="wavefield"``, then
    :func:`backward_image`, both with the Laplacian ``lap_impl`` selects:
    the exact taps, or the z taps in split bf16, as the JAX K-step
    recording kernel (``_kstep_rec_kernel``) takes them. Returns the (ns,
    nx, nz) per-shot images."""
    _, _, swf = forward_modeling(ctx, v2, wavelet, sx, sz, gz,
                                 source="point", taper="top",
                                 record="wavefield", lap_impl=lap_impl)
    return backward_image(ctx, v2, swf, dobs, gz, x_off_quirk=x_off_quirk,
                          next_shot_first=next_shot_first,
                          lap=laplacian_of(ctx, lap_impl, axis="z"))


def _gpu_step(ctx: FDContext, y, x, v2, mask, gz: int = 0, inj_row=None,
              img=None, src=None, lap=None):
    """One taper-first step from the state ``(x, y)``: ``t = y*m``, ``new =
    2t - x*m + v2*dt2*lap(t)``, the receiver row ``inj_row`` (ns, nx) added
    at depth gz (K5), and ``img += src * new`` over the interior (K6).
    The Laplacian ``lap`` (:func:`fd_update`) takes the tapered ``t``, as
    the JAX whole-shot kernel's tapered leap does. Returns ``(t, new)``,
    or ``(t, new, img)`` with ``img``."""
    t = y * mask
    new = fd_update(ctx, t, x * mask, v2, lap)
    if inj_row is not None:
        new = inject_receivers(new, inj_row, ctx.nxb, gz)
    if img is None:
        return t, new
    return t, new, imaging_correlation(img, src, new, ctx.nxb, ctx.nzb)


def fd_step_gpu(ctx: FDContext, y, x, v2, gz: int = 0, inj_row=None,
                img=None, src=None, lap=None):
    """One taper-first step (top-strip taper) from the state ``(x, y)``
    (ns, nxe, nze): the plain version of the ``gpu_step`` kernel and of the
    JAX package's ``_kernel_gpu`` (``ops/pallas_stream.py:207-267``).
    ``t = y*m``, ``new = 2t - x*m + v2*dt2*lap(t)``; with ``inj_row`` (ns,
    nx) the receiver row is added at depth gz (K5); with ``img`` (ns, nx,
    nz), ``img + src * new`` over the interior (K6); ``lap``: the Laplacian
    (:func:`fd_update`). Returns ``(t, new)``, or ``(t, new, img)``."""
    return _gpu_step(ctx, y, x, v2, _mask(ctx, "top", y.device), gz,
                     inj_row, img, src, lap)


def fd_forward_kstep(ctx: FDContext, p, pp, v2, amps, sx, sz: int,
                     lap=None):
    """K ``fd_forward`` steps from the state ``(p, pp)`` (ns, nxe, nze), K =
    ``len(amps)``: the plain version of the ``kstep_gpu_fwd`` kernel and the
    body of the JAX package's ``_kstep_gpu_fwd_kernel``
    (``ops/pallas_stream.py:788-791``): per step ``t = pp*m``, ``pp' = 2t -
    p*m + v2*dt2*lap(t) + amp`` at (sx, sz), ``p' = t``; ``lap``: the
    Laplacian (:func:`fd_update`). Returns ``(p, pp)``."""
    sxs = shot_positions(sx)
    mask = _mask(ctx, "top", p.device)
    for amp in host_wavelet(amps):
        p, pp = _gpu_step(ctx, pp, p, v2, mask, lap=lap)
        pp = inject_point(pp, sxs, sz, float(amp))
    return p, pp


def fd_back_kstep(ctx: FDContext, ps, pps, pr, ppr, img, v2, inj_rows,
                  gz: int, lap=None):
    """K ``fd_back`` steps (it >= 2) from the state ``(ps, pps, pr, ppr,
    img)``: the plain version of the ``kstep_gpu_bwd`` kernel and the body
    of the JAX package's ``_kstep_gpu_bwd_kernel``
    (``ops/pallas_stream.py:914-921``). Per step: the untapered source
    reconstruction ``s = 2ps - pps + v2*dt2*lap(ps)``, the tapered receiver
    step with ``inj_rows[:, k]`` added at depth gz (K5), and ``img += s *
    pr'`` over the interior (K6), in time order. ``inj_rows`` is (ns, K,
    nx); ``img`` (ns, nx, nz); ``lap``: the Laplacian of both propagations
    (:func:`fd_update`). Returns the next state."""
    mask = _mask(ctx, "top", ps.device)
    for k in range(inj_rows.shape[1]):
        ps, pps = fd_update(ctx, ps, pps, v2, lap), ps
        ppr, pr, img = _gpu_step(ctx, pr, ppr, v2, mask, gz, inj_rows[:, k],
                                 img, ps, lap)
    return ps, pps, pr, ppr, img


def fd_forward(ctx: FDContext, v2, wavelet, sx, sz: int, lap=None):
    """GPU-suite forward propagation (``fd_forward``, ``fd-code.cu:247-288``).
    Per step: swap, taper both fields (top strip), Laplacian + leapfrog,
    point source into the new field; ``lap``: the Laplacian
    (:func:`fd_update`). Returns ``(p, pp)``, the final two states (ns,
    nxe, nze): the snapshots :func:`fd_back` starts from."""
    ns = len(shot_positions(sx))
    return fd_forward_kstep(ctx, _zero_fields(ctx, ns, v2),
                            _zero_fields(ctx, ns, v2), v2, wavelet, sx, sz,
                            lap)


def _seed_steps(ctx: FDContext, v2, snap0, snap1, inj, gz: int,
                step=None):
    """``fd_back``'s steps it = 0, 1 (at most nt of them), whose source field
    is the snapshot ``snap1`` then ``snap0`` (``fd-code.cu:311-315``), each
    a taper-first receiver step with K5 and K6 through ``step``
    (:func:`fd_step_gpu`, or its kernel's wrapper). ``inj`` is (ns, nt,
    nx). Returns the state ``(ps, pps, pr, ppr, img)`` after them."""
    step = step or fd_step_gpu
    ns = snap0.shape[0]
    ps = pps = pr = ppr = _zero_fields(ctx, ns, snap0)
    img = snap0.new_zeros((ns, ctx.nx, ctx.nz))
    for it, snap in enumerate((snap1, snap0)[:ctx.nt]):
        ps, pps = snap, ps
        ppr, pr, img = step(ctx, pr, ppr, v2, gz, inj[:, it], img, ps)
    return ps, pps, pr, ppr, img


def fd_back(ctx: FDContext, v2, snap0, snap1, dobs, gz: int, lap=None):
    """GPU-suite backward propagation and imaging (``fd_back``,
    ``fd-code.cu:290-341``).

    The source field is re-seeded from the snapshots at it=0, 1 (``snap1``
    then ``snap0``) and re-propagated without taper; the receiver field is
    tapered (top strip), updated, and gets the time-reversed ``dobs``
    (ns, nx, nt) added along row ``gz`` (K5); ``imloc += p * pr`` over the
    interior every step (K6); ``lap``: the Laplacian of both propagations
    (:func:`fd_update`). Returns the (ns, nx, nz) per-shot images."""
    inj = dobs.flip(-1).transpose(1, 2)   # inj[:, it] = dobs[..., nt-1-it]
    state = _seed_steps(ctx, v2, snap0, snap1, inj, gz,
                        functools.partial(fd_step_gpu, lap=lap))
    return fd_back_kstep(ctx, *state, v2, inj[:, 2:], gz, lap)[4]


def rtm_shot_snapshot(ctx: FDContext, v2, wavelet, dobs, sx, sz: int,
                      gz: int, lap_impl=None):
    """Two-snapshot RTM (``fd-code.cu:480-529``): :func:`fd_forward` to the
    final two states, then :func:`fd_back`, with the Laplacian ``lap_impl``
    selects (:func:`laplacian_of`), as the JAX package's
    ``rtm_snapshot_pallas(lap_impl=...)`` runs it: the tapered leaps take
    the tapered field ``m*f``, the source reconstruction the untapered
    one. Returns (ns, nx, nz) images."""
    lap = laplacian_of(ctx, lap_impl)
    p, pp = fd_forward(ctx, v2, wavelet, sx, sz, lap)
    return fd_back(ctx, v2, p, pp, dobs, gz, lap)


def forward_modeling_tiled(ctx: FDContext, v2, wavelet, sx, sz: int,
                           gz: int, source: str = "gaussian",
                           taper: str = "all", record: str = "trace",
                           block_k: int = 1, lap_impl=None):
    """:func:`forward_modeling` through the large-grid tier (the JAX
    package's ``forward_modeling_tiled``, ``solver.py:184-355``), with its
    ``source``, ``taper`` and ``record`` modes. Returns ``(p, pp,
    recorded)`` as :func:`forward_modeling`, bitwise its on the CPU (under
    a split ``lap_impl``, where it splits the z taps: the wavefield).

    ``block_k=1``, the per-step streaming tier: one
    :func:`.ops.stream.fd_step_cuda` a step (the ``fd_step`` kernel on the
    card, the injection folded in before the taper; :func:`fd_step` on the
    CPU) into two buffer pairs swapped every step, and the record taken
    from the tapered old field. ``block_k`` in 2..8: nt // K passes of K
    fused steps and one tail pass of nt % K through
    :func:`.ops.stream.mod_kstep_cuda` (``kstep_mod``) for traces or none;
    wavefield recording runs ``rec_fwd_step``
    (:func:`.ops.fd_kernels.forward_modeling_cuda`), the port of the JAX
    K-step recording kernel.

    ``lap_impl`` (:func:`.ops.fd_kernels.lap_parts`) as in the JAX
    package: a split-bf16 tier takes the z taps in 2 or 3 bf16 parts (the
    JAX streaming kernels' ``use_mxu`` branch; :func:`laplacian_of` with
    ``axis="z"`` on the CPU): ``fd_step_mma`` at K = 1, ``kstep_mod_mma``
    at K >= 2, ``rec_fwd_step_mma`` for the wavefield at K >= 2."""
    from .ops import stream
    from .ops.fd_kernels import (forward_modeling_cuda, lap_parts, _check_gz,
                                 _check_wavelet)
    K = stream.check_block_k(block_k)
    parts = lap_parts(lap_impl, ctx)
    if record not in RECORD_MODES:
        raise ValueError(f"unknown record mode {record!r}")
    if taper not in ("all", "top"):
        raise ValueError(f"unknown taper {taper!r}")
    sxs = shot_positions(sx)
    wav = _check_wavelet(ctx, wavelet)
    if K > 1 and record == "wavefield":
        return forward_modeling_cuda(ctx, v2, wav, sxs, sz, gz, source=source,
                                     taper=taper, record=record,
                                     lap_impl=parts)
    consts = stream.prepare(ctx, v2, sxs, source=source, taper=taper)
    ns = len(sxs)
    p = _zero_fields(ctx, ns, v2)
    pp = _zero_fields(ctx, ns, v2)
    rec = None
    if record == "trace":
        rec = v2.new_empty((ns, ctx.nt, ctx.nx))
    elif record == "wavefield":
        rec = v2.new_empty((ns, ctx.nt, ctx.nx, ctx.nz))
    if K > 1:
        for it0 in range(0, ctx.nt, K):
            amps = wav[it0:it0 + K]
            p, pp, tr = stream.mod_kstep_cuda(ctx, p, pp, v2, amps, sxs, sz,
                                              gz, source, taper,
                                              consts=consts, parts=parts)
            if rec is not None:
                rec[:, it0:it0 + len(amps)] = tr
        return p, pp, rec
    _check_gz(ctx, gz)
    spare = (torch.empty_like(p), torch.empty_like(p))
    for it in range(ctx.nt):
        pm, new = stream.fd_step_cuda(ctx, p, pp, v2, taper,
                                      amp=float(wav[it]), sx=sxs, sz=sz,
                                      source=source, consts=consts, out=spare,
                                      parts=parts)
        if record == "trace":
            rec[:, it] = pm[:, ctx.nxb:ctx.nxb + ctx.nx, gz]
        elif record == "wavefield":
            rec[:, it] = _interior(ctx, pm)
        spare = (p, pp)
        p, pp = new, pm
    return p, pp, rec


def _backward_steps(ctx: FDContext, v2, dobs, gz: int, x_off_quirk,
                    next_shot_first, parts: int, swf=None):
    """``rtm_main``'s backward half one :func:`.ops.stream.fd_step_cuda` a
    step (top-strip taper, the receiver row of :func:`_injection_rows` at
    :func:`receiver_offset` folded in before it; the z taps in ``parts``
    bf16 splits), two buffer pairs swapped every step. Without ``swf``
    returns ``(p, pp, rwf)``; with the source wavefield ``swf`` (ns, nt,
    nx, nz) returns the (ns, nx, nz) images,
    ``img += swf[:, nt-1-it] * frame`` each step in time order, so that no
    receiver wavefield is held."""
    from .ops import stream
    from .ops.fd_kernels import (_check, _check_dobs, _check_gz,
                                 _next_shot_first)
    ns = _check_dobs(ctx, dobs, v2.device)
    _check_gz(ctx, gz)
    if swf is not None:
        _check("swf", swf, (ns, ctx.nt, ctx.nx, ctx.nz), v2.device)
    inj = _injection_rows(ctx, dobs,
                          _next_shot_first(next_shot_first, ns, v2.device))
    x0 = receiver_offset(ctx, x_off_quirk)
    consts = stream.prepare(ctx, v2, [0], source="point", taper="top")
    p = _zero_fields(ctx, ns, dobs)
    pp = _zero_fields(ctx, ns, dobs)
    spare = (torch.empty_like(p), torch.empty_like(p))
    if swf is None:
        out = dobs.new_empty((ns, ctx.nt, ctx.nx, ctx.nz))
    else:
        out = dobs.new_zeros((ns, ctx.nx, ctx.nz))
    for it in range(ctx.nt):
        pm, new = stream.fd_step_cuda(ctx, p, pp, v2, "top",
                                      inj_row=inj[:, it], x0=x0, gz=gz,
                                      consts=consts, out=spare, parts=parts)
        if swf is None:
            out[:, it] = _interior(ctx, pm)
        else:
            out += swf[:, ctx.nt - 1 - it] * _interior(ctx, pm)
        spare = (p, pp)
        p, pp = new, pm
    return (p, pp, out) if swf is None else out


def backward_recorded_tiled(ctx: FDContext, v2, dobs, gz: int,
                            x_off_quirk: bool = True, next_shot_first=0.0,
                            block_k: int = 1, lap_impl=None):
    """:func:`backward_recorded` through the large-grid tier (the JAX
    package's ``backward_recorded_tiled``, ``solver.py:609-661``): at
    ``block_k=1`` one ``fd_step`` a step with the receiver row (the JAX
    tiled tier's missing clamp of the row is not copied: the row sits at
    :func:`receiver_offset`); at K in 2..8 ``rec_bwd_step`` in frame mode
    (:func:`.ops.fd_kernels.backward_recorded_cuda`), the port of the JAX
    K-step recording kernel; under a split ``lap_impl`` (the z taps in bf16
    parts, :func:`forward_modeling_tiled`) their ``*_mma`` twins. ``dobs``
    is (ns, nx, nt), ``next_shot_first`` one number or one per shot.
    Returns ``(p, pp, rwf)`` with rwf (ns, nt, nx, nz), bitwise
    :func:`backward_recorded`'s (with the same Laplacian) on the CPU."""
    from .ops import stream
    from .ops.fd_kernels import backward_recorded_cuda, lap_parts
    parts = lap_parts(lap_impl, ctx)
    if stream.check_block_k(block_k) > 1:
        return backward_recorded_cuda(ctx, v2, dobs, gz,
                                      x_off_quirk=x_off_quirk,
                                      next_shot_first=next_shot_first,
                                      lap_impl=parts)
    return _backward_steps(ctx, v2, dobs, gz, x_off_quirk, next_shot_first,
                           parts)


def rtm_shot_full_tiled(ctx: FDContext, v2, wavelet, dobs, sx, sz: int,
                        gz: int, x_off_quirk: bool = True,
                        next_shot_first=0.0, block_k: int = 1,
                        lap_impl=None):
    """:func:`rtm_shot_full` (``rtm_main``) through the large-grid tier (the
    JAX package's ``rtm_shot_full_tiled``, ``solver.py:724-748``). At
    ``block_k=1``: :func:`forward_modeling_tiled` stores the source
    wavefield (point source, top taper), then the backward steps add
    ``swf[:, nt-1-it] * frame`` into the image each step, in time order, so
    the card holds one wavefield volume, as ``rec_bwd_step``'s image mode
    does. At K in 2..8: :func:`.ops.fd_kernels.rtm_full_cuda`
    (``rec_fwd_step``, ``rec_bwd_step``). ``lap_impl`` as in
    :func:`forward_modeling_tiled`: a split tier runs the ``*_mma`` twins.
    Returns the (ns, nx, nz) images; on the CPU they equal
    :func:`rtm_shot_full`'s (with the same ``lap_impl``) up to the
    summation order of the image."""
    from .ops import stream
    from .ops.fd_kernels import lap_parts, rtm_full_cuda
    parts = lap_parts(lap_impl, ctx)
    if stream.check_block_k(block_k) > 1:
        return rtm_full_cuda(ctx, v2, wavelet, dobs, sx, sz, gz,
                             x_off_quirk=x_off_quirk,
                             next_shot_first=next_shot_first, lap_impl=parts)
    _, _, swf = forward_modeling_tiled(ctx, v2, wavelet, sx, sz, gz,
                                       source="point", taper="top",
                                       record="wavefield", block_k=1,
                                       lap_impl=parts)
    return _backward_steps(ctx, v2, dobs, gz, x_off_quirk, next_shot_first,
                           parts, swf)


def rtm_shot_snapshot_tiled(ctx: FDContext, v2, wavelet, dobs, sx, sz: int,
                            gz: int, block_k: int = 1, lap_impl=None):
    """:func:`rtm_shot_snapshot` through the large-grid tier (the JAX
    package's ``rtm_shot_snapshot_tiled`` and ``_rtm_snapshot_kblocked``,
    ``solver.py:362-531``). ``block_k=1``: the forward one taper-first
    ``gpu_step`` a step, then the point source added into the new field;
    the backward seeded by the two taper-first steps from the snapshots,
    then per step the untapered source reconstruction (``fd_update``) and
    the receiver step with the trace row and imaging (``gpu_step``), each
    into buffers swapped every step. ``block_k`` in 2..8: the forward in
    nt // K passes of K ``fd_forward`` steps and a tail of nt % K; the same
    seed, then (nt - 2) // K passes of K ``fd_back`` steps and a tail. On
    the card the steps and passes run the kernels of :mod:`.ops.stream`;
    on the CPU their plain versions, bitwise :func:`rtm_shot_snapshot`.
    ``dobs`` is (ns, nx, nt). Returns the (ns, nx, nz) images.

    ``lap_impl`` (:func:`.ops.fd_kernels.lap_parts`) as in the JAX
    package: a split-bf16 tier takes the z taps in 2 or 3 bf16 parts
    (:func:`laplacian_of` with ``axis="z"`` on the CPU): ``gpu_step_mma``
    and ``fd_update_mma`` at K = 1; ``kstep_gpu_fwd_mma``, ``gpu_step_mma``
    (the seed steps) and ``kstep_gpu_bwd_mma`` at K >= 2."""
    from .ops import stream
    from .ops.fd_kernels import lap_parts, _check_wavelet, _check_window
    K = stream.check_block_k(block_k)
    parts = lap_parts(lap_impl, ctx)
    sxs = shot_positions(sx)
    wav = _check_wavelet(ctx, wavelet)
    _check_window(ctx, sxs, sz, 0)
    consts = stream.prepare(ctx, v2, sxs, source="point", taper="top")
    ns = len(sxs)
    p = _zero_fields(ctx, ns, v2)
    pp = _zero_fields(ctx, ns, v2)
    if K == 1:
        shots = torch.arange(ns, device=v2.device)
        xs = torch.as_tensor(sxs, device=v2.device)
        spare = (torch.empty_like(p), torch.empty_like(p))
        for amp in wav:
            t, new = stream.fd_step_gpu_cuda(ctx, pp, p, v2, consts=consts,
                                             out=spare, parts=parts)
            new[shots, xs, sz] += float(amp)
            spare = (p, pp)
            p, pp = t, new
    else:
        for it0 in range(0, ctx.nt, K):
            p, pp = stream.fd_forward_kstep_cuda(ctx, p, pp, v2,
                                                 wav[it0:it0 + K], sxs, sz,
                                                 consts=consts, parts=parts)
    inj = dobs.flip(-1).transpose(1, 2).contiguous()     # (ns, nt, nx)
    step = functools.partial(stream.fd_step_gpu_cuda, consts=consts,
                             parts=parts)
    state = _seed_steps(ctx, v2, p, pp, inj, gz, step)
    if K > 1:
        for it0 in range(2, ctx.nt, K):
            state = stream.fd_back_kstep_cuda(ctx, *state, v2,
                                              inj[:, it0:it0 + K], gz,
                                              consts=consts, parts=parts)
        return state[4]
    ps, pps, pr, ppr, img = state
    spare_s = torch.empty_like(ps)
    spare_r = (torch.empty_like(ps), torch.empty_like(ps))
    for it in range(2, ctx.nt):
        src = stream.fd_update_cuda(ctx, ps, pps, v2, consts=consts,
                                    out=spare_s, parts=parts)
        spare_s, pps, ps = pps, ps, src
        t, new, img = stream.fd_step_gpu_cuda(ctx, pr, ppr, v2, gz,
                                              inj[:, it], img, ps,
                                              consts=consts, out=spare_r,
                                              parts=parts)
        spare_r = (pr, ppr)
        ppr, pr = t, new
    return img
