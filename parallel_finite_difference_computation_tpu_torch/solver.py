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

Shots: ``v2`` is (nxe, nze), shared by every shot, or (ns, nxe, nze);
``sx`` is one int or a sequence of one int per shot. Fields and outputs
always carry the shot axis first. The wavelet is a host float32 array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import numerics
from .config import Params
from .ops.stencil import (
    laplacian, leapfrog, inject_point, inject_gaussian, inject_receivers,
    imaging_correlation, receiver_x0,
)

__all__ = ["FDContext", "forward_modeling", "fd_forward", "fd_back",
           "rtm_shot_snapshot", "backward_recorded", "backward_image",
           "rtm_shot_full", "receiver_offset"]

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


def _fd_update(ctx: FDContext, p, pp, v2):
    """One Laplacian + leapfrog update (K1+K2; CPU ``fd_step``,
    ``timestep/fd.c:24-46``)."""
    lap = laplacian(p, ctx.coefs_x, ctx.coefs_z, ctx.order)
    return leapfrog(p, pp, v2, lap, ctx.dt2)


def _zero_fields(ctx: FDContext, ns: int, like):
    return like.new_zeros((ns, ctx.nxe, ctx.nze))


RECORD_MODES = ("trace", "wavefield", "none")


def _interior(ctx: FDContext, f):
    return f[:, ctx.nxb:ctx.nxb + ctx.nx, ctx.nzb:ctx.nzb + ctx.nz]


def forward_modeling(ctx: FDContext, v2, wavelet, sx, sz: int, gz: int,
                     source: str = "gaussian", taper: str = "all",
                     record: str = "trace"):
    """Forward modeling: ``mod_main``'s time loop (``mod_main.cpp:146-168``)
    and ``rtm_main``'s forward half (``rtm_main.cpp:166-188``). Per step:
    leapfrog update, source injection into the *new* field, taper both
    fields, record from the tapered *old* field, swap.

    Returns ``(p, pp, recorded)``: the final fields (ns, nxe, nze) and, by
    ``record``, the (ns, nt, nx) seismograms ``seis[s, it, ix] =
    p[ix + nxb, gz]`` (``"trace"``), the (ns, nt, nx, nz) interior of the
    tapered time-t field (``"wavefield"``, ``rtm_main.cpp:177-181``), or
    None (``"none"``)."""
    if record not in RECORD_MODES:
        raise ValueError(f"unknown record mode {record!r}")
    sxs = shot_positions(sx)
    wav = host_wavelet(wavelet)
    mask = torch.as_tensor(ctx.mask_all if taper == "all" else ctx.mask_top,
                           device=v2.device)
    patch = torch.as_tensor(ctx.source_patch, device=v2.device)
    p = _zero_fields(ctx, len(sxs), v2)
    pp = _zero_fields(ctx, len(sxs), v2)
    rec = None
    if record == "trace":
        rec = v2.new_empty((len(sxs), ctx.nt, ctx.nx))
    elif record == "wavefield":
        rec = v2.new_empty((len(sxs), ctx.nt, ctx.nx, ctx.nz))
    for it in range(ctx.nt):
        amp = float(wav[it])
        pp = _fd_update(ctx, p, pp, v2)
        if source == "gaussian":
            pp = inject_gaussian(pp, sxs, sz, amp, patch)
        else:
            pp = inject_point(pp, sxs, sz, amp)
        pp = pp * mask
        p = p * mask
        if record == "trace":
            rec[:, it] = p[:, ctx.nxb:ctx.nxb + ctx.nx, gz]
        elif record == "wavefield":
            rec[:, it] = _interior(ctx, p)
        p, pp = pp, p
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
                      x_off_quirk: bool = True, next_shot_first=0.0):
    """``rtm_main``'s backward half (``rtm_main.cpp:196-220``) for a batch
    of shots: propagate the time-reversed observed data ``dobs`` (ns, nx,
    nt), injected along row ``gz`` (:func:`_injection_rows`, at the x
    offset of :func:`receiver_offset`), with the CPU-flavor step and the
    top-strip taper, and record the interior of the tapered time-t field.
    ``next_shot_first`` is one number or one per shot.

    Returns ``(p, pp, rwf)`` with rwf (ns, nt, nx, nz)."""
    mask = torch.as_tensor(ctx.mask_top, device=v2.device)
    x0 = receiver_offset(ctx, x_off_quirk)
    inj = _injection_rows(ctx, dobs, next_shot_first)
    ns = dobs.shape[0]
    p = _zero_fields(ctx, ns, dobs)
    pp = _zero_fields(ctx, ns, dobs)
    rwf = dobs.new_empty((ns, ctx.nt, ctx.nx, ctx.nz))
    for it in range(ctx.nt):
        pp = _fd_update(ctx, p, pp, v2)
        pp = inject_receivers(pp, inj[:, it], x0, gz)
        pp = pp * mask
        p = p * mask
        rwf[:, it] = _interior(ctx, p)
        p, pp = pp, p
    return p, pp, rwf


def backward_image(ctx: FDContext, v2, swf, dobs, gz: int,
                   x_off_quirk: bool = True, next_shot_first=0.0):
    """:func:`backward_recorded` then ``rtm_main``'s zero-lag correlation
    with the stored source wavefield ``swf`` (ns, nt, nx, nz):
    ``imloc = sum_it swf[nt-1-it] * rwf[it]`` (``rtm_main.cpp:223-229``),
    summed as ``jnp.sum(swf[::-1] * rwf, axis=0)`` sums. Returns the
    (ns, nx, nz) per-shot images."""
    _, _, rwf = backward_recorded(ctx, v2, dobs, gz, x_off_quirk=x_off_quirk,
                                  next_shot_first=next_shot_first)
    return (swf.flip(1) * rwf).sum(1)


def rtm_shot_full(ctx: FDContext, v2, wavelet, dobs, sx, sz: int, gz: int,
                  x_off_quirk: bool = True, next_shot_first=0.0):
    """Full-wavefield-storage RTM, the ``rtm_main`` shot body
    (``rtm_main.cpp:158-247``): :func:`forward_modeling` with a point
    source, the top-strip taper and ``record="wavefield"``, then
    :func:`backward_image`. Returns the (ns, nx, nz) per-shot images."""
    _, _, swf = forward_modeling(ctx, v2, wavelet, sx, sz, gz,
                                 source="point", taper="top",
                                 record="wavefield")
    return backward_image(ctx, v2, swf, dobs, gz, x_off_quirk=x_off_quirk,
                          next_shot_first=next_shot_first)


def fd_forward(ctx: FDContext, v2, wavelet, sx, sz: int):
    """GPU-suite forward propagation (``fd_forward``, ``fd-code.cu:247-288``).
    Per step: swap, taper both fields (top strip), Laplacian + leapfrog,
    point source into the new field. Returns ``(p, pp)``, the final two
    states (ns, nxe, nze): the snapshots :func:`fd_back` starts from."""
    sxs = shot_positions(sx)
    wav = host_wavelet(wavelet)
    mask = torch.as_tensor(ctx.mask_top, device=v2.device)
    p = _zero_fields(ctx, len(sxs), v2)
    pp = _zero_fields(ctx, len(sxs), v2)
    for it in range(ctx.nt):
        p, pp = pp, p
        p = p * mask
        pp = pp * mask
        pp = _fd_update(ctx, p, pp, v2)
        pp = inject_point(pp, sxs, sz, float(wav[it]))
    return p, pp


def fd_back(ctx: FDContext, v2, snap0, snap1, dobs, gz: int):
    """GPU-suite backward propagation and imaging (``fd_back``,
    ``fd-code.cu:290-341``).

    The source field is re-seeded from the snapshots at it=0, 1 (``snap1``
    then ``snap0``) and re-propagated without taper; the receiver field is
    tapered (top strip), updated, and gets the time-reversed ``dobs``
    (ns, nx, nt) added along row ``gz`` (K5); ``imloc += p * pr`` over the
    interior every step (K6). Returns the (ns, nx, nz) per-shot images."""
    mask = torch.as_tensor(ctx.mask_top, device=v2.device)
    ns = snap0.shape[0]
    inj = dobs.flip(-1)               # inj[..., it] = dobs[..., nt-1-it]
    p = _zero_fields(ctx, ns, snap0)
    pp = _zero_fields(ctx, ns, snap0)
    pr = _zero_fields(ctx, ns, snap0)
    ppr = _zero_fields(ctx, ns, snap0)
    imloc = snap0.new_zeros((ns, ctx.nx, ctx.nz))
    for it in range(ctx.nt):
        if it == 0:
            ppn = snap1
        elif it == 1:
            ppn = snap0
        else:
            ppn = _fd_update(ctx, p, pp, v2)
        p, pp = ppn, p
        pr = pr * mask
        ppr = ppr * mask
        pprn = _fd_update(ctx, pr, ppr, v2)
        pprn = inject_receivers(pprn, inj[..., it], ctx.nxb, gz)
        imloc = imaging_correlation(imloc, p, pprn, ctx.nxb, ctx.nzb)
        pr, ppr = pprn, pr
    return imloc


def rtm_shot_snapshot(ctx: FDContext, v2, wavelet, dobs, sx, sz: int,
                      gz: int):
    """Two-snapshot RTM (``fd-code.cu:480-529``): :func:`fd_forward` to the
    final two states, then :func:`fd_back`. Returns (ns, nx, nz) images."""
    p, pp = fd_forward(ctx, v2, wavelet, sx, sz)
    return fd_back(ctx, v2, p, pp, dobs, gz)
