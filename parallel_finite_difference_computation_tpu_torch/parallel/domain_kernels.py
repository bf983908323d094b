"""x-domain-decomposed modeling and two-snapshot RTM on block kernels: the
port's counterpart of the JAX package's ``parallel/domain_pallas.py``.

The extended grid's x axis is cut into ``n_x`` slabs of ``nxl`` rows (nxe
zero-padded up to a multiple of ``n_x``), one per position of the mesh's
``x`` axis; shots split over its ``shot`` axis. Every block of K steps, each
slab takes ``H = K*h`` rows of halo from each neighbour (:func:`exchange`)
and then advances K steps on its halo-extended slab in one kernel launch:
the exact region shrinks by h rows a step, so after K steps the owned rows
are exact (communication-avoiding blocking; the JAX package's module
docstring has the argument). Slabs at the grid's edge get zero halos.

A slab's state lives in (ns, nxw, nze) buffers, ``nxw = nxl + 2H``, z
contiguous: the owned rows in the middle, the halo rows around them. A
kernel reads such buffers and writes the owned rows of output buffers that
no block of its launch reads; the makers keep two buffer sets per slab,
allocated zero once a run, and swap them every block, so the grid edges'
halo rows, which nothing writes, stay zero. (A plain block function
returns new buffers with zero halo rows.) :func:`exchange` then fills the
inner halo rows from the neighbours' owned rows: a copy on the stream where
both lie on one device, a peer copy between two devices, which
``Tensor.copy_`` orders against both devices' current streams with CUDA
events. Positions that share a device run in turn on its stream.

The three block kernels (``csrc/domain_block.cu``) and their plain torch
versions here, the wrappers routing CPU tensors to the plain versions and
CUDA tensors to the kernels (no fallback; ``LAUNCHES`` counts one per
kernel launch, and only there):

| kernel | plain version | replaces (JAX package, ``parallel/domain_pallas.py``) |
|---|---|---|
| ``block_mod`` | :func:`block_mod` | ``_mod_block_kernel`` (:189) |
| ``block_fwd`` | :func:`block_fwd` | ``_fwd_block_kernel`` (:115) |
| ``block_bwd`` | :func:`block_bwd` | ``_bwd_block_kernel`` (:136) |

The plain versions run the steps of the JAX block kernels in their order
and rounding: the update ``2p - pp + v2m*lap(p)`` with ``v2m = v2*dt2``
zero outside the global Laplacian interior (so that a slab's zero-bordered
Laplacian times ``v2m`` is the unsharded grid's), the taper as the whole-
grid plain loops apply it, and the image summed per block from zero, then
added to the running image, the interior mask applied once at the end
(``domain_pallas.py:161, :178, :492, :506-510``). Against the whole-grid
per-step tier the image then differs by rounding only.

Not ported, as TPU-only apparatus: ``_block_vmem_params``, the lane padding
``pad_to`` and ``_mxu_band_inputs`` (``lap_impl`` other than None/"vpu"
raises).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import numerics
from ..ops.fd_kernels import (_check_gz, _check_order, _check_window,
                              _coef_args, _on_cuda, _raise_on, _stream,
                              check_lap_impl)
from ..ops.stencil import laplacian
from ..ops.stream import MAX_STEPS
from ..solver import FDContext, host_wavelet, shot_positions
from .shots import split_shots

__all__ = ["LAUNCHES", "reset_launches", "Slab", "prepare_slabs", "exchange",
           "block_mod", "block_fwd", "block_bwd", "block_mod_cuda",
           "block_fwd_cuda", "block_bwd_cuda",
           "make_sharded_forward_modeling_cuda",
           "make_sharded_rtm_snapshot_cuda"]

LAUNCHES = {"block_mod": 0, "block_fwd": 0, "block_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Slab:
    """The static operands of one x-slab, made once a run on its device."""

    ctx: FDContext
    j: int                     # position on the mesh's x axis
    nxl: int                   # owned rows
    hs: int                    # halo rows a side, K*h
    device: torch.device
    v2m: torch.Tensor          # (1 or ns, nxw, nze) v2*dt2, 0 off the interior
    ramps: tuple               # (xramp (nxw,), zfac (nze,), strip (nze,))
    src: torch.Tensor          # (ns, 2r+1, nxw) source rows, or None
    r: int
    sz: int
    inj: torch.Tensor          # (ns, nt, nxw) time-reversed trace rows, or None
    gz: int
    coefs: tuple               # host coefficient arrays, kept alive
    coef_ptrs: tuple

    @property
    def nxw(self) -> int:
        return self.nxl + 2 * self.hs

    @property
    def row0(self) -> int:
        """Global row of the slab's first owned row."""
        return self.j * self.nxl

    @property
    def ns(self) -> int:
        return self.src.shape[0] if self.src is not None else self.inj.shape[0]

    @property
    def v2_stride(self) -> int:
        return 0 if self.v2m.shape[0] == 1 else self.nxw * self.ctx.nze

    def mask(self) -> torch.Tensor:
        """The taper plane of the slab, as the kernels rebuild it from the
        ramps (``kstep.cuh``, ``taper_at``): bitwise the mask plane inside
        the grid, 0 (taper strip) or the z factor beyond it."""
        xr, zf, st = self.ramps
        sel = torch.where(st[None, :] != 0, xr[:, None],
                          torch.ones((), dtype=xr.dtype, device=xr.device))
        return zf[None, :] * sel


def _slab_rows(a: torch.Tensor, lo: int, hi: int, nrows: int, device):
    """Rows [lo, hi) of ``a`` along dim -2 (or the last dim for a 1-D
    ``a``), 0 where they fall outside [0, nrows), on ``device``."""
    axis = a.dim() - 2 if a.dim() > 1 else 0
    shape = list(a.shape)
    shape[axis] = hi - lo
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    a0, a1 = max(lo, 0), min(hi, nrows)
    if a1 > a0:
        idx = [slice(None)] * a.dim()
        idx[axis] = slice(a0 - lo, a1 - lo)
        src = [slice(None)] * a.dim()
        src[axis] = slice(a0, a1)
        out[tuple(idx)] = a[tuple(src)].to(device)
    return out


def slab_geometry(ctx: FDContext, n_x: int, block_k: int):
    """``(nxl, K, H)`` of an x decomposition over ``n_x`` slabs with blocks
    of ``block_k`` steps; raises as the JAX package does when the halo
    outgrows a slab (``domain_pallas.py:246-249``)."""
    nxl = -(-ctx.nxe // n_x)
    h = ctx.order // 2
    K = int(block_k)
    if not 1 <= K <= MAX_STEPS:
        raise ValueError(f"block_k must be in [1, {MAX_STEPS}], got {K}")
    H = K * h
    if H > nxl:
        raise ValueError(
            f"halo width K*h={H} exceeds the local slab width nxl={nxl}; "
            f"lower block_k to <= {nxl // h} or use fewer x shards")
    return nxl, K, H


def prepare_slabs(ctx: FDContext, devices, block_k: int, v2, taper: str,
                  sxs=None, sz: int = 0, source: str = "point", dobs_ext=None,
                  gz: int = 0):
    """The :class:`Slab` of each position of one shot group, ``devices``
    its row of the mesh. ``v2`` is (nxe, nze), shared, or (ns, nxe, nze);
    ``sxs`` the shots' source rows (with ``source`` "point" or "gaussian"
    at depth ``sz``), or ``dobs_ext`` (ns, nxe, nt) the embedded gathers
    (:func:`.domain.embed_dobs`) whose time-reversed rows ``block_bwd``
    adds at depth ``gz``."""
    nxl, K, H = slab_geometry(ctx, len(devices), block_k)
    h = ctx.order // 2
    nxw = nxl + 2 * H
    v2 = torch.as_tensor(v2, dtype=torch.float32)
    v2 = v2[None] if v2.dim() == 2 else v2
    zrow = torch.zeros(ctx.nze)
    zrow[h:ctx.nze - h] = 1.0
    xramp, zfac, strip = (torch.from_numpy(a) for a in numerics.mask_ramps(
        ctx.mask_all, ctx.mask_top, taper, ctx.nzb))
    patch = (ctx.source_patch if source == "gaussian"
             else np.ones((1, 1), np.float32))
    r = patch.shape[0] // 2
    keep, ptrs = _coef_args(ctx)
    slabs = []
    for j, dev in enumerate(devices):
        lo = j * nxl - H
        glob = torch.arange(lo, lo + nxw)
        lane = ((glob >= h) & (glob < ctx.nxe - h)).float()
        interior = (lane[:, None] * zrow[None, :]).to(dev)
        v2m = _slab_rows(v2, lo, lo + nxw, ctx.nxe, dev) * ctx.dt2 * interior
        src = None
        if sxs is not None:
            # rows[s, dz + r, x] = patch[glob - sx + r, dz + r]: the Gaussian
            # rows exp(-dz^2 - dx^2) of domain_pallas.py:294-301, as the
            # whole-grid loops' patch holds them (or the one-hot row)
            rows = np.zeros((len(sxs), 2 * r + 1, nxw), np.float32)
            for s, sx in enumerate(sxs):
                for x in range(nxw):
                    dx = lo + x - sx
                    if abs(dx) <= r and 0 <= lo + x < ctx.nxe:
                        rows[s, :, x] = patch[dx + r, :]
            src = torch.from_numpy(rows).to(dev)
        inj = None
        if dobs_ext is not None:
            d = _slab_rows(torch.as_tensor(dobs_ext, dtype=torch.float32),
                           lo, lo + nxw, ctx.nxe, dev)     # (ns, nxw, nt)
            inj = d.flip(-1).transpose(1, 2).contiguous()  # (ns, nt, nxw)
        slabs.append(Slab(
            ctx=ctx, j=j, nxl=nxl, hs=H, device=torch.device(dev),
            v2m=v2m.contiguous(),
            ramps=(_slab_rows(xramp, lo, lo + nxw, ctx.nxe, dev),
                   zfac.to(dev), strip.to(dev)),
            src=src, r=r, sz=sz, inj=inj, gz=gz, coefs=keep,
            coef_ptrs=ptrs))
    return slabs


def exchange(slabs, *fields):
    """Fills the halo rows of each field's extended slab buffers (one list
    per field, over the x axis) from the neighbours' owned rows, in
    place. The global edges' halos stay as they are (zero)."""
    for bufs in fields:
        for j, c in enumerate(slabs):
            H, nxl = c.hs, c.nxl
            if j > 0:
                bufs[j][:, :H].copy_(bufs[j - 1][:, nxl:nxl + H])
            if j + 1 < len(slabs):
                bufs[j][:, H + nxl:].copy_(bufs[j + 1][:, H:2 * H])


def _owned(c: Slab, f):
    """``f`` with its halo rows set to zero (a new tensor)."""
    out = torch.zeros_like(f)
    out[:, c.hs:c.hs + c.nxl] = f[:, c.hs:c.hs + c.nxl]
    return out


def _update(c: Slab, p, pp):
    """``2p - pp + v2m*lap(p)`` on the slab (zero-bordered Laplacian)."""
    ctx = c.ctx
    return 2.0 * p - pp + c.v2m * laplacian(p, ctx.coefs_x, ctx.coefs_z,
                                            ctx.order)


def block_mod(c: Slab, p, pp, amps):
    """K = ``len(amps)`` ``mod_main`` steps on the extended slabs (ns, nxw,
    nze) from the state ``(p, pp)``: the plain version of ``block_mod`` and
    the body of ``_mod_block_kernel`` (``domain_pallas.py:201-210``): update,
    add ``amp * src`` on the source rows, taper the new and the old field,
    record row gz of the tapered old field on the owned rows. Returns
    ``(p, pp, rec)``, rec (ns, K, nxl)."""
    mask = c.mask()
    rows = slice(c.hs, c.hs + c.nxl)
    rec = p.new_empty((p.shape[0], len(amps), c.nxl))
    band = slice(c.sz - c.r, c.sz + c.r + 1)
    for k, amp in enumerate(host_wavelet(amps)):
        upd = _update(c, p, pp)
        upd[:, :, band] += float(amp) * c.src.transpose(1, 2)
        p, pp = upd * mask, p * mask
        rec[:, k] = pp[:, rows, c.gz]
    return _owned(c, p), _owned(c, pp), rec


def block_fwd(c: Slab, p, pp, amps):
    """K ``fd_forward`` steps on the extended slabs from the state ``(p,
    pp)``: the plain version of ``block_fwd`` and the body of
    ``_fwd_block_kernel`` (``domain_pallas.py:124-130``): ``t = pp*m``,
    ``pp' = 2t - p*m + v2m*lap(t)``, ``amp * src`` added on row sz, ``p' =
    t``. Returns ``(p, pp)``."""
    mask = c.mask()
    for amp in host_wavelet(amps):
        t = pp * mask
        new = _update(c, t, p * mask)
        new[:, :, c.sz] += float(amp) * c.src[:, 0]
        p, pp = t, new
    return _owned(c, p), _owned(c, pp)


def block_bwd(c: Slab, ps, pps, pr, ppr, img, it0: int, k: int,
              snaps=None):
    """K = ``k`` ``fd_back`` steps on the extended slabs from the state
    ``(ps, pps, pr, ppr)``, trace rows ``it0 .. it0+k-1``: the plain
    version of ``block_bwd`` and the body of ``_bwd_block_kernel``
    (``domain_pallas.py:163-178``): the untapered source step (with
    ``snaps = (snap0, snap1)``, the first block: ``snap1`` at step 0,
    ``snap0`` at step 1), the tapered receiver step with the trace row
    added on row gz, and the block's image delta, summed from 0 over the
    steps on the owned rows, added to ``img`` (ns, nxl, nze) at the end.
    Returns ``(ps, pps, pr, ppr, img)``."""
    mask = c.mask()
    delta = torch.zeros_like(ps)
    for i in range(k):
        if snaps is not None and i < 2:
            new_s = snaps[1 - i]
        else:
            new_s = _update(c, ps, pps)
        ps, pps = new_s, ps
        t = pr * mask
        new_r = _update(c, t, ppr * mask)
        new_r[:, :, c.gz] += c.inj[:, it0 + i]
        pr, ppr = new_r, t
        delta = delta + new_s * new_r
    rows = slice(c.hs, c.hs + c.nxl)
    return (_owned(c, ps), _owned(c, pps), _owned(c, pr), _owned(c, ppr),
            img + delta[:, rows])


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _check_state(c: Slab, **fields) -> int:
    first = next(iter(fields.values()))
    ns = first.shape[0]
    for name, f in fields.items():
        if f.device != c.device or f.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {c.device}")
        if tuple(f.shape) != (ns, c.nxw, c.ctx.nze) or not f.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"{(ns, c.nxw, c.ctx.nze)} slab, got "
                             f"{tuple(f.shape)}")
    if ns != c.ns or c.v2m.shape[0] not in (1, ns):
        raise ValueError(f"{ns} shots, the slab was prepared for {c.ns}")
    return ns


def _check_steps(c: Slab, k: int) -> None:
    if not 1 <= k <= MAX_STEPS or k * (c.ctx.order // 2) > c.hs:
        raise ValueError(f"{k} steps do not fit a block of the slab's "
                         f"halo H={c.hs}")


def _check_out(c: Slab, ins, out, n: int) -> None:
    """``out``, if given, holds ``n`` slab buffers apart from each other and
    from the inputs ``ins``: a block of the launch would read what another
    wrote."""
    if out is None:
        return
    if len(out) != n:
        raise ValueError(f"out takes {n} buffers, got {len(out)}")
    _check_state(c, **{f"out[{i}]": o for i, o in enumerate(out)})
    taken = {t.data_ptr() for t in ins}
    if len(taken | {o.data_ptr() for o in out}) != len(taken) + n:
        raise ValueError("the output buffers must be distinct from each "
                         "other and from the inputs")


def _outputs(like, out, n: int):
    """``out``, or ``n`` new buffers like ``like`` with zero halo rows."""
    return list(out) if out is not None else [torch.zeros_like(like)
                                              for _ in range(n)]


def block_mod_cuda(c: Slab, p, pp, amps, out=None):
    """One block of ``block_mod``: the kernel on the card, writing the owned
    rows of ``out = (p_out, pp_out)`` (new buffers with zero halo rows when
    None); :func:`block_mod` on the CPU, which returns new buffers.
    Returns ``(p, pp, rec)``."""
    amps = host_wavelet(amps)
    ns = _check_state(c, p=p, pp=pp)
    _check_steps(c, len(amps))
    if c.src is None:
        raise ValueError("the slab has no source rows")
    _check_out(c, (p, pp), out, 2)
    if not _on_cuda(p):
        return block_mod(c, p, pp, amps)
    from ..ops import _build
    k = len(amps)
    p_out, pp_out = _outputs(p, out, 2)
    rec = torch.empty((ns, k, c.nxl), dtype=torch.float32, device=p.device)
    xr, zf, st = c.ramps
    with torch.cuda.device(p.device):
        rc = _build.library().pfdc_block_mod_run(
            p.data_ptr(), pp.data_ptr(), p_out.data_ptr(), pp_out.data_ptr(),
            c.v2m.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), c.src.data_ptr(), c.r, c.sz, amps.ctypes.data, k,
            rec.data_ptr(), c.gz, ns, c.hs, c.nxl, c.ctx.nze, c.ctx.order,
            *c.coef_ptrs, _stream(p.device))
    _raise_on(rc, "block_mod")
    LAUNCHES["block_mod"] += 1
    return p_out, pp_out, rec


def block_fwd_cuda(c: Slab, p, pp, amps, out=None):
    """One block of ``block_fwd``: the kernel on the card, writing the owned
    rows of ``out`` as :func:`block_mod_cuda` does; :func:`block_fwd` on
    the CPU. Returns ``(p, pp)``."""
    amps = host_wavelet(amps)
    ns = _check_state(c, p=p, pp=pp)
    _check_steps(c, len(amps))
    if c.src is None or c.r != 0:
        raise ValueError("block_fwd takes one point-source row")
    _check_out(c, (p, pp), out, 2)
    if not _on_cuda(p):
        return block_fwd(c, p, pp, amps)
    from ..ops import _build
    p_out, pp_out = _outputs(p, out, 2)
    xr, zf, st = c.ramps
    with torch.cuda.device(p.device):
        rc = _build.library().pfdc_block_fwd_run(
            p.data_ptr(), pp.data_ptr(), p_out.data_ptr(), pp_out.data_ptr(),
            c.v2m.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), c.src.data_ptr(), c.sz, amps.ctypes.data,
            len(amps), ns, c.hs, c.nxl, c.ctx.nze, c.ctx.order,
            *c.coef_ptrs, _stream(p.device))
    _raise_on(rc, "block_fwd")
    LAUNCHES["block_fwd"] += 1
    return p_out, pp_out


def block_bwd_cuda(c: Slab, ps, pps, pr, ppr, img, it0: int, k: int,
                   snaps=None, out=None):
    """One block of ``block_bwd``: the kernel on the card, which writes the
    owned rows of the four ``out`` buffers as :func:`block_mod_cuda` does
    and adds the image delta into ``img`` (ns, nxl, nze) in place;
    :func:`block_bwd` on the CPU. Returns ``(ps, pps, pr, ppr, img)``."""
    ns = _check_state(c, ps=ps, pps=pps, pr=pr, ppr=ppr,
                      **({} if snaps is None else
                         {"snap0": snaps[0], "snap1": snaps[1]}))
    _check_steps(c, k)
    if c.inj is None or not 0 <= it0 <= c.ctx.nt - k:
        raise ValueError(f"trace rows {it0}..{it0 + k - 1} are not in the "
                         f"slab's (nt={c.ctx.nt})")
    if snaps is not None and k < 2:
        raise ValueError("the first backward block seeds both snapshots: "
                         "it needs k >= 2")
    if (img.device != c.device or img.dtype != torch.float32
            or tuple(img.shape) != (ns, c.nxl, c.ctx.nze)
            or not img.is_contiguous()):
        raise ValueError(f"img must be a contiguous float32 "
                         f"{(ns, c.nxl, c.ctx.nze)} tensor on {c.device}")
    _check_out(c, (ps, pps, pr, ppr, img, *(snaps or ())), out, 4)
    if not _on_cuda(ps):
        return block_bwd(c, ps, pps, pr, ppr, img, it0, k, snaps)
    from ..ops import _build
    outs = _outputs(ps, out, 4)
    xr, zf, st = c.ramps
    s0, s1 = (None, None) if snaps is None else (snaps[0].data_ptr(),
                                                 snaps[1].data_ptr())
    with torch.cuda.device(ps.device):
        rc = _build.library().pfdc_block_bwd_run(
            ps.data_ptr(), pps.data_ptr(), pr.data_ptr(), ppr.data_ptr(),
            *(o.data_ptr() for o in outs), s0, s1, img.data_ptr(),
            c.v2m.data_ptr(), c.v2_stride, xr.data_ptr(), zf.data_ptr(),
            st.data_ptr(), c.inj[:, it0].data_ptr(), c.inj.stride(0), c.gz,
            k, ns, c.hs, c.nxl, c.ctx.nze, c.ctx.order, *c.coef_ptrs,
            _stream(ps.device))
    _raise_on(rc, "block_bwd")
    LAUNCHES["block_bwd"] += 1
    return (*outs, img)


# --------------------------------------------------------------------------
# Makers
# --------------------------------------------------------------------------

def _zeros(slabs, ns: int, n: int):
    """``n`` fields of zero buffers, each a list over the slabs."""
    return [[torch.zeros((ns, c.nxw, c.ctx.nze), device=c.device)
             for c in slabs] for _ in range(n)]


def _advance(state, spare, j: int, outs) -> None:
    """Slab j's fields become ``outs``; their old buffers go to ``spare``,
    the outputs of the next block."""
    for f, s, o in zip(state, spare, outs):
        s[j], f[j] = f[j], o


def _gather(parts, nxe: int, device, dim: int):
    """The slabs' owned-row tensors joined in x order along ``dim`` on
    ``device``, cut to the grid's nxe rows."""
    out = torch.cat([t.to(device) for t in parts], dim=dim)
    return out.narrow(dim, 0, nxe)


def _image_mask(c: Slab):
    """(nxl, nze) 0/1 mask of the image interior on the slab's owned rows
    (the K6 region, ``domain_pallas.py:506-510``)."""
    ctx = c.ctx
    rows = torch.arange(c.row0, c.row0 + c.nxl, device=c.device)
    zs = torch.arange(ctx.nze, device=c.device)
    return (((rows >= ctx.nxb) & (rows < ctx.nxe - ctx.nxb))[:, None]
            & ((zs >= ctx.nzb) & (zs < ctx.nze - ctx.nzb))[None, :]).float()


def _check_mesh_and_k(ctx: FDContext, mesh, gz, block_k, lap_impl):
    check_lap_impl(lap_impl)
    _check_order(ctx)
    _check_gz(ctx, gz)
    return slab_geometry(ctx, mesh.shape["x"], block_k)


def make_sharded_forward_modeling_cuda(ctx: FDContext, mesh, sz: int,
                                       gz: int, source: str = "gaussian",
                                       taper: str = "all", block_k: int = 8,
                                       lap_impl=None):
    """Shot + x-domain-parallel forward modeling on the block kernels: the
    counterpart of ``make_sharded_forward_modeling_pallas``
    (``domain_pallas.py:220``). Returns ``fn(v2, sxs, wavelet) -> seis``
    with ``v2`` (nxe, nze) shared by the shots, or (ns, nxe, nze), ``sxs``
    (ns,) source rows, and ``seis`` (ns, nt, nxe) extended-row seismograms
    on the mesh's first device. nt // K blocks of K steps, then a tail of
    nt % K."""
    nxl, K, H = _check_mesh_and_k(ctx, mesh, gz, block_k, lap_impl)

    def fn(v2, sxs, wavelet):
        sxs = shot_positions(sxs)
        _check_window(ctx, sxs, sz, ctx.source_patch.shape[0] // 2
                      if source == "gaussian" else 0)
        wav = host_wavelet(wavelet)
        v2 = torch.as_tensor(v2, dtype=torch.float32)
        groups = []
        for i, idx in enumerate(split_shots(len(sxs), mesh.shape["shot"])):
            if not len(idx):
                continue
            slabs = prepare_slabs(
                ctx, list(mesh.devices[i]), K,
                v2 if v2.dim() == 2 else v2[idx], taper,
                sxs=[sxs[s] for s in idx], sz=sz, source=source, gz=gz)
            groups.append({
                "slabs": slabs, "state": _zeros(slabs, len(idx), 2),
                "spare": _zeros(slabs, len(idx), 2),
                "seis": [torch.empty((len(idx), ctx.nt, nxl), device=c.device)
                         for c in slabs]})
        for it0 in range(0, ctx.nt, K):
            amps = wav[it0:it0 + K]
            for g in groups:
                (p, pp), spare = g["state"], g["spare"]
                exchange(g["slabs"], p, pp)
                for j, c in enumerate(g["slabs"]):
                    *outs, rec = block_mod_cuda(
                        c, p[j], pp[j], amps, out=[f[j] for f in spare])
                    _advance(g["state"], spare, j, outs)
                    g["seis"][j][:, it0:it0 + len(amps)] = rec
        dev0 = mesh.devices[0, 0]
        return torch.cat([_gather(g["seis"], ctx.nxe, dev0, 2)
                          for g in groups])

    return fn


def make_sharded_rtm_snapshot_cuda(ctx: FDContext, mesh, sz: int, gz: int,
                                   block_k: int = 8, lap_impl=None):
    """Shot + x-domain-parallel two-snapshot RTM on the block kernels: the
    counterpart of ``make_sharded_rtm_snapshot_pallas``
    (``domain_pallas.py:346``). Returns ``fn(v2, sxs, wavelet, dobs_ext) ->
    imloc_ext`` with ``v2`` (ns, nxe, nze), ``sxs`` (ns,) source rows at
    depth ``sz``, ``dobs_ext`` (ns, nxe, nt) (:func:`.domain.embed_dobs`),
    and ``imloc_ext`` (ns, nxe, nze) extended per-shot images on the mesh's
    first device. The forward runs nt // K blocks and a tail; the backward
    a first block seeded by the snapshots, then blocks of K and a tail."""
    nxl, K, H = _check_mesh_and_k(ctx, mesh, gz, block_k, lap_impl)
    if K < 2:
        raise ValueError("block_k must be >= 2: the first backward block "
                         "seeds BOTH snapshots (steps 0 and 1)")
    if ctx.nt < 2 * K:
        raise ValueError(f"nt={ctx.nt} < 2*block_k={2 * K}: lower block_k "
                         f"to <= {ctx.nt // 2} (at least 2), or migrate on a "
                         f"shot-only mesh (n_x = 1)")

    def fn(v2, sxs, wavelet, dobs_ext):
        sxs = shot_positions(sxs)
        _check_window(ctx, sxs, sz, 0)
        wav = host_wavelet(wavelet)
        v2 = torch.as_tensor(v2, dtype=torch.float32)
        dobs_ext = torch.as_tensor(dobs_ext, dtype=torch.float32)
        groups = []
        for i, idx in enumerate(split_shots(len(sxs), mesh.shape["shot"])):
            if not len(idx):
                continue
            slabs = prepare_slabs(ctx, list(mesh.devices[i]), K, v2[idx],
                                  "top", sxs=[sxs[s] for s in idx], sz=sz,
                                  dobs_ext=dobs_ext[idx], gz=gz)
            groups.append({"slabs": slabs, "state": _zeros(slabs, len(idx), 2),
                           "spare": _zeros(slabs, len(idx), 2)})
        for it0 in range(0, ctx.nt, K):
            amps = wav[it0:it0 + K]
            for g in groups:
                (p, pp), spare = g["state"], g["spare"]
                exchange(g["slabs"], p, pp)
                for j, c in enumerate(g["slabs"]):
                    _advance(g["state"], spare, j, block_fwd_cuda(
                        c, p[j], pp[j], amps, out=[f[j] for f in spare]))
        # the final forward pair is the snapshots (snap0, snap1)
        for g in groups:
            exchange(g["slabs"], *g["state"])
            g["snaps"] = g.pop("state")
            ns = g["snaps"][0][0].shape[0]
            g["state"] = _zeros(g["slabs"], ns, 4)
            g["spare"] = _zeros(g["slabs"], ns, 4)
            g["img"] = [torch.zeros((ns, nxl, ctx.nze), device=c.device)
                        for c in g["slabs"]]
        for it0 in range(0, ctx.nt, K):
            k = min(K, ctx.nt - it0)
            for g in groups:
                state, spare, img = g["state"], g["spare"], g["img"]
                if it0:
                    exchange(g["slabs"], *state)
                for j, c in enumerate(g["slabs"]):
                    snaps = ([f[j] for f in g["snaps"]] if it0 == 0
                             else None)
                    *outs, img[j] = block_bwd_cuda(
                        c, *(f[j] for f in state), img[j], it0, k, snaps,
                        out=[f[j] for f in spare])
                    _advance(state, spare, j, outs)
                if it0 == 0:
                    del g["snaps"]               # the snapshots are spent
        dev0 = mesh.devices[0, 0]
        out = [_gather([im * _image_mask(c) for c, im in
                        zip(g["slabs"], g["img"])], ctx.nxe, dev0, 1)
               for g in groups]
        return torch.cat(out)

    return fn
