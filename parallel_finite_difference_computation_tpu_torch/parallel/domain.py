"""x-domain decomposition with a halo exchange every step: the port's
counterpart of the JAX package's ``parallel/domain.py`` (``:42-260,
357-368``).

These per-step loops are the plain reference of the domain tier and what
the pipeline runs on a mesh of CPU devices, as the JAX package runs its lax
makers off the TPU: torch eager ops over the slabs of a mesh row, the x
halo of ``order/2`` rows exchanged before every Laplacian, sources and
receivers injected through embedded fields. The tests hold them against
the JAX lax makers and the unsharded solver. A mesh with a CUDA device
runs the block kernels of :mod:`.domain_kernels` instead. A "slab list" is
one tensor per position of the mesh's ``x`` axis,
each (..., nxl, nz) on its position's device, holding rows ``[j*nxl,
(j+1)*nxl)`` of the grid zero-padded to ``n_x * nxl`` rows.

Left for the next slice (ROADMAP.md): ``make_sharded_rtm_full`` and
``embed_injection_rows``, ``rtm_main`` over an x mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import FDContext, host_wavelet
from .shots import distribute_shots

__all__ = ["halo_exchange", "sharded_laplacian",
           "make_sharded_forward_modeling", "make_sharded_rtm_snapshot",
           "embed_source_fields", "embed_dobs", "to_slabs", "from_slabs"]


def to_slabs(a, devices):
    """(..., nxe, nz) -> a slab list over ``devices`` (zero-padded rows)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    n_x = len(devices)
    nxe = a.shape[-2]
    nxl = -(-nxe // n_x)
    pad = a.new_zeros(a.shape[:-2] + (n_x * nxl - nxe, a.shape[-1]))
    a = torch.cat([a, pad], dim=-2)
    return [a[..., j * nxl:(j + 1) * nxl, :].to(d).contiguous()
            for j, d in enumerate(devices)]


def from_slabs(slabs, nxe: int, device, dim: int = -2):
    """A slab list joined along ``dim`` on ``device``, cut to nxe rows."""
    return torch.cat([s.to(device) for s in slabs], dim=dim).narrow(
        dim, 0, nxe)


def halo_exchange(slabs, h: int):
    """Each slab (..., nxl, nz) extended to (..., nxl + 2h, nz) with h rows
    from each x neighbour; the grid's edge slabs get zero halos (the
    Laplacian's zero border)."""
    out = []
    for j, f in enumerate(slabs):
        zero = f.new_zeros(f.shape[:-2] + (h, f.shape[-1]))
        left = slabs[j - 1][..., -h:, :].to(f.device) if j > 0 else zero
        right = (slabs[j + 1][..., :h, :].to(f.device)
                 if j + 1 < len(slabs) else zero)
        out.append(torch.cat([left, f, right], dim=-2))
    return out


def _row_interior_mask(nxe: int, nxl: int, h: int, j: int, device):
    """(nxl, 1) float mask: 1 where slab j's *global* row is in the
    Laplacian interior [h, nxe - h)."""
    rows = j * nxl + torch.arange(nxl, device=device)
    return ((rows >= h) & (rows < nxe - h)).float()[:, None]


def sharded_laplacian(slabs, coefs_x, coefs_z, order: int, nxe: int):
    """The x-sharded Laplacian of a slab list: local z taps, x taps from
    the halo-extended rows, zero outside the *global* interior; the taps
    in :func:`..ops.stencil.laplacian_interior`'s order, so bitwise the
    unsharded Laplacian."""
    h = order // 2
    cx = [float(v) for v in np.asarray(coefs_x, np.float32)]
    cz = [float(v) for v in np.asarray(coefs_z, np.float32)]
    out = []
    for j, (p, ext) in enumerate(zip(slabs, halo_exchange(slabs, h))):
        nxl, nz = p.shape[-2:]
        c = p[..., :, h:nz - h]
        accz = None
        for k in range(h, 0, -1):
            term = cz[h + k] * (p[..., :, h - k:nz - h - k]
                                + p[..., :, h + k:nz - h + k])
            accz = term if accz is None else accz + term
        accz = accz + cz[h] * c
        accx = None
        for k in range(h, 0, -1):
            term = cx[h + k] * (ext[..., h - k:nxl + h - k, h:nz - h]
                                + ext[..., h + k:nxl + h + k, h:nz - h])
            accx = term if accx is None else accx + term
        accx = accx + cx[h] * c
        lap = torch.nn.functional.pad(accz + accx, (h, h))
        out.append(lap * _row_interior_mask(nxe, nxl, h, j, p.device))
    return out


def _sharded_update(ctx: FDContext, p, pp, v2):
    lap = sharded_laplacian(p, ctx.coefs_x, ctx.coefs_z, ctx.order, ctx.nxe)
    return [2.0 * a - b + v * ctx.dt2 * l for a, b, v, l in zip(p, pp, v2, lap)]


def _embed_sources(ctx: FDContext, sx: int, sz: int, gaussian: bool):
    """(nxe, nze) injection field of a source at (sx, sz): one-hot (K4) or
    the ``ptsrc`` Gaussian patch."""
    f = np.zeros((ctx.nxe, ctx.nze), np.float32)
    if gaussian:
        r = ctx.source_patch.shape[0] // 2
        f[sx - r:sx + r + 1, sz - r:sz + r + 1] = ctx.source_patch
    else:
        f[sx, sz] = 1.0
    return f


def embed_source_fields(ctx: FDContext, sxs, sz: int,
                        gaussian: bool = False) -> np.ndarray:
    """(ns, nxe, nze) per-shot injection fields for sources at (sxs[i],
    sz)."""
    return np.stack([_embed_sources(ctx, int(sx), sz, gaussian)
                     for sx in sxs])


def embed_dobs(ctx: FDContext, dobs: np.ndarray) -> np.ndarray:
    """(ns, nx, nt) observed data -> (ns, nxe, nt) at the interior rows."""
    ns, nx, nt = dobs.shape
    out = np.zeros((ns, ctx.nxe, nt), np.float32)
    out[:, ctx.nxb:ctx.nxb + nx, :] = dobs
    return out


def _per_shot(v2, ns: int):
    v2 = torch.as_tensor(v2, dtype=torch.float32)
    return v2.expand(ns, *v2.shape[-2:]) if v2.dim() == 2 else v2


def make_sharded_forward_modeling(ctx: FDContext, mesh, gz: int,
                                  source: str = "gaussian",
                                  taper: str = "all"):
    """Shot + x-domain-parallel forward modeling, one halo exchange a step.
    Returns ``fn(v2, src_fields, wavelet) -> seis`` with ``v2`` (ns, nxe,
    nze) or (nxe, nze), ``src_fields`` (ns, nxe, nze)
    (:func:`embed_source_fields`) and ``seis`` (ns, nt, nxe) extended-row
    seismograms on the mesh's first device. ``source`` is carried by the
    fields; it names the JAX maker's argument."""
    mask_plane = ctx.mask_all if taper == "all" else ctx.mask_top

    def body(devices, v2, srcf, wav):
        v2, srcf = to_slabs(v2, devices), to_slabs(srcf, devices)
        mask = to_slabs(mask_plane, devices)
        p = [torch.zeros_like(v) for v in v2]
        pp = [torch.zeros_like(v) for v in v2]
        seis = []
        for amp in wav:
            pp = _sharded_update(ctx, p, pp, v2)
            pp = [a + float(amp) * s for a, s in zip(pp, srcf)]
            pp = [a * m for a, m in zip(pp, mask)]
            p = [a * m for a, m in zip(p, mask)]
            seis.append([a[..., gz] for a in p])
            p, pp = pp, p
        return [torch.stack([row[j] for row in seis], dim=1)
                for j in range(len(devices))]

    return _sharded(ctx, mesh, body, dim=-1)


def make_sharded_rtm_snapshot(ctx: FDContext, mesh, gz: int):
    """Shot + x-domain-parallel two-snapshot RTM (``fd-code.cu:480-529``),
    one halo exchange a step. Returns ``fn(v2, src_fields, wavelet,
    dobs_ext) -> imloc_ext`` with ``dobs_ext`` (ns, nxe, nt)
    (:func:`embed_dobs`) and ``imloc_ext`` (ns, nxe, nze) extended per-shot
    images on the mesh's first device (the interior ``[nxb:-nxb,
    nzb:-nzb]`` is the unsharded image)."""
    im = np.zeros((ctx.nxe, ctx.nze), np.float32)
    im[ctx.nxb:ctx.nxe - ctx.nxb, ctx.nzb:ctx.nze - ctx.nzb] = 1.0

    def body(devices, v2, srcf, wav, dobs_ext):
        v2, srcf = to_slabs(v2, devices), to_slabs(srcf, devices)
        mask = to_slabs(ctx.mask_top, devices)
        im_l = to_slabs(im, devices)
        inj = to_slabs(torch.as_tensor(dobs_ext).flip(-1), devices)
        p = [torch.zeros_like(v) for v in v2]
        pp = [torch.zeros_like(v) for v in v2]
        for amp in wav:
            p, pp = pp, p
            p = [a * m for a, m in zip(p, mask)]
            pp = [a * m for a, m in zip(pp, mask)]
            pp = _sharded_update(ctx, p, pp, v2)
            pp = [a + float(amp) * s for a, s in zip(pp, srcf)]
        snap0, snap1 = p, pp
        zero = [torch.zeros_like(v) for v in v2]
        p, pp, pr, ppr, imloc = zero, zero, zero, zero, zero
        for it in range(ctx.nt):
            ppn = ((snap1, snap0)[it] if it < 2
                   else _sharded_update(ctx, p, pp, v2))
            p, pp = ppn, p
            pr = [a * m for a, m in zip(pr, mask)]
            ppr = [a * m for a, m in zip(ppr, mask)]
            pprn = _sharded_update(ctx, pr, ppr, v2)
            for a, d in zip(pprn, inj):
                a[..., gz] += d[..., it]
            imloc = [i + a * b * m for i, a, b, m in zip(imloc, p, pprn, im_l)]
            pr, ppr = pprn, pr
        return imloc

    return _sharded(ctx, mesh, body, dim=-2)


def _sharded(ctx, mesh, body, dim: int):
    """``fn(v2, src_fields, wavelet, *extra)`` running ``body(devices, v2,
    src_fields, wavelet, *extra)`` on each shot group's mesh row and joining
    the slab outputs along ``dim``, then the groups in shot order."""
    def fn(v2, srcf, wav, *extra):
        wav = host_wavelet(wav)
        parts = distribute_shots(mesh, _per_shot(v2, len(srcf)),
                                 np.asarray(srcf, np.float32),
                                 *(np.asarray(e, np.float32) for e in extra))
        outs = [from_slabs(body(list(mesh.grid(i)[:, 0]), *group[:2], wav,
                                *group[2:]), ctx.nxe, mesh.lead(), dim)
                for i, group in enumerate(zip(*parts)) if len(group[0])]
        return torch.cat(outs)
    return fn
