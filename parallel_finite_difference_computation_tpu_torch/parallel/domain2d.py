"""(x, z) domain decomposition with a halo exchange every step: the port's
counterpart of the JAX package's ``parallel/domain2d.py`` (``:40-250``).

Where x-slabs of :mod:`.domain` grow too thin, both grid axes split: a
(shot, x, z) mesh holds each shot group's grid as ``n_x * n_z`` tiles.
These per-step loops are the plain reference of the (x, z) tier and what
the pipeline runs on a mesh of CPU devices, as :mod:`.domain` is for the x
tier: torch eager ops over the tiles of a mesh row, ``order/2`` halo cells
exchanged on both axes before every Laplacian, sources and receivers
injected through embedded fields. A mesh with a CUDA device runs the block
kernels of :mod:`.domain2d_kernels` instead.

A "tile grid" is a list over the mesh's x positions of lists over its z
positions: tile (j, l), (..., nxl, nzl) on its position's device, holds
cells ``[j*nxl, (j+1)*nxl) x [l*nzl, (l+1)*nzl)`` of the grid zero-padded
to ``(n_x*nxl, n_z*nzl)``. Padded cells have v2 = 0 and taper 0, so their
fields stay 0; the interior masks come from the unpadded nxe and nze
(``domain2d.py:108-115``). The Laplacian's taps keep the unsharded
association order (per-axis accumulators, pairs in descending k, the
centre last), so :func:`sharded_laplacian_2d` is bitwise
:func:`..ops.stencil.laplacian`.

Left for the ``rtm_main``-domain slice (ROADMAP.md): ``make_sharded_rtm_
full_2d``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver import FDContext, host_wavelet
from .domain import _per_shot, from_slabs, to_slabs
from .shots import distribute_shots

__all__ = ["halo_exchange_axis", "sharded_laplacian_2d",
           "make_sharded_forward_modeling_2d", "make_sharded_rtm_snapshot_2d",
           "to_tiles", "from_tiles"]


def to_tiles(a, grid) -> list:
    """(..., nxe, nze) -> a tile grid over ``grid``, an (n_x, n_z) array of
    devices (both axes zero-padded to a multiple of the mesh's)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    n_x, n_z = grid.shape
    nxe, nze = a.shape[-2:]
    nxl, nzl = -(-nxe // n_x), -(-nze // n_z)
    a = torch.nn.functional.pad(a, (0, n_z * nzl - nze, 0, n_x * nxl - nxe))
    return [[a[..., j * nxl:(j + 1) * nxl, l * nzl:(l + 1) * nzl].to(
        grid[j, l]).contiguous() for l in range(n_z)] for j in range(n_x)]


def from_tiles(tiles, nxe: int, nze: int, device) -> torch.Tensor:
    """A tile grid joined on ``device``, cut to the (nxe, nze) grid."""
    cols = [torch.cat([t.to(device) for t in row], dim=-1) for row in tiles]
    return torch.cat(cols, dim=-2)[..., :nxe, :nze]


def halo_exchange_axis(tiles, h: int, axis: int) -> list:
    """Each tile of a tile grid extended by ``h`` cells on both sides of
    ``axis`` (0: x, 1: z) from its neighbours on that mesh axis; the
    grid's edge tiles get zero halos (the Laplacian's zero border), as
    ``ppermute`` leaves them in the JAX package."""
    dim = -2 if axis == 0 else -1
    n_x, n_z = len(tiles), len(tiles[0])

    def neighbour(j, l, d):
        j, l = (j + d, l) if axis == 0 else (j, l + d)
        return tiles[j][l] if 0 <= j < n_x and 0 <= l < n_z else None

    out = []
    for j in range(n_x):
        row = []
        for l in range(n_z):
            f = tiles[j][l]
            n = f.shape[dim]
            shape = list(f.shape)
            shape[dim] = h
            lo, hi = neighbour(j, l, -1), neighbour(j, l, 1)
            lo = (lo.narrow(dim, n - h, h).to(f.device) if lo is not None
                  else f.new_zeros(shape))
            hi = (hi.narrow(dim, 0, h).to(f.device) if hi is not None
                  else f.new_zeros(shape))
            row.append(torch.cat([lo, f, hi], dim=dim))
        out.append(row)
    return out


def _interior_mask_axis(n_global: int, n_local: int, h: int, i: int,
                        device) -> torch.Tensor:
    """(n_local,) float mask: 1 where the *global* index of tile i along
    its axis is in the Laplacian interior [h, n_global - h)."""
    idx = i * n_local + torch.arange(n_local, device=device)
    return ((idx >= h) & (idx < n_global - h)).float()


def sharded_laplacian_2d(tiles, coefs_x, coefs_z, order: int, nxe: int,
                         nze: int) -> list:
    """The (x, z)-sharded Laplacian of a tile grid: both axes' taps read
    ``order/2``-wide halos from the neighbours, zero outside the *global*
    interior; bitwise the unsharded Laplacian of the joined grid."""
    h = order // 2
    cx = [float(v) for v in np.asarray(coefs_x, np.float32)]
    cz = [float(v) for v in np.asarray(coefs_z, np.float32)]
    ext_x = halo_exchange_axis(tiles, h, 0)
    ext_z = halo_exchange_axis(tiles, h, 1)
    out = []
    for j, row in enumerate(tiles):
        out_row = []
        for l, p in enumerate(row):
            nxl, nzl = p.shape[-2:]
            ez, ex = ext_z[j][l], ext_x[j][l]
            accz = None
            for k in range(h, 0, -1):
                term = cz[h + k] * (ez[..., :, h - k:h - k + nzl]
                                    + ez[..., :, h + k:h + k + nzl])
                accz = term if accz is None else accz + term
            accz = accz + cz[h] * p
            accx = None
            for k in range(h, 0, -1):
                term = cx[h + k] * (ex[..., h - k:h - k + nxl, :]
                                    + ex[..., h + k:h + k + nxl, :])
                accx = term if accx is None else accx + term
            accx = accx + cx[h] * p
            mx = _interior_mask_axis(nxe, nxl, h, j, p.device)
            mz = _interior_mask_axis(nze, nzl, h, l, p.device)
            out_row.append((accz + accx) * (mx[:, None] * mz[None, :]))
        out.append(out_row)
    return out


def _map(fn, *grids) -> list:
    """``fn`` applied tile by tile over tile grids of one shape."""
    return [[fn(*ts) for ts in zip(*rows)] for rows in zip(*grids)]


def _update_2d(ctx: FDContext, p, pp, v2) -> list:
    lap = sharded_laplacian_2d(p, ctx.coefs_x, ctx.coefs_z, ctx.order,
                               ctx.nxe, ctx.nze)
    return _map(lambda a, b, v, l: 2.0 * a - b + v * ctx.dt2 * l,
                p, pp, v2, lap)


def _owner(n: int, n_parts: int, i: int):
    """(part, local index) of global index i of an axis of n cells cut in
    n_parts equal parts (padded)."""
    size = -(-n // n_parts)
    return i // size, i % size


def make_sharded_forward_modeling_2d(ctx: FDContext, mesh, gz: int,
                                     source: str = "gaussian",
                                     taper: str = "all"):
    """Shot + (x, z)-domain-parallel forward modeling, one two-axis halo
    exchange a step. Returns ``fn(v2, src_fields, wavelet) -> seis`` with
    ``v2`` (ns, nxe, nze) or (nxe, nze), ``src_fields`` (ns, nxe, nze)
    (:func:`.domain.embed_source_fields`) and ``seis`` (ns, nt, nxe)
    extended-row seismograms on the mesh's first device. Row gz is read
    from the one z tile that owns it (the JAX package's ``psum`` over z of
    a one-hot contraction, which has one nonzero term)."""
    mask_plane = ctx.mask_all if taper == "all" else ctx.mask_top
    lz, gzl = _owner(ctx.nze, mesh.shape["z"], gz)

    def body(grid, v2, srcf, wav):
        v2, srcf = to_tiles(v2, grid), to_tiles(srcf, grid)
        mask = to_tiles(mask_plane, grid)
        p = _map(torch.zeros_like, v2)
        pp = _map(torch.zeros_like, v2)
        seis = []
        for amp in wav:
            pp = _update_2d(ctx, p, pp, v2)
            pp = _map(lambda a, s: a + float(amp) * s, pp, srcf)
            pp = _map(torch.mul, pp, mask)
            p = _map(torch.mul, p, mask)
            seis.append([row[lz][..., gzl] for row in p])
            p, pp = pp, p
        return [torch.stack([step[j] for step in seis], dim=1)
                for j in range(len(grid))]

    return _sharded(mesh, body, lambda seis: from_slabs(
        seis, ctx.nxe, mesh.lead(), dim=-1))


def make_sharded_rtm_snapshot_2d(ctx: FDContext, mesh, gz: int):
    """Shot + (x, z)-domain-parallel two-snapshot RTM (``fd-code.cu:
    480-529``), one two-axis halo exchange a step; the contract of
    :func:`.domain.make_sharded_rtm_snapshot`: ``fn(v2, src_fields,
    wavelet, dobs_ext) -> imloc_ext`` with ``dobs_ext`` (ns, nxe, nt) and
    ``imloc_ext`` (ns, nxe, nze) on the mesh's first device."""
    im = np.zeros((ctx.nxe, ctx.nze), np.float32)
    im[ctx.nxb:ctx.nxe - ctx.nxb, ctx.nzb:ctx.nze - ctx.nzb] = 1.0
    lz, gzl = _owner(ctx.nze, mesh.shape["z"], gz)

    def body(grid, v2, srcf, wav, dobs_ext):
        v2, srcf = to_tiles(v2, grid), to_tiles(srcf, grid)
        mask = to_tiles(ctx.mask_top, grid)
        im_l = to_tiles(im, grid)
        inj = to_slabs(torch.as_tensor(dobs_ext).flip(-1), list(grid[:, lz]))
        zero = _map(torch.zeros_like, v2)
        p, pp = zero, zero
        for amp in wav:
            p, pp = pp, p
            p = _map(torch.mul, p, mask)
            pp = _map(torch.mul, pp, mask)
            pp = _update_2d(ctx, p, pp, v2)
            pp = _map(lambda a, s: a + float(amp) * s, pp, srcf)
        snap0, snap1 = p, pp
        p, pp, pr, ppr, imloc = zero, zero, zero, zero, zero
        for it in range(ctx.nt):
            ppn = ((snap1, snap0)[it] if it < 2
                   else _update_2d(ctx, p, pp, v2))
            p, pp = ppn, p
            pr = _map(torch.mul, pr, mask)
            ppr = _map(torch.mul, ppr, mask)
            pprn = _update_2d(ctx, pr, ppr, v2)
            for row, d in zip(pprn, inj):
                row[lz][..., gzl] += d[..., it]
            imloc = _map(lambda i, a, b, m: i + a * b * m, imloc, p, pprn,
                         im_l)
            pr, ppr = pprn, pr
        return imloc

    return _sharded(mesh, body, lambda tiles: from_tiles(
        tiles, ctx.nxe, ctx.nze, mesh.lead()))


def _sharded(mesh, body, join):
    """``fn(v2, src_fields, wavelet, *extra)`` running ``body(grid, v2,
    src_fields, wavelet, *extra)`` on each shot group's (n_x, n_z) grid of
    devices and joining its output with ``join``, then the groups in shot
    order."""
    def fn(v2, srcf, wav, *extra):
        wav = host_wavelet(wav)
        parts = distribute_shots(mesh, _per_shot(v2, len(srcf)),
                                 np.asarray(srcf, np.float32),
                                 *(np.asarray(e, np.float32) for e in extra))
        return torch.cat([join(body(mesh.grid(i), *group[:2], wav,
                                    *group[2:]))
                          for i, group in enumerate(zip(*parts))
                          if len(group[0])])
    return fn
