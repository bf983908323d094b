"""x-domain-decomposed modeling and two-snapshot RTM on block kernels: the
port's counterpart of the JAX package's ``parallel/domain_pallas.py``, and
the tile machinery that the (x, z) tier (:mod:`.domain2d_kernels`) shares.

The extended grid's x axis is cut into ``n_x`` slabs of ``nxl`` rows (nxe
zero-padded up to a multiple of ``n_x``), one per position of the mesh's
``x`` axis; shots split over its ``shot`` axis. Every block of K steps, each
slab takes ``H = K*h`` rows of halo from each neighbour (:func:`exchange`)
and then advances K steps on its halo-extended slab in one kernel launch:
the exact region shrinks by h rows a step, so after K steps the owned rows
are exact (communication-avoiding blocking; the JAX package's module
docstring has the argument). Slabs at the grid's edge get zero halos.

A slab is the x tier's :class:`Tile`: one that spans every z column and
carries no z halo. A tile's state lives in (ns, nxw, nzw) buffers, ``nxw =
nxl + 2*hs``, ``nzw = nzl + 2*hz``, z contiguous: the owned cells in the
middle, the halos around them. A kernel reads such buffers and writes the
owned cells of output buffers that no block of its launch reads; the
makers keep two buffer sets per tile, allocated zero once a run, and swap
them every block, so the grid edges' halos, which nothing writes, stay
zero. (A plain block function returns new buffers with zero halos.)
:func:`exchange` then fills the inner halos from the neighbours' owned
cells: a copy on the stream where both lie on one device, a peer copy
between two devices, which ``Tensor.copy_`` orders against both devices'
current streams with CUDA events. Positions that share a device run in
turn on its stream.

The three block kernels (``csrc/domain_block.cu`` on
``csrc/domain_block.cuh``), their split-bf16 twins and their plain torch
versions here, the wrappers routing CPU tensors to the plain versions and
CUDA tensors to the kernels (no fallback; ``LAUNCHES`` counts one per
kernel launch, and only there):

| kernel | plain version | replaces (JAX package, ``parallel/domain_pallas.py``) |
|---|---|---|
| ``block_mod`` | :func:`block_mod` | ``_mod_block_kernel`` (:189) |
| ``block_fwd`` | :func:`block_fwd` | ``_fwd_block_kernel`` (:115) |
| ``block_bwd`` | :func:`block_bwd` | ``_bwd_block_kernel`` (:136) |
| ``block_mod_mma`` | :func:`block_mod` with ``parts`` | ``_mod_block_kernel``'s ``use_mxu`` lowering |
| ``block_fwd_mma`` | :func:`block_fwd` with ``parts`` | ``_fwd_block_kernel``'s |
| ``block_bwd_mma`` | :func:`block_bwd` with ``parts`` | ``_bwd_block_kernel``'s |

``parts`` (:func:`..ops.fd_kernels.lap_parts`: 0, 2 or 3) is the bf16
splits of the Laplacian's x taps: 0 runs the exact kernels; 2
(``lap_impl="mxu"``) and 3 (``"mxu6"``) the ``*_mma`` kernels, which take
the x taps as the split-bf16 banded product on the tensor cores and the z
taps exact, as ``_lap_and_refs`` (``domain_pallas.py:106-112``) hands the
JAX block kernels ``_make_lap``'s MXU branch; on the CPU the plain
versions with :func:`..ops.stencil.laplacian_mxu` (``axis="x"``).

The plain versions run the steps of the JAX block kernels in their order
and rounding: the update ``2p - pp + v2m*lap(p)`` with ``v2m = v2*dt2``
zero outside the global Laplacian interior (so that a tile's zero-bordered
Laplacian times ``v2m`` is the unsharded grid's), the taper as the whole-
grid plain loops apply it, and the image summed per block from zero, then
added to the running image, the interior mask applied once at the end
(``domain_pallas.py:161, :178, :492, :506-510``). Against the whole-grid
per-step tier the image then differs by rounding only. They take (x, z)
tiles as they take slabs, and serve both tiers.

Not ported, as TPU-only apparatus: ``_block_vmem_params`` and the lane
padding ``pad_to`` (the split variant's ``nxww``, whose zero lanes are
inert: a band window past the tile reads 0 here).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import numerics
from ..ops.fd_kernels import (_check_gz, _check_order, _check_window,
                              _coef_args, _on_cuda, _raise_on, _stream,
                              block_passes, lap_parts)
from ..ops.stencil import laplacian, laplacian_mxu
from ..ops.stream import MAX_STEPS
from ..solver import FDContext, host_wavelet, shot_positions
from .shots import split_shots

__all__ = ["LAUNCHES", "reset_launches", "Tile", "TileGeometry",
           "prepare_slabs", "prepare_tiles", "exchange", "block_mod",
           "block_fwd", "block_bwd", "block_mod_cuda", "block_fwd_cuda",
           "block_bwd_cuda", "make_sharded_forward_modeling_cuda",
           "make_sharded_rtm_snapshot_cuda"]

LAUNCHES = {"block_mod": 0, "block_fwd": 0, "block_bwd": 0,
            "block_mod_mma": 0, "block_fwd_mma": 0, "block_bwd_mma": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class TileGeometry(NamedTuple):
    """Owned cells, steps a block and halos of a decomposition."""

    nxl: int          # owned rows of a tile
    nzl: int          # owned columns
    k: int            # steps a block
    hs: int           # halo rows a side (K*h, or 0 on an x axis of one part)
    hz: int           # halo columns a side (0 for a slab)


@dataclasses.dataclass(frozen=True, eq=False)
class Tile:
    """The static operands of one tile of a shot group's grid, made once a
    run on its device: an x-slab (all z columns, no z halo) or an (x, z)
    tile. Acquisition depths are tile rows (z - the column of the
    buffer's first cell): ``sz`` may lie outside the tile (a Gaussian band
    straddling its edge); ``gz`` is the row the kernels record (block_mod:
    a row the tile owns) or inject at (block_bwd: a row the buffer holds,
    halo included), -1 for none."""

    ctx: FDContext
    j: int                     # position on the mesh's x axis
    l: int                     # position on its z axis (0 on a (shot, x) mesh)
    geom: TileGeometry
    ns: int
    device: torch.device
    v2m: torch.Tensor          # (1 or ns, nxw, nzw) v2*dt2, 0 off the interior
    ramps: tuple               # (xramp (nxw,), zfac (nzw,), strip (nzw,))
    src: torch.Tensor          # (ns, 2r+1, nxw) source rows, or None
    r: int
    sz: int
    inj: torch.Tensor          # (ns, nt, nxw) time-reversed trace rows, or None
    gz: int
    coefs: tuple               # host coefficient arrays, kept alive
    coef_ptrs: tuple

    nxl = property(lambda self: self.geom.nxl)
    nzl = property(lambda self: self.geom.nzl)
    hs = property(lambda self: self.geom.hs)
    hz = property(lambda self: self.geom.hz)

    @property
    def nxw(self) -> int:
        return self.nxl + 2 * self.hs

    @property
    def nzw(self) -> int:
        return self.nzl + 2 * self.hz

    @property
    def owned(self) -> tuple:
        """(rows, columns) of the owned cells in the tile's buffers."""
        return (slice(self.hs, self.hs + self.nxl),
                slice(self.hz, self.hz + self.nzl))

    @property
    def records(self) -> bool:
        """True when the tile owns row gz: ``block_mod`` records it."""
        return self.hz <= self.gz < self.hz + self.nzl

    @property
    def v2_stride(self) -> int:
        return 0 if self.v2m.shape[0] == 1 else self.nxw * self.nzw

    def mask(self) -> torch.Tensor:
        """The taper plane of the tile, as the kernels rebuild it from the
        ramps (``kstep.cuh``, ``taper_at``): bitwise the mask plane inside
        the grid, 0 (taper strip) or the z factor beyond it."""
        xr, zf, st = self.ramps
        sel = torch.where(st[None, :] != 0, xr[:, None],
                          torch.ones((), dtype=xr.dtype, device=xr.device))
        return zf[None, :] * sel


def _cut(a: torch.Tensor, dim: int, lo: int, n: int, device):
    """``a`` narrowed to [lo, lo + n) along ``dim``, 0 where that falls
    outside ``a``, on ``device``."""
    size = a.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    a0, a1 = max(lo, 0), min(lo + n, size)
    if a1 > a0:
        out.narrow(dim, a0 - lo, a1 - a0).copy_(a.narrow(dim, a0, a1 - a0))
    return out


def _source_rows(ctx: FDContext, sxs, patch: np.ndarray, x0: int,
                 nxw: int) -> np.ndarray:
    """(ns, 2r+1, nxw) rows of each shot's source patch over grid rows
    [x0, x0 + nxw): ``rows[s, dz + r, x] = patch[x0 + x - sx + r, dz + r]``
    (the Gaussian rows ``exp(-dz^2 - dx^2)`` of ``domain_pallas.py:294-301``,
    as the whole-grid loops' patch holds them, or the one-hot row), 0 off
    the patch and beyond the grid."""
    r = patch.shape[0] // 2
    gx = np.arange(x0, x0 + nxw)
    dx = gx[None, :] - np.asarray(sxs, np.int64)[:, None]
    on = (np.abs(dx) <= r) & (gx >= 0) & (gx < ctx.nxe)
    rows = np.zeros((len(sxs), 2 * r + 1, nxw), np.float32)
    s, x = np.nonzero(on)
    rows[s, :, x] = patch[dx[s, x] + r, :]
    return rows


def slab_geometry(ctx: FDContext, n_x: int, block_k: int) -> TileGeometry:
    """The geometry of an x decomposition over ``n_x`` slabs with blocks
    of ``block_k`` steps; raises as the JAX package does when the halo
    outgrows a slab (``domain_pallas.py:246-249``)."""
    nxl = -(-ctx.nxe // n_x)
    h = ctx.order // 2
    K = _check_k(block_k)
    H = K * h
    if H > nxl:
        raise ValueError(
            f"halo width K*h={H} exceeds the local slab width nxl={nxl}; "
            f"lower block_k to <= {nxl // h} or use fewer x shards")
    return TileGeometry(nxl, ctx.nze, K, H, 0)


def _check_k(block_k) -> int:
    K = int(block_k)
    if not 1 <= K <= MAX_STEPS:
        raise ValueError(f"block_k must be in [1, {MAX_STEPS}], got {K}")
    return K


def prepare_tiles(ctx: FDContext, grid, geom: TileGeometry, v2, taper: str,
                  sxs=None, sz: int = 0, source: str = "point",
                  dobs_ext=None, gz: int = 0) -> list:
    """The :class:`Tile` of each position of one shot group, in row-major
    (x, z) order, ``grid`` its (n_x, n_z) array of devices. ``v2`` is (nxe,
    nze), shared, or (ns, nxe, nze); ``sxs`` the shots' source rows (with
    ``source`` "point" or "gaussian" at depth ``sz``), or ``dobs_ext`` (ns,
    nxe, nt) the embedded gathers (:func:`.domain.embed_dobs`) whose
    time-reversed rows ``block_bwd`` adds at depth ``gz``; without them
    ``gz`` is the depth ``block_mod`` records."""
    nxl, nzl, K, hs, hz = geom
    h = ctx.order // 2
    nxw, nzw = nxl + 2 * hs, nzl + 2 * hz
    v2 = torch.as_tensor(v2, dtype=torch.float32)
    v2 = v2[None] if v2.dim() == 2 else v2
    xramp, zfac, strip = (torch.from_numpy(a) for a in numerics.mask_ramps(
        ctx.mask_all, ctx.mask_top, taper, ctx.nzb))
    patch = (ctx.source_patch if source == "gaussian"
             else np.ones((1, 1), np.float32))
    ns = len(sxs) if sxs is not None else dobs_ext.shape[0]
    if dobs_ext is not None:
        dobs_ext = torch.as_tensor(dobs_ext, dtype=torch.float32)
    keep, ptrs = _coef_args(ctx)
    tiles = []
    for j in range(grid.shape[0]):
        x0 = j * nxl - hs
        gx = torch.arange(x0, x0 + nxw)
        lane = ((gx >= h) & (gx < ctx.nxe - h)).float()
        v2_rows = _cut(v2, 1, x0, nxw, v2.device)
        rows = (_source_rows(ctx, sxs, patch, x0, nxw) if sxs is not None
                else None)
        for l in range(grid.shape[1]):
            dev = torch.device(grid[j, l])
            z0 = l * nzl - hz
            gzs = torch.arange(z0, z0 + nzw)
            zrow = ((gzs >= h) & (gzs < ctx.nze - h)).float()
            interior = (lane[:, None] * zrow[None, :]).to(dev)
            v2m = _cut(v2_rows, 2, z0, nzw, dev) * ctx.dt2 * interior
            row = gz - z0
            if dobs_ext is not None:
                row = row if 0 <= row < nzw else -1
            else:
                row = row if hz <= row < hz + nzl else -1
            inj = None
            if dobs_ext is not None and row >= 0:
                d = _cut(dobs_ext, 1, x0, nxw, dev)        # (ns, nxw, nt)
                inj = d.flip(-1).transpose(1, 2).contiguous()
            tiles.append(Tile(
                ctx=ctx, j=j, l=l, geom=geom, ns=ns, device=dev,
                v2m=v2m.contiguous(),
                ramps=(_cut(xramp, 0, x0, nxw, dev),
                       _cut(zfac, 0, z0, nzw, dev),
                       _cut(strip, 0, z0, nzw, dev)),
                src=None if rows is None else torch.from_numpy(rows).to(dev),
                r=patch.shape[0] // 2, sz=sz - z0, inj=inj, gz=row,
                coefs=keep, coef_ptrs=ptrs))
    return tiles


def prepare_slabs(ctx: FDContext, devices, block_k: int, v2, taper: str,
                  sxs=None, sz: int = 0, source: str = "point", dobs_ext=None,
                  gz: int = 0) -> list:
    """The slab (:class:`Tile`) of each position of one shot group,
    ``devices`` its row of a (shot, x) mesh, for blocks of ``block_k``
    steps; the operands as :func:`prepare_tiles` takes them."""
    grid = np.empty((len(devices), 1), dtype=object)
    grid[:, 0] = [torch.device(d) for d in devices]
    return prepare_tiles(ctx, grid, slab_geometry(ctx, len(devices), block_k),
                         v2, taper, sxs=sxs, sz=sz, source=source,
                         dobs_ext=dobs_ext, gz=gz)


def exchange(tiles, *fields) -> None:
    """Fills the halos of each field's tile buffers (one list per field,
    over ``tiles`` in row-major (x, z) order) from the neighbours' owned
    cells, in place, in two stages: first the z halos on the owned rows of
    every tile, then the x halos on the whole z-extended rows, which carry
    the neighbours' fresh z halos, so that the corners come from the
    diagonal neighbours (``halo_exchange_2d``, ``domain2d_pallas.py:58-74``).
    An axis without a halo is skipped; the grid edges' halos stay as they
    are (zero)."""
    n_x, n_z = tiles[-1].j + 1, tiles[-1].l + 1
    for bufs in fields:
        for i, c in enumerate(tiles):
            H, n = c.hz, c.nzl
            rows = c.owned[0]
            if H and c.l > 0:
                bufs[i][:, rows, :H].copy_(bufs[i - 1][:, rows, n:n + H])
            if H and c.l + 1 < n_z:
                bufs[i][:, rows, H + n:].copy_(bufs[i + 1][:, rows, H:2 * H])
        for i, c in enumerate(tiles):
            H, n = c.hs, c.nxl
            if H and c.j > 0:
                bufs[i][:, :H].copy_(bufs[i - n_z][:, n:n + H])
            if H and c.j + 1 < n_x:
                bufs[i][:, H + n:].copy_(bufs[i + n_z][:, H:2 * H])


def _owned(c: Tile, f):
    """``f`` with its halos set to zero (a new tensor)."""
    out = torch.zeros_like(f)
    rows, cols = c.owned
    out[:, rows, cols] = f[:, rows, cols]
    return out


def _update(c: Tile, p, pp, parts: int = 0):
    """``2p - pp + v2m*lap(p)`` on the tile (zero-bordered Laplacian; with
    ``parts`` > 0 its x taps in that many bf16 splits)."""
    ctx = c.ctx
    if parts:
        lap = laplacian_mxu(p, ctx.coefs_x, ctx.coefs_z, ctx.order, parts,
                            axis="x")
    else:
        lap = laplacian(p, ctx.coefs_x, ctx.coefs_z, ctx.order)
    return 2.0 * p - pp + c.v2m * lap


def block_mod(c: Tile, p, pp, amps, parts: int = 0):
    """K = ``len(amps)`` ``mod_main`` steps on the tile buffers (ns, nxw,
    nzw) from the state ``(p, pp)``: the plain version of ``block_mod``
    and ``block2_mod`` (with ``parts`` > 0, of their ``*_mma`` twins), the
    body of ``_mod_block_kernel`` (``domain_pallas.py:201-210``) and
    ``_mod2_block_kernel`` (``domain2d_pallas.py:193-201``): update, add
    ``amp * src`` on the source rows the tile holds, taper the new and the
    old field, record row gz of the tapered old field if the tile owns it.
    Returns ``(p, pp, rec)``, rec (ns, K, nxl), zero where the tile records
    no row."""
    mask = c.mask()
    rows = c.owned[0]
    rec = p.new_zeros((p.shape[0], len(amps), c.nxl))
    lo, hi = max(c.sz - c.r, 0), min(c.sz + c.r + 1, c.nzw)
    src = c.src[:, lo - c.sz + c.r:hi - c.sz + c.r].transpose(1, 2)
    for k, amp in enumerate(host_wavelet(amps)):
        upd = _update(c, p, pp, parts)
        if hi > lo:
            upd[:, :, lo:hi] += float(amp) * src
        p, pp = upd * mask, p * mask
        if c.records:
            rec[:, k] = pp[:, rows, c.gz]
    return _owned(c, p), _owned(c, pp), rec


def block_fwd(c: Tile, p, pp, amps, parts: int = 0):
    """K ``fd_forward`` steps on the tile buffers from the state ``(p,
    pp)``: the plain version of ``block_fwd`` and ``block2_fwd`` (with
    ``parts`` > 0, of their ``*_mma`` twins), the body
    of ``_fwd_block_kernel`` (``domain_pallas.py:124-130``) and
    ``_fwd2_block_kernel`` (``domain2d_pallas.py:112-118``): ``t = pp*m``,
    ``pp' = 2t - p*m + v2m*lap(t)``, ``amp * src`` added on row sz if the
    tile holds it, ``p' = t``. Returns ``(p, pp)``."""
    mask = c.mask()
    for amp in host_wavelet(amps):
        t = pp * mask
        new = _update(c, t, p * mask, parts)
        if 0 <= c.sz < c.nzw:
            new[:, :, c.sz] += float(amp) * c.src[:, 0]
        p, pp = t, new
    return _owned(c, p), _owned(c, pp)


def block_bwd(c: Tile, ps, pps, pr, ppr, img, it0: int, k: int,
              snaps=None, parts: int = 0):
    """K = ``k`` ``fd_back`` steps on the tile buffers from the state
    ``(ps, pps, pr, ppr)``, trace rows ``it0 .. it0+k-1``: the plain
    version of ``block_bwd`` and ``block2_bwd`` (with ``parts`` > 0, of
    their ``*_mma`` twins), the body of
    ``_bwd_block_kernel`` (``domain_pallas.py:163-178``) and
    ``_bwd2_block_kernel`` (``domain2d_pallas.py:152-167``): the untapered
    source step (with ``snaps = (snap0, snap1)``, the first block: ``snap1``
    at step 0, ``snap0`` at step 1), the tapered receiver step with the
    trace row added on row gz (if the tile holds it), and the block's image
    delta, summed from 0 over the steps on the owned cells, added to
    ``img`` (ns, nxl, nzl) at the end. Returns ``(ps, pps, pr, ppr,
    img)``."""
    mask = c.mask()
    delta = torch.zeros_like(ps)
    for i in range(k):
        if snaps is not None and i < 2:
            new_s = snaps[1 - i]
        else:
            new_s = _update(c, ps, pps, parts)
        ps, pps = new_s, ps
        t = pr * mask
        new_r = _update(c, t, ppr * mask, parts)
        if c.gz >= 0:
            new_r[:, :, c.gz] += c.inj[:, it0 + i]
        pr, ppr = new_r, t
        delta = delta + new_s * new_r
    rows, cols = c.owned
    return (_owned(c, ps), _owned(c, pps), _owned(c, pr), _owned(c, ppr),
            img + delta[:, rows, cols])


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _check_state(c: Tile, **fields) -> int:
    first = next(iter(fields.values()))
    ns = first.shape[0]
    shape = (ns, c.nxw, c.nzw)
    for name, f in fields.items():
        if f.device != c.device or f.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {c.device}")
        if tuple(f.shape) != shape or not f.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tile, "
                             f"got {tuple(f.shape)}")
    if ns != c.ns or c.v2m.shape[0] not in (1, ns):
        raise ValueError(f"{ns} shots, the tile was prepared for {c.ns}")
    return ns


def _check_steps(c: Tile, k: int) -> None:
    halo = k * (c.ctx.order // 2)
    if (not 1 <= k <= MAX_STEPS or (c.hs and halo > c.hs)
            or (c.hz and halo > c.hz)):
        raise ValueError(f"{k} steps do not fit a block of the tile's "
                         f"halos (H={c.hs}, {c.hz})")


def _check_out(c: Tile, ins, out, n: int) -> None:
    """``out``, if given, holds ``n`` tile buffers apart from each other and
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
    """``out``, or ``n`` new buffers like ``like`` with zero halos."""
    return list(out) if out is not None else [torch.zeros_like(like)
                                              for _ in range(n)]


def _split(c: Tile, name: str, parts):
    """``parts`` checked (0, 2 or 3, :func:`..ops.fd_kernels.lap_parts`) and
    the kernel a launch with them runs: ``name`` or its ``*_mma`` twin."""
    parts = lap_parts(int(parts), c.ctx)
    return parts, f"{name}_mma" if parts else name


def _entry(c: Tile, name: str, parts: int = 0):
    """The C entry point of kernel ``name`` and the arguments of its
    signature between the x sizes and the coefficients: the tile's z sizes
    (``(nze,)`` for the x tier's ``block_*``, ``(hz, nzl)`` for the (x, z)
    tier's ``block2_*``), the order, and ``parts`` for a ``*_mma``
    kernel."""
    from ..ops import _build
    if name.startswith("block2_"):
        dims = (c.hz, c.nzl)
    elif c.hz or c.nzl != c.ctx.nze:
        raise ValueError(f"{name} takes x-slabs; an (x, z) tile runs on "
                         f"block2_{name[6:]}")
    else:
        dims = (c.nzl,)
    return (getattr(_build.library(), f"pfdc_{name}_run"),
            (*dims, c.ctx.order, *((parts,) if parts else ())))


def _scratch(c: Tile, k: int, fields: int, like, extra: int = 0):
    """The launches of a block of ``k`` steps (its passes,
    :func:`..ops.fd_kernels.block_passes`, as every block kernel, exact or
    split, takes them), the scratch argument of the entry point (``(None,)``
    for one pass) and its buffer, which the caller keeps over the launch:
    for two passes, ``fields`` tile fields and ``extra`` floats on the
    device of ``like``."""
    passes = len(block_passes(k))
    if passes == 1:
        return 1, (None,), None
    buf = torch.empty(fields * like.shape[0] * c.nxw * c.nzw + extra,
                      device=like.device)
    return passes, (buf.data_ptr(),), buf


def launch_mod(name: str, launches: dict, c: Tile, p, pp, amps, out=None,
               parts: int = 0):
    """One block of the modeling kernel ``name`` (``block_mod`` or
    ``block2_mod``, or with ``parts`` > 0 its ``*_mma`` twin): the kernel
    on the card, writing the owned cells of ``out = (p_out, pp_out)`` (new
    buffers with zero halos when None) and counted in ``launches``, once a
    pass (the kernel, exact or split, takes a block of more than 4 steps in
    two); :func:`block_mod` on the CPU, which returns new buffers. Returns
    ``(p, pp, rec)``."""
    amps = host_wavelet(amps)
    ns = _check_state(c, p=p, pp=pp)
    _check_steps(c, len(amps))
    if c.src is None:
        raise ValueError("the tile has no source rows")
    _check_out(c, (p, pp), out, 2)
    parts, name = _split(c, name, parts)
    if not _on_cuda(p):
        return block_mod(c, p, pp, amps, parts)
    _check_order(c.ctx.order, True)
    run, dims = _entry(c, name, parts)
    k = len(amps)
    p_out, pp_out = _outputs(p, out, 2)
    rec = (torch.empty if c.records else torch.zeros)(
        (ns, k, c.nxl), dtype=torch.float32, device=p.device)
    xr, zf, st = c.ramps
    passes, scratch, _buf = _scratch(c, k, 2, p)
    with torch.cuda.device(p.device):
        rc = run(p.data_ptr(), pp.data_ptr(), p_out.data_ptr(),
                 pp_out.data_ptr(), *scratch, c.v2m.data_ptr(), c.v2_stride,
                 xr.data_ptr(), zf.data_ptr(), st.data_ptr(), c.src.data_ptr(),
                 c.r, c.sz, amps.ctypes.data, k, rec.data_ptr(), c.gz, ns,
                 c.hs, c.nxl, *dims, *c.coef_ptrs, _stream(p.device))
    _raise_on(rc, name, c.ctx.order, k)
    launches[name] += passes
    return p_out, pp_out, rec


def launch_fwd(name: str, launches: dict, c: Tile, p, pp, amps, out=None,
               parts: int = 0):
    """One block of the forward kernel ``name`` (``block_fwd`` or
    ``block2_fwd``, or with ``parts`` > 0 its ``*_mma`` twin): the kernel
    on the card, writing the owned cells of ``out`` and counted as
    :func:`launch_mod` does; :func:`block_fwd` on the CPU. Returns ``(p,
    pp)``."""
    amps = host_wavelet(amps)
    ns = _check_state(c, p=p, pp=pp)
    _check_steps(c, len(amps))
    if c.src is None or c.r != 0:
        raise ValueError(f"{name} takes one point-source row")
    _check_out(c, (p, pp), out, 2)
    parts, name = _split(c, name, parts)
    if not _on_cuda(p):
        return block_fwd(c, p, pp, amps, parts)
    _check_order(c.ctx.order, True)
    run, dims = _entry(c, name, parts)
    p_out, pp_out = _outputs(p, out, 2)
    xr, zf, st = c.ramps
    passes, scratch, _buf = _scratch(c, len(amps), 2, p)
    with torch.cuda.device(p.device):
        rc = run(p.data_ptr(), pp.data_ptr(), p_out.data_ptr(),
                 pp_out.data_ptr(), *scratch, c.v2m.data_ptr(), c.v2_stride,
                 xr.data_ptr(), zf.data_ptr(), st.data_ptr(), c.src.data_ptr(),
                 c.sz if 0 <= c.sz < c.nzw else -1, amps.ctypes.data,
                 len(amps), ns, c.hs, c.nxl, *dims, *c.coef_ptrs,
                 _stream(p.device))
    _raise_on(rc, name, c.ctx.order, len(amps))
    launches[name] += passes
    return p_out, pp_out


def launch_bwd(name: str, launches: dict, c: Tile, ps, pps, pr, ppr, img,
               it0: int, k: int, snaps=None, out=None, parts: int = 0):
    """One block of the backward kernel ``name`` (``block_bwd`` or
    ``block2_bwd``, or with ``parts`` > 0 its ``*_mma`` twin): the kernel
    on the card, which writes the owned cells of the four ``out`` buffers
    as :func:`launch_mod` does and adds the image delta into ``img`` (ns,
    nxl, nzl) in place; :func:`block_bwd` on the CPU. Returns ``(ps, pps,
    pr, ppr, img)``."""
    ns = _check_state(c, ps=ps, pps=pps, pr=pr, ppr=ppr,
                      **({} if snaps is None else
                         {"snap0": snaps[0], "snap1": snaps[1]}))
    _check_steps(c, k)
    if (c.gz >= 0 and c.inj is None) or not 0 <= it0 <= c.ctx.nt - k:
        raise ValueError(f"trace rows {it0}..{it0 + k - 1} are not in the "
                         f"tile's (nt={c.ctx.nt})")
    if snaps is not None and k < 2:
        raise ValueError("the first backward block seeds both snapshots: "
                         "it needs k >= 2")
    if (img.device != c.device or img.dtype != torch.float32
            or tuple(img.shape) != (ns, c.nxl, c.nzl)
            or not img.is_contiguous()):
        raise ValueError(f"img must be a contiguous float32 "
                         f"{(ns, c.nxl, c.nzl)} tensor on {c.device}")
    _check_out(c, (ps, pps, pr, ppr, img, *(snaps or ())), out, 4)
    parts, name = _split(c, name, parts)
    if not _on_cuda(ps):
        return block_bwd(c, ps, pps, pr, ppr, img, it0, k, snaps, parts)
    _check_order(c.ctx.order, True)
    run, dims = _entry(c, name, parts)
    outs = _outputs(ps, out, 4)
    xr, zf, st = c.ramps
    s0, s1 = (None, None) if snaps is None else (snaps[0].data_ptr(),
                                                 snaps[1].data_ptr())
    inj, inj_stride = ((None, 0) if c.inj is None
                       else (c.inj[:, it0].data_ptr(), c.inj.stride(0)))
    # the state and image delta between the kernel's two passes
    passes, scratch, _buf = _scratch(c, k, 4, ps, ns * c.nxl * c.nzl)
    with torch.cuda.device(ps.device):
        rc = run(ps.data_ptr(), pps.data_ptr(), pr.data_ptr(), ppr.data_ptr(),
                 *(o.data_ptr() for o in outs), s0, s1, img.data_ptr(),
                 *scratch, c.v2m.data_ptr(), c.v2_stride, xr.data_ptr(),
                 zf.data_ptr(), st.data_ptr(), inj, inj_stride, c.gz, k, ns,
                 c.hs, c.nxl, *dims, *c.coef_ptrs, _stream(ps.device))
    _raise_on(rc, name, c.ctx.order, k)
    launches[name] += passes
    return (*outs, img)


def block_mod_cuda(c: Tile, p, pp, amps, out=None, parts: int = 0):
    """One block of ``block_mod`` (``block_mod_mma`` with the x taps in
    ``parts`` bf16 splits) on an x-slab (:func:`launch_mod`). Returns
    ``(p, pp, rec)``."""
    return launch_mod("block_mod", LAUNCHES, c, p, pp, amps, out, parts)


def block_fwd_cuda(c: Tile, p, pp, amps, out=None, parts: int = 0):
    """One block of ``block_fwd`` (``block_fwd_mma`` with ``parts``) on an
    x-slab (:func:`launch_fwd`). Returns ``(p, pp)``."""
    return launch_fwd("block_fwd", LAUNCHES, c, p, pp, amps, out, parts)


def block_bwd_cuda(c: Tile, ps, pps, pr, ppr, img, it0: int, k: int,
                   snaps=None, out=None, parts: int = 0):
    """One block of ``block_bwd`` (``block_bwd_mma`` with ``parts``) on an
    x-slab (:func:`launch_bwd`). Returns ``(ps, pps, pr, ppr, img)``."""
    return launch_bwd("block_bwd", LAUNCHES, c, ps, pps, pr, ppr, img, it0,
                      k, snaps, out, parts)


# --------------------------------------------------------------------------
# Makers
# --------------------------------------------------------------------------

def _zeros(tiles, ns: int, n: int):
    """``n`` fields of zero buffers, each a list over the tiles."""
    return [[torch.zeros((ns, c.nxw, c.nzw), device=c.device)
             for c in tiles] for _ in range(n)]


def _advance(state, spare, i: int, outs) -> None:
    """Tile i's fields become ``outs``; their old buffers go to ``spare``,
    the outputs of the next block."""
    for f, s, o in zip(state, spare, outs):
        s[i], f[i] = f[i], o


def _gather(parts, n: int, device, dim: int):
    """Tensors joined in order along ``dim`` on ``device``, cut to n."""
    out = torch.cat([t.to(device) for t in parts], dim=dim)
    return out.narrow(dim, 0, n)


def _image_mask(c: Tile):
    """(nxl, nzl) 0/1 mask of the image interior on the tile's owned cells
    (the K6 region, ``domain_pallas.py:506-510``)."""
    ctx = c.ctx
    rows = torch.arange(c.j * c.nxl, (c.j + 1) * c.nxl, device=c.device)
    zs = torch.arange(c.l * c.nzl, (c.l + 1) * c.nzl, device=c.device)
    return (((rows >= ctx.nxb) & (rows < ctx.nxe - ctx.nxb))[:, None]
            & ((zs >= ctx.nzb) & (zs < ctx.nze - ctx.nzb))[None, :]).float()


def _check_maker(ctx: FDContext, mesh, gz, lap_impl) -> int:
    """Checks a maker's arguments; returns the bf16 parts ``lap_impl``
    resolves to (:func:`..ops.fd_kernels.lap_parts`), which the block
    calls take."""
    _check_order(ctx.order, any(d.type == "cuda" for d in mesh.devices.flat))
    _check_gz(ctx, gz)
    return lap_parts(lap_impl, ctx)


def check_rtm_blocks(ctx: FDContext, K: int, shot_only: str) -> None:
    """The block RTM's limits (``domain_pallas.py:377-382``): the seeded
    first backward block needs K >= 2 and the forward pass nt >= 2K."""
    if K < 2:
        raise ValueError("block_k must be >= 2: the first backward block "
                         "seeds BOTH snapshots (steps 0 and 1)")
    if ctx.nt < 2 * K:
        raise ValueError(f"nt={ctx.nt} < 2*block_k={2 * K}: lower block_k "
                         f"to <= {ctx.nt // 2} (at least 2), or migrate on "
                         f"{shot_only}")


def modeling_maker(ctx: FDContext, mesh, geom: TileGeometry, sz: int,
                   gz: int, source: str, taper: str, block):
    """``fn(v2, sxs, wavelet) -> seis`` of the block-kernel modeling over
    the tiles of ``geom``, ``block`` the wrapper that runs one block on a
    tile (:func:`block_mod_cuda` or ``block2_mod_cuda``): nt // K blocks
    of K steps, then a tail of nt % K; each block exchanges the halos of
    (p, pp), then launches once per tile. The tile that owns row gz of
    each x position records its traces."""
    K = geom.k

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
            tiles = prepare_tiles(
                ctx, mesh.grid(i), geom, v2 if v2.dim() == 2 else v2[idx],
                taper, sxs=[sxs[s] for s in idx], sz=sz, source=source, gz=gz)
            groups.append({
                "tiles": tiles, "state": _zeros(tiles, len(idx), 2),
                "spare": _zeros(tiles, len(idx), 2),
                "seis": [torch.empty((len(idx), ctx.nt, geom.nxl),
                                     device=c.device)
                         for c in tiles if c.records]})
        for it0 in range(0, ctx.nt, K):
            amps = wav[it0:it0 + K]
            for g in groups:
                (p, pp), spare = g["state"], g["spare"]
                exchange(g["tiles"], p, pp)
                for i, c in enumerate(g["tiles"]):
                    *outs, rec = block(c, p[i], pp[i], amps,
                                       out=[f[i] for f in spare])
                    _advance(g["state"], spare, i, outs)
                    if c.records:
                        g["seis"][c.j][:, it0:it0 + len(amps)] = rec
        return torch.cat([_gather(g["seis"], ctx.nxe, mesh.lead(), 2)
                          for g in groups])

    return fn


def rtm_maker(ctx: FDContext, mesh, geom: TileGeometry, sz: int, gz: int,
              fwd, bwd):
    """``fn(v2, sxs, wavelet, dobs_ext) -> imloc_ext`` of the block-kernel
    two-snapshot RTM over the tiles of ``geom``, ``fwd`` and ``bwd`` the
    wrappers that run one block on a tile: the forward runs nt // K blocks
    and a tail; the backward a first block seeded by the snapshots, then
    blocks of K and a tail; each block exchanges the halos of its state
    first. The image is masked to the interior once at the end."""
    K = geom.k

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
            tiles = prepare_tiles(ctx, mesh.grid(i), geom, v2[idx], "top",
                                  sxs=[sxs[s] for s in idx], sz=sz,
                                  dobs_ext=dobs_ext[idx], gz=gz)
            groups.append({"tiles": tiles, "state": _zeros(tiles, len(idx), 2),
                           "spare": _zeros(tiles, len(idx), 2)})
        for it0 in range(0, ctx.nt, K):
            amps = wav[it0:it0 + K]
            for g in groups:
                (p, pp), spare = g["state"], g["spare"]
                exchange(g["tiles"], p, pp)
                for i, c in enumerate(g["tiles"]):
                    _advance(g["state"], spare, i, fwd(
                        c, p[i], pp[i], amps, out=[f[i] for f in spare]))
        # the final forward pair is the snapshots (snap0, snap1)
        for g in groups:
            exchange(g["tiles"], *g["state"])
            g["snaps"] = g.pop("state")
            ns = g["snaps"][0][0].shape[0]
            g["state"] = _zeros(g["tiles"], ns, 4)
            g["spare"] = _zeros(g["tiles"], ns, 4)
            g["img"] = [torch.zeros((ns, geom.nxl, geom.nzl), device=c.device)
                        for c in g["tiles"]]
        for it0 in range(0, ctx.nt, K):
            k = min(K, ctx.nt - it0)
            for g in groups:
                state, spare, img = g["state"], g["spare"], g["img"]
                if it0:
                    exchange(g["tiles"], *state)
                for i, c in enumerate(g["tiles"]):
                    snaps = ([f[i] for f in g["snaps"]] if it0 == 0
                             else None)
                    *outs, img[i] = bwd(c, *(f[i] for f in state), img[i],
                                        it0, k, snaps,
                                        out=[f[i] for f in spare])
                    _advance(state, spare, i, outs)
                if it0 == 0:
                    del g["snaps"]               # the snapshots are spent
        out = []
        for g in groups:
            n_z = g["tiles"][-1].l + 1
            masked = [im * _image_mask(c) for c, im in zip(g["tiles"],
                                                           g["img"])]
            cols = [_gather(masked[i:i + n_z], ctx.nze, mesh.lead(), 2)
                    for i in range(0, len(masked), n_z)]
            out.append(_gather(cols, ctx.nxe, mesh.lead(), 1))
        return torch.cat(out)

    return fn


def make_sharded_forward_modeling_cuda(ctx: FDContext, mesh, sz: int,
                                       gz: int, source: str = "gaussian",
                                       taper: str = "all", block_k: int = 8,
                                       lap_impl=None):
    """Shot + x-domain-parallel forward modeling on the block kernels: the
    counterpart of ``make_sharded_forward_modeling_pallas``
    (``domain_pallas.py:220``). Returns ``fn(v2, sxs, wavelet) -> seis``
    with ``v2`` (nxe, nze) shared by the shots, or (ns, nxe, nze), ``sxs``
    (ns,) source rows, and ``seis`` (ns, nt, nxe) extended-row seismograms
    on the mesh's first device (:func:`modeling_maker`). ``lap_impl``
    resolves as in the JAX package (``_use_mxu_lap``,
    ``domain_pallas.py:251``): to ``block_mod_mma`` with the x taps in 2
    (``"mxu"``) or 3 (``"mxu6"``) bf16 splits, else ``block_mod``."""
    parts = _check_maker(ctx, mesh, gz, lap_impl)
    return modeling_maker(
        ctx, mesh, slab_geometry(ctx, mesh.shape["x"], block_k), sz, gz,
        source, taper,
        lambda *a, **kw: block_mod_cuda(*a, parts=parts, **kw))


def make_sharded_rtm_snapshot_cuda(ctx: FDContext, mesh, sz: int, gz: int,
                                   block_k: int = 8, lap_impl=None):
    """Shot + x-domain-parallel two-snapshot RTM on the block kernels: the
    counterpart of ``make_sharded_rtm_snapshot_pallas``
    (``domain_pallas.py:346``). Returns ``fn(v2, sxs, wavelet, dobs_ext) ->
    imloc_ext`` with ``v2`` (ns, nxe, nze), ``sxs`` (ns,) source rows at
    depth ``sz``, ``dobs_ext`` (ns, nxe, nt) (:func:`.domain.embed_dobs`),
    and ``imloc_ext`` (ns, nxe, nze) extended per-shot images on the mesh's
    first device (:func:`rtm_maker`). ``lap_impl``: ``block_fwd_mma`` and
    ``block_bwd_mma`` where it resolves to a split tier, as in the
    modeling maker."""
    parts = _check_maker(ctx, mesh, gz, lap_impl)
    geom = slab_geometry(ctx, mesh.shape["x"], block_k)
    check_rtm_blocks(ctx, geom.k, "a shot-only mesh (n_x = 1)")
    return rtm_maker(ctx, mesh, geom, sz, gz,
                     lambda *a, **kw: block_fwd_cuda(*a, parts=parts, **kw),
                     lambda *a, **kw: block_bwd_cuda(*a, parts=parts, **kw))
