"""(x, z)-domain-decomposed modeling and two-snapshot RTM on block kernels:
the port's counterpart of the JAX package's ``parallel/domain2d_pallas.py``.

Both axes of the extended grid split over a (shot, x, z) mesh: each shot
group's grid becomes ``n_x x n_z`` tiles of ``nxl x nzl`` owned cells (nxe
and nze zero-padded up to multiples of the mesh axes; padded cells have v2
= 0 and taper 0, and the interior masks come from the unpadded sizes).
Every block of K steps, each tile takes ``Hx = K*h`` rows of halo from its
x neighbours and ``Hz = K*h`` columns from its z neighbours (an axis of one
part carries none: its tile edge is the grid's) and advances K steps on
its halo-extended tile in one launch, as the x tier does
(:mod:`.domain_kernels`, whose tiles, exchange, plain block functions and
makers this tier shares). :func:`exchange_2d` runs in two stages, z on the
owned rows of every tile, then x on the whole z-extended rows, so that the
corner cells arrive from the diagonal neighbours.

The acquisition rows fall at tile rows that differ from tile to tile. A
source band or trace row is injected by every tile whose buffer holds it,
halo included, so that its halo evolves as the neighbour's own cells
(``domain2d_pallas.py:267-275, 368-371``); the seismogram is recorded by
the one tile that owns row gz of each x position (``:535-537``). The
Gaussian band is cut from the whole-grid patch, so the gathers are bitwise
the per-step tier's (the JAX kernels form it with a float32 ``exp``).

The three kernels (``csrc/domain2d_block.cu``, on the x tier's
``csrc/domain_block.cuh``), their split-bf16 twins and their plain
versions, the x tier's, which take (x, z) tiles as they take slabs; the
wrappers route CPU tensors to the plain versions and CUDA tensors to the
kernels (no fallback; ``LAUNCHES`` counts one per launch, and only there):

| kernel | plain version | replaces (JAX package, ``parallel/domain2d_pallas.py``) |
|---|---|---|
| ``block2_mod`` | :func:`block2_mod` | ``_mod2_block_kernel`` (:178) |
| ``block2_fwd`` | :func:`block2_fwd` | ``_fwd2_block_kernel`` (:99) |
| ``block2_bwd`` | :func:`block2_bwd` | ``_bwd2_block_kernel`` (:124) |
| ``block2_mod_mma`` | :func:`block2_mod` with ``parts`` | ``_mod2_block_kernel``'s ``use_mxu`` lowering |
| ``block2_fwd_mma`` | :func:`block2_fwd` with ``parts`` | ``_fwd2_block_kernel``'s |
| ``block2_bwd_mma`` | :func:`block2_bwd` with ``parts`` | ``_bwd2_block_kernel``'s |

``parts`` and ``lap_impl`` select them as on the x tier
(:mod:`.domain_kernels`; ``_use_mxu_lap``, ``domain2d_pallas.py:234-239``).

Not ported, as TPU-only apparatus: ``_block2_vmem_params`` and the lane
padding ``pad_to`` (the split variant's ``nxww``, ``domain2d_pallas.py:
237``, whose zero lanes are inert); nor ``force_halo``, the benchmark's
halo-cost proxy (ROADMAP.md, Queue 1, "Measurement harness, then the
benchmark cells").
"""

from __future__ import annotations

from ..solver import FDContext
from .domain_kernels import (TileGeometry, _check_k, _check_maker,
                             block_bwd, block_fwd, block_mod,
                             check_rtm_blocks, exchange, launch_bwd,
                             launch_fwd, launch_mod, modeling_maker,
                             prepare_tiles, rtm_maker)

__all__ = ["LAUNCHES", "reset_launches", "tile_geometry", "prepare_tiles",
           "exchange_2d", "block2_mod", "block2_fwd", "block2_bwd",
           "block2_mod_cuda", "block2_fwd_cuda", "block2_bwd_cuda",
           "make_sharded_forward_modeling_2d_cuda",
           "make_sharded_rtm_snapshot_2d_cuda"]

LAUNCHES = {"block2_mod": 0, "block2_fwd": 0, "block2_bwd": 0,
            "block2_mod_mma": 0, "block2_fwd_mma": 0, "block2_bwd_mma": 0}

# The plain versions of the three kernels: the x tier's block functions,
# which run on any tile.
block2_mod, block2_fwd, block2_bwd = block_mod, block_fwd, block_bwd

# The two-stage exchange of tile buffers (z, then x on z-extended rows).
exchange_2d = exchange


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tile_geometry(ctx: FDContext, n_x: int, n_z: int,
                  block_k: int) -> TileGeometry:
    """The tiles of an (x, z) decomposition over ``n_x x n_z`` parts with
    blocks of ``block_k`` steps (``_tile2``, ``domain2d_pallas.py:
    211-239``): both axes zero-padded to a multiple of their part count, a
    ``K*h`` halo on each axis cut in more than one part. Raises when a halo
    outgrows the tile, before anything is launched."""
    nxl = -(-ctx.nxe // n_x)
    nzl = -(-ctx.nze // n_z)
    h = ctx.order // 2
    K = _check_k(block_k)
    hs = K * h if n_x > 1 else 0
    hz = K * h if n_z > 1 else 0
    if hs > nxl or hz > nzl:
        fit = min(n // h for n, H in ((nxl, hs), (nzl, hz)) if H)
        raise ValueError(
            f"halo width K*h={K * h} exceeds the local tile ({nxl} x {nzl});"
            f" a halo reaches the adjacent tile only: lower block_k to <= "
            f"{fit} or use fewer x or z shards")
    return TileGeometry(nxl, nzl, K, hs, hz)


def block2_mod_cuda(c, p, pp, amps, out=None, parts: int = 0):
    """One block of ``block2_mod`` (``block2_mod_mma`` with the x taps in
    ``parts`` bf16 splits) on an (x, z) tile
    (:func:`.domain_kernels.launch_mod`). Returns ``(p, pp, rec)``."""
    return launch_mod("block2_mod", LAUNCHES, c, p, pp, amps, out, parts)


def block2_fwd_cuda(c, p, pp, amps, out=None, parts: int = 0):
    """One block of ``block2_fwd`` (``block2_fwd_mma`` with ``parts``) on
    an (x, z) tile (:func:`.domain_kernels.launch_fwd`). Returns ``(p,
    pp)``."""
    return launch_fwd("block2_fwd", LAUNCHES, c, p, pp, amps, out, parts)


def block2_bwd_cuda(c, ps, pps, pr, ppr, img, it0: int, k: int, snaps=None,
                    out=None, parts: int = 0):
    """One block of ``block2_bwd`` (``block2_bwd_mma`` with ``parts``) on
    an (x, z) tile (:func:`.domain_kernels.launch_bwd`). Returns ``(ps,
    pps, pr, ppr, img)``."""
    return launch_bwd("block2_bwd", LAUNCHES, c, ps, pps, pr, ppr, img, it0,
                      k, snaps, out, parts)


def _geometry(ctx: FDContext, mesh, block_k: int) -> TileGeometry:
    shape = mesh.shape
    return tile_geometry(ctx, shape["x"], shape.get("z", 1), block_k)


def make_sharded_forward_modeling_2d_cuda(ctx: FDContext, mesh, sz: int,
                                          gz: int, source: str = "gaussian",
                                          taper: str = "all",
                                          block_k: int = 8, lap_impl=None):
    """Shot + (x, z)-domain-parallel forward modeling on the block kernels:
    the counterpart of ``make_sharded_forward_modeling_2d_pallas``
    (``domain2d_pallas.py:453-554``). Returns ``fn(v2, sxs, wavelet) ->
    seis`` with ``v2`` (nxe, nze) shared by the shots, or (ns, nxe, nze),
    ``sxs`` (ns,) source rows at depth ``sz``, and ``seis`` (ns, nt, nxe)
    extended-row seismograms on the mesh's first device
    (:func:`.domain_kernels.modeling_maker`); ``block2_mod_mma`` where
    ``lap_impl`` resolves to a split tier (``domain2d_pallas.py:
    234-239``)."""
    parts = _check_maker(ctx, mesh, gz, lap_impl)
    return modeling_maker(
        ctx, mesh, _geometry(ctx, mesh, block_k), sz, gz, source, taper,
        lambda *a, **kw: block2_mod_cuda(*a, parts=parts, **kw))


def make_sharded_rtm_snapshot_2d_cuda(ctx: FDContext, mesh, sz: int,
                                      gz: int, block_k: int = 8,
                                      lap_impl=None):
    """Shot + (x, z)-domain-parallel two-snapshot RTM on the block kernels:
    the counterpart of ``make_sharded_rtm_snapshot_2d_pallas``
    (``domain2d_pallas.py:296-450``). Returns ``fn(v2, sxs, wavelet,
    dobs_ext) -> imloc_ext`` with ``v2`` (ns, nxe, nze), ``sxs`` (ns,)
    source rows at depth ``sz``, ``dobs_ext`` (ns, nxe, nt)
    (:func:`.domain.embed_dobs`), and ``imloc_ext`` (ns, nxe, nze) extended
    per-shot images on the mesh's first device
    (:func:`.domain_kernels.rtm_maker`). Needs K >= 2 and nt >= 2K.
    ``block2_fwd_mma`` and ``block2_bwd_mma`` where ``lap_impl`` resolves
    to a split tier."""
    parts = _check_maker(ctx, mesh, gz, lap_impl)
    geom = _geometry(ctx, mesh, block_k)
    check_rtm_blocks(ctx, geom.k, "the per-step (x, z) loops "
                     "(domain2d.make_sharded_rtm_snapshot_2d, a CPU mesh)")
    return rtm_maker(ctx, mesh, geom, sz, gz,
                     lambda *a, **kw: block2_fwd_cuda(*a, parts=parts, **kw),
                     lambda *a, **kw: block2_bwd_cuda(*a, parts=parts, **kw))
