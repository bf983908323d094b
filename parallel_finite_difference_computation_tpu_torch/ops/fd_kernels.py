"""Wrappers of the CUDA kernels: the port's counterparts of the JAX
package's Pallas entry points.

Each wrapper routes by the device of its input. A CPU tensor goes to the
plain version in :mod:`..solver` or :mod:`.stencil`; a CUDA tensor goes to
the kernel, and any failure (no ``nvcc``, a build error, a refused launch)
raises. Nothing falls back.

One step-kernel launch is one time step for every shot of the batch; the C
entry point loops over the nt steps on PyTorch's current stream, so one
wrapper call runs a whole batch, as one Pallas call ran a whole shot. The
exact two-snapshot RTM passes and the exact modeling and ``rtm_main`` passes
go through all nt steps in one launch where a shot fits a thread-block
cluster (:func:`resident_plan`): ``rtm_fwd_cluster``, ``rtm_bwd_cluster``,
``mod_cluster``, ``rec_fwd_cluster`` and ``rec_bwd_cluster``, elsewhere
their per-step kernels;
the C entry point reports the route it took. ``LAUNCHES``
counts the launches of each kernel (nt per propagation of a per-step
kernel, one per resident pass, one per Laplacian apply), and is added to
only where the kernels are launched.

| kernel | source | replaces (JAX package, ``ops/``) |
|---|---|---|
| ``mod_step`` | ``csrc/mod_step.cu`` | ``pallas_fd.py`` ``_fwd_mod_kernel`` (:423) |
| ``rtm_fwd_step`` | ``csrc/rtm_fwd_step.cu`` | ``pallas_fd.py`` ``_rtm_kernel`` forward, ``_fwd_gpu_kernel`` (:534, :702) |
| ``rtm_bwd_step`` | ``csrc/rtm_bwd_step.cu`` | ``pallas_fd.py`` ``_rtm_kernel`` backward, ``_bwd_gpu_kernel`` (:534, :729) |
| ``rtm_fwd_cluster`` | ``csrc/rtm_fwd_step.cu`` on ``cluster_loop.cuh`` | the same as ``rtm_fwd_step``, all nt steps in one launch |
| ``rtm_bwd_cluster`` | ``csrc/rtm_bwd_step.cu`` on ``cluster_loop.cuh`` | the same as ``rtm_bwd_step``, all nt steps in one launch |
| ``mod_cluster`` | ``csrc/mod_step.cu`` on ``cluster_loop.cuh`` | the same as ``mod_step``, all nt steps in one launch |
| ``rec_fwd_cluster`` | ``csrc/rec_step.cu`` on ``cluster_loop.cuh`` | the same as ``rec_fwd_step``, all nt steps in one launch |
| ``rec_bwd_cluster`` | ``csrc/rec_step.cu`` on ``cluster_loop.cuh`` | the same as ``rec_bwd_step``, all nt steps in one launch |
| ``rec_fwd_step`` | ``csrc/rec_step.cu`` | ``pallas_stream.py`` ``_kstep_rec_kernel`` source mode (:1002) |
| ``rec_bwd_step`` | ``csrc/rec_step.cu`` | ``pallas_stream.py`` ``_kstep_rec_kernel`` receiver mode (:1002) |
| ``lap_apply`` | ``csrc/laplacian.cu`` | ``pallas_stencil.py`` ``_kernel`` (:60) |
| ``mod_step_mma`` | ``csrc/step_mma.cu`` | ``pallas_fd.py`` MXU branch of ``_make_lap`` (:260-334) in ``_fwd_mod_kernel`` (:423) |
| ``rtm_fwd_step_mma`` | ``csrc/step_mma.cu`` | the same in ``_rtm_kernel``'s forward (:534) |
| ``rtm_bwd_step_mma`` | ``csrc/step_mma.cu`` | the same in ``_rtm_kernel``'s backward (:534) |
| ``rec_fwd_step_mma`` | ``csrc/rec_step.cu`` on ``step_strip.cuh`` | ``pallas_stream.py`` ``_kstep_rec_kernel``'s ``use_mxu`` branch (:1026-1033), source mode |
| ``rec_bwd_step_mma`` | ``csrc/rec_step.cu`` on ``step_strip.cuh`` | the same, receiver mode |

The padded-layout stencil's two kernels, ``lap_padded`` and
``lap_padded_mma`` (``pallas_stencil.py`` ``_kernel_padded`` :546 and
``_kernel_padded_mxu`` :429), have their wrapper in :mod:`.padded`.

``lap_impl`` selects the Laplacian of the whole-shot kernels as in the JAX
package (:func:`resolve_lap_impl`): the exact taps (``None``, ``"vpu"``),
the split-bf16 tensor-core tiers (``"mxu"``: 3 passes, ``"mxu6"``: 6), or
``"auto"``. The per-step tier runs all of them (``mod_step``/``rtm_*_step``
exact, the ``*_step_mma`` kernels split, the x taps in bf16 parts), and so
do the large-grid tier (the ``*_mma`` kernels of :mod:`.stream`, the z
taps in bf16 parts, as the JAX streaming kernels split them) and the
``rtm_main`` kernels (``rec_*_step_mma``, the z taps split, as the JAX
K-step recording kernel splits them), and the domain tiers (the block
kernels' ``*_mma`` twins, the x taps split, as the JAX block kernels'
``use_mxu`` branch splits them). The JAX kernels' ``z_taps`` and
``taper_impl`` are Mosaic lowering choices with bitwise-identical results
and are not ported.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .. import solver
from ..solver import FDContext, host_wavelet, shot_positions
from . import stencil

__all__ = ["LAUNCHES", "reset_launches", "MXU3_NT_MAX", "MXU6_NT_MAX",
           "SMEM_BYTES", "STAGING_KERNELS", "BLOCK_PASS_STEPS", "block_passes",
           "smem_bytes", "largest_fitting_k", "ResidentPlan", "resident_plan",
           "resolve_lap_impl", "lap_parts", "LapShape", "lap_shape",
           "forward_modeling_cuda", "fd_forward_cuda", "fd_back_cuda",
           "rtm_snapshot_cuda", "backward_recorded_cuda",
           "backward_image_cuda", "rtm_full_cuda", "laplacian_cuda"]

LAUNCHES = {"mod_step": 0, "rtm_fwd_step": 0, "rtm_bwd_step": 0,
            "rtm_fwd_cluster": 0, "rtm_bwd_cluster": 0, "mod_cluster": 0,
            "rec_fwd_cluster": 0, "rec_bwd_cluster": 0,
            "rec_fwd_step": 0, "rec_bwd_step": 0, "lap_apply": 0,
            "mod_step_mma": 0, "rtm_fwd_step_mma": 0, "rtm_bwd_step_mma": 0,
            "rec_fwd_step_mma": 0, "rec_bwd_step_mma": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The JAX package's routing rule for lap_impl="auto" (its ops/pallas_fd.py:
# 150-163): the accuracy envelope it measured for its split-bf16 tiers
# against the C oracle. The 3-pass tier drifted 2.1e-5 over 3lay (nt=1001,
# dx == dz) and 2.4e-3 over marmousi (nt=3004, dz != dx, dt at the fine
# axis's CFL edge); the 6-pass tier 4.0e-6 over marmousi. Each tier is
# trusted to about 1.5x its validated nt.
MXU3_NT_MAX = 1500
MXU6_NT_MAX = 4500
# lap_impl=None reads this import-time snapshot of PFDC_LAP_IMPL, never the
# environment at call time: "mxu", "mxu6" and "auto" select those tiers;
# the default "padded" (and "roll") are the JAX kernels' lowerings of the
# exact taps.
_ENV_LAP_IMPL = os.environ.get("PFDC_LAP_IMPL", "padded")
_EXACT = (None, "vpu", "padded", "roll")
_PARTS = {"mxu": 2, "mxu6": 3}


def _mxu3_in_envelope(ctx: FDContext) -> bool:
    """Whether the 3-pass tier's measured envelope covers ``ctx``: nt <=
    ``MXU3_NT_MAX`` and an isotropic grid, seen through the premultiplied
    centre coefficients (``coefs_x[h] == coefs_z[h]`` iff dx == dz).
    Isotropy stands in for the CFL margin, which depends on the velocity
    model; ``auto`` assumes dt well inside the CFL bound."""
    h = ctx.order // 2
    isotropic = float(ctx.coefs_x[h]) == float(ctx.coefs_z[h])
    return ctx.nt <= MXU3_NT_MAX and isotropic


def resolve_lap_impl(ctx: FDContext, lap_impl):
    """``lap_impl`` resolved against ``ctx`` as the JAX package resolves it
    (``resolve_lap_impl``, its ``ops/pallas_fd.py:186-218``): ``None``
    takes the ``PFDC_LAP_IMPL`` snapshot when that is ``"mxu"``, ``"mxu6"``
    or ``"auto"``; ``"auto"`` is ``"mxu"`` inside the 3-pass envelope,
    else ``"mxu6"`` up to ``MXU6_NT_MAX`` steps, else ``"vpu"``. An
    explicit ``"mxu"`` outside its envelope runs, with a ``UserWarning``."""
    if lap_impl not in _EXACT and lap_impl not in ("auto", "mxu", "mxu6"):
        raise ValueError(f"unknown lap_impl {lap_impl!r}: one of None, "
                         f"'vpu', 'mxu', 'mxu6', 'auto'")
    if lap_impl is None and _ENV_LAP_IMPL in ("mxu", "mxu6", "auto"):
        lap_impl = _ENV_LAP_IMPL
    if lap_impl == "auto":
        if _mxu3_in_envelope(ctx):
            return "mxu"
        return "mxu6" if ctx.nt <= MXU6_NT_MAX else "vpu"
    if lap_impl == "mxu" and not _mxu3_in_envelope(ctx):
        warnings.warn(
            f"lap_impl='mxu' outside its validated accuracy envelope "
            f"(nt={ctx.nt}, isotropic grid required, nt <= {MXU3_NT_MAX}):"
            f" measured 2.4e-3 image drift on marmousi-class configs. Use"
            f" lap_impl='mxu6' (validated 4.0e-6) or 'auto'.",
            stacklevel=3)
    return lap_impl


def lap_parts(lap_impl, ctx: FDContext) -> int:
    """The bf16 splits the split-bf16 Laplacian runs with (the JAX
    ``_use_mxu_lap``, its ``ops/pallas_fd.py:221-241``): 0 for the exact
    taps, 2 for ``"mxu"`` (3 passes), 3 for ``"mxu6"`` (6 passes), after
    :func:`resolve_lap_impl`. A part count (0, 2 or 3) is taken as already
    resolved, as the wrappers hand it on to the plain versions."""
    if isinstance(lap_impl, int) and not isinstance(lap_impl, bool):
        if lap_impl not in (0, 2, 3):
            raise ValueError(f"a resolved lap_impl is 0, 2 or 3 bf16 parts, "
                             f"got {lap_impl}")
        return lap_impl
    return _PARTS.get(resolve_lap_impl(ctx, lap_impl), 0)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: use cpu or cuda")


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The highest order the kernels take: 2 * kMaxHalf of csrc/stencil.cuh.
MAX_ORDER = 16
# A block's dynamic shared memory on an H100 (kMaxSmemBytes, csrc/kstep.cuh).
SMEM_BYTES = 232448


class _Strip(NamedTuple):
    """A strip body's owned shapes, the first that fits taken, and what it
    stages besides the x ramp: fields, whether the owned image, and
    whether its rows are padded (strip.cuh: StripStage, strip_pitch)."""
    shapes: tuple
    fields: int
    image: bool
    padded: bool = False


# The strip bodies (csrc/bwd_strip.cuh: kBwdShapes, kBwdStage,
# kstep_gpu_bwd and block_bwd; kBwdMmaStage, their split twins
# block_bwd_mma and, on kBwdZMmaShapes, kstep_gpu_bwd_mma, the two
# products staged too, on padded rows; csrc/fwd_strip.cuh: kFwdShapes,
# kFwdStage, kstep_mod and kstep_gpu_fwd; kBlockFwdShapes, block_mod and
# block_fwd; kFwdShapes and kFwdMmaStage, the split twins of all four,
# the x or z product staged too, on padded rows).
_BWD_STRIP = _Strip(((32, 64), (32, 32), (16, 32), (16, 16)), 4, True)
_BWD_MMA_STRIP = _BWD_STRIP._replace(fields=6, padded=True)
_BWD_ZMMA_STRIP = _BWD_MMA_STRIP._replace(shapes=((32, 96),)
                                          + _BWD_STRIP.shapes)
_FWD_STRIP = _Strip(((64, 64), (32, 64), (32, 32), (16, 32), (16, 16)), 2,
                    False)
_BLOCK_FWD_STRIP = _FWD_STRIP._replace(shapes=((64, 96),)
                                       + _FWD_STRIP.shapes)
_FWD_MMA_STRIP = _FWD_STRIP._replace(fields=3, padded=True)
# The most steps a pass of the block kernels on strip bodies takes
# (kBlockPassSteps).
BLOCK_PASS_STEPS = 4
# Per kernel: its split twin's strip body and the exact kernel's.
_STAGED = {"kstep_mod": (_FWD_MMA_STRIP, _FWD_STRIP),
           "kstep_gpu_fwd": (_FWD_MMA_STRIP, _FWD_STRIP),
           "kstep_gpu_bwd": (_BWD_ZMMA_STRIP, _BWD_STRIP),
           "block_mod": (_FWD_MMA_STRIP, _BLOCK_FWD_STRIP),
           "block_fwd": (_FWD_MMA_STRIP, _BLOCK_FWD_STRIP),
           "block_bwd": (_BWD_MMA_STRIP, _BWD_STRIP)}
STAGING_KERNELS = tuple(_STAGED)


def _strip_bytes(shape, r: int, body: _Strip) -> int:
    """strip.cuh's strip_bytes: the staged fields at the rows' pitch
    (strip_pitch), the owned image if staged, and the x ramp of the tile's
    rows."""
    tx, tz = shape
    sz = tz + 2 * r
    pitch = (sz + 3) // 8 * 8 + 4 if body.padded else sz
    return 4 * (body.fields * (tx + 2 * r) * pitch
                + (tx * tz if body.image else 0) + tx + 2 * r)


def block_passes(k: int) -> tuple:
    """The steps of each pass of a block kernel on a strip body (the exact
    ``block_mod``, ``block_fwd``, ``block_bwd`` and their ``block2_*``,
    and their split twins ``*_mma``) for a block of ``k`` steps: one pass
    up to ``BLOCK_PASS_STEPS``, else two, of ``(k + 1) // 2`` and ``k //
    2`` steps (kBlockPassSteps, BlockPasses, csrc/domain_block.cuh); each
    pass is a launch."""
    return (k,) if k <= BLOCK_PASS_STEPS else ((k + 1) // 2, k // 2)


def smem_bytes(kernel: str, order: int, k: int, parts: int = 0) -> int:
    """Dynamic shared memory of one block of the staging kernel ``kernel``
    (one of ``STAGING_KERNELS``; ``block2_*`` as ``block_*``, ``*_mma`` as
    ``parts`` > 0) at ``order`` and K = ``k`` steps (a halo of k*h cells),
    as its launcher sizes it. A kernel on a strip body takes the first of
    its shapes that fits ``SMEM_BYTES``; where none does, the smallest's
    bytes (refused); the block kernels on strip bodies stage the steps of
    their longer pass only (:func:`block_passes`)."""
    kernel = kernel.replace("block2_", "block_").removesuffix("_mma")
    split, exact = _STAGED[kernel]
    body = split if parts else exact
    if kernel.startswith("block_"):
        k = block_passes(k)[0]
    sizes = [_strip_bytes(s, k * (order // 2), body) for s in body.shapes]
    return next((b for b in sizes if b <= SMEM_BYTES), sizes[-1])


def largest_fitting_k(kernels, order: int, k_max: int, parts: int = 0) -> int:
    """The largest K <= ``k_max`` whose blocks of every one of ``kernels``
    fit a block's shared memory (:func:`smem_bytes`), at least 1: the
    pipelines' and makers' default block size."""
    for k in range(k_max, 1, -1):
        if all(smem_bytes(n, order, k, parts) <= SMEM_BYTES
               for n in kernels):
            return k
    return 1


class ResidentPlan(NamedTuple):
    """How a shot runs on the resident route of the exact two-snapshot RTM
    and modeling (``pfdc::ClusterPlan``, csrc/cluster_loop.cuh):
    ``cluster`` CTAs, each a slab of ``rows`` or ``rows - 1`` x nze cells,
    ``threads`` a CTA (one strip of cells each), and the dynamic shared
    memory of a forward (the modeling kernels' too) and a backward CTA."""
    cluster: int
    rows: int
    threads: int
    fwd_bytes: int
    bwd_bytes: int


def resident_plan(nxe: int, nze: int, order: int):
    """The route rule of ``pfdc_rtm_fwd_run``/``pfdc_rtm_bwd_run``, and of
    ``pfdc_mod_run``/``pfdc_rec_fwd_run``/``pfdc_rec_bwd_run`` with the
    exact taps
    (``cluster_plan``, csrc/cluster_loop.cuh), asked of the built library:
    the first cluster size whose slabs hold at least order/2 rows each,
    whose strips a CTA's threads cover and whose backward levels fit a
    CTA's shared memory. Returns a :class:`ResidentPlan`, or None where the
    per-step kernels run. The wrappers count the route the entry points
    report, not this."""
    from . import _build
    out = (ctypes.c_int * len(ResidentPlan._fields))()
    resident = _build.library().pfdc_cluster_plan(nxe, nze, order, out)
    return ResidentPlan(*out) if resident else None


_INVALID_VALUE = 1             # cudaErrorInvalidValue
_INT_MAX = 2**31 - 1           # a dim the C entry points take as an int


def _check_order(order: int, on_cuda: bool) -> None:
    """Every even order >= 2 runs on the CPU, as in the JAX package; the
    kernels take up to ``MAX_ORDER``."""
    if order % 2 or order < 2:
        raise ValueError(f"the order must be even and >= 2, got {order}")
    if on_cuda and order > MAX_ORDER:
        raise ValueError(f"the CUDA kernels take even orders up to "
                         f"{MAX_ORDER}, got {order}")


def _check_v2(ctx: FDContext, v2: torch.Tensor, ns: int) -> int:
    """Checks ``v2`` and returns its shot stride: 0 for one (nxe, nze)
    velocity shared by all shots, else one plane per shot."""
    plane = (ctx.nxe, ctx.nze)
    if v2.dim() == 2:
        _check("v2", v2, plane, v2.device)
        return 0
    _check("v2", v2, (ns,) + plane, v2.device)
    return ctx.nxe * ctx.nze


def _check_wavelet(ctx: FDContext, wavelet) -> np.ndarray:
    wav = host_wavelet(wavelet)
    if wav.shape != (ctx.nt,):
        raise ValueError(f"wavelet has shape {wav.shape}, expected "
                         f"({ctx.nt},)")
    return wav


def _check_window(ctx: FDContext, sxs, sz: int, r: int) -> None:
    """The source window [s - r, s + r] must lie inside the grid."""
    if (min(min(sxs), sz) < r or max(sxs) >= ctx.nxe - r
            or sz >= ctx.nze - r):
        raise ValueError(f"source window (sx={sxs}, sz={sz}, radius {r}) "
                         f"leaves the {ctx.nxe}x{ctx.nze} grid")


def _dev_f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def _coef_args(ctx: FDContext):
    """Host coefficient arrays (kept alive by the caller) and their
    pointers."""
    cx = np.ascontiguousarray(ctx.coefs_x, np.float32)
    cz = np.ascontiguousarray(ctx.coefs_z, np.float32)
    return (cx, cz), (cx.ctypes.data, cz.ctypes.data)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str, order: int = 0, k: int = 0) -> None:
    """Raises on a C entry point's error. For a kernel that stages a tile
    with a halo of ``k`` steps of order ``order``, the entry point's refusal
    (cudaErrorInvalidValue) means the tile does not fit a block's shared
    memory."""
    if rc == _INVALID_VALUE and k:
        raise ValueError(
            f"{name}: order {order} with K={k} steps (a halo of "
            f"{k * (order // 2)} cells) needs a tile larger than the "
            f"{SMEM_BYTES} bytes of shared memory a block may use "
            f"(kMaxSmemBytes, csrc/kstep.cuh): use a smaller block_k")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} in the step launches")


def _newest_prev(a, b, nt: int):
    """The two ping-pong buffers after nt steps: (newest, previous)."""
    return (b, a) if nt % 2 else (a, b)


def _check_gz(ctx: FDContext, gz: int) -> None:
    if not 0 <= gz < ctx.nze:
        raise ValueError(f"receiver depth gz={gz} is outside the grid")


def forward_modeling_cuda(ctx: FDContext, v2, wavelet, sx, sz: int, gz: int,
                          source: str = "gaussian", taper: str = "all",
                          record: str = "trace", lap_impl=None):
    """Forward modeling (``mod_main``, and ``rtm_main``'s forward half) for
    a batch of shots: the counterpart of ``forward_modeling_pallas`` and of
    ``forward_modeling_tiled``. Returns ``(p, pp, recorded)`` as
    :func:`..solver.forward_modeling`. With the exact taps, ``record=
    "trace"`` and ``"none"`` run ``mod_cluster`` where
    :func:`resident_plan` takes the shot (all nt steps in one launch), else
    ``mod_step``; ``"wavefield"`` runs ``rec_fwd_cluster``, else
    ``rec_fwd_step``, which write the (ns, nt, nx, nz) interior frames; the
    route is the one the entry point reports. Where ``lap_impl`` resolves
    to a split-bf16 tier (:func:`lap_parts`) they run ``mod_step_mma`` (the
    x taps split) and ``rec_fwd_step_mma`` (the z taps split)."""
    return _forward_modeling(ctx, v2, wavelet, sx, sz, gz, source, taper,
                             record, lap_parts(lap_impl, ctx))


def _forward_modeling(ctx: FDContext, v2, wavelet, sx, sz: int, gz: int,
                      source: str, taper: str, record: str, parts: int,
                      per_step: bool = False):
    """:func:`forward_modeling_cuda` with the Laplacian in ``parts`` bf16
    splits. ``per_step`` runs the exact per-step kernels (``mod_step``,
    ``rec_fwd_step``) at any shape (the probe and ``chip_smoke.py`` time
    both routes)."""
    if record not in solver.RECORD_MODES:
        raise ValueError(f"unknown record mode {record!r}")
    sxs = shot_positions(sx)
    ns, dev = len(sxs), v2.device
    wav = _check_wavelet(ctx, wavelet)
    v2_stride = _check_v2(ctx, v2, ns)
    patch = ctx.source_patch if source == "gaussian" else np.ones((1, 1))
    r = patch.shape[0] // 2
    _check_window(ctx, sxs, sz, r)
    _check_gz(ctx, gz)
    _check_order(ctx.order, _on_cuda(v2))
    if not _on_cuda(v2):
        return solver.forward_modeling(ctx, v2, wav, sxs, sz, gz,
                                       source=source, taper=taper,
                                       record=record, lap_impl=parts)
    from . import _build
    v2dt2 = v2 * ctx.dt2
    mask = _dev_f32(ctx.mask_all if taper == "all" else ctx.mask_top, dev)
    patch_d = _dev_f32(patch, dev)
    wav_d = _dev_f32(wav, dev)
    sx_d = torch.tensor(sxs, dtype=torch.int32, device=dev)
    a = torch.zeros((ns, ctx.nxe, ctx.nze), dtype=torch.float32, device=dev)
    b = torch.zeros_like(a)
    keep, (cx, cz) = _coef_args(ctx)
    resident = ctypes.c_int(0)
    args = (a.data_ptr(), b.data_ptr(), v2dt2.data_ptr(), v2_stride,
            mask.data_ptr(), patch_d.data_ptr(), r, sx_d.data_ptr(), sz)
    if record == "wavefield":
        rec = torch.empty((ns, ctx.nt, ctx.nx, ctx.nz), dtype=torch.float32,
                          device=dev)
        with torch.cuda.device(dev):
            rc = _build.library().pfdc_rec_fwd_run(
                *args, wav.ctypes.data, wav_d.data_ptr(), rec.data_ptr(), ns,
                ctx.nxe, ctx.nze, ctx.nxb, ctx.nzb, ctx.nt, ctx.order, parts,
                cx, cz, int(per_step), ctypes.byref(resident), _stream(dev))
        names = ("rec_fwd_cluster", "rec_fwd_step_mma" if parts
                 else "rec_fwd_step")
    else:
        rec = torch.empty((ns, ctx.nt, ctx.nx), dtype=torch.float32,
                          device=dev)
        dims = (ns, ctx.nxe, ctx.nze, ctx.nxb, ctx.nx, ctx.nt, ctx.order)
        with torch.cuda.device(dev):
            lib = _build.library()
            if parts:
                rc = lib.pfdc_mod_mma_run(*args, gz, wav.ctypes.data,
                                          rec.data_ptr(), *dims, parts, cx,
                                          cz, _stream(dev))
            else:
                rc = lib.pfdc_mod_run(
                    *args, gz, wav.ctypes.data, wav_d.data_ptr(),
                    rec.data_ptr(), int(record == "trace"), *dims, cx, cz,
                    int(per_step), ctypes.byref(resident), _stream(dev))
        names = ("mod_cluster", "mod_step_mma" if parts else "mod_step")
        if record == "none":
            rec = None
    name, count = ((names[0], 1) if resident.value else (names[1], ctx.nt))
    _raise_on(rc, name)
    LAUNCHES[name] += count
    newest, prev = _newest_prev(a, b, ctx.nt)
    return newest, prev * mask, rec


def _check_dobs(ctx: FDContext, dobs: torch.Tensor, device) -> int:
    """Checks the (ns, nx, nt) gathers and returns ns."""
    if dobs.dim() != 3:
        raise ValueError(f"dobs must be (ns, nx, nt), got shape "
                         f"{tuple(dobs.shape)}")
    _check("dobs", dobs, (dobs.shape[0], ctx.nx, ctx.nt), device)
    return dobs.shape[0]


def _next_shot_first(next_shot_first, ns: int, device) -> torch.Tensor:
    """``next_shot_first`` as an (ns,) float32 tensor: one number for every
    shot, or one per shot."""
    nxt = torch.as_tensor(next_shot_first, dtype=torch.float32,
                          device=device).reshape(-1)
    if nxt.numel() == 1:
        nxt = nxt.expand(ns)
    if nxt.shape != (ns,):
        raise ValueError(f"next_shot_first has {nxt.numel()} values, "
                         f"expected 1 or {ns}")
    return nxt


def _rec_bwd(ctx: FDContext, v2, dobs, gz: int, x_off_quirk, next_shot_first,
             lap_impl, swf=None, per_step: bool = False):
    """Checks the inputs of the receiver-mode step and routes them: the
    plain version on the CPU; on the card with the exact taps
    ``rec_bwd_cluster`` where :func:`resident_plan` takes the shot (all nt
    steps in one launch), else ``rec_bwd_step``, as the entry point
    reports; ``rec_bwd_step_mma`` where ``lap_impl`` resolves to a
    split-bf16 tier (the z taps split). ``per_step`` runs the exact
    per-step kernel at any shape (the probe and ``chip_smoke.py`` time both
    routes). Without ``swf`` (frame mode) returns ``(p, pp, rwf)``; with it
    (image mode) returns the (ns, nx, nz) images."""
    parts = lap_parts(lap_impl, ctx)
    _check_order(ctx.order, _on_cuda(v2))
    dev = v2.device
    ns = _check_dobs(ctx, dobs, dev)
    v2_stride = _check_v2(ctx, v2, ns)
    _check_gz(ctx, gz)
    nxt = _next_shot_first(next_shot_first, ns, dev)
    if swf is not None:
        _check("swf", swf, (ns, ctx.nt, ctx.nx, ctx.nz), dev)
    if not _on_cuda(v2):
        lap = solver.laplacian_of(ctx, parts, axis="z")
        if swf is None:
            return solver.backward_recorded(ctx, v2, dobs, gz,
                                            x_off_quirk=x_off_quirk,
                                            next_shot_first=nxt, lap=lap)
        return solver.backward_image(ctx, v2, swf, dobs, gz,
                                     x_off_quirk=x_off_quirk,
                                     next_shot_first=nxt, lap=lap)
    from . import _build
    v2dt2 = v2 * ctx.dt2
    mask = _dev_f32(ctx.mask_top, dev)
    inj = solver._injection_rows(ctx, dobs, nxt)            # (ns, nt, nx)
    x0 = solver.receiver_offset(ctx, x_off_quirk)
    a = torch.zeros((ns, ctx.nxe, ctx.nze), dtype=torch.float32, device=dev)
    b = torch.zeros_like(a)
    if swf is None:
        out = torch.empty((ns, ctx.nt, ctx.nx, ctx.nz), dtype=torch.float32,
                          device=dev)
    else:
        out = torch.zeros((ns, ctx.nx, ctx.nz), dtype=torch.float32,
                          device=dev)
    keep, (cx, cz) = _coef_args(ctx)
    resident = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _build.library().pfdc_rec_bwd_run(
            a.data_ptr(), b.data_ptr(), v2dt2.data_ptr(), v2_stride,
            mask.data_ptr(), inj.data_ptr(), x0, gz,
            None if swf is None else swf.data_ptr(), out.data_ptr(), ns,
            ctx.nxe, ctx.nze, ctx.nxb, ctx.nzb, ctx.nt, ctx.order, parts, cx,
            cz, int(per_step), ctypes.byref(resident), _stream(dev))
    name, count = (("rec_bwd_cluster", 1) if resident.value else
                   ("rec_bwd_step_mma" if parts else "rec_bwd_step", ctx.nt))
    _raise_on(rc, name)
    LAUNCHES[name] += count
    if swf is not None:
        return out
    newest, prev = _newest_prev(a, b, ctx.nt)
    return newest, prev * mask, out


def backward_recorded_cuda(ctx: FDContext, v2, dobs, gz: int,
                           x_off_quirk: bool = True, next_shot_first=0.0,
                           lap_impl=None):
    """``rtm_main``'s backward half for a batch of shots (``dobs`` (ns, nx,
    nt); ``next_shot_first`` one number or one per shot): the counterpart of
    ``backward_recorded_tiled``, in frame mode ``rec_bwd_cluster`` where
    :func:`resident_plan` takes the shot (all nt steps in one launch), else
    ``rec_bwd_step`` (``rec_bwd_step_mma`` under a split ``lap_impl``).
    Returns ``(p, pp, rwf)`` with rwf (ns, nt, nx, nz), as
    :func:`..solver.backward_recorded`."""
    return _rec_bwd(ctx, v2, dobs, gz, x_off_quirk, next_shot_first,
                    lap_impl)


def backward_image_cuda(ctx: FDContext, v2, swf, dobs, gz: int,
                        x_off_quirk: bool = True, next_shot_first=0.0,
                        lap_impl=None):
    """``rtm_main``'s backward half fused with its imaging for a batch of
    shots, correlating each step's frame with ``swf[:, nt-1-it]`` without
    storing the receiver wavefield: with the exact taps ``rec_bwd_cluster``
    in image mode where :func:`resident_plan` takes the shot (all nt steps
    in one launch, each cell's sum in registers), else ``rec_bwd_step``
    (``rec_bwd_step_mma`` under a split ``lap_impl``), the route the entry
    point reports. Returns the (ns, nx, nz) images, as
    :func:`..solver.backward_image` (both routes sum in time order, that
    function does not, so the two agree to rounding)."""
    return _rec_bwd(ctx, v2, dobs, gz, x_off_quirk, next_shot_first,
                    lap_impl, swf=swf)


def rtm_full_cuda(ctx: FDContext, v2, wavelet, dobs, sx, sz: int, gz: int,
                  x_off_quirk: bool = True, next_shot_first=0.0,
                  lap_impl=None):
    """Full-wavefield RTM (``rtm_main``) for a batch of shots: the
    counterpart of ``rtm_shot_full_tiled``. The forward stores the source
    wavefield, then the backward in image mode reads it back in reverse:
    with the exact taps ``rec_fwd_cluster`` and ``rec_bwd_cluster``, one
    launch each, where :func:`resident_plan` takes the shot, else
    ``rec_fwd_step`` and ``rec_bwd_step``, nt launches each; under a
    ``lap_impl`` that resolves to ``mxu``/``mxu6``, their ``*_mma`` twins
    (the z taps split, as the JAX K-step recording kernel splits them).
    Returns the (ns, nx, nz) images, as :func:`..solver.rtm_shot_full`."""
    parts = lap_parts(lap_impl, ctx)
    _, _, swf = forward_modeling_cuda(ctx, v2, wavelet, sx, sz, gz,
                                      source="point", taper="top",
                                      record="wavefield", lap_impl=parts)
    return backward_image_cuda(ctx, v2, swf, dobs, gz,
                               x_off_quirk=x_off_quirk,
                               next_shot_first=next_shot_first,
                               lap_impl=parts)


class LapShape(NamedTuple):
    """The launch of ``lap_apply`` over an (nx, nz) field (``lap_shape``,
    csrc/laplacian.cu): ``bands`` x ``runs`` CTAs, each ``band`` output
    columns by ``run`` output rows (the grid's tails cut the last of each),
    ``threads`` a CTA, and the ring of input rows in ``smem_bytes`` of
    dynamic shared memory."""
    bands: int
    runs: int
    run: int
    band: int
    threads: int
    smem_bytes: int


def lap_shape(nx: int, nz: int, order: int) -> LapShape:
    """The launch :func:`laplacian_cuda` makes over an (nx, nz) field at
    ``order`` on the current device, asked of the built library: the runs
    are cut so that the grid makes about two waves of CTAs on the device's
    SMs, at least 16 rows each."""
    from . import _build
    out = (ctypes.c_int * len(LapShape._fields))()
    _raise_on(_build.library().pfdc_lap_shape(nx, nz, order, out),
              "lap_apply")
    return LapShape(*out)


def laplacian_cuda(p, coefs_x, coefs_z, order: int):
    """The order-``order`` interior Laplacian of one (nx, nz) field with a
    zero border of width order/2: the counterpart of ``laplacian_pallas``,
    ``lap_apply`` on the card (one launch of :func:`lap_shape`'s grid),
    :func:`.stencil.laplacian` on the CPU. ``coefs_x``/``coefs_z`` are the
    premultiplied (order+1,) arrays of
    :func:`..numerics.scaled_coefficients`."""
    _check_order(order, _on_cuda(p))
    if p.dim() != 2:
        raise ValueError(f"p must be one (nx, nz) field, got shape "
                         f"{tuple(p.shape)}")
    nx, nz = p.shape
    if nx <= order or nz <= order or max(nx, nz) > _INT_MAX:
        raise ValueError(f"field {nx}x{nz} does not fit order {order} or "
                         f"the kernel's int dims")
    _check("p", p, (nx, nz), p.device)
    cx = np.ascontiguousarray(coefs_x, np.float32)
    cz = np.ascontiguousarray(coefs_z, np.float32)
    if cx.shape != (order + 1,) or cz.shape != (order + 1,):
        raise ValueError(f"coefficients must be ({order + 1},) arrays")
    if not _on_cuda(p):
        return stencil.laplacian(p, cx, cz, order)
    from . import _build
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        rc = _build.library().pfdc_lap_run(
            p.data_ptr(), out.data_ptr(), nx, nz, order, cx.ctypes.data,
            cz.ctypes.data, _stream(p.device))
    _raise_on(rc, "lap_apply")
    LAUNCHES["lap_apply"] += 1
    return out


def fd_forward_cuda(ctx: FDContext, v2, wavelet, sx, sz: int):
    """GPU-suite forward propagation for a batch of shots: the counterpart
    of ``fd_forward_pallas``, with the exact taps as there. Returns the
    tapered final pair ``(p, pp)``, as :func:`..solver.fd_forward`."""
    return _fd_forward(ctx, v2, wavelet, sx, sz, 0)


def _fd_forward(ctx: FDContext, v2, wavelet, sx, sz: int, parts: int,
                per_step: bool = False):
    """:func:`fd_forward_cuda` with the Laplacian in ``parts`` bf16 splits
    (0: exact, ``rtm_fwd_cluster`` where :func:`resident_plan` takes the
    shot, else ``rtm_fwd_step``, as the entry point reports; 2, 3:
    ``rtm_fwd_step_mma``). ``per_step`` runs the exact per-step kernel at
    any shape (the probe and ``chip_smoke.py`` time both routes)."""
    sxs = shot_positions(sx)
    ns, dev = len(sxs), v2.device
    wav = _check_wavelet(ctx, wavelet)
    v2_stride = _check_v2(ctx, v2, ns)
    _check_window(ctx, sxs, sz, 0)
    _check_order(ctx.order, _on_cuda(v2))
    if not _on_cuda(v2):
        return solver.fd_forward(ctx, v2, wav, sxs, sz,
                                 solver.laplacian_of(ctx, parts))
    from . import _build
    v2dt2 = v2 * ctx.dt2
    mask = _dev_f32(ctx.mask_top, dev)
    sx_d = torch.tensor(sxs, dtype=torch.int32, device=dev)
    a = torch.zeros((ns, ctx.nxe, ctx.nze), dtype=torch.float32, device=dev)
    b = torch.zeros_like(a)
    keep, (cx, cz) = _coef_args(ctx)
    args = (a.data_ptr(), b.data_ptr(), v2dt2.data_ptr(), v2_stride,
            mask.data_ptr(), sx_d.data_ptr(), sz)
    dims = (ns, ctx.nxe, ctx.nze, ctx.nt, ctx.order)
    if parts:
        name, count = "rtm_fwd_step_mma", ctx.nt
        with torch.cuda.device(dev):
            rc = _build.library().pfdc_rtm_fwd_mma_run(
                *args, wav.ctypes.data, *dims, parts, cx, cz, _stream(dev))
    else:
        wav_d = _dev_f32(wav, dev)
        resident = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _build.library().pfdc_rtm_fwd_run(
                *args, wav_d.data_ptr(), *dims, cx, cz, int(per_step),
                ctypes.byref(resident), _stream(dev))
        name, count = (("rtm_fwd_cluster", 1) if resident.value
                       else ("rtm_fwd_step", ctx.nt))
    _raise_on(rc, name)
    LAUNCHES[name] += count
    newest, prev = _newest_prev(a, b, ctx.nt)
    return prev * mask, newest


def fd_back_cuda(ctx: FDContext, v2, snap_p, snap_pp, dobs, gz: int):
    """GPU-suite backward propagation and imaging for a batch of shots: the
    counterpart of ``fd_back_pallas``, with the exact taps as there.
    ``snap_p``/``snap_pp`` are :func:`fd_forward_cuda`'s outputs (ns, nxe,
    nze); ``dobs`` is (ns, nx, nt). Returns the (ns, nx, nz) images."""
    return _fd_back(ctx, v2, snap_p, snap_pp, dobs, gz, 0)


def _fd_back(ctx: FDContext, v2, snap_p, snap_pp, dobs, gz: int,
             parts: int, per_step: bool = False):
    """:func:`fd_back_cuda` with the Laplacian in ``parts`` bf16 splits
    (0: exact, ``rtm_bwd_cluster`` where :func:`resident_plan` takes the
    shot, else ``rtm_bwd_step``, as the entry point reports; 2, 3:
    ``rtm_bwd_step_mma``). ``per_step`` runs the exact per-step kernel at
    any shape."""
    _check_order(ctx.order, _on_cuda(v2))
    dev = v2.device
    ns = snap_p.shape[0]
    _check_gz(ctx, gz)
    _check("snap_p", snap_p, (ns, ctx.nxe, ctx.nze), dev)
    _check("snap_pp", snap_pp, (ns, ctx.nxe, ctx.nze), dev)
    _check("dobs", dobs, (ns, ctx.nx, ctx.nt), dev)
    v2_stride = _check_v2(ctx, v2, ns)
    if not _on_cuda(v2):
        return solver.fd_back(ctx, v2, snap_p, snap_pp, dobs, gz,
                              solver.laplacian_of(ctx, parts))
    from . import _build
    v2dt2 = v2 * ctx.dt2
    mask = _dev_f32(ctx.mask_top, dev)
    inj = dobs.flip(-1).transpose(1, 2).contiguous()   # (ns, nt, nx)
    sa = torch.empty((ns, ctx.nxe, ctx.nze), dtype=torch.float32, device=dev)
    sb = torch.empty_like(sa)
    ra = torch.zeros_like(sa)
    rb = torch.zeros_like(sa)
    img = torch.zeros((ns, ctx.nx, ctx.nz), dtype=torch.float32, device=dev)
    keep, (cx, cz) = _coef_args(ctx)
    args = (sa.data_ptr(), sb.data_ptr(), snap_p.data_ptr(),
            snap_pp.data_ptr(), ra.data_ptr(), rb.data_ptr(),
            v2dt2.data_ptr(), v2_stride, mask.data_ptr(), inj.data_ptr(),
            img.data_ptr(), gz, ctx.nxb, ctx.nzb, ns, ctx.nxe, ctx.nze,
            ctx.nt, ctx.order)
    if parts:
        name, count = "rtm_bwd_step_mma", ctx.nt
        with torch.cuda.device(dev):
            rc = _build.library().pfdc_rtm_bwd_mma_run(*args, parts, cx, cz,
                                                       _stream(dev))
    else:
        resident = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _build.library().pfdc_rtm_bwd_run(
                *args, cx, cz, int(per_step), ctypes.byref(resident),
                _stream(dev))
        name, count = (("rtm_bwd_cluster", 1) if resident.value
                       else ("rtm_bwd_step", ctx.nt))
    _raise_on(rc, name)
    LAUNCHES[name] += count
    return img


def rtm_snapshot_cuda(ctx: FDContext, v2, wavelet, dobs, sx, sz: int,
                      gz: int, lap_impl=None):
    """Two-snapshot RTM for a batch of shots: the counterpart of
    ``rtm_snapshot_pallas``. The forward and backward kernels run back to
    back on one stream; the snapshots stay on the card. ``lap_impl``
    (:func:`lap_parts`) picks ``rtm_fwd_step``/``rtm_bwd_step`` (exact) or
    ``rtm_fwd_step_mma``/``rtm_bwd_step_mma`` (split bf16); on CPU tensors
    :func:`..solver.rtm_shot_snapshot` with the same Laplacian. Returns the
    (ns, nx, nz) images."""
    parts = lap_parts(lap_impl, ctx)
    p, pp = _fd_forward(ctx, v2, wavelet, sx, sz, parts)
    return _fd_back(ctx, v2, p, pp, dobs, gz, parts)
