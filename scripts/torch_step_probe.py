#!/usr/bin/env python3
"""Build, check and time the split per-step kernels of checkouts of the
PyTorch port on one CUDA card: ``fd_step_mma``, ``fd_update_mma`` and
``gpu_step_mma`` of the K = 1 tier and rtm_main's ``rec_fwd_step_mma`` and
``rec_bwd_step_mma`` (the one-step strip body, the z taps in bf16 parts),
and the two-snapshot RTM's ``rtm_bwd_step_mma`` (the x taps in bf16
parts), each beside its exact twin.

    python3 scripts/torch_step_probe.py TREE [TREE ...]
                                        [--variants NAME ...] [--rounds N]
                                        [--only REGEX]
                                        [--rtm | --mod | --rec-bwd |
                                         --step-mma]

Each tree runs in a process of its own that imports the port from that
tree (building its kernels there). The process prints the compiler's
register, shared-memory and spill lines of these kernels at orders 8 and
16, holds the split kernels against their plain versions with the same
parts (2 and 3) on a small ragged grid (67 x 88 extended, two shots,
orders 4, 8, 12 and 16; ``fd_step`` with both tapers and every injection:
none, the Gaussian window, the point source, the receiver row;
``fd_update``; ``gpu_step`` without and with the trace row and the
image; gate 1e-6 of the plain result's max; ``rec_bwd_step`` over 9
steps in frame mode, both receiver offsets, and in image mode, gates
1e-4 and 1e-5, exact or split; ``rec_fwd_step``'s fields and frames over
9 steps, the point sources across the owned shapes' edges, gate 1e-4;
``rtm_bwd_step``'s image over 9 steps from random snapshots, the two
seeded steps included, gate 1e-5) and the other exact ones bitwise, and
then times them at the
Pluto grid (7040 x 1281 extended, order 8, 2 shots) as ``chip_smoke.py``
phase 31 times them: ``fd_step`` over 1001 launches (the Gaussian
source, the all-edge taper, one velocity plane), ``gpu_step`` over 1001
receiver launches (the trace row and the image) and over 1001 forward
launches (neither), ``fd_update`` over 999; exact, mxu and mxu6; then
``rec_fwd_step`` (the frames) and ``rec_bwd_step`` in image mode at 3lay
(8 shots of 231 x 231 extended, nt = 1001) and at the Pluto grid (2
shots, nt = 203, the rtm_main path of phase 30), exact, mxu and mxu6;
then the split K = 1 modeling and RTM calls (``forward_modeling_tiled``
and ``rtm_shot_snapshot_tiled`` at block_k = 1, mxu, nt = 1001), the 3lay
rtm_main call (``rtm_full_cuda``, mxu), ``rtm_bwd_step`` at 3lay from
random snapshots (exact, mxu and mxu6) and the 3lay RTM call
(``rtm_snapshot_cuda``, mxu). Median of 3 CUDA-event samples after a
warm-up. ``--only`` times only the cases whose names the regular
expression finds (``"rec_fwd|rtm_bwd|3lay"``: the rtm_main and 3lay
cases); the checks always run.

``--variants`` adds copies of the last tree with other constants:
``step64x64``, ``step64x128`` and ``step32x128`` (the first owned shape
of the one-step split body, ``kStepShapes`` in ``csrc/step_strip.cuh``);
``fd_rows4``, ``upd_rows4``, ``gpu_rows8`` and ``rec_rows8`` (the rows of
a strip, ``kRows`` of ``fd_step_mma``'s, ``fd_update_mma``'s,
``gpu_step_mma``'s and ``rec_bwd_step_mma``'s sites; ``recf_rows8``:
``rec_fwd_step_mma``'s); ``fd_ahead``, ``upd_ahead``, ``gpu_behind``,
``rec_behind`` and ``recf_ahead`` (whether a warp loads its next strip's
operands while it computes the current one, ``kAhead`` of the same
sites); ``rec128x64``, ``rec64x64``, ``rec32x64`` and ``rec64x32`` (both
rec kernels on that one owned shape at every grid instead of their shape
rule, ``kRecShapes`` in ``csrc/rec_step.cu``); ``bwd32x32`` and
``bwd64x32`` (``rtm_bwd_step_mma``'s owned shape instead of 32 x 64, a
warp for each 16 x 16: ``kBwdTileX``/``kBwdTileZ`` in
``csrc/step_mma.cu``); made under a temporary directory. The trees run in turns, ``--rounds`` times (A, B,
..., then in reverse), as ``scripts/torch_bwd_probe.py`` runs them.
Prints one JSON line per process and the medians per tree, beside the
card's name and power limit.

``--mod`` probes the exact modeling kernels instead (``mod_cluster`` and
``rec_fwd_cluster``, ``mod_loop`` of ``csrc/cluster_loop.cuh``, and the
per-step ``mod_step``/``rec_fwd_step``): the compiler's lines of each at
orders 8 and 16, the clusters the card holds at once at 3lay, both routes
bitwise against the plain version at 3lay (8 shots of 231 x 231
extended, nt = 20, orders 4, 8, 10 and 16; 1lay, 281 x 181 extended, at
order 8) for the modeling (the Gaussian source, the all-edge taper, the
trace) and rtm_main's forward (the point source, the top taper, the
frames), then, at 1lay and 3lay, order 8, nt = 1001, each call on each
route, and at 3lay the resident calls at 7 shots and 1, median of 3. A
tree without the modeling's resident route (the parent) times its
per-step kernels under the resident names. Its variants: ``frame_pairs``
(a column pair's frames stored as one 8-byte vector where the frame row
allows) and ``amp_now`` (the wavelet sample loaded at its step, not a
step ahead).

``--rec-bwd`` probes rtm_main's exact backward instead
(``rec_bwd_cluster``, ``mod_loop`` with the injection row, and the
per-step ``rec_bwd_step``): the compiler's lines of both and of the
forward kernels on the same loop (``mod_cluster``, ``rec_fwd_cluster``)
at orders 8 and 16, the clusters the card holds at once at 3lay, both
routes bitwise against the plain version at 3lay (8 shots of 231 x 231
extended, nt = 20, orders 4, 8, 10 and 16; 1lay at order 8; both
``x_off_quirk`` settings, random ``next_shot_first``): the frames and the
final pair against ``solver.backward_recorded``, the image from random
source frames against the plain frames' correlation summed in time
order; then, at 1lay and 3lay, order 8, nt = 1001, the image and the
frame mode on each route, at 3lay the resident calls at 7 shots and 1,
the modeling and rtm_main's forward (resident) and the whole rtm_main
call (``rtm_full_cuda``), median of 3. A tree without the backward's
resident route (the parent) times its per-step kernel under the resident
names. Its variant ``swf_staged``: each thread's source frame values of
the next step copied with ``cp.async`` into a double buffer in shared
memory and waited at the step, instead of loaded into registers a step
ahead.

``--rtm`` probes the exact two-snapshot RTM instead (``rtm_fwd_cluster``
and ``rtm_bwd_cluster`` on ``csrc/cluster_loop.cuh``, and the per-step
``rtm_fwd_step``/``rtm_bwd_step``): the compiler's lines of both at
orders 8 and 16, the clusters the card holds at once at 3lay, both routes
bitwise against the plain versions at 3lay (8 shots of 231 x 231
extended, nt = 20, orders 4, 8, 10 and 16, random velocities, gathers and
wavelet; 1lay, 281 x 181 extended, at order 8), then, at 3lay and 1lay,
order 8, nt = 1001, the forward and backward pass of each route and the
RTM call of each route (the two passes back to back), at 3lay the
resident passes also at 7 shots (one wave of the clusters of 16 the card
holds at once) and 1, and the tiled K-step tier's RTM call
(``rtm_shot_snapshot_tiled`` at the pipeline's K), median of 3. A tree
without the resident route (the parent) times its per-step kernels under
the resident names. Its variants (``csrc/cluster_loop.cuh``): the cluster
sizes tried (``kClusterSizes``) ``cluster8`` and ``cluster9``; the strip
(``kClusterRows`` x ``kClusterCols``, 4 x 2) ``rows2``, ``rows8``,
``cols1``, ``cols4``, ``cols4rows2``; ``threads1024``
(``kClusterThreads``); ``cluster9c4``, ``cluster9t`` and ``cluster8c4``
(a cluster size with 4 columns or 1024 threads); and, for timing only
(wrong results, so the probe exits 1), ``nosync`` and ``nosync9`` (no
cluster barrier between steps).

``--step-mma`` probes the split per-step kernels of ``csrc/step_mma.cu``
instead (``mod_step_mma``, ``rtm_fwd_step_mma``, ``rtm_bwd_step_mma``, the
x taps split): the compiler's lines of each at orders 8 and 16, each
against its plain version with the same parts (2 and 3) within 1e-5 of the
plain result's max over 20 steps at 3lay (8 shots of 231 x 231 extended,
orders 4, 8, 10 and 16, the taper at fac 0.7) and on a ragged 207 x 203
(orders 8 and 16), then, at 3lay, order 8, nt = 1001, each kernel in mxu
and mxu6 (``mod_step_mma``: the 3lay modeling call, one velocity plane),
its exact per-step twin (``per_step=True``) and the 3lay RTM call in mxu,
median of 3. Its variants: ``own32x32`` and ``own64x64``
(``mod_step_mma``'s and ``rtm_fwd_step_mma``'s owned shape instead of 32 x
64: ``kModTileX``/``kModTileZ`` and ``kFwdTileX``/``kFwdTileZ``);
``sx_first`` (``mod_step_mma`` reads its shot's x before it issues the
stage, not after), ``band_early`` (both forward kernels compute their band
fragments before the wait, not after the barrier) and ``sx_band`` (both).
"""

from __future__ import annotations

import pathlib
import re
import sys

import torch_bwd_probe

CSRC = (pathlib.Path(__file__).resolve().parents[1]
        / "parallel_finite_difference_computation_tpu_torch" / "csrc")

_STEP_FIRST = "kStepShapes[] = {{128, 64}};"
_REC = "kRecShapes[] = {{128, 64}, {64, 64}, {32, 64}};"
_FD = "struct FdStepSite {\n  static constexpr int kRows = 8;\n"
_UPD = "struct FdUpdateSite {\n  static constexpr int kRows = 8;\n"
_REC_SITE = ("struct RecBwdSite {\n  static constexpr int kRows = "
             "pfdc::kStripRows;\n  static constexpr bool kAhead = true;\n")
_RECF_SITE = _REC_SITE.replace("RecBwdSite", "RecFwdSite").replace(
    "true;", "false;")
_OWN = ("constexpr int kModTileX = 32;\nconstexpr int kModTileZ = 64;\n"
        "constexpr int kFwdTileX = 32;\nconstexpr int kFwdTileZ = 64;\n")
_MOD_HEAD = """  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;
  const float* v2 = v2dt2 + s * static_cast<size_t>(v2_shot_stride);
  for_staged_cells<T>([&](int lx, int lz) {
    const int x = x0 - H + lx, z = z0 - H + lz;
    const bool in = x >= 0 && x < nxe && z >= 0 && z < nze;
    const size_t q = in ? static_cast<size_t>(x) * nze + z : 0;
    pfdc::cp_async4(f + lx * T::kPitch + lz, p + q, in);
"""
_MOD_XS = "  const int xs = sx[s];\n  ModCell cell[2][4];\n"
_BAND = "  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);\n"
_MOD_WAIT = "  pfdc::cp_async_wait_all();\n  __syncthreads();\n" + _BAND
_FWD_WAIT = """  pfdc::cp_async_wait_all();
  for_staged_cells<T>([&](int lx, int lz) {
    const int j = lx * T::kPitch + lz;
    f[j] = msk[j] * f[j];
  });
  __syncthreads();
""" + _BAND
_BWD = "constexpr int kBwdTileX = 32;\nconstexpr int kBwdTileZ = 64;"
_SIZES = "constexpr int kClusterSizes[] = {16, 8, 4, 2};"
_ROWS = "constexpr int kClusterRows = 4;"
_COLS = "constexpr int kClusterCols = 2;"
_SYNC = "    cooperative_groups::cluster_group& cl) {\n  cl.sync();"
_FRAMES = """          if (kRecord == kRecordFrames && gx >= g.nxb &&
              gx < g.nxb + g.nx && iz >= g.nzb && iz < g.nzb + g.nz) {
            rec_shot[(static_cast<size_t>(it) * g.nx + (gx - g.nxb)) * g.nz +
                     (iz - g.nzb)] = m * centre;
          }
"""
_STORE_ROW = "        store_cols(smem + old + q, stored);\n"
_PAIRS = """        if (kRecord == kRecordFrames && gx >= g.nxb && gx < g.nxb + g.nx) {
          const int fz = st.iz0 - g.nzb;
          float* f = rec_shot +
                     (static_cast<size_t>(it) * g.nx + (gx - g.nxb)) * g.nz +
                     fz;
          const float f0 = mr[r][0] * w[r + H].v[0];
          const float f1 = mr[r][1] * w[r + H].v[1];
          const bool in0 = fz >= 0 && fz < g.nz;
          const bool in1 = fz + 1 >= 0 && fz + 1 < g.nz;
          if (in0 && in1 && (reinterpret_cast<size_t>(f) & 7) == 0) {
            *reinterpret_cast<float2*>(f) = make_float2(f0, f1);
          } else {
            if (in0) f[0] = f0;
            if (in1) f[1] = f1;
          }
        }
"""
_AMP = "      const float amp = pw ? g.wav[it] : 0.0f;\n"
_AMP_AHEAD = """      const float amp = amp_next;
      if (pw && it + 1 < g.nt) amp_next = g.wav[it + 1];
"""
_AMP_FIRST = "  float amp_next = pw && g.nt > 0 ? g.wav[0] : 0.0f;\n"
_CP_FNS_AT = "// The source's x of shot s (mod_loop with the patch).\n"
_CP_FNS = """// cp.async groups: commit this thread's copies; wait until at most N
// are pending.
__device__ __forceinline__ void cp_async_commit() {
#ifndef PFDC_CPU_SHIM
  asm volatile("cp.async.commit_group;\\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifndef PFDC_CPU_SHIM
  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));
#endif
}

"""
_SW_FIRST = """      // frame nt - 1 of the source wavefield is the first step's
      const float* frame =
          swf_shot + static_cast<ptrdiff_t>(g.nt - 1) * g.nx * g.nz + f0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int col = 0; col < V; ++col) {
          sw_next[r][col] = (fw >> (r * V + col)) & 1u && g.nt > 0
                                ? frame[r * g.nz + col]
                                : 0.0f;
        }
      }
"""
_SW_FIRST_STAGED = """      // frame nt - 1 of the source wavefield is the first step's: into
      // stage buffer 0, after the two levels
      const float* frame =
          swf_shot + static_cast<ptrdiff_t>(g.nt - 1) * g.nx * g.nz + f0;
      if (g.nt > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int col = 0; col < V; ++col) {
            const bool in = (fw >> (r * V + col)) & 1u;
            cp_async4(smem + 2 * level + (r * V + col) * blockDim.x +
                          threadIdx.x,
                      in ? frame + r * g.nz + col : g.swf, in);
          }
        }
        cp_async_commit();
      }
"""
_SW_STEP = """        if constexpr (kImage) {
          const float* frame =
              swf_shot +
              static_cast<ptrdiff_t>(g.nt - 2 - it) * g.nx * g.nz + f0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int col = 0; col < V; ++col) {
              sw_now[r][col] = sw_next[r][col];
              if ((fw >> (r * V + col)) & 1u && ahead) {
                sw_next[r][col] = frame[r * g.nz + col];
              }
            }
          }
        }
"""
_SW_STEP_STAGED = """        if constexpr (kImage) {
          float* const buf = smem + 2 * level;
          const int n = R * V * blockDim.x;
          if (ahead) {
            const float* frame =
                swf_shot +
                static_cast<ptrdiff_t>(g.nt - 2 - it) * g.nx * g.nz + f0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
#pragma unroll
              for (int col = 0; col < V; ++col) {
                const bool in = (fw >> (r * V + col)) & 1u;
                cp_async4(buf + ((it + 1) & 1) * n +
                              (r * V + col) * blockDim.x + threadIdx.x,
                          in ? frame + r * g.nz + col : g.swf, in);
              }
            }
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int col = 0; col < V; ++col) {
              sw_now[r][col] = buf[(it & 1) * n +
                                   (r * V + col) * blockDim.x + threadIdx.x];
            }
          }
        }
"""
_REC_BWD_BYTES = """                 ? pfdc::launch_cluster(rec_bwd_cluster<H, true>, plan, ns,
                                        plan.fwd_bytes, stream, g, c)"""
_STAGE_BYTES = ("plan.fwd_bytes + 2 * pfdc::kClusterRows * "
                "pfdc::kClusterCols * plan.threads * 4")
_REC_BWD_BYTES_STAGED = _REC_BWD_BYTES.replace("plan.fwd_bytes",
                                               _STAGE_BYTES)
_REC_BWD_HELD = """    *out = pfdc::active_clusters(rec_bwd_cluster<H, true>, plan,
                                 plan.fwd_bytes);"""
_REC_BWD_HELD_STAGED = _REC_BWD_HELD.replace("plan.fwd_bytes", _STAGE_BYTES)
VARIANTS = {
    "step64x64": ("step_strip.cuh", _STEP_FIRST,
                  "kStepShapes[] = {{64, 64}};"),
    "step64x128": ("step_strip.cuh", _STEP_FIRST,
                   "kStepShapes[] = {{64, 128}};"),
    "step32x128": ("step_strip.cuh", _STEP_FIRST,
                   "kStepShapes[] = {{32, 128}};"),
    "fd_rows4": ("stream_step.cu", _FD, _FD.replace(
        "8;", "pfdc::kStripRows;")),
    "fd_ahead": ("stream_step.cu", _FD + "  static constexpr bool kAhead = "
                 "false;", _FD + "  static constexpr bool kAhead = true;"),
    "upd_rows4": ("stream_step.cu", _UPD, _UPD.replace(
        "8;", "pfdc::kStripRows;")),
    "upd_ahead": ("stream_step.cu", _UPD + "  static constexpr bool kAhead "
                  "= false;", _UPD + "  static constexpr bool kAhead = "
                  "true;"),
    "rec_rows8": ("rec_step.cu", _REC_SITE, _REC_SITE.replace(
        "pfdc::kStripRows;", "8;")),
    "rec_behind": ("rec_step.cu", _REC_SITE, _REC_SITE.replace(
        "true;", "false;")),
    "recf_rows8": ("rec_step.cu", _RECF_SITE, _RECF_SITE.replace(
        "pfdc::kStripRows;", "8;")),
    "recf_ahead": ("rec_step.cu", _RECF_SITE, _RECF_SITE.replace(
        "false;", "true;")),
    # mod_step_mma's and rtm_fwd_step_mma's owned shape (--step-mma)
    "own32x32": ("step_mma.cu", _OWN, _OWN.replace("Z = 64", "Z = 32")),
    "own64x64": ("step_mma.cu", _OWN, _OWN.replace("X = 32", "X = 64")),
    # mod_step_mma's shot position read first, before the stage is
    # issued (the window test of the lanes' patch loads waits on it)
    "sx_first": [("step_mma.cu", _MOD_HEAD, _MOD_HEAD.replace(
        "blockIdx.z;\n", "blockIdx.z;\n  const int xs = sx[s];\n", 1)),
                 ("step_mma.cu", _MOD_XS, "  ModCell cell[2][4];\n")],
    # the band fragments of mod_step_mma and rtm_fwd_step_mma computed
    # while the stage is in flight, not after the barrier
    "band_early": [("step_mma.cu", _MOD_WAIT, _BAND + _MOD_WAIT[:-len(
        _BAND)]), ("step_mma.cu", _FWD_WAIT, _BAND + _FWD_WAIT[:-len(_BAND)])],
    "bwd32x32": ("step_mma.cu", _BWD, _BWD.replace("Z = 64", "Z = 32")),
    "bwd64x32": ("step_mma.cu", _BWD, _BWD.replace("X = 32", "X = 64")
                 .replace("Z = 64", "Z = 32")),
    "rec128x64": ("rec_step.cu", _REC, "kRecShapes[] = {{128, 64}};"),
    "rec64x64": ("rec_step.cu", _REC, "kRecShapes[] = {{64, 64}};"),
    "rec32x64": ("rec_step.cu", _REC, "kRecShapes[] = {{32, 64}};"),
    "rec64x32": ("rec_step.cu", _REC, "kRecShapes[] = {{64, 32}};"),
    "gpu_rows8": ("gpu_step.cu",
                  "static constexpr int kRows = pfdc::kStripRows;",
                  "static constexpr int kRows = 8;"),
    "gpu_behind": ("gpu_step.cu", "static constexpr bool kAhead = true;",
                   "static constexpr bool kAhead = false;"),
    "cluster8": ("cluster_loop.cuh", _SIZES,
                 _SIZES.replace("{16, 8, 4, 2}", "{8, 4, 2}")),
    "rows2": ("cluster_loop.cuh", _ROWS, _ROWS.replace("4;", "2;")),
    "rows8": ("cluster_loop.cuh", _ROWS, _ROWS.replace("4;", "8;")),
    "cols1": ("cluster_loop.cuh", _COLS, _COLS.replace("2;", "1;")),
    "cols4": ("cluster_loop.cuh", _COLS, _COLS.replace("2;", "4;")),
    "cols4rows2": [("cluster_loop.cuh", _COLS, _COLS.replace("2;", "4;")),
                   ("cluster_loop.cuh", _ROWS, _ROWS.replace("4;", "2;"))],
    "threads1024": ("cluster_loop.cuh",
                    "constexpr int kClusterThreads = 512; ",
                    "constexpr int kClusterThreads = 1024;"),
    "cluster9": ("cluster_loop.cuh", _SIZES,
                 _SIZES.replace("{16, 8, 4, 2}", "{9, 8, 4, 2}")),
    "cluster9c4": [("cluster_loop.cuh", _SIZES,
                    _SIZES.replace("{16, 8, 4, 2}", "{9, 8, 4, 2}")),
                   ("cluster_loop.cuh", _COLS, _COLS.replace("2;", "4;"))],
    "cluster9t": [("cluster_loop.cuh", _SIZES,
                   _SIZES.replace("{16, 8, 4, 2}", "{9, 8, 4, 2}")),
                  ("cluster_loop.cuh", "constexpr int kClusterThreads = 512; ",
                   "constexpr int kClusterThreads = 1024;")],
    "cluster8c4": [("cluster_loop.cuh", _SIZES,
                    _SIZES.replace("{16, 8, 4, 2}", "{8, 4, 2}")),
                   ("cluster_loop.cuh", _COLS, _COLS.replace("2;", "4;"))],
    # the modeling loop (mod_loop, --mod): the frames of a column pair
    # stored as one 8-byte vector where the frame's row puts it on 8 bytes
    # (at 3lay's odd nz every other row), else as two floats
    "frame_pairs": [("cluster_loop.cuh", _FRAMES, ""),
                    ("cluster_loop.cuh", _STORE_ROW, _STORE_ROW + _PAIRS)],
    # the wavelet sample loaded at its step, not a step ahead, by the
    # threads whose cells the source's window covers
    "amp_now": [("cluster_loop.cuh", _AMP_AHEAD, _AMP),
                ("cluster_loop.cuh", _AMP_FIRST, "")],
    # rtm_main's backward in image mode (--rec-bwd): each thread's source
    # frame values of the next step copied with cp.async into a double
    # buffer in shared memory (a cell's values of the CTA's threads
    # adjacent), waited at the step, instead of loaded into registers
    "swf_staged": [("cluster_loop.cuh", _CP_FNS_AT, _CP_FNS + _CP_FNS_AT),
                   ("cluster_loop.cuh", _SW_FIRST, _SW_FIRST_STAGED),
                   ("cluster_loop.cuh", _SW_STEP, _SW_STEP_STAGED),
                   ("rec_step.cu", _REC_BWD_BYTES, _REC_BWD_BYTES_STAGED),
                   ("rec_step.cu", _REC_BWD_HELD, _REC_BWD_HELD_STAGED)],
    # timing only, wrong results: no cluster barrier between steps
    "nosync": ("cluster_loop.cuh", _SYNC, _SYNC.replace("cl.sync()",
                                                        "__syncthreads()")),
    "nosync9": [("cluster_loop.cuh", _SIZES,
                 _SIZES.replace("{16, 8, 4, 2}", "{9, 8, 4, 2}")),
                ("cluster_loop.cuh", _SYNC, _SYNC.replace("cl.sync()",
                                                          "__syncthreads()"))],
}
# both of the above
VARIANTS["sx_band"] = VARIANTS["sx_first"] + VARIANTS["band_early"]
# lap_apply (--stencil): csrc/laplacian.cu's constants, one at a time
for _name, _const, _values in (
        ("band", "kLapBand", ("128", "512")),
        ("ahead", "kLapAhead", ("2", "8")),
        ("waves", "kLapWaves", ("1", "4")),
        ("minrun", "kLapMinRun", ("8", "16"))):
    _line = re.search(rf"constexpr \w+ {_const} = (\w+);",
                      (CSRC / "laplacian.cu").read_text())
    for _v in _values:
        VARIANTS[f"lap_{_name}{_v}"] = ("laplacian.cu", _line[0],
                                        re.sub(r"= \w+;", f"= {_v};",
                                               _line[0]))
VARIANTS["lap_narrow"] = ("laplacian.cu", "kLapWide = true;",
                          "kLapWide = false;")

CHILD = r'''
import json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
stream = __import__(pkg + ".ops.stream", fromlist=["x"])
fk = __import__(pkg + ".ops.fd_kernels", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
build.library()
fn = None
ptxas = []        # printed after the checks, whose lines stderr's tail keeps
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    # the order-8 and order-16 instances (H = 4, 8)
    name = fn and re.search(
        r"\d((?:fd_step|fd_update|gpu_step|rec_fwd_step|rec_bwd_step"
        r"|rtm_bwd_step)\w*?I(?:L\w\d+E)+)E", fn)
    if (name and re.search(r"ILi[48]E", name[1])
            and ("registers" in line or "spill" in line)):
        ptxas.append(f"[ptxas] {name[1]}: {line.strip()}")
res = {"bitwise": True}
n_checks = 0

def timed(case):
    """Whether the case is timed (--only)."""
    return not ONLY or re.search(ONLY, case) is not None

rng = np.random.default_rng(0)

def f32(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

def judge(label, got, want, parts, gate=1e-6):
    """Split kernels within gate of max; exact ones bitwise, but for the
    rec loops (gate=): their image sums in another order than the plain
    loop's, which chip_smoke.py phase 5 holds to 1e-5."""
    global n_checks
    if parts or gate != 1e-6:
        rel = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(got, want))
        ok = rel <= gate
        what = f"max rel {rel:.2e}"
    else:
        ok = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        what = "bitwise" if ok else "DIFFERS"
    res["bitwise"] &= ok
    n_checks += 1
    if not ok or "order 16" in label:
        print(f"[check] {label}: {what}{'' if ok else ' FAILS'}",
              file=sys.stderr)

for order in (4, 8, 12, 16):
    ctx = solver.FDContext.create(53, 70, 9, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=7, nzb=9, fac=0.7)
    v2 = torch.from_numpy(((1500.0 + 500.0 * rng.random(
        (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2)
    st = [f32(2, ctx.nxe, ctx.nze) for _ in range(3)]
    img = f32(2, ctx.nx, ctx.nz)
    row = f32(2, ctx.nx)
    # the sources and the row across the tile edges at x = 64 and z = 64
    sxs, sz, gz = (31, 61), 62, 63
    for parts in (0, 2, 3):
        calls = {}
        for taper in ("all", "top"):
            for inj, kw in (("none", {}),
                            ("gaussian", dict(amp=0.7, sx=sxs, sz=sz)),
                            ("point", dict(amp=0.7, sx=sxs, sz=sz,
                                           source="point")),
                            ("receiver row", dict(inj_row=row, x0=ctx.nzb,
                                                  gz=gz))):
                calls[f"fd_step {taper} {inj}"] = (
                    lambda s, v, taper=taper, kw=kw: stream.fd_step_cuda(
                        ctx, s[0], s[1], v[0], taper, parts=parts,
                        **{k: a.to(s[0].device) if torch.is_tensor(a)
                           else a for k, a in kw.items()}))
        calls["fd_update"] = lambda s, v: (stream.fd_update_cuda(
            ctx, s[0], s[1], v, parts=parts),)
        calls["gpu_step"] = lambda s, v: stream.fd_step_gpu_cuda(
            ctx, s[0], s[1], v, parts=parts)
        calls["gpu_step K5 K6"] = lambda s, v: stream.fd_step_gpu_cuda(
            ctx, s[0], s[1], v, gz, row.to(s[0].device),
            img.clone().to(s[0].device), s[2], parts=parts)
        for label, call in calls.items():
            want = call(st, v2)
            got = call([a.to(dev) for a in st], v2.to(dev))
            judge(f"{label} parts {parts} order {order}", got, want, parts)
        # rec_bwd_step over 9 steps: frames and fields, both receiver
        # offsets, then the image; the plain loops with the same parts
        lap = solver.laplacian_of(ctx, parts, axis="z")
        dobs = f32(2, ctx.nx, ctx.nt)
        swf = f32(2, ctx.nt, ctx.nx, ctx.nz)
        for quirk in (True, False):
            want = solver.backward_recorded(ctx, v2[0], dobs, gz,
                                            x_off_quirk=quirk, lap=lap)
            got = fk.backward_recorded_cuda(ctx, v2[0].to(dev), dobs.to(dev),
                                            gz, x_off_quirk=quirk,
                                            lap_impl=parts)
            judge(f"rec_bwd_step frames x_off_quirk {quirk} parts {parts} "
                  f"order {order}", got, want, parts, 1e-4)
        want = solver.backward_image(ctx, v2[0], swf, dobs, gz, lap=lap)
        got = fk.backward_image_cuda(ctx, v2[0].to(dev), swf.to(dev),
                                     dobs.to(dev), gz, lap_impl=parts)
        judge(f"rec_bwd_step image parts {parts} order {order}", (got,),
              (want,), parts, 1e-5)
        # rec_fwd_step over 9 steps: the point sources across the owned
        # shapes' edges, fields and frames
        wav9 = np.float32(rng.standard_normal(ctx.nt))
        kw = dict(source="point", taper="top", record="wavefield")
        want = solver.forward_modeling(ctx, v2[0], wav9, sxs, sz, gz, **kw,
                                       lap_impl=parts)
        got = fk.forward_modeling_cuda(ctx, v2[0].to(dev), wav9, sxs, sz, gz,
                                       **kw, lap_impl=parts)
        judge(f"rec_fwd_step fields and frames parts {parts} order {order}",
              got, want, parts, 1e-4)
        # rtm_bwd_step over 9 steps from random snapshots, the two seeded
        # steps included: the image (summed in time order, as the plain
        # loop sums it)
        snaps = (f32(2, ctx.nxe, ctx.nze), f32(2, ctx.nxe, ctx.nze))
        want = solver.fd_back(ctx, v2, *snaps, dobs, gz,
                              solver.laplacian_of(ctx, parts))
        got = fk._fd_back(ctx, v2.to(dev), *(a.to(dev) for a in snaps),
                          dobs.to(dev), gz, parts)
        judge(f"rtm_bwd_step image parts {parts} order {order}", (got,),
              (want,), parts, 1e-5)
print("\n".join(ptxas), file=sys.stderr)
print(f"[check] {n_checks} cases, {'all held' if res['bitwise'] else 'FAILED'}",
      file=sys.stderr)

ctx = solver.FDContext.create(6960, 1201, 1001, dx=7.62, dz=7.62, dt=0.0007,
                              order=8, nxb=40, nzb=40, fac=0.75)
v2 = torch.from_numpy(((1500.0 + 2500.0 * rng.random(
    (2, ctx.nxe, ctx.nze))).astype(np.float32)) ** 2).to(dev)

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

st = [torch.from_numpy(rng.standard_normal((2, ctx.nxe, ctx.nze)).astype(
    np.float32)).to(dev) for _ in range(5)]
img = torch.zeros((2, ctx.nx, ctx.nz), device=dev)
row = torch.from_numpy(rng.standard_normal((2, ctx.nx)).astype(
    np.float32)).to(dev)
wav = np.float32(rng.standard_normal(ctx.nt))
sxs = [2740, 2760]
v2m = v2[0]                     # one plane: consts hold to the tensor
cm = stream.prepare(ctx, v2m, sxs, source="gaussian", taper="all")
cr = stream.prepare(ctx, v2, sxs, source="point", taper="top")
for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):

    def fd_step():
        for amp in wav:
            stream.fd_step_cuda(ctx, st[0], st[1], v2m, "all",
                                amp=float(amp), sx=sxs, sz=40, consts=cm,
                                out=st[2:4], parts=parts)

    def gpu_rec():
        for _ in range(ctx.nt):
            stream.fd_step_gpu_cuda(ctx, st[0], st[1], v2, 40, row, img,
                                    st[4], consts=cr, out=st[2:4],
                                    parts=parts)

    def gpu_fwd():
        for _ in range(ctx.nt):
            stream.fd_step_gpu_cuda(ctx, st[0], st[1], v2, consts=cr,
                                    out=st[2:4], parts=parts)

    if timed("fd_step"):
        res["fd_step" + sfx] = median_ms(fd_step)
    if timed("gpu_step"):
        res["gpu_step" + sfx + " receiver"] = median_ms(gpu_rec)
        res["gpu_step" + sfx + " forward"] = median_ms(gpu_fwd)
for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):

    def fd_update():
        for _ in range(ctx.nt - 2):
            stream.fd_update_cuda(ctx, st[0], st[1], v2, consts=cr,
                                  out=st[2], parts=parts)

    if timed("fd_update"):
        res["fd_update" + sfx] = median_ms(fd_update)
del st, img, cm, cr
# rec_fwd_step (frames) and rec_bwd_step in image mode: 3lay (8 shots, nt
# = 1001) and the Pluto rtm_main path of chip_smoke.py phase 30 (2 shots,
# nt = 203), on random gathers and source frames made on the card
gen = torch.Generator(device=dev).manual_seed(0)
for where, ctx_r, ns in (
        ("3lay", solver.FDContext.create(151, 151, 1001, dx=10.0, dz=10.0,
                                         dt=0.001, order=8, nxb=40, nzb=40,
                                         fac=0.01), 8),
        ("Pluto nt 203", solver.FDContext.create(
            6960, 1201, 203, dx=7.62, dz=7.62, dt=0.0007, order=8, nxb=40,
            nzb=40, fac=0.75), 2)):
    v2r = ((1500.0 + 2000.0 * torch.rand((ctx_r.nxe, ctx_r.nze), device=dev,
                                          generator=gen)) ** 2)
    wr = np.float32(rng.standard_normal(ctx_r.nt))
    sxr = ([40 + 20 * i for i in range(8)] if ns == 8 else [2740, 2760])
    for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):
        if timed(f"rec_fwd_step{sfx} {where}"):
            res[f"rec_fwd_step{sfx} {where}"] = median_ms(
                lambda: fk.forward_modeling_cuda(
                    ctx_r, v2r, wr, sxr, 40, 40, "point", "top",
                    "wavefield", lap_impl=parts))
    torch.cuda.empty_cache()
    if not timed(f"rec_bwd_step {where}") and not timed(
            f"rec_bwd_step_mma {where}"):
        continue
    d = torch.randn((ns, ctx_r.nx, ctx_r.nt), device=dev, generator=gen)
    swf = torch.randn((ns, ctx_r.nt, ctx_r.nx, ctx_r.nz), device=dev,
                      generator=gen)
    for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):
        res[f"rec_bwd_step{sfx} {where}"] = median_ms(
            lambda: fk.backward_image_cuda(ctx_r, v2r, swf, d, 40,
                                           lap_impl=parts))
    del d, swf
    torch.cuda.empty_cache()
dobs = torch.from_numpy(rng.standard_normal((2, ctx.nx, ctx.nt)).astype(
    np.float32)).to(dev)
if timed("K=1 modeling mxu"):
    res["K=1 modeling mxu"] = median_ms(lambda: solver.forward_modeling_tiled(
        ctx, v2m, wav, sxs, 40, 40, block_k=1, lap_impl="mxu"))
if timed("K=1 RTM mxu"):
    res["K=1 RTM mxu"] = median_ms(lambda: solver.rtm_shot_snapshot_tiled(
        ctx, v2, wav, dobs, sxs, 40, 40, block_k=1, lap_impl="mxu"))
del dobs, v2, v2m
torch.cuda.empty_cache()
ctx3 = solver.FDContext.create(151, 151, 1001, dx=10.0, dz=10.0, dt=0.001,
                               order=8, nxb=40, nzb=40, fac=0.01)
v23 = ((1500.0 + 2000.0 * torch.rand((ctx3.nxe, ctx3.nze), device=dev,
                                     generator=gen)) ** 2)
d3 = torch.randn((8, ctx3.nx, ctx3.nt), device=dev, generator=gen)
wav3 = np.float32(rng.standard_normal(ctx3.nt))
sx3 = [40 + 20 * i for i in range(8)]
if timed("3lay rtm_main mxu"):
    res["3lay rtm_main mxu"] = median_ms(lambda: fk.rtm_full_cuda(
        ctx3, v23, wav3, d3, sx3, 40, 40, lap_impl="mxu"))
# rtm_bwd_step (the two-snapshot backward) at 3lay from random snapshots,
# exact, mxu and mxu6, and the 3lay RTM mxu call (rtm_snapshot_cuda)
v28 = v23.expand(8, -1, -1).contiguous()
snaps = [torch.randn((8, ctx3.nxe, ctx3.nze), device=dev, generator=gen)
         for _ in range(2)]
for parts, sfx in ((0, ""), (2, "_mma"), (3, "_mma mxu6")):
    if timed(f"rtm_bwd_step{sfx} 3lay"):
        res[f"rtm_bwd_step{sfx} 3lay"] = median_ms(
            lambda: fk._fd_back(ctx3, v28, *snaps, d3, 40, parts))
if timed("3lay RTM mxu"):
    res["3lay RTM mxu"] = median_ms(lambda: fk.rtm_snapshot_cuda(
        ctx3, v28, wav3, d3, sx3, 40, 40, lap_impl="mxu"))
print(json.dumps(res))
'''


RTM_CHILD = r'''
import inspect, json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
stream = __import__(pkg + ".ops.stream", fromlist=["x"])
fk = __import__(pkg + ".ops.fd_kernels", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
lib = build.library()
resident = "per_step" in inspect.signature(fk._fd_forward).parameters
fn = None
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    name = fn and re.search(
        r"\d((?:rtm_fwd_step|rtm_bwd_step|rtm_fwd_cluster|rtm_bwd_cluster)"
        r"I(?:L\w\d+E)+)E", fn)
    if (name and re.search(r"ILi[48]E", name[1])
            and ("registers" in line or "spill" in line)):
        print(f"[ptxas] {name[1]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
if resident:
    res["clusters fwd 3lay"] = lib.pfdc_rtm_fwd_clusters(231, 231, 8)
    res["clusters bwd 3lay"] = lib.pfdc_rtm_bwd_clusters(231, 231, 8)
    print(f"[plan] 3lay order 8: {fk.resident_plan(231, 231, 8)}; clusters "
          f"held at once: forward {res['clusters fwd 3lay']}, backward "
          f"{res['clusters bwd 3lay']}", file=sys.stderr)

def timed(case):
    return not ONLY or re.search(ONLY, case) is not None

gen = torch.Generator(device=dev).manual_seed(0)
rng = np.random.default_rng(0)

SHAPES = {"3lay": (151, 151), "1lay": (201, 101)}

def case(order, nt, model="3lay"):
    nx, nz = SHAPES[model]
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=40, nzb=40, fac=0.01)
    v2 = (1500.0 + 2000.0 * torch.rand((8, ctx.nxe, ctx.nze), device=dev,
                                       generator=gen)) ** 2
    d = torch.randn((8, ctx.nx, nt), device=dev, generator=gen)
    wav = np.float32(rng.standard_normal(nt))
    return ctx, v2, d, wav

sx, sz, gz = [40 + 20 * i for i in range(8)], 40, 40
routes = (False, True) if resident else (None,)

def fwd(ctx, v2, wav, per_step):
    return (fk.fd_forward_cuda(ctx, v2, wav, sx, sz) if per_step is None
            else fk._fd_forward(ctx, v2, wav, sx, sz, 0, per_step=per_step))

def bwd(ctx, v2, snaps, d, per_step):
    return (fk.fd_back_cuda(ctx, v2, *snaps, d, gz) if per_step is None
            else fk._fd_back(ctx, v2, *snaps, d, gz, 0, per_step=per_step))

for order, model in ((4, "3lay"), (8, "3lay"), (10, "3lay"), (16, "3lay"),
                     (8, "1lay")):
    ctx, v2, d, wav = case(order, 20, model)
    want = solver.fd_forward(ctx, v2, wav, sx, sz)
    want_img = solver.fd_back(ctx, v2, *want, d, gz)
    for per_step in routes:
        got = fwd(ctx, v2, wav, per_step)
        img = bwd(ctx, v2, want, d, per_step)
        same = (all(torch.equal(a, b) for a, b in zip(got, want))
                and torch.equal(img, want_img))
        res["bitwise"] &= same
        print(f"[check] {model} order {order} nt 20, "
              f"{'per-step' if per_step else 'resident'} route: "
              f"{'bitwise' if same else 'DIFFERS'}", file=sys.stderr)

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

for model in ("1lay", "3lay"):
    ctx, v2, d, wav = case(8, 1001, model)
    snaps = [torch.randn((8, ctx.nxe, ctx.nze), device=dev, generator=gen)
             for _ in range(2)]
    if resident:
        print(f"[plan] {model} ({ctx.nxe} x {ctx.nze}) order 8: "
              f"{fk.resident_plan(ctx.nxe, ctx.nze, 8)}", file=sys.stderr)
    for per_step in routes:
        sfx = " per-step" if per_step else ""
        if timed(f"rtm_fwd{sfx} {model}"):
            res[f"rtm_fwd{sfx} {model}"] = median_ms(
                lambda: fwd(ctx, v2, wav, per_step))
        if timed(f"rtm_bwd{sfx} {model}"):
            res[f"rtm_bwd{sfx} {model}"] = median_ms(
                lambda: bwd(ctx, v2, snaps, d, per_step))
        if timed(f"{model} RTM{sfx}"):
            res[f"{model} RTM{sfx}"] = median_ms(lambda: bwd(
                ctx, v2, fwd(ctx, v2, wav, per_step), d, per_step))
if resident:
    for ns7 in (7, 1):
        # one wave of the clusters the card holds at once, and one shot
        s7 = [a[:ns7].contiguous() for a in snaps]
        if timed(f"rtm_fwd 3lay {ns7} shots"):
            res[f"rtm_fwd 3lay {ns7} shots"] = median_ms(
                lambda: fk._fd_forward(ctx, v2[:ns7].contiguous(), wav,
                                       sx[:ns7], sz, 0))
        if timed(f"rtm_bwd 3lay {ns7} shots"):
            res[f"rtm_bwd 3lay {ns7} shots"] = median_ms(
                lambda: fk._fd_back(ctx, v2[:ns7].contiguous(), *s7,
                                    d[:ns7].contiguous(), gz, 0))
if timed("3lay RTM tiled"):
    k = stream.tiled_block_k(ctx, ("kstep_gpu_fwd", "kstep_gpu_bwd"))
    res["3lay RTM tiled"] = median_ms(lambda: solver.rtm_shot_snapshot_tiled(
        ctx, v2, wav, d, sx, sz, gz, block_k=k))
print(json.dumps(res))
'''


MOD_CHILD = r'''
import inspect, json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
fk = __import__(pkg + ".ops.fd_kernels", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
lib = build.library()
resident = hasattr(fk, "_forward_modeling")
fn = None
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    name = fn and re.search(
        r"\d((?:mod_step|mod_cluster|rec_fwd_step|rec_fwd_cluster)"
        r"I(?:L\w\d+E)+)E", fn)
    if (name and re.search(r"ILi[48]E", name[1])
            and ("registers" in line or "spill" in line)):
        print(f"[ptxas] {name[1]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
if resident:
    res["clusters mod 3lay"] = lib.pfdc_mod_clusters(231, 231, 8)
    res["clusters rec_fwd 3lay"] = lib.pfdc_rec_fwd_clusters(231, 231, 8)
    print(f"[plan] 3lay order 8: {fk.resident_plan(231, 231, 8)}; clusters "
          f"held at once: mod_cluster {res['clusters mod 3lay']}, "
          f"rec_fwd_cluster {res['clusters rec_fwd 3lay']}", file=sys.stderr)

def timed(case):
    return not ONLY or re.search(ONLY, case) is not None

gen = torch.Generator(device=dev).manual_seed(0)
rng = np.random.default_rng(0)
SHAPES = {"3lay": (151, 151), "1lay": (201, 101)}
KINDS = {"mod": ("gaussian", "all", "trace"),
         "rec_fwd": ("point", "top", "wavefield")}

def case(order, nt, model="3lay"):
    nx, nz = SHAPES[model]
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=40, nzb=40, fac=0.01,
                                  exact_taper=False)
    v2 = (1500.0 + 2000.0 * torch.rand((ctx.nxe, ctx.nze), device=dev,
                                       generator=gen)) ** 2
    wav = np.float32(rng.standard_normal(nt))
    return ctx, v2, wav

sx, sz, gz = [40 + 20 * i for i in range(8)], 40, 40
routes = (False, True) if resident else (None,)

def run(ctx, v2, wav, kind, per_step, ns=8):
    source, taper, record = KINDS[kind]
    if per_step is None:
        return fk.forward_modeling_cuda(ctx, v2, wav, sx[:ns], sz, gz,
                                        source, taper, record)
    return fk._forward_modeling(ctx, v2, wav, sx[:ns], sz, gz, source,
                                taper, record, 0, per_step=per_step)

for order, model in ((4, "3lay"), (8, "3lay"), (10, "3lay"), (16, "3lay"),
                     (8, "1lay")):
    ctx, v2, wav = case(order, 20, model)
    for kind, (source, taper, record) in KINDS.items():
        want = solver.forward_modeling(ctx, v2, wav, sx, sz, gz, source,
                                       taper, record)
        for per_step in routes:
            got = run(ctx, v2, wav, kind, per_step)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            res["bitwise"] &= same
            print(f"[check] {kind} {model} order {order} nt 20, "
                  f"{'per-step' if per_step else 'resident'} route: "
                  f"{'bitwise' if same else 'DIFFERS'}", file=sys.stderr)

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

for model in ("1lay", "3lay"):
    ctx, v2, wav = case(8, 1001, model)
    for kind in KINDS:
        for per_step in routes:
            key = f"{kind}{' per-step' if per_step else ''} {model}"
            if timed(key):
                res[key] = median_ms(lambda: run(ctx, v2, wav, kind,
                                                 per_step))
            torch.cuda.empty_cache()
if resident:
    for kind in KINDS:
        for ns in (7, 1):
            # one wave of the clusters the card holds at once, and one shot
            key = f"{kind} 3lay {ns} shots"
            if timed(key):
                res[key] = median_ms(lambda: run(ctx, v2, wav, kind, False,
                                                 ns))
print(json.dumps(res))
'''


REC_BWD_CHILD = r'''
import inspect, json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
fk = __import__(pkg + ".ops.fd_kernels", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
lib = build.library()
resident = "per_step" in inspect.signature(fk._rec_bwd).parameters
fn = None
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    name = fn and re.search(
        r"\d((?:mod_cluster|rec_fwd_cluster|rec_bwd_step|rec_bwd_cluster)"
        r"I(?:L\w\d+E)+)E", fn)
    if (name and re.search(r"ILi[48]E", name[1])
            and ("registers" in line or "spill" in line)):
        print(f"[ptxas] {name[1]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
if resident:
    res["clusters rec_bwd 3lay"] = lib.pfdc_rec_bwd_clusters(231, 231, 8)
    print(f"[plan] 3lay order 8: {fk.resident_plan(231, 231, 8)}; clusters "
          f"held at once: rec_bwd_cluster {res['clusters rec_bwd 3lay']}",
          file=sys.stderr)

def timed(case):
    return not ONLY or re.search(ONLY, case) is not None

gen = torch.Generator(device=dev).manual_seed(0)
rng = np.random.default_rng(0)
SHAPES = {"3lay": (151, 151), "1lay": (201, 101)}
NXT = np.float32(rng.standard_normal(8))

def case(order, nt, model="3lay"):
    nx, nz = SHAPES[model]
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=40, nzb=40, fac=0.01,
                                  exact_taper=False)
    v2 = (1500.0 + 2000.0 * torch.rand((ctx.nxe, ctx.nze), device=dev,
                                       generator=gen)) ** 2
    d = torch.randn((8, ctx.nx, nt), device=dev, generator=gen)
    swf = torch.randn((8, nt, ctx.nx, ctx.nz), device=dev, generator=gen)
    return ctx, v2, d, swf

sx, sz, gz = [40 + 20 * i for i in range(8)], 40, 41
routes = (False, True) if resident else (None,)

def run(ctx, v2, d, swf, per_step, ns=8, quirk=True):
    # swf None: frame mode
    d, swf = d[:ns].contiguous(), None if swf is None else swf[:ns]
    if per_step is None:
        if swf is None:
            return fk.backward_recorded_cuda(ctx, v2, d, gz, quirk, NXT[:ns])
        return fk.backward_image_cuda(ctx, v2, swf, d, gz, quirk, NXT[:ns])
    return fk._rec_bwd(ctx, v2, d, gz, quirk, NXT[:ns], 0, swf=swf,
                       per_step=per_step)

for order, model in ((4, "3lay"), (8, "3lay"), (10, "3lay"), (16, "3lay"),
                     (8, "1lay")):
    ctx, v2, d, swf = case(order, 20, model)
    for quirk in (True, False):
        pb = solver.backward_recorded(ctx, v2, d, gz, x_off_quirk=quirk,
                                      next_shot_first=NXT)
        pt = torch.zeros_like(swf[:, 0])
        for it in range(ctx.nt):    # the image summed in time order
            pt = pt + swf[:, ctx.nt - 1 - it] * pb[2][:, it]
        for per_step in routes:
            got = (*run(ctx, v2, d, None, per_step, quirk=quirk),
                   run(ctx, v2, d, swf, per_step, quirk=quirk))
            same = all(torch.equal(a, b) for a, b in zip(got, (*pb, pt)))
            res["bitwise"] &= same
            print(f"[check] rec_bwd {model} order {order} nt 20 x_off_quirk "
                  f"{quirk}, {'per-step' if per_step else 'resident'} "
                  f"route: {'bitwise' if same else 'DIFFERS'}",
                  file=sys.stderr)

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

for model in ("1lay", "3lay"):
    ctx, v2, d, swf = case(8, 1001, model)
    for mode, sw in (("image", swf), ("frames", None)):
        for per_step in routes:
            key = f"rec_bwd {mode}{' per-step' if per_step else ''} {model}"
            if timed(key):
                res[key] = median_ms(lambda: run(ctx, v2, d, sw, per_step))
            torch.cuda.empty_cache()
if resident:
    for mode, sw in (("image", swf), ("frames", None)):
        for ns in (7, 1):
            # one wave of the clusters the card holds at once, and one shot
            key = f"rec_bwd {mode} 3lay {ns} shots"
            if timed(key):
                res[key] = median_ms(lambda: run(ctx, v2, d, sw, False, ns))
# the forward passes on the modeling loop beside it (a change to mod_loop
# must leave them as they were) and the whole rtm_main call
wav = np.float32(rng.standard_normal(ctx.nt))
for kind, (source, taper, record) in (("mod", ("gaussian", "all", "trace")),
                                      ("rec_fwd", ("point", "top",
                                                   "wavefield"))):
    key = f"{kind} 3lay"
    if timed(key):
        res[key] = median_ms(lambda: fk.forward_modeling_cuda(
            ctx, v2, wav, sx, sz, gz, source, taper, record))
    torch.cuda.empty_cache()
if timed("rtm_main 3lay"):
    res["rtm_main 3lay"] = median_ms(lambda: fk.rtm_full_cuda(
        ctx, v2, wav, d, sx, sz, gz, next_shot_first=NXT))
print(json.dumps(res))
'''


STEP_MMA_CHILD = r'''
import json, re, statistics, sys
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
solver = __import__(pkg + ".solver", fromlist=["x"])
fk = __import__(pkg + ".ops.fd_kernels", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
build.library()
fn = None
for line in build.build_log().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    name = fn and re.search(
        r"\d((?:mod_step_mma|rtm_fwd_step_mma|rtm_bwd_step_mma)"
        r"I(?:L\w\d+E)+)E", fn)
    if (name and re.search(r"ILi[48]E", name[1])
            and ("registers" in line or "spill" in line)):
        print(f"[ptxas] {name[1]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}

def timed(case):
    return not ONLY or re.search(ONLY, case) is not None

gen = torch.Generator(device=dev).manual_seed(0)
rng = np.random.default_rng(0)
sx, sz, gz = [40 + 20 * i for i in range(8)], 40, 40

def case(order, nt, nx=151, nz=151, fac=0.01):
    ctx = solver.FDContext.create(nx, nz, nt, dx=10.0, dz=10.0, dt=0.001,
                                  order=order, nxb=40, nzb=40, fac=fac)
    v2 = (1500.0 + 2000.0 * torch.rand((8, ctx.nxe, ctx.nze), device=dev,
                                       generator=gen)) ** 2
    d = torch.randn((8, ctx.nx, nt), device=dev, generator=gen)
    snaps = [torch.randn((8, ctx.nxe, ctx.nze), device=dev, generator=gen)
             for _ in range(2)]
    wav = np.float32(rng.standard_normal(nt))
    return ctx, v2, d, snaps, wav

def calls(ctx, v2, d, snaps, wav, parts, per_step=False):
    # the modeling (one velocity plane, the Gaussian source, the all-edge
    # taper, the trace: the 3lay modeling call), rtm_fwd_step (the final
    # pair) and rtm_bwd_step (the image from the snapshots); parts 0: the
    # exact kernels, per-step where asked
    return {
        "mod_step": lambda: fk._forward_modeling(
            ctx, v2[0], wav, sx, sz, gz, "gaussian", "all", "trace", parts,
            per_step=per_step),
        "rtm_fwd_step": lambda: fk._fd_forward(ctx, v2, wav, sx, sz, parts,
                                               per_step=per_step),
        "rtm_bwd_step": lambda: (fk._fd_back(ctx, v2, *snaps, d, gz, parts,
                                             per_step=per_step),)}

# the split kernels within 1e-5 of the plain result's max over 20 steps
# (the tensor cores sum in their own order), at 3lay (231 x 231 extended,
# 8 shots) and on a ragged grid (207 x 203 extended), orders 4, 8, 10, 16
for order, shape in ((4, (151, 151)), (8, (151, 151)), (10, (151, 151)),
                     (16, (151, 151)), (8, (127, 123)), (16, (127, 123))):
    ctx, v2, d, snaps, wav = case(order, 20, *shape, fac=0.7)
    for parts in (2, 3):
        lap = solver.laplacian_of(ctx, parts)
        want = {"mod_step": solver.forward_modeling(
                    ctx, v2[0], wav, sx, sz, gz, lap_impl=parts),
                "rtm_fwd_step": solver.fd_forward(ctx, v2, wav, sx, sz, lap),
                "rtm_bwd_step": (solver.fd_back(ctx, v2, *snaps, d, gz,
                                                lap),)}
        for k, call in calls(ctx, v2, d, snaps, wav, parts).items():
            got = call()
            rel = max(float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(got, want[k]))
            ok = rel <= 1e-5
            res["bitwise"] &= ok
            print(f"[check] {k}_mma parts {parts} order {order} "
                  f"{ctx.nxe} x {ctx.nze}: max rel {rel:.2e}"
                  f"{'' if ok else ' FAILS'}", file=sys.stderr)
    del v2, d, snaps
    torch.cuda.empty_cache()

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

# 3lay, order 8, 8 shots x 1001 steps: each split kernel (mxu, mxu6; the
# mod_step_mma call is the 3lay mxu modeling call), its exact per-step
# twin, and the 3lay mxu RTM call
ctx, v2, d, snaps, wav = case(8, 1001)
for parts, sfx in ((2, "_mma"), (3, "_mma mxu6"), (0, " per-step")):
    for k, call in calls(ctx, v2, d, snaps, wav, parts,
                         per_step=parts == 0).items():
        if timed(k + sfx):
            res[k + sfx] = median_ms(call)
if timed("3lay RTM mxu"):
    res["3lay RTM mxu"] = median_ms(lambda: fk.rtm_snapshot_cuda(
        ctx, v2, wav, d, sx, sz, gz, lap_impl="mxu"))
print(json.dumps(res))
'''

STENCIL_CHILD = r'''
import ctypes, json, os, re, statistics, sys, tempfile
sys.path.insert(0, TREE)
import numpy as np, torch
pkg = "parallel_finite_difference_computation_tpu_torch"
numerics = __import__(pkg + ".numerics", fromlist=["x"])
stencil = __import__(pkg + ".ops.stencil", fromlist=["x"])
padded = __import__(pkg + ".ops.padded", fromlist=["x"])
fk = __import__(pkg + ".ops.fd_kernels", fromlist=["x"])
build = __import__(pkg + ".ops._build", fromlist=["x"])
dev = torch.device("cuda", 0)
# a library of the tree's two stencil sources only, built as _build builds
# the whole one (the other sources take minutes and no part here)
tmp = tempfile.mkdtemp()
srcs = ("laplacian.cu", "lap_padded.cu")
objs = [os.path.join(tmp, n + ".o") for n in srcs]
flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
log = build._run_all([[build._nvcc(), *flags, "-c", "-o", o,
                       str(build.CSRC / n)] for n, o in zip(srcs, objs)])
so = os.path.join(tmp, "libstencil.so")
log += build._run_all([[build._nvcc(), *build.NVCC_FLAGS, "-o", so, *objs]])
lib = ctypes.CDLL(so)
for name, argtypes in build._SIGNATURES.items():
    fn = getattr(lib, name, None)
    if fn is not None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
build.library = lambda: lib
fn = None
for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        fn = m.group(1)
    # the order-4, 8 and 16 instances (H = 2, 4, 8)
    name = fn and re.search(r"\d((?:lap_apply|lap_padded)I(?:L\w\d+E)+)E",
                            fn)
    if (name and re.search(r"ILi[248]E", name[1])
            and ("registers" in line or "spill" in line)):
        print(f"[ptxas] {name[1]}: {line.strip()}", file=sys.stderr)
res = {"bitwise": True}
gen = torch.Generator(device=dev).manual_seed(0)

def timed(case):
    return not ONLY or re.search(ONLY, case) is not None

def field(nx, nz, offset=0):
    # offset floats into its storage: 1 puts it off 16 bytes
    flat = torch.randn(nx * nz + offset, device=dev, generator=gen)
    return flat[offset:].view(nx, nz)

# bitwise the plain version on the card: the stencil grids, a ragged large
# field, small ragged ones, the smallest, and fields off 16 bytes
shapes = [((415, 295), 0), ((8192, 8192), 0), ((4099, 4097), 0),
          ((45, 139), 0), ((300, 257), 0), ((415, 295), 1),
          ((4099, 4097), 1), ((8192, 8192), 3)]
n_checks = 0
for order in range(2, 18, 2):
    cx, cz = numerics.scaled_coefficients(order, 10.0, 12.5)
    for (nx, nz), offset in shapes + [((order + 1, order + 1), 0)]:
        f = field(nx, nz, offset)
        got = fk.laplacian_cuda(f, cx, cz, order)
        want = stencil.laplacian(f, cx, cz, order)
        ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        res["bitwise"] &= ok
        n_checks += 1
        if not ok:
            print(f"[check] lap_apply order {order} {nx} x {nz} offset "
                  f"{offset}: max abs diff "
                  f"{float((got - want).abs().max()):.3e} FAILS",
                  file=sys.stderr)
        del f, got, want
torch.cuda.empty_cache()
print(f"[check] {n_checks} cases, {'all bitwise' if res['bitwise'] else 'FAILED'}",
      file=sys.stderr)

def per_call(fn, reps=20):
    # ms a call: median of 5 CUDA-event samples of reps calls, warmed up
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)

def kernel_us(fn, key, reps=20):
    # device us a launch of the kernels whose names hold key (profiler)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    t = n = 0
    for e in prof.key_averages():
        if key in e.key:
            t += getattr(e, "device_time_total", 0) or e.cuda_time_total
            n += e.count
    return t / n if n else float("nan")

for (nx, nz), orders in (((8192, 8192), (4, 8, 16)), ((415, 295), (4, 8, 16)),
                         ((4099, 4097), (8,))):
    f = field(nx, nz)
    for order in orders:
        cx, cz = numerics.scaled_coefficients(order, 10.0, 12.5)
        call = lambda: fk.laplacian_cuda(f, cx, cz, order)
        case = f"lap_apply {nx}x{nz} o{order}"
        if timed(case):
            res[case] = per_call(call)
            res[case + " kernel us"] = kernel_us(call, "lap_apply")
        if hasattr(fk, "lap_shape") and order == 8:
            print(f"[shape] {nx} x {nz} order 8: {fk.lap_shape(nx, nz, 8)}",
                  file=sys.stderr)
    if (nx, nz) == (8192, 8192) and timed("lap_padded"):
        # lap_padded per apply of a 16-apply chain at order 8 (the padded
        # layout's kernel, the same bytes)
        cx, cz = numerics.scaled_coefficients(8, 10.0, 12.5)
        pf = padded.to_padded(f, 8)
        bufs = (pf.clone(), torch.empty_like(pf))

        def chain():
            for n in range(16):
                padded.laplacian_padded_cuda(bufs[n % 2], cx, cz, 8, nx, nz,
                                             "vpu", out=bufs[1 - n % 2])

        res["lap_padded 8192x8192 o8"] = per_call(chain, reps=1) / 16
        del pf, bufs
    del f
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


if __name__ == "__main__":
    child = CHILD
    for flag, flag_child in (("--rtm", RTM_CHILD), ("--mod", MOD_CHILD),
                             ("--rec-bwd", REC_BWD_CHILD),
                             ("--step-mma", STEP_MMA_CHILD),
                             ("--stencil", STENCIL_CHILD)):
        if flag in sys.argv:
            sys.argv.remove(flag)
            child = flag_child
    sys.exit(torch_bwd_probe.main(child, VARIANTS, __doc__))
