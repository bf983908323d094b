#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU, and check them.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``. The phases, each printing what it found:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from ``csrc/``, with ``nvcc`` (one per source,
   started together), and each kernel's registers and spill stores;
3. kernel vs plain: the exact modeling's resident kernel ``mod_cluster``
   and the exact two-snapshot RTM's ``rtm_fwd_cluster`` and
   ``rtm_bwd_cluster`` (the 3lay route: one launch a pass, each shot in a
   thread-block cluster) and their per-step ones ``mod_step``,
   ``rtm_fwd_step`` and ``rtm_bwd_step`` (the route forced)
   against their plain torch versions on the same CUDA tensors, at the
   3lay shapes (231 x 231 extended grid, nt=1001, 8 shots, order 8) and in
   short runs (nt=20) at orders 4, 10 and 16; then 2 shots, nt=20, order
   8, on a grid just inside the resident route's limit (256 x 256
   extended: 16 rows a CTA, 512 strips of 4 x 2 cells) and one just past
   it (260 x 260: the per-step kernels), with launch counts; gate: max
   relative error <= 1e-5, the resident kernels bitwise (max abs err 0),
   and the clusters the card holds at once; the per-step kernels' launches
   in the ``kernels`` line are those of the forced route at 3lay, order 8,
   whose time phase 14 gives;
4. main path (mod -> rtm_gpu): ``run_modeling`` then ``run_rtm_gpu`` on the
   3lay config, ns=8, through the kernels: the launch counts (the three
   resident kernels one each),
   ``dir.image``, the image against the plain path on the card (rel RMS
   <= 1e-5), the gathers bitwise the forced per-step route's of phase 3,
   and the whole slice at a small size against the plain path on the CPU;
5. rec kernels vs plain: the frames of ``rec_fwd_cluster`` (resident,
   bitwise) and ``rec_fwd_step`` (forced); ``rec_bwd_cluster`` (resident)
   and ``rec_bwd_step`` (forced) in frame mode (the frames and the final
   pair) and in image mode (against the plain frames' correlation summed
   in time order, as both routes sum it, and against the plain
   ``backward_image``), and ``rtm_full_cuda`` against their plain
   versions at the 3lay shapes (``exact_taper=False``, phase 4's gathers
   as ``dobs``) and in short runs (nt=20, 21) at orders 4 and 10 with nxb
   != nzb (one of them with the receiver row clamped) and
   ``next_shot_first`` != 0; both passes' two routes also on phase 3's
   256 x 256 and 260 x 260 grids, the forward's at order 16 (nt=20); the
   clusters the card holds at once; gate: max relative error <= 1e-5, the
   resident kernels bitwise the plain versions summed in their order and
   the forced per-step route;
6. rtm_main path: ``run_rtm_cpu`` on the 3lay config, ns=8, after phase
   4's ``run_modeling``: the launch counts (``rec_fwd_cluster`` and
   ``rec_bwd_cluster`` once each), ``dir.image`` and ``dir.img``
   against the returned arrays, the image against the plain path on the
   card (rel RMS <= 1e-5), and the small config card vs plain on the CPU;
7. stencil path: ``run_stencil`` through a file at the reference stencil's
   415 x 295 grid and at 8192 x 8192, orders 4, 8 and 10, and at a ragged
   4099 x 4097 (rows off 16 bytes, tails cutting ``lap_apply``'s band and
   run), orders 2 and 16: one launch each, and each result bitwise the
   plain version on the card;
8. large-grid kernels vs plain: ``kstep_mod``, ``kstep_gpu_fwd``,
   ``gpu_step`` and ``kstep_gpu_bwd`` against their plain versions on the
   same CUDA tensors, pass by pass and through the tiled loops, in short
   runs (nt=21, K = 2 and 4, orders 4, 8 and 10) on a 67 x 88 grid that is
   no multiple of the 32 x 64 tiles, with nxb != nzb and the sources and
   the receiver row across tile edges; then at the full Pluto grid (7040 x
   1281 extended), 2 shots, nt=203, K=4; gate: max relative error <= 1e-5,
   and the exact strip kernels bitwise: ``kstep_mod`` and ``kstep_gpu_fwd``
   (the one-field body of ``csrc/fwd_strip.cuh``) and ``kstep_gpu_bwd``
   (``csrc/bwd_strip.cuh``);
9. tiled vs per-step at the Pluto grid: ``forward_modeling_tiled`` against
   ``forward_modeling_cuda`` and ``rtm_shot_snapshot_tiled`` against
   ``rtm_snapshot_cuda``, 2 shots, nt=203 (<= 1e-5; 0 expected);
10. the Pluto path: ``run_modeling`` then ``run_rtm_gpu`` on the Pluto
   config at full width and full nt=12860, 2 of its 30 shots (the only
   cut, for time), through ``backend="auto"`` (which resolves to the tiled
   tier) and through ``"pallas"``: launch counts, ``dir.image``, the two
   tiers' gathers and images (rel RMS <= 1e-5), wall s/shot of each;
11. domain kernels vs plain: ``block_mod`` (both source modes),
   ``block_fwd`` and ``block_bwd`` against their plain versions on the same
   CUDA tensors, launch by launch on random states of every slab (seeded,
   full and tail blocks), at orders 4, 8 and 10, K = 2, 3 and 8, x = 2 and
   4, on a 134 x 88 grid (nxe no multiple of 4) with the sources at the
   first slab edge; and the two makers on a (2, x) mesh of cuda:0 and on
   one alternating cuda:0 and the CPU against the same makers on a CPU
   mesh (edge slabs' zero halos, the exchange within and between
   devices); gate: max relative error <= 1e-5, and the three kernels
   bitwise (they run the strip bodies of ``csrc/fwd_strip.cuh`` and
   ``csrc/bwd_strip.cuh``, a block of more than 4 steps in two passes);
12. 3lay mesh path: ``run_modeling`` then ``run_rtm_gpu`` on the 3lay
   config over meshes (2, 1), (2, 2) and (1, 4), every position on cuda:0,
   against the no-mesh run of phase 4 (rel RMS <= 1e-5), with the launch
   counts (the shot-only mesh: each resident kernel once a shot group);
13. the Pluto domain path: ``run_modeling`` then ``run_rtm_gpu`` at the
   full Pluto grid, nt=4500 (cut from 12860 for time), 2 shots, over a
   (1, 4) mesh of cuda:0 (K=8): launch counts (two passes a block of each
   block kernel), ``dir.image``, gathers and images against the per-step
   tier at the same nt (rel RMS <= 1e-5) and their SHA-256 digests (equal
   digests across runs are bitwise equal results), wall s/shot;
14. times: each kernel's wrapper call and its plain version, timed with
   CUDA events, median of 3 after a warm-up, taken in turns; for the
   stencil also ``torch.nn.functional.conv2d`` with the same taps (the
   library yardstick, not used by the port), and ``lap_apply`` at orders 4
   and 16 at 8192 x 8192 beside their bounds; for the K-step kernels, at
   3lay both routes of the exact modeling, RTM and rtm_main kernels and
   calls in turns with the plain versions; at the Pluto grid (2 shots,
   nt=1001), the K-step
   kernels' passes, their plain passes and
   the per-step kernel call for the same function (here and in phases 18,
   21 and 27 the plain versions at the Pluto grid, seconds a call, are
   timed once, without a warm-up of their own); the same for the block
   kernels over the four slabs of a (1, 4) mesh, after holding each
   against its plain version there (K = 8 and the tails 4 and 1, seeded;
   gate 1e-5, every kernel bitwise), and the domain tier's whole
   modeling and RTM calls against the per-step calls;
15. profile: one ``torch.profiler`` trace of each 3lay 8-shot call (the
   modeling, RTM and rtm_main calls on both routes), of the
   8192 x 8192 stencil, and of the Pluto modeling and RTM calls (nt=1001)
   of each tier: the device time of each kernel, its launch count, and the
   share of the event-timed call that the card spent in kernels; for the
   domain tier also the share of the copy kernels (the halo exchange);
16. (x, z) kernels vs plain: ``block2_mod`` (both source modes),
   ``block2_fwd`` and ``block2_bwd`` against their plain versions on the
   same CUDA tensors, launch by launch on random states of every tile
   (seeded, full and tail blocks), at orders 4, 8 and 10, K = 2, 3 and 8,
   over (1, 2, 2) and (1, 1, 4) meshes, on the 134 x 88 grid with the
   sources across the x cut, the Gaussian band across a z cut and the
   receiver row in a later z part; and the two makers on (2, x, z) meshes
   of cuda:0 and alternating cuda:0 and the CPU against a CPU mesh; gate:
   max relative error <= 1e-5, and the three kernels bitwise;
17. 3lay (x, z) mesh path: ``run_modeling`` then ``run_rtm_gpu`` on the
   3lay config over (2, 2, 2), (1, 2, 2) and (1, 1, 4) meshes of cuda:0,
   against the no-mesh run of phase 4 (rel RMS <= 1e-5);
18. the Pluto (x, z) path: ``run_modeling`` then ``run_rtm_gpu`` at the
   full Pluto grid, nt=4500, 2 shots, over a (1, 2, 2) mesh of cuda:0
   (K=8): launch counts, ``dir.image``, gathers and images against phase
   13's per-step run (rel RMS <= 1e-5) and their digests beside the x
   tier's, wall s/shot; then at nt=1001 the three kernels held bitwise
   against their plain versions at the Pluto tile shapes (K = 8 and the
   tails 4 and 1), each kernel's launches, its plain
   version's and the per-step kernel call for the same function in turns,
   the two makers' whole calls against the per-step calls, and one
   profiler trace of each: the copy kernels' (the two-stage exchange)
   and the idle share of the call;
19. stream-step kernels vs plain: ``fd_step`` (both tapers; no injection,
   the Gaussian window, the point source, the receiver row at nxb, at nzb
   and at nxe, where it clamps) and ``fd_update`` against their plain
   versions on the same CUDA tensors, then the four tiled loops at
   K = 1 against the whole-grid plain loops and ``forward_modeling_tiled``'s
   other modes at K = 2, in short runs (nt=21) on phase 8's 67 x 88 grid
   (nxb 7, nzb 9) at orders 4, 8, 10, 12 and 16; then three steps at the
   full Pluto grid, 2 shots; gate: max relative error <= 1e-5;
20. the K = 1 tier at the Pluto grid (2 shots, nt=203, phase 9's shapes):
   the launch counts of the three K = 1 loops, their gathers bitwise the
   per-step tier's, ``rtm_shot_snapshot_tiled`` against
   ``rtm_snapshot_cuda``, ``rtm_shot_full_tiled`` against
   ``rtm_full_cuda`` (and against the plain ``rtm_shot_full`` on one shot),
   and ``run_rtm_cpu(backend="tiled")`` against ``"pallas"`` on the 3lay
   config and at the Pluto grid; gate: 1e-5 rel RMS;
21. times and profile of the K = 1 tier at the Pluto grid, 2 shots,
   nt=1001: ``fd_step`` and ``fd_update`` over 1001 launches, their plain
   versions and the per-step kernel for a step of the same kind
   (``mod_step``, ``rtm_fwd_step``), with their bounds; the K = 1 modeling
   and RTM calls against the K = 4 and per-step calls; one profiler trace
   of each K = 1 call (kernel time, the other ops' launches, idle share).
22. padded stencil vs plain: ``lap_padded`` bitwise its plain version and
   n = 1, 2, 16 chained applies of ``stencil.laplacian`` (two buffers,
   ``out=``), ``lap_padded_mma`` (mxu, mxu6) within 1e-6 of max of its
   plain version and 2e-5 / 2e-7 of the exact taps, the pads zero, at
   415 x 295 and 8192 x 8192, orders 4, 8, 10 and 16; then the padded chain
   path (16 applies at 8192 x 8192, order 8, each impl) and its launches;
23. the split-bf16 tiers (``lap_impl`` mxu, mxu6): ``mod_step_mma``,
   ``rtm_fwd_step_mma`` and ``rtm_bwd_step_mma`` against their plain
   versions in short runs (nt=20, orders 4, 8, 10, 16, nxb != nzb) and at
   3lay (8 shots, nt=1001); gate: max relative error <= 1e-5, but 1e-4 for
   3lay's final fields p, pp, which move by ~1e-5 when only the order of
   the plain version's own sums changes (scripts/torch_sum_order_floor.py);
   then the main path ``run_modeling`` + ``run_rtm_gpu`` on 3lay with
   ``lap_impl="auto"`` (resolves to mxu) and ``"mxu6"``: the launch counts
   (the *_mma kernels nt times, the exact ones never), the image against
   the plain path on the card (rel RMS <= 1e-5) and against phase 4's
   exact image (<= 1e-4 for mxu, <= 1e-5 for mxu6);
24. times and traces of the tensor-core tiers: the 3lay modeling and RTM
   calls in exact, mxu and mxu6; each *_mma kernel's call (mxu) against its
   plain version, the exact per-step call of the same function and the
   exact call on its resident route, in the same turns; the padded chain per apply (vpu, mxu, mxu6) against ``lap_apply`` and fp32
   ``conv2d``; one profiler trace of each mxu call and chain. The bounds
   count the x taps' multiply-adds of each cross term at the bf16 tensor
   rate and the rest at the float32 rate.
25. the split-bf16 lowering of the large-grid tier, whose three K-step
   kernels run strip bodies with the z product (``kstep_mod_mma`` and
   ``kstep_gpu_fwd_mma`` the forward one, ``kstep_gpu_bwd_mma`` the
   backward one): ``kstep_mod_mma`` (Gaussian source with the all-edge
   taper, point source with the top strip), ``kstep_gpu_fwd_mma``,
   ``gpu_step_mma`` and ``kstep_gpu_bwd_mma`` against their plain passes
   with the z taps in the same bf16 parts, on the same CUDA tensors, pass
   by pass and (above K = 1) through the tiled RTM driver: phase 8's 67 x
   88 grid (nt=21) at orders 4, 8, 10 and 16, K = 1, 2, 4 and 8 (order 16
   at K = 8, whose tiles outgrow a block, skipped), parts 2 and 3, then
   the Pluto grid (2 shots, nt=203, K = 4);
   gate: gathers and images <= 1e-5 max rel, the fields <= 1e-4;
26. the Pluto path through the split tier: ``run_modeling`` then
   ``run_rtm_gpu`` at the full Pluto grid, 2 shots, ``backend="auto"``
   (tiled, K = 4) with ``lap_impl="auto"`` at nt=1001 (resolves to mxu) and
   nt=4500 = ``MXU6_NT_MAX`` (mxu6), cut from 12860: the launch counts (the
   split kernels nt/K passes each, the exact ones never), ``dir.image``,
   wall s/shot; the mxu6 image against the exact tiled run at the same nt
   (rel RMS <= 1e-5, the JAX envelope's gate); the mxu gathers and image
   against the plain split path on the card (rel RMS <= 1e-5), and their
   drift from the exact tiled run, reported: at Pluto's sampling the
   lowering itself drifts past the 1e-4 the JAX envelope expects
   (``scripts/torch_split_drift.py`` shows it through the plain path);
27. times and traces of the split tier at the Pluto grid (2 shots,
   nt=1001, K = 4): each split kernel's calls (mxu and mxu6), its plain
   passes (mxu) and the exact kernel of the same function in turns, with
   ``kstep_bounds(parts=)`` (the z taps' cross terms at the bf16 tensor
   rate); the whole tiled modeling and RTM calls in exact, mxu and mxu6;
   one profiler trace of each split call;
28. the split-bf16 lowering of the K = 1 tier and of rtm_main's recording
   kernels: ``fd_step_mma`` (both tapers, every injection),
   ``fd_update_mma`` and ``gpu_step_mma`` (without and with the trace row
   and the image) one step from random states (gate 1e-6 of max an
   apply), ``rec_fwd_step_mma`` and ``rec_bwd_step_mma`` (frame mode at
   both receiver offsets, image mode) over nt steps (images 1e-5, frames
   and fields 1e-4), against their plain versions with the z taps in the
   same bf16 parts: phase 8's 67 x 88 grid (nt=21) at orders 4-16, parts 2
   and 3; ``fd_update_mma`` and the rec loops on 164 x 78 (two 128 x 64
   shapes along each axis, with tails) at orders 4-16, the rec loops on
   8 shots of 360 x 360 (where ``rec_bwd_step_mma``'s launcher takes 64 x
   64) at orders 8 and 16; then the Pluto grid (2 shots; the rec loops at
   nt=5) and 3lay (8 shots, nt=1001);
29. the Pluto K = 1 path through them: ``forward_modeling_tiled`` and
   ``rtm_shot_snapshot_tiled`` at block_k=1, 2 shots, nt=1001, with
   ``lap_impl="auto"`` (= mxu) and ``"mxu6"``: launch counts (only the
   split kernels), gathers and images against the K = 4 split tier at the
   same lap_impl (rel RMS <= 1e-5), mxu6 against the exact K = 1 run
   (<= 1e-5), mxu's drift reported;
30. rtm_main through them at the Pluto grid, 2 shots, nt=203 (cut for
   memory: swf is 13.6 GB): ``rtm_shot_full_tiled`` at K = 1 and 4 in
   exact, mxu and mxu6 (K = 1 against K = 4, mxu6 against exact: rel RMS
   <= 1e-5), ``run_rtm_cpu(backend="tiled")`` in a subprocess with
   ``PFDC_LAP_IMPL=mxu6`` (read at import) against the in-process call;
   at 3lay the split tier against its plain path, and the whole-grid tier
   under ``PFDC_LAP_IMPL=auto``, which keeps the exact taps (the JAX lax
   ``rtm_shot_full`` has no other);
31. times and traces: ``fd_step_mma``/``fd_update_mma`` over 1001 launches
   and ``gpu_step_mma`` over the RTM's 1001 receiver launches at the Pluto
   grid (the forward launches' bound beside), and
   ``rec_fwd_step_mma``/``rec_bwd_step_mma`` over
   3lay's 8 shots x 1001 steps, each against mxu6, its plain version and
   its exact twin, with ``stream_bounds(parts=)`` and
   ``step_bounds(parts=)``; the Pluto K = 1 modeling and RTM calls and the
   3lay rtm_main call in exact, mxu and mxu6; one profiler trace of each
   split call;
32. the split-bf16 lowering of the domain tiers' block kernels:
   ``block_*_mma`` and ``block2_*_mma`` against their plain block
   functions with the x taps in the same bf16 parts, on the same CUDA
   tensors, launch by launch on random states of every slab or tile
   (seeded, full and tail blocks): phases 11 and 16's 134 x 88 grid over
   (1, 2), (1, 4), (1, 2, 2) and (1, 1, 4) meshes, orders 4, 8 and 10,
   K = 2, 3 and 8, parts 2 and 3, and the split makers on meshes of
   cuda:0 against CPU meshes; every split twin, each of which takes two
   passes above 4 steps, alone at K = 5, 7 and 8 at orders 8, 12, 14 and
   16 (the modeling twin in both source modes, with its traces); then the
   Pluto slab and tile shapes (2 shots, K = 8 and the tails 4 and 1);
   gates: traces and images <= 1e-5 max rel, fields <= 1e-4;
33. the 3lay mesh paths under ``lap_impl="auto"`` (= mxu) and ``"mxu6"``:
   (1, 4) and (1, 2, 2) meshes of cuda:0 against the no-mesh run at the
   same lap_impl (the per-step ``*_step_mma`` tier), rel RMS <= 1e-5, and
   only the tier's ``_mma`` block kernels launched;
34. the Pluto domain paths through them: full grid, 2 shots, nt=1001,
   ``run_modeling`` + ``run_rtm_gpu`` over (1, 4) and (1, 2, 2) meshes of
   cuda:0 under auto (= mxu), mxu6 and exact: launch counts, gathers and
   images against the per-step tier at the same lap_impl (rel RMS <=
   1e-5), mxu6 against the exact domain run (<= 1e-5), mxu's drift from
   it reported, wall s/shot;
35. times and traces at the Pluto shapes (nt=1001, K=8): each ``_mma``
   block kernel's launches over the four slabs or tiles (mxu and mxu6),
   its plain version and its exact twin (once each) in turns,
   against ``block_bounds(parts=)``; one profiler trace of each split
   maker call (mxu) with the copy and idle shares;
36. order 12: ``run_modeling`` and ``run_rtm_gpu`` on the 3lay config
   through ``backend="tiled"`` and over a (1, 2) and a (1, 2, 2) mesh of
   cuda:0, each at the K its pipeline chooses to fit a block's shared
   memory, against the per-step tier (rel RMS <= 1e-5); and
   ``run_modeling`` under ``lap_impl="mxu"`` over the same meshes, at the
   JAX package's K = 8 that its pipeline now chooses, with the split
   modeling twin's launch counts, against the per-step split tier (rel RMS
   <= 1e-5).

Every phase prints its seconds, and the run its total. It prints one JSON line of per-kernel results (with each kernel's bound,
worked out from this run's shapes), the nvidia-smi line, and, as the last
line, ``{"ok": true, "device": {...}}``. Any failed phase raises and the
exit code is not 0. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GATE = 1e-5
PKG = "parallel_finite_difference_computation_tpu_torch"
KERNELS = {
    # name: (source, TPU kernel it replaces)
    "mod_step": (f"{PKG}/csrc/mod_step.cu",
                 "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:423"),
    "rtm_fwd_step": (f"{PKG}/csrc/rtm_fwd_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:534"),
    "rtm_bwd_step": (f"{PKG}/csrc/rtm_bwd_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:534"),
    "rtm_fwd_cluster": (f"{PKG}/csrc/rtm_fwd_step.cu",
                        "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:702"),
    "rtm_bwd_cluster": (f"{PKG}/csrc/rtm_bwd_step.cu",
                        "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:729"),
    "mod_cluster": (f"{PKG}/csrc/mod_step.cu",
                    "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:423"),
    "rec_fwd_cluster": (f"{PKG}/csrc/rec_step.cu",
                        "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1002"),
    "rec_bwd_cluster": (f"{PKG}/csrc/rec_step.cu",
                        "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1002"),
    "rec_fwd_step": (f"{PKG}/csrc/rec_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1002"),
    "rec_bwd_step": (f"{PKG}/csrc/rec_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1002"),
    "lap_apply": (f"{PKG}/csrc/laplacian.cu",
                  "parallel_finite_difference_computation_tpu/ops/pallas_stencil.py:60"),
    "kstep_mod": (f"{PKG}/csrc/kstep_mod.cu",
                  "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:574"),
    "kstep_gpu_fwd": (f"{PKG}/csrc/kstep_gpu_fwd.cu",
                      "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:740"),
    "kstep_gpu_bwd": (f"{PKG}/csrc/kstep_gpu_bwd.cu",
                      "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:857"),
    "gpu_step": (f"{PKG}/csrc/gpu_step.cu",
                 "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:207"),
    "block_mod": (f"{PKG}/csrc/domain_block.cu",
                  "parallel_finite_difference_computation_tpu/parallel/domain_pallas.py:189"),
    "block_fwd": (f"{PKG}/csrc/domain_block.cu",
                  "parallel_finite_difference_computation_tpu/parallel/domain_pallas.py:115"),
    "block_bwd": (f"{PKG}/csrc/domain_block.cu",
                  "parallel_finite_difference_computation_tpu/parallel/domain_pallas.py:136"),
    "block2_mod": (f"{PKG}/csrc/domain2d_block.cu",
                   "parallel_finite_difference_computation_tpu/parallel/domain2d_pallas.py:178"),
    "block2_fwd": (f"{PKG}/csrc/domain2d_block.cu",
                   "parallel_finite_difference_computation_tpu/parallel/domain2d_pallas.py:99"),
    "block2_bwd": (f"{PKG}/csrc/domain2d_block.cu",
                   "parallel_finite_difference_computation_tpu/parallel/domain2d_pallas.py:124"),
    "fd_step": (f"{PKG}/csrc/stream_step.cu",
                "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:76"),
    "fd_update": (f"{PKG}/csrc/stream_step.cu",
                  "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:171"),
    "lap_padded": (f"{PKG}/csrc/lap_padded.cu",
                   "parallel_finite_difference_computation_tpu/ops/pallas_stencil.py:546"),
    "lap_padded_mma": (f"{PKG}/csrc/lap_padded.cu",
                       "parallel_finite_difference_computation_tpu/ops/pallas_stencil.py:429"),
    "mod_step_mma": (f"{PKG}/csrc/step_mma.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:260"),
    "rtm_fwd_step_mma": (f"{PKG}/csrc/step_mma.cu",
                         "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:260"),
    "rtm_bwd_step_mma": (f"{PKG}/csrc/step_mma.cu",
                         "parallel_finite_difference_computation_tpu/ops/pallas_fd.py:260"),
    "kstep_mod_mma": (f"{PKG}/csrc/kstep_mod.cu",
                      "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:600"),
    "kstep_gpu_fwd_mma": (f"{PKG}/csrc/kstep_gpu_fwd.cu",
                          "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:753"),
    "kstep_gpu_bwd_mma": (f"{PKG}/csrc/kstep_gpu_bwd.cu",
                          "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:875"),
    "gpu_step_mma": (f"{PKG}/csrc/gpu_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:220"),
    "fd_step_mma": (f"{PKG}/csrc/stream_step.cu",
                    "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:79"),
    "fd_update_mma": (f"{PKG}/csrc/stream_step.cu",
                      "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:177"),
    "rec_fwd_step_mma": (f"{PKG}/csrc/rec_step.cu",
                         "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1026"),
    "rec_bwd_step_mma": (f"{PKG}/csrc/rec_step.cu",
                         "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1026"),
    "block_mod_mma": (f"{PKG}/csrc/domain_block.cu",
                      "parallel_finite_difference_computation_tpu/parallel/domain_pallas.py:189"),
    "block_fwd_mma": (f"{PKG}/csrc/domain_block.cu",
                      "parallel_finite_difference_computation_tpu/parallel/domain_pallas.py:115"),
    "block_bwd_mma": (f"{PKG}/csrc/domain_block.cu",
                      "parallel_finite_difference_computation_tpu/parallel/domain_pallas.py:136"),
    "block2_mod_mma": (f"{PKG}/csrc/domain2d_block.cu",
                       "parallel_finite_difference_computation_tpu/parallel/domain2d_pallas.py:178"),
    "block2_fwd_mma": (f"{PKG}/csrc/domain2d_block.cu",
                       "parallel_finite_difference_computation_tpu/parallel/domain2d_pallas.py:99"),
    "block2_bwd_mma": (f"{PKG}/csrc/domain2d_block.cu",
                       "parallel_finite_difference_computation_tpu/parallel/domain2d_pallas.py:124"),
}
# The exact strip kernels' templates, as the build log and the profiler
# name them: the wrapper (a key of KERNELS) and the kernel-table row
# (PERF.md, section 6) each serves.
STRIP_TEMPLATES = {"kstep_mod_strip": ("kstep_mod", "11"),
                   "kstep_gpu_fwd_strip": ("kstep_gpu_fwd", "12"),
                   "kstep_gpu_bwd_strip": ("kstep_gpu_bwd", "13"),
                   "block_mod": ("block_mod", "15a/16a"),
                   "block_fwd": ("block_fwd", "15b/16b"),
                   "block_bwd": ("block_bwd", "15c/16c")}
# The large-grid tier's exact strip kernels, which phase 8 holds bit for
# bit to their plain versions.
TIER_BITWISE = ("kstep_mod", "kstep_gpu_fwd", "kstep_gpu_bwd")
# The reference's full-resolution Pluto config
# (dpct_gpu_rtm_domain_division/build/pluto/input.orig, as restated in
# scripts/run_pluto_survey.py:57-78) with its synthetic four-layer model
# (its velocity blob is absent upstream); 2 of its 30 shots.
PLUTO = dict(nz=1201, nx=6960, nt=12860, dz=7.62, dx=7.62, dt=0.0007,
             fpeak=6.0, ns=2, sz=0, fsx=2700, ds=20, gz=0, nxb=40, nzb=40,
             fac=0.75, order=8)
PLUTO_VELOCITIES = (1500.0, 2200.0, 3000.0, 4000.0)
# The card's published peaks (H100 SXM data sheet): HBM bytes/s, float32
# flop/s outside the tensor cores and dense bf16 flop/s on them. A kernel's
# bound is the largest of its bytes (inputs read once, outputs written once)
# and its flop of each kind over these. The data sheet's 67 TFLOP/s counts
# a fused multiply-add as two flop; every kernel here is built with
# -fmad=false (the reference's rounding), so each multiply and each add
# issues on its own: 33.5e12 of them a second on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12 / 2
BF16_TENSOR_FLOP_PER_S = 989e12


def lap_flops(h: int) -> int:
    """Flop of one order-2h Laplacian cell: per axis h pair adds, h
    multiplies, h-1 accumulating adds and the centre's multiply and add,
    then accz + accx."""
    return 6 * h + 3


def mma_lap_flops(h: int, parts: int):
    """(float32 flop, bf16 tensor flop) of one order-2h Laplacian cell with
    the taps of one axis as the parts-part split-bf16 banded product: the
    other axis exact (3h + 1), the split of the field (a rounding and a
    subtraction a part), the sum of the cross terms and yx + accz on the
    CUDA cores; a multiply-add for each of the 2h + 1 taps of each cross
    term (3 for parts = 2, 6 for 3) on the tensor cores."""
    terms = 3 if parts == 2 else 6
    return 3 * h + 1 + 2 * parts + terms, terms * 2 * (2 * h + 1)


def bound(nbytes: float, flops: float, tensor_flops: float = 0.0):
    """(bound_ms, bound_by) of a call that moves nbytes and does flops on
    the CUDA cores and tensor_flops on the tensor cores."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    t = max(tb, flops / F32_FLOP_PER_S * 1e3,
            tensor_flops / BF16_TENSOR_FLOP_PER_S * 1e3)
    return (t, "bytes") if t == tb else (t, "operations")


def step_bounds(ctx, ns: int, parts: int = 0):
    """Bounds of one wrapper call (ns shots x nt steps) of each step kernel
    as this script times it, from the shapes: per cell-step, the Laplacian
    over its interior and the update over the whole plane; bytes of the
    call's inputs and outputs, float32. The modeling and rtm_main calls
    share one velocity plane; the two-snapshot RTM has one per shot. A
    field is tapered once per cell, as the functions define it: the kernels'
    taper of each Laplacian tap on read is not counted. With parts > 0 the
    Laplacian's taps of one axis (x for the mod and rtm steps, z for the
    rec steps: the same count) are the split-bf16 banded product
    (:func:`mma_lap_flops`): the bounds of the *_mma kernels."""
    h = ctx.order // 2
    lf, tf = (lap_flops(h), 0) if not parts else mma_lap_flops(h, parts)
    plane = ctx.nxe * ctx.nze
    lapc = (ctx.nxe - 2 * h) * (ctx.nze - 2 * h)
    inter = ctx.nx * ctx.nz
    steps = ns * ctx.nt
    f4 = 4
    return {
        # mod_step: u=(2p-pp*m)+v*lap (5), taper (1), trace m*p
        "mod_step": bound(
            f4 * (plane + plane + 49 + ctx.nt + 2 * ns * plane
                  + ns * ctx.nt * ctx.nx),
            steps * (lapc * lf + 6 * plane + ctx.nx + 49),
            steps * lapc * tf),
        # rtm_fwd_step: a=m*p, b=m*(m*pp), u=2a-b+v*lap(a)
        "rtm_fwd_step": bound(
            f4 * (ns * plane + plane + ctx.nt + 2 * ns * plane),
            steps * (lapc * lf + 7 * plane + 1), steps * lapc * tf),
        # rtm_bwd_step: untapered source step (4), tapered receiver step
        # (7), trace add, imaging multiply-add over the interior
        "rtm_bwd_step": bound(
            f4 * (ns * plane + plane + 2 * ns * plane
                  + ns * ctx.nx * ctx.nt + ns * inter),
            steps * (lapc * 2 * lf + 11 * plane + ctx.nx + 2 * inter),
            steps * lapc * 2 * tf),
        # rec_fwd_step: the mod_step update, a point source, frame m*p
        "rec_fwd_step": bound(
            f4 * (plane + plane + ctx.nt + 2 * ns * plane
                  + ns * ctx.nt * inter),
            steps * (lapc * lf + 6 * plane + inter + 1), steps * lapc * tf),
        # rec_bwd_step, image mode: the update, the trace add, and
        # img += swf * (m*p) over the interior; reads swf once
        "rec_bwd_step": bound(
            f4 * (plane + plane + ns * ctx.nx * ctx.nt
                  + ns * ctx.nt * inter + ns * inter),
            steps * (lapc * lf + 6 * plane + ctx.nx + 3 * inter),
            steps * lapc * tf),
    }


def stream_bounds(ctx, ns: int, parts: int = 0):
    """Bounds of the K = 1 tier's launches as this script times them, nt
    launches over ns shots: fd_step with the Gaussian window and the
    all-edge taper (one velocity plane), fd_update (one velocity plane a
    shot), gpu_step's receiver launches (the trace row and the image) and
    its forward ones (neither), each input read once and each output
    written once a launch. With parts > 0 the z taps are the split-bf16
    banded product (:func:`mma_lap_flops`): the bounds of fd_step_mma,
    fd_update_mma and gpu_step_mma."""
    h = ctx.order // 2
    lf, tf = (lap_flops(h), 0) if not parts else mma_lap_flops(h, parts)
    plane = ctx.nxe * ctx.nze
    lapc = (ctx.nxe - 2 * h) * (ctx.nze - 2 * h)
    inter = ctx.nx * ctx.nz
    ramps = ctx.nxe + 2 * ctx.nze
    steps = ns * ctx.nt
    return {
        # fd_step: reads p, pp, one v2*dt2 plane, the ramps and the patch;
        # writes p*m and u*m; the update (4), two tapers, the Gaussian add
        "fd_step": bound(4 * ctx.nt * (4 * ns * plane + plane + ramps + 50),
                         steps * (lapc * lf + 6 * plane + 2 * 49),
                         steps * lapc * tf),
        # fd_update: reads p, pp and one v2*dt2 plane a shot; writes one
        # field a shot; the update (4)
        "fd_update": bound(4 * ctx.nt * 4 * ns * plane,
                           steps * (lapc * lf + 4 * plane),
                           steps * lapc * tf),
        # gpu_step, the RTM's receiver launches: reads y, x, one v2*dt2
        # plane a shot, the ramps and the trace row, and over the interior
        # the source field and the image; writes t, the new field and the
        # image (kstep_bounds' launch, nt times)
        "gpu_step": bound(
            4 * ctx.nt * (5 * ns * plane + ramps + ns * ctx.nx
                          + 3 * ns * inter),
            steps * (lapc * lf + 7 * plane + ctx.nx + 2 * inter),
            steps * lapc * tf),
        # gpu_step, the RTM's forward launches: no trace row, no image
        "gpu_step forward": bound(4 * ctx.nt * (5 * ns * plane + ramps),
                                  steps * (lapc * lf + 7 * plane),
                                  steps * lapc * tf)}


def kstep_bounds(ctx, ns: int, k: int, parts: int = 0):
    """Bounds of the large-grid tier's calls as this script times them, at
    ``ctx.nt`` steps: the K-step kernels' passes (bytes of one pass, each
    input read once and each output written once, times the passes; the
    flop of the steps, halo cells computed twice not counted) and one
    ``gpu_step`` launch. The RTM calls have one velocity plane per shot;
    the taper is read as its three ramps (xramp, zfac, strip). With parts >
    0 the Laplacian's z taps are the split-bf16 banded product
    (:func:`mma_lap_flops`): the bounds of the ``*_mma`` kernels."""
    h = ctx.order // 2
    lf, tf = (lap_flops(h), 0) if not parts else mma_lap_flops(h, parts)
    plane = ctx.nxe * ctx.nze
    lapc = (ctx.nxe - 2 * h) * (ctx.nze - 2 * h)
    inter = ctx.nx * ctx.nz
    ramps = ctx.nxe + 2 * ctx.nze
    passes = -(-ctx.nt // k)
    steps = ns * ctx.nt
    f4 = 4
    return {
        # kstep_mod: reads p, pp, v2*dt2 (shared), ramps, patch; writes p,
        # pp and the traces; per step mod_step's arithmetic
        "kstep_mod": bound(
            f4 * passes * (4 * ns * plane + plane + ramps + 49 + k
                           + ns * k * ctx.nx),
            steps * (lapc * lf + 6 * plane + ctx.nx + 49), steps * lapc * tf),
        # kstep_gpu_fwd: reads p, pp, v2*dt2 (per shot), ramps; writes p, pp
        "kstep_gpu_fwd": bound(
            f4 * passes * (5 * ns * plane + ramps + k),
            steps * (lapc * lf + 7 * plane + 1), steps * lapc * tf),
        # kstep_gpu_bwd: reads four fields, v2*dt2, ramps, K trace rows and
        # the image; writes four fields and the image
        "kstep_gpu_bwd": bound(
            f4 * passes * (9 * ns * plane + ramps + ns * k * ctx.nx
                           + 2 * ns * inter),
            steps * (lapc * 2 * lf + 11 * plane + ctx.nx + 2 * inter),
            steps * lapc * 2 * tf),
        # gpu_step, one launch: reads y, x, v2*dt2, ramps and the trace
        # row, and over the interior (the only cells it images) the source
        # field and the image; writes t, the new field and the image
        "gpu_step": bound(
            f4 * (5 * ns * plane + ramps + ns * ctx.nx + 3 * ns * inter),
            ns * (lapc * lf + 7 * plane + ctx.nx + 2 * inter),
            ns * lapc * tf),
    }


def block_bounds(ctx, ns: int, k: int, n_x: int, n_z: int = 1,
                 gz: int = 0, parts: int = 0):
    """Bounds of the domain tiers' block kernels as this script times
    them: blocks of k steps over ``ctx.nt`` steps on each of ``n_x`` slabs
    (``n_z = 1``, the x tier's kernels) or ``n_x x n_z`` (x, z) tiles (a
    halo on each axis cut in more than one part), the bytes of every launch
    (each input read once, each output written once: the halo-extended
    fields in, the owned cells out; the traces by the tiles that record or
    inject row ``gz`` only), the flop of the steps over the grid (halo
    cells computed twice not counted). block_mod's velocity is one plane
    for all shots, the RTM kernels' one per shot; block_bwd's launches are
    not the seeded first one. With parts > 0 the Laplacian's x taps are the
    split-bf16 banded product (:func:`mma_lap_flops`): the bounds of the
    ``*_mma`` twins, under their names."""
    h = ctx.order // 2
    lf, tf = (lap_flops(h), 0) if not parts else mma_lap_flops(h, parts)
    sfx = "_mma" if parts else ""
    nxl, nzl = -(-ctx.nxe // n_x), -(-ctx.nze // n_z)
    hx = k * h if n_x > 1 or n_z == 1 else 0
    hz = k * h if n_z > 1 else 0
    nxw, nzw = nxl + 2 * hx, nzl + 2 * hz
    ext, own = nxw * nzw, nxl * nzl
    ramps = nxw + 2 * nzw
    blocks = -(-ctx.nt // k)
    launches = blocks * n_x * n_z
    holds = sum(l * nzl - hz <= gz < (l + 1) * nzl + hz for l in range(n_z))
    rows = blocks * n_x * (holds if n_z > 1 else 1)   # trace-row launches
    recs = blocks * n_x                                # recording launches
    plane = ctx.nxe * ctx.nze
    lapc = (ctx.nxe - 2 * h) * (ctx.nze - 2 * h)
    inter = ctx.nx * ctx.nz
    steps = ns * ctx.nt
    f4 = 4
    two_d = "2" if n_z > 1 else ""
    return {
        # reads p, pp, v2m, ramps, 7 Gaussian source rows a shot; writes
        # p, pp and the traces
        f"block{two_d}_mod{sfx}": bound(
            f4 * (launches * (2 * ns * ext + ext + ramps + 7 * ns * nxw + k
                              + 2 * ns * own) + recs * ns * k * nxl),
            steps * (lapc * lf + 6 * plane + ctx.nx + 49), steps * lapc * tf),
        # reads p, pp, v2m, ramps, the source row; writes p, pp
        f"block{two_d}_fwd{sfx}": bound(
            f4 * launches * (3 * ns * ext + ramps + ns * nxw + k
                             + 2 * ns * own),
            steps * (lapc * lf + 7 * plane + 1), steps * lapc * tf),
        # reads four fields, v2m, ramps, k trace rows and the image; writes
        # four fields and the image
        f"block{two_d}_bwd{sfx}": bound(
            f4 * (launches * (5 * ns * ext + ramps + 6 * ns * own)
                  + rows * ns * k * nxw),
            steps * (lapc * 2 * lf + 11 * plane + ctx.nx + 2 * inter),
            steps * lapc * 2 * tf),
    }


def max_rel(a, b) -> float:
    """max |a - b| / max |b| (0 where both are all zero: the traces of a
    tile that records none)."""
    d, m = float((a - b).abs().max()), float(b.abs().max())
    return d / m if m else (0.0 if d == 0 else float("inf"))


def rel_rms(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def kernel_name(mangled: str):
    """The template's name in an Itanium-mangled kernel name
    (``...11fd_step_mmaILi4ELi2EE...`` -> ``fd_step_mma``): the first
    length-prefixed identifier followed by its template arguments. A
    length prefix may follow the hex digits of an anonymous namespace's
    hash, so every tail of a run of digits is tried; where the hash's own
    digits also read as the length of a longer identifier ending at the
    same place, the shortest one, the innermost name, is taken."""
    best = None
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(1, len(digits) + 1):
            n = int(digits[-k:])
            name = mangled[m.end():m.end() + n]
            end = m.end() + n
            if (len(name) == n and name.isidentifier()
                    and mangled[end:end + 1] == "I"
                    and (best is None or end < best[0]
                         or (end == best[0] and n < len(best[1])))):
                best = (end, name)
    return best and best[1]


def strip_row(template: str) -> str:
    """`` (row n, wrapper)`` for the template of an exact strip kernel
    (STRIP_TEMPLATES), else ''."""
    if template not in STRIP_TEMPLATES:
        return ""
    wrapper, row = STRIP_TEMPLATES[template]
    return f" (row {row}, {wrapper})"


def template_args(mangled: str, name: str) -> str:
    """``<8, 3, true>``: the integer and bool template arguments that
    follow the template ``name`` in an Itanium-mangled kernel name
    (``Lin5E`` is -5, ``Lb1E`` true)."""
    m = re.search(rf"{name}I((?:L[ib]n?\d+E)+)E", mangled)
    args = re.findall(r"L([ib])(n?\d+)E", m.group(1)) if m else []
    return "<" + ", ".join(
        ("true" if v == "1" else "false") if t == "b" else v.replace("n", "-")
        for t, v in args) + ">"


def build_report(log: str) -> list:
    """One line per kernel of the build log: its instances, registers,
    static shared memory and spill stores, with the instances that spill
    the most (ptxas names an entry function, then prints its spills, then
    its registers and shared memory), and the kernel-table row of an exact
    strip kernel."""
    per, fn, args, spill = {}, None, "", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernel_name(m.group(1))
            args = fn and template_args(m.group(1), fn)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            per.setdefault(fn, []).append(
                (int(m.group(1)), spill, int(smem.group(1)) if smem else 0,
                 args))
    lines = []
    for fn, rs in sorted(per.items()):
        most = max(r[1] for r in rs)
        where = (f" (in {', '.join(r[3] for r in rs if r[1] == most)})"
                 if most else "")
        lines.append(f"[build] {fn}{strip_row(fn)}: {len(rs)} instances, "
                     f"{min(r[0] for r in rs)}-{max(r[0] for r in rs)} "
                     f"registers, {max(r[2] for r in rs)} bytes of static "
                     f"shared memory, {most} bytes of spill stores at "
                     f"most{where}")
    return lines


def block_launches(name: str, nt: int, k: int, tiles: int) -> int:
    """Launches of the domain block kernel ``name`` over nt steps in
    blocks of k (and a tail) on ``tiles`` slabs or tiles: one a pass, as
    every block kernel, exact or split, takes a block of more than 4 steps
    in two (``fk.block_passes``)."""
    from parallel_finite_difference_computation_tpu_torch.ops import (
        fd_kernels as fk)
    full, tail = divmod(nt, k)
    per = lambda n: len(fk.block_passes(n))
    return tiles * (full * per(k) + (per(tail) if tail else 0))


def digest(*arrays) -> str:
    """SHA-256 of the arrays' bytes, the first 16 hex digits: equal
    digests across runs or commits are bitwise equal results."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes())
    return h.hexdigest()[:16]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def profile(torch, label: str, fn, call_ms: float, smi: str) -> None:
    """One torch.profiler trace of fn, a call this script has timed before
    (so warm: no warm-up of its own, for the time limit):
    device time and launches of each kernel, and the kernels' share of
    call_ms, the call's median event time from the timing phase."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type.name == "CUDA"]
    busy = sum(ms for _, ms, _ in rows)
    for key, ms, n in sorted(rows, key=lambda r: -r[1]):
        template = re.search(r"(\w+)<", key)
        row = strip_row(template.group(1)) if template else ""
        print(f"[profile] {label}: {key[:60]}{row}: {ms:.3f} ms device time "
              f"in {n} launches ({ms / n * 1e3:.2f} us each)")
    print(f"[profile] {label}: kernels {busy:.3f} ms of the {call_ms:.3f} ms "
          f"event-timed call, busy share {busy / call_ms:.3f}; {smi}",
          flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    from parallel_finite_difference_computation_tpu_torch import (
        io, numerics, pipeline, solver)
    from parallel_finite_difference_computation_tpu_torch.config import (
        Params, Geometry)
    from parallel_finite_difference_computation_tpu_torch.models import (
        layered_model)
    from parallel_finite_difference_computation_tpu_torch.ops import (
        _build, fd_kernels as fk, stream)

    dev = torch.device("cuda", 0)
    results = {k: {} for k in KERNELS}

    def event_ms(fn, reps: int = 1) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def in_turns(fns, reps: int = 1, once=()):
        """Median-of-3 lists of event times of each function, after a
        warm-up, the order of the functions turned each round (3 rounds,
        to keep the script under 1000 s; the min-max spread of 5 rounds was
        under 3 % on the H100). The functions at the
        indices in ``once`` (the plain versions at the Pluto grid, seconds a
        call: a scale beside the kernels, not a claim) are timed once, in
        the first round, without a warm-up of their own, to keep the script
        inside its time limit."""
        for n, fn in enumerate(fns):
            if n not in once:
                fn()
        torch.cuda.synchronize()
        ts = [[] for _ in fns]
        for i in range(3):
            order = range(len(fns)) if i % 2 else reversed(range(len(fns)))
            for n in order:
                if i == 0 or n not in once:
                    ts[n].append(event_ms(fns[n], reps))
        return ts

    def span(t) -> str:
        if len(t) == 1:
            return f"{t[0]:.3f} ms (one sample)"
        return (f"{statistics.median(t):.3f} ms (min {min(t):.3f}, max "
                f"{max(t):.3f})")

    clock = [time.perf_counter()]
    start = clock[0]

    def phase_done(label: str) -> None:
        now = time.perf_counter()
        print(f"[phase] {label}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now


    # ---- 1. device
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"[device] {card}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    phase_done("device")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    log = _build.build_log()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
    if regs:
        print(f"[build] {len(regs)} kernel instances: {min(regs)}-{max(regs)} "
              f"registers per thread, {max(spills, default=0)} bytes of "
              f"spills at most")
    for line in build_report(log):
        print(line)
    # the exact strip kernels' dynamic shared memory, as their launchers
    # size it, at the main path's order 8 and K = 4 (the SM's 228 KB, 1 KB
    # reserved a block)
    for template, (name, row) in STRIP_TEMPLATES.items():
        b = fk.smem_bytes(name, 8, 4)
        print(f"[build] {template} (row {row}): {b} bytes of dynamic shared "
              f"memory a block at order 8, K = 4, "
              f"{228 * 1024 // (b + 1024)} blocks an SM by shared memory")
    # and the split instances of the strip bodies: kstep_gpu_bwd_mma at the
    # tiled tier's K = 4, the block kernels' at the domain tiers' K = 8, two
    # passes of 4
    for wrapper, k, what in (
            ("kstep_gpu_bwd", 4, "kstep_gpu_bwd_mma (row 13 split, "
                                 "bwd_strip.cuh, the z taps split)"),
            ("block_mod", 8, "block_mod_mma (rows 15a/16a split, "
                             "fwd_strip.cuh at P > 0)"),
            ("block_fwd", 8, "block_fwd_mma (rows 15b/16b split, "
                             "fwd_strip.cuh at P > 0)"),
            ("block_bwd", 8, "block_bwd_mma (rows 15c/16c split, "
                             "bwd_strip.cuh at P > 0)")):
        b = fk.smem_bytes(wrapper, 8, k, parts=2)
        print(f"[build] {what}: {b} bytes of dynamic shared memory a block "
              f"at order 8, K = {k}, {228 * 1024 // (b + 1024)} blocks an SM "
              f"by shared memory")

    phase_done("build")

    # ---- 3. kernel vs plain on the card
    P = Params(nz=151, nx=151, nt=1001, dz=10.0, dx=10.0, dt=0.001,
               fpeak=30.0, ns=8, sz=0, fsx=0, ds=20, gz=0, nxb=40, nzb=40,
               fac=0.01, order=8)
    vp = layered_model(P.nx, P.nz)
    g = Geometry.from_params(P)

    def shapes(order: int, nt: int):
        p = dataclasses.replace(P, order=order, nt=nt)
        ctx_mod = solver.FDContext.from_params(p, exact_taper=False)
        ctx_rtm = solver.FDContext.from_params(p, exact_taper=True)
        v2_mod = torch.from_numpy(pipeline.prepare_velocity_cpu(p, vp)).to(dev)
        v2_rtm = pipeline.prepare_velocities_gpu(p, vp, device=dev, seed=0)
        wav_mod = numerics.ricker_wavelet(nt, p.dt, p.fpeak, truncated=True)
        wav_rtm = numerics.ricker_wavelet(nt, p.dt, p.fpeak)
        return ctx_mod, ctx_rtm, v2_mod, v2_rtm, wav_mod, wav_rtm

    def pair_errs(k, p):
        return (max(max_rel(a, b) for a, b in zip(k, p)),
                max(float((a - b).abs().max()) for a, b in zip(k, p)))

    def rtm_errs(ctx_r, v2_r, wav_r, dobs, sx, sz, gz, out, record=False):
        """Both routes of the exact two-snapshot RTM against plain, into
        out, with the route each call took (its LAUNCHES); with record,
        the forced route's launches go into the per-step kernels'
        records."""
        pf = solver.fd_forward(ctx_r, v2_r, wav_r, sx, sz)
        pb = solver.fd_back(ctx_r, v2_r, pf[0], pf[1], dobs, gz)
        for per_step in (False, True):
            fk.reset_launches()
            kf = fk._fd_forward(ctx_r, v2_r, wav_r, sx, sz, 0,
                                per_step=per_step)
            kb = fk._fd_back(ctx_r, v2_r, pf[0], pf[1], dobs, gz, 0,
                             per_step=per_step)
            torch.cuda.synchronize()
            names = [k for k, n in fk.LAUNCHES.items() if n]
            out[" + ".join(names)] = (pair_errs(kf, pf), pair_errs((kb,),
                                                                   (pb,)))
            plan = fk.resident_plan(ctx_r.nxe, ctx_r.nze, ctx_r.order)
            want = ({"rtm_fwd_cluster": 1, "rtm_bwd_cluster": 1}
                    if plan and not per_step
                    else {"rtm_fwd_step": ctx_r.nt, "rtm_bwd_step": ctx_r.nt})
            check({k: fk.LAUNCHES[k] for k in names} == want,
                  f"RTM route (per_step={per_step}): launches "
                  f"{dict(fk.LAUNCHES)}, expected {want}")
            if record and per_step:
                for k in names:
                    results[k]["launches"] = fk.LAUNCHES[k]
        return out

    def mod_errs(ctx_m, v2_m, wav_m, sx, sz, gz, out, record=False,
                 source="gaussian", taper="all", rec="trace"):
        """Both routes of the exact modeling (``rec``: what is recorded)
        against plain, into out: the resident kernel (mod_cluster, or
        rec_fwd_cluster for the frames) where the shot fits a cluster,
        and the per-step one (mod_step, rec_fwd_step) forced, each with
        the launches it counted; with record, the forced route's launches
        go into the per-step kernel's records. Returns the plain outputs
        and the forced route's."""
        pm = solver.forward_modeling(ctx_m, v2_m, wav_m, sx, sz, gz,
                                     source=source, taper=taper, record=rec)
        kinds = (("rec_fwd_cluster", "rec_fwd_step") if rec == "wavefield"
                 else ("mod_cluster", "mod_step"))
        plan = fk.resident_plan(ctx_m.nxe, ctx_m.nze, ctx_m.order)
        for per_step in (False, True):
            fk.reset_launches()
            km = fk._forward_modeling(ctx_m, v2_m, wav_m, sx, sz, gz, source,
                                      taper, rec, 0, per_step=per_step)
            torch.cuda.synchronize()
            name = kinds[1] if per_step or plan is None else kinds[0]
            want = {name: ctx_m.nt if name == kinds[1] else 1}
            got = {k: n for k, n in fk.LAUNCHES.items() if n}
            check(got == want, f"modeling route ({rec}, per_step="
                               f"{per_step}): launches {got}, expected "
                               f"{want}")
            out[name + (" (forced)" if per_step and plan else "")] = (
                pair_errs(km, pm),)
            if record and per_step:
                results[name]["launches"] = fk.LAUNCHES[name]
        return pm, km

    def compare(order: int, nt: int):
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r = shapes(order, nt)
        out = {}
        pm, ks = mod_errs(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz, out,
                          record=order == 8 and nt == P.nt)
        dobs = pm[2].transpose(1, 2).contiguous()          # (ns, nx, nt)
        rtm_errs(ctx_r, v2_r, wav_r, dobs, g.sx, g.sz, g.gz, out,
                 record=order == 8 and nt == P.nt)
        torch.cuda.synchronize()
        return out, pm[2], ks[2]

    def report(k, errs, where, order):
        """Prints and gates one kernel's (max rel, max abs) errors; the
        resident kernels bitwise."""
        rel, absd = errs
        print(f"[kernel vs plain] {k} {where}: max rel err {rel:.3e}, max "
              f"abs err {absd:.3e}", flush=True)
        check(rel <= GATE, f"{k} {where}: {rel:.3e} > {GATE}")
        check(not k.endswith("_cluster") or absd == 0,
              f"{k} {where} is not bitwise")
        if order == 8:
            results[k]["max_abs_err"] = max(
                results[k].get("max_abs_err", 0.0), absd)

    plain_seis = step_seis = None
    for order, nt in ((8, P.nt), (4, 20), (10, 20), (16, 20)):
        errs, seis, seis_step = compare(order, nt)
        if order == 8:
            plain_seis, step_seis = seis, seis_step
        for names, e in errs.items():
            for k, err in zip(names.split(" (")[0].split(" + "), e):
                report(k, err, f"order {order} nt {nt} ns {P.ns}", order)
    # 2 shots on grids just inside the resident route's limit (a strip for
    # each of 512 threads) and just past it (the per-step kernels)
    for n in (176, 180):
        pg = dataclasses.replace(P, nx=n, nz=n, nt=20, ns=2, ds=100)
        ctx_g = solver.FDContext.from_params(pg, exact_taper=True)
        plan = fk.resident_plan(ctx_g.nxe, ctx_g.nze, pg.order)
        check((plan is not None) == (n == 176),
              f"{ctx_g.nxe} x {ctx_g.nze}: resident plan {plan}")
        gg = Geometry.from_params(pg)
        v2_g = pipeline.prepare_velocities_gpu(pg, layered_model(n, n),
                                               device=dev, seed=0)
        wav_g = numerics.ricker_wavelet(pg.nt, pg.dt, pg.fpeak)
        d_g = torch.randn((pg.ns, pg.nx, pg.nt), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(n))
        errs = rtm_errs(ctx_g, v2_g, wav_g, d_g, gg.sx, gg.sz, gg.gz, {})
        ctx_gm = solver.FDContext.from_params(pg, exact_taper=False)
        v2_gm = torch.from_numpy(pipeline.prepare_velocity_cpu(
            pg, layered_model(n, n))).to(dev)
        mod_errs(ctx_gm, v2_gm, numerics.ricker_wavelet(
            pg.nt, pg.dt, pg.fpeak, truncated=True), gg.sx, gg.sz, gg.gz,
                 errs)
        for names, e in errs.items():
            if names == "rtm_fwd_step + rtm_bwd_step" and plan:
                names = "rtm_fwd_step + rtm_bwd_step (forced)"
            print(f"[kernel vs plain] {ctx_g.nxe} x {ctx_g.nze}, 2 shots, nt "
                  f"20, plan {plan}: {names}", flush=True)
            for k, err in zip(names.split(" (")[0].split(" + "), e):
                report(k, err, f"at {ctx_g.nxe} x {ctx_g.nze}", 0)
    lib = _build.library()
    for order in (4, 8, 16):
        print(f"[kernel vs plain] 3lay order {order}: "
              f"{fk.resident_plan(P.nxe, P.nze, order)}; clusters the card "
              f"holds at once: forward "
              f"{lib.pfdc_rtm_fwd_clusters(P.nxe, P.nze, order)}, backward "
              f"{lib.pfdc_rtm_bwd_clusters(P.nxe, P.nze, order)}, modeling "
              f"{lib.pfdc_mod_clusters(P.nxe, P.nze, order)} (a batch of "
              f"{P.ns} shots)", flush=True)

    phase_done("kernel vs plain")

    # ---- 4. the main path, through the kernels; 3lay's "auto" is the
    # per-step tier
    check(pipeline.resolve_backend("auto", P.nxe, P.nze) == "pallas",
          "3lay auto does not resolve to the per-step kernels")
    fk.reset_launches()
    stream.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data = pipeline.run_modeling(P, vp=vp, device=dev)
        img, imlocs = pipeline.run_rtm_gpu(P, vp=vp, dobs=data, seed=0,
                                           device=dev, outdir=tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        written = np.fromfile(os.path.join(tmp, "dir.image"), np.float32)
    print(f"[main path] run_modeling + run_rtm_gpu, 3lay ns={P.ns} "
          f"nt={P.nt}: {wall:.3f} s wall incl. host; launches {launches}",
          flush=True)
    want = {"mod_cluster": 1, "rtm_fwd_cluster": 1, "rtm_bwd_cluster": 1}
    for k, n in launches.items():
        check(n == want.get(k, 0), f"{k} launched {n} times, expected "
                                   f"{want.get(k, 0)}")
    for k in want:
        results[k]["launches"] = launches[k]
    check(not any(stream.LAUNCHES.values()),
          f"the 3lay path launched K-step kernels: {stream.LAUNCHES}")
    check(data.shape == (P.ns, P.nx, P.nt) and np.isfinite(data).all()
          and np.abs(data).max() > 0, "gathers not finite or all zero")
    check(written.size == P.nx * P.nz and np.isfinite(written).all()
          and np.abs(written).max() > 0, "dir.image missing, not finite or "
                                         "all zero")
    check(np.array_equal(written.reshape(P.nx, P.nz), img),
          "dir.image differs from the returned image")
    rr_data = rel_rms(data, plain_seis.transpose(1, 2).cpu().numpy())
    ctx_r = solver.FDContext.from_params(P, exact_taper=True)
    v2_r = pipeline.prepare_velocities_gpu(P, vp, device=dev, seed=0)
    wav_r = numerics.ricker_wavelet(P.nt, P.dt, P.fpeak)
    d = torch.from_numpy(data).to(dev)
    plain_img = solver.rtm_shot_snapshot(ctx_r, v2_r, wav_r, d, g.sx, g.sz,
                                         g.gz).cpu().numpy().sum(axis=0)
    rr_img = rel_rms(img, plain_img)
    same_step = np.array_equal(data, step_seis.transpose(1, 2).cpu().numpy())
    print(f"[main path] vs plain on the card: gathers rel RMS {rr_data:.3e}, "
          f"image rel RMS {rr_img:.3e}; gathers bitwise the forced per-step "
          f"route's (mod_step, phase 3): {same_step}", flush=True)
    check(rr_data <= GATE and rr_img <= GATE, "main path differs from plain")
    check(same_step, "the main path's gathers differ from the per-step "
                     "route's")

    # the whole slice at a small size, card kernels vs plain on the CPU; the
    # per-shot boundary velocities come from one vel_ext_file (the parity
    # path), since the two devices' generators draw different numbers
    small = Params(nz=24, nx=28, nt=11, dz=10.0, dx=10.0, dt=0.001,
                   fpeak=25.0, ns=2, sz=4, fsx=6, ds=10, gz=1, nxb=8,
                   nzb=8, fac=0.7, order=8)
    vps = layered_model(small.nx, small.nz)
    base = np.zeros((small.nxe, small.nze), np.float32)
    base[small.nxb:small.nxb + small.nx, small.nzb:small.nzb + small.nz] = vps
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        small.vel_ext_file = os.path.join(tmp, "vel_ext.bin")
        io.write_f32(small.vel_ext_file, np.stack([
            numerics.extendvel_random(base, small.nx, small.nz, small.nxb,
                                      small.nzb, seed=i)
            for i in range(small.ns)]))
        for where in ("cpu", dev):
            d_small = pipeline.run_modeling(small, vp=vps, device=where)
            img_small, _ = pipeline.run_rtm_gpu(small, vp=vps, dobs=d_small,
                                                device=where)
            outs[str(where)] = (d_small, img_small)
    rr_small = [rel_rms(a, b) for a, b in zip(outs[str(dev)], outs["cpu"])]
    print(f"[main path] small config (28 x 24, ns=2, nt=11), card kernels "
          f"vs plain on the CPU: gathers rel RMS {rr_small[0]:.3e}, image "
          f"rel RMS {rr_small[1]:.3e}", flush=True)
    check(max(rr_small) <= GATE, "small-config slice differs from the CPU")

    phase_done("main path")

    # ---- 5. rtm_main's rec kernels vs plain on the card
    def rec_inputs(p, dobs):
        """Context, shared velocity, wavelet, gathers and per-shot
        next_shot_first of the rtm_main flavor (exact_taper=False)."""
        ctx = solver.FDContext.from_params(p, exact_taper=False)
        v2 = torch.from_numpy(pipeline.prepare_velocity_cpu(
            p, layered_model(p.nx, p.nz))).to(dev)
        wav = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)
        d = torch.from_numpy(np.ascontiguousarray(dobs, np.float32)).to(dev)
        nxt = torch.cat([d[1:, 0, 0], d.new_zeros(1)]).cpu().numpy()
        return ctx, v2, wav, d, nxt

    def errs(k, p):
        """(max rel err, max abs err) of kernel outputs k against plain p."""
        k = k if isinstance(k, tuple) else (k,)
        p = p if isinstance(p, tuple) else (p,)
        return (max(max_rel(a, b) for a, b in zip(k, p)),
                max(float((a - b).abs().max()) for a, b in zip(k, p)))

    def rec_fwd_errs(p, ctx, v2, wav, out):
        """Both routes of rtm_main's forward (the frames) against plain
        (mod_errs), into out as (max rel, max abs) by kernel; the forced
        route's launches recorded at 3lay. Returns the plain frames."""
        gp = Geometry.from_params(p)
        fwd = {}
        pf, _ = mod_errs(ctx, v2, wav, gp.sx, gp.sz, gp.gz, fwd,
                         record=p is P, source="point", taper="top",
                         rec="wavefield")
        out.update({k: e for k, (e,) in fwd.items()})
        return pf[2]

    def rec_bwd_errs(ctx, v2, d, gz, quirk, nxt, swf, out, record=False):
        """Both routes of rtm_main's backward against plain, into out as
        (max rel, max abs) by kernel and mode: the resident kernel
        (rec_bwd_cluster) where the shot fits a cluster and the per-step
        one (rec_bwd_step) forced; the frames and the final pair against
        backward_recorded, the image against the plain frames'
        correlation summed in time order (as both routes sum it) and
        against backward_image; the launches each call counted; with
        record, the forced image call's launches go into rec_bwd_step's
        record. The resident route is held bitwise to the forced one."""
        plan = fk.resident_plan(ctx.nxe, ctx.nze, ctx.order)
        pb = solver.backward_recorded(ctx, v2, d, gz, x_off_quirk=quirk,
                                      next_shot_first=nxt)
        pt = torch.zeros_like(swf[:, 0])
        for it in range(ctx.nt):
            pt = pt + swf[:, ctx.nt - 1 - it] * pb[2][:, it]
        pi = solver.backward_image(ctx, v2, swf, d, gz, x_off_quirk=quirk,
                                   next_shot_first=nxt)
        got = []
        for per_step in (False, True):
            name = ("rec_bwd_step" if per_step or plan is None
                    else "rec_bwd_cluster")
            sfx = " (forced)" if per_step and plan else ""
            fk.reset_launches()
            kb = fk._rec_bwd(ctx, v2, d, gz, quirk, nxt, 0,
                             per_step=per_step)
            frames = dict(fk.LAUNCHES)
            fk.reset_launches()
            ki = fk._rec_bwd(ctx, v2, d, gz, quirk, nxt, 0, swf=swf,
                             per_step=per_step)
            torch.cuda.synchronize()
            n = 1 if name == "rec_bwd_cluster" else ctx.nt
            for mode, counts in (("frames", frames),
                                 ("image", dict(fk.LAUNCHES))):
                want = {name: n}
                have = {k: v for k, v in counts.items() if v}
                check(have == want, f"rtm_main backward route ({mode}, "
                                    f"per_step={per_step}): launches "
                                    f"{have}, expected {want}")
            if record and per_step:
                results[name]["launches"] = fk.LAUNCHES[name]
            out[f"{name} frames{sfx}"] = errs(kb, pb)
            out[f"{name} image{sfx}"] = errs(ki, pt)
            out[f"{name} image{sfx} vs backward_image"] = errs(ki, pi)
            got.append((*kb, ki))
        if plan:
            same = all(torch.equal(a, b) for a, b in zip(*got))
            print(f"[rec vs plain] rec_bwd_cluster bitwise the forced "
                  f"rec_bwd_step (frames, pair, image) at {ctx.nxe} x "
                  f"{ctx.nze} order {ctx.order} nt {ctx.nt} x_off_quirk "
                  f"{quirk}: {same}", flush=True)
            check(same, f"rec_bwd_cluster differs from the forced "
                        f"rec_bwd_step at {ctx.nxe} x {ctx.nze}")
        return out

    def compare_rec(p, dobs, quirk):
        ctx, v2, wav, d, nxt = rec_inputs(p, dobs)
        gp = Geometry.from_params(p)
        out = {}
        if quirk:    # the forward does not see the quirk: once a case
            swf = rec_fwd_errs(p, ctx, v2, wav, out)
        else:
            swf = solver.forward_modeling(ctx, v2, wav, gp.sx, gp.sz, gp.gz,
                                          source="point", taper="top",
                                          record="wavefield")[2]
        rec_bwd_errs(ctx, v2, d, gp.gz, quirk, nxt, swf, out,
                     record=p is P and quirk)
        del swf
        kr = fk.rtm_full_cuda(ctx, v2, wav, d, gp.sx, gp.sz, gp.gz,
                              x_off_quirk=quirk, next_shot_first=nxt)
        pr = solver.rtm_shot_full(ctx, v2, wav, d, gp.sx, gp.sz, gp.gz,
                                  x_off_quirk=quirk, next_shot_first=nxt)
        out["rtm_full_cuda"] = errs(kr, pr)
        torch.cuda.synchronize()
        return out, solver.receiver_offset(ctx, quirk)

    def bitwise_kernel(k: str) -> bool:
        """Whether the result k of phase 5 must be bitwise: the resident
        kernels against the plain versions summed in their order."""
        return (k.split(" ")[0].endswith("_cluster")
                and "backward_image" not in k)

    rng = np.random.default_rng(7)
    runs = [(P, data, True)]
    for order, nxb, nzb in ((4, 40, 30), (10, 12, 30)):   # (12, 30): clamped
        for nt in (20, 21):
            p = dataclasses.replace(P, order=order, nt=nt, nxb=nxb, nzb=nzb)
            dobs = rng.standard_normal((p.ns, p.nx, nt)).astype(np.float32)
            runs += [(p, dobs, True), (p, dobs, False)]
    for p, dobs, quirk in runs:
        out, x0 = compare_rec(p, dobs, quirk)
        for k, (rel, absd) in out.items():
            print(f"[rec vs plain] {k} order {p.order} nt {p.nt} ns {p.ns} "
                  f"nxb {p.nxb} nzb {p.nzb} x_off_quirk {quirk} (receiver "
                  f"row at x {x0}): max rel err {rel:.3e}, max abs err "
                  f"{absd:.3e}", flush=True)
            check(rel <= GATE, f"{k} order {p.order} nt {p.nt}: {rel:.3e} > "
                               f"{GATE}")
            check(not bitwise_kernel(k) or absd == 0,
                  f"{k} order {p.order} nt {p.nt} is not bitwise")
        if p is P and quirk:
            results["rec_fwd_cluster"]["max_abs_err"] = out[
                "rec_fwd_cluster"][1]
            results["rec_fwd_step"]["max_abs_err"] = out[
                "rec_fwd_step (forced)"][1]
            results["rec_bwd_cluster"]["max_abs_err"] = max(
                out["rec_bwd_cluster frames"][1],
                out["rec_bwd_cluster image"][1])
            results["rec_bwd_step"]["max_abs_err"] = max(
                out["rec_bwd_step frames (forced)"][1],
                out["rec_bwd_step image (forced)"][1])
    # the forward's two routes at order 16 (3lay, nt 20); both passes' two
    # routes, 2 shots, on phase 3's grids at the resident route's limit
    # (256 x 256 extended) and past it (260 x 260)
    for p in (dataclasses.replace(P, order=16, nt=20),
              *(dataclasses.replace(P, nx=n, nz=n, nt=20, ns=2, ds=100)
                for n in (176, 180))):
        dobs = rng.standard_normal((p.ns, p.nx, p.nt)).astype(np.float32)
        ctx, v2, wav, d, nxt = rec_inputs(p, dobs)
        out = {}
        swf = rec_fwd_errs(p, ctx, v2, wav, out)
        if p.ns == 2:
            gp = Geometry.from_params(p)
            rec_bwd_errs(ctx, v2, d, gp.gz, True, nxt, swf, out)
        for k, (rel, absd) in out.items():
            print(f"[rec vs plain] {k} order {p.order} nt {p.nt} ns {p.ns} "
                  f"at {ctx.nxe} x {ctx.nze} (plan "
                  f"{fk.resident_plan(ctx.nxe, ctx.nze, p.order)}): max rel "
                  f"err {rel:.3e}, max abs err {absd:.3e}", flush=True)
            check(rel <= GATE and (not bitwise_kernel(k) or absd == 0),
                  f"{k} at {ctx.nxe} x {ctx.nze} order {p.order}: {rel:.3e},"
                  f" {absd:.3e}")
        del swf
    for order in (4, 8, 16):
        print(f"[rec vs plain] 3lay order {order}: clusters the card holds "
              f"at once: rec_fwd_cluster "
              f"{lib.pfdc_rec_fwd_clusters(P.nxe, P.nze, order)}, "
              f"rec_bwd_cluster "
              f"{lib.pfdc_rec_bwd_clusters(P.nxe, P.nze, order)} (a batch "
              f"of {P.ns} shots)", flush=True)

    phase_done("rec kernels vs plain")

    # ---- 6. the rtm_main path, through the kernels
    fk.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        img_m, imlocs_m = pipeline.run_rtm_cpu(P, vp=vp, dobs=data,
                                               outdir=tmp, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        written = np.fromfile(os.path.join(tmp, "dir.image"), np.float32)
        written_locs = np.fromfile(os.path.join(tmp, "dir.img"), np.float32)
    print(f"[rtm_main path] run_rtm_cpu, 3lay ns={P.ns} nt={P.nt}: "
          f"{wall:.3f} s wall incl. host; launches {launches}", flush=True)
    want = {"rec_fwd_cluster": 1, "rec_bwd_cluster": 1}
    for k, n in launches.items():
        check(n == want.get(k, 0), f"{k} launched {n} times, expected "
                                   f"{want.get(k, 0)}")
    for k in want:
        results[k]["launches"] = launches[k]
    check(img_m.shape == (P.nx, P.nz) and np.isfinite(imlocs_m).all()
          and np.abs(img_m).max() > 0, "rtm_main image not finite or zero")
    check(written.tobytes() == img_m.tobytes(),
          "dir.image differs from the returned image")
    check(written_locs.tobytes() == imlocs_m.tobytes(),
          "dir.img differs from the returned per-shot images")
    ctx_c, v2_c, wav_c, d_c, nxt_c = rec_inputs(P, data)
    plain_m = solver.rtm_shot_full(ctx_c, v2_c, wav_c, d_c, g.sx, g.sz, g.gz,
                                   next_shot_first=nxt_c).cpu().numpy()
    rr_m = rel_rms(img_m, plain_m.sum(axis=0))
    print(f"[rtm_main path] vs plain on the card: image rel RMS {rr_m:.3e}, "
          f"per-shot images rel RMS {rel_rms(imlocs_m, plain_m):.3e}",
          flush=True)
    check(rr_m <= GATE, "rtm_main path differs from plain")
    outs_m = {}
    for where in ("cpu", dev):
        outs_m[str(where)] = pipeline.run_rtm_cpu(
            small, vp=vps, dobs=outs["cpu"][0], device=where)
    rr_sm = [rel_rms(a, b) for a, b in zip(outs_m[str(dev)], outs_m["cpu"])]
    print(f"[rtm_main path] small config (28 x 24, ns=2, nt=11), card "
          f"kernels vs plain on the CPU: image rel RMS {rr_sm[0]:.3e}, "
          f"per-shot rel RMS {rr_sm[1]:.3e}", flush=True)
    check(max(rr_sm) <= GATE, "small-config rtm_main differs from the CPU")

    phase_done("rtm_main path")

    # ---- 7. the stencil path, through the kernel
    from parallel_finite_difference_computation_tpu_torch.ops import stencil
    grids = {"415 x 295": Params(nx=335, nz=215, nt=1, dx=10.0, dz=10.0,
                                 dt=0.001, nxb=40, nzb=40),
             "8192 x 8192": Params(nx=8112, nz=8112, nt=1, dx=10.0, dz=10.0,
                                   dt=0.001, nxb=40, nzb=40)}
    # and a ragged large field, whose rows are not on 16 bytes and whose
    # tails cut lap_apply's band and run, at the lowest and highest order
    ragged = {"4099 x 4097": Params(nx=4019, nz=4017, nt=1, dx=10.0,
                                    dz=10.0, dt=0.001, nxb=40, nzb=40)}
    stencil_grids = {**grids, **ragged}
    orders = {**{label: (4, 8, 10) for label in grids},
              **{label: (2, 16) for label in ragged}}
    fields = {}
    stencil_err = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for label, p in stencil_grids.items():
            path = os.path.join(tmp, f"{p.nxe}x{p.nze}.bin")
            f = np.random.default_rng(p.nxe).standard_normal(
                (p.nxe, p.nze)).astype(np.float32)
            io.write_f32(path, f)
            fields[label] = torch.from_numpy(f).to(dev)
        fk.reset_launches()
        t0 = time.perf_counter()
        laps = {}
        for label, p in stencil_grids.items():
            for order in orders[label]:
                q = dataclasses.replace(p, order=order)
                laps[label, order] = pipeline.run_stencil(
                    q, input_path=os.path.join(tmp, f"{p.nxe}x{p.nze}.bin"),
                    device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
    print(f"[stencil path] run_stencil at 415 x 295 and 8192 x 8192, orders "
          f"4, 8, 10, and 4099 x 4097, orders 2, 16: {wall:.3f} s wall incl. "
          f"file reads; launches {launches}", flush=True)
    results["lap_apply"]["launches"] = launches["lap_apply"]
    check(launches["lap_apply"] == len(laps),
          f"lap_apply launched {launches['lap_apply']} times, expected "
          f"{len(laps)}")
    for (label, order), lap in laps.items():
        p = stencil_grids[label]
        cx, cz = numerics.scaled_coefficients(order, p.dx, p.dz)
        want = stencil.laplacian(fields[label], cx, cz, order)
        got = torch.from_numpy(lap).to(dev)
        rel, absd = errs(got, want)
        bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
        stencil_err = max(stencil_err, absd)
        print(f"[stencil path] lap_apply {label} order {order} vs plain on "
              f"the card: {'bitwise' if bitwise else 'NOT bitwise'}, max rel "
              f"err {rel:.3e}, max abs err {absd:.3e}; launch "
              f"{fk.lap_shape(p.nxe, p.nze, order)}", flush=True)
        check(lap.shape == (p.nxe, p.nze) and np.isfinite(lap).all()
              and bitwise, f"lap_apply {label} order {order} is not bitwise "
              f"its plain version")
    results["lap_apply"]["max_abs_err"] = stencil_err
    del laps
    for label in ragged:
        del fields[label]

    phase_done("stencil path")

    # ---- 8. the large-grid tier's kernels vs plain on the card
    def tier_case(p, velocities=(1500.0, 2500.0, 3500.0)):
        """Contexts, velocities, wavelets, random gathers and geometry of
        the modeling flavor (exact_taper=False, one clamp-extended velocity)
        and of two-snapshot RTM (exact_taper=True, one random boundary per
        shot)."""
        vpp = layered_model(p.nx, p.nz, velocities=velocities)
        d = torch.from_numpy(np.random.default_rng(p.order).standard_normal(
            (p.ns, p.nx, p.nt)).astype(np.float32)).to(dev)
        return (solver.FDContext.from_params(p, exact_taper=False),
                solver.FDContext.from_params(p, exact_taper=True),
                torch.from_numpy(pipeline.prepare_velocity_cpu(p, vpp)).to(dev),
                pipeline.prepare_velocities_gpu(p, vpp, device=dev, seed=0),
                numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True),
                numerics.ricker_wavelet(p.nt, p.dt, p.fpeak), d,
                Geometry.from_params(p))

    def compare_tier(case, k: int):
        """(max rel err, max abs err) of each K-step kernel against its
        plain version on the same CUDA tensors: kstep_mod through
        forward_modeling_tiled; kstep_gpu_fwd's passes; the two gpu_step
        seed steps from the plain snapshots; kstep_gpu_bwd's passes from
        the plain seeded state; and the whole tiled RTM loop."""
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp = case
        nt, out = ctx_r.nt, {}
        km = solver.forward_modeling_tiled(ctx_m, v2_m, wav_m, gp.sx, gp.sz,
                                           gp.gz, block_k=k)
        pm = solver.forward_modeling(ctx_m, v2_m, wav_m, gp.sx, gp.sz, gp.gz)
        out["kstep_mod"] = errs(km, pm)
        del km, pm
        c = stream.prepare(ctx_r, v2_r, gp.sx, source="point", taper="top")
        kf = (torch.zeros((len(gp.sx), ctx_r.nxe, ctx_r.nze), device=dev),) * 2
        for it0 in range(0, nt, k):
            kf = stream.fd_forward_kstep_cuda(ctx_r, *kf, v2_r,
                                              wav_r[it0:it0 + k], gp.sx,
                                              gp.sz, consts=c)
        pf = solver.fd_forward(ctx_r, v2_r, wav_r, gp.sx, gp.sz)
        out["kstep_gpu_fwd"] = errs(kf, pf)
        inj = d.flip(-1).transpose(1, 2).contiguous()
        step = functools.partial(stream.fd_step_gpu_cuda, consts=c)
        ks = solver._seed_steps(ctx_r, v2_r, *pf, inj, gp.gz, step)
        ps = solver._seed_steps(ctx_r, v2_r, *pf, inj, gp.gz)
        out["gpu_step"] = errs(ks[2:], ps[2:])
        kb = ps[:4] + (ps[4].clone(),)          # the kernel adds in place
        for it0 in range(2, nt, k):
            kb = stream.fd_back_kstep_cuda(ctx_r, *kb, v2_r,
                                           inj[:, it0:it0 + k], gp.gz,
                                           consts=c)
        pb = solver.fd_back_kstep(ctx_r, *ps, v2_r, inj[:, 2:], gp.gz)
        out["kstep_gpu_bwd"] = errs(kb, pb)
        del kf, pf, ks, ps, kb, pb
        ki = solver.rtm_shot_snapshot_tiled(ctx_r, v2_r, wav_r, d, gp.sx,
                                            gp.sz, gp.gz, block_k=k)
        pi = solver.rtm_shot_snapshot(ctx_r, v2_r, wav_r, d, gp.sx, gp.sz,
                                      gp.gz)
        out["rtm_shot_snapshot_tiled"] = errs(ki, pi)
        torch.cuda.synchronize()
        return out

    # 53 x 70 + borders 7, 9: 67 x 88, no multiple of the 32 x 64 tiles;
    # the sources at x = 31 and 61 and z = 62, the receiver row at z = 63,
    # across the tile edges at x = 32 and z = 64
    short = Params(nz=70, nx=53, nt=21, dz=10.0, dx=10.0, dt=0.001,
                   fpeak=30.0, ns=2, sz=53, fsx=24, ds=30, gz=54, nxb=7,
                   nzb=9, fac=0.7, order=8)
    for order in (4, 8, 10):
        case = tier_case(dataclasses.replace(short, order=order))
        for k in (2, 4):
            for kname, (rel, absd) in compare_tier(case, k).items():
                print(f"[tier vs plain] {kname} order {order} K {k} nt "
                      f"{short.nt} 67 x 88: max rel err {rel:.3e}, max abs "
                      f"err {absd:.3e}", flush=True)
                check(rel <= GATE, f"{kname} order {order} K {k}: {rel:.3e}")
                check(kname not in TIER_BITWISE or absd == 0,
                      f"{kname} order {order} K {k} is not bitwise")
    pluto = Params(**dict(PLUTO, nt=203))
    case = tier_case(pluto, PLUTO_VELOCITIES)
    for kname, (rel, absd) in compare_tier(case, 4).items():
        print(f"[tier vs plain] {kname} Pluto {pluto.nxe} x {pluto.nze} "
              f"order 8 K 4 nt {pluto.nt} ns {pluto.ns}: max rel err "
              f"{rel:.3e}, max abs err {absd:.3e}", flush=True)
        check(rel <= GATE, f"{kname} at the Pluto grid: {rel:.3e}")
        check(kname not in TIER_BITWISE or absd == 0,
              f"{kname} at the Pluto grid is not bitwise")
        if kname in results:
            results[kname]["max_abs_err"] = absd
    phase_done("large-grid kernels vs plain")

    # ---- 9. tiled vs per-step kernels at the Pluto grid
    ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp = case
    km = solver.forward_modeling_tiled(ctx_m, v2_m, wav_m, gp.sx, gp.sz,
                                       gp.gz, block_k=4)
    kp = fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, gp.sx, gp.sz, gp.gz)
    ri = solver.rtm_shot_snapshot_tiled(ctx_r, v2_r, wav_r, d, gp.sx, gp.sz,
                                        gp.gz, block_k=4)
    rp = fk.rtm_snapshot_cuda(ctx_r, v2_r, wav_r, d, gp.sx, gp.sz, gp.gz)
    torch.cuda.synchronize()
    for label, (rel, absd) in (("forward_modeling_tiled vs "
                                "forward_modeling_cuda", errs(km, kp)),
                               ("rtm_shot_snapshot_tiled vs "
                                "rtm_snapshot_cuda", errs(ri, rp))):
        print(f"[tiled vs per-step] {label}, Pluto, ns {pluto.ns}, nt "
              f"{pluto.nt}: max abs err {absd:.3e}, max rel err {rel:.3e}",
              flush=True)
        check(rel <= GATE, f"{label}: {rel:.3e}")
    del km, kp, ri, rp, case
    phase_done("tiled vs per-step")

    # ---- 10. the Pluto path, through both tiers
    pl = Params(**PLUTO)
    vp_pl = layered_model(pl.nx, pl.nz, velocities=PLUTO_VELOCITIES)
    check(pipeline.resolve_backend("auto", pl.nxe, pl.nze) == "tiled",
          "Pluto auto does not resolve to the tiled tier")
    tiers = {}
    for backend in ("auto", "pallas"):
        fk.reset_launches()
        stream.reset_launches()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            dat = pipeline.run_modeling(pl, vp=vp_pl, device=dev,
                                        backend=backend)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img_p, locs_p = pipeline.run_rtm_gpu(pl, vp=vp_pl, dobs=dat,
                                                 seed=0, device=dev,
                                                 outdir=tmp, backend=backend)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = {**fk.LAUNCHES, **stream.LAUNCHES}
            written = np.fromfile(os.path.join(tmp, "dir.image"), np.float32)
        tiers[backend] = (dat, img_p, locs_p)
        print(f"[Pluto path] backend={backend!r} ({pl.nxe} x {pl.nze}, nt "
              f"{pl.nt}, ns {pl.ns}): run_modeling {t1 - t0:.3f} s wall "
              f"({(t1 - t0) / pl.ns:.3f} s/shot), run_rtm_gpu {t2 - t1:.3f} s "
              f"wall ({(t2 - t1) / pl.ns:.3f} s/shot), host included; "
              f"launches {launches}; {smi}", flush=True)
        check(dat.shape == (pl.ns, pl.nx, pl.nt) and np.isfinite(dat).all()
              and np.abs(dat).max() > 0, f"{backend}: gathers not finite")
        check(written.size == pl.nx * pl.nz
              and written.tobytes() == img_p.tobytes()
              and np.isfinite(img_p).all() and np.abs(img_p).max() > 0,
              f"{backend}: dir.image missing, wrong, not finite or zero")
        passes, bwd = -(-pl.nt // 4), -(-(pl.nt - 2) // 4)
        want = ({"kstep_mod": passes, "kstep_gpu_fwd": passes,
                 "kstep_gpu_bwd": bwd, "gpu_step": 2} if backend == "auto"
                else {"mod_step": pl.nt, "rtm_fwd_step": pl.nt,
                      "rtm_bwd_step": pl.nt})
        for k, n in launches.items():
            check(n == want.get(k, 0), f"{backend}: {k} launched {n} times, "
                                       f"expected {want.get(k, 0)}")
        if backend == "auto":
            for k in stream.LAUNCHES:
                results[k]["launches"] = launches[k]
    rr = [rel_rms(a, b) for a, b in zip(tiers["auto"], tiers["pallas"])]
    print(f"[Pluto path] tiled vs per-step tier: gathers rel RMS {rr[0]:.3e}, "
          f"image rel RMS {rr[1]:.3e}, per-shot images rel RMS {rr[2]:.3e}",
          flush=True)
    check(max(rr) <= GATE, "the Pluto tiers differ")
    del tiers, dat
    phase_done("Pluto path")

    # ---- 11. the x-domain tier's block kernels vs plain on the card
    from parallel_finite_difference_computation_tpu_torch.parallel import (
        domain_kernels as dk, make_mesh)
    from parallel_finite_difference_computation_tpu_torch.parallel.domain \
        import embed_dobs

    def randn(rng, *shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    X_BLOCKS = (("block_mod", dk.block_mod_cuda, dk.block_mod),
                ("block_fwd", dk.block_fwd_cuda, dk.block_fwd),
                ("block_bwd", dk.block_bwd_cuda, dk.block_bwd))

    def block_errs(ms, rs, fields, imgs, amps, ks, blocks=X_BLOCKS):
        """(max rel err, max abs err) of each block kernel against its
        plain version on the same CUDA tensors, one launch a tile on the
        tile's states ``fields[j]`` (six (ns, nxw, nzw) tensors) and image
        ``imgs[j]`` for each step count in ``ks``: the modeling kernel
        with the Gaussian source and all-edge taper (tiles ``ms``) and with
        the point source and top taper (``rs``), the forward kernel, the
        backward kernel at trace row ks[0]; then the backward kernel seeded
        by fields 4 and 5 at row 0. ``blocks``: (name, wrapper, plain
        version) of the tier's modeling, forward and backward kernels."""
        (nm, km, pm), (nf, kf, pf), (nb, kb, pb) = blocks
        out = {}

        def note(name, e):
            old = out.get(name, (0.0, 0.0))
            out[name] = (max(old[0], e[0]), max(old[1], e[1]))

        for cm, cr, f, img in zip(ms, rs, fields, imgs):
            for kk in ks:
                a = amps[:kk]
                for c in (cm, cr):
                    note(nm, errs(km(c, f[0], f[1], a), pm(c, f[0], f[1], a)))
                note(nf, errs(kf(cr, f[0], f[1], a), pf(cr, f[0], f[1], a)))
                note(nb, errs(kb(cr, *f[:4], img.clone(), ks[0], kk),
                              pb(cr, *f[:4], img, ks[0], kk)))
            if ks[0] > 1:
                note(nb, errs(kb(cr, *f[:4], img.clone(), 0, ks[0], f[4:6]),
                              pb(cr, *f[:4], img, 0, ks[0], f[4:6])))
        torch.cuda.synchronize()
        return out

    def compare_blocks(case, n_x: int, k: int):
        """:func:`block_errs` on random states of every slab of an x mesh
        of n_x slabs, with k steps and a tail of k - 1."""
        ctx_m, ctx_r, v2_m, v2_r, _, _, d, gp = case
        rng = np.random.default_rng(n_x * 10 + k)
        amps = rng.standard_normal(k).astype(np.float32)
        ms = dk.prepare_slabs(ctx_m, [dev] * n_x, k, v2_m, "all", sxs=gp.sx,
                              sz=gp.sz, source="gaussian", gz=gp.gz)
        rs = dk.prepare_slabs(ctx_r, [dev] * n_x, k, v2_r, "top", sxs=gp.sx,
                              sz=gp.sz, dobs_ext=embed_dobs(
                                  ctx_r, d.cpu().numpy()), gz=gp.gz)
        fields = [[randn(rng, c.ns, c.nxw, ctx_m.nze) for _ in range(6)]
                  for c in ms]
        imgs = [randn(rng, c.ns, c.nxl, ctx_m.nze) for c in ms]
        return block_errs(ms, rs, fields, imgs, amps,
                          (k, k - 1) if k > 1 else (k,))

    def compare_makers(case, n_x: int, k: int):
        """The two makers on a (2, n_x) mesh of cuda:0, and on one whose
        positions alternate between cuda:0 and the CPU (the exchange copies
        between devices), against the same makers on a CPU mesh (the plain
        block functions): the edge slabs' zero halos, the exchange, nxe
        padded to a multiple of n_x. Returns the larger error."""
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp = case
        d_ext = embed_dobs(ctx_r, d.cpu().numpy())
        out = []
        for devices in ([dev] * (2 * n_x), [dev, "cpu"] * n_x,
                        ["cpu"] * (2 * n_x)):
            mesh = make_mesh(2, n_x, devices=devices)
            out.append((
                dk.make_sharded_forward_modeling_cuda(
                    ctx_m, mesh, gp.sz, gp.gz, block_k=k)(
                    v2_m, gp.sx, wav_m).cpu(),
                dk.make_sharded_rtm_snapshot_cuda(
                    ctx_r, mesh, gp.sz, gp.gz, block_k=k)(
                    v2_r, gp.sx, wav_r, d_ext).cpu()))
        e = [errs(got, out[2]) for got in out[:2]]
        return max(e[0][0], e[1][0]), max(e[0][1], e[1][1])

    # 120 x 70 + borders 7, 9: 134 x 88, no multiple of x = 4 (padded to
    # 136) nor of the 32 x 64 tiles; two shots around the first slab edge,
    # the source at z = 62 and the receiver row at z = 63, across a tile
    # edge; nt = 21: tails for every K
    dom = Params(nz=70, nx=120, nt=21, dz=10.0, dx=10.0, dt=0.001,
                 fpeak=30.0, ns=2, sz=53, fsx=33, ds=1, gz=54, nxb=7,
                 nzb=9, fac=0.7, order=8)
    block_err = {k: 0.0 for k in ("block_mod", "block_fwd", "block_bwd")}
    n_cases = 0
    for order in (4, 8, 10):
        case = tier_case(dataclasses.replace(dom, order=order))
        for n_x in (2, 4):
            nxl = -(-dom.nxe // n_x)
            case_x = case[:7] + (dataclasses.replace(
                case[7], sx=(nxl - 1, nxl)),)
            for k in (2, 3, 8):
                if k * order // 2 > nxl:
                    continue
                for kname, (rel, absd) in {
                        **compare_blocks(case_x, n_x, k),
                        "makers (cuda:0, mixed) vs CPU mesh":
                            compare_makers(case_x, n_x, k)}.items():
                    print(f"[domain vs plain] {kname} order {order} x "
                          f"{n_x} K {k} nt {dom.nt} {dom.nxe} x {dom.nze}: "
                          f"max rel err {rel:.3e}, max abs err {absd:.3e}",
                          flush=True)
                    check(rel <= GATE, f"{kname} order {order} x {n_x} K "
                                       f"{k}: {rel:.3e} > {GATE}")
                    check(kname not in block_err or absd == 0,
                          f"{kname} order {order} x {n_x} K {k} is not "
                          f"bitwise")
                    if kname in block_err:
                        block_err[kname] = max(block_err[kname], absd)
                n_cases += 1
    print(f"[domain vs plain] {n_cases} cases; max abs err {block_err}",
          flush=True)
    phase_done("domain kernels vs plain")

    # ---- 12. the 3lay path over meshes on cuda:0, against the no-mesh run
    for shape in ((2, 1), (2, 2), (1, 4)):
        mesh = make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        dk.reset_launches()
        fk.reset_launches()
        t0 = time.perf_counter()
        data_m = pipeline.run_modeling(P, vp=vp, mesh=mesh)
        img_m3, locs_m3 = pipeline.run_rtm_gpu(P, vp=vp, dobs=data_m, seed=0,
                                               mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rr3 = (rel_rms(data_m, data), rel_rms(img_m3, img),
               rel_rms(locs_m3, imlocs))
        print(f"[3lay mesh path] mesh {shape}: run_modeling + run_rtm_gpu "
              f"{wall:.3f} s wall; block launches {dict(dk.LAUNCHES)}; vs "
              f"the no-mesh per-step run: gathers rel RMS {rr3[0]:.3e}, image "
              f"{rr3[1]:.3e}, per-shot images {rr3[2]:.3e}", flush=True)
        check(max(rr3) <= GATE, f"3lay mesh {shape} differs")
        exact_n = [n for k, n in dk.LAUNCHES.items() if not k.endswith("_mma")]
        check((shape[1] > 1) == all(exact_n) and sum(exact_n) == sum(
            dk.LAUNCHES.values()), f"mesh {shape}: block launches "
                                   f"{dk.LAUNCHES}")
        # a shot-only mesh runs the resident kernels once a shot group
        fk_n = {k: n for k, n in fk.LAUNCHES.items() if n}
        want = ({} if shape[1] > 1 else dict.fromkeys(
            ("mod_cluster", "rtm_fwd_cluster", "rtm_bwd_cluster"), shape[0]))
        check(fk_n == want, f"mesh {shape}: launches {fk_n}, expected {want}")
    phase_done("3lay mesh path")

    # ---- 13. the Pluto path over a (1, 4) mesh of cuda:0: four x-slabs,
    # nt = 4500 (cut from 12860 for time), against the per-step tier at the
    # same nt
    pl45 = Params(**dict(PLUTO, nt=4500))
    dat45 = pipeline.run_modeling(pl45, vp=vp_pl, device=dev,
                                  backend="pallas")
    pluto_ref = (dat45, *pipeline.run_rtm_gpu(pl45, vp=vp_pl, dobs=dat45,
                                              seed=0, device=dev,
                                              backend="pallas"))
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    fk.reset_launches()
    stream.reset_launches()
    dk.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dat_d = pipeline.run_modeling(pl45, vp=vp_pl, mesh=mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img_d, locs_d = pipeline.run_rtm_gpu(pl45, vp=vp_pl, dobs=dat_d,
                                             seed=0, outdir=tmp, mesh=mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        written = np.fromfile(os.path.join(tmp, "dir.image"), np.float32)
    launches = dict(dk.LAUNCHES)
    print(f"[Pluto domain path] mesh (1, 4) on cuda:0 ({pl45.nxe} x "
          f"{pl45.nze}, nt {pl45.nt} (cut from {PLUTO['nt']}), ns "
          f"{pl45.ns}, K 8): run_modeling {t1 - t0:.3f} s wall "
          f"({(t1 - t0) / pl45.ns:.3f} s/shot), run_rtm_gpu {t2 - t1:.3f} s "
          f"wall ({(t2 - t1) / pl45.ns:.3f} s/shot), host included; launches "
          f"{launches}; {smi}", flush=True)
    for k in launches:
        want = 0 if k.endswith("_mma") else block_launches(k, pl45.nt, 8, 4)
        if want:
            results[k]["launches"] = launches[k]
        check(launches[k] == want, f"{k} launched {launches[k]} times, "
                                   f"expected {want}")
    check(not any(fk.LAUNCHES.values()) and not any(stream.LAUNCHES.values()),
          f"the domain path launched other kernels: {fk.LAUNCHES}, "
          f"{stream.LAUNCHES}")
    check(written.tobytes() == img_d.tobytes() and np.isfinite(img_d).all()
          and np.abs(img_d).max() > 0, "domain dir.image wrong or zero")
    rr = [rel_rms(a, b) for a, b in zip((dat_d, img_d, locs_d), pluto_ref)]
    digests = [digest(a) for a in (dat_d, img_d, locs_d)]
    print(f"[Pluto domain path] vs the per-step tier: gathers rel RMS "
          f"{rr[0]:.3e}, image rel RMS {rr[1]:.3e}, per-shot images rel RMS "
          f"{rr[2]:.3e}; SHA-256 of the gathers, image, per-shot images "
          f"{', '.join(digests)}", flush=True)
    check(max(rr) <= GATE, "the Pluto domain path differs")
    del dat_d
    phase_done("Pluto domain path")

    # ---- 14. times, kernel and plain in turns
    ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r = shapes(8, P.nt)
    d = torch.from_numpy(data).to(dev)
    snaps = fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz)
    swf = fk.forward_modeling_cuda(ctx_c, v2_c, wav_c, g.sx, g.sz, g.gz,
                                   source="point", taper="top",
                                   record="wavefield")[2]
    rec_fwd = lambda fn: (lambda: fn(ctx_c, v2_c, wav_c, g.sx, g.sz, g.gz,
                                     source="point", taper="top",
                                     record="wavefield"))
    rec_fwd_step = lambda: fk._forward_modeling(
        ctx_c, v2_c, wav_c, g.sx, g.sz, g.gz, "point", "top", "wavefield", 0,
        per_step=True)
    cases = {
        # the exact modeling's two routes, in turns with the plain version:
        # the resident kernel and the per-step one (forced)
        "mod_cluster": (
            lambda: fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz),
            lambda: solver.forward_modeling(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz),
            lambda: fk._forward_modeling(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz,
                                         "gaussian", "all", "trace", 0,
                                         per_step=True)),
        # the exact RTM's two routes, in turns with one plain version:
        # the resident kernels and the per-step ones (forced)
        "rtm_fwd_cluster": (
            lambda: fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz),
            lambda: solver.fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz),
            lambda: fk._fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz, 0,
                                   per_step=True)),
        "rtm_bwd_cluster": (
            lambda: fk.fd_back_cuda(ctx_r, v2_r, *snaps, d, g.gz),
            lambda: solver.fd_back(ctx_r, v2_r, *snaps, d, g.gz),
            lambda: fk._fd_back(ctx_r, v2_r, *snaps, d, g.gz, 0,
                                per_step=True)),
        "rtm": (
            lambda: fk.rtm_snapshot_cuda(ctx_r, v2_r, wav_r, d, g.sx, g.sz, g.gz),
            lambda: solver.rtm_shot_snapshot(ctx_r, v2_r, wav_r, d, g.sx, g.sz, g.gz),
            lambda: fk._fd_back(ctx_r, v2_r, *fk._fd_forward(
                ctx_r, v2_r, wav_r, g.sx, g.sz, 0, per_step=True), d, g.gz,
                0, per_step=True)),
        "rec_fwd_cluster": (rec_fwd(fk.forward_modeling_cuda),
                            rec_fwd(solver.forward_modeling), rec_fwd_step),
        # rtm_main's backward in image mode (the main path's) and in frame
        # mode: the resident kernel and the per-step one (forced)
        "rec_bwd_cluster": (
            lambda: fk.backward_image_cuda(ctx_c, v2_c, swf, d_c, g.gz,
                                           next_shot_first=nxt_c),
            lambda: solver.backward_image(ctx_c, v2_c, swf, d_c, g.gz,
                                          next_shot_first=nxt_c),
            lambda: fk._rec_bwd(ctx_c, v2_c, d_c, g.gz, True, nxt_c, 0,
                                swf=swf, per_step=True)),
        "rec_bwd_cluster frames": (
            lambda: fk.backward_recorded_cuda(ctx_c, v2_c, d_c, g.gz,
                                              next_shot_first=nxt_c),
            lambda: solver.backward_recorded(ctx_c, v2_c, d_c, g.gz,
                                             next_shot_first=nxt_c),
            lambda: fk._rec_bwd(ctx_c, v2_c, d_c, g.gz, True, nxt_c, 0,
                                per_step=True)),
        "rtm_main": (
            lambda: fk.rtm_full_cuda(ctx_c, v2_c, wav_c, d_c, g.sx, g.sz,
                                     g.gz, next_shot_first=nxt_c),
            lambda: solver.rtm_shot_full(ctx_c, v2_c, wav_c, d_c, g.sx, g.sz,
                                         g.gz, next_shot_first=nxt_c),
            lambda: fk._rec_bwd(ctx_c, v2_c, d_c, g.gz, True, nxt_c, 0,
                                swf=rec_fwd_step()[2], per_step=True)),
    }

    times = {}
    for k, (kern, plain, *step) in cases.items():
        tk, tp, *ts = in_turns([kern, plain, *step])
        times[k] = (tk, tp, *ts)
        also = (f", per-step route {span(ts[0])}" if ts else "")
        print(f"[times] {k}: kernel {span(tk)}, plain {span(tp)}{also} per "
              f"call of {P.ns} shots x {P.nt} steps; {smi}", flush=True)
        if k in results:
            results[k]["ms"] = statistics.median(tk)
            results[k]["plain_ms"] = statistics.median(tp)
        if k.endswith("_cluster"):
            step_name = k.replace("_cluster", "_step")
            results[step_name]["ms"] = statistics.median(ts[0])
            results[step_name]["plain_ms"] = statistics.median(tp)
    del swf
    for label, k in (("modeling", "mod_cluster"), ("RTM", "rtm"),
                     ("rtm_main", "rtm_main")):
        tk, tp, *ts = times[k]
        also = (f", the per-step route "
                f"{statistics.median(ts[0]) / 1e3 / P.ns:.6f}" if ts else "")
        print(f"[times] 3lay {label} s/shot (8-shot batch): kernel "
              f"{statistics.median(tk) / 1e3 / P.ns:.6f}{also}, plain "
              f"{statistics.median(tp) / 1e3 / P.ns:.6f}; {smi}")
    for k, (bms, by) in step_bounds(ctx_c, P.ns).items():
        for name in (k, k.replace("_step", "_cluster")):
            if name in results:
                results[name]["bound_ms"], results[name]["bound_by"] = bms, by
                results[name]["library_ms"] = None

    # the stencil: kernel, plain, and conv2d with the same taps (cuDNN in
    # full float32: TF32 off), 10 calls per sample
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, p in grids.items():
        order, h = 8, 4
        cx, cz = numerics.scaled_coefficients(order, p.dx, p.dz)
        f = fields[label]
        w = torch.zeros((1, 1, order + 1, order + 1), device=dev)
        w[0, 0, h, :] = torch.from_numpy(cz).to(dev)
        w[0, 0, :, h] += torch.from_numpy(cx).to(dev)
        conv = lambda: torch.nn.functional.conv2d(f[None, None], w)
        got = fk.laplacian_cuda(f, cx, cz, order)
        rel_conv = max_rel(conv()[0, 0], got[h:-h, h:-h])
        tk, tp, tl = in_turns([lambda: fk.laplacian_cuda(f, cx, cz, order),
                               lambda: stencil.laplacian(f, cx, cz, order),
                               conv], reps=10)
        bms, by = bound(2 * 4 * p.nxe * p.nze,
                        (p.nxe - 2 * h) * (p.nze - 2 * h) * lap_flops(h))
        print(f"[times] lap_apply {label} order {order}: kernel {span(tk)}, "
              f"plain {span(tp)}, conv2d {span(tl)} (max rel diff to the "
              f"kernel {rel_conv:.3e}); bound {bms:.4f} ms ({by}); {smi}",
              flush=True)
        if label == "8192 x 8192":
            results["lap_apply"].update(
                ms=statistics.median(tk), plain_ms=statistics.median(tp),
                library_ms=statistics.median(tl), bound_ms=bms, bound_by=by)
    # lap_apply at orders 4 and 16 at 8192 x 8192 beside their bounds (the
    # same bytes; more flop at 16)
    p, f = grids["8192 x 8192"], fields["8192 x 8192"]
    for order in (4, 16):
        h = order // 2
        cx, cz = numerics.scaled_coefficients(order, p.dx, p.dz)
        tk, = in_turns([lambda: fk.laplacian_cuda(f, cx, cz, order)],
                       reps=10)
        bms, by = bound(2 * 4 * p.nxe * p.nze,
                        (p.nxe - 2 * h) * (p.nze - 2 * h) * lap_flops(h))
        print(f"[times] lap_apply 8192 x 8192 order {order}: kernel "
              f"{span(tk)}; bound {bms:.4f} ms ({by}), kernel / bound "
              f"{statistics.median(tk) / bms:.2f}; {smi}", flush=True)

    # the large-grid tier at the Pluto grid, 2 shots, nt=1001: each K-step
    # kernel's passes (constants prepared once, as the tiled loops do), its
    # plain passes, and the per-step kernel call for the same function,
    # the yardstick (no one PyTorch call runs a K-step loop); gpu_step one
    # launch, 10 calls a sample, against one rtm_bwd_step launch
    pt = Params(**dict(PLUTO, nt=1001))
    K = 4
    (ctx_pm, ctx_pr, v2_pm, v2_pr, wav_pm, wav_pr, d_p,
     gp) = tier_case(pt, PLUTO_VELOCITIES)
    cm = stream.prepare(ctx_pm, v2_pm, gp.sx, source="gaussian", taper="all")
    cr = stream.prepare(ctx_pr, v2_pr, gp.sx, source="point", taper="top")
    zero = torch.zeros((pt.ns, pt.nxe, pt.nze), device=dev)
    snaps_p = fk.fd_forward_cuda(ctx_pr, v2_pr, wav_pr, gp.sx, gp.sz)
    inj_p = d_p.flip(-1).transpose(1, 2).contiguous()
    seeded = solver._seed_steps(ctx_pr, v2_pr, *snaps_p, inj_p, gp.gz)

    def mod_passes(kernel: bool):
        fn = (functools.partial(stream.mod_kstep_cuda, consts=cm) if kernel
              else solver.mod_kstep)

        def run():
            p, pp = zero, zero
            for it0 in range(0, pt.nt, K):
                p, pp, _ = fn(ctx_pm, p, pp, v2_pm, wav_pm[it0:it0 + K],
                              gp.sx, gp.sz, gp.gz)
        return run

    def fwd_passes(kernel: bool):
        fn = (functools.partial(stream.fd_forward_kstep_cuda, consts=cr)
              if kernel else solver.fd_forward_kstep)

        def run():
            p, pp = zero, zero
            for it0 in range(0, pt.nt, K):
                p, pp = fn(ctx_pr, p, pp, v2_pr, wav_pr[it0:it0 + K], gp.sx,
                           gp.sz)
        return run

    def bwd_passes(kernel: bool):
        fn = (functools.partial(stream.fd_back_kstep_cuda, consts=cr)
              if kernel else solver.fd_back_kstep)

        def run():
            state = seeded[:4] + (seeded[4].clone(),)
            for it0 in range(0, pt.nt, K):
                state = fn(ctx_pr, *state, v2_pr, inj_p[:, it0:it0 + K],
                           gp.gz)
        return run

    img_t = seeded[4].clone()
    row0 = inj_p[:, 0]
    ctx_1 = dataclasses.replace(ctx_pr, nt=1)
    d_1 = d_p[:, :, :1].contiguous()
    tier_cases = {
        "kstep_mod": (mod_passes(True), mod_passes(False),
                      lambda: fk.forward_modeling_cuda(
                          ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz), 1),
        "kstep_gpu_fwd": (fwd_passes(True), fwd_passes(False),
                          lambda: fk.fd_forward_cuda(ctx_pr, v2_pr, wav_pr,
                                                     gp.sx, gp.sz), 1),
        "kstep_gpu_bwd": (bwd_passes(True), bwd_passes(False),
                          lambda: fk.fd_back_cuda(ctx_pr, v2_pr, *snaps_p,
                                                  d_p, gp.gz), 1),
        "gpu_step": (lambda: stream.fd_step_gpu_cuda(
                         ctx_pr, *snaps_p, v2_pr, gp.gz, row0, img_t,
                         seeded[0], consts=cr),
                     lambda: solver.fd_step_gpu(
                         ctx_pr, *snaps_p, v2_pr, gp.gz, row0, img_t,
                         seeded[0]),
                     lambda: fk.fd_back_cuda(ctx_1, v2_pr, *snaps_p, d_1,
                                             gp.gz), 10),
    }
    bounds = kstep_bounds(ctx_pr, pt.ns, K)
    for k, (kern, plain, per_step, reps) in tier_cases.items():
        tk, tp, ts = in_turns([kern, plain, per_step], reps=reps, once=(1,))
        bms, by = bounds[k]
        what = ("one call" if k == "gpu_step"
                else f"{-(-pt.nt // K)} passes of K={K}")
        strip = next((f" ({t}, row {row})" for t, (w, row)
                      in STRIP_TEMPLATES.items() if w == k), "")
        print(f"[times] {k}{strip} at the Pluto grid ({pt.ns} shots, nt "
              f"{pt.nt}, "
              f"{what}): kernel {span(tk)}, plain {span(tp)}, per-step "
              f"kernel {span(ts)}; bound {bms:.3f} ms ({by}), kernel / "
              f"bound {statistics.median(tk) / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)
    del tier_cases, seeded, img_t

    # the two tiers' whole calls at the Pluto grid, nt=1001, in turns
    pluto_calls = {
        "modeling tiled": lambda: solver.forward_modeling_tiled(
            ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz, block_k=K),
        "modeling per-step": lambda: fk.forward_modeling_cuda(
            ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz),
        "RTM tiled": lambda: solver.rtm_shot_snapshot_tiled(
            ctx_pr, v2_pr, wav_pr, d_p, gp.sx, gp.sz, gp.gz, block_k=K),
        "RTM per-step": lambda: fk.rtm_snapshot_cuda(
            ctx_pr, v2_pr, wav_pr, d_p, gp.sx, gp.sz, gp.gz),
    }
    pluto_ms = {}
    for pair in (("modeling tiled", "modeling per-step"),
                 ("RTM tiled", "RTM per-step")):
        ts = in_turns([pluto_calls[c] for c in pair])
        for c, t in zip(pair, ts):
            pluto_ms[c] = statistics.median(t)
            print(f"[times] Pluto {c} ({pt.ns} shots, nt {pt.nt}): {span(t)}"
                  f", {pluto_ms[c] / 1e3 / pt.ns:.6f} s/shot, "
                  f"{pluto_ms[c] / 1e3 / pt.ns * PLUTO['nt'] / pt.nt:.3f} "
                  f"s/shot scaled to nt {PLUTO['nt']}; {smi}", flush=True)

    # the x-domain tier at the Pluto grid over a (1, 4) mesh of cuda:0, 2
    # shots, nt=1001, K=8: each block kernel's launches on fixed random
    # states of the four slabs (no exchange), its plain version's, and the
    # per-step kernel call for the same function, the yardstick; then the
    # two makers' whole calls (slab set-up and exchange included) in turns
    # with the per-step calls
    KD = 8
    mesh4 = make_mesh(1, 4, devices=[dev] * 4)
    d_ext_p = embed_dobs(ctx_pr, d_p.cpu().numpy())
    ms_p = dk.prepare_slabs(ctx_pm, [dev] * 4, KD, v2_pm, "all", sxs=gp.sx,
                            sz=gp.sz, source="gaussian", gz=gp.gz)
    rs_p = dk.prepare_slabs(ctx_pr, [dev] * 4, KD, v2_pr, "top", sxs=gp.sx,
                            sz=gp.sz, dobs_ext=d_ext_p, gz=gp.gz)
    rng = np.random.default_rng(11)
    st_p = [[randn(rng, pt.ns, c.nxw, pt.nze) for _ in range(6)]
            for c in rs_p]
    imgs_p = [randn(rng, pt.ns, c.nxl, pt.nze) for c in rs_p]
    # the block kernels against their plain versions at the shapes the
    # Pluto domain path gives them: each slab of the (1, 4) mesh, K = 8,
    # the tails of nt = 4500 (4) and of nt = 1001 (1), the seeded block
    amps_p = rng.standard_normal(KD).astype(np.float32)
    for kname, (rel, absd) in block_errs(ms_p, rs_p, st_p, imgs_p, amps_p,
                                         (KD, 4, 1)).items():
        print(f"[domain vs plain] {kname} at the Pluto grid ({pt.nxe} x "
              f"{pt.nze}, {pt.ns} shots, 4 slabs of {rs_p[0].nxw} rows, "
              f"K {KD}, 4, 1): max rel err {rel:.3e}, max abs err "
              f"{absd:.3e}", flush=True)
        check(rel <= GATE, f"{kname} at the Pluto grid: {rel:.3e} > {GATE}")
        check(absd == 0, f"{kname} at the Pluto grid is not bitwise")
        results[kname]["max_abs_err"] = max(block_err[kname], absd)

    outs_p = [[torch.zeros_like(st_p[j][0]) for _ in range(4)]
              for j in range(4)]

    def block_runner(blocks, ms, rs, st, imgs, outs):
        """``run(i, kernel)``: a function that runs block kernel i of
        ``blocks`` (0 modeling, 1 forward, 2 backward), or its plain
        version, over ``pt.nt`` steps in blocks of KD on every tile, from
        the fixed states ``st`` and images ``imgs``; the kernels write into
        the output buffers ``outs``, made once, as the makers do."""
        def run(i: int, kernel: bool):
            fn = blocks[i][1 if kernel else 2]
            n_out = 4 if i == 2 else 2

            def go():
                for it0 in range(0, pt.nt, KD):
                    k = min(KD, pt.nt - it0)
                    for j in range(len(ms)):
                        out = {"out": outs[j][:n_out]} if kernel else {}
                        if i == 0:
                            fn(ms[j], *st[j][:2], wav_pm[it0:it0 + k], **out)
                        elif i == 1:
                            fn(rs[j], *st[j][:2], wav_pr[it0:it0 + k], **out)
                        else:
                            fn(rs[j], *st[j][:4], imgs[j], it0, k, **out)
            return go
        return run

    block_run = block_runner(X_BLOCKS, ms_p, rs_p, st_p, imgs_p, outs_p)

    per_step = {
        "block_mod": lambda: fk.forward_modeling_cuda(
            ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz),
        "block_fwd": lambda: fk.fd_forward_cuda(ctx_pr, v2_pr, wav_pr, gp.sx,
                                                gp.sz),
        "block_bwd": lambda: fk.fd_back_cuda(ctx_pr, v2_pr, *snaps_p, d_p,
                                             gp.gz)}
    bounds = {**block_bounds(ctx_pr, pt.ns, KD, 4),
              "block_mod": block_bounds(ctx_pm, pt.ns, KD, 4)["block_mod"]}
    for i, k in enumerate(("block_mod", "block_fwd", "block_bwd")):
        tk, tp, ts = in_turns([block_run(i, True), block_run(i, False),
                               per_step[k]], once=(1,))
        bms, by = bounds[k]
        print(f"[times] {k} at the Pluto grid ({pt.ns} shots, nt {pt.nt}, 4 "
              f"slabs, {4 * -(-pt.nt // KD)} blocks of K={KD}): kernel "
              f"{span(tk)}, plain {span(tp)}, per-step kernel {span(ts)}; "
              f"bound {bms:.3f} ms ({by}), kernel / bound "
              f"{statistics.median(tk) / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)
    del st_p, imgs_p, outs_p, ms_p, rs_p
    dmod = dk.make_sharded_forward_modeling_cuda(ctx_pm, mesh4, gp.sz, gp.gz,
                                                 block_k=KD)
    drtm = dk.make_sharded_rtm_snapshot_cuda(ctx_pr, mesh4, gp.sz, gp.gz,
                                             block_k=KD)
    pluto_calls["modeling domain"] = lambda: dmod(v2_pm, gp.sx, wav_pm)
    pluto_calls["RTM domain"] = lambda: drtm(v2_pr, gp.sx, wav_pr, d_ext_p)
    for pair in (("modeling domain", "modeling per-step"),
                 ("RTM domain", "RTM per-step")):
        ts = in_turns([pluto_calls[c] for c in pair])
        for c, t in zip(pair, ts):
            pluto_ms[c] = statistics.median(t)
            print(f"[times] Pluto {c} ({pt.ns} shots, nt {pt.nt}; mesh (1, 4) "
                  f"of cuda:0 for the domain tier): {span(t)}, "
                  f"{pluto_ms[c] / 1e3 / pt.ns:.6f} s/shot; {smi}", flush=True)

    phase_done("times")

    # ---- 15. one profiler trace of each timed call
    f = fields["8192 x 8192"]
    cx, cz = numerics.scaled_coefficients(8, 10.0, 10.0)
    stencil_call = lambda: fk.laplacian_cuda(f, cx, cz, 8)
    for label, fn, ms in (
            ("modeling", cases["mod_cluster"][0],
             results["mod_cluster"]["ms"]),
            ("modeling per-step route", cases["mod_cluster"][2],
             results["mod_step"]["ms"]),
            ("RTM", cases["rtm"][0], statistics.median(times["rtm"][0])),
            ("RTM per-step route", cases["rtm"][2],
             statistics.median(times["rtm"][2])),
            ("rtm_main", cases["rtm_main"][0],
             statistics.median(times["rtm_main"][0])),
            ("rtm_main per-step route", cases["rtm_main"][2],
             statistics.median(times["rtm_main"][2])),
            ("stencil 8192 x 8192", stencil_call,
             results["lap_apply"]["ms"]),
            *((f"Pluto {c}", pluto_calls[c], pluto_ms[c])
              for c in pluto_calls)):
        rows = profile(torch, label, fn, ms, smi)
        if "domain" in label:
            # copy kernels on the card: the halo exchange, with the trace
            # rows and the slab set-up; not the host <-> device copies
            copies = sum(t for key, t, _ in rows if "copy" in key.lower()
                         and "HtoD" not in key and "DtoH" not in key
                         and "CatArray" not in key)
            fills = sum(t for key, t, _ in rows if "Fill" in key)
            print(f"[profile] {label}: copy kernels (halo exchange, trace "
                  f"rows, slab set-up) {copies:.3f} ms, share of the call "
                  f"{copies / ms:.3f}; fills (buffers zeroed once a call) "
                  f"{fills:.3f} ms, share {fills / ms:.3f}; {smi}",
                  flush=True)
    phase_done("profile")

    # ---- 16. the (x, z) tier's block kernels vs plain on the card
    from parallel_finite_difference_computation_tpu_torch.parallel import (
        domain2d_kernels as d2k)
    XZ_BLOCKS = (("block2_mod", d2k.block2_mod_cuda, d2k.block2_mod),
                 ("block2_fwd", d2k.block2_fwd_cuda, d2k.block2_fwd),
                 ("block2_bwd", d2k.block2_bwd_cuda, d2k.block2_bwd))

    def xz_tiles(case, shape, k, devices):
        """The modeling tiles (Gaussian source, all-edge taper) and the
        RTM tiles (point source, top taper, trace rows) of shot group 0 of
        a mesh of ``shape`` over ``devices``, blocks of k steps."""
        ctx_m, ctx_r, v2_m, v2_r, _, _, d, gp_ = case
        geom = d2k.tile_geometry(ctx_m, shape[1], shape[2], k)
        grid = make_mesh(*shape, devices=devices).grid(0)
        return (d2k.prepare_tiles(ctx_m, grid, geom, v2_m, "all", sxs=gp_.sx,
                                  sz=gp_.sz, source="gaussian", gz=gp_.gz),
                d2k.prepare_tiles(ctx_r, grid, geom, v2_r, "top", sxs=gp_.sx,
                                  sz=gp_.sz, gz=gp_.gz, dobs_ext=embed_dobs(
                                      ctx_r, d.cpu().numpy())))

    def compare_blocks2(case, shape, k):
        """:func:`block_errs` of the (x, z) kernels on random states of
        every tile of a mesh of ``shape`` on cuda:0, k steps and a tail of
        k - 1."""
        ms, rs = xz_tiles(case, shape, k, [dev] * (shape[1] * shape[2]))
        rng = np.random.default_rng(shape[1] * 100 + shape[2] * 10 + k)
        amps = rng.standard_normal(k).astype(np.float32)
        fields = [[randn(rng, c.ns, c.nxw, c.nzw) for _ in range(6)]
                  for c in ms]
        imgs = [randn(rng, c.ns, c.nxl, c.nzl) for c in ms]
        return block_errs(ms, rs, fields, imgs, amps,
                          (k, k - 1) if k > 1 else (k,), XZ_BLOCKS)

    def compare_makers2(case, shape, k):
        """The two (x, z) makers on a (2, x, z) mesh of cuda:0, and on one
        whose positions alternate between cuda:0 and the CPU along both
        grid axes (the two-stage exchange between devices), against the
        same makers on a CPU mesh. Returns the larger error."""
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp_ = case
        d_ext = embed_dobs(ctx_r, d.cpu().numpy())
        n = 2 * shape[1] * shape[2]
        out = []
        for devices in ([dev] * n, [dev, "cpu", "cpu", dev] * (n // 4),
                        ["cpu"] * n):
            mesh = make_mesh(2, shape[1], shape[2], devices=devices)
            out.append((
                d2k.make_sharded_forward_modeling_2d_cuda(
                    ctx_m, mesh, gp_.sz, gp_.gz, block_k=k)(
                    v2_m, gp_.sx, wav_m).cpu(),
                d2k.make_sharded_rtm_snapshot_2d_cuda(
                    ctx_r, mesh, gp_.sz, gp_.gz, block_k=k)(
                    v2_r, gp_.sx, wav_r, d_ext).cpu()))
        e = [errs(got, out[2]) for got in out[:2]]
        return max(e[0][0], e[1][0]), max(e[0][1], e[1][1])

    # phase 11's 134 x 88 grid, the sources at x = 66 and 67 (across the x
    # cut of a (1, 2, 2) mesh at 67), the Gaussian band at z = 40..46
    # (across the z cut at 44 of both meshes), the receiver row at z = 46
    # (in the second z part of (1, 2, 2), the third of (1, 1, 4))
    dom2 = dataclasses.replace(dom, sz=34, gz=37)
    block2_err = {k: 0.0 for k in ("block2_mod", "block2_fwd", "block2_bwd")}
    n_cases = 0
    for order in (4, 8, 10):
        case = tier_case(dataclasses.replace(dom2, order=order))
        case = case[:7] + (dataclasses.replace(case[7], sx=(66, 67)),)
        for shape in ((1, 2, 2), (1, 1, 4)):
            nxl = -(-dom2.nxe // shape[1])
            nzl = -(-dom2.nze // shape[2])
            for k in (2, 3, 8):
                halo = k * order // 2
                if (shape[1] > 1 and halo > nxl) or halo > nzl:
                    continue
                for kname, (rel, absd) in {
                        **compare_blocks2(case, shape, k),
                        "makers (cuda:0, mixed) vs CPU mesh":
                            compare_makers2(case, shape, k)}.items():
                    print(f"[(x, z) vs plain] {kname} order {order} mesh "
                          f"{shape} K {k} nt {dom2.nt} {dom2.nxe} x "
                          f"{dom2.nze}: max rel err {rel:.3e}, max abs err "
                          f"{absd:.3e}", flush=True)
                    check(rel <= GATE, f"{kname} order {order} mesh {shape}"
                                       f" K {k}: {rel:.3e} > {GATE}")
                    check(kname not in block2_err or absd == 0,
                          f"{kname} order {order} mesh {shape} K {k} is "
                          f"not bitwise")
                    if kname in block2_err:
                        block2_err[kname] = max(block2_err[kname], absd)
                n_cases += 1
    print(f"[(x, z) vs plain] {n_cases} cases; max abs err {block2_err}",
          flush=True)
    phase_done("(x, z) kernels vs plain")

    # ---- 17. the 3lay path over (x, z) meshes of cuda:0
    for shape in ((2, 2, 2), (1, 2, 2), (1, 1, 4)):
        mesh = make_mesh(*shape, devices=[dev] * int(np.prod(shape)))
        dk.reset_launches()
        d2k.reset_launches()
        t0 = time.perf_counter()
        data_m = pipeline.run_modeling(P, vp=vp, mesh=mesh)
        img_m3, locs_m3 = pipeline.run_rtm_gpu(P, vp=vp, dobs=data_m, seed=0,
                                               mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rr3 = (rel_rms(data_m, data), rel_rms(img_m3, img),
               rel_rms(locs_m3, imlocs))
        print(f"[3lay (x, z) mesh path] mesh {shape}: run_modeling + "
              f"run_rtm_gpu {wall:.3f} s wall; block launches "
              f"{dict(d2k.LAUNCHES)}; vs the no-mesh per-step run: gathers "
              f"rel RMS {rr3[0]:.3e}, image {rr3[1]:.3e}, per-shot images "
              f"{rr3[2]:.3e}", flush=True)
        check(max(rr3) <= GATE, f"3lay mesh {shape} differs")
        exact_n = [n for k, n in d2k.LAUNCHES.items() if not k.endswith("_mma")]
        check(all(exact_n) and sum(exact_n) == sum(d2k.LAUNCHES.values())
              and not any(dk.LAUNCHES.values()),
              f"mesh {shape}: block launches {d2k.LAUNCHES}, {dk.LAUNCHES}")
    phase_done("3lay (x, z) mesh path")

    # ---- 18. the Pluto path over a (1, 2, 2) mesh of cuda:0: four tiles
    mesh = make_mesh(1, 2, 2, devices=[dev] * 4)
    for lc in (fk, stream, dk, d2k):
        lc.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dat_z = pipeline.run_modeling(pl45, vp=vp_pl, mesh=mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img_z, locs_z = pipeline.run_rtm_gpu(pl45, vp=vp_pl, dobs=dat_z,
                                             seed=0, outdir=tmp, mesh=mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        written = np.fromfile(os.path.join(tmp, "dir.image"), np.float32)
    launches = dict(d2k.LAUNCHES)
    print(f"[Pluto (x, z) path] mesh (1, 2, 2) on cuda:0 ({pl45.nxe} x "
          f"{pl45.nze}, nt {pl45.nt} (cut from {PLUTO['nt']}), ns "
          f"{pl45.ns}, K 8): run_modeling {t1 - t0:.3f} s wall "
          f"({(t1 - t0) / pl45.ns:.3f} s/shot), run_rtm_gpu {t2 - t1:.3f} s "
          f"wall ({(t2 - t1) / pl45.ns:.3f} s/shot), host included; "
          f"launches {launches}; {smi}", flush=True)
    for k in launches:
        want = 0 if k.endswith("_mma") else block_launches(k, pl45.nt, 8, 4)
        if want:
            results[k]["launches"] = launches[k]
        check(launches[k] == want, f"{k} launched {launches[k]} times, "
                                   f"expected {want}")
    check(not any(fk.LAUNCHES.values()) and not any(stream.LAUNCHES.values())
          and not any(dk.LAUNCHES.values()),
          f"the (x, z) path launched other kernels: {fk.LAUNCHES}, "
          f"{stream.LAUNCHES}, {dk.LAUNCHES}")
    check(written.tobytes() == img_z.tobytes() and np.isfinite(img_z).all()
          and np.abs(img_z).max() > 0, "(x, z) dir.image wrong or zero")
    rr = [rel_rms(a, b) for a, b in zip((dat_z, img_z, locs_z), pluto_ref)]
    digests_z = [digest(a) for a in (dat_z, img_z, locs_z)]
    print(f"[Pluto (x, z) path] vs the per-step tier: gathers rel RMS "
          f"{rr[0]:.3e}, image rel RMS {rr[1]:.3e}, per-shot images rel RMS "
          f"{rr[2]:.3e}; SHA-256 of the gathers, image, per-shot images "
          f"{', '.join(digests_z)} (bitwise the x tier's: "
          f"{digests_z == digests})", flush=True)
    check(max(rr) <= GATE, "the Pluto (x, z) path differs")
    del dat_z, pluto_ref, dat45

    # the kernels at the Pluto tile shapes, 2 shots, nt=1001, K=8: held
    # against their plain versions (K = 8, the tails 4 of nt = 4500 and 1
    # of nt = 1001, the seeded block), then timed as phase 14 times the x
    # tier's, with the per-step kernel call for the same function
    geom_z = d2k.tile_geometry(ctx_pm, 2, 2, KD)
    grid_z = mesh.grid(0)
    ms_z = d2k.prepare_tiles(ctx_pm, grid_z, geom_z, v2_pm, "all", sxs=gp.sx,
                             sz=gp.sz, source="gaussian", gz=gp.gz)
    rs_z = d2k.prepare_tiles(ctx_pr, grid_z, geom_z, v2_pr, "top", sxs=gp.sx,
                             sz=gp.sz, dobs_ext=d_ext_p, gz=gp.gz)
    rng = np.random.default_rng(13)
    st_z = [[randn(rng, pt.ns, c.nxw, c.nzw) for _ in range(6)]
            for c in rs_z]
    imgs_z = [randn(rng, pt.ns, c.nxl, c.nzl) for c in rs_z]
    amps_z = rng.standard_normal(KD).astype(np.float32)
    for kname, (rel, absd) in block_errs(ms_z, rs_z, st_z, imgs_z, amps_z,
                                         (KD, 4, 1), XZ_BLOCKS).items():
        print(f"[(x, z) vs plain] {kname} at the Pluto grid ({pt.nxe} x "
              f"{pt.nze}, {pt.ns} shots, 4 tiles of {rs_z[0].nxw} x "
              f"{rs_z[0].nzw}, K {KD}, 4, 1): max rel err {rel:.3e}, max "
              f"abs err {absd:.3e}", flush=True)
        check(rel <= GATE, f"{kname} at the Pluto grid: {rel:.3e} > {GATE}")
        check(absd == 0, f"{kname} at the Pluto grid is not bitwise")
        results[kname]["max_abs_err"] = max(block2_err[kname], absd)
    outs_z = [[torch.zeros_like(st_z[j][0]) for _ in range(4)]
              for j in range(4)]
    run_z = block_runner(XZ_BLOCKS, ms_z, rs_z, st_z, imgs_z, outs_z)
    bounds = {**block_bounds(ctx_pr, pt.ns, KD, 2, 2, gp.gz),
              "block2_mod": block_bounds(ctx_pm, pt.ns, KD, 2, 2,
                                         gp.gz)["block2_mod"]}
    for i, k in enumerate(("block2_mod", "block2_fwd", "block2_bwd")):
        tk, tp, ts = in_turns([run_z(i, True), run_z(i, False),
                               per_step[k.replace("2", "")]], once=(1,))
        bms, by = bounds[k]
        print(f"[times] {k} at the Pluto grid ({pt.ns} shots, nt {pt.nt}, 4 "
              f"tiles of {rs_z[0].nxw} x {rs_z[0].nzw}, "
              f"{4 * -(-pt.nt // KD)} blocks of K={KD}): kernel "
              f"{span(tk)}, plain {span(tp)}, per-step kernel {span(ts)}; "
              f"bound {bms:.3f} ms ({by}), kernel / bound "
              f"{statistics.median(tk) / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)
    del st_z, imgs_z, outs_z, ms_z, rs_z
    zmod = d2k.make_sharded_forward_modeling_2d_cuda(ctx_pm, mesh, gp.sz,
                                                     gp.gz, block_k=KD)
    zrtm = d2k.make_sharded_rtm_snapshot_2d_cuda(ctx_pr, mesh, gp.sz, gp.gz,
                                                 block_k=KD)
    pluto_calls["modeling (x, z)"] = lambda: zmod(v2_pm, gp.sx, wav_pm)
    pluto_calls["RTM (x, z)"] = lambda: zrtm(v2_pr, gp.sx, wav_pr, d_ext_p)
    for pair in (("modeling (x, z)", "modeling per-step"),
                 ("RTM (x, z)", "RTM per-step")):
        ts = in_turns([pluto_calls[c] for c in pair])
        for c, t in zip(pair, ts):
            pluto_ms[c] = statistics.median(t)
            print(f"[times] Pluto {c} ({pt.ns} shots, nt {pt.nt}; mesh (1, 2, "
                  f"2) of cuda:0 for the (x, z) tier): {span(t)}, "
                  f"{pluto_ms[c] / 1e3 / pt.ns:.6f} s/shot; {smi}",
                  flush=True)
    for c in ("modeling (x, z)", "RTM (x, z)"):
        rows = profile(torch, f"Pluto {c}", pluto_calls[c], pluto_ms[c], smi)
        busy = sum(t for _, t, _ in rows)
        copies = sum(t for key, t, _ in rows if "copy" in key.lower()
                     and "HtoD" not in key and "DtoH" not in key
                     and "CatArray" not in key)
        print(f"[profile] Pluto {c}: copy kernels (the two-stage exchange, "
              f"trace rows, tile set-up) {copies:.3f} ms, share of the call "
              f"{copies / pluto_ms[c]:.3f}; idle share "
              f"{1 - busy / pluto_ms[c]:.3f}; {smi}", flush=True)
    phase_done("Pluto (x, z) path")

    # ---- 19. the per-step streaming kernels vs plain on the card
    def compare_stream(case, order):
        """(max rel err, max abs err) of fd_step (both tapers; no injection,
        the Gaussian window, the point source, the receiver row at nxb, at
        nzb and at nxe, which clamps to nxe - nx) and fd_update against
        their plain versions on random states; then the four tiled loops at
        K = 1 against the whole-grid plain loops (and rtm_shot_full_tiled
        against rtm_full_cuda), and forward_modeling_tiled's modes at K = 2
        (point source and top taper on kstep_mod; the Gaussian wavefield on
        rec_fwd_step)."""
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp_ = case
        rng = np.random.default_rng(order)
        p_, pp_ = randn(rng, 2, ctx_m.nxe, ctx_m.nze), randn(
            rng, 2, ctx_m.nxe, ctx_m.nze)
        row = randn(rng, 2, ctx_m.nx)
        out = {}

        def note(name, e):
            old = out.get(name, (0.0, 0.0))
            out[name] = (max(old[0], e[0]), max(old[1], e[1]))

        injections = [{}, dict(amp=0.7, sx=gp_.sx, sz=gp_.sz),
                      dict(amp=0.7, sx=gp_.sx, sz=gp_.sz, source="point")]
        injections += [dict(inj_row=row, x0=x0, gz=gp_.gz)
                       for x0 in (ctx_m.nxb, ctx_m.nzb, ctx_m.nxe)]
        for taper in ("all", "top"):
            for kw in injections:
                note("fd_step", errs(
                    stream.fd_step_cuda(ctx_m, p_, pp_, v2_m, taper, **kw),
                    solver.fd_step(ctx_m, p_, pp_, v2_m, taper, **kw)))
        note("fd_update", errs(stream.fd_update_cuda(ctx_r, p_, pp_, v2_r),
                               solver.fd_update(ctx_r, p_, pp_, v2_r)))
        args = (v2_m, wav_m, gp_.sx, gp_.sz, gp_.gz)
        note("forward_modeling_tiled K=1", errs(
            solver.forward_modeling_tiled(ctx_m, *args, block_k=1),
            solver.forward_modeling(ctx_m, *args)))
        mode = dict(source="point", taper="top", record="wavefield")
        note("forward_modeling_tiled K=1", errs(
            solver.forward_modeling_tiled(ctx_m, *args, **mode, block_k=1),
            solver.forward_modeling(ctx_m, *args, **mode)))
        nxt = torch.cat([d[1:, 0, 0], d.new_zeros(1)]).cpu().numpy()
        for quirk in (True, False):
            note("backward_recorded_tiled K=1", errs(
                solver.backward_recorded_tiled(ctx_m, v2_m, d, gp_.gz,
                                               x_off_quirk=quirk,
                                               next_shot_first=nxt),
                solver.backward_recorded(ctx_m, v2_m, d, gp_.gz,
                                         x_off_quirk=quirk,
                                         next_shot_first=nxt)))
        full = solver.rtm_shot_full_tiled(ctx_m, v2_m, wav_m, d, gp_.sx,
                                          gp_.sz, gp_.gz, next_shot_first=nxt)
        note("rtm_shot_full_tiled K=1 vs rtm_full_cuda", errs(
            full, fk.rtm_full_cuda(ctx_m, v2_m, wav_m, d, gp_.sx, gp_.sz,
                                   gp_.gz, next_shot_first=nxt)))
        note("rtm_shot_snapshot_tiled K=1", errs(
            solver.rtm_shot_snapshot_tiled(ctx_r, v2_r, wav_r, d, gp_.sx,
                                           gp_.sz, gp_.gz, block_k=1),
            solver.rtm_shot_snapshot(ctx_r, v2_r, wav_r, d, gp_.sx, gp_.sz,
                                     gp_.gz)))
        for mode in (dict(source="point", taper="top", record="trace"),
                     dict(source="gaussian", taper="all",
                          record="wavefield")):
            note("forward_modeling_tiled K=2, other modes", errs(
                solver.forward_modeling_tiled(ctx_m, *args, **mode,
                                              block_k=2),
                solver.forward_modeling(ctx_m, *args, **mode)))
        torch.cuda.synchronize()
        return out

    stream_err = {"fd_step": 0.0, "fd_update": 0.0}
    for order in (4, 8, 10, 12, 16):
        for name, (rel, absd) in compare_stream(
                tier_case(dataclasses.replace(short, order=order)),
                order).items():
            print(f"[stream vs plain] {name} order {order} nt {short.nt} 67 "
                  f"x 88 (nxb 7, nzb 9): max rel err {rel:.3e}, max abs err "
                  f"{absd:.3e}", flush=True)
            check(rel <= GATE, f"{name} order {order}: {rel:.3e} > {GATE}")
            if name in stream_err:
                stream_err[name] = max(stream_err[name], absd)
    # a few steps at the full Pluto grid, 2 shots: fd_step with the Gaussian
    # source (all-edge taper) and the receiver row (top strip), fd_update
    # with one velocity plane a shot, from random states
    rng = np.random.default_rng(19)
    st = [randn(rng, pt.ns, pt.nxe, pt.nze) for _ in range(2)]
    rows = randn(rng, pt.ns, pt.nx)
    for step in range(3):
        for taper, kw in (("all", dict(amp=float(wav_pm[step]), sx=gp.sx,
                                       sz=gp.sz)),
                          ("top", dict(inj_row=rows, x0=ctx_pm.nzb,
                                       gz=gp.gz))):
            rel, absd = errs(
                stream.fd_step_cuda(ctx_pm, *st, v2_pm, taper, **kw),
                solver.fd_step(ctx_pm, *st, v2_pm, taper, **kw))
            print(f"[stream vs plain] fd_step at the Pluto grid ({pt.nxe} x "
                  f"{pt.nze}, {pt.ns} shots, taper {taper}, step {step}): "
                  f"max rel err {rel:.3e}, max abs err {absd:.3e}",
                  flush=True)
            check(rel <= GATE, f"fd_step at the Pluto grid: {rel:.3e}")
            stream_err["fd_step"] = max(stream_err["fd_step"], absd)
        rel, absd = errs(stream.fd_update_cuda(ctx_pm, *st, v2_pr),
                         solver.fd_update(ctx_pm, *st, v2_pr))
        print(f"[stream vs plain] fd_update at the Pluto grid, step {step}: "
              f"max rel err {rel:.3e}, max abs err {absd:.3e}", flush=True)
        check(rel <= GATE, f"fd_update at the Pluto grid: {rel:.3e}")
        stream_err["fd_update"] = max(stream_err["fd_update"], absd)
        st = list(solver.fd_step(ctx_pm, *st, v2_pm, "all"))[::-1]
    for k, e in stream_err.items():
        results[k]["max_abs_err"] = e
    del st, rows
    phase_done("stream-step kernels vs plain")

    # ---- 20. the K = 1 tier at the Pluto grid, 2 shots, nt = 203 (the
    # phase-9 shapes), against the per-step tier; then rtm_main's two
    # tiers through run_rtm_cpu on the 3lay config and at the Pluto grid
    case = tier_case(pluto, PLUTO_VELOCITIES)
    ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp20 = case
    nxt20 = torch.cat([d[1:, 0, 0], d.new_zeros(1)]).cpu().numpy()
    fk.reset_launches()
    stream.reset_launches()
    k1 = {"gathers": solver.forward_modeling_tiled(
              ctx_m, v2_m, wav_m, gp20.sx, gp20.sz, gp20.gz, block_k=1)[2],
          "snapshot": solver.rtm_shot_snapshot_tiled(
              ctx_r, v2_r, wav_r, d, gp20.sx, gp20.sz, gp20.gz, block_k=1),
          "full": solver.rtm_shot_full_tiled(
              ctx_m, v2_m, wav_m, d, gp20.sx, gp20.sz, gp20.gz,
              next_shot_first=nxt20, block_k=1)}
    torch.cuda.synchronize()
    launches = dict(stream.LAUNCHES)
    print(f"[K=1 tier] Pluto ({pluto.nxe} x {pluto.nze}, ns {pluto.ns}, nt "
          f"{pluto.nt}): forward_modeling_tiled, rtm_shot_snapshot_tiled and "
          f"rtm_shot_full_tiled at block_k=1: launches {launches}, "
          f"{dict(fk.LAUNCHES)}", flush=True)
    want = {"fd_step": 3 * pluto.nt, "fd_update": pluto.nt - 2,
            "gpu_step": 2 * pluto.nt}
    for k, n in launches.items():
        check(n == want.get(k, 0), f"K=1 tier: {k} launched {n} times, "
                                   f"expected {want.get(k, 0)}")
    check(not any(fk.LAUNCHES.values()), f"the K=1 tier launched per-step "
                                         f"kernels: {fk.LAUNCHES}")
    for k in ("fd_step", "fd_update"):
        results[k]["launches"] = launches[k]
    ref = fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, gp20.sx, gp20.sz,
                                   gp20.gz)[2]
    check(torch.equal(k1["gathers"], ref),
          f"K=1 gathers are not bitwise the per-step tier's: "
          f"{errs(k1['gathers'], ref)}")
    rr = {"snapshot": rel_rms(k1["snapshot"].cpu(), fk.rtm_snapshot_cuda(
              ctx_r, v2_r, wav_r, d, gp20.sx, gp20.sz, gp20.gz).cpu()),
          "full": rel_rms(k1["full"].cpu(), fk.rtm_full_cuda(
              ctx_m, v2_m, wav_m, d, gp20.sx, gp20.sz, gp20.gz,
              next_shot_first=nxt20).cpu())}
    plain1 = solver.rtm_shot_full(ctx_m, v2_m, wav_m, d[:1], gp20.sx[:1],
                                  gp20.sz, gp20.gz,
                                  next_shot_first=nxt20[:1]).cpu()
    rr["full, shot 0, vs plain"] = rel_rms(k1["full"][:1].cpu(), plain1)
    print(f"[K=1 tier] gathers bitwise the per-step tier's; images rel RMS "
          f"{rr} (rtm_shot_snapshot_tiled vs rtm_snapshot_cuda, "
          f"rtm_shot_full_tiled vs rtm_full_cuda and the plain "
          f"rtm_shot_full)", flush=True)
    check(max(rr.values()) <= GATE, f"K=1 images differ: {rr}")
    del k1, ref, plain1
    dobs20 = d.cpu().numpy()
    for label, p_, vp_, dobs_ in (
            ("3lay", P, vp, data),
            ("Pluto", pluto, layered_model(pluto.nx, pluto.nz,
                                           velocities=PLUTO_VELOCITIES),
             dobs20)):
        outs = {}
        for backend in ("tiled", "pallas"):
            fk.reset_launches()
            stream.reset_launches()
            t0 = time.perf_counter()
            outs[backend] = pipeline.run_rtm_cpu(p_, vp=vp_, dobs=dobs_,
                                                 device=dev, backend=backend)
            torch.cuda.synchronize()
            print(f"[K=1 tier] run_rtm_cpu {label} backend={backend!r} (ns "
                  f"{p_.ns}, nt {p_.nt}): {time.perf_counter() - t0:.3f} s "
                  f"wall; launches {dict(fk.LAUNCHES)}, "
                  f"{dict(stream.LAUNCHES)}", flush=True)
            # both passes resident where the shot fits a cluster (3lay)
            plan_ = fk.resident_plan(p_.nxe, p_.nze, p_.order)
            fwd, bwd = ((("rec_fwd_cluster", 1), ("rec_bwd_cluster", 1))
                        if plan_ else (("rec_fwd_step", p_.nt),
                                       ("rec_bwd_step", p_.nt)))
            check(fk.LAUNCHES[fwd[0]] == fwd[1]
                  and fk.LAUNCHES[bwd[0]] == bwd[1]
                  and np.isfinite(outs[backend][1]).all()
                  and np.abs(outs[backend][0]).max() > 0,
                  f"run_rtm_cpu {label} {backend}")
        rr = [rel_rms(a, b) for a, b in zip(outs["tiled"], outs["pallas"])]
        print(f"[K=1 tier] run_rtm_cpu {label}: tiled vs pallas image rel RMS "
              f"{rr[0]:.3e}, per-shot {rr[1]:.3e}", flush=True)
        check(max(rr) <= GATE, f"run_rtm_cpu {label} tiers differ")
    del case, d, outs
    phase_done("K=1 tier at the Pluto grid")

    # ---- 21. times and profile of the K = 1 tier at the Pluto grid, 2
    # shots, nt=1001: each new kernel's launches over the steps (constants
    # and buffers made once, as the tiled loops do), its plain version's, and
    # the per-step kernel call for the same function, in turns; then the
    # whole K = 1 calls against the K = 4 and per-step calls, and one trace
    # of each K = 1 call
    c_mod = stream.prepare(ctx_pm, v2_pm, gp.sx, source="gaussian",
                           taper="all")
    c_rtm = stream.prepare(ctx_pr, v2_pr, gp.sx, source="point", taper="top")
    st = [randn(np.random.default_rng(21), pt.ns, pt.nxe, pt.nze)
          for _ in range(4)]
    # the plain step with its mask and patch on the card once, as the
    # plain loops hold them (solver.fd_step uploads the mask every call)
    mask_all = torch.as_tensor(ctx_pm.mask_all, device=dev)
    patch = torch.as_tensor(ctx_pm.source_patch, device=dev)

    def step_loop(kernel: bool, update: bool):
        def run():
            if update:
                for _ in range(pt.nt):
                    if kernel:
                        stream.fd_update_cuda(ctx_pr, st[0], st[1], v2_pr,
                                              consts=c_rtm, out=st[2])
                    else:
                        solver.fd_update(ctx_pr, st[0], st[1], v2_pr)
                return
            for amp in wav_pm:
                kw = dict(amp=float(amp), sx=gp.sx, sz=gp.sz)
                if kernel:
                    stream.fd_step_cuda(ctx_pm, st[0], st[1], v2_pm, "all",
                                        consts=c_mod, out=st[2:], **kw)
                else:
                    solver._step(ctx_pm, st[0], st[1], v2_pm, mask_all,
                                 float(amp), gp.sx, gp.sz, patch)
        return run

    k1_bounds = stream_bounds(ctx_pm, pt.ns)
    yardstick = {
        "fd_step": ("mod_step", lambda: fk.forward_modeling_cuda(
            ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz)),
        "fd_update": ("rtm_fwd_step", lambda: fk.fd_forward_cuda(
            ctx_pr, v2_pr, wav_pr, gp.sx, gp.sz))}
    for k, update in (("fd_step", False), ("fd_update", True)):
        tk, tp, ts = in_turns([step_loop(True, update),
                               step_loop(False, update), yardstick[k][1]],
                              once=(1,))
        bms, by = k1_bounds[k]
        print(f"[times] {k} at the Pluto grid ({pt.ns} shots, {pt.nt} "
              f"launches): kernel {span(tk)}, plain {span(tp)}, per-step "
              f"kernel {yardstick[k][0]} {span(ts)}; bound {bms:.3f} ms "
              f"({by}), kernel / bound {statistics.median(tk) / bms:.2f}; "
              f"{smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)
    del st
    pluto_calls["modeling K=1"] = lambda: solver.forward_modeling_tiled(
        ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz, block_k=1)
    pluto_calls["RTM K=1"] = lambda: solver.rtm_shot_snapshot_tiled(
        ctx_pr, v2_pr, wav_pr, d_p, gp.sx, gp.sz, gp.gz, block_k=1)
    for trio in (("modeling K=1", "modeling tiled", "modeling per-step"),
                 ("RTM K=1", "RTM tiled", "RTM per-step")):
        ts = in_turns([pluto_calls[c] for c in trio])
        for c, t in zip(trio, ts):
            pluto_ms[c] = statistics.median(t)
            print(f"[times] Pluto {c} ({pt.ns} shots, nt {pt.nt}; tiled = "
                  f"K={K}): {span(t)}, {pluto_ms[c] / 1e3 / pt.ns:.6f} s/shot; "
                  f"{smi}", flush=True)
    ours = ("fd_step", "fd_update", "gpu_step")
    for c in ("modeling K=1", "RTM K=1"):
        rows = profile(torch, f"Pluto {c}", pluto_calls[c], pluto_ms[c], smi)
        busy = sum(t for _, t, _ in rows)
        other = [(key, t, n) for key, t, n in rows
                 if not any(o in key for o in ours)]
        print(f"[profile] Pluto {c}: other ops (trace copies, the point "
              f"source's index add, fills) {sum(t for _, t, _ in other):.3f} "
              f"ms in {sum(n for _, _, n in other)} launches; idle share "
              f"{1 - busy / pluto_ms[c]:.3f}; {smi}", flush=True)
    phase_done("K=1 times and profile")

    # ---- 22. the padded-layout stencil (kernel-table row 7) vs plain on
    # the card: lap_padded bitwise its plain version and n = 1, 2, 16
    # chained applies of stencil.laplacian; lap_padded_mma within 1e-6 of
    # max of its plain version and 2e-5 (mxu) / 2e-7 (mxu6) of the exact
    # taps; the pads zero
    from parallel_finite_difference_computation_tpu_torch.ops import padded

    def pads_zero(t, nx, nz, order) -> bool:
        q = t.clone()
        padded.from_padded(q, nx, nz, order).zero_()
        return float(q.abs().max()) == 0.0

    pad_abs = {"lap_padded": 0.0, "lap_padded_mma": 0.0}
    for label, p in grids.items():
        f = fields[label]
        nx, nz = f.shape
        for order in (4, 8, 10, 16):
            cx, cz = numerics.scaled_coefficients(order, p.dx, p.dz)
            pf = padded.to_padded(f, order)
            exact = padded.laplacian_padded(pf, cx, cz, order, nx, nz)
            bufs = (pf.clone(), torch.empty_like(pf))
            chain = f
            for n in range(1, 17):
                got = padded.laplacian_padded_cuda(
                    bufs[(n - 1) % 2], cx, cz, order, nx, nz,
                    out=bufs[n % 2])
                chain = stencil.laplacian(chain, cx, cz, order)
                if n == 1:
                    check(torch.equal(got, exact), f"lap_padded {label} "
                          f"order {order} differs from its plain version")
                if n in (1, 2, 16):
                    check(torch.equal(padded.from_padded(got, nx, nz, order),
                                      chain),
                          f"lap_padded {label} order {order}: {n} chained "
                          f"applies differ from stencil.laplacian")
            check(pads_zero(got, nx, nz, order), f"lap_padded {label} "
                  f"order {order}: pads not zero")
            line = [f"lap_padded bitwise (1, 2, 16 applies)"]
            for impl, tol in (("mxu", 2e-5), ("mxu6", 2e-7)):
                got = padded.laplacian_padded_cuda(pf, cx, cz, order, nx, nz,
                                                   impl, out=bufs[1])
                want = padded.laplacian_padded(pf, cx, cz, order, nx, nz,
                                               impl)
                e_plain, e_exact = max_rel(got, want), max_rel(got, exact)
                pad_abs["lap_padded_mma"] = max(
                    pad_abs["lap_padded_mma"],
                    float((got - want).abs().max()))
                line.append(f"lap_padded_mma {impl}: {e_plain:.3e} of max "
                            f"from plain, {e_exact:.3e} from exact")
                check(e_plain <= 1e-6 and e_exact <= tol
                      and pads_zero(got, nx, nz, order),
                      f"lap_padded_mma {impl} {label} order {order}: "
                      f"{e_plain:.3e} from plain (gate 1e-6), {e_exact:.3e} "
                      f"from exact (gate {tol})")
            print(f"[padded vs plain] {label} order {order}: "
                  + "; ".join(line), flush=True)
            del pf, exact, bufs, chain, got, want
    results["lap_padded"]["max_abs_err"] = pad_abs["lap_padded"]
    results["lap_padded_mma"]["max_abs_err"] = pad_abs["lap_padded_mma"]

    # the padded chain path: 16 chained applies at 8192 x 8192, order 8, on
    # two buffers, for each impl, counted
    p8 = grids["8192 x 8192"]
    f8 = fields["8192 x 8192"]
    cx8, cz8 = numerics.scaled_coefficients(8, p8.dx, p8.dz)
    pf8 = padded.to_padded(f8, 8)
    chain_bufs = (pf8.clone(), torch.empty_like(pf8))

    def padded_chain(impl: str):
        def run():
            for n in range(16):
                padded.laplacian_padded_cuda(
                    chain_bufs[n % 2], cx8, cz8, 8, p8.nxe, p8.nze, impl,
                    out=chain_bufs[1 - n % 2])
        return run

    padded.reset_launches()
    for impl in padded.IMPLS:
        padded_chain(impl)()
    torch.cuda.synchronize()
    launches = dict(padded.LAUNCHES)
    print(f"[padded path] 16 chained applies at 8192 x 8192, order 8, for "
          f"vpu, mxu and mxu6: launches {launches}", flush=True)
    check(launches == {"lap_padded": 16, "lap_padded_mma": 32},
          f"padded chain launches {launches}")
    results["lap_padded"]["launches"] = launches["lap_padded"]
    results["lap_padded_mma"]["launches"] = launches["lap_padded_mma"]
    phase_done("padded stencil vs plain")

    # ---- 23. the split-bf16 tiers of the per-step kernels (row 5): the
    # three *_mma kernels vs their plain versions (short runs at orders 4,
    # 8, 10, 16 with nxb != nzb, at orders 8 and 16 on a grid whose tails
    # cut their owned shapes, and 3lay), then the 3lay main
    # path with lap_impl="auto" (which resolves to mxu) and "mxu6"
    mma_names = ("mod_step_mma", "rtm_fwd_step_mma", "rtm_bwd_step_mma")
    exact_img = img

    def compare_mma(p, lap_impl):
        """{kernel: [(output, max rel, max abs)]} of the *_mma kernels
        against the plain split loops on the same CUDA tensors; the
        backward kernel from the plain forward's snapshots."""
        ctx_m = solver.FDContext.from_params(p, exact_taper=False)
        ctx_r = solver.FDContext.from_params(p, exact_taper=True)
        vp_ = (vp if (p.nx, p.nz) == (P.nx, P.nz)
               else layered_model(p.nx, p.nz))
        v2_m = torch.from_numpy(pipeline.prepare_velocity_cpu(p, vp_)).to(dev)
        v2_r = pipeline.prepare_velocities_gpu(p, vp_, device=dev, seed=0)
        wav_m = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak, truncated=True)
        wav_r = numerics.ricker_wavelet(p.nt, p.dt, p.fpeak)
        gp_ = Geometry.from_params(p)
        parts = fk.lap_parts(lap_impl, ctx_r)
        lap = solver.laplacian_of(ctx_r, parts)
        out = {}
        km = fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, gp_.sx, gp_.sz,
                                      gp_.gz, lap_impl=parts)
        pm = solver.forward_modeling(ctx_m, v2_m, wav_m, gp_.sx, gp_.sz,
                                     gp_.gz, lap_impl=parts)
        out["mod_step_mma"] = [(n, max_rel(a, b), float((a - b).abs().max()))
                               for n, a, b in zip(("p", "pp", "gathers"),
                                                  km, pm)]
        kf = fk._fd_forward(ctx_r, v2_r, wav_r, gp_.sx, gp_.sz, parts)
        pf = solver.fd_forward(ctx_r, v2_r, wav_r, gp_.sx, gp_.sz, lap)
        out["rtm_fwd_step_mma"] = [
            (n, max_rel(a, b), float((a - b).abs().max()))
            for n, a, b in zip(("p", "pp"), kf, pf)]
        dobs = pm[2].transpose(1, 2).contiguous()
        kb = fk._fd_back(ctx_r, v2_r, pf[0], pf[1], dobs, gp_.gz, parts)
        pb = solver.fd_back(ctx_r, v2_r, pf[0], pf[1], dobs, gp_.gz, lap)
        out["rtm_bwd_step_mma"] = [("images", max_rel(kb, pb),
                                    float((kb - pb).abs().max()))]
        torch.cuda.synchronize()
        return out

    mma_abs = {k: 0.0 for k in mma_names}
    runs = [(dataclasses.replace(P, order=order, nt=20, nxb=nxb, nzb=nzb),
             li)
            for order, nxb, nzb in ((4, 40, 30), (8, 40, 40), (10, 12, 30),
                                    (16, 30, 40))
            for li in ("mxu", "mxu6")]
    # a grid whose tails cut the owned shape of every kernel of
    # step_mma.cu along both axes (126 x 92 extended: 32 x 64 owned cells,
    # or 32 x 32 and 64 x 64 as the probe tries them)
    runs += [(dataclasses.replace(P, order=order, nt=20, nx=100, nz=70,
                                  nxb=13, nzb=11, ns=4), li)
             for order in (8, 16) for li in ("mxu", "mxu6")]
    runs += [(P, "mxu"), (P, "mxu6")]
    for p, li in runs:
        for k, outs in compare_mma(p, li).items():
            for name, rel, absd in outs:
                # after the 1001 steps of 3lay the final fields are the
                # residual wavefield, whose max moves by ~1e-5 when only the
                # order of the plain version's own sums changes
                # (scripts/torch_sum_order_floor.py); the gathers and the
                # images are the calls' products
                final = p.nt == P.nt and name in ("p", "pp")
                gate = 1e-4 if final else GATE
                print(f"[mma vs plain] {k} {li} order {p.order} nt {p.nt} "
                      f"nxb {p.nxb} nzb {p.nzb}: {name} max rel err "
                      f"{rel:.3e} (gate {gate}), max abs err {absd:.3e}",
                      flush=True)
                check(rel <= gate, f"{k} {li} order {p.order} nt {p.nt} "
                                   f"{name}: {rel:.3e} > {gate}")
                if p is P:
                    mma_abs[k] = max(mma_abs[k], absd)
    for k in mma_names:
        results[k]["max_abs_err"] = mma_abs[k]

    ctx_p = solver.FDContext.from_params(P, exact_taper=True)
    check(fk.resolve_lap_impl(ctx_p, "auto") == "mxu",
          "3lay lap_impl='auto' does not resolve to mxu")
    wav_r = numerics.ricker_wavelet(P.nt, P.dt, P.fpeak)
    v2_r = pipeline.prepare_velocities_gpu(P, vp, device=dev, seed=0)
    for li in ("auto", "mxu6"):
        fk.reset_launches()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            data_li = pipeline.run_modeling(P, vp=vp, device=dev,
                                            lap_impl=li)
            img_li, _ = pipeline.run_rtm_gpu(P, vp=vp, dobs=data_li, seed=0,
                                             device=dev, outdir=tmp,
                                             lap_impl=li)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(fk.LAUNCHES)
            written = np.fromfile(os.path.join(tmp, "dir.image"), np.float32)
        print(f"[mxu path] run_modeling + run_rtm_gpu, 3lay ns={P.ns} "
              f"nt={P.nt}, lap_impl={li!r}: {wall:.3f} s wall incl. host; "
              f"launches {launches}", flush=True)
        want = {k: (P.nt if k in mma_names else 0) for k in fk.LAUNCHES}
        check(launches == want, f"lap_impl={li!r} launches {launches}")
        if li == "auto":
            for k in mma_names:
                results[k]["launches"] = launches[k]
        check(np.isfinite(data_li).all() and np.isfinite(img_li).all()
              and np.array_equal(written.reshape(P.nx, P.nz), img_li),
              f"lap_impl={li!r}: outputs not finite or dir.image differs")
        d_li = torch.from_numpy(data_li).to(dev)
        plain_li = solver.rtm_shot_snapshot(
            ctx_p, v2_r, wav_r, d_li, g.sx, g.sz, g.gz,
            lap_impl=li).cpu().numpy().sum(axis=0)
        rr_plain = rel_rms(img_li, plain_li)
        rr_exact = rel_rms(img_li, exact_img)
        rr_data = rel_rms(data_li, data)
        gate = 1e-4 if li == "auto" else 1e-5
        print(f"[mxu path] lap_impl={li!r}: image vs the plain {li} path on "
              f"the card rel RMS {rr_plain:.3e} (gate {GATE}); vs phase 4's "
              f"exact path: image rel RMS {rr_exact:.3e} (gate {gate}), "
              f"gathers rel RMS {rr_data:.3e} (the JAX record for mxu on "
              f"3lay: 2.1e-5 against the C oracle)", flush=True)
        check(rr_plain <= GATE and rr_exact <= gate,
              f"lap_impl={li!r} path: {rr_plain:.3e} from plain, "
              f"{rr_exact:.3e} from exact")
        del d_li
    phase_done("split-bf16 tiers vs plain and the mxu path")

    # ---- 24. times and traces of the tensor-core tiers: the 3lay calls in
    # exact, mxu and mxu6 in turns; each *_mma call (mxu) against its plain
    # version, the exact per-step call of the same function (per_step=True)
    # and the exact call on its resident route, in the same turns; the
    # padded chain per apply against lap_apply and conv2d; one trace of each
    ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r = shapes(8, P.nt)
    d = torch.from_numpy(data).to(dev)
    calls = {}
    for label, fn in (
            ("modeling", lambda li: lambda: fk.forward_modeling_cuda(
                ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz, lap_impl=li)),
            ("RTM", lambda li: lambda: fk.rtm_snapshot_cuda(
                ctx_r, v2_r, wav_r, d, g.sx, g.sz, g.gz, lap_impl=li))):
        ts = in_turns([fn(None), fn("mxu"), fn("mxu6")])
        for li, t in zip(("exact", "mxu", "mxu6"), ts):
            calls[label, li] = statistics.median(t)
            print(f"[times] 3lay {label} {li} ({P.ns} shots x {P.nt} steps): "
                  f"{span(t)}, {calls[label, li] / 1e3 / P.ns:.6f} s/shot; "
                  f"{smi}", flush=True)
    lap2 = solver.laplacian_of(ctx_r, 2)
    snaps2 = fk._fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz, 2)
    snaps0 = fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz)
    mma_cases = {
        "mod_step_mma": (
            lambda: fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, g.sx, g.sz,
                                             g.gz, lap_impl=2),
            lambda: solver.forward_modeling(ctx_m, v2_m, wav_m, g.sx, g.sz,
                                            g.gz, lap_impl=2),
            lambda: fk._forward_modeling(ctx_m, v2_m, wav_m, g.sx, g.sz,
                                         g.gz, "gaussian", "all", "trace", 0,
                                         per_step=True),
            lambda: fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, g.sx, g.sz,
                                             g.gz)),
        "rtm_fwd_step_mma": (
            lambda: fk._fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz, 2),
            lambda: solver.fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz, lap2),
            lambda: fk._fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz, 0,
                                   per_step=True),
            lambda: fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz)),
        "rtm_bwd_step_mma": (
            lambda: fk._fd_back(ctx_r, v2_r, *snaps2, d, g.gz, 2),
            lambda: solver.fd_back(ctx_r, v2_r, *snaps2, d, g.gz, lap2),
            lambda: fk._fd_back(ctx_r, v2_r, *snaps0, d, g.gz, 0,
                                per_step=True),
            lambda: fk.fd_back_cuda(ctx_r, v2_r, *snaps0, d, g.gz))}
    bounds = step_bounds(ctx_r, P.ns, parts=2)
    for k, (kern, plain, per_step_call, exact_call) in mma_cases.items():
        tk, tp, ts_, te = in_turns([kern, plain, per_step_call, exact_call])
        bms, by = bounds[k[:-4]]
        print(f"[times] {k} (mxu) {P.ns} shots x {P.nt} steps: kernel "
              f"{span(tk)}, plain {span(tp)}, exact per-step twin "
              f"({k[:-4]}, {P.nt} launches) {span(ts_)}, exact resident "
              f"route {span(te)}; kernel / per-step twin "
              f"{statistics.median(tk) / statistics.median(ts_):.3f}; bound "
              f"{bms:.4f} ms ({by}); {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), library_ms=None,
                          bound_ms=bms, bound_by=by)
    del snaps2, snaps0

    def lap_apply_chain():
        for _ in range(16):
            fk.laplacian_cuda(f8, cx8, cz8, 8)

    w8 = torch.zeros((1, 1, 9, 9), device=dev)
    w8[0, 0, 4, :] = torch.from_numpy(cz8).to(dev)
    w8[0, 0, :, 4] += torch.from_numpy(cx8).to(dev)

    def conv_chain():
        for _ in range(16):
            torch.nn.functional.conv2d(f8[None, None], w8)

    ts = in_turns([padded_chain("vpu"), padded_chain("mxu"),
                   padded_chain("mxu6"), lap_apply_chain, conv_chain])
    per = {k: statistics.median(t) / 16 for k, t in zip(
        ("lap_padded", "lap_padded_mma", "lap_padded_mma mxu6", "lap_apply",
         "conv2d"), ts)}
    tp = in_turns([lambda: padded.laplacian_padded(pf8, cx8, cz8, 8, p8.nxe,
                                                   p8.nze),
                   lambda: padded.laplacian_padded(pf8, cx8, cz8, 8, p8.nxe,
                                                   p8.nze, "mxu")])
    R8, W8 = pf8.shape
    h8 = 4
    interior8 = (p8.nxe - 2 * h8) * (p8.nze - 2 * h8)
    pad_bounds = {
        "lap_padded": bound(2 * 4 * R8 * W8, interior8 * lap_flops(h8)),
        "lap_padded_mma": bound(2 * 4 * R8 * W8,
                                interior8 * mma_lap_flops(h8, 2)[0],
                                interior8 * mma_lap_flops(h8, 2)[1])}
    for k, t_plain in zip(("lap_padded", "lap_padded_mma"), tp):
        bms, by = pad_bounds[k]
        print(f"[times] {k} 8192 x 8192 order 8, per apply of a 16-apply "
              f"chain: kernel {per[k]:.4f} ms (mxu6 "
              f"{per['lap_padded_mma mxu6']:.4f}), plain {span(t_plain)} per "
              f"apply, lap_apply {per['lap_apply']:.4f}, conv2d "
              f"{per['conv2d']:.4f}; bound {bms:.4f} ms ({by}), kernel / "
              f"bound {per[k] / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=per[k], plain_ms=statistics.median(t_plain),
                          library_ms=per["conv2d"], bound_ms=bms,
                          bound_by=by)
    for label, fn, ms in (
            ("3lay modeling mxu", mma_cases["mod_step_mma"][0],
             calls["modeling", "mxu"]),
            ("3lay RTM mxu", lambda: fk.rtm_snapshot_cuda(
                ctx_r, v2_r, wav_r, d, g.sx, g.sz, g.gz, lap_impl="mxu"),
             calls["RTM", "mxu"]),
            ("padded chain 8192^2 vpu", padded_chain("vpu"),
             16 * per["lap_padded"]),
            ("padded chain 8192^2 mxu", padded_chain("mxu"),
             16 * per["lap_padded_mma"])):
        if not profile(torch, label, fn, ms, smi):
            # a trace that caught no kernel: take it once more
            profile(torch, label, fn, ms, smi)
    del pf8, chain_bufs, d
    phase_done("tensor-core tiers: times and profile")

    # ---- 25. the split-bf16 lowering of the large-grid tier (rows 10-13):
    # the three split K-step kernels, each on a strip body with the z
    # product (kstep_mod_mma in both sources and tapers and
    # kstep_gpu_fwd_mma on the forward body, kstep_gpu_bwd_mma on the
    # backward one), and gpu_step_mma against their plain passes (the z
    # taps in the same bf16 parts) on the same CUDA tensors, pass by pass
    # and through the tiled RTM driver; phase 8's 67 x 88 grid at K = 1,
    # 2, 4 and 8, then the Pluto grid
    split_names = ("kstep_mod_mma", "kstep_gpu_fwd_mma", "gpu_step_mma",
                   "kstep_gpu_bwd_mma")

    def modeling_passes(ctx, v2, wav, gp_, k, lap, source, taper, parts=0):
        """The K-step passes of forward_modeling_tiled: plain with the
        Laplacian lap, or through kstep_mod_mma with parts > 0 (at every
        K, where the driver runs the K = 1 tier's kernels at K = 1)."""
        step = (functools.partial(stream.mod_kstep_cuda, parts=parts)
                if parts else lambda *a: solver.mod_kstep(*a, lap))
        p_ = pp_ = torch.zeros((len(gp_.sx), ctx.nxe, ctx.nze), device=dev)
        rec = []
        for it0 in range(0, ctx.nt, k):
            p_, pp_, tr = step(ctx, p_, pp_, v2, wav[it0:it0 + k], gp_.sx,
                               gp_.sz, gp_.gz, source, taper)
            rec.append(tr)
        return p_, pp_, torch.cat(rec, 1)

    def compare_split(case, k: int, parts: int):
        """{kernel: [(output, max rel, max abs)]} of the split kernels
        against their plain passes with the same Laplacian: kstep_mod_mma's
        passes (Gaussian source, all-edge taper; point source, top taper);
        kstep_gpu_fwd_mma's passes; the two gpu_step_mma seed steps from the
        plain snapshots; kstep_gpu_bwd_mma's passes from the plain seeded
        state; above K = 1 the whole tiled RTM (its image under
        kstep_gpu_bwd_mma)."""
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp_ = case
        lap = solver.laplacian_of(ctx_r, parts, axis="z")
        lap_m = solver.laplacian_of(ctx_m, parts, axis="z")

        def ob(names, a, b):
            return [(n, max_rel(x, y), float((x - y).abs().max()))
                    for n, x, y in zip(names, a, b)]

        out = {"kstep_mod_mma": []}
        for source, taper in (("gaussian", "all"), ("point", "top")):
            km = modeling_passes(ctx_m, v2_m, wav_m, gp_, k, None, source,
                                 taper, parts)
            pm = modeling_passes(ctx_m, v2_m, wav_m, gp_, k, lap_m, source,
                                 taper)
            out["kstep_mod_mma"] += ob(("p", "pp", "gathers"), km, pm)
        c = stream.prepare(ctx_r, v2_r, gp_.sx, source="point", taper="top")
        kf = (torch.zeros((len(gp_.sx), ctx_r.nxe, ctx_r.nze),
                          device=dev),) * 2
        for it0 in range(0, ctx_r.nt, k):
            kf = stream.fd_forward_kstep_cuda(ctx_r, *kf, v2_r,
                                              wav_r[it0:it0 + k], gp_.sx,
                                              gp_.sz, consts=c, parts=parts)
        pf = solver.fd_forward(ctx_r, v2_r, wav_r, gp_.sx, gp_.sz, lap)
        out["kstep_gpu_fwd_mma"] = ob(("p", "pp"), kf, pf)
        inj = d.flip(-1).transpose(1, 2).contiguous()
        ks = solver._seed_steps(ctx_r, v2_r, *pf, inj, gp_.gz,
                                functools.partial(stream.fd_step_gpu_cuda,
                                                  consts=c, parts=parts))
        ps = solver._seed_steps(ctx_r, v2_r, *pf, inj, gp_.gz,
                                functools.partial(solver.fd_step_gpu,
                                                  lap=lap))
        out["gpu_step_mma"] = ob(("pr", "ppr", "images"), ks[2:], ps[2:])
        kb = ps[:4] + (ps[4].clone(),)
        for it0 in range(2, ctx_r.nt, k):
            kb = stream.fd_back_kstep_cuda(ctx_r, *kb, v2_r,
                                           inj[:, it0:it0 + k], gp_.gz,
                                           consts=c, parts=parts)
        pb = solver.fd_back_kstep(ctx_r, *ps, v2_r, inj[:, 2:], gp_.gz, lap)
        out["kstep_gpu_bwd_mma"] = ob(("ps", "pps", "pr", "ppr", "images"),
                                      kb, pb)
        if k > 1:
            ki = solver.rtm_shot_snapshot_tiled(ctx_r, v2_r, wav_r, d, gp_.sx,
                                                gp_.sz, gp_.gz, block_k=k,
                                                lap_impl=parts)
            out["kstep_gpu_bwd_mma"] += ob(("tiled RTM images",), (ki,),
                                           (pb[4],))
        torch.cuda.synchronize()
        return out

    def check_split(label, outs):
        """Prints and gates compare_split's outputs: gathers and images
        <= 1e-5 max rel, final fields <= 1e-4 (the summation-order floor of
        the tensor cores' sums over many steps; phase 23). Returns the
        largest max abs error of each kernel."""
        worst = {}
        for kname, rows in outs.items():
            for name, rel, absd in rows:
                gate = GATE if name in ("gathers", "images",
                                        "tiled RTM images") else 1e-4
                print(f"[split vs plain] {kname} {label}: {name} max rel err "
                      f"{rel:.3e} (gate {gate}), max abs err {absd:.3e}",
                      flush=True)
                check(rel <= gate, f"{kname} {label} {name}: {rel:.3e}")
                worst[kname] = max(worst.get(kname, 0.0), absd)
        return worst

    for order in (4, 8, 10, 16):
        case = tier_case(dataclasses.replace(short, order=order))
        for k in (1, 2, 4, 8):
            for parts in (2, 3):
                label = (f"order {order} K {k} parts {parts} nt {short.nt} "
                         f"67 x 88")
                refused = [n for n in ("kstep_mod", "kstep_gpu_fwd",
                                       "kstep_gpu_bwd")
                           if fk.smem_bytes(n, order, k, parts)
                           > fk.SMEM_BYTES]
                if refused:      # order 16 at K = 8 (the backward from 6)
                    print(f"[split vs plain] {label}: skipped, the tiles of "
                          f"{refused} outgrow a block", flush=True)
                    continue
                check_split(label, compare_split(case, k, parts))
    case = tier_case(pluto, PLUTO_VELOCITIES)
    for parts in (2, 3):
        worst = check_split(f"Pluto {pluto.nxe} x {pluto.nze} order 8 K 4 nt "
                            f"{pluto.nt} ns {pluto.ns} parts {parts}",
                            compare_split(case, 4, parts))
        if parts == 2:
            for kname in split_names:
                results[kname]["max_abs_err"] = worst[kname]
    del case
    phase_done("split-bf16 large-grid kernels vs plain")

    # ---- 26. the Pluto path through the split tier: run_modeling then
    # run_rtm_gpu at the full Pluto grid, 2 shots, backend="auto" (tiled,
    # K = 4) with lap_impl="auto" at nt = 1001 (resolves to mxu) and nt =
    # MXU6_NT_MAX = 4500 (mxu6, the longest record auto sends to a split
    # tier), each against the exact tiled run at the same nt
    check(pipeline.TILED_BLOCK_K == 4, "the tiled tier's K is not 4")
    for nt_s, tier in ((1001, "mxu"), (fk.MXU6_NT_MAX, "mxu6")):
        ps_ = Params(**dict(PLUTO, nt=nt_s))
        ctx_s = solver.FDContext.from_params(ps_, exact_taper=True)
        check(fk.resolve_lap_impl(ctx_s, "auto") == tier,
              f"Pluto nt {nt_s}: auto does not resolve to {tier}")
        runs = {}
        for li in ("auto", None):
            fk.reset_launches()
            stream.reset_launches()
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                dat = pipeline.run_modeling(ps_, vp=vp_pl, device=dev,
                                            backend="auto", lap_impl=li)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                img_s, _ = pipeline.run_rtm_gpu(
                    ps_, vp=vp_pl, dobs=runs["auto"][0] if li is None else dat,
                    seed=0, device=dev, outdir=tmp, backend="auto",
                    lap_impl=li)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                launches = {**fk.LAUNCHES, **stream.LAUNCHES}
                written = np.fromfile(os.path.join(tmp, "dir.image"),
                                      np.float32)
            runs[li] = (dat, img_s)
            name = tier if li else "exact"
            print(f"[split Pluto path] lap_impl={li!r} ({name}), Pluto "
                  f"{ps_.nxe} x {ps_.nze}, nt {nt_s} (cut from "
                  f"{PLUTO['nt']}), ns {ps_.ns} of 30: run_modeling "
                  f"{t1 - t0:.3f} s wall ({(t1 - t0) / ps_.ns:.3f} s/shot), "
                  f"run_rtm_gpu {t2 - t1:.3f} s wall ({(t2 - t1) / ps_.ns:.3f}"
                  f" s/shot), host included; launches "
                  f"{ {k: n for k, n in launches.items() if n} }; {smi}",
                  flush=True)
            check(np.isfinite(dat).all() and np.abs(dat).max() > 0
                  and written.size == ps_.nx * ps_.nz
                  and written.tobytes() == img_s.tobytes()
                  and np.isfinite(img_s).all() and np.abs(img_s).max() > 0,
                  f"{name} at nt {nt_s}: outputs not finite, zero or "
                  f"dir.image differs")
            passes, bwd = -(-nt_s // 4), -(-(nt_s - 2) // 4)
            sfx = "_mma" if li else ""
            want = {f"kstep_mod{sfx}": passes, f"kstep_gpu_fwd{sfx}": passes,
                    f"kstep_gpu_bwd{sfx}": bwd, f"gpu_step{sfx}": 2}
            for k, n in launches.items():
                check(n == want.get(k, 0), f"{name} nt {nt_s}: {k} launched "
                                           f"{n} times, expected "
                                           f"{want.get(k, 0)}")
            if li and tier == "mxu":
                for k in split_names:
                    results[k]["launches"] = launches[k]
        rr_img = rel_rms(runs["auto"][1], runs[None][1])
        rr_dat = rel_rms(runs["auto"][0], runs[None][0])
        if tier == "mxu6":
            print(f"[split Pluto path] nt {nt_s}, mxu6 vs exact tiled: image "
                  f"rel RMS {rr_img:.3e} (gate 1e-5, the JAX envelope's), "
                  f"gathers rel RMS {rr_dat:.3e}", flush=True)
            check(rr_img <= 1e-5, f"Pluto mxu6 image {rr_img:.3e} > 1e-5")
        else:
            # The mxu drift from the exact taps is the lowering's own: the
            # plain path, which agrees with the JAX kernels pass by pass,
            # drifts as far at Pluto's sampling (scripts/
            # torch_split_drift.py), past the 1e-4 the JAX envelope (nt <=
            # 1500, dx = dz) expects. Reported; the port is held to its
            # plain split path on the card.
            ctx_m = solver.FDContext.from_params(ps_, exact_taper=False)
            g_s = Geometry.from_params(ps_)
            lap = solver.laplacian_of(ctx_s, 2, axis="z")
            v2_m = torch.from_numpy(pipeline.prepare_velocity_cpu(
                ps_, vp_pl)).to(dev)
            v2_r = pipeline.prepare_velocities_gpu(ps_, vp_pl, device=dev,
                                                   seed=0)
            plain_d = modeling_passes(
                ctx_m, v2_m, numerics.ricker_wavelet(
                    nt_s, ps_.dt, ps_.fpeak, truncated=True), g_s, 4, lap,
                "gaussian", "all")[2].transpose(1, 2).cpu().numpy()
            wav_r = numerics.ricker_wavelet(nt_s, ps_.dt, ps_.fpeak)
            snaps = solver.fd_forward(ctx_s, v2_r, wav_r, g_s.sx, g_s.sz, lap)
            plain_i = solver.fd_back(
                ctx_s, v2_r, *snaps, torch.from_numpy(runs["auto"][0]).to(dev),
                g_s.gz, lap).sum(0).cpu().numpy()
            rr_pd = rel_rms(runs["auto"][0], plain_d)
            rr_pi = rel_rms(runs["auto"][1], plain_i)
            print(f"[split Pluto path] nt {nt_s}, mxu vs its plain path on "
                  f"the card: gathers rel RMS {rr_pd:.3e}, image rel RMS "
                  f"{rr_pi:.3e} (gate {GATE}); vs exact tiled: image rel RMS "
                  f"{rr_img:.3e}, gathers rel RMS {rr_dat:.3e} (the JAX "
                  f"envelope expects <= 1e-4; the lowering drifts as far on "
                  f"the CPU)", flush=True)
            check(rr_pd <= GATE and rr_pi <= GATE,
                  f"Pluto mxu path vs plain: {rr_pd:.3e}, {rr_pi:.3e}")
            del v2_m, v2_r, snaps
        del runs, dat
    phase_done("Pluto path through the split tier")

    # ---- 27. times and traces of the split tier at the Pluto grid, 2
    # shots, nt = 1001, K = 4: each split kernel's calls (mxu), its plain
    # passes and the exact K-step kernel for the same function in turns;
    # the whole modeling and RTM calls per lowering; one trace of each
    # split call
    (ctx_pm, ctx_pr, v2_pm, v2_pr, wav_pm, wav_pr, d_p,
     gp) = tier_case(pt, PLUTO_VELOCITIES)
    cm = stream.prepare(ctx_pm, v2_pm, gp.sx, source="gaussian", taper="all")
    cr = stream.prepare(ctx_pr, v2_pr, gp.sx, source="point", taper="top")
    zero = torch.zeros((pt.ns, pt.nxe, pt.nze), device=dev)
    lap2 = solver.laplacian_of(ctx_pr, 2, axis="z")
    lap2m = solver.laplacian_of(ctx_pm, 2, axis="z")
    inj_p = d_p.flip(-1).transpose(1, 2).contiguous()
    pf = (zero, zero)
    for it0 in range(0, pt.nt, K):
        pf = stream.fd_forward_kstep_cuda(ctx_pr, *pf, v2_pr,
                                          wav_pr[it0:it0 + K], gp.sx, gp.sz,
                                          consts=cr, parts=2)
    seeded = solver._seed_steps(ctx_pr, v2_pr, *pf, inj_p, gp.gz,
                                functools.partial(stream.fd_step_gpu_cuda,
                                                  consts=cr, parts=2))

    def mod_call(parts):
        if parts is None:
            fn = lambda *a: solver.mod_kstep(*a, "gaussian", "all", lap2m)
        else:
            fn = lambda *a: stream.mod_kstep_cuda(*a, consts=cm, parts=parts)

        def run():
            p_, pp_ = zero, zero
            for it0 in range(0, pt.nt, K):
                p_, pp_, _ = fn(ctx_pm, p_, pp_, v2_pm, wav_pm[it0:it0 + K],
                                gp.sx, gp.sz, gp.gz)
        return run

    def fwd_call(parts):
        fn = ((lambda *a: solver.fd_forward_kstep(*a, lap2)) if parts is None
              else (lambda *a: stream.fd_forward_kstep_cuda(
                  *a, consts=cr, parts=parts)))

        def run():
            p_, pp_ = zero, zero
            for it0 in range(0, pt.nt, K):
                p_, pp_ = fn(ctx_pr, p_, pp_, v2_pr, wav_pr[it0:it0 + K],
                             gp.sx, gp.sz)
        return run

    def bwd_call(parts):
        fn = ((lambda *a: solver.fd_back_kstep(*a, lap2)) if parts is None
              else (lambda *a: stream.fd_back_kstep_cuda(
                  *a, consts=cr, parts=parts)))

        def run():
            st = seeded[:4] + (seeded[4].clone(),)
            for it0 in range(2, pt.nt, K):
                st = fn(ctx_pr, *st, v2_pr, inj_p[:, it0:it0 + K], gp.gz)
        return run

    img_t = seeded[4].clone()
    row0 = inj_p[:, 0]
    gpu_call = lambda parts: lambda: (
        solver.fd_step_gpu(ctx_pr, *pf, v2_pr, gp.gz, row0, img_t,
                           seeded[0], lap2) if parts is None
        else stream.fd_step_gpu_cuda(ctx_pr, *pf, v2_pr, gp.gz, row0, img_t,
                                     seeded[0], consts=cr, parts=parts))
    split_cases = {"kstep_mod_mma": (mod_call, 1),
                   "kstep_gpu_fwd_mma": (fwd_call, 1),
                   "kstep_gpu_bwd_mma": (bwd_call, 1),
                   "gpu_step_mma": (gpu_call, 10)}
    bounds2 = kstep_bounds(ctx_pr, pt.ns, K, parts=2)
    bounds3 = kstep_bounds(ctx_pr, pt.ns, K, parts=3)
    for k, (call, reps) in split_cases.items():
        tk, tk6, tp, te = in_turns([call(2), call(3), call(None), call(0)],
                                   reps=reps, once=(2,))
        bms, by = bounds2[k[:-4]]
        what = ("one call" if k == "gpu_step_mma"
                else f"{-(-(pt.nt - (2 if 'bwd' in k else 0)) // K)} passes "
                     f"of K={K}")
        print(f"[times] {k} at the Pluto grid ({pt.ns} shots, nt {pt.nt}, "
              f"{what}): kernel (mxu) {span(tk)}, mxu6 {span(tk6)}, plain "
              f"(mxu) {span(tp)}, exact kernel {k[:-4]} {span(te)}; bound "
              f"{bms:.3f} ms ({by}; mxu6 {bounds3[k[:-4]][0]:.3f}), kernel / "
              f"bound {statistics.median(tk) / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)
    del split_cases, seeded, img_t, pf

    split_calls = {}
    for li, name in ((None, "exact"), (2, "mxu"), (3, "mxu6")):
        split_calls["modeling", name] = (
            lambda li=li: solver.forward_modeling_tiled(
                ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz, block_k=K,
                lap_impl=li))
        split_calls["RTM", name] = (
            lambda li=li: solver.rtm_shot_snapshot_tiled(
                ctx_pr, v2_pr, wav_pr, d_p, gp.sx, gp.sz, gp.gz, block_k=K,
                lap_impl=li))
    split_ms = {}
    for label in ("modeling", "RTM"):
        names = ("exact", "mxu", "mxu6")
        ts = in_turns([split_calls[label, n] for n in names])
        for n, t in zip(names, ts):
            split_ms[label, n] = statistics.median(t)
            print(f"[times] Pluto tiled {label} {n} ({pt.ns} shots, nt "
                  f"{pt.nt}, K={K}): {span(t)}, "
                  f"{split_ms[label, n] / 1e3 / pt.ns:.6f} s/shot; {smi}",
                  flush=True)
    for (label, n), fn in split_calls.items():
        if n != "exact" and not profile(torch, f"Pluto tiled {label} {n}",
                                        fn, split_ms[label, n], smi):
            profile(torch, f"Pluto tiled {label} {n}", fn,
                    split_ms[label, n], smi)
    del split_calls, d_p, v2_pm, v2_pr, zero
    phase_done("split tier: times and profile")

    # ---- 28. the split-bf16 lowering of the per-step streaming tier and of
    # rtm_main's recording kernels (rows 8, 9, 10, 14): fd_step_mma,
    # fd_update_mma, gpu_step_mma (without and with the trace row and the
    # image), rec_fwd_step_mma and rec_bwd_step_mma against their plain
    # versions (the z taps in the same bf16 parts) on the same CUDA
    # tensors: one step from random states on phase 8's 67 x 88 grid at
    # orders 4-16 (fd_update_mma also on 164 x 78) and at the Pluto grid,
    # gate 1e-6 of max an apply; the rec loops (frames, frame and image
    # mode) on the 67 x 88 and 164 x 78 grids (nt=21), on 8 shots of 360 x
    # 360 (orders 8 and 16), at the Pluto grid (nt=5) and at 3lay (8
    # shots, nt=1001), gate 1e-5 for
    # the images, 1e-4 for the frames and final fields (the fields' floor
    # of the tensor cores' summation order over many steps, phase 23)
    split_k1 = ("fd_step_mma", "fd_update_mma", "rec_fwd_step_mma",
                "rec_bwd_step_mma")
    # gpu_step_mma's max abs err in the results is phase 25's (the main
    # path's seed steps)
    worst28 = dict.fromkeys(split_k1 + ("gpu_step_mma",), 0.0)

    def gate28(label, name, got, want, gate):
        """Prints and gates the largest errors of the kernel outputs got
        against the plain ones want (lists of output tuples)."""
        rel, absd = (max(e) for e in zip(*map(errs, got, want)))
        print(f"[split K=1 vs plain] {name} {label}: max rel err {rel:.3e} "
              f"(gate {gate}), max abs err {absd:.3e}", flush=True)
        check(rel <= gate, f"{name} {label}: {rel:.3e} > {gate}")
        worst28[name.split()[0]] = max(worst28[name.split()[0]], absd)

    def split_steps(label, case, parts, st, row, img):
        """fd_step_mma (both tapers; no injection, the Gaussian window, the
        point source, the receiver row at nzb), fd_update_mma (a velocity
        plane a shot) and gpu_step_mma (without and with the trace row at
        gz and the image, st[2] the source field), one step from the
        random state st."""
        ctx_m, ctx_r, v2_m, v2_r, _, _, _, gp_ = case
        lap = solver.laplacian_of(ctx_m, parts, axis="z")
        cases = [(taper, kw) for taper in ("all", "top") for kw in (
            {}, dict(amp=0.7, sx=gp_.sx, sz=gp_.sz),
            dict(amp=0.7, sx=gp_.sx, sz=gp_.sz, source="point"),
            dict(inj_row=row, x0=ctx_m.nzb, gz=gp_.gz))]
        gate28(f"{label} (both tapers, every injection)", "fd_step_mma",
               [stream.fd_step_cuda(ctx_m, *st[:2], v2_m, taper,
                                    parts=parts, **kw) for taper, kw in cases],
               [solver.fd_step(ctx_m, *st[:2], v2_m, taper, lap=lap, **kw)
                for taper, kw in cases], 1e-6)
        lap_r = solver.laplacian_of(ctx_r, parts, axis="z")
        gate28(label, "fd_update_mma",
               [stream.fd_update_cuda(ctx_r, *st[:2], v2_r, parts=parts)],
               [solver.fd_update(ctx_r, *st[:2], v2_r, lap_r)], 1e-6)
        gate28(f"{label} (without and with the trace row and the image)",
               "gpu_step_mma",
               [stream.fd_step_gpu_cuda(ctx_r, *st[:2], v2_r, parts=parts),
                stream.fd_step_gpu_cuda(ctx_r, *st[:2], v2_r, gp_.gz, row,
                                        img.clone(), st[2], parts=parts)],
               [solver.fd_step_gpu(ctx_r, *st[:2], v2_r, lap=lap_r),
                solver.fd_step_gpu(ctx_r, *st[:2], v2_r, gp_.gz, row,
                                   img.clone(), st[2], lap_r)], 1e-6)

    def split_rec(label, p_, dobs, parts, quirks=(True, False)):
        """rec_fwd_step_mma's frames and fields, rec_bwd_step_mma in frame
        mode (both receiver offsets) and in image mode, over p_.nt steps."""
        ctx, v2, wav, d, nxt = rec_inputs(p_, dobs)
        gp_ = Geometry.from_params(p_)
        lap = solver.laplacian_of(ctx, parts, axis="z")
        wf = dict(source="point", taper="top", record="wavefield")
        kf = fk.forward_modeling_cuda(ctx, v2, wav, gp_.sx, gp_.sz, gp_.gz,
                                      **wf, lap_impl=parts)
        pf = solver.forward_modeling(ctx, v2, wav, gp_.sx, gp_.sz, gp_.gz,
                                     **wf, lap_impl=parts)
        gate28(label, "rec_fwd_step_mma frames", [kf[2]], [pf[2]], 1e-4)
        gate28(label, "rec_fwd_step_mma fields", [kf[:2]], [pf[:2]], 1e-4)
        swf = pf[2]
        del kf, pf
        for quirk in quirks:
            kb = fk.backward_recorded_cuda(ctx, v2, d, gp_.gz,
                                           x_off_quirk=quirk,
                                           next_shot_first=nxt,
                                           lap_impl=parts)
            pb = solver.backward_recorded(ctx, v2, d, gp_.gz,
                                          x_off_quirk=quirk,
                                          next_shot_first=nxt, lap=lap)
            gate28(f"{label} x_off_quirk {quirk}", "rec_bwd_step_mma frames",
                   [kb[2]], [pb[2]], 1e-4)
            gate28(f"{label} x_off_quirk {quirk}", "rec_bwd_step_mma fields",
                   [kb[:2]], [pb[:2]], 1e-4)
            del kb, pb
        gate28(label, "rec_bwd_step_mma image",
               [fk.backward_image_cuda(ctx, v2, swf, d, gp_.gz,
                                       next_shot_first=nxt, lap_impl=parts)],
               [solver.backward_image(ctx, v2, swf, d, gp_.gz,
                                      next_shot_first=nxt, lap=lap)], GATE)
        del swf
        torch.cuda.synchronize()

    rng = np.random.default_rng(28)
    for order in range(4, 17, 2):
        p_ = dataclasses.replace(short, order=order)
        case = tier_case(p_)
        st = [randn(rng, p_.ns, case[0].nxe, case[0].nze) for _ in range(3)]
        row = randn(rng, p_.ns, p_.nx)
        img = randn(rng, p_.ns, p_.nx, p_.nz)
        for parts in (2, 3):
            label = f"order {order} parts {parts} 67 x 88"
            split_steps(label, case, parts, st, row, img)
            split_rec(f"{label} nt {p_.nt}", p_, case[6].cpu().numpy(),
                      parts)
    # the one-step body's shapes with tails: fd_update_mma's 128 x 64 twice
    # along x and z on 164 x 78 (the rec kernels' launchers take 32 x 64
    # there), and 8 shots of 360 x 360, where they take 64 x 64 (144 blocks
    # of 128 x 64 for 132 SMs)
    for order in range(4, 17, 2):
        p_ = dataclasses.replace(short, nx=150, nz=60, order=order)
        _, ctx_r, _, v2_r, _, _, d_, _ = tier_case(p_)
        st = [randn(rng, p_.ns, ctx_r.nxe, ctx_r.nze) for _ in range(2)]
        for parts in (2, 3):
            label = f"order {order} parts {parts} 164 x 78"
            gate28(label, "fd_update_mma",
                   [stream.fd_update_cuda(ctx_r, *st, v2_r, parts=parts)],
                   [solver.fd_update(ctx_r, *st, v2_r, solver.laplacian_of(
                       ctx_r, parts, axis="z"))], 1e-6)
            split_rec(f"{label} nt {p_.nt}", p_, d_.cpu().numpy(), parts)
            if order in (8, 16):
                p8 = dataclasses.replace(short, nx=320, nz=320, ns=8,
                                         nxb=20, nzb=20, order=order)
                split_rec(f"order {order} parts {parts} 8 x 360 x 360 nt "
                          f"{p8.nt}", p8, randn(rng, p8.ns, p8.nx, p8.nt)
                          .cpu().numpy(), parts, quirks=(True,))
    case = tier_case(pluto, PLUTO_VELOCITIES)
    st = [randn(rng, pluto.ns, pluto.nxe, pluto.nze) for _ in range(3)]
    row = randn(rng, pluto.ns, pluto.nx)
    img = randn(rng, pluto.ns, pluto.nx, pluto.nz)
    p5 = dataclasses.replace(pluto, nt=5)
    for parts in (2, 3):
        label = f"Pluto {pluto.nxe} x {pluto.nze} ns {pluto.ns} parts {parts}"
        split_steps(label, case, parts, st, row, img)
        split_rec(f"{label} nt 5", p5, case[6][..., :5].cpu().numpy(),
                  parts, quirks=(True,))
    del case, st, row, img
    for parts in (2, 3):
        split_rec(f"3lay ns {P.ns} nt {P.nt} parts {parts}", P, data, parts,
                  quirks=(True,))
    for k in split_k1:
        results[k]["max_abs_err"] = worst28[k]
    phase_done("split K=1 and rec kernels vs plain")

    # ---- 29. the Pluto K = 1 path through the split kernels: 2 shots,
    # nt=1001, the full grid: forward_modeling_tiled and
    # rtm_shot_snapshot_tiled at block_k=1 with lap_impl "auto" (= mxu at
    # nt=1001) and "mxu6", against the K = 4 split tier at the same
    # lap_impl and the exact K = 1 calls
    (ctx_pm, ctx_pr, v2_pm, v2_pr, wav_pm, wav_pr, d_p,
     gp) = tier_case(pt, PLUTO_VELOCITIES)
    check(fk.resolve_lap_impl(ctx_pr, "auto") == "mxu",
          "Pluto nt 1001: auto does not resolve to mxu")
    k1 = {}
    for li, k in (("auto", 1), ("auto", K), ("mxu6", 1), ("mxu6", K),
                  (None, 1)):
        fk.reset_launches()
        stream.reset_launches()
        t0 = time.perf_counter()
        gathers = solver.forward_modeling_tiled(
            ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz, block_k=k,
            lap_impl=li)[2]
        image = solver.rtm_shot_snapshot_tiled(
            ctx_pr, v2_pr, wav_pr, d_p, gp.sx, gp.sz, gp.gz, block_k=k,
            lap_impl=li)
        torch.cuda.synchronize()
        launches = {n: v for n, v in {**fk.LAUNCHES,
                                      **stream.LAUNCHES}.items() if v}
        print(f"[split K=1 Pluto] lap_impl={li!r} block_k={k}, Pluto "
              f"{pt.nxe} x {pt.nze}, ns {pt.ns}, nt {pt.nt}: modeling + RTM "
              f"{time.perf_counter() - t0:.3f} s wall; launches {launches}",
              flush=True)
        check(torch.isfinite(gathers).all() and torch.isfinite(image).all()
              and float(image.abs().max()) > 0,
              f"Pluto lap_impl {li} K {k}: outputs not finite or zero")
        if k == 1:
            sfx = "_mma" if li else ""
            want = {f"fd_step{sfx}": pt.nt, f"gpu_step{sfx}": 2 * pt.nt,
                    f"fd_update{sfx}": pt.nt - 2}
            check(launches == want, f"Pluto K=1 lap_impl {li}: launches "
                                    f"{launches}, expected {want}")
            if li == "auto":
                for n in ("fd_step_mma", "fd_update_mma"):
                    results[n]["launches"] = launches[n]
        k1[li, k] = (gathers.cpu(), image.cpu())
        del gathers, image
    rr29 = {}
    for li in ("auto", "mxu6"):
        for n, what in enumerate(("gathers", "image")):
            rr29[f"{li} K=1 vs K={K} {what}"] = rel_rms(k1[li, 1][n],
                                                        k1[li, K][n])
            rr29[f"{li} K=1 vs exact K=1 {what}"] = rel_rms(k1[li, 1][n],
                                                            k1[None, 1][n])
    print(f"[split K=1 Pluto] rel RMS {rr29} (gates: K=1 vs K={K} at the "
          f"same lap_impl 1e-5, mxu6 vs exact 1e-5; mxu vs exact reported)",
          flush=True)
    for key, v in rr29.items():
        if "vs K=" in key or key.startswith("mxu6"):
            check(v <= GATE, f"Pluto K=1 {key}: {v:.3e} > {GATE}")
    del k1
    phase_done("Pluto K=1 path through the split kernels")

    # ---- 30. rtm_main at the Pluto grid through the split kernels, 2
    # shots, nt=203 (cut for memory: swf is 13.6 GB at nt=203, 67 GB at
    # nt=1001): rtm_shot_full_tiled at K = 1 and 4 in exact, mxu and mxu6;
    # run_rtm_cpu(backend="tiled") in a subprocess with PFDC_LAP_IMPL=mxu6
    # (read at import); at 3lay, the split tier against its plain path and
    # the whole-grid tier under PFDC_LAP_IMPL=auto, which keeps the exact
    # taps
    (ctx_m, _, v2_m, _, wav_m, _, d, gp30) = tier_case(pluto,
                                                       PLUTO_VELOCITIES)
    nxt30 = torch.cat([d[1:, 0, 0], d.new_zeros(1)]).cpu().numpy()
    full = {}
    for li in (None, "mxu", "mxu6"):
        for k in (1, K):
            fk.reset_launches()
            stream.reset_launches()
            t0 = time.perf_counter()
            full[li, k] = solver.rtm_shot_full_tiled(
                ctx_m, v2_m, wav_m, d, gp30.sx, gp30.sz, gp30.gz,
                next_shot_first=nxt30, block_k=k, lap_impl=li).cpu()
            torch.cuda.synchronize()
            launches = {n: v for n, v in {**fk.LAUNCHES,
                                          **stream.LAUNCHES}.items() if v}
            print(f"[split rtm_main Pluto] lap_impl={li!r} block_k={k}, "
                  f"{pluto.nxe} x {pluto.nze}, ns {pluto.ns}, nt {pluto.nt}: "
                  f"{time.perf_counter() - t0:.3f} s wall; launches "
                  f"{launches}", flush=True)
            sfx = "_mma" if li else ""
            want = ({f"fd_step{sfx}": 2 * pluto.nt} if k == 1 else
                    {f"rec_fwd_step{sfx}": pluto.nt,
                     f"rec_bwd_step{sfx}": pluto.nt})
            check(launches == want and bool(full[li, k].isfinite().all()),
                  f"rtm_main Pluto lap_impl {li} K {k}: launches {launches}, "
                  f"expected {want}, or the image is not finite")
            if li == "mxu" and k == K:
                for n in ("rec_fwd_step_mma", "rec_bwd_step_mma"):
                    results[n]["launches"] = launches[n]
            torch.cuda.empty_cache()
    rr30 = {f"{li} K=1 vs K={K}": rel_rms(full[li, 1], full[li, K])
            for li in (None, "mxu", "mxu6")}
    rr30.update({f"{li} vs exact, K={K}": rel_rms(full[li, K], full[None, K])
                 for li in ("mxu", "mxu6")})
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "dobs.npy"), d.cpu().numpy())
        code = (
            "import json, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import numpy as np\n"
            f"from {PKG} import pipeline\n"
            f"from {PKG}.config import Params\n"
            f"from {PKG}.models import layered_model\n"
            f"from {PKG}.ops import fd_kernels as fk, stream\n"
            f"p = Params(**{dict(PLUTO, nt=pluto.nt)!r})\n"
            "vp = layered_model(p.nx, p.nz, "
            f"velocities={PLUTO_VELOCITIES!r})\n"
            "_, locs = pipeline.run_rtm_cpu(p, vp=vp, dobs=np.load("
            "sys.argv[1]), backend='tiled')\n"
            "np.save(sys.argv[2], locs)\n"
            "print(json.dumps({k: v for k, v in {**fk.LAUNCHES, "
            "**stream.LAUNCHES}.items() if v}))\n")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", code, os.path.join(tmp, "dobs.npy"),
             os.path.join(tmp, "locs.npy")], capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PFDC_LAP_IMPL="mxu6"))
        check(out.returncode == 0, f"run_rtm_cpu subprocess: {out.stderr}")
        sub_launches = json.loads(out.stdout.strip().splitlines()[-1])
        sub_locs = np.load(os.path.join(tmp, "locs.npy"))
    print(f"[split rtm_main Pluto] run_rtm_cpu(backend='tiled') with "
          f"PFDC_LAP_IMPL=mxu6 in a subprocess: "
          f"{time.perf_counter() - t0:.3f} s wall (start-up and build load "
          f"included); launches {sub_launches}", flush=True)
    check(sub_launches == {"rec_fwd_step_mma": pluto.nt,
                           "rec_bwd_step_mma": pluto.nt},
          f"run_rtm_cpu mxu6 launches {sub_launches}")
    rr30["run_rtm_cpu (PFDC_LAP_IMPL=mxu6) vs rtm_shot_full_tiled mxu6"] = (
        rel_rms(sub_locs, full["mxu6", K]))
    ctx3, v23, wav3, d3, nxt3 = rec_inputs(P, data)
    g3 = Geometry.from_params(P)
    rr30["3lay K=4 mxu vs its plain path"] = rel_rms(
        solver.rtm_shot_full_tiled(ctx3, v23, wav3, d3, g3.sx, g3.sz, g3.gz,
                                   next_shot_first=nxt3, block_k=K,
                                   lap_impl="mxu").cpu(),
        solver.rtm_shot_full(ctx3, v23, wav3, d3, g3.sx, g3.sz, g3.gz,
                             next_shot_first=nxt3, lap_impl="mxu").cpu())
    print(f"[split rtm_main] rel RMS {rr30} (gate {GATE}; mxu vs exact "
          f"reported)", flush=True)
    for key, v in rr30.items():
        if not key.startswith("mxu vs"):
            check(v <= GATE, f"rtm_main {key}: {v:.3e} > {GATE}")
    exact3 = pipeline.run_rtm_cpu(P, vp=vp, dobs=data, device=dev)[1]
    env_lap = fk._ENV_LAP_IMPL
    fk._ENV_LAP_IMPL = "auto"         # what PFDC_LAP_IMPL=auto sets
    try:
        fk.reset_launches()
        stream.reset_launches()
        auto3 = pipeline.run_rtm_cpu(P, vp=vp, dobs=data, device=dev)[1]
        torch.cuda.synchronize()
        launches = {n: v for n, v in {**fk.LAUNCHES,
                                      **stream.LAUNCHES}.items() if v}
    finally:
        fk._ENV_LAP_IMPL = env_lap
    print(f"[split rtm_main] 3lay run_rtm_cpu (whole-grid tier) under "
          f"PFDC_LAP_IMPL=auto: launches {launches}, images bitwise the "
          f"exact run's: {np.array_equal(auto3, exact3)}", flush=True)
    check(launches == {"rec_fwd_cluster": 1, "rec_bwd_cluster": 1}
          and np.array_equal(auto3, exact3),
          "the whole-grid rtm_main tier left the exact taps under auto")
    del full, d, v2_m, sub_locs, exact3, auto3
    torch.cuda.empty_cache()
    phase_done("rtm_main through the split kernels")

    # ---- 31. times and traces of the split K = 1 and rtm_main kernels:
    # fd_step_mma and fd_update_mma over 1001 launches at the Pluto grid (2
    # shots; phase 21's loops), gpu_step_mma over the RTM's 1001 receiver
    # launches there (the trace row and the image), rec_fwd_step_mma and
    # rec_bwd_step_mma (image mode) over 3lay's 8 shots x 1001 steps; each
    # against mxu6, its plain version (mxu, timed once) and its exact
    # twin, in turns; the whole Pluto K = 1 calls and the 3lay rtm_main
    # call per lowering; one trace of each split call
    c_mod = stream.prepare(ctx_pm, v2_pm, gp.sx, source="gaussian",
                           taper="all")
    c_rtm = stream.prepare(ctx_pr, v2_pr, gp.sx, source="point", taper="top")
    rng31 = np.random.default_rng(31)
    st = [randn(rng31, pt.ns, pt.nxe, pt.nze) for _ in range(5)]
    row31 = randn(rng31, pt.ns, pt.nx)
    img31 = torch.zeros((pt.ns, pt.nx, pt.nz), device=dev)
    mask_all = torch.as_tensor(ctx_pm.mask_all, device=dev)
    mask_top = torch.as_tensor(ctx_pr.mask_top, device=dev)
    patch = torch.as_tensor(ctx_pm.source_patch, device=dev)
    lap2m = solver.laplacian_of(ctx_pm, 2, axis="z")
    lap2r = solver.laplacian_of(ctx_pr, 2, axis="z")

    def k1_loop(update: bool, parts):
        """nt launches of fd_step(_mma) or fd_update(_mma); parts None: the
        plain version with the z taps in 2 bf16 parts."""
        def run():
            if update:
                for _ in range(pt.nt):
                    if parts is None:
                        solver.fd_update(ctx_pr, st[0], st[1], v2_pr, lap2r)
                    else:
                        stream.fd_update_cuda(ctx_pr, st[0], st[1], v2_pr,
                                              consts=c_rtm, out=st[2],
                                              parts=parts)
                return
            for amp in wav_pm:
                if parts is None:
                    solver._step(ctx_pm, st[0], st[1], v2_pm, mask_all,
                                 float(amp), gp.sx, gp.sz, patch, lap=lap2m)
                else:
                    stream.fd_step_cuda(ctx_pm, st[0], st[1], v2_pm, "all",
                                        amp=float(amp), sx=gp.sx, sz=gp.sz,
                                        consts=c_mod, out=st[2:4],
                                        parts=parts)
        return run

    b2, b3 = stream_bounds(ctx_pm, pt.ns, 2), stream_bounds(ctx_pm, pt.ns, 3)
    for k, update in (("fd_step_mma", False), ("fd_update_mma", True)):
        tk, tk6, tp, te = in_turns([k1_loop(update, 2), k1_loop(update, 3),
                                    k1_loop(update, None),
                                    k1_loop(update, 0)], once=(2,))
        bms, by = b2[k[:-4]]
        print(f"[times] {k} at the Pluto grid ({pt.ns} shots, {pt.nt} "
              f"launches): kernel (mxu) {span(tk)}, mxu6 {span(tk6)}, plain "
              f"(mxu) {span(tp)}, exact kernel {k[:-4]} {span(te)}; bound "
              f"{bms:.3f} ms ({by}; mxu6 {b3[k[:-4]][0]:.3f}), kernel / "
              f"bound {statistics.median(tk) / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)

    def gpu_loop(parts):
        """The RTM's nt receiver launches of gpu_step(_mma) from the state
        (st[1], st[0]), st[4] the source field; parts None: the plain
        step with the z taps in 2 bf16 parts. The results' gpu_step_mma
        entry stays phase 27's one-launch timing."""
        def run():
            for _ in range(pt.nt):
                if parts is None:
                    solver._gpu_step(ctx_pr, st[0], st[1], v2_pr, mask_top,
                                     gp.gz, row31, img31, st[4], lap2r)
                else:
                    stream.fd_step_gpu_cuda(ctx_pr, st[0], st[1], v2_pr,
                                            gp.gz, row31, img31, st[4],
                                            consts=c_rtm, out=st[2:4],
                                            parts=parts)
        return run

    tk, tk6, tp, te = in_turns([gpu_loop(2), gpu_loop(3), gpu_loop(None),
                                gpu_loop(0)], once=(2,))
    (bms, by), (bfw, bfy) = b2["gpu_step"], b2["gpu_step forward"]
    print(f"[times] gpu_step_mma at the Pluto grid ({pt.ns} shots, {pt.nt} "
          f"receiver launches, the trace row and the image): kernel (mxu) "
          f"{span(tk)}, mxu6 {span(tk6)}, plain (mxu) {span(tp)}, exact "
          f"kernel gpu_step {span(te)}; bound {bms:.3f} ms ({by}; mxu6 "
          f"{b3['gpu_step'][0]:.3f}; {pt.nt} forward launches, no trace row "
          f"and no image: {bfw:.3f} ms, {bfy}), kernel / bound "
          f"{statistics.median(tk) / bms:.2f}; {smi}", flush=True)
    del st, c_mod, c_rtm, row31, img31, mask_top
    ctx3, v23, wav3, d3, nxt3 = rec_inputs(P, data)
    g3 = Geometry.from_params(P)
    wf = dict(source="point", taper="top", record="wavefield")
    swf3 = fk.forward_modeling_cuda(ctx3, v23, wav3, g3.sx, g3.sz, g3.gz,
                                    **wf, lap_impl=2)[2]
    lap3 = solver.laplacian_of(ctx3, 2, axis="z")
    rec_calls = {
        "rec_fwd_step_mma": lambda parts: (
            (lambda: solver.forward_modeling(ctx3, v23, wav3, g3.sx, g3.sz,
                                             g3.gz, **wf, lap_impl=2))
            if parts is None else
            (lambda: fk.forward_modeling_cuda(ctx3, v23, wav3, g3.sx, g3.sz,
                                              g3.gz, **wf, lap_impl=parts))),
        "rec_bwd_step_mma": lambda parts: (
            (lambda: solver.backward_image(ctx3, v23, swf3, d3, g3.gz,
                                           next_shot_first=nxt3, lap=lap3))
            if parts is None else
            (lambda: fk.backward_image_cuda(ctx3, v23, swf3, d3, g3.gz,
                                            next_shot_first=nxt3,
                                            lap_impl=parts)))}
    b2, b3 = step_bounds(ctx3, P.ns, 2), step_bounds(ctx3, P.ns, 3)
    for k, call in rec_calls.items():
        tk, tk6, tp, te = in_turns([call(2), call(3), call(None), call(0)],
                                   once=(2,))
        bms, by = b2[k[:-4]]
        print(f"[times] {k} at 3lay ({P.ns} shots, {P.nt} launches"
              f"{', image mode' if 'bwd' in k else ''}): kernel (mxu) "
              f"{span(tk)}, mxu6 {span(tk6)}, plain (mxu) {span(tp)}, exact "
              f"kernel {k[:-9]}_cluster {span(te)}; bound {bms:.3f} ms "
              f"({by}; mxu6 "
              f"{b3[k[:-4]][0]:.3f}), kernel / bound "
              f"{statistics.median(tk) / bms:.2f}; {smi}", flush=True)
        results[k].update(ms=statistics.median(tk),
                          plain_ms=statistics.median(tp), bound_ms=bms,
                          bound_by=by, library_ms=None)
    k1_calls = {}
    for li, name in ((None, "exact"), (2, "mxu"), (3, "mxu6")):
        k1_calls["modeling K=1", name] = (
            lambda li=li: solver.forward_modeling_tiled(
                ctx_pm, v2_pm, wav_pm, gp.sx, gp.sz, gp.gz, block_k=1,
                lap_impl=li))
        k1_calls["RTM K=1", name] = (
            lambda li=li: solver.rtm_shot_snapshot_tiled(
                ctx_pr, v2_pr, wav_pr, d_p, gp.sx, gp.sz, gp.gz, block_k=1,
                lap_impl=li))
        k1_calls["3lay rtm_main", name] = (
            lambda li=li: fk.rtm_full_cuda(ctx3, v23, wav3, d3, g3.sx, g3.sz,
                                           g3.gz, next_shot_first=nxt3,
                                           lap_impl=li))
    k1_ms = {}
    for label in ("modeling K=1", "RTM K=1", "3lay rtm_main"):
        names = ("exact", "mxu", "mxu6")
        ts = in_turns([k1_calls[label, n] for n in names])
        for n, t in zip(names, ts):
            k1_ms[label, n] = statistics.median(t)
            ns_ = P.ns if label.startswith("3lay") else pt.ns
            print(f"[times] {'' if label.startswith('3lay') else 'Pluto '}"
                  f"{label} {n} ({ns_} shots, nt 1001): {span(t)}, "
                  f"{k1_ms[label, n] / 1e3 / ns_:.6f} s/shot; {smi}",
                  flush=True)
    for (label, n), fn in k1_calls.items():
        if n != "exact":
            profile(torch, f"{label} {n}", fn, k1_ms[label, n], smi)
    del k1_calls, swf3, d_p, v2_pm, v2_pr
    phase_done("split K=1 and rtm_main: times and profile")

    # ---- 32. the split-bf16 lowering of the domain tiers' block kernels
    # (rows 15-16): block_*_mma and block2_*_mma against their plain block
    # functions with the x taps in the same bf16 parts, on the same CUDA
    # tensors, launch by launch on random states of every slab or tile
    # (seeded, full and tail blocks): phases 11 and 16's 134 x 88 grid and
    # meshes at orders 4, 8 and 10, K = 2, 3 and 8, parts 2 and 3, and the
    # split makers on a mesh of cuda:0 against a CPU mesh; every split twin
    # alone at K = 5 and 7 (two unequal passes) and 8 at orders 8, 12, 14
    # and 16; then the Pluto slab and tile shapes (2 shots, K = 8 and the
    # tails 4 and 1). Gates:
    # traces and images 1e-5 max rel, fields 1e-4 (each mma sums its 16
    # products in the card's order)
    SPLIT_GATES = {"fields": 1e-4, "traces": GATE, "image": GATE}

    def split_blocks(tier2: bool, parts: int):
        """(name, wrapper, plain version) of a tier's three split kernels
        with ``parts`` bf16 splits."""
        wraps = ((d2k.block2_mod_cuda, d2k.block2_fwd_cuda,
                  d2k.block2_bwd_cuda) if tier2 else
                 (dk.block_mod_cuda, dk.block_fwd_cuda, dk.block_bwd_cuda))
        stem = "block2_" if tier2 else "block_"
        return tuple(
            (f"{stem}{n}_mma", functools.partial(w, parts=parts),
             functools.partial(plain, parts=parts))
            for n, w, plain in zip(("mod", "fwd", "bwd"), wraps,
                                   (dk.block_mod, dk.block_fwd,
                                    dk.block_bwd)))

    def split_errs(ms, rs, fields, imgs, amps, ks, blocks):
        """{(kernel, "fields" | "traces" | "image"): (max rel err, max abs
        err)} of each split kernel against its plain version, launch by
        launch as :func:`block_errs` runs the exact ones."""
        (nm, km, pm), (nf, kf, pf), (nb, kb, pb) = blocks
        out = {}

        def note(name, kinds, got, want):
            for kind, a, b in zip(kinds, got, want):
                old = out.get((name, kind), (0.0, 0.0))
                out[name, kind] = (max(old[0], max_rel(a, b)),
                                   max(old[1], float((a - b).abs().max())))

        bwd_kinds = ("fields",) * 4 + ("image",)
        for cm, cr, f, img in zip(ms, rs, fields, imgs):
            for kk in ks:
                a = amps[:kk]
                for c in (cm, cr):
                    note(nm, ("fields", "fields", "traces"),
                         km(c, f[0], f[1], a), pm(c, f[0], f[1], a))
                note(nf, ("fields", "fields"), kf(cr, f[0], f[1], a),
                     pf(cr, f[0], f[1], a))
                note(nb, bwd_kinds, kb(cr, *f[:4], img.clone(), ks[0], kk),
                     pb(cr, *f[:4], img, ks[0], kk))
            if ks[0] > 1:
                note(nb, bwd_kinds,
                     kb(cr, *f[:4], img.clone(), 0, ks[0], f[4:6]),
                     pb(cr, *f[:4], img, 0, ks[0], f[4:6]))
        torch.cuda.synchronize()
        return out

    def split_tiles(case, shape, k):
        """The modeling and RTM tiles of shot group 0 of a mesh of
        ``shape`` on cuda:0 (slabs on a (shot, x) mesh), blocks of k."""
        ctx_m, ctx_r, v2_m, v2_r, _, _, d, gp_ = case
        geom = (d2k.tile_geometry(ctx_m, shape[1], shape[2], k)
                if len(shape) == 3 else dk.slab_geometry(ctx_m, shape[1], k))
        grid = make_mesh(*shape, devices=[dev] * int(np.prod(shape))).grid(0)
        return (dk.prepare_tiles(ctx_m, grid, geom, v2_m, "all", sxs=gp_.sx,
                                 sz=gp_.sz, source="gaussian", gz=gp_.gz),
                dk.prepare_tiles(ctx_r, grid, geom, v2_r, "top", sxs=gp_.sx,
                                 sz=gp_.sz, gz=gp_.gz, dobs_ext=embed_dobs(
                                     ctx_r, d.cpu().numpy())))

    def split_case(case, shape, ks, parts, seed):
        """:func:`split_errs` on random states of every tile of a mesh of
        ``shape``, blocks of ks[0] steps and the tails ks[1:]."""
        ms, rs = split_tiles(case, shape, ks[0])
        rng = np.random.default_rng(seed)
        amps = rng.standard_normal(ks[0]).astype(np.float32)
        fields = [[randn(rng, c.ns, c.nxw, c.nzw) for _ in range(6)]
                  for c in ms]
        imgs = [randn(rng, c.ns, c.nxl, c.nzl) for c in ms]
        return split_errs(ms, rs, fields, imgs, amps, ks,
                          split_blocks(len(shape) == 3, parts))

    def split_makers(case, shape, k, parts):
        """The tier's two makers with lap_impl "mxu" (parts 2) or "mxu6" on
        a (2, ...) mesh of cuda:0 against the same makers on a CPU mesh
        (the plain split block functions): (max rel err, max abs err)."""
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r, d, gp_ = case
        d_ext = embed_dobs(ctx_r, d.cpu().numpy())
        mshape = (2,) + shape[1:]
        n = int(np.prod(mshape))
        mod, rtm = ((d2k.make_sharded_forward_modeling_2d_cuda,
                     d2k.make_sharded_rtm_snapshot_2d_cuda)
                    if len(shape) == 3 else
                    (dk.make_sharded_forward_modeling_cuda,
                     dk.make_sharded_rtm_snapshot_cuda))
        li = "mxu" if parts == 2 else "mxu6"
        out = []
        for devices in ([dev] * n, ["cpu"] * n):
            mesh = make_mesh(*mshape, devices=devices)
            out.append((
                mod(ctx_m, mesh, gp_.sz, gp_.gz, block_k=k, lap_impl=li)(
                    v2_m, gp_.sx, wav_m).cpu(),
                rtm(ctx_r, mesh, gp_.sz, gp_.gz, block_k=k, lap_impl=li)(
                    v2_r, gp_.sx, wav_r, d_ext).cpu()))
        return errs(out[0], out[1])

    split_err = {f"{s}{n}_mma": 0.0 for s in ("block_", "block2_")
                 for n in ("mod", "fwd", "bwd")}

    def hold(label, found):
        """Prints one line per kernel of ``found`` (split_errs) and checks
        the gates; keeps the largest abs error of each kernel."""
        for kname in sorted({kn for kn, _ in found}):
            kinds = {kind: found[kn, kind] for kn, kind in found
                     if kn == kname}
            print(f"[split domain vs plain] {kname} {label}: " + ", ".join(
                f"{kind} max rel err {rel:.3e}" for kind, (rel, _)
                in sorted(kinds.items())) + ", max abs err "
                f"{max(a for _, a in kinds.values()):.3e}", flush=True)
            for kind, (rel, absd) in kinds.items():
                check(rel <= SPLIT_GATES[kind],
                      f"{kname} {label}: {kind} {rel:.3e} > "
                      f"{SPLIT_GATES[kind]}")
                split_err[kname] = max(split_err[kname], absd)

    n_cases = 0
    for order in (4, 8, 10):
        case_x = tier_case(dataclasses.replace(dom, order=order))
        case_z = tier_case(dataclasses.replace(dom2, order=order))
        case_z = case_z[:7] + (dataclasses.replace(case_z[7], sx=(66, 67)),)
        for shape in ((1, 2), (1, 4), (1, 2, 2), (1, 1, 4)):
            nxl = -(-dom.nxe // shape[1])
            case = case_z if len(shape) == 3 else case_x
            if len(shape) == 2:
                case = case[:7] + (dataclasses.replace(
                    case[7], sx=(nxl - 1, nxl)),)
            nzl = -(-dom.nze // shape[2]) if len(shape) == 3 else dom.nze
            for k in (2, 3, 8):
                halo = k * order // 2
                if (shape[1] > 1 and halo > nxl) or (
                        len(shape) == 3 and shape[2] > 1 and halo > nzl):
                    continue
                for parts in (2, 3):
                    hold(f"order {order} mesh {shape} K {k} parts {parts}",
                         split_case(case, shape, (k, k - 1) if k > 1
                                    else (k,), parts,
                                    order * 1000 + k * 10 + parts))
                    n_cases += 1
                    if k == 3 and shape in ((1, 4), (1, 2, 2)):
                        rel, absd = split_makers(case, shape, k, parts)
                        print(f"[split domain vs plain] makers mesh "
                              f"{(2,) + shape[1:]} cuda:0 vs CPU order "
                              f"{order} K {k} parts {parts}: max rel err "
                              f"{rel:.3e}, max abs err {absd:.3e}",
                              flush=True)
                        check(rel <= GATE, f"split makers {shape} order "
                                           f"{order} parts {parts}: {rel:.3e}")

    def split_pass_case(case, shape, k, parts, seed):
        """:func:`split_errs` of the three split twins (two passes above 4
        steps) on random states of every tile of a mesh of ``shape``, a
        block of k steps, the modeling twin in both source modes, the
        backward seeded and not."""
        ms, rs = split_tiles(case, shape, k)
        blocks = split_blocks(len(shape) == 3, parts)
        rng = np.random.default_rng(seed)
        amps = rng.standard_normal(k).astype(np.float32)
        out = {}

        def note(name, kinds, got, want):
            for kind, a, b in zip(kinds, got, want):
                old = out.get((name, kind), (0.0, 0.0))
                out[name, kind] = (max(old[0], max_rel(a, b)),
                                   max(old[1], float((a - b).abs().max())))

        for cm, cr in zip(ms, rs):
            f = [randn(rng, cr.ns, cr.nxw, cr.nzw) for _ in range(6)]
            img = randn(rng, cr.ns, cr.nxl, cr.nzl)
            name, km, pm = blocks[0]
            for c in (cm, cr):
                note(name, ("fields", "fields", "traces"),
                     km(c, f[0], f[1], amps), pm(c, f[0], f[1], amps))
            name, kf, pf = blocks[1]
            note(name, ("fields", "fields"), kf(cr, f[0], f[1], amps),
                 pf(cr, f[0], f[1], amps))
            name, kb, pb = blocks[2]
            for it0, snaps in ((k, None), (0, f[4:6])):
                note(name, ("fields",) * 4 + ("image",),
                     kb(cr, *f[:4], img.clone(), it0, k, snaps),
                     pb(cr, *f[:4], img, it0, k, snaps))
        torch.cuda.synchronize()
        return out

    # the split twins run two passes above 4 steps: unequal splits (K = 5:
    # 3 + 2, K = 7: 4 + 3) and K = 8, the pipelines' choice at every order,
    # at orders 8, 12, 14 and 16, where the tiles take them
    for order in (8, 12, 14, 16):
        case_x = tier_case(dataclasses.replace(dom, order=order))
        case_z = tier_case(dataclasses.replace(dom2, order=order))
        for shape in ((1, 2), (1, 2, 2)):
            nxl = -(-dom.nxe // shape[1])
            nzl = -(-dom.nze // shape[2]) if len(shape) == 3 else dom.nze
            for k in (5, 7, 8):
                halo = k * order // 2
                if halo > nxl or (len(shape) == 3 and halo > nzl):
                    continue
                for parts in (2, 3):
                    hold(f"order {order} mesh {shape} K {k} parts {parts}",
                         split_pass_case(case_z if len(shape) == 3
                                         else case_x, shape, k, parts,
                                         order * 1000 + k * 10 + parts))
                    n_cases += 1
    print(f"[split domain vs plain] {n_cases} cases on {dom.nxe} x "
          f"{dom.nze}, nt {dom.nt}", flush=True)
    (ctx_pm, ctx_pr, v2_pm, v2_pr, wav_pm, wav_pr, d_p,
     gp) = case_p = tier_case(pt, PLUTO_VELOCITIES)
    for shape in ((1, 4), (1, 2, 2)):
        for parts in (2, 3):
            hold(f"at the Pluto grid ({pt.nxe} x {pt.nze}, {pt.ns} shots, "
                 f"mesh {shape}, K {KD}, 4, 1, parts {parts})",
                 split_case(case_p, shape, (KD, 4, 1), parts, 32 + parts))
    for k in split_err:
        results[k]["max_abs_err"] = split_err[k]
    phase_done("split domain kernels vs plain")

    # ---- 33. the 3lay path over (1, 4) and (1, 2, 2) meshes of cuda:0
    # with lap_impl "auto" (= mxu) and "mxu6", against the no-mesh run at
    # the same lap_impl (the per-step *_step_mma tier, the same x lowering)
    for li in ("auto", "mxu6"):
        data_li = pipeline.run_modeling(P, vp=vp, device=dev, lap_impl=li)
        ref_li = (data_li, *pipeline.run_rtm_gpu(
            P, vp=vp, dobs=data_li, seed=0, device=dev, lap_impl=li))
        for shape in ((1, 4), (1, 2, 2)):
            mesh = make_mesh(*shape, devices=[dev] * 4)
            for lc in (fk, stream, dk, d2k):
                lc.reset_launches()
            t0 = time.perf_counter()
            data_m = pipeline.run_modeling(P, vp=vp, mesh=mesh, lap_impl=li)
            img_m3, locs_m3 = pipeline.run_rtm_gpu(
                P, vp=vp, dobs=data_m, seed=0, mesh=mesh, lap_impl=li)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rr3 = [rel_rms(a, b) for a, b in zip((data_m, img_m3, locs_m3),
                                                 ref_li)]
            lc = d2k if len(shape) == 3 else dk
            launched = {k: n for k, n in {**fk.LAUNCHES, **stream.LAUNCHES,
                                          **dk.LAUNCHES,
                                          **d2k.LAUNCHES}.items() if n}
            print(f"[split 3lay mesh path] lap_impl={li!r} mesh {shape}: "
                  f"run_modeling + run_rtm_gpu {wall:.3f} s wall; launches "
                  f"{launched}; vs the no-mesh run at the same lap_impl: "
                  f"gathers rel RMS {rr3[0]:.3e}, image {rr3[1]:.3e}, "
                  f"per-shot images {rr3[2]:.3e}", flush=True)
            check(max(rr3) <= GATE, f"3lay {li} mesh {shape} differs")
            check(set(launched) == {k for k in lc.LAUNCHES
                                    if k.endswith("_mma")},
                  f"3lay {li} mesh {shape}: launches {launched}")
    del ref_li, data_li, data_m
    phase_done("split 3lay mesh paths")

    # ---- 34. the Pluto domain paths through the split kernels: the full
    # grid, 2 shots, nt = 1001 (auto resolves to mxu), run_modeling then
    # run_rtm_gpu over (1, 4) and (1, 2, 2) meshes of cuda:0 under auto and
    # mxu6, and exact: launch counts (only the tier's _mma kernels), the
    # gathers and images against the per-step tier at the same lap_impl,
    # mxu6 against the exact domain run, mxu's drift from it (reported),
    # wall s/shot
    check(fk.resolve_lap_impl(ctx_pr, "auto") == "mxu",
          "Pluto nt 1001: auto does not resolve to mxu")
    step_ref = {}
    for li in ("auto", "mxu6"):
        dat = pipeline.run_modeling(pt, vp=vp_pl, device=dev,
                                    backend="pallas", lap_impl=li)
        step_ref[li] = (dat, *pipeline.run_rtm_gpu(
            pt, vp=vp_pl, dobs=dat, seed=0, device=dev, backend="pallas",
            lap_impl=li))
    for shape in ((1, 4), (1, 2, 2)):
        mesh = make_mesh(*shape, devices=[dev] * 4)
        lc = d2k if len(shape) == 3 else dk
        runs = {}
        for li in ("auto", "mxu6", None):
            for c in (fk, stream, dk, d2k):
                c.reset_launches()
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                dat = pipeline.run_modeling(pt, vp=vp_pl, mesh=mesh,
                                            lap_impl=li)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                img_s, locs_s = pipeline.run_rtm_gpu(
                    pt, vp=vp_pl, dobs=dat, seed=0, outdir=tmp, mesh=mesh,
                    lap_impl=li)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                written = np.fromfile(os.path.join(tmp, "dir.image"),
                                      np.float32)
            runs[li] = (dat, img_s, locs_s)
            launched = {k: n for k, n in {**fk.LAUNCHES, **stream.LAUNCHES,
                                          **dk.LAUNCHES,
                                          **d2k.LAUNCHES}.items() if n}
            name = {"auto": "mxu", None: "exact"}.get(li, li)
            print(f"[split Pluto domain path] lap_impl={li!r} ({name}), "
                  f"mesh {shape} of cuda:0, Pluto {pt.nxe} x {pt.nze}, nt "
                  f"{pt.nt} (cut from {PLUTO['nt']}), ns {pt.ns}, K {KD}: "
                  f"run_modeling {t1 - t0:.3f} s wall "
                  f"({(t1 - t0) / pt.ns:.3f} s/shot), run_rtm_gpu "
                  f"{t2 - t1:.3f} s wall ({(t2 - t1) / pt.ns:.3f} s/shot), "
                  f"host included; launches {launched}; {smi}", flush=True)
            check(np.isfinite(dat).all() and np.abs(dat).max() > 0
                  and written.tobytes() == img_s.tobytes()
                  and np.isfinite(img_s).all() and np.abs(img_s).max() > 0,
                  f"{name} mesh {shape}: outputs not finite, zero or "
                  f"dir.image differs")
            want = {k: block_launches(k, pt.nt, KD, 4) for k in lc.LAUNCHES
                    if k.endswith("_mma") == bool(li)}
            check(launched == want, f"{name} mesh {shape}: launches "
                                    f"{launched}, expected {want}")
            if li == "auto":
                for k in want:
                    results[k]["launches"] = launched[k]
            if li:
                rr = [rel_rms(a, b) for a, b in zip(runs[li], step_ref[li])]
                print(f"[split Pluto domain path] {name} mesh {shape} vs the "
                      f"per-step tier at lap_impl={li!r}: gathers rel RMS "
                      f"{rr[0]:.3e}, image {rr[1]:.3e}, per-shot images "
                      f"{rr[2]:.3e} (gate {GATE})", flush=True)
                check(max(rr) <= GATE, f"Pluto {name} mesh {shape} differs "
                                       f"from the per-step tier")
        rr6 = [rel_rms(a, b) for a, b in zip(runs["mxu6"][:2], runs[None])]
        rr3 = [rel_rms(a, b) for a, b in zip(runs["auto"][:2], runs[None])]
        print(f"[split Pluto domain path] mesh {shape}: mxu6 vs the exact "
              f"domain run: gathers rel RMS {rr6[0]:.3e}, image {rr6[1]:.3e}"
              f" (gate 1e-5); mxu vs exact: gathers {rr3[0]:.3e}, image "
              f"{rr3[1]:.3e} (reported: the lowering's own drift at Pluto's "
              f"sampling, scripts/torch_split_drift.py)", flush=True)
        check(max(rr6) <= 1e-5, f"Pluto mxu6 mesh {shape} vs exact")
    del runs, step_ref, dat
    phase_done("split Pluto domain paths")

    # ---- 35. times and traces of the split block kernels at the Pluto
    # shapes (2 shots, nt = 1001, K = 8): each kernel's launches over the
    # four slabs or tiles (mxu and mxu6), its plain version (mxu) and its
    # exact twin (once each: phases 14 and 18 hold the twins' medians), in
    # turns, against block_bounds(parts=); then one trace of each split
    # maker call (mxu), with the share of the copy kernels and the idle
    # share
    d_ext_p = embed_dobs(ctx_pr, d_p.cpu().numpy())
    for shape in ((1, 4), (1, 2, 2)):
        tier2 = len(shape) == 3
        ms_s, rs_s = split_tiles(case_p, shape, KD)
        rng = np.random.default_rng(35)
        st_s = [[randn(rng, pt.ns, c.nxw, c.nzw) for _ in range(6)]
                for c in rs_s]
        imgs_s = [randn(rng, pt.ns, c.nxl, c.nzl) for c in rs_s]
        outs_s = [[torch.zeros_like(st_s[j][0]) for _ in range(4)]
                  for j in range(4)]
        runners = {p_: block_runner(split_blocks(tier2, p_), ms_s, rs_s,
                                    st_s, imgs_s, outs_s) for p_ in (2, 3)}
        exact_run = block_runner(XZ_BLOCKS if tier2 else X_BLOCKS, ms_s,
                                 rs_s, st_s, imgs_s, outs_s)
        n_xz = (shape[1], shape[2] if tier2 else 1)
        stem = "block2_" if tier2 else "block_"
        b2, b3 = ({**block_bounds(ctx_pr, pt.ns, KD, *n_xz, gp.gz, parts=p_),
                   f"{stem}mod_mma": block_bounds(
                       ctx_pm, pt.ns, KD, *n_xz, gp.gz,
                       parts=p_)[f"{stem}mod_mma"]} for p_ in (2, 3))
        for i, (k, _, _) in enumerate(split_blocks(tier2, 2)):
            tk, tk6, tp, te = in_turns(
                [runners[2](i, True), runners[3](i, True),
                 runners[2](i, False), exact_run(i, True)],
                once=(2, 3))
            bms, by = b2[k]
            print(f"[times] {k} at the Pluto grid ({pt.ns} shots, nt "
                  f"{pt.nt}, 4 {'tiles' if tier2 else 'slabs'} of "
                  f"{rs_s[0].nxw} x {rs_s[0].nzw}, "
                  f"{block_launches(k, pt.nt, KD, 4)} launches of "
                  f"K={KD}): kernel (mxu) {span(tk)}, mxu6 {span(tk6)}, "
                  f"plain (mxu) {span(tp)}, exact kernel {k[:-4]} "
                  f"{span(te)}; bound {bms:.3f} ms ({by}; mxu6 "
                  f"{b3[k][0]:.3f}), kernel / bound "
                  f"{statistics.median(tk) / bms:.2f}; {smi}", flush=True)
            results[k].update(ms=statistics.median(tk),
                              plain_ms=statistics.median(tp), bound_ms=bms,
                              bound_by=by, library_ms=None)
        del st_s, imgs_s, outs_s, ms_s, rs_s, runners, exact_run
        mesh = make_mesh(*shape, devices=[dev] * 4)
        mk = ((d2k.make_sharded_forward_modeling_2d_cuda,
               d2k.make_sharded_rtm_snapshot_2d_cuda) if tier2 else
              (dk.make_sharded_forward_modeling_cuda,
               dk.make_sharded_rtm_snapshot_cuda))
        smod = mk[0](ctx_pm, mesh, gp.sz, gp.gz, block_k=KD, lap_impl="mxu")
        srtm = mk[1](ctx_pr, mesh, gp.sz, gp.gz, block_k=KD, lap_impl="mxu")
        for label, fn in (("modeling", lambda: smod(v2_pm, gp.sx, wav_pm)),
                          ("RTM", lambda: srtm(v2_pr, gp.sx, wav_pr,
                                               d_ext_p))):
            call_ms = event_ms(fn)
            label = f"Pluto {label} mxu, mesh {shape}"
            print(f"[times] {label} ({pt.ns} shots, nt {pt.nt}): "
                  f"{call_ms:.3f} ms (one sample), "
                  f"{call_ms / 1e3 / pt.ns:.6f} s/shot; {smi}", flush=True)
            rows = profile(torch, label, fn, call_ms, smi)
            busy = sum(t for _, t, _ in rows)
            copies = sum(t for key, t, _ in rows if "copy" in key.lower()
                         and "HtoD" not in key and "DtoH" not in key
                         and "CatArray" not in key)
            print(f"[profile] {label}: copy kernels (the exchange, trace "
                  f"rows, tile set-up) {copies:.3f} ms, share of the call "
                  f"{copies / call_ms:.3f}; idle share "
                  f"{1 - busy / call_ms:.3f}; {smi}", flush=True)
    del d_p, v2_pm, v2_pr, d_ext_p, case_p
    phase_done("split domain kernels: times and profile")

    # ---- 36. order 12 on the pipelines' chosen K: run_modeling and
    # run_rtm_gpu at 3lay through backend="tiled" and over a (1, 2) and a
    # (1, 2, 2) mesh of cuda:0, against the per-step tier; then the split
    # modeling over the same meshes at the K its pipeline chooses (8, the
    # JAX package's), against the per-step split tier
    p12 = dataclasses.replace(P, order=12)
    ctx12 = solver.FDContext.from_params(p12)
    dat12 = pipeline.run_modeling(p12, vp=vp, device=dev, backend="pallas")
    img12 = pipeline.run_rtm_gpu(p12, vp=vp, dobs=dat12, seed=0, device=dev,
                                 backend="pallas")[0]
    runs12 = {"backend tiled": (dict(device=dev, backend="tiled"),
                                stream.tiled_block_k(ctx12, (
                                    "kstep_gpu_fwd", "kstep_gpu_bwd")))}
    for shape in ((1, 2), (1, 2, 2)):
        mesh = make_mesh(*shape, devices=[dev] * int(np.prod(shape)))
        runs12[f"mesh {shape}"] = (dict(mesh=mesh), pipeline._block_k(
            ctx12, mesh, p12.nt // 2, ("block_fwd", "block_bwd"), None))
    for label, (kw, k12) in runs12.items():
        for c in (fk, stream, dk, d2k):
            c.reset_launches()
        got_d = pipeline.run_modeling(p12, vp=vp, **kw)
        got_i = pipeline.run_rtm_gpu(p12, vp=vp, dobs=got_d, seed=0, **kw)[0]
        torch.cuda.synchronize()
        launched = {k: n for c in (fk, stream, dk, d2k)
                    for k, n in c.LAUNCHES.items() if n}
        rr = (rel_rms(got_d, dat12), rel_rms(got_i, img12))
        print(f"[order 12] 3lay {label}, RTM K {k12}: launches {launched}; "
              f"vs the per-step tier: gathers rel RMS {rr[0]:.3e}, image "
              f"rel RMS {rr[1]:.3e} (gate {GATE})", flush=True)
        check(launched and max(rr) <= GATE, f"order 12 {label} differs "
                                             f"from the per-step tier")
    dat12s = pipeline.run_modeling(p12, vp=vp, device=dev, backend="pallas",
                                   lap_impl="mxu")
    batches = -(-p12.ns // pipeline._batch_shots(p12, planes=4, traces=2))
    for shape in ((1, 2), (1, 2, 2)):
        mesh = make_mesh(*shape, devices=[dev] * int(np.prod(shape)))
        k12 = pipeline._block_k(ctx12, mesh, ctx12.nt, ("block_mod",), "mxu")
        check(k12 == 8, f"order 12 split modeling mesh {shape}: K {k12}, "
                        f"not the JAX package's 8")
        for c in (fk, stream, dk, d2k):
            c.reset_launches()
        got_d = pipeline.run_modeling(p12, vp=vp, mesh=mesh, lap_impl="mxu")
        torch.cuda.synchronize()
        launched = {k: n for c in (fk, stream, dk, d2k)
                    for k, n in c.LAUNCHES.items() if n}
        name = "block2_mod_mma" if len(shape) == 3 else "block_mod_mma"
        want = {name: batches * block_launches(name, p12.nt, k12,
                                               int(np.prod(shape)))}
        rr = rel_rms(got_d, dat12s)
        print(f"[order 12] 3lay split modeling (mxu) mesh {shape}, K {k12}: "
              f"launches {launched}; vs the per-step split tier: gathers rel "
              f"RMS {rr:.3e} (gate {GATE})", flush=True)
        check(launched == want, f"order 12 split modeling mesh {shape}: "
                                f"launches {launched}, expected {want}")
        check(rr <= GATE, f"order 12 split modeling mesh {shape} differs "
                          f"from the per-step split tier")
    del dat12, img12, runs12, dat12s
    phase_done("order 12 on the chosen K")

    print(f"[total] {time.perf_counter() - start:.1f} s", flush=True)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                **{key: results[k][key] for key in keys}}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
