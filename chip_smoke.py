#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU, and check them.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``. The phases, each printing what it found:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from ``csrc/``, with ``nvcc`` (one per source,
   started together);
3. kernel vs plain: ``mod_step``, ``rtm_fwd_step`` and ``rtm_bwd_step``
   against their plain torch versions on the same CUDA tensors, at the 3lay
   shapes (231 x 231 extended grid, nt=1001, 8 shots, order 8) and in short
   runs (nt=20) at orders 4 and 10; gate: max relative error <= 1e-5;
4. main path (mod -> rtm_gpu): ``run_modeling`` then ``run_rtm_gpu`` on the
   3lay config, ns=8, through the kernels: the launch counts,
   ``dir.image``, the image against the plain path on the card (rel RMS
   <= 1e-5), and the whole slice at a small size against the plain path on
   the CPU;
5. rec kernels vs plain: ``rec_fwd_step`` frames, ``rec_bwd_step`` in frame
   and image mode and ``rtm_full_cuda`` against their plain versions at the
   3lay shapes (``exact_taper=False``, phase 4's gathers as ``dobs``) and
   in short runs (nt=20, 21) at orders 4 and 10 with nxb != nzb (one of
   them with the receiver row clamped) and ``next_shot_first`` != 0;
   gate: max relative error <= 1e-5;
6. rtm_main path: ``run_rtm_cpu`` on the 3lay config, ns=8, after phase
   4's ``run_modeling``: the launch counts, ``dir.image`` and ``dir.img``
   against the returned arrays, the image against the plain path on the
   card (rel RMS <= 1e-5), and the small config card vs plain on the CPU;
7. stencil path: ``run_stencil`` through a file at the reference stencil's
   415 x 295 grid and at 8192 x 8192, orders 4, 8 and 10: one launch each,
   and each result against the plain version on the card (<= 1e-5);
8. times: each kernel's wrapper call and its plain version, timed with
   CUDA events, median of 5 after a warm-up, taken in turns; for the
   stencil also ``torch.nn.functional.conv2d`` with the same taps (the
   library yardstick, not used by the port);
9. profile: one ``torch.profiler`` trace of each 3lay 8-shot call and of
   the 8192 x 8192 stencil: the device time of each kernel, its launch
   count, and the share of the event-timed call that the card spent in
   kernels.

It prints one JSON line of per-kernel results (with each kernel's bound,
worked out from this run's shapes), the nvidia-smi line, and, as the last
line, ``{"ok": true, "device": {...}}``. Any failed phase raises and the
exit code is not 0. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
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
    "rec_fwd_step": (f"{PKG}/csrc/rec_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1002"),
    "rec_bwd_step": (f"{PKG}/csrc/rec_step.cu",
                     "parallel_finite_difference_computation_tpu/ops/pallas_stream.py:1002"),
    "lap_apply": (f"{PKG}/csrc/laplacian.cu",
                  "parallel_finite_difference_computation_tpu/ops/pallas_stencil.py:60"),
}
# The card's published peaks (H100 SXM data sheet): HBM bytes/s and float32
# flop/s outside the tensor cores. A kernel's bound is the larger of its
# bytes (inputs read once, outputs written once) and its flop over these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def lap_flops(h: int) -> int:
    """Flop of one order-2h Laplacian cell: per axis h pair adds, h
    multiplies, h-1 accumulating adds and the centre's multiply and add,
    then accz + accx."""
    return 6 * h + 3


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by) of a call that moves nbytes and does flops."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def step_bounds(ctx, ns: int):
    """Bounds of one wrapper call (ns shots x nt steps) of each step kernel
    as this script times it, from the shapes: per cell-step, the Laplacian
    over its interior and the update over the whole plane; bytes of the
    call's inputs and outputs, float32. The modeling and rtm_main calls
    share one velocity plane; the two-snapshot RTM has one per shot. A
    field is tapered once per cell, as the functions define it: the kernels'
    taper of each Laplacian tap on read is not counted."""
    h = ctx.order // 2
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
            steps * (lapc * lap_flops(h) + 6 * plane + ctx.nx + 49)),
        # rtm_fwd_step: a=m*p, b=m*(m*pp), u=2a-b+v*lap(a)
        "rtm_fwd_step": bound(
            f4 * (ns * plane + plane + ctx.nt + 2 * ns * plane),
            steps * (lapc * lap_flops(h) + 7 * plane + 1)),
        # rtm_bwd_step: untapered source step (4), tapered receiver step
        # (7), trace add, imaging multiply-add over the interior
        "rtm_bwd_step": bound(
            f4 * (ns * plane + plane + 2 * ns * plane
                  + ns * ctx.nx * ctx.nt + ns * inter),
            steps * (lapc * 2 * lap_flops(h)
                     + 11 * plane + ctx.nx + 2 * inter)),
        # rec_fwd_step: the mod_step update, a point source, frame m*p
        "rec_fwd_step": bound(
            f4 * (plane + plane + ctx.nt + 2 * ns * plane
                  + ns * ctx.nt * inter),
            steps * (lapc * lap_flops(h) + 6 * plane + inter + 1)),
        # rec_bwd_step, image mode: the update, the trace add, and
        # img += swf * (m*p) over the interior; reads swf once
        "rec_bwd_step": bound(
            f4 * (plane + plane + ns * ctx.nx * ctx.nt
                  + ns * ctx.nt * inter + ns * inter),
            steps * (lapc * lap_flops(h) + 6 * plane + ctx.nx
                     + 3 * inter)),
    }


def max_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def rel_rms(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def profile(torch, label: str, fn, call_ms: float, smi: str) -> None:
    """One torch.profiler trace of fn (after a warm-up): device time and
    launches of each kernel, and the kernels' share of call_ms, the
    call's median event time from the timing phase."""
    from torch.profiler import ProfilerActivity
    fn()
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
        print(f"[profile] {label}: {key[:60]}: {ms:.3f} ms device time in "
              f"{n} launches ({ms / n * 1e3:.2f} us each)")
    print(f"[profile] {label}: kernels {busy:.3f} ms of the {call_ms:.3f} ms "
          f"event-timed call, busy share {busy / call_ms:.3f}; {smi}",
          flush=True)


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
        _build, fd_kernels as fk)

    dev = torch.device("cuda", 0)
    results = {k: {} for k in KERNELS}

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

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

    def compare(order: int, nt: int):
        ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r = shapes(order, nt)
        out = {}
        km = fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz)
        pm = solver.forward_modeling(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz)
        out["mod_step"] = (max(max_rel(a, b) for a, b in zip(km, pm)),
                           max(float((a - b).abs().max())
                               for a, b in zip(km, pm)))
        kf = fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz)
        pf = solver.fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz)
        out["rtm_fwd_step"] = (max(max_rel(a, b) for a, b in zip(kf, pf)),
                               max(float((a - b).abs().max())
                                   for a, b in zip(kf, pf)))
        dobs = pm[2].transpose(1, 2).contiguous()          # (ns, nx, nt)
        kb = fk.fd_back_cuda(ctx_r, v2_r, pf[0], pf[1], dobs, g.gz)
        pb = solver.fd_back(ctx_r, v2_r, pf[0], pf[1], dobs, g.gz)
        out["rtm_bwd_step"] = (max_rel(kb, pb), float((kb - pb).abs().max()))
        torch.cuda.synchronize()
        return out, pm[2]

    plain_seis = None
    for order, nt in ((8, P.nt), (4, 20), (10, 20)):
        errs, seis = compare(order, nt)
        if order == 8:
            plain_seis = seis
        for k, (rel, absd) in errs.items():
            print(f"[kernel vs plain] {k} order {order} nt {nt} ns {P.ns}: "
                  f"max rel err {rel:.3e}, max abs err {absd:.3e}", flush=True)
            check(rel <= GATE, f"{k} order {order}: {rel:.3e} > {GATE}")
            if order == 8:
                results[k]["max_abs_err"] = absd

    # ---- 4. the main path, through the kernels
    fk.reset_launches()
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
    for k in ("mod_step", "rtm_fwd_step", "rtm_bwd_step"):
        results[k]["launches"] = launches[k]
        check(launches[k] == P.nt, f"{k} launched {launches[k]} times, "
                                   f"expected {P.nt}")
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
    print(f"[main path] vs plain on the card: gathers rel RMS {rr_data:.3e}, "
          f"image rel RMS {rr_img:.3e}", flush=True)
    check(rr_data <= GATE and rr_img <= GATE, "main path differs from plain")

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

    def compare_rec(p, dobs, quirk):
        ctx, v2, wav, d, nxt = rec_inputs(p, dobs)
        gp = Geometry.from_params(p)
        out = {}
        kf = fk.forward_modeling_cuda(ctx, v2, wav, gp.sx, gp.sz, gp.gz,
                                      source="point", taper="top",
                                      record="wavefield")
        pf = solver.forward_modeling(ctx, v2, wav, gp.sx, gp.sz, gp.gz,
                                     source="point", taper="top",
                                     record="wavefield")
        out["rec_fwd_step"] = errs(kf, pf)
        swf = pf[2]
        del kf, pf
        kb = fk.backward_recorded_cuda(ctx, v2, d, gp.gz, x_off_quirk=quirk,
                                       next_shot_first=nxt)
        pb = solver.backward_recorded(ctx, v2, d, gp.gz, x_off_quirk=quirk,
                                      next_shot_first=nxt)
        out["rec_bwd_step frames"] = errs(kb, pb)
        del kb, pb
        ki = fk.backward_image_cuda(ctx, v2, swf, d, gp.gz,
                                    x_off_quirk=quirk, next_shot_first=nxt)
        pi = solver.backward_image(ctx, v2, swf, d, gp.gz,
                                   x_off_quirk=quirk, next_shot_first=nxt)
        out["rec_bwd_step image"] = errs(ki, pi)
        del swf
        kr = fk.rtm_full_cuda(ctx, v2, wav, d, gp.sx, gp.sz, gp.gz,
                              x_off_quirk=quirk, next_shot_first=nxt)
        pr = solver.rtm_shot_full(ctx, v2, wav, d, gp.sx, gp.sz, gp.gz,
                                  x_off_quirk=quirk, next_shot_first=nxt)
        out["rtm_full_cuda"] = errs(kr, pr)
        torch.cuda.synchronize()
        return out, solver.receiver_offset(ctx, quirk)

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
        if p is P:
            results["rec_fwd_step"]["max_abs_err"] = out["rec_fwd_step"][1]
            results["rec_bwd_step"]["max_abs_err"] = max(
                out["rec_bwd_step frames"][1], out["rec_bwd_step image"][1])

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
    for k in ("rec_fwd_step", "rec_bwd_step"):
        results[k]["launches"] = launches[k]
        check(launches[k] == P.nt, f"{k} launched {launches[k]} times, "
                                   f"expected {P.nt}")
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

    # ---- 7. the stencil path, through the kernel
    from parallel_finite_difference_computation_tpu_torch.ops import stencil
    grids = {"415 x 295": Params(nx=335, nz=215, nt=1, dx=10.0, dz=10.0,
                                 dt=0.001, nxb=40, nzb=40),
             "8192 x 8192": Params(nx=8112, nz=8112, nt=1, dx=10.0, dz=10.0,
                                   dt=0.001, nxb=40, nzb=40)}
    fields = {}
    stencil_err = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for label, p in grids.items():
            path = os.path.join(tmp, f"{p.nxe}x{p.nze}.bin")
            f = np.random.default_rng(p.nxe).standard_normal(
                (p.nxe, p.nze)).astype(np.float32)
            io.write_f32(path, f)
            fields[label] = torch.from_numpy(f).to(dev)
        fk.reset_launches()
        t0 = time.perf_counter()
        laps = {}
        for label, p in grids.items():
            for order in (4, 8, 10):
                q = dataclasses.replace(p, order=order)
                laps[label, order] = pipeline.run_stencil(
                    q, input_path=os.path.join(tmp, f"{p.nxe}x{p.nze}.bin"),
                    device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
    print(f"[stencil path] run_stencil at 415 x 295 and 8192 x 8192, orders "
          f"4, 8, 10: {wall:.3f} s wall incl. file reads; launches "
          f"{launches}", flush=True)
    results["lap_apply"]["launches"] = launches["lap_apply"]
    check(launches["lap_apply"] == len(laps),
          f"lap_apply launched {launches['lap_apply']} times, expected "
          f"{len(laps)}")
    for (label, order), lap in laps.items():
        p = grids[label]
        cx, cz = numerics.scaled_coefficients(order, p.dx, p.dz)
        want = stencil.laplacian(fields[label], cx, cz, order)
        got = torch.from_numpy(lap).to(dev)
        rel, absd = errs(got, want)
        stencil_err = max(stencil_err, absd)
        print(f"[stencil path] lap_apply {label} order {order} vs plain on "
              f"the card: max rel err {rel:.3e}, max abs err {absd:.3e}",
              flush=True)
        check(lap.shape == (p.nxe, p.nze) and np.isfinite(lap).all()
              and rel <= GATE, f"lap_apply {label} order {order}")
    results["lap_apply"]["max_abs_err"] = stencil_err
    del laps

    # ---- 8. times, kernel and plain in turns
    ctx_m, ctx_r, v2_m, v2_r, wav_m, wav_r = shapes(8, P.nt)
    d = torch.from_numpy(data).to(dev)
    snaps = fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz)
    swf = fk.forward_modeling_cuda(ctx_c, v2_c, wav_c, g.sx, g.sz, g.gz,
                                   source="point", taper="top",
                                   record="wavefield")[2]
    rec_fwd = lambda fn: (lambda: fn(ctx_c, v2_c, wav_c, g.sx, g.sz, g.gz,
                                     source="point", taper="top",
                                     record="wavefield"))
    cases = {
        "mod_step": (
            lambda: fk.forward_modeling_cuda(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz),
            lambda: solver.forward_modeling(ctx_m, v2_m, wav_m, g.sx, g.sz, g.gz)),
        "rtm_fwd_step": (
            lambda: fk.fd_forward_cuda(ctx_r, v2_r, wav_r, g.sx, g.sz),
            lambda: solver.fd_forward(ctx_r, v2_r, wav_r, g.sx, g.sz)),
        "rtm_bwd_step": (
            lambda: fk.fd_back_cuda(ctx_r, v2_r, *snaps, d, g.gz),
            lambda: solver.fd_back(ctx_r, v2_r, *snaps, d, g.gz)),
        "rtm": (
            lambda: fk.rtm_snapshot_cuda(ctx_r, v2_r, wav_r, d, g.sx, g.sz, g.gz),
            lambda: solver.rtm_shot_snapshot(ctx_r, v2_r, wav_r, d, g.sx, g.sz, g.gz)),
        "rec_fwd_step": (rec_fwd(fk.forward_modeling_cuda),
                         rec_fwd(solver.forward_modeling)),
        "rec_bwd_step": (
            lambda: fk.backward_image_cuda(ctx_c, v2_c, swf, d_c, g.gz,
                                           next_shot_first=nxt_c),
            lambda: solver.backward_image(ctx_c, v2_c, swf, d_c, g.gz,
                                          next_shot_first=nxt_c)),
        "rec_bwd_step frames": (
            lambda: fk.backward_recorded_cuda(ctx_c, v2_c, d_c, g.gz,
                                              next_shot_first=nxt_c),
            lambda: solver.backward_recorded(ctx_c, v2_c, d_c, g.gz,
                                             next_shot_first=nxt_c)),
        "rtm_main": (
            lambda: fk.rtm_full_cuda(ctx_c, v2_c, wav_c, d_c, g.sx, g.sz,
                                     g.gz, next_shot_first=nxt_c),
            lambda: solver.rtm_shot_full(ctx_c, v2_c, wav_c, d_c, g.sx, g.sz,
                                         g.gz, next_shot_first=nxt_c)),
    }

    def event_ms(fn, reps: int = 1) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def in_turns(fns, reps: int = 1):
        """Median-of-5 lists of event times of each function, after a
        warm-up, the order of the functions turned each round."""
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        ts = [[] for _ in fns]
        for i in range(5):
            order = range(len(fns)) if i % 2 else reversed(range(len(fns)))
            for n in order:
                ts[n].append(event_ms(fns[n], reps))
        return ts

    def span(t) -> str:
        return (f"{statistics.median(t):.3f} ms (min {min(t):.3f}, max "
                f"{max(t):.3f})")

    times = {}
    for k, (kern, plain) in cases.items():
        tk, tp = in_turns([kern, plain])
        times[k] = (tk, tp)
        print(f"[times] {k}: kernel {span(tk)}, plain {span(tp)} per call "
              f"of {P.ns} shots x {P.nt} steps; {smi}", flush=True)
        if k in results:
            results[k]["ms"] = statistics.median(tk)
            results[k]["plain_ms"] = statistics.median(tp)
    del swf
    for label, k in (("modeling", "mod_step"), ("RTM", "rtm"),
                     ("rtm_main", "rtm_main")):
        tk, tp = times[k]
        print(f"[times] 3lay {label} s/shot (8-shot batch): kernel "
              f"{statistics.median(tk) / 1e3 / P.ns:.6f}, plain "
              f"{statistics.median(tp) / 1e3 / P.ns:.6f}; {smi}")
    for k, (bms, by) in step_bounds(ctx_c, P.ns).items():
        results[k]["bound_ms"], results[k]["bound_by"] = bms, by
        results[k]["library_ms"] = None

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

    # ---- 9. one profiler trace of each timed call
    f = fields["8192 x 8192"]
    cx, cz = numerics.scaled_coefficients(8, 10.0, 10.0)
    stencil_call = lambda: fk.laplacian_cuda(f, cx, cz, 8)
    for label, fn, ms in (
            ("modeling", cases["mod_step"][0], results["mod_step"]["ms"]),
            ("RTM", cases["rtm"][0], statistics.median(times["rtm"][0])),
            ("rtm_main", cases["rtm_main"][0],
             statistics.median(times["rtm_main"][0])),
            ("stencil 8192 x 8192", stencil_call,
             results["lap_apply"]["ms"])):
        profile(torch, label, fn, ms, smi)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                **{key: results[k][key] for key in keys}}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
