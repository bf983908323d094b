"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them.

The sources are compiled at first use into one shared library with a plain
C interface (no PyTorch headers, so ``nvcc`` takes seconds), named by a hash
of the sources and flags, under ``parallel_finite_difference_computation_tpu_torch/_build/``.
The library is loaded with ctypes; pointers and the stream pass as
``c_void_p``, ints as ``c_int``.

``-fmad=false`` keeps every multiply and add rounded on its own, as the
reference's own build does (``cuda_reference_RTM/Makefile:4``) and as the
plain torch version and the JAX package round.

There is no fallback: without ``nvcc``, or when the build fails, this
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["NVCC_FLAGS", "library", "build_log"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # pfdc_mod_run(a, b, v2dt2, v2_shot_stride, mask, patch, r, sx, sz, gz,
    #              wav, dwav, seis, record, ns, nxe, nze, nxb, nx, nt, order,
    #              cx, cz, per_step, resident, stream)
    "pfdc_mod_run": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I,
                     _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P, _P, _I, _P, _P],
    # pfdc_rtm_fwd_run(a, b, v2dt2, v2_shot_stride, mask, sx, sz, wav,
    #                  ns, nxe, nze, nt, order, cx, cz, per_step, resident,
    #                  stream)
    "pfdc_rtm_fwd_run": [_P, _P, _P, _I, _P, _P, _I, _P,
                         _I, _I, _I, _I, _I, _P, _P, _I, _P, _P],
    # pfdc_rtm_bwd_run(sa, sb, snap0, snap1, ra, rb, v2dt2, v2_shot_stride,
    #                  mask, inj, img, gz, nxb, nzb, ns, nxe, nze, nt, order,
    #                  cx, cz, per_step, resident, stream)
    "pfdc_rtm_bwd_run": [_P, _P, _P, _P, _P, _P, _P, _I,
                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _I, _P, _P],
    # pfdc_cluster_plan(nxe, nze, order, out); pfdc_rtm_fwd_clusters,
    # pfdc_rtm_bwd_clusters, pfdc_mod_clusters,
    # pfdc_rec_fwd_clusters, pfdc_rec_bwd_clusters(nxe, nze, order)
    "pfdc_cluster_plan": [_I, _I, _I, _P],
    "pfdc_rtm_fwd_clusters": [_I, _I, _I],
    "pfdc_rtm_bwd_clusters": [_I, _I, _I],
    "pfdc_mod_clusters": [_I, _I, _I],
    "pfdc_rec_fwd_clusters": [_I, _I, _I],
    "pfdc_rec_bwd_clusters": [_I, _I, _I],
    # pfdc_rec_fwd_run(a, b, v2dt2, v2_shot_stride, mask, patch, r, sx, sz,
    #                  wav, dwav, swf, ns, nxe, nze, nxb, nzb, nt, order,
    #                  parts, cx, cz, per_step, resident, stream)
    "pfdc_rec_fwd_run": [_P, _P, _P, _I, _P, _P, _I, _P, _I,
                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _I, _P, _P],
    # pfdc_rec_bwd_run(a, b, v2dt2, v2_shot_stride, mask, inj, x0, gz, swf,
    #                  out, ns, nxe, nze, nxb, nzb, nt, order, parts, cx, cz,
    #                  per_step, resident, stream)
    "pfdc_rec_bwd_run": [_P, _P, _P, _I, _P, _P, _I, _I, _P,
                         _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _I, _P, _P],
    # pfdc_lap_run(p, out, nx, nz, order, cx, cz, stream)
    "pfdc_lap_run": [_P, _P, _I, _I, _I, _P, _P, _P],
    # pfdc_lap_shape(nx, nz, order, out)
    "pfdc_lap_shape": [_I, _I, _I, _P],
    # pfdc_lap_padded_run(p, out, rows, pitch, nx, nz, order, parts, cx, cz,
    #                     stream)
    "pfdc_lap_padded_run": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_mod_mma_run(a, b, v2dt2, v2_shot_stride, mask, patch, r, sx, sz,
    #                  gz, wav, seis, ns, nxe, nze, nxb, nx, nt, order, parts,
    #                  cx, cz, stream)
    "pfdc_mod_mma_run": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I,
                         _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_rtm_fwd_mma_run: pfdc_rtm_fwd_run's with parts after order
    "pfdc_rtm_fwd_mma_run": [_P, _P, _P, _I, _P, _P, _I, _P,
                             _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_rtm_bwd_mma_run: pfdc_rtm_bwd_run's with parts after order
    "pfdc_rtm_bwd_mma_run": [_P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P],
    # pfdc_kstep_mod_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp,
    #                    zfac, strip, patch, r, sx, sz, gz, amps, k, rec, ns,
    #                    nxe, nze, nxb, order, cx, cz, stream)
    "pfdc_kstep_mod_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                           _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    # pfdc_kstep_gpu_fwd_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride,
    #                        xramp, zfac, strip, sx, sz, amps, k, ns, nxe,
    #                        nze, order, cx, cz, stream)
    "pfdc_kstep_gpu_fwd_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                               _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_kstep_gpu_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out,
    #                        ppr_out, img, v2dt2, v2_shot_stride, xramp,
    #                        zfac, strip, inj, inj_shot_stride, gz, k, nxb,
    #                        nzb, ns, nxe, nze, order, cx, cz, stream)
    "pfdc_kstep_gpu_bwd_run": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P, _P, _P],
    # pfdc_gpu_step_run(y, x, t_out, u_out, v2dt2, v2_shot_stride, xramp,
    #                   zfac, strip, inj, inj_shot_stride, gz, src, img, nxb,
    #                   nzb, ns, nxe, nze, order, cx, cz, stream)
    "pfdc_gpu_step_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                          _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_kstep_mod_mma_run, pfdc_kstep_gpu_fwd_mma_run,
    # pfdc_kstep_gpu_bwd_mma_run, pfdc_gpu_step_mma_run: the exact entry
    # points' arguments with parts after order
    "pfdc_kstep_mod_mma_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                               _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                               _I, _P, _P, _P],
    "pfdc_kstep_gpu_fwd_mma_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                                   _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                                   _P],
    "pfdc_kstep_gpu_bwd_mma_run": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P, _P, _P],
    "pfdc_gpu_step_mma_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                              _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _P],
    # pfdc_fd_step_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp,
    #                  zfac, strip, patch, r, sx, sz, amp, inj,
    #                  inj_shot_stride, x0, gz, nx, ns, nxe, nze, order, cx,
    #                  cz, stream)
    "pfdc_fd_step_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I,
                         _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_fd_update_run(p, pp, out, v2dt2, v2_shot_stride, ns, nxe, nze,
    #                    order, cx, cz, stream)
    "pfdc_fd_update_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_fd_step_mma_run, pfdc_fd_update_mma_run: the exact entry points'
    # arguments with parts after order
    "pfdc_fd_step_mma_run": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                             _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P],
    "pfdc_fd_update_mma_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                               _P, _P],
    # pfdc_block_mod_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
    #                    xramp, zfac, strip, src, r, sz, amps, k, rec, gz,
    #                    ns, hs, nxl, nze, order, cx, cz, stream)
    "pfdc_block_mod_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                           _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    # pfdc_block_fwd_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
    #                    xramp, zfac, strip, src, sz, amps, k, ns, hs, nxl,
    #                    nze, order, cx, cz, stream)
    "pfdc_block_fwd_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                           _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_block_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out,
    #                    snap0, snap1, img, scratch, v2m, v2_shot_stride,
    #                    xramp, zfac, strip, inj, inj_shot_stride, gz, k, ns,
    #                    hs, nxl, nze, order, cx, cz, stream)
    "pfdc_block_bwd_run": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P, _P, _P],
    # pfdc_block2_mod_run(p, pp, p_out, pp_out, scratch, v2m,
    #                     v2_shot_stride, xramp, zfac, strip, src, r, sz,
    #                     amps, k, rec, gz, ns, hs, nxl, hz, nzl, order, cx,
    #                     cz, stream)
    "pfdc_block2_mod_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                            _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                            _P, _P],
    # pfdc_block2_fwd_run(p, pp, p_out, pp_out, scratch, v2m,
    #                     v2_shot_stride, xramp, zfac, strip, src, sz, amps,
    #                     k, ns, hs, nxl, hz, nzl, order, cx, cz, stream)
    "pfdc_block2_fwd_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                            _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # pfdc_block2_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out,
    #                     ppr_out, snap0, snap1, img, scratch, v2m,
    #                     v2_shot_stride, xramp, zfac, strip, inj,
    #                     inj_shot_stride, gz, k, ns, hs, nxl, hz, nzl, order,
    #                     cx, cz, stream)
    "pfdc_block2_bwd_run": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P, _P, _P],
    # pfdc_block{,2}_{mod,fwd,bwd}_mma_run: the exact entry points'
    # arguments, with parts after order
    "pfdc_block_mod_mma_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                               _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P, _P, _P],
    "pfdc_block_fwd_mma_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                               _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                               _P],
    "pfdc_block_bwd_mma_run": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P, _P],
    "pfdc_block2_mod_mma_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                                _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P, _P, _P],
    "pfdc_block2_fwd_mma_run": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                                _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                                _P, _P],
    "pfdc_block2_bwd_mma_run": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _P, _P, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the CUDA "
                       "step kernels cannot be built")


def _library_path() -> pathlib.Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpfdc_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output of the build (register and spill counts from
    ``-Xptxas=-v``), or '' if the library was built by another process."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _run_all(cmds):
    """Runs the commands at once and waits for all of them. Returns their
    combined output; raises on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library: one
    ``nvcc -c`` per source, all started together, then one link."""
    so = _library_path()
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        log = _run_all([[nvcc, *compile_flags, "-c", "-o", str(o), str(f)]
                        for f, o in zip(cu, objs)])
        tmp = so.with_name(f"{tag}.tmp.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-o", str(tmp),
                          *map(str, objs)]])
        for o in objs:
            o.unlink()
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
