// fd_step / fd_update: one time step of the large-grid tier at K = 1 for
// every shot of a batch, their split-bf16 twins fd_step_mma and
// fd_update_mma, and the C entry points pfdc_fd_step_run,
// pfdc_fd_update_run and their *_mma_run siblings that launch one step on
// a stream.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kernel (:76), called through fd_step_padded (:111) by the JAX package's
// forward_modeling_tiled and backward_recorded_tiled at block_k = 1; and
// _kernel_update (:171), called through fd_update_padded (:284) for the
// source reconstruction of rtm_shot_snapshot_tiled at block_k = 1; the
// *_mma kernels their use_mxu branch (_lap_dispatch, :64, through
// pallas_stencil.py's _lap_taps_mxu: the z taps as the split-bf16 banded
// product, then the x taps exact). Those
// kernels stream row tiles of the padded layout through VMEM with a
// double-buffered halo DMA; here one thread owns one cell of one shot
// (threads along z, blockIdx.z the shot) and the Laplacian's neighbours
// come through L1/L2, as in mod_step.cu.
//
// fd_step, from the state (p, pp), pp already tapered (the plain version's
// state): u = (2p - pp) + v*lap(p); then, before the taper, the optional
// injection: amp * patch around (sx[s], sz) (the Gaussian window, or r = 0
// and a patch of one for a point source) and/or the receiver row inj[s] on
// row gz at x in [x0, x0 + nx); p_out = p*m, pp_out = u*m. The JAX tiled
// loop adds amp*patch*m after the kernel instead, which rounds
// differently; here the operations and their order are the plain
// version's (solver.fd_step), so with -fmad=false the result is bitwise
// its. The taper is rebuilt from its three 1-D ramps (kstep.cuh,
// taper_at), not read as a plane.
//
// fd_update: out = (2p - pp) + v*lap(p), no taper, no injection.
//
// The outputs are buffers the launch does not read (neighbours read p), so
// nothing races; the TPU kernel's in-place taper has no counterpart here.
// The tiled loops swap two buffer pairs between steps, so no step allocates.
//
// What bounds it on an H100: HBM. At the Pluto grid (7040 x 1281, 36 MB a
// plane) an fd_step launch over 2 shots reads p, pp and one v2*dt2 plane
// and writes two fields a shot: 9 planes, 325 MB, 97 us at 3.35 TB/s,
// against ~40 flop a cell. fd_update reads p, pp and a v2*dt2 plane a shot
// and writes one field: 8 planes. This first version stages nothing in
// shared memory: the 2H+1 taps along x touch rows 2H apart, reread from L2.
//
// fd_step_mma<H, P> and fd_update_mma<H, P> compute what their exact twins
// compute, in the same order and with the same taper, but for the
// Laplacian: the z taps as the P-part (2: lap_impl "mxu", 3: "mxu6")
// split-bf16 banded product on the tensor cores, plus the exact x taps.
// They read and write what the exact kernels do, so HBM bounds them too.
// Both run the one-step split body of step_strip.cuh: a block of 16 warps
// stages p over 128 x 64 owned cells and an H-cell halo with cp.async,
// takes its z product behind one barrier, and walks the owned cells in
// strips of 8 rows, lanes along z, the x taps from a register window.
// fd_step_mma reads pp, v2*dt2 and the injections at the cell and writes
// p*m and u*m there; fd_update_mma, which does not taper (no ramp staged
// or read), reads pp and v2*dt2 and writes u.
#include "step_strip.cuh"

namespace {

template <int H>
__global__ void fd_step(const float* __restrict__ p,
                        const float* __restrict__ pp,
                        float* __restrict__ p_out, float* __restrict__ pp_out,
                        const float* __restrict__ v2dt2, int v2_shot_stride,
                        const float* __restrict__ xramp,
                        const float* __restrict__ zfac,
                        const float* __restrict__ strip,
                        const float* __restrict__ patch, int r,
                        const int* __restrict__ sx, int sz, float amp,
                        const float* __restrict__ inj, int inj_shot_stride,
                        int x0, int gz, int nx, int nxe, int nze,
                        pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t q = s * static_cast<size_t>(nxe) * nze + j;
  const float* ps = p + (q - j);
  const float pc = ps[j];
  const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                        ? pfdc::laplacian<H, false>(ps, nullptr, j, nze, c)
                        : 0.0f;
  float u = (2.0f * pc - pp[q]) +
            v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
  if (patch != nullptr) {
    const int dx = ix - sx[s];
    const int dz = iz - sz;
    if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
      u = u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)];
    }
  }
  if (inj != nullptr && iz == gz && ix >= x0 && ix < x0 + nx) {
    u = u + inj[s * static_cast<size_t>(inj_shot_stride) + (ix - x0)];
  }
  const float m = pfdc::taper_at(xramp, zfac, strip, ix, iz);
  p_out[q] = pc * m;
  pp_out[q] = u * m;
}

template <int H>
__global__ void fd_update(const float* __restrict__ p,
                          const float* __restrict__ pp,
                          float* __restrict__ out,
                          const float* __restrict__ v2dt2, int v2_shot_stride,
                          int nxe, int nze, pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t q = s * static_cast<size_t>(nxe) * nze + j;
  const float* ps = p + (q - j);
  const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                        ? pfdc::laplacian<H, false>(ps, nullptr, j, nze, c)
                        : 0.0f;
  out[q] = (2.0f * ps[j] - pp[q]) +
           v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
}

// fd_step_mma's site (step_strip.cuh): one shot's fields on the (nxf, nzf)
// grid; the step from the staged p and the cell's pp and v2*dt2, with the
// source window (patch null: none) and the receiver row (inj null: none)
// before the taper. Two operands a cell: strips of 8 rows, each strip's
// loaded when it is taken (4 rows ran 8 % slower; 8 rows with the next
// strip loaded ahead spilled and ran 15 % slower, PERF.md).
struct FdStepSite {
  static constexpr int kRows = 8;
  static constexpr bool kAhead = false;
  static constexpr bool kTaper = true;
  static constexpr bool kGpu = false;
  const float* field;   // p
  const float* xramp;
  const float* zfac;
  const float* strip;
  int nxf, nzf;
  const float* pp;
  float* p_out;
  float* pp_out;
  const float* v2dt2;
  const float* patch;
  int r, src_x, sz;
  float amp;
  const float* inj;
  int x0, gz, nx;

  struct Cell {
    float pp, v;
  };
  __device__ Cell load(int gx, int gz_) const {
    const size_t q = static_cast<size_t>(gx) * nzf + gz_;
    return {__ldg(pp + q), __ldg(v2dt2 + q)};
  }
  __device__ void step(int gx, int gz_, const Cell& in, float pc, float m,
                       float lap) const {
    const size_t q = static_cast<size_t>(gx) * nzf + gz_;
    float u = (2.0f * pc - in.pp) + in.v * lap;
    if (patch != nullptr) {
      const int dx = gx - src_x;
      const int dz = gz_ - sz;
      if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
        u = u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)];
      }
    }
    if (inj != nullptr && gz_ == gz && gx >= x0 && gx < x0 + nx) {
      u = u + inj[gx - x0];
    }
    p_out[q] = pc * m;
    pp_out[q] = u * m;
  }
};

template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    fd_step_mma(const float* __restrict__ p, const float* __restrict__ pp,
                float* __restrict__ p_out, float* __restrict__ pp_out,
                const float* __restrict__ v2dt2, int v2_shot_stride,
                const float* __restrict__ xramp,
                const float* __restrict__ zfac,
                const float* __restrict__ strip,
                const float* __restrict__ patch, int r,
                const int* __restrict__ sx, int sz, float amp,
                const float* __restrict__ inj, int inj_shot_stride, int x0,
                int gz, int nx, int nxe, int nze, pfdc::StripShape shape,
                pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const FdStepSite site{
      p + s * plane, xramp, zfac, strip, nxe, nze, pp + s * plane,
      p_out + s * plane, pp_out + s * plane,
      v2dt2 + s * static_cast<size_t>(v2_shot_stride), patch, r,
      patch == nullptr ? 0 : sx[s], sz, amp,
      inj == nullptr ? nullptr
                     : inj + s * static_cast<size_t>(inj_shot_stride),
      x0, gz, nx};
  const pfdc::StripTile t(H, shape, static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::step_strip<H, P>(smem, site, t, c);
}

// fd_update_mma's site (step_strip.cuh): one shot's fields on the (nxf,
// nzf) grid; the untapered step from the staged p and the cell's pp and
// v2*dt2. Two operands a cell, as fd_step_mma's: strips of 8 rows, each
// strip's loaded when it is taken.
struct FdUpdateSite {
  static constexpr int kRows = 8;
  static constexpr bool kAhead = false;
  static constexpr bool kTaper = false;
  static constexpr bool kGpu = false;
  const float* field;   // p
  int nxf, nzf;
  const float* pp;
  float* out;
  const float* v2dt2;

  struct Cell {
    float pp, v;
  };
  __device__ Cell load(int gx, int gz_) const {
    const size_t q = static_cast<size_t>(gx) * nzf + gz_;
    return {__ldg(pp + q), __ldg(v2dt2 + q)};
  }
  __device__ void step(int gx, int gz_, const Cell& in, float pc,
                       float lap) const {
    out[static_cast<size_t>(gx) * nzf + gz_] = (2.0f * pc - in.pp) +
                                               in.v * lap;
  }
};

template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    fd_update_mma(const float* __restrict__ p, const float* __restrict__ pp,
                  float* __restrict__ out, const float* __restrict__ v2dt2,
                  int v2_shot_stride, int nxe, int nze,
                  pfdc::StripShape shape, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const FdUpdateSite site{p + s * plane, nxe, nze, pp + s * plane,
                          out + s * plane,
                          v2dt2 + s * static_cast<size_t>(v2_shot_stride)};
  const pfdc::StripTile t(H, shape, static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::step_strip<H, P>(smem, site, t, c);
}

struct FdStepRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  const float* v2dt2;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* patch;
  int r;
  const int* sx;
  int sz;
  float amp;
  const float* inj;
  int inj_shot_stride, x0, gz, nx, ns, nxe, nze;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t launch() const {
    if constexpr (P == 0) {
      const dim3 grid = pfdc::step_grid(ns, nxe, nze);
      const dim3 block = pfdc::step_block();
      fd_step<H><<<grid, block, 0, stream>>>(
          p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp, zfac, strip,
          patch, r, sx, sz, amp, inj, inj_shot_stride, x0, gz, nx, nxe, nze,
          c);
    } else {
      const pfdc::StripShape shape =
          pfdc::strip_shape(pfdc::kStepShapes, pfdc::kStepStage, H);
      if (shape.tx == 0) return cudaErrorInvalidValue;
      const size_t bytes = pfdc::strip_bytes(shape, pfdc::kStepStage, H);
      const cudaError_t e = pfdc::allow_smem(fd_step_mma<H, P>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
      const dim3 block(pfdc::kStripThreads);
      fd_step_mma<H, P><<<grid, block, bytes, stream>>>(
          p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp, zfac, strip,
          patch, r, sx, sz, amp, inj, inj_shot_stride, x0, gz, nx, nxe, nze,
          shape, c);
    }
    return cudaGetLastError();
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

struct FdUpdateRun {
  const float* p;
  const float* pp;
  float* out;
  const float* v2dt2;
  int v2_shot_stride, ns, nxe, nze;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t launch() const {
    if constexpr (P == 0) {
      const dim3 grid = pfdc::step_grid(ns, nxe, nze);
      const dim3 block = pfdc::step_block();
      fd_update<H><<<grid, block, 0, stream>>>(p, pp, out, v2dt2,
                                               v2_shot_stride, nxe, nze, c);
    } else {
      const pfdc::StripShape shape =
          pfdc::strip_shape(pfdc::kStepShapes, pfdc::kStepStage, H);
      if (shape.tx == 0) return cudaErrorInvalidValue;
      const size_t bytes = pfdc::strip_bytes(shape, pfdc::kStepStage, H);
      const cudaError_t e = pfdc::allow_smem(fd_update_mma<H, P>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
      const dim3 block(pfdc::kStripThreads);
      fd_update_mma<H, P><<<grid, block, bytes, stream>>>(
          p, pp, out, v2dt2, v2_shot_stride, nxe, nze, shape, c);
    }
    return cudaGetLastError();
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

int fd_step_run(const float* p, const float* pp, float* p_out,
                float* pp_out, const float* v2dt2, int v2_shot_stride,
                const float* xramp, const float* zfac, const float* strip,
                const float* patch, int r, const int* sx, int sz,
                const float* amp, const float* inj, int inj_shot_stride,
                int x0, int gz, int nx, int ns, int nxe, int nze, int order,
                int parts, const float* cx, const float* cz, void* stream) {
  const FdStepRun run{p, pp, p_out, pp_out, v2dt2, v2_shot_stride,
                      xramp, zfac, strip,
                      amp != nullptr ? patch : nullptr, r, sx, sz,
                      amp != nullptr ? *amp : 0.0f,
                      inj, inj_shot_stride, x0, gz, nx, ns, nxe, nze,
                      pfdc::make_coefs(order / 2, cx, cz), parts,
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

int fd_update_run(const float* p, const float* pp, float* out,
                  const float* v2dt2, int v2_shot_stride, int ns, int nxe,
                  int nze, int order, int parts, const float* cx,
                  const float* cz, void* stream) {
  const FdUpdateRun run{p,   pp,  out, v2dt2, v2_shot_stride, ns,
                        nxe, nze, pfdc::make_coefs(order / 2, cx, cz), parts,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs one fd_step from the state (p, pp) into (p_out, pp_out), all
// (ns, nxe, nze), with the taper's ramps (xramp (nxe), zfac and strip
// (nze)). amp, a host pointer to the step's wavelet sample, may be null
// for no source window (patch (2r+1)^2 around sx (ns) int32, depth sz);
// inj (row of shot s at inj + s * inj_shot_stride, nx values from x = x0
// on row gz) may be null for no receiver row. Returns a cudaError_t.
extern "C" int pfdc_fd_step_run(const float* p, const float* pp,
                                float* p_out, float* pp_out,
                                const float* v2dt2, int v2_shot_stride,
                                const float* xramp, const float* zfac,
                                const float* strip, const float* patch, int r,
                                const int* sx, int sz, const float* amp,
                                const float* inj, int inj_shot_stride, int x0,
                                int gz, int nx, int ns, int nxe, int nze,
                                int order, const float* cx, const float* cz,
                                void* stream) {
  return fd_step_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp,
                     zfac, strip, patch, r, sx, sz, amp, inj,
                     inj_shot_stride, x0, gz, nx, ns, nxe, nze, order, 0, cx,
                     cz, stream);
}

// The same step with the z taps in parts (2 or 3) bf16 splits:
// fd_step_mma.
extern "C" int pfdc_fd_step_mma_run(
    const float* p, const float* pp, float* p_out, float* pp_out,
    const float* v2dt2, int v2_shot_stride, const float* xramp,
    const float* zfac, const float* strip, const float* patch, int r,
    const int* sx, int sz, const float* amp, const float* inj,
    int inj_shot_stride, int x0, int gz, int nx, int ns, int nxe, int nze,
    int order, int parts, const float* cx, const float* cz, void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fd_step_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp,
                     zfac, strip, patch, r, sx, sz, amp, inj,
                     inj_shot_stride, x0, gz, nx, ns, nxe, nze, order, parts,
                     cx, cz, stream);
}

// Runs one fd_update from (p, pp) into out, all (ns, nxe, nze). Returns a
// cudaError_t.
extern "C" int pfdc_fd_update_run(const float* p, const float* pp,
                                  float* out, const float* v2dt2,
                                  int v2_shot_stride, int ns, int nxe,
                                  int nze, int order, const float* cx,
                                  const float* cz, void* stream) {
  return fd_update_run(p, pp, out, v2dt2, v2_shot_stride, ns, nxe, nze,
                       order, 0, cx, cz, stream);
}

// The same update with the z taps in parts (2 or 3) bf16 splits:
// fd_update_mma.
extern "C" int pfdc_fd_update_mma_run(const float* p, const float* pp,
                                      float* out, const float* v2dt2,
                                      int v2_shot_stride, int ns, int nxe,
                                      int nze, int order, int parts,
                                      const float* cx, const float* cz,
                                      void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fd_update_run(p, pp, out, v2dt2, v2_shot_stride, ns, nxe, nze,
                       order, parts, cx, cz, stream);
}
