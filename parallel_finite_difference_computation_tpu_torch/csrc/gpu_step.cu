// gpu_step: one taper-first receiver step of the GPU suite's backward pass
// with the trace row (K5) and imaging (K6), for every shot of a batch, and
// the C entry points pfdc_gpu_step_run and pfdc_gpu_step_mma_run that
// launch it. The large-grid tier runs it for fd_back's two seed steps
// (it = 0, 1), whose source field is a snapshot instead of a propagated
// field; the K = 1 tier runs it for every step of fd_forward (no trace
// row, no image) and of fd_back's receiver field: 2 * nt launches a call.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kernel_gpu (:207), called through fd_step_gpu_padded (:324) by the JAX
// package's rtm_shot_snapshot_tiled at block_k = 1 and its
// _rtm_snapshot_kblocked for the seed steps (the same steps): gpu_step its
// exact taps, gpu_step_mma<H, 2 or 3> its use_mxu branch (_lap_dispatch,
// :64, through pallas_stencil.py's _lap_taps_mxu: the z taps as the split-
// bf16 banded product, then the x taps exact).
//
// What bounds it on an H100: one launch reads y, x, v2*dt2, the source
// field and the image, and writes t, the new field and the image: ~280 MB
// a shot at the Pluto grid. Threads run along z for coalesced loads; the
// Laplacian tapers its taps on read, as rtm_bwd_step does, with the
// top-strip taper rebuilt from its 1-D ramps (kstep.cuh, taper_at) instead
// of read from a 36 MB mask plane.
//
// From the state (x, y) with x tapered: t = m*y, u = (2t - x*m) + v*lap(t),
// plus the trace row at depth gz; img += src*u over the interior. These
// are rtm_bwd_step's receiver operations in its order, so with -fmad=false
// the result is bitwise the per-step kernel's. The outputs are separate
// buffers (neighbours read y); img is updated in place, one cell a thread.
//
// gpu_step_mma runs the one-step split body of step_strip.cuh (the kGpu
// state): a block of 16 warps stages y over 128 x 64 owned cells and an
// H-cell halo, tapers it in a phase of its own (t = m*y, the tapped field
// and t_out), takes its z product, and walks the owned cells in 4-row
// strips, lanes along z, reading x, v2*dt2, the trace row, the source
// field and the image at the cell and writing t, u and the image there.
#include "step_strip.cuh"

namespace {

template <int H>
__global__ void gpu_step(const float* __restrict__ y,
                         const float* __restrict__ x, float* __restrict__ t_out,
                         float* __restrict__ u_out,
                         const float* __restrict__ v2dt2, int v2_shot_stride,
                         const float* __restrict__ xramp,
                         const float* __restrict__ zfac,
                         const float* __restrict__ strip,
                         const float* __restrict__ inj, int inj_shot_stride,
                         int gz, const float* __restrict__ src,
                         float* __restrict__ img, int nxb, int nzb, int nx,
                         int nz, int nxe, int nze, pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t q = s * static_cast<size_t>(nxe) * nze + j;
  const float* ys = y + (q - j);
  auto tapered = [&](int dx, int dz) {
    return pfdc::taper_at(xramp, zfac, strip, ix + dx, iz + dz) *
           ys[j + dx * nze + dz];
  };
  const float m = pfdc::taper_at(xramp, zfac, strip, ix, iz);
  const float t = m * ys[j];
  const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                        ? pfdc::laplacian_taps<H>(tapered, c)
                        : 0.0f;
  float u = (2.0f * t - x[q] * m) +
            v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
  if (inj != nullptr && iz == gz && ix >= nxb && ix < nxb + nx) {
    u = u + inj[s * static_cast<size_t>(inj_shot_stride) + (ix - nxb)];
  }
  t_out[q] = t;
  u_out[q] = u;
  if (img != nullptr && ix >= nxb && ix < nxb + nx && iz >= nzb &&
      iz < nzb + nz) {
    float* im = img + s * static_cast<size_t>(nx) * nz +
                static_cast<size_t>(ix - nxb) * nz + (iz - nzb);
    *im = *im + src[q] * u;
  }
}

// gpu_step_mma's site (step_strip.cuh): one shot's fields on the (nxf,
// nzf) grid; the step from the staged t = m*y and the cell's x, v2*dt2 and
// (over the interior, when imaging) source field and image, with the trace
// row and the image where given. Four operands a cell: strips of 4 rows,
// the next strip's loaded ahead (receiver launches 8 % faster than with
// each strip's loaded when it is taken; 8 rows spilled and ran 41 %
// slower, PERF.md).
struct GpuStepSite {
  static constexpr int kRows = pfdc::kStripRows;
  static constexpr bool kAhead = true;
  static constexpr bool kTaper = true;
  static constexpr bool kGpu = true;
  const float* field;   // y
  const float* xramp;
  const float* zfac;
  const float* strip;
  int nxf, nzf;
  const float* x;
  float* t_out;
  float* u_out;
  const float* v2dt2;
  const float* inj;
  int gz;
  const float* src;
  float* img;
  int nxb, nzb, nx, nz;

  struct Cell {
    float x, v, src, img;
  };
  __device__ bool imaged(int gx, int gz_) const {
    return img != nullptr && gx >= nxb && gx < nxb + nx && gz_ >= nzb &&
           gz_ < nzb + nz;
  }
  __device__ float* image_at(int gx, int gz_) const {
    return img + static_cast<size_t>(gx - nxb) * nz + (gz_ - nzb);
  }
  __device__ Cell load(int gx, int gz_) const {
    const size_t q = static_cast<size_t>(gx) * nzf + gz_;
    const bool im = imaged(gx, gz_);
    return {__ldg(x + q), __ldg(v2dt2 + q), im ? __ldg(src + q) : 0.0f,
            im ? *image_at(gx, gz_) : 0.0f};
  }
  __device__ void step(int gx, int gz_, const Cell& in, float t, float m,
                       float lap) const {
    const size_t q = static_cast<size_t>(gx) * nzf + gz_;
    float u = (2.0f * t - in.x * m) + in.v * lap;
    if (inj != nullptr && gz_ == gz && gx >= nxb && gx < nxb + nx) {
      u = u + inj[gx - nxb];
    }
    t_out[q] = t;
    u_out[q] = u;
    if (imaged(gx, gz_)) *image_at(gx, gz_) = in.img + in.src * u;
  }
};

template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    gpu_step_mma(const float* __restrict__ y, const float* __restrict__ x,
                 float* __restrict__ t_out, float* __restrict__ u_out,
                 const float* __restrict__ v2dt2, int v2_shot_stride,
                 const float* __restrict__ xramp,
                 const float* __restrict__ zfac,
                 const float* __restrict__ strip,
                 const float* __restrict__ inj, int inj_shot_stride, int gz,
                 const float* __restrict__ src, float* __restrict__ img,
                 int nxb, int nzb, int nx, int nz, int nxe, int nze,
                 pfdc::StripShape shape, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const GpuStepSite site{
      y + s * plane, xramp, zfac, strip, nxe, nze, x + s * plane,
      t_out + s * plane, u_out + s * plane,
      v2dt2 + s * static_cast<size_t>(v2_shot_stride),
      inj == nullptr ? nullptr
                     : inj + s * static_cast<size_t>(inj_shot_stride),
      gz, src == nullptr ? nullptr : src + s * plane,
      img == nullptr ? nullptr : img + s * static_cast<size_t>(nx) * nz,
      nxb, nzb, nx, nz};
  const pfdc::StripTile t(H, shape, static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::step_strip<H, P>(smem, site, t, c);
}

struct GpuStepRun {
  const float* y;
  const float* x;
  float* t_out;
  float* u_out;
  const float* v2dt2;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* inj;
  int inj_shot_stride, gz;
  const float* src;
  float* img;
  int nxb, nzb, ns, nxe, nze;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t launch() const {
    if constexpr (P == 0) {
      const dim3 grid = pfdc::step_grid(ns, nxe, nze);
      const dim3 block = pfdc::step_block();
      gpu_step<H><<<grid, block, 0, stream>>>(
          y, x, t_out, u_out, v2dt2, v2_shot_stride, xramp, zfac, strip, inj,
          inj_shot_stride, gz, src, img, nxb, nzb, nxe - 2 * nxb,
          nze - 2 * nzb, nxe, nze, c);
    } else {
      const pfdc::StripShape shape =
          pfdc::strip_shape(pfdc::kStepShapes, pfdc::kStepStage, H);
      if (shape.tx == 0) return cudaErrorInvalidValue;
      const size_t bytes = pfdc::strip_bytes(shape, pfdc::kStepStage, H);
      const cudaError_t e = pfdc::allow_smem(gpu_step_mma<H, P>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
      const dim3 block(pfdc::kStripThreads);
      gpu_step_mma<H, P><<<grid, block, bytes, stream>>>(
          y, x, t_out, u_out, v2dt2, v2_shot_stride, xramp, zfac, strip, inj,
          inj_shot_stride, gz, src, img, nxb, nzb, nxe - 2 * nxb,
          nze - 2 * nzb, nxe, nze, shape, c);
    }
    return cudaGetLastError();
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

int gpu_step_run(const float* y, const float* x, float* t_out, float* u_out,
                 const float* v2dt2, int v2_shot_stride, const float* xramp,
                 const float* zfac, const float* strip, const float* inj,
                 int inj_shot_stride, int gz, const float* src, float* img,
                 int nxb, int nzb, int ns, int nxe, int nze, int order,
                 int parts, const float* cx, const float* cz, void* stream) {
  const GpuStepRun run{y,     x,     t_out, u_out, v2dt2, v2_shot_stride,
                       xramp, zfac,  strip, inj,   inj_shot_stride,
                       gz,    src,   img,   nxb,   nzb,   ns,
                       nxe,   nze,   pfdc::make_coefs(order / 2, cx, cz),
                       parts, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs one gpu_step from the state (x, y) into (t_out, u_out), all
// (ns, nxe, nze), with the top-strip taper's ramps (xramp (nxe), zfac and
// strip (nze)). inj (row of shot s at inj + s * inj_shot_stride) may be
// null for no trace row; img (ns, nx, nz), updated in place with src
// (ns, nxe, nze), may be null for no imaging. Returns a cudaError_t.
extern "C" int pfdc_gpu_step_run(const float* y, const float* x,
                                 float* t_out, float* u_out,
                                 const float* v2dt2, int v2_shot_stride,
                                 const float* xramp, const float* zfac,
                                 const float* strip, const float* inj,
                                 int inj_shot_stride, int gz,
                                 const float* src, float* img, int nxb,
                                 int nzb, int ns, int nxe, int nze,
                                 int order, const float* cx, const float* cz,
                                 void* stream) {
  return gpu_step_run(y, x, t_out, u_out, v2dt2, v2_shot_stride, xramp, zfac,
                      strip, inj, inj_shot_stride, gz, src, img, nxb, nzb, ns,
                      nxe, nze, order, 0, cx, cz, stream);
}

// The same step with the z taps in parts (2 or 3) bf16 splits:
// gpu_step_mma.
extern "C" int pfdc_gpu_step_mma_run(
    const float* y, const float* x, float* t_out, float* u_out,
    const float* v2dt2, int v2_shot_stride, const float* xramp,
    const float* zfac, const float* strip, const float* inj,
    int inj_shot_stride, int gz, const float* src, float* img, int nxb,
    int nzb, int ns, int nxe, int nze, int order, int parts, const float* cx,
    const float* cz, void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return gpu_step_run(y, x, t_out, u_out, v2dt2, v2_shot_stride, xramp, zfac,
                      strip, inj, inj_shot_stride, gz, src, img, nxb, nzb, ns,
                      nxe, nze, order, parts, cx, cz, stream);
}
