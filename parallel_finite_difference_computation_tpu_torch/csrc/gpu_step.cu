// gpu_step: one taper-first receiver step of the GPU suite's backward pass
// with the trace row (K5) and imaging (K6), for every shot of a batch, and
// the C entry points pfdc_gpu_step_run and pfdc_gpu_step_mma_run that
// launch it. The large-grid tier runs it for fd_back's two seed steps
// (it = 0, 1), whose source field is a snapshot instead of a propagated
// field.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kernel_gpu (:207), called through fd_step_gpu_padded (:324) by the JAX
// package's _rtm_snapshot_kblocked for the same two steps: gpu_step its
// exact taps, gpu_step_mma<H, 2 or 3> its use_mxu branch (_lap_dispatch,
// :64, through pallas_stencil.py's _lap_taps_mxu: the z taps as the split-
// bf16 banded product, then the x taps exact).
//
// What bounds it on an H100: one launch reads y, x, v2*dt2, the source
// field and the image, and writes t, the new field and the image: ~280 MB
// a shot at the Pluto grid, twice per shot. Threads run along z for
// coalesced loads; the Laplacian tapers its taps on read, as rtm_bwd_step
// does, with the top-strip taper rebuilt from its 1-D ramps (kstep.cuh,
// taper_at) instead of read from a 36 MB mask plane.
//
// From the state (x, y) with x tapered: t = m*y, u = (2t - x*m) + v*lap(t),
// plus the trace row at depth gz; img += src*u over the interior. These
// are rtm_bwd_step's receiver operations in its order, so with -fmad=false
// the result is bitwise the per-step kernel's. The outputs are separate
// buffers (neighbours read y); img is updated in place, one cell a thread.
//
// gpu_step_mma stages what its taps read: a block of four warps takes
// 64 x 64 cells and copies t = m*y of them and of an H-cell halo into
// shared memory (zeros outside the grid; mma_tile.cuh's MmaTile). Each
// warp runs its 16 rows as eight 16 x 8 mma blocks along z (mma_bf16.cuh,
// banded_mma: the window of an output starts H cells before it), and the
// lane that holds an output does that cell's whole step: the x taps from
// the tile, the update, the trace row and the image. The tile is the only
// thing shared, so one barrier suffices. The step runs twice a call: it is
// kept simple.
#include "mma_tile.cuh"

namespace {

using pfdc::kMmaThreads;
using pfdc::kMmaTileX;
using pfdc::kMmaTileZ;
using pfdc::MmaTile;

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

template <int H, int P>
__global__ void __launch_bounds__(kMmaThreads)
    gpu_step_mma(const float* __restrict__ y, const float* __restrict__ x,
                 float* __restrict__ t_out, float* __restrict__ u_out,
                 const float* __restrict__ v2dt2, int v2_shot_stride,
                 const float* __restrict__ xramp,
                 const float* __restrict__ zfac,
                 const float* __restrict__ strip,
                 const float* __restrict__ inj, int inj_shot_stride, int gz,
                 const float* __restrict__ src, float* __restrict__ img,
                 int nxb, int nzb, int nx, int nz, int nxe, int nze,
                 pfdc::Coefs c) {
  using T = MmaTile<H>;
  __shared__ float tile[T::kRows][T::kPitch];
  const int s = blockIdx.z;
  const int x0 = blockIdx.y * kMmaTileX;
  const int z0 = blockIdx.x * kMmaTileZ;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* ys = y + s * plane;
  for (int i = threadIdx.x; i < T::kRows * T::kCols; i += kMmaThreads) {
    const int r = i / T::kCols;
    const int cc = i - r * T::kCols;
    const int ix = x0 - H + r;
    const int iz = z0 - H + cc;
    tile[r][cc] = (ix >= 0 && ix < nxe && iz >= 0 && iz < nze)
                      ? pfdc::taper_at(xramp, zfac, strip, ix, iz) *
                            ys[static_cast<size_t>(ix) * nze + iz]
                      : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wr = 16 * (threadIdx.x >> 5);   // the warp's first output row
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.z, lane);
#pragma unroll 1
  for (int nb = 0; nb < kMmaTileZ / 8; ++nb) {
    float yz[4];
    pfdc::banded_mma<H, P>(
        yz, [&](int m, int k) { return tile[H + wr + m][8 * nb + k]; }, band,
        lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = wr + pfdc::frag_g(lane) + 8 * (q >> 1);   // output row
      const int cz = 8 * nb + 2 * pfdc::frag_t(lane) + (q & 1);
      const int ix = x0 + r;
      const int iz = z0 + cz;
      if (ix >= nxe || iz >= nze) continue;
      const int j_tile = (r + H) * T::kPitch + cz + H;   // its tile cell
      const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                            ? yz[q] + pfdc::axis_taps<H>(&tile[0][0], j_tile,
                                                         T::kPitch, c.x)
                            : 0.0f;
      const float t = (&tile[0][0])[j_tile];
      const float m = pfdc::taper_at(xramp, zfac, strip, ix, iz);
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      const size_t qi = s * plane + j;
      float u = (2.0f * t - x[qi] * m) +
                v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
      if (inj != nullptr && iz == gz && ix >= nxb && ix < nxb + nx) {
        u = u + inj[s * static_cast<size_t>(inj_shot_stride) + (ix - nxb)];
      }
      t_out[qi] = t;
      u_out[qi] = u;
      if (img != nullptr && ix >= nxb && ix < nxb + nx && iz >= nzb &&
          iz < nzb + nz) {
        float* im = img + s * static_cast<size_t>(nx) * nz +
                    static_cast<size_t>(ix - nxb) * nz + (iz - nzb);
        *im = *im + src[qi] * u;
      }
    }
  }
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
      static_assert(sizeof(float) * MmaTile<H>::kRows * MmaTile<H>::kPitch <=
                        48 * 1024,
                    "static shared memory");
      const dim3 grid((nze + kMmaTileZ - 1) / kMmaTileZ,
                      (nxe + kMmaTileX - 1) / kMmaTileX, ns);
      const dim3 block(kMmaThreads);
      gpu_step_mma<H, P><<<grid, block, 0, stream>>>(
          y, x, t_out, u_out, v2dt2, v2_shot_stride, xramp, zfac, strip, inj,
          inj_shot_stride, gz, src, img, nxb, nzb, nxe - 2 * nxb,
          nze - 2 * nzb, nxe, nze, c);
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
