// mod_step_mma, rtm_fwd_step_mma and rtm_bwd_step_mma: the per-step
// kernels of mod_step.cu, rtm_fwd_step.cu and rtm_bwd_step.cu with the
// Laplacian's x taps as the banded product in P-part split bf16 on the
// tensor cores (mma_bf16.cuh; P = 2 is lap_impl "mxu", 3 is "mxu6") and
// its z taps exact on the CUDA cores: lap = yx + accz over the interior, 0
// outside it. One launch is one time step for every shot of the batch; the
// C entry points loop over the nt steps on a stream, as the exact kernels'
// do, and the rest of each step (taper on read, the source, the trace row,
// the image) is theirs, cell by cell.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_fd.py,
// the MXU branch of _make_lap (:260-334) inside _fwd_mod_kernel (:423,
// through forward_modeling_pallas :474) and _rtm_kernel (:534, through
// rtm_snapshot_pallas :629), selected by resolve_lap_impl/_use_mxu_lap
// (:161-241). There the lane axis is x, padded to 128 lanes, and the band
// is cut into 128-lane blocks with first/middle/last windows; here the
// band is the (2h+1)-tap sum of each interior cell, which those windows
// also give it.
//
// A block owns 32 x outputs by 32 z outputs of one shot and stages (32 +
// 2h, or the k-steps' window) rows by (32 + 2h) columns of the field in
// shared memory, tapered (m * f) for the tapered steps: the fields the
// Laplacian reads. Warp w computes z outputs 16 (w & 1) .. + 15 of the
// x outputs 16 (w >> 1) .. + 15, two 16 (z) x 8 (x) mma blocks whose rows
// are z and whose contraction runs down x: A[m][k] = tile[8n + k][h + z]
// is a column of the tile, read at a row pitch of 4 mod 32 floats (no
// bank conflicts). Each lane then finishes the four cells of each block
// it holds in the accumulator fragment (z = g, g + 8; x = 2t, 2t + 1).
//
// What bounds it on an H100: at the 3lay size (231 x 231, 8 shots) a step
// touches about 7 MB (12 MB for rtm_bwd), inside the 50 MB L2, and the
// exact kernels run at 24-33x their operation bound with ~1.5 us gaps
// between the 1001 dependent launches (PERF.md). The tensor cores take the
// x taps' multiply-adds off the CUDA cores (3 or 6 passes of 16 * KS
// multiply-adds a cell), the split and the staging add work; whether the
// tier is faster than the exact kernels is measured, not assumed.
#include "mma_bf16.cuh"
#include "stencil.cuh"

namespace {

constexpr int kTileX = 32;   // x outputs of a block: 4 mma blocks of 8
constexpr int kTileZ = 32;   // z outputs of a block: 2 mma blocks of 16
constexpr int kThreads = 128;

// The staged tile: rows x0 - H .. (kRows), columns z0 - H .. (kCols).
template <int H>
struct StepTile {
  static constexpr int kKS = pfdc::band_ksteps<H>();
  // the exact taps read rows to kTileX + 2H - 1, the last x window to
  // kTileX - 8 + 16 * kKS - 1
  static constexpr int kRows = kTileX + 2 * H > kTileX - 8 + 16 * kKS
                                   ? kTileX + 2 * H
                                   : kTileX - 8 + 16 * kKS;
  static constexpr int kCols = kTileZ + 2 * H;
  static constexpr int kPitch = (kCols + 27) / 32 * 32 + 4;
};

template <int H>
using StepArray = float[StepTile<H>::kRows][StepTile<H>::kPitch];

// Stages one shot's field f (m[q] * f[q] where mask is not null, as the
// exact kernels' taps read it), zeros outside the grid.
template <int H>
__device__ __forceinline__ void stage_field(StepArray<H>& tile,
                                            const float* __restrict__ f,
                                            const float* __restrict__ mask,
                                            int x0, int z0, int nxe,
                                            int nze) {
  using T = StepTile<H>;
  for (int i = threadIdx.x; i < T::kRows * T::kCols; i += kThreads) {
    const int rr = i / T::kCols;
    const int cc = i - rr * T::kCols;
    const int x = x0 - H + rr;
    const int z = z0 - H + cc;
    float v = 0.0f;
    if (x >= 0 && x < nxe && z >= 0 && z < nze) {
      const int q = x * nze + z;
      v = mask != nullptr ? mask[q] * f[q] : f[q];
    }
    tile[rr][cc] = v;
  }
}

// The exact z taps of the cell at tile row xr, column zc, centre included,
// in the order of pfdc::laplacian's accz.
template <int H>
__device__ __forceinline__ float taps_z(const StepArray<H>& tile, int xr,
                                        int zc, const pfdc::Coefs& c) {
  const float* row = &tile[xr][zc];
  float acc = c.z[H] * (row[-H] + row[H]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) acc = acc + c.z[k] * (row[-k] + row[k]);
  return acc + c.z[0] * row[0];
}

// Where this lane's cells are: for block b (0, 1) of the warp and fragment
// entry q, the tile-relative x (xl) and z (zl) of the output.
struct Cells {
  int zw, nb, g, t;
  __device__ __forceinline__ Cells(int warp, int lane)
      : zw(16 * (warp & 1)), nb(2 * (warp >> 1)), g(pfdc::frag_g(lane)),
        t(pfdc::frag_t(lane)) {}
  __device__ __forceinline__ int xl(int b, int q) const {
    return 8 * (nb + b) + 2 * t + (q & 1);
  }
  __device__ __forceinline__ int zl(int q) const {
    return zw + g + 8 * (q >> 1);
  }
};

// yx[q] of block b: the banded x taps of the staged field.
template <int H, int P>
__device__ __forceinline__ void x_taps(float (&yx)[4],
                                       const StepArray<H>& tile,
                                       const Cells& cl, int b,
                                       const pfdc::Band<H, P>& band,
                                       int lane) {
  const int r0 = 8 * (cl.nb + b);
  const int c0 = H + cl.zw;
  pfdc::banded_mma<H, P>(
      yx, [&](int m, int k) { return tile[r0 + k][c0 + m]; }, band, lane);
}

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
    mod_step_mma(const float* __restrict__ cur, float* __restrict__ old,
                 const float* __restrict__ v2dt2, int v2_shot_stride,
                 const float* __restrict__ mask,
                 const float* __restrict__ patch, int r,
                 const int* __restrict__ sx, int sz, float amp,
                 float* __restrict__ seis_it, int seis_shot_stride, int gz,
                 int nxb, int nx, int nxe, int nze, pfdc::Coefs c) {
  __shared__ StepArray<H> tile;
  const int lane = threadIdx.x & 31;
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);
  const int x0 = blockIdx.y * kTileX;
  const int z0 = blockIdx.x * kTileZ;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;
  stage_field<H>(tile, p, nullptr, x0, z0, nxe, nze);
  __syncthreads();
  const Cells cl(threadIdx.x >> 5, lane);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float yx[4];
    x_taps<H, P>(yx, tile, cl, b, band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ix = x0 + cl.xl(b, q);
      const int iz = z0 + cl.zl(q);
      if (ix >= nxe || iz >= nze) continue;
      const int j = ix * nze + iz;
      const float lap =
          pfdc::in_interior(ix, iz, H, nxe, nze)
              ? yx[q] + taps_z<H>(tile, H + cl.xl(b, q), H + cl.zl(q), c)
              : 0.0f;
      const float m = mask[j];
      const float pc = p[j];
      float u = (2.0f * pc - pp[j] * m) +
                v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
      const int dx = ix - sx[s];
      const int dz = iz - sz;
      if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
        u = u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)];
      }
      pp[j] = u * m;
      if (iz == gz && ix >= nxb && ix < nxb + nx) {
        seis_it[s * static_cast<size_t>(seis_shot_stride) + (ix - nxb)] =
            pc * m;
      }
    }
  }
}

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
    rtm_fwd_step_mma(const float* __restrict__ cur, float* __restrict__ old,
                     const float* __restrict__ v2dt2, int v2_shot_stride,
                     const float* __restrict__ mask,
                     const int* __restrict__ sx, int sz, float amp, int nxe,
                     int nze, pfdc::Coefs c) {
  __shared__ StepArray<H> tile;
  const int lane = threadIdx.x & 31;
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);
  const int x0 = blockIdx.y * kTileX;
  const int z0 = blockIdx.x * kTileZ;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;
  stage_field<H>(tile, p, mask, x0, z0, nxe, nze);
  __syncthreads();
  const Cells cl(threadIdx.x >> 5, lane);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float yx[4];
    x_taps<H, P>(yx, tile, cl, b, band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ix = x0 + cl.xl(b, q);
      const int iz = z0 + cl.zl(q);
      if (ix >= nxe || iz >= nze) continue;
      const int j = ix * nze + iz;
      const float lap =
          pfdc::in_interior(ix, iz, H, nxe, nze)
              ? yx[q] + taps_z<H>(tile, H + cl.xl(b, q), H + cl.zl(q), c)
              : 0.0f;
      const float m = mask[j];
      const float pc = m * p[j];
      const float ppc = m * (m * pp[j]);
      float u = (2.0f * pc - ppc) +
                v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
      if (ix == sx[s] && iz == sz) u = u + amp;
      pp[j] = u;
    }
  }
}

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
    rtm_bwd_step_mma(const float* __restrict__ s_cur,
                     float* __restrict__ s_old,
                     const float* __restrict__ snap,
                     const float* __restrict__ r_cur,
                     float* __restrict__ r_old,
                     const float* __restrict__ v2dt2, int v2_shot_stride,
                     const float* __restrict__ mask,
                     const float* __restrict__ inj_it, int inj_shot_stride,
                     float* __restrict__ img, int gz, int nxb, int nzb,
                     int nx, int nz, int nxe, int nze, pfdc::Coefs c) {
  __shared__ StepArray<H> src_tile;
  __shared__ StepArray<H> rec_tile;
  const int lane = threadIdx.x & 31;
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);
  const int x0 = blockIdx.y * kTileX;
  const int z0 = blockIdx.x * kTileZ;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* ps = s_cur + s * plane;
  float* so = s_old + s * plane;
  const float* pr = r_cur + s * plane;
  float* ro = r_old + s * plane;
  // the source field is untapered; at it = 0, 1 it is the snapshot itself
  if (snap == nullptr) {
    stage_field<H>(src_tile, ps, nullptr, x0, z0, nxe, nze);
  }
  stage_field<H>(rec_tile, pr, mask, x0, z0, nxe, nze);
  __syncthreads();
  const Cells cl(threadIdx.x >> 5, lane);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float ys[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float yr[4];
    if (snap == nullptr) x_taps<H, P>(ys, src_tile, cl, b, band, lane);
    x_taps<H, P>(yr, rec_tile, cl, b, band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ix = x0 + cl.xl(b, q);
      const int iz = z0 + cl.zl(q);
      if (ix >= nxe || iz >= nze) continue;
      const int j = ix * nze + iz;
      const int xr = H + cl.xl(b, q);
      const int zc = H + cl.zl(q);
      const bool interior = pfdc::in_interior(ix, iz, H, nxe, nze);
      const float v = v2dt2[s * static_cast<size_t>(v2_shot_stride) + j];

      float us;
      if (snap != nullptr) {
        us = snap[s * plane + j];
      } else {
        const float lap =
            interior ? ys[q] + taps_z<H>(src_tile, xr, zc, c) : 0.0f;
        us = (2.0f * ps[j] - so[j]) + v * lap;
      }
      so[j] = us;

      const float m = mask[j];
      const float lap =
          interior ? yr[q] + taps_z<H>(rec_tile, xr, zc, c) : 0.0f;
      float ur = (2.0f * (m * pr[j]) - m * (m * ro[j])) + v * lap;
      if (iz == gz && ix >= nxb && ix < nxb + nx) {
        ur = ur +
             inj_it[s * static_cast<size_t>(inj_shot_stride) + (ix - nxb)];
      }
      ro[j] = ur;

      if (ix >= nxb && ix < nxb + nx && iz >= nzb && iz < nzb + nz) {
        float* im = img + s * static_cast<size_t>(nx) * nz +
                    static_cast<size_t>(ix - nxb) * nz + (iz - nzb);
        *im = *im + us * ur;
      }
    }
  }
}

inline dim3 tile_grid(int ns, int nxe, int nze) {
  return dim3((nze + kTileZ - 1) / kTileZ, (nxe + kTileX - 1) / kTileX, ns);
}

template <class F>
struct ByParts {
  const F& f;
  int parts;
  template <int H>
  cudaError_t operator()() const {
    if (parts == 2) return f.template operator()<H, 2>();
    if (parts == 3) return f.template operator()<H, 3>();
    return cudaErrorInvalidValue;
  }
};

// Calls f.template operator()<H, P>() for H = order / 2 and P = parts.
template <class F>
cudaError_t dispatch_parts(int order, int parts, const F& f) {
  return pfdc::dispatch_half(order, ByParts<F>{f, parts});
}

struct ModRun {
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* patch;
  int r;
  const int* sx;
  int sz;
  int gz;
  const float* wav;  // host, nt samples
  float* seis;       // (ns, nt, nx)
  int ns, nxe, nze, nxb, nx, nt;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t operator()() const {
    const dim3 grid = tile_grid(ns, nxe, nze);
    const dim3 block(kThreads);
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      mod_step_mma<H, P><<<grid, block, 0, stream>>>(
          cur, old, v2dt2, v2_shot_stride, mask, patch, r, sx, sz, wav[it],
          seis + static_cast<size_t>(it) * nx, nt * nx, gz, nxb, nx, nxe, nze,
          c);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

struct FwdRun {
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const int* sx;
  int sz;
  const float* wav;  // host, nt samples
  int ns, nxe, nze, nt;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t operator()() const {
    const dim3 grid = tile_grid(ns, nxe, nze);
    const dim3 block(kThreads);
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      rtm_fwd_step_mma<H, P><<<grid, block, 0, stream>>>(
          cur, old, v2dt2, v2_shot_stride, mask, sx, sz, wav[it], nxe, nze, c);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

struct BwdRun {
  float* sa;
  float* sb;
  const float* snap0;
  const float* snap1;
  float* ra;
  float* rb;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* inj;  // (ns, nt, nx): inj[s, it, ix] = dobs[s, ix, nt-1-it]
  float* img;        // (ns, nx, nz)
  int gz, nxb, nzb, nx, nz, ns, nxe, nze, nt;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t operator()() const {
    const dim3 grid = tile_grid(ns, nxe, nze);
    const dim3 block(kThreads);
    for (int it = 0; it < nt; ++it) {
      const bool even = it % 2 == 0;
      const float* snap = it == 0 ? snap1 : (it == 1 ? snap0 : nullptr);
      rtm_bwd_step_mma<H, P><<<grid, block, 0, stream>>>(
          even ? sa : sb, even ? sb : sa, snap, even ? ra : rb,
          even ? rb : ra, v2dt2, v2_shot_stride, mask,
          inj + static_cast<size_t>(it) * nx, nt * nx, img, gz, nxb, nzb, nx,
          nz, nxe, nze, c);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

}  // namespace

// As pfdc_mod_run (mod_step.cu), with the x taps in parts = 2 or 3 bf16
// splits. Returns a cudaError_t.
extern "C" int pfdc_mod_mma_run(float* a, float* b, const float* v2dt2,
                                int v2_shot_stride, const float* mask,
                                const float* patch, int r, const int* sx,
                                int sz, int gz, const float* wav, float* seis,
                                int ns, int nxe, int nze, int nxb, int nx,
                                int nt, int order, int parts, const float* cx,
                                const float* cz, void* stream) {
  const ModRun run{a,   b,   v2dt2, v2_shot_stride, mask, patch, r,
                   sx,  sz,  gz,    wav,            seis, ns,    nxe,
                   nze, nxb, nx,    nt,   pfdc::make_coefs(order / 2, cx, cz),
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_parts(order, parts, run));
}

// As pfdc_rtm_fwd_run (rtm_fwd_step.cu), with the x taps in parts = 2 or 3
// bf16 splits. Returns a cudaError_t.
extern "C" int pfdc_rtm_fwd_mma_run(float* a, float* b, const float* v2dt2,
                                    int v2_shot_stride, const float* mask,
                                    const int* sx, int sz, const float* wav,
                                    int ns, int nxe, int nze, int nt,
                                    int order, int parts, const float* cx,
                                    const float* cz, void* stream) {
  const FwdRun run{a,   b,   v2dt2, v2_shot_stride, mask,
                   sx,  sz,  wav,   ns,             nxe,
                   nze, nt,  pfdc::make_coefs(order / 2, cx, cz),
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_parts(order, parts, run));
}

// As pfdc_rtm_bwd_run (rtm_bwd_step.cu), with the x taps in parts = 2 or 3
// bf16 splits. Returns a cudaError_t.
extern "C" int pfdc_rtm_bwd_mma_run(float* sa, float* sb, const float* snap0,
                                    const float* snap1, float* ra, float* rb,
                                    const float* v2dt2, int v2_shot_stride,
                                    const float* mask, const float* inj,
                                    float* img, int gz, int nxb, int nzb,
                                    int ns, int nxe, int nze, int nt,
                                    int order, int parts, const float* cx,
                                    const float* cz, void* stream) {
  const BwdRun run{sa,   sb,   snap0, snap1, ra,  rb,
                   v2dt2, v2_shot_stride, mask, inj, img, gz,
                   nxb,  nzb,  nxe - 2 * nxb, nze - 2 * nzb, ns, nxe,
                   nze,  nt,   pfdc::make_coefs(order / 2, cx, cz),
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_parts(order, parts, run));
}
