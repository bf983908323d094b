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
// One design for the three kernels. A block owns kX x outputs by kZ z
// outputs of one shot (the kernel's owned shape), a warp for each 16 x 16 of
// them: two 16 (z) x 8 (x) mma blocks whose rows are z and whose
// contraction runs down x, A[m][k] = tile[(r0 + k) * kPitch + c0 + m], a
// column of the tile. The block stages the fields it reads around its
// cells (StageTile: rows x0 - H .. as far as the last x window reads,
// columns z0 - H .. z0 + kZ + H - 1, zeros outside the grid, rows padded to
// 4 mod 8 floats by strip_pitch, at which the fragments' reads of rows 2
// apart and the z taps' of 8 columns hit no bank twice) with cp.async into
// dynamic shared memory, every copy of a thread in flight at once and no
// division per copy (for_staged_cells). Each lane issues the loads of its 8
// cells' other operands before it waits; a field that the exact kernel's
// taps read tapered (m * f) is tapered by each thread on the cells it
// copied, once its own copies have landed; then one barrier, and each lane
// finishes the four cells of each block it holds in the accumulator
// fragment (z = g, g + 8; x = 2t, 2t + 1), the centres and the mask from
// the tiles where they are staged, no product through shared memory:
//
//   kernel            staged (kFields)            tapered  lane's loads
//   mod_step_mma      cur (1)                     -        pp, mask, v2*dt2,
//                                                          the patch value
//   rtm_fwd_step_mma  cur, mask (2)               cur      pp, v2*dt2
//   rtm_bwd_step_mma  source (not on the two      receiver older fields,
//                     seeded steps), receiver,             v2*dt2, image
//                     mask (3)
//
// mod_step_mma stages cur untapered: the exact mod_step's taps read p as it
// is stored. The two forward kernels staged a static tile of 32 x 32 owned
// cells before, with synchronous loads, an integer division per element
// and, tapered, two dependent global loads, and read their operands (the
// centre and the mask again) from global memory after the product: 1.70x
// and 1.40x their exact per-step twins at 3lay (PERF.md, kernel table, row
// 5), where rtm_bwd_step_mma, on this design, ran at 1.11x.
//
// What bounds it on an H100: at the 3lay size (231 x 231, 8 shots) a step
// touches about 7 MB (12 MB for rtm_bwd), inside the 50 MB L2, and the
// exact kernels run at 24-33x their operation bound with ~1.5 us gaps
// between the 1001 dependent launches (PERF.md). The tensor cores take the
// x taps' multiply-adds off the CUDA cores (3 or 6 passes of 16 * KS
// multiply-adds a cell), the split and the staging add work; whether the
// tier is faster than the exact kernels is measured, not assumed.
#include "strip.cuh"

namespace {

// The owned shapes, x rows by z columns, 256 blocks of 8 warps for 3lay's
// 8 shots (PERF.md): on 32 x 64 rtm_bwd_step_mma ran 2.5-5 % faster than
// on 32 x 32 and 4 % faster than on 64 x 32, mod_step_mma 1.5 % and 6 %
// faster than on 32 x 32 and 64 x 64, rtm_fwd_step_mma 5 % and 4 %.
constexpr int kModTileX = 32;
constexpr int kModTileZ = 64;
constexpr int kFwdTileX = 32;
constexpr int kFwdTileZ = 64;
constexpr int kBwdTileX = 32;
constexpr int kBwdTileZ = 64;

// The kFields staged fields of a block of TX x TZ owned cells: rows x0 - H
// .. (kRows), columns z0 - H .. (kCols), kCells floats each on padded rows.
template <int H, int kFields, int TX, int TZ>
struct StageTile {
  static constexpr int kX = TX;
  static constexpr int kZ = TZ;
  static constexpr int kBlockThreads = 32 * (TX / 16) * (TZ / 16);
  static constexpr int kKS = pfdc::band_ksteps<H>();
  // the exact taps read rows to TX + 2H - 1, the last x window to
  // TX - 8 + 16 * kKS - 1
  static constexpr int kRows =
      TX + 2 * H > TX - 8 + 16 * kKS ? TX + 2 * H : TX - 8 + 16 * kKS;
  static constexpr int kCols = TZ + 2 * H;
  static constexpr int kPitch = pfdc::strip_pitch(kCols, true);
  static constexpr int kCells = kRows * kPitch;
  static constexpr size_t kBytes = sizeof(float) * kFields * kCells;
  // a thread's staged cells: cell tid, then every kBlockThreads-th, walked
  // kStepRows rows and kStepCols columns at a time
  static constexpr int kCopies =
      (kRows * kCols + kBlockThreads - 1) / kBlockThreads;
  static constexpr int kStepRows = kBlockThreads / kCols;
  static constexpr int kStepCols = kBlockThreads % kCols;

  static dim3 grid(int ns, int nxe, int nze) {
    return dim3((nze + TZ - 1) / TZ, (nxe + TX - 1) / TX, ns);
  }
};

template <int H>
using ModTile = StageTile<H, 1, kModTileX, kModTileZ>;
template <int H>
using FwdTile = StageTile<H, 2, kFwdTileX, kFwdTileZ>;
template <int H>
using BwdTile = StageTile<H, 3, kBwdTileX, kBwdTileZ>;

// Calls fn(lx, lz) for each staged cell of this thread, row lx and column
// lz of the tile T, the same cells for every call: no division but the
// first.
template <class T, class F>
__device__ __forceinline__ void for_staged_cells(F&& fn) {
  int lx = static_cast<int>(threadIdx.x) / T::kCols;
  int lz = static_cast<int>(threadIdx.x) - lx * T::kCols;
#pragma unroll
  for (int i = 0; i < T::kCopies; ++i) {
    if (lx < T::kRows) fn(lx, lz);
    lx += T::kStepRows;
    lz += T::kStepCols;
    if (lz >= T::kCols) {
      lz -= T::kCols;
      ++lx;
    }
  }
}

// A lane's operands of one mod_step_mma cell, loaded before the stage
// completes: the older field, the mask, v2*dt2 and, in the source's
// window, the patch value.
struct ModCell {
  float pp, m, v, w;
};

template <int H, int P>
__global__ void __launch_bounds__(ModTile<H>::kBlockThreads)
    mod_step_mma(const float* __restrict__ cur, float* __restrict__ old,
                 const float* __restrict__ v2dt2, int v2_shot_stride,
                 const float* __restrict__ mask,
                 const float* __restrict__ patch, int r,
                 const int* __restrict__ sx, int sz, float amp,
                 float* __restrict__ seis_it, int seis_shot_stride, int gz,
                 int nxb, int nx, int nxe, int nze, pfdc::Coefs c) {
  using T = ModTile<H>;
  extern __shared__ float smem[];
  float* f = smem;  // p, untapered, as the exact mod_step's taps read it
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.y * T::kX;
  const int z0 = blockIdx.x * T::kZ;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;
  const float* v2 = v2dt2 + s * static_cast<size_t>(v2_shot_stride);
  for_staged_cells<T>([&](int lx, int lz) {
    const int x = x0 - H + lx, z = z0 - H + lz;
    const bool in = x >= 0 && x < nxe && z >= 0 && z < nze;
    const size_t q = in ? static_cast<size_t>(x) * nze + z : 0;
    pfdc::cp_async4(f + lx * T::kPitch + lz, p + q, in);
  });
  // this lane's cells: rows xw + 8b + 2t + (q & 1), columns zw + g +
  // 8 (q >> 1) of the owned cells, their operands in flight with the stage
  const int zw = 16 * (warp % (T::kZ / 16));
  const int xw = 16 * (warp / (T::kZ / 16));
  const int g = pfdc::frag_g(lane), t = pfdc::frag_t(lane);
  const int xs = sx[s];
  ModCell cell[2][4];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ix = x0 + xw + 8 * b + 2 * t + (q & 1);
      const int iz = z0 + zw + g + 8 * (q >> 1);
      if (ix >= nxe || iz >= nze) continue;
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      ModCell& e = cell[b][q];
      e.pp = pp[j];
      e.m = mask[j];
      e.v = v2[j];
      const int dx = ix - xs, dz = iz - sz;
      if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
        e.w = patch[(dx + r) * (2 * r + 1) + (dz + r)];
      }
    }
  }
  pfdc::cp_async_wait_all();
  __syncthreads();
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    // the banded x taps: A[m][k] is column zw + m of the tile at row
    // xw + 8b + k, the window of output row xw + 8b + n
    const int r0 = xw + 8 * b;
    const int c0 = H + zw;
    float yx[4];
    pfdc::banded_mma<H, P>(
        yx, [&](int m, int k) { return f[(r0 + k) * T::kPitch + c0 + m]; },
        band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int xl = r0 + 2 * t + (q & 1);
      const int zl = zw + g + 8 * (q >> 1);
      const int ix = x0 + xl;
      const int iz = z0 + zl;
      if (ix >= nxe || iz >= nze) continue;
      const ModCell& e = cell[b][q];
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      const int jt = (H + xl) * T::kPitch + H + zl;
      const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                            ? yx[q] + pfdc::axis_taps<H>(f, jt, 1, c.z)
                            : 0.0f;
      const float pc = f[jt];
      float u = (2.0f * pc - e.pp * e.m) + e.v * lap;
      const int dx = ix - xs, dz = iz - sz;
      if (dx >= -r && dx <= r && dz >= -r && dz <= r) u = u + amp * e.w;
      pp[j] = u * e.m;
      if (iz == gz && ix >= nxb && ix < nxb + nx) {
        seis_it[s * static_cast<size_t>(seis_shot_stride) + (ix - nxb)] =
            pc * e.m;
      }
    }
  }
}

// A lane's operands of one rtm_fwd_step_mma cell, loaded before the stage
// completes: the older field and v2*dt2.
struct FwdCell {
  float pp, v;
};

template <int H, int P>
__global__ void __launch_bounds__(FwdTile<H>::kBlockThreads)
    rtm_fwd_step_mma(const float* __restrict__ cur, float* __restrict__ old,
                     const float* __restrict__ v2dt2, int v2_shot_stride,
                     const float* __restrict__ mask,
                     const int* __restrict__ sx, int sz, float amp, int nxe,
                     int nze, pfdc::Coefs c) {
  using T = FwdTile<H>;
  extern __shared__ float smem[];
  float* f = smem;  // m * p
  float* msk = smem + T::kCells;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.y * T::kX;
  const int z0 = blockIdx.x * T::kZ;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;
  const float* v2 = v2dt2 + s * static_cast<size_t>(v2_shot_stride);
  for_staged_cells<T>([&](int lx, int lz) {
    const int x = x0 - H + lx, z = z0 - H + lz;
    const bool in = x >= 0 && x < nxe && z >= 0 && z < nze;
    const size_t q = in ? static_cast<size_t>(x) * nze + z : 0;
    const int j = lx * T::kPitch + lz;
    pfdc::cp_async4(f + j, p + q, in);
    pfdc::cp_async4(msk + j, mask + q, in);
  });
  // this lane's cells, as in mod_step_mma
  const int zw = 16 * (warp % (T::kZ / 16));
  const int xw = 16 * (warp / (T::kZ / 16));
  const int g = pfdc::frag_g(lane), t = pfdc::frag_t(lane);
  const int xs = sx[s];
  FwdCell cell[2][4];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ix = x0 + xw + 8 * b + 2 * t + (q & 1);
      const int iz = z0 + zw + g + 8 * (q >> 1);
      if (ix >= nxe || iz >= nze) continue;
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      cell[b][q].pp = pp[j];
      cell[b][q].v = v2[j];
    }
  }
  // the staged field holds m * p, as the exact kernel's taps read it: each
  // thread tapers the cells it copied once its own copies have landed,
  // then one barrier
  pfdc::cp_async_wait_all();
  for_staged_cells<T>([&](int lx, int lz) {
    const int j = lx * T::kPitch + lz;
    f[j] = msk[j] * f[j];
  });
  __syncthreads();
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int r0 = xw + 8 * b;
    const int c0 = H + zw;
    float yx[4];
    pfdc::banded_mma<H, P>(
        yx, [&](int m, int k) { return f[(r0 + k) * T::kPitch + c0 + m]; },
        band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int xl = r0 + 2 * t + (q & 1);
      const int zl = zw + g + 8 * (q >> 1);
      const int ix = x0 + xl;
      const int iz = z0 + zl;
      if (ix >= nxe || iz >= nze) continue;
      const FwdCell& e = cell[b][q];
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      const int jt = (H + xl) * T::kPitch + H + zl;
      const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                            ? yx[q] + pfdc::axis_taps<H>(f, jt, 1, c.z)
                            : 0.0f;
      const float m = msk[jt];
      const float ppc = m * (m * e.pp);
      float u = (2.0f * f[jt] - ppc) + e.v * lap;
      if (ix == xs && iz == sz) u = u + amp;
      pp[j] = u;
    }
  }
}

// A lane's operands of one rtm_bwd_step_mma cell, loaded before the stage
// completes: the older source field (the snapshot on the two seeded
// steps), the older receiver field, v2*dt2 and, in the image's rectangle,
// the image.
struct BwdCell {
  float so, ro, v, img;
};

template <int H, int P>
__global__ void __launch_bounds__(BwdTile<H>::kBlockThreads)
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
  using T = BwdTile<H>;
  extern __shared__ float smem[];
  float* src = smem;                 // ps
  float* rec = smem + T::kCells;     // m * pr
  float* msk = smem + 2 * T::kCells;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.y * T::kX;
  const int z0 = blockIdx.x * T::kZ;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* ps = s_cur + s * plane;
  float* so = s_old + s * plane;
  const float* pr = r_cur + s * plane;
  float* ro = r_old + s * plane;
  const float* v2 = v2dt2 + s * static_cast<size_t>(v2_shot_stride);
  float* im = img + s * static_cast<size_t>(nx) * nz;
  // the source field is untapered; at it = 0, 1 it is the snapshot itself
  const bool seeded = snap != nullptr;
  for_staged_cells<T>([&](int lx, int lz) {
    const int x = x0 - H + lx, z = z0 - H + lz;
    const bool in = x >= 0 && x < nxe && z >= 0 && z < nze;
    const size_t q = in ? static_cast<size_t>(x) * nze + z : 0;
    const int j = lx * T::kPitch + lz;
    if (!seeded) pfdc::cp_async4(src + j, ps + q, in);
    pfdc::cp_async4(rec + j, pr + q, in);
    pfdc::cp_async4(msk + j, mask + q, in);
  });
  // this lane's cells, as in mod_step_mma
  const int zw = 16 * (warp % (T::kZ / 16));
  const int xw = 16 * (warp / (T::kZ / 16));
  const int g = pfdc::frag_g(lane), t = pfdc::frag_t(lane);
  BwdCell cell[2][4];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ix = x0 + xw + 8 * b + 2 * t + (q & 1);
      const int iz = z0 + zw + g + 8 * (q >> 1);
      if (ix >= nxe || iz >= nze) continue;
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      BwdCell& e = cell[b][q];
      e.so = seeded ? snap[s * plane + j] : so[j];
      e.ro = ro[j];
      e.v = v2[j];
      if (ix >= nxb && ix < nxb + nx && iz >= nzb && iz < nzb + nz) {
        e.img = im[static_cast<size_t>(ix - nxb) * nz + (iz - nzb)];
      }
    }
  }
  // the receiver's staged cells hold m * pr, as the exact kernels' taps
  // read it: tapered as in rtm_fwd_step_mma
  pfdc::cp_async_wait_all();
  for_staged_cells<T>([&](int lx, int lz) {
    const int j = lx * T::kPitch + lz;
    rec[j] = msk[j] * rec[j];
  });
  __syncthreads();
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.x, lane);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    // the banded x taps of both fields
    const int r0 = xw + 8 * b;
    const int c0 = H + zw;
    float ys[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float yr[4];
    if (!seeded) {
      pfdc::banded_mma<H, P>(
          ys, [&](int m, int k) { return src[(r0 + k) * T::kPitch + c0 + m]; },
          band, lane);
    }
    pfdc::banded_mma<H, P>(
        yr, [&](int m, int k) { return rec[(r0 + k) * T::kPitch + c0 + m]; },
        band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int xl = r0 + 2 * t + (q & 1);
      const int zl = zw + g + 8 * (q >> 1);
      const int ix = x0 + xl;
      const int iz = z0 + zl;
      if (ix >= nxe || iz >= nze) continue;
      const BwdCell& e = cell[b][q];
      const size_t j = static_cast<size_t>(ix) * nze + iz;
      const int jt = (H + xl) * T::kPitch + H + zl;
      const bool interior = pfdc::in_interior(ix, iz, H, nxe, nze);

      float us;
      if (seeded) {
        us = e.so;
      } else {
        const float lap =
            interior ? ys[q] + pfdc::axis_taps<H>(src, jt, 1, c.z) : 0.0f;
        us = (2.0f * src[jt] - e.so) + e.v * lap;
      }
      so[j] = us;

      const float m = msk[jt];
      const float lap =
          interior ? yr[q] + pfdc::axis_taps<H>(rec, jt, 1, c.z) : 0.0f;
      float ur = (2.0f * rec[jt] - m * (m * e.ro)) + e.v * lap;
      if (iz == gz && ix >= nxb && ix < nxb + nx) {
        ur = ur +
             inj_it[s * static_cast<size_t>(inj_shot_stride) + (ix - nxb)];
      }
      ro[j] = ur;

      if (ix >= nxb && ix < nxb + nx && iz >= nzb && iz < nzb + nz) {
        im[static_cast<size_t>(ix - nxb) * nz + (iz - nzb)] = e.img + us * ur;
      }
    }
  }
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
    using T = ModTile<H>;
    const size_t bytes = T::kBytes;
    const cudaError_t e = pfdc::allow_smem(mod_step_mma<H, P>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = T::grid(ns, nxe, nze);
    const dim3 block(T::kBlockThreads);
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      mod_step_mma<H, P><<<grid, block, bytes, stream>>>(
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
    using T = FwdTile<H>;
    const size_t bytes = T::kBytes;
    const cudaError_t e = pfdc::allow_smem(rtm_fwd_step_mma<H, P>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = T::grid(ns, nxe, nze);
    const dim3 block(T::kBlockThreads);
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      rtm_fwd_step_mma<H, P><<<grid, block, bytes, stream>>>(
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
    using T = BwdTile<H>;
    const size_t bytes = T::kBytes;
    const cudaError_t e = pfdc::allow_smem(rtm_bwd_step_mma<H, P>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = T::grid(ns, nxe, nze);
    const dim3 block(T::kBlockThreads);
    for (int it = 0; it < nt; ++it) {
      const bool even = it % 2 == 0;
      const float* snap = it == 0 ? snap1 : (it == 1 ? snap0 : nullptr);
      rtm_bwd_step_mma<H, P><<<grid, block, bytes, stream>>>(
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
