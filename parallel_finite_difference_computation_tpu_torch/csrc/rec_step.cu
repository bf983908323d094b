// rec_fwd_step / rec_bwd_step: one time step of rtm_main's full-wavefield
// RTM (rtm_main.cpp:158-247) for every shot of a batch, their split-bf16
// twins rec_fwd_step_mma and rec_bwd_step_mma, rec_fwd_cluster and
// rec_bwd_cluster (all nt steps of the exact forward or backward in one
// launch where a shot fits a thread-block cluster: mod_loop of
// cluster_loop.cuh with the source's patch recording the frames, as
// mod_cluster records the trace, or with the injection row recording the
// frames or the image), and the C entry points pfdc_rec_fwd_run and
// pfdc_rec_bwd_run that run the whole time loop on a stream.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kstep_rec_kernel (:1002), called through fd_kstep_rec_padded (:1084) in
// source-window mode (the forward half, solver.py:311-321 there) and in
// receiver-column mode (the backward half, solver.py:663-719). That kernel
// fuses K steps per pass only because a large grid does not fit in VMEM;
// here a shot that fits a cluster runs all nt steps in one launch (the
// *_cluster kernels), and elsewhere each step is one launch over all
// shots, as in mod_step.cu, the host function looping over the steps. The
// *_mma kernels replace its
// use_mxu branch (:1026-1033: _lap_z_mxu_full + _lap_x_slab, the z taps as
// the split-bf16 banded product, then the x taps exact).
//
// The step is the CPU-flavor step of mod_step.cu: u = (2p - m*pp) +
// v2dt2*lap(p), inject into u, store pp <- u*m; the time-t value is m*p.
// Injection comes before the taper (the lax order), so every value rounds
// as the plain torch version's does. The TPU kernel adds a pre-masked
// injection after the taper instead, which rounds differently.
//
// rec_fwd_step (source mode) adds amp * patch around (sx[s], sz) and writes
// m*p of each interior cell into swf[s, it]. rec_bwd_step (receiver mode)
// adds inj[s, it, ix - x0] on row gz for x0 <= ix < x0 + nx (x0 already
// clamped into the grid by the wrapper, as the JAX package's
// dynamic_update_slice clamps it) and then either
//   - frame mode: writes m*p of each interior cell into rwf[s, it], or
//   - image mode: img[s] += swf[s, nt-1-it] * (m*p), the zero-lag
//     correlation of rtm_main.cpp:223-229 summed in time order. Each thread
//     owns its cell, so no atomics; rwf is never stored.
//
// What bounds it on an H100: the frames. At the 3lay size (231 x 231
// extended, 151 x 151 interior, nt = 1001, 8 shots) swf is 730 MB, written
// once by the forward and read once by the backward: 0.22 ms each at
// 3.35 TB/s, about the time of the ~33 flop per cell-step at 67 TFLOP/s.
// The fields, v2*dt2 and the mask (7 MB) stay in L2. The per-step kernels
// do nothing special: threads run along z for coalesced loads and frame
// stores, nothing is staged in shared memory, and each launch is short, so
// launch latency sets their pace, as for mod_step. The resident kernels
// hold the fields in the cluster's shared memory and issue the step's
// instructions (cluster_loop.cuh); rec_bwd_cluster's image mode reads each
// thread's source frame values a step ahead, into registers, so that the
// stream of swf overlaps the step before.
//
// rec_fwd_step_mma<H, P> and rec_bwd_step_mma<H, P, kImage> compute what
// their exact twins compute, in the same order, but for the Laplacian: the
// z taps as the P-part (2: lap_impl "mxu", 3: "mxu6") split-bf16 banded
// product on the tensor cores, plus the exact x taps. Both run the
// one-step split body of step_strip.cuh without a taper (the stored field
// is tapered already; the mask plane is read at the cell), each through a
// site of its own: a block of 16 warps stages the time-t field over its
// owned cells and an H-cell halo with cp.async, takes its z product behind
// one barrier, and walks the owned cells in 4-row strips, lanes along z
// (whole sectors for the fields, the frames and the image), reading the
// older field, v2*dt2, the mask and, in image mode, swf and the image at
// the cell (the receiver step the next strip's while it computes the
// current one); the source step adds the point source's patch where its
// window covers the cell.
// Their launchers take the largest owned shape whose grid gives every SM
// two blocks (kRecShapes, rec_shape): 3lay's 8 shots of 231 x 231 gave 128
// x 64 tiles only 64 blocks for the card's 132 SMs. On a staged 64 x 64
// tile of four warps rec_fwd_step_mma ran 3.3x its exact twin at 3lay
// (PERF.md, kernel table, row 14).
//
// Frame offsets are size_t: ns * nt * nx * nz passes 2^31 at marmousi size.
#include "cluster_loop.cuh"
#include "step_strip.cuh"

namespace {

// The CPU-flavor update of cell j of one shot (mod_step.cu): cur holds the
// time-t field as stored (tapered once on write), old the older field,
// tapered on read.
template <int H>
__device__ __forceinline__ float cpu_update(const float* __restrict__ p,
                                            const float* __restrict__ pp,
                                            const float* __restrict__ mask,
                                            float m, float v, int ix, int iz,
                                            int j, int nxe, int nze,
                                            const pfdc::Coefs& c) {
  const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                        ? pfdc::laplacian<H, false>(p, mask, j, nze, c)
                        : 0.0f;
  return (2.0f * p[j] - pp[j] * m) + v * lap;
}

// Offset of interior cell (ix, iz) in one (nx, nz) frame.
__device__ __forceinline__ size_t frame_offset(int ix, int iz, int nxb,
                                               int nzb, int nz) {
  return static_cast<size_t>(ix - nxb) * nz + (iz - nzb);
}

template <int H>
__global__ void rec_fwd_step(const float* __restrict__ cur,
                             float* __restrict__ old,
                             const float* __restrict__ v2dt2,
                             int v2_shot_stride,
                             const float* __restrict__ mask,
                             const float* __restrict__ patch, int r,
                             const int* __restrict__ sx, int sz, float amp,
                             float* __restrict__ swf_it,
                             size_t swf_shot_stride, int nxb, int nzb,
                             int nx, int nz, int nxe, int nze,
                             pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;

  const float m = mask[j];
  const float pc = p[j];
  float u = cpu_update<H>(p, pp, mask, m,
                          v2dt2[s * static_cast<size_t>(v2_shot_stride) + j],
                          ix, iz, j, nxe, nze, c);
  const int dx = ix - sx[s];
  const int dz = iz - sz;
  if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
    u = u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)];
  }
  pp[j] = u * m;
  if (ix >= nxb && ix < nxb + nx && iz >= nzb && iz < nzb + nz) {
    swf_it[s * swf_shot_stride + frame_offset(ix, iz, nxb, nzb, nz)] = pc * m;
  }
}

// rec_fwd_step's loop as one launch (mod_loop, cluster_loop.cuh), the
// frames of every step into g.rec, stored as scalars: at 3lay nz (151) is
// odd, so a pair of columns starts on 8 bytes in every other row only.
template <int H>
__global__ void __launch_bounds__(pfdc::kClusterThreads, 1)
    rec_fwd_cluster(pfdc::ModArgs g, pfdc::Coefs c) {
  extern __shared__ float smem[];
  pfdc::mod_loop<H, pfdc::kRecordFrames>(smem, g, c);
}

// rec_bwd_step's loop as one launch (mod_loop with the injection row,
// cluster_loop.cuh): the frames of every step into g.rec, stored as scalars,
// or (kImage) the image, summed in registers and stored once.
template <int H, bool kImage>
__global__ void __launch_bounds__(pfdc::kClusterThreads, 1)
    rec_bwd_cluster(pfdc::RecvArgs g, pfdc::Coefs c) {
  extern __shared__ float smem[];
  pfdc::mod_loop<H, kImage ? pfdc::kRecordImage : pfdc::kRecordFrames>(
      smem, g, c);
}

template <int H, bool kImage>
__global__ void rec_bwd_step(const float* __restrict__ cur,
                             float* __restrict__ old,
                             const float* __restrict__ v2dt2,
                             int v2_shot_stride,
                             const float* __restrict__ mask,
                             const float* __restrict__ inj_it,
                             size_t inj_shot_stride, int x0, int gz,
                             const float* __restrict__ swf_rev,
                             float* __restrict__ out,
                             size_t frame_shot_stride, int nxb, int nzb,
                             int nx, int nz, int nxe, int nze,
                             pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;

  const float m = mask[j];
  const float pc = p[j];
  float u = cpu_update<H>(p, pp, mask, m,
                          v2dt2[s * static_cast<size_t>(v2_shot_stride) + j],
                          ix, iz, j, nxe, nze, c);
  if (iz == gz && ix >= x0 && ix < x0 + nx) {
    u = u + inj_it[s * inj_shot_stride + (ix - x0)];
  }
  pp[j] = u * m;
  if (ix >= nxb && ix < nxb + nx && iz >= nzb && iz < nzb + nz) {
    const size_t q = frame_offset(ix, iz, nxb, nzb, nz);
    if (kImage) {
      // out is img (ns, nx, nz); swf_rev is frame nt-1-it of shot 0
      float* im = out + s * static_cast<size_t>(nx) * nz + q;
      *im = *im + swf_rev[s * frame_shot_stride + q] * (pc * m);
    } else {
      // out is frame it of rwf (ns, nt, nx, nz), shot 0
      out[s * frame_shot_stride + q] = pc * m;
    }
  }
}

// rec_fwd_step_mma's site (step_strip.cuh, no taper): one shot's fields
// on the (nxf, nzf) grid; the source step from the staged time-t field and
// the cell's older field, v2*dt2 and mask, the point source's patch in the
// (2r+1)^2 window around (sx, sz), and the frame of the interior. The
// older field is written in place: only the cell's own thread reads it.
// Three operands a cell: strips of 4 rows, each strip's loaded when it is
// taken (a 3lay call 7 % faster than with the next strip's loaded ahead,
// a 203-step Pluto call 3 % slower; 8-row strips, which spill, 11 % and
// 32 % slower than 4 with the lookahead; PERF.md).
struct RecFwdSite {
  static constexpr int kRows = pfdc::kStripRows;
  static constexpr bool kAhead = false;
  static constexpr bool kTaper = false;
  static constexpr bool kGpu = false;
  const float* field;   // the time-t field, as stored
  int nxf, nzf;
  float* old;
  const float* v2dt2;
  const float* mask;
  const float* patch;   // (2r+1, 2r+1)
  int r, sx, sz;
  float amp;
  float* swf;           // frame it of the shot
  int nxb, nzb, nx, nz;

  struct Cell {
    float old, v, m;
  };
  __device__ Cell load(int gx, int gz) const {
    const size_t j = static_cast<size_t>(gx) * nzf + gz;
    return {old[j], __ldg(v2dt2 + j), __ldg(mask + j)};
  }
  __device__ void step(int gx, int gz, const Cell& in, float pc,
                       float lap) const {
    float u = (2.0f * pc - in.old * in.m) + in.v * lap;
    const int dx = gx - sx;
    const int dz = gz - sz;
    if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
      u = u + amp * __ldg(patch + (dx + r) * (2 * r + 1) + (dz + r));
    }
    old[static_cast<size_t>(gx) * nzf + gz] = u * in.m;
    if (gx >= nxb && gx < nxb + nx && gz >= nzb && gz < nzb + nz) {
      swf[frame_offset(gx, gz, nxb, nzb, nz)] = pc * in.m;
    }
  }
};

template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    rec_fwd_step_mma(const float* __restrict__ cur, float* __restrict__ old,
                     const float* __restrict__ v2dt2, int v2_shot_stride,
                     const float* __restrict__ mask,
                     const float* __restrict__ patch, int r,
                     const int* __restrict__ sx, int sz, float amp,
                     float* __restrict__ swf_it, size_t swf_shot_stride,
                     int nxb, int nzb, int nx, int nz, int nxe, int nze,
                     pfdc::StripShape shape, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const RecFwdSite site{
      cur + s * plane, nxe, nze, old + s * plane,
      v2dt2 + s * static_cast<size_t>(v2_shot_stride), mask, patch, r,
      sx[s], sz, amp, swf_it + s * swf_shot_stride, nxb, nzb, nx, nz};
  const pfdc::StripTile t(H, shape, static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::step_strip<H, P>(smem, site, t, c);
}

// rec_bwd_step_mma's site (step_strip.cuh, no taper): one shot's fields
// on the (nxf, nzf) grid; the receiver step from the staged time-t field
// and the cell's older field, v2*dt2 and mask and, in image mode over the
// interior, swf's frame and the image. The older field is written in
// place: only the cell's own thread reads it. Up to five operands a
// cell: strips of 4 rows, the next strip's loaded ahead (a 2-shot,
// 203-step Pluto call 10-13 % faster than with each strip's loaded when
// it is taken, 3lay within 1.3 % either way; 8 rows ran 3lay 47 % slower,
// PERF.md).
template <bool kImage>
struct RecBwdSite {
  static constexpr int kRows = pfdc::kStripRows;
  static constexpr bool kAhead = true;
  static constexpr bool kTaper = false;
  static constexpr bool kGpu = false;
  const float* field;   // the time-t field, as stored
  int nxf, nzf;
  float* old;
  const float* v2dt2;
  const float* mask;
  const float* inj;     // this step's row of the shot, x from x0
  int x0, gz;
  const float* swf;     // frame nt-1-it of the shot (image mode)
  float* out;           // the shot's image, or frame it of its rwf
  int nxb, nzb, nx, nz;

  struct Cell {
    float old, v, m, swf, img;
  };
  __device__ bool interior(int gx, int gz_) const {
    return gx >= nxb && gx < nxb + nx && gz_ >= nzb && gz_ < nzb + nz;
  }
  __device__ Cell load(int gx, int gz_) const {
    const size_t j = static_cast<size_t>(gx) * nzf + gz_;
    Cell c{old[j], __ldg(v2dt2 + j), __ldg(mask + j), 0.0f, 0.0f};
    if constexpr (kImage) {
      if (interior(gx, gz_)) {
        const size_t q = frame_offset(gx, gz_, nxb, nzb, nz);
        c.swf = __ldg(swf + q);
        c.img = out[q];
      }
    }
    return c;
  }
  __device__ void step(int gx, int gz_, const Cell& in, float pc,
                       float lap) const {
    float u = (2.0f * pc - in.old * in.m) + in.v * lap;
    if (gz_ == gz && gx >= x0 && gx < x0 + nx) u = u + inj[gx - x0];
    old[static_cast<size_t>(gx) * nzf + gz_] = u * in.m;
    if (interior(gx, gz_)) {
      const size_t q = frame_offset(gx, gz_, nxb, nzb, nz);
      if constexpr (kImage) {
        out[q] = in.img + in.swf * (pc * in.m);
      } else {
        out[q] = pc * in.m;
      }
    }
  }
};

template <int H, int P, bool kImage>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    rec_bwd_step_mma(const float* __restrict__ cur, float* __restrict__ old,
                     const float* __restrict__ v2dt2, int v2_shot_stride,
                     const float* __restrict__ mask,
                     const float* __restrict__ inj_it,
                     size_t inj_shot_stride, int x0, int gz,
                     const float* __restrict__ swf_rev,
                     float* __restrict__ out, size_t frame_shot_stride,
                     int nxb, int nzb, int nx, int nz, int nxe, int nze,
                     pfdc::StripShape shape, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const RecBwdSite<kImage> site{
      cur + s * plane, nxe, nze, old + s * plane,
      v2dt2 + s * static_cast<size_t>(v2_shot_stride), mask,
      inj_it + s * inj_shot_stride, x0, gz,
      kImage ? swf_rev + s * frame_shot_stride : nullptr,
      out + s * (kImage ? static_cast<size_t>(nx) * nz : frame_shot_stride),
      nxb, nzb, nx, nz};
  const pfdc::StripTile t(H, shape, static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::step_strip<H, P>(smem, site, t, c);
}

// The owned shapes of rec_fwd_step_mma and rec_bwd_step_mma, largest
// first: the launchers take the first whose grid gives every SM two
// blocks, else the last (strip_shape_for_grid). Pluto's 2 shots take 128 x
// 64 (2310 blocks), 3lay's 8 shots of 231 x 231 32 x 64 (256 blocks: 64 x
// 64 gives 128).
constexpr pfdc::StripShape kRecShapes[] = {{128, 64}, {64, 64}, {32, 64}};

// The shape of a launch of the rec kernel over ns shots of the (nxe, nze)
// grid on this device, and its bytes of dynamic shared memory, allowed to
// the kernel.
template <int H, class Kernel>
cudaError_t rec_shape(Kernel kernel, int ns, int nxe, int nze,
                      pfdc::StripShape& shape, size_t& bytes) {
  int sms = 0;
  const cudaError_t e = pfdc::device_sms(sms);
  if (e != cudaSuccess) return e;
  shape = pfdc::strip_shape_for_grid(kRecShapes, pfdc::kStepStage, H, ns,
                                     nxe, nze, sms);
  if (shape.tx == 0) return cudaErrorInvalidValue;
  bytes = pfdc::strip_bytes(shape, pfdc::kStepStage, H);
  return pfdc::allow_smem(kernel, bytes);
}

struct RecFwdRun {
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* patch;
  int r;
  const int* sx;
  int sz;
  const float* wav;   // host, nt samples
  const float* dwav;  // device, nt samples (the resident route)
  float* swf;         // (ns, nt, nx, nz)
  int ns, nxe, nze, nxb, nzb, nt;
  pfdc::Coefs c;
  int parts;
  pfdc::ClusterPlan plan;  // plan.cluster == 0: the per-step route
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t launch() const {
    const int nx = nxe - 2 * nxb;
    const int nz = nze - 2 * nzb;
    const size_t frame = static_cast<size_t>(nx) * nz;
    pfdc::StripShape shape{0, 0};
    size_t bytes = 0;
    if constexpr (P > 0) {
      const cudaError_t e =
          rec_shape<H>(rec_fwd_step_mma<H, P>, ns, nxe, nze, shape, bytes);
      if (e != cudaSuccess) return e;
    }
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      float* swf_it = swf + static_cast<size_t>(it) * frame;
      if constexpr (P == 0) {
        const dim3 grid = pfdc::step_grid(ns, nxe, nze);
        const dim3 block = pfdc::step_block();
        rec_fwd_step<H><<<grid, block, 0, stream>>>(
            cur, old, v2dt2, v2_shot_stride, mask, patch, r, sx, sz, wav[it],
            swf_it, static_cast<size_t>(nt) * frame, nxb, nzb, nx, nz, nxe,
            nze, c);
      } else {
        const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
        const dim3 block(pfdc::kStripThreads);
        rec_fwd_step_mma<H, P><<<grid, block, bytes, stream>>>(
            cur, old, v2dt2, v2_shot_stride, mask, patch, r, sx, sz, wav[it],
            swf_it, static_cast<size_t>(nt) * frame, nxb, nzb, nx, nz, nxe,
            nze, shape, c);
      }
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }

  template <int H>
  cudaError_t operator()() const {
    if (plan.cluster) {
      const pfdc::ModArgs g{a,   b,  v2dt2, v2_shot_stride, mask,
                            patch, r, sx,   sz,             dwav,
                            swf, 0,  nxb,   nzb,            nxe - 2 * nxb,
                            nze - 2 * nzb,  nxe, nze,       plan.rows,
                            nt};
      return pfdc::launch_cluster(rec_fwd_cluster<H>, plan, ns,
                                  plan.fwd_bytes, stream, g, c);
    }
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

struct RecFwdClusters {
  pfdc::ClusterPlan plan;
  int* out;
  template <int H>
  cudaError_t operator()() const {
    *out = pfdc::active_clusters(rec_fwd_cluster<H>, plan, plan.fwd_bytes);
    return cudaSuccess;
  }
};

struct RecBwdRun {
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* inj;  // (ns, nt, nx)
  int x0, gz;
  const float* swf;  // (ns, nt, nx, nz) in image mode, else nullptr
  float* out;        // img (ns, nx, nz) in image mode, else rwf
  int ns, nxe, nze, nxb, nzb, nt;
  pfdc::Coefs c;
  int parts;
  pfdc::ClusterPlan plan;  // plan.cluster == 0: the per-step route
  cudaStream_t stream;

  template <int H, int P, bool kImage>
  cudaError_t run() const {
    const int nx = nxe - 2 * nxb;
    const int nz = nze - 2 * nzb;
    const size_t frame = static_cast<size_t>(nx) * nz;
    pfdc::StripShape shape{0, 0};
    size_t bytes = 0;
    if constexpr (P > 0) {
      const cudaError_t e = rec_shape<H>(rec_bwd_step_mma<H, P, kImage>, ns,
                                         nxe, nze, shape, bytes);
      if (e != cudaSuccess) return e;
    }
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      const float* swf_rev =
          kImage ? swf + static_cast<size_t>(nt - 1 - it) * frame : nullptr;
      float* out_it = kImage ? out : out + static_cast<size_t>(it) * frame;
      const float* inj_it = inj + static_cast<size_t>(it) * nx;
      if constexpr (P == 0) {
        const dim3 grid = pfdc::step_grid(ns, nxe, nze);
        const dim3 block = pfdc::step_block();
        rec_bwd_step<H, kImage><<<grid, block, 0, stream>>>(
            cur, old, v2dt2, v2_shot_stride, mask, inj_it,
            static_cast<size_t>(nt) * nx, x0, gz, swf_rev, out_it,
            static_cast<size_t>(nt) * frame, nxb, nzb, nx, nz, nxe, nze, c);
      } else {
        const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
        const dim3 block(pfdc::kStripThreads);
        rec_bwd_step_mma<H, P, kImage><<<grid, block, bytes, stream>>>(
            cur, old, v2dt2, v2_shot_stride, mask, inj_it,
            static_cast<size_t>(nt) * nx, x0, gz, swf_rev, out_it,
            static_cast<size_t>(nt) * frame, nxb, nzb, nx, nz, nxe, nze,
            shape, c);
      }
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }

  template <int H, int P>
  cudaError_t launch() const {
    return swf != nullptr ? run<H, P, true>() : run<H, P, false>();
  }

  template <int H>
  cudaError_t operator()() const {
    if (plan.cluster) {
      const pfdc::RecvArgs g{a,   b,   v2dt2, v2_shot_stride, mask,
                             inj, x0,  swf,   out,            gz,
                             nxb, nzb, nxe - 2 * nxb,         nze - 2 * nzb,
                             nxe, nze, plan.rows,             nt};
      return swf != nullptr
                 ? pfdc::launch_cluster(rec_bwd_cluster<H, true>, plan, ns,
                                        plan.fwd_bytes, stream, g, c)
                 : pfdc::launch_cluster(rec_bwd_cluster<H, false>, plan, ns,
                                        plan.fwd_bytes, stream, g, c);
    }
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

struct RecBwdClusters {
  pfdc::ClusterPlan plan;
  int* out;
  template <int H>
  cudaError_t operator()() const {
    *out = pfdc::active_clusters(rec_bwd_cluster<H, true>, plan,
                                 plan.fwd_bytes);
    return cudaSuccess;
  }
};

}  // namespace

// Runs nt steps of the source-mode step, writing the (ns, nt, nx, nz)
// interior frames into swf: with parts 0, rec_fwd_cluster where the shot
// fits a cluster (pfdc::cluster_plan) and per_step is 0, else nt launches
// of rec_fwd_step; parts 2 or 3, the z taps in that many bf16 splits, nt
// launches of rec_fwd_step_mma. *resident says which (1: the cluster
// kernel). a and b hold the two fields (zeroed by the caller); after the
// loop the newest field is in b when nt is odd, else in a. wav is the
// nt-sample wavelet on the host (the per-step kernels take a sample a
// launch), dwav the same on the device (the resident route). Returns a
// cudaError_t.
extern "C" int pfdc_rec_fwd_run(float* a, float* b, const float* v2dt2,
                                int v2_shot_stride, const float* mask,
                                const float* patch, int r, const int* sx,
                                int sz, const float* wav, const float* dwav,
                                float* swf, int ns, int nxe, int nze, int nxb,
                                int nzb, int nt, int order, int parts,
                                const float* cx, const float* cz,
                                int per_step, int* resident, void* stream) {
  pfdc::ClusterPlan plan;
  if (!per_step && parts == 0) plan = pfdc::cluster_plan(nxe, nze, order);
  *resident = plan.cluster != 0;
  const RecFwdRun run{a,     b,   v2dt2, v2_shot_stride, mask, patch, r,
                      sx,    sz,  wav,   dwav,           swf,  ns,    nxe,
                      nze,   nxb, nzb,   nt,             pfdc::make_coefs(order / 2, cx, cz),
                      parts, plan, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// The most clusters of rec_fwd_cluster the card holds at once at (nxe, nze,
// order), or -1 where the shot takes the per-step route or on an error.
extern "C" int pfdc_rec_fwd_clusters(int nxe, int nze, int order) {
  int n = -1;
  const RecFwdClusters f{pfdc::cluster_plan(nxe, nze, order), &n};
  if (f.plan.cluster) pfdc::dispatch_half(order, f);
  return n;
}

// Runs nt steps of the receiver-mode step with the (ns, nt, nx) injection
// rows inj, added on row gz from x0: with parts 0, rec_bwd_cluster where
// the shot fits a cluster (pfdc::cluster_plan) and per_step is 0, else nt
// launches of rec_bwd_step; parts 2 or 3, nt launches of rec_bwd_step_mma.
// *resident says which (1: the cluster kernel). With swf null (frame mode)
// it writes the (ns, nt, nx, nz) frames into out; with swf the forward's
// frames (image mode) it adds each shot's correlation into out, an (ns,
// nx, nz) image zeroed by the caller (the resident route writes it once,
// and leaves a and b as they were). Field roles as for pfdc_rec_fwd_run.
// Returns a cudaError_t.
extern "C" int pfdc_rec_bwd_run(float* a, float* b, const float* v2dt2,
                                int v2_shot_stride, const float* mask,
                                const float* inj, int x0, int gz,
                                const float* swf, float* out, int ns, int nxe,
                                int nze, int nxb, int nzb, int nt, int order,
                                int parts, const float* cx, const float* cz,
                                int per_step, int* resident, void* stream) {
  pfdc::ClusterPlan plan;
  if (!per_step && parts == 0) plan = pfdc::cluster_plan(nxe, nze, order);
  *resident = plan.cluster != 0;
  const RecBwdRun run{a,   b,   v2dt2, v2_shot_stride, mask, inj, x0,
                      gz,  swf, out,   ns,             nxe,  nze, nxb,
                      nzb, nt,  pfdc::make_coefs(order / 2, cx, cz),
                      parts, plan, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// The most clusters of rec_bwd_cluster (image mode) the card holds at once
// at (nxe, nze, order), or -1 where the shot takes the per-step route or on
// an error.
extern "C" int pfdc_rec_bwd_clusters(int nxe, int nze, int order) {
  int n = -1;
  const RecBwdClusters f{pfdc::cluster_plan(nxe, nze, order), &n};
  if (f.plan.cluster) pfdc::dispatch_half(order, f);
  return n;
}
