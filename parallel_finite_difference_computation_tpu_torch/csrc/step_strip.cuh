// The one-step split body: one time step with the z taps as the
// split-bf16 banded product, on the strip pieces of strip.cuh, shared by
// the K = 1 tier's fd_step_mma, fd_update_mma (stream_step.cu) and
// gpu_step_mma (gpu_step.cu), and rtm_main's rec_fwd_step_mma and
// rec_bwd_step_mma (rec_step.cu). Every per-step split kernel of those
// tiers runs it; the staged 64 x 64 tile they ran before is gone.
//
// What held the staged-tile kernels back on an H100 (PERF.md, kernel
// table, rows 8 and 10 split: 2.66x and 5.4x their bytes bound, read from
// the code; no ncu): blocks of four warps staged a 64 x 64 tile with
// synchronous loads and an integer division per element; every staged and
// every output cell rebuilt the taper from three global loads; every cell
// read all 2H + 1 x taps from shared memory; and gpu_step_mma let the lane
// that holds an mma output do that cell's whole step, so that each load and
// store of a warp spanned 8 rows at 4 columns 2 apart (8 half-filled
// sectors) for x, v2*dt2, the source field, the image and both outputs.
//
// This body (each step adopted against its variants on an H100, PERF.md;
// scripts/torch_step_probe.py):
// - takes blocks of kStripThreads on a shape list of its own, the first
//   that fits taken (strip_shape): 128 x 64 owned cells (at K = 1 the halo
//   is only H cells), the K = 1 calls 1-2 % faster than on 64 x 128 and
//   4-7 % faster than on 64 x 64;
// - stages only the field whose taps are read (p for fd_step_mma and
//   fd_update_mma, y for gpu_step_mma, the time-t field for
//   rec_fwd_step_mma and rec_bwd_step_mma) with cp.async, on rows padded
//   to 4 mod 8 floats (strip_pitch), and, where the step tapers, the
//   tile's x ramp;
// - for the kGpu state (gpu_step_mma) tapers the staged field in a phase
//   of its own (taper_strip_tile), so that the staged t = m*y is both the
//   tapped field and t_out;
// - takes the z product of the staged field (z_product) into a second
//   staged buffer, then one barrier;
// - walks the owned cells in strips of the site's kRows rows down one
//   column (StripWalk from lo = H, lanes along z): the x taps from a
//   register window of the staged field, added to the product at the cell
//   (cell_lap<H, P, Split::kZ>: zb + accx, the order of the JAX kernels'
//   use_mxu branch), the centre from the window, the taper (where the
//   step tapers) from the staged ramp and the column's z factor and strip
//   flag in registers.
//   Every other operand is read at the cell from global memory (lanes
//   along z: whole sectors), a strip's loads all issued before the first
//   of its stores, and the outputs are written straight to global memory.
//
// Exactness. Per cell the operations and their order are the plain
// versions' (solver.fd_step, solver.fd_update, solver._gpu_step, the
// source and receiver steps of solver.forward_modeling and
// solver.backward_recorded); built with -fmad=false. The
// outputs are buffers no block of the launch reads, or cells of a field
// that only the cell's own thread reads (the rec kernels' older field).
//
// The site. A kernel hands the body a Site: the flavour (kTaper: the step
// takes the taper's multiplier from its ramps; kGpu: the staged field is
// tapered before its taps are read), one shot's field pointer in the
// (nxf, nzf) layout and, with kTaper, the taper's ramps, the operands a
// cell reads from global memory (Site::Cell, load(gx, gz)), and step(gx,
// gz, cell, centre, m, lap), which finishes the cell's step from them,
// its staged value, its taper multiplier and its Laplacian (0 outside the
// interior); without kTaper step(gx, gz, cell, centre, lap): no ramp is
// staged or read and no multiplier is formed (fd_update does not taper;
// the rec kernels read their mask plane at the cell).
// The loads of a strip's cells go first: a store may alias a later cell's
// operand as far as the compiler knows, so loads and stores interleaved
// cell by cell would wait for memory once a cell instead of once a strip
// (fd_step_mma 288.6 -> 233.7 ms a 1001-step Pluto call when they were
// split). The site also picks its strip's rows (kRows) and whether a warp
// loads its next strip's operands while it computes the current one, and
// its first strip's before the stage (kAhead): 64 registers a thread hold
// either more rows or a second strip's operands, not both.
#pragma once

#include "strip.cuh"

namespace pfdc {

// Owned shapes, the first that fits taken (strip_shape), and what the body
// stages: the field and its z product on padded rows. 128 x 64 stages 83.2
// KB at order 8 and 97.3 KB at order 16: it fits at every order the
// kernels take, two blocks an SM.
constexpr StripShape kStepShapes[] = {{128, 64}};
constexpr StripStage kStepStage{2, false, true};

// The first of shapes that fits whose launch over ns shots of an (nx, nz)
// grid gives each of sms SMs at least kStripBlocks blocks, else the last
// that fits, or {0, 0} if none does: for a launcher whose grids can be too
// small to fill the card with its largest shape.
template <size_t N>
inline StripShape strip_shape_for_grid(const StripShape (&shapes)[N],
                                       StripStage g, int r, int ns, int nx,
                                       int nz, int sms) {
  StripShape last{0, 0};
  for (const StripShape& s : shapes) {
    if (strip_bytes(s, g, r) > static_cast<size_t>(kMaxSmemBytes)) continue;
    const dim3 grid = strip_grid(s, ns, nx, nz);
    if (static_cast<long long>(grid.x) * grid.y * grid.z >=
        static_cast<long long>(kStripBlocks) * sms) {
      return s;
    }
    last = s;
  }
  return last;
}

// The SMs of the current device into sms.
inline cudaError_t device_sms(int& sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// One step of the site's block on its tile (blockDim.x = kStripThreads, a
// 1-D block, a halo of t.r = H cells) with the z taps in P bf16 parts.
template <int H, int P, class Site>
__device__ __forceinline__ void step_strip(float* smem, const Site& site,
                                           const StripTile& t,
                                           const Coefs& c) {
  static_assert(P > 0, "the body of the split instances");
  constexpr int S = Site::kRows;
  const int pitch = strip_pitch(t.sz, kStepStage.padded);
  const int n = t.sx * pitch;
  float* f = smem;           // the field whose taps are read
  float* zb = smem + n;      // its z product
  float* sxr = smem + 2 * n;
  const int nxf = site.nxf, nzf = site.nzf;
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = static_cast<int>(blockDim.x) >> 5;
  // this warp's strips; with the site's kAhead, the first one's operands
  // loaded before the stage and each next one's before the current one is
  // computed, else each one's when it is taken
  const StripWalk<S> walk(t, H);
  typename Site::Cell in[S], next[S];
  auto load_strip = [&](int item, typename Site::Cell(&cell)[S]) {
    int lx0, rows, lz, gz;
    if (item >= walk.items ||
        !walk.strip(item, lane, t, nzf, lx0, rows, lz, gz)) {
      return;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int gx = t.gx0 + lx0 + i;
      if (i < rows && gx >= 0 && gx < nxf) cell[i] = site.load(gx, gz);
    }
  };
  if constexpr (Site::kAhead) load_strip(warp, in);
  if constexpr (Site::kTaper) {
    stage_strip_tile<1>({f}, {site.field}, sxr, site.xramp, t, nxf, nzf,
                        [](int, int) { return true; }, pitch);
  } else {
    stage_strip_fields<1>({f}, {site.field}, t, nxf, nzf,
                          [](int, int) { return true; }, pitch);
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (Site::kGpu) {
    taper_strip_tile(f, sxr, site.zfac, site.strip, t, nxf, nzf, pitch);
  }
  const Band<H, P> band = band_fragments<H, P>(c.z, lane);
  z_product<H, P>(zb, f, t, H, band, pitch, warp, nwarps, lane);
  __syncthreads();
  for (int item = warp; item < walk.items; item += nwarps) {
    if constexpr (Site::kAhead) {
      load_strip(item + nwarps, next);
    } else {
      load_strip(item, in);
    }
    int lx0, rows, lz, gz;
    if (walk.strip(item, lane, t, nzf, lx0, rows, lz, gz)) {
      float zf = 1.0f;
      bool ramp = false;
      if constexpr (Site::kTaper) {
        zf = site.zfac[gz];
        ramp = site.strip[gz] != 0.0f;
      }
      float w[1][S + 2 * H];
      strip_windows<H>(w, {f}, t, lx0, rows, lz, pitch);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int lx = lx0 + i, gx = t.gx0 + lx;
        if (i >= rows || gx < 0 || gx >= nxf) continue;
        const int j = lx * pitch + lz;
        const float lap =
            in_interior(gx, gz, H, nxf, nzf)
                ? cell_lap<H, P, Split::kZ>(w[0], i, f, zb, j, c)
                : 0.0f;
        if constexpr (Site::kTaper) {
          site.step(gx, gz, in[i], w[0][i + H],
                    strip_taper(sxr, lx, zf, ramp), lap);
        } else {
          site.step(gx, gz, in[i], w[0][i + H], lap);
        }
      }
    }
    if constexpr (Site::kAhead) {
#pragma unroll
      for (int i = 0; i < S; ++i) in[i] = next[i];
    }
  }
}

}  // namespace pfdc
