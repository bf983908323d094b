// The backward body of the temporal-blocking kernels: K steps of the GPU
// suite's backward propagation and imaging (fd_back,
// cuda_reference_RTM/src/fd-code.cu:290-341) on one block's staged tile,
// shared by kstep_gpu_bwd (kstep_gpu_bwd.cu, the large-grid tier) and
// block_bwd / block2_bwd (domain_block.cuh, the domain tiers), and with
// the x taps in split bf16 (P > 0, below) by block_bwd_mma /
// block2_bwd_mma, with the z taps in split bf16 by kstep_gpu_bwd_mma.
//
// What held the earlier body back on an H100 (PERF.md, kernel table): it
// staged five fields and the image (131 KB at order 8, K = 4; 147 KB for
// the domain tiers' 32 x 32 owned cells at K = 8), so an SM ran one block
// of 16 warps, whose load phase of dependent global loads no other block
// hid; every cell-step read 34 taps and 7 more values from shared memory
// and rebuilt the taper from three global loads, twice; and a generic cell
// loop recomputed bounds for every cell.
//
// This body (on the strip pieces of strip.cuh, which the forward body of
// fwd_strip.cuh shares):
// - stages only what neighbours read: the source and receiver fields at
//   two time levels (the leapfrog's current and older field), with cp.async
//   (every load of a thread in flight at once), plus the owned image and
//   the taper's x ramp along the tile's rows. v2*dt2 is read from global
//   memory at the cell's own position (an L1/L2 hit) and the z factors of
//   the taper stay in registers, so a tile of 32 x 64 owned cells at order
//   8, K = 4 takes 107 KB and two blocks share an SM;
// - gives each thread a strip of kStripRows cells down one column (lanes
//   along z): the strip's x taps come from a window of kStripRows + 2H
//   values loaded once into registers, so a Laplacian reads 2H z taps and
//   (kStripRows + 2H) / kStripRows window values from shared memory
//   instead of 4H + 1 taps (11 at order 8, against 17);
// - lays the strips over each step's shrinking region anew (rows from
//   (k+1)H, columns in warps of 32 from (k+1)H), so no warp visits a cell
//   outside it, and the warps share the region's strips in turn;
// - tapers the receiver field where it is written: each step stores
//   u * m as the next step's tapered field (untapered after the last step,
//   for the output), and a phase of its own behind a barrier tapers the
//   staged field before step 0. The values are those of tapering in place
//   in a phase of its own, without a second barrier a step.
//
// Exactness. Per cell and step the operations, their order and rounding
// are the earlier body's (and rtm_bwd_step's): the taps summed as
// stencil.cuh's laplacian does (accz from H down to 1, then the centre;
// accx the same; accz + accx), the update (2p - pp) + v * lap, the
// receiver's ppr * m, the trace row, and the image sum in time order
// (from the running image in kstep_gpu_bwd, from 0 in block_bwd). Built
// with -fmad=false, so the kernels stay bitwise equal to their plain
// versions. A step writes only the older time level, at its own cells,
// and reads the current level, so one barrier a step separates every
// write from every read of another thread; outputs go to buffers no block
// of the launch reads.
//
// The site. A kernel hands the body a Site that says where the tile lies
// and what its cells mean: the field pointers (of one shot, in the
// field's (nxf, nzf) layout), the tile, and per cell v2*dt2, the snapshot
// that seeds a step (block_bwd's first block) if any, the trace row's
// injection, and whether a cell is imaged and stored.
//
// The split x taps (P = 2 or 3 bf16 parts: lap_impl "mxu", "mxu6";
// Split::kX, the domain tiers' block kernels). Each
// step first takes the x taps of the source and the receiver field over
// the step's region as the banded product on the tensor cores
// (strip.cuh's x_product; the source's not on a seeded step) into two
// more staged buffers, then a barrier: an mma hands an output to another
// lane than the strip's cell thread. The cell loop then adds the exact z
// taps to the product at the cell (xb + accz, the order of the JAX
// kernels' use_mxu branch and of the plain split Laplacian), and keeps
// everything else of the exact step. No register window is loaded: the x
// taps are the product's. Two barriers a step (the products', the
// step's); the products are written only after the end-of-step barrier
// that follows every read of the last ones. What the split body stages: 6
// tile fields (the four fields and the two products), the owned image and
// the x ramp, its rows padded to a pitch of 4 mod 8 floats (strip_pitch:
// the product's fragment reads and stores without bank conflicts), on the
// exact body's shapes and launch bounds (32 x 64 owned cells first: 162.0
// KB at order 8 and a pass of 4 steps, one block an SM). On an H100, over
// one 2-shot, 1001-step Pluto call (PERF.md, scripts/torch_bwd_mma_probe.py)
// these ran faster than 32 x 32 first (two blocks an SM), 16 x 32 first,
// the unpadded pitch and one pass of 8 steps; __launch_bounds__(512, 1)
// ran no faster. A second pass's buffers may hold no value past what the
// first wrote: the split instances stage 0 there (the site's held()),
// since the product multiplies every value it reads.
//
// The split z taps (Split::kZ, kstep_gpu_bwd_mma: the JAX K-step kernels
// split the z taps and keep the x taps exact). Each step takes the z
// products of the source and the receiver field over the step's region
// (strip.cuh's z_product) into the two product buffers, then one barrier;
// the strip walk keeps the exact body's register windows of both fields,
// and a Laplacian is the product plus the window's x taps (zb + accx, the
// sum and order of the JAX K-step kernels' use_mxu branch; strip.cuh's
// cell_lap). The same stage and padded rows as the x split.
#pragma once

#include "strip.cuh"

namespace pfdc {

// Owned shapes, the first that fits taken (strip_shape), and what the body
// stages: the four fields and the owned image; the split instances the
// two products too, on padded rows. kstep_gpu_bwd_mma takes shapes of its
// own: 32 x 96 first (215 KB at order 8, K = 4) ran 7 % faster than 32 x
// 64 on the Pluto grid, where the exact kstep_gpu_bwd ran 21 % slower
// (one block an SM instead of two; PERF.md).
constexpr StripShape kBwdShapes[] = {{32, 64}, {32, 32}, {16, 32}, {16, 16}};
constexpr StripShape kBwdZMmaShapes[] = {
    {32, 96}, {32, 64}, {32, 32}, {16, 32}, {16, 16}};
constexpr StripStage kBwdStage{4, true};
constexpr StripStage kBwdMmaStage{6, true, true};

// Steps k0 .. k0 + k_steps - 1 of the site's block, on its tile (blockDim.x
// = kStripThreads, a 1-D block), with the taps exact (P = 0) or the taps
// of axis A in P bf16 parts. Per step, from the state (ps, pps, pr, ppr)
// with pr tapered: the source s = (2ps - pps) + v*lap(ps), untapered, or
// the site's snapshot; the receiver u = (2pr - ppr*m) + v*lap(pr) plus
// the trace row; the image += s*u on the imaged cells; the next state (s,
// ps, u*m, pr).
template <int H, int P = 0, Split A = Split::kX, class Site>
__device__ __forceinline__ void bwd_strip(float* smem, const Site& site,
                                          const StripTile& t, int k0,
                                          int k_steps, const Coefs& c) {
  constexpr int S = kStripRows;
  // the rows' pitch: padded in the split instances (strip_pitch)
  const int pitch = P == 0 ? t.sz : strip_pitch(t.sz, kBwdMmaStage.padded);
  const int n = t.sx * pitch;
  float* s_cur = smem;
  float* s_old = smem + n;
  float* r_cur = smem + 2 * n;
  float* r_old = smem + 3 * n;
  float* simg = smem + 4 * n;   // t.tx x t.tz, the owned cells
  float* sxr = simg + t.tx * t.tz;
  float* xbs = sxr + t.sx;      // P > 0: the products of s_cur, r_cur
  float* xbr = xbs + n;
  const int tid = static_cast<int>(threadIdx.x);
  const int nth = static_cast<int>(blockDim.x);
  const int nxf = site.nxf, nzf = site.nzf;
  if constexpr (P == 0) {
    stage_strip_tile<4>({s_cur, s_old, r_cur, r_old},
                        {site.ps, site.pps, site.pr, site.ppr}, sxr,
                        site.xramp, t, nxf, nzf);
  } else {
    // x_product reads every staged cell: 0 where the site's buffers hold
    // no value (past what a first pass wrote), which only inexact cells
    // read in the exact body
    stage_strip_tile<4>({s_cur, s_old, r_cur, r_old},
                        {site.ps, site.pps, site.pr, site.ppr}, sxr,
                        site.xramp, t, nxf, nzf,
                        [&](int gx, int gz) { return site.held(gx, gz); },
                        pitch);
  }
  for (int i = tid; i < t.tx * t.tz; i += nth) {
    const int ox = i / t.tz, oz = i - ox * t.tz;
    simg[i] = site.image_start(t.gx0 + t.r + ox, t.gz0 + t.r + oz);
  }
  cp_async_wait_all();
  __syncthreads();
  // step 0's taper phase: the staged receiver field, every cell in the grid
  taper_strip_tile(r_cur, sxr, site.zfac, site.strip, t, nxf, nzf, pitch);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  const SplitBand<H, P> band =
      split_band<H, P>(A == Split::kX ? c.x : c.z, lane);
  for (int k = 0; k < k_steps; ++k) {
    const bool last = k + 1 == k_steps;
    const StripWalk<S> walk(t, (k + 1) * H);
    if constexpr (P > 0 && A == Split::kX) {
      if (!site.seeded(k0 + k)) {
        x_product<H, P>(xbs, s_cur, t, walk.lo, band, pitch, warp, nwarps,
                        lane);
      }
      x_product<H, P>(xbr, r_cur, t, walk.lo, band, pitch, warp, nwarps,
                      lane);
      __syncthreads();
    } else if constexpr (P > 0) {
      if (!site.seeded(k0 + k)) {
        z_product<H, P>(xbs, s_cur, t, walk.lo, band, pitch, warp, nwarps,
                        lane);
      }
      z_product<H, P>(xbr, r_cur, t, walk.lo, band, pitch, warp, nwarps,
                      lane);
      __syncthreads();
    }
    for (int item = warp; item < walk.items; item += nwarps) {
      int lx0, rows, lz, gz;
      if (!walk.strip(item, lane, t, nzf, lx0, rows, lz, gz)) continue;
      const float zf = site.zfac[gz];
      const bool ramp = site.strip[gz] != 0.0f;
      float w[2][S + 2 * H];     // the source's and the receiver's
      if constexpr (P == 0) {
        strip_windows<H>(w, {s_cur, r_cur}, t, lx0, rows, lz);
      } else if constexpr (A == Split::kZ) {
        strip_windows<H>(w, {s_cur, r_cur}, t, lx0, rows, lz, pitch);
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int lx = lx0 + i, gx = t.gx0 + lx;
        if (i >= rows || gx < 0 || gx >= nxf) continue;
        const int j = lx * pitch + lz;
        const bool interior = in_interior(gx, gz, H, nxf, nzf);
        const float v = site.v(gx, gz);
        float us;
        if (site.seeded(k0 + k)) {
          us = site.snapshot(k0 + k, gx, gz);
        } else {
          const float lap_s =
              interior ? cell_lap<H, P, A>(w[0], i, s_cur, xbs, j, c) : 0.0f;
          us = (2.0f * cell_centre<H, P, A>(w[0], i, s_cur, j) - s_old[j]) +
               v * lap_s;
        }
        const float m = strip_taper(sxr, lx, zf, ramp);
        const float lap_r =
            interior ? cell_lap<H, P, A>(w[1], i, r_cur, xbr, j, c) : 0.0f;
        float ur =
            (2.0f * cell_centre<H, P, A>(w[1], i, r_cur, j) - r_old[j] * m) +
            v * lap_r;
        ur = site.inject(k0 + k, gx, gz, ur);
        s_old[j] = us;
        r_old[j] = last ? ur : ur * m;
        const int ox = lx - t.r, oz = lz - t.r;
        if (ox >= 0 && ox < t.tx && oz >= 0 && oz < t.tz &&
            site.imaged(gx, gz)) {
          float& acc = simg[ox * t.tz + oz];
          acc = acc + us * ur;
        }
      }
    }
    __syncthreads();
    float* tmp = s_cur;
    s_cur = s_old;
    s_old = tmp;
    tmp = r_cur;
    r_cur = r_old;
    r_old = tmp;
  }
  for (int i = tid; i < t.tx * t.tz; i += nth) {
    const int ox = i / t.tz, oz = i - ox * t.tz;
    const int lx = t.r + ox, lz = t.r + oz;
    const int gx = t.gx0 + lx, gz = t.gz0 + lz;
    if (gx < 0 || gx >= nxf || gz < 0 || gz >= nzf || !site.stored(gx, gz)) {
      continue;
    }
    const int j = lx * pitch + lz;
    const size_t q = static_cast<size_t>(gx) * nzf + gz;
    site.ps_out[q] = s_cur[j];
    site.pps_out[q] = s_old[j];
    site.pr_out[q] = r_cur[j];
    site.ppr_out[q] = r_old[j];
    if (site.imaged(gx, gz)) site.image_end(gx, gz, simg[i]);
  }
}

}  // namespace pfdc
