// The exact backward body of the temporal-blocking kernels: K steps of
// the GPU suite's backward propagation and imaging (fd_back,
// cuda_reference_RTM/src/fd-code.cu:290-341) on one block's staged tile,
// shared by kstep_gpu_bwd (kstep_gpu_bwd.cu, the large-grid tier) and
// block_bwd / block2_bwd (domain_block.cuh, the domain tiers). Their split
// twins (P > 0) keep the staged-tile bodies of kstep.cuh and
// domain_block.cuh.
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
#pragma once

#include "strip.cuh"

namespace pfdc {

// Owned shapes, the first that fits taken (strip_shape), and what the body
// stages: the four fields and the owned image.
constexpr StripShape kBwdShapes[] = {{32, 64}, {32, 32}, {16, 32}, {16, 16}};
constexpr StripStage kBwdStage{4, true};

// Steps k0 .. k0 + k_steps - 1 of the site's block, on its tile (blockDim.x
// = kStripThreads, a 1-D block). Per step, from the state (ps, pps, pr, ppr)
// with pr tapered: the source s = (2ps - pps) + v*lap(ps), untapered, or
// the site's snapshot; the receiver u = (2pr - ppr*m) + v*lap(pr) plus the
// trace row; the image += s*u on the imaged cells; the next state (s, ps,
// u*m, pr).
template <int H, class Site>
__device__ __forceinline__ void bwd_strip(float* smem, const Site& site,
                                          const StripTile& t, int k0,
                                          int k_steps, const Coefs& c) {
  constexpr int S = kStripRows;
  const int n = t.sx * t.sz;
  float* s_cur = smem;
  float* s_old = smem + n;
  float* r_cur = smem + 2 * n;
  float* r_old = smem + 3 * n;
  float* simg = smem + 4 * n;   // t.tx x t.tz, the owned cells
  float* sxr = simg + t.tx * t.tz;
  const int tid = static_cast<int>(threadIdx.x);
  const int nth = static_cast<int>(blockDim.x);
  const int nxf = site.nxf, nzf = site.nzf;
  stage_strip_tile<4>({s_cur, s_old, r_cur, r_old},
                      {site.ps, site.pps, site.pr, site.ppr}, sxr,
                      site.xramp, t, nxf, nzf);
  for (int i = tid; i < t.tx * t.tz; i += nth) {
    const int ox = i / t.tz, oz = i - ox * t.tz;
    simg[i] = site.image_start(t.gx0 + t.r + ox, t.gz0 + t.r + oz);
  }
  cp_async_wait_all();
  __syncthreads();
  // step 0's taper phase: the staged receiver field, every cell in the grid
  taper_strip_tile(r_cur, sxr, site.zfac, site.strip, t, nxf, nzf);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  for (int k = 0; k < k_steps; ++k) {
    const bool last = k + 1 == k_steps;
    const StripWalk<S> walk(t, (k + 1) * H);
    for (int item = warp; item < walk.items; item += nwarps) {
      int lx0, rows, lz, gz;
      if (!walk.strip(item, lane, t, nzf, lx0, rows, lz, gz)) continue;
      const float zf = site.zfac[gz];
      const bool ramp = site.strip[gz] != 0.0f;
      float w[2][S + 2 * H];     // the source's and the receiver's
      strip_windows<H>(w, {s_cur, r_cur}, t, lx0, rows, lz);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int lx = lx0 + i, gx = t.gx0 + lx;
        if (i >= rows || gx < 0 || gx >= nxf) continue;
        const int j = lx * t.sz + lz;
        const bool interior = in_interior(gx, gz, H, nxf, nzf);
        const float v = site.v(gx, gz);
        float us;
        if (site.seeded(k0 + k)) {
          us = site.snapshot(k0 + k, gx, gz);
        } else {
          const float lap_s =
              interior ? strip_lap<H>(w[0], i, s_cur, j, c) : 0.0f;
          us = (2.0f * w[0][i + H] - s_old[j]) + v * lap_s;
        }
        const float m = strip_taper(sxr, lx, zf, ramp);
        const float lap_r =
            interior ? strip_lap<H>(w[1], i, r_cur, j, c) : 0.0f;
        float ur = (2.0f * w[1][i + H] - r_old[j] * m) + v * lap_r;
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
    const int j = lx * t.sz + lz;
    const size_t q = static_cast<size_t>(gx) * nzf + gz;
    site.ps_out[q] = s_cur[j];
    site.pps_out[q] = s_old[j];
    site.pr_out[q] = r_cur[j];
    site.ppr_out[q] = r_old[j];
    if (site.imaged(gx, gz)) site.image_end(gx, gz, simg[i]);
  }
}

}  // namespace pfdc
