// The exact forward body of the temporal-blocking kernels: K steps of one
// field's leapfrog on one block's staged tile, shared by the large-grid
// tier's kstep_mod (kstep_mod.cu, mod_main's modeling step) and
// kstep_gpu_fwd (kstep_gpu_fwd.cu, the GPU suite's fd_forward), and by the
// domain tiers' block_mod and block_fwd (domain_block.cuh: the same two
// states on a halo-extended slab or tile, in passes of at most 4 steps),
// and with the x taps in split bf16 (P > 0, below) by block_mod_mma /
// block2_mod_mma and block_fwd_mma / block2_fwd_mma, with the z taps in
// split bf16 by kstep_mod_mma and kstep_gpu_fwd_mma.
//
// What held the earlier bodies back on an H100 (PERF.md, kernel table,
// rows 11-12 and 15a-16b: 11-13x the bytes bound for the K-step kernels,
// 27-31x the operations bound for the block kernels): they staged p and pp
// (and for the K-step kernels v2*dt2) with dependent loads (74 KB at order
// 8, K = 4); a generic cell loop recomputed bounds for every cell; every
// cell-step read 4H + 1 taps from shared memory and rebuilt the taper from
// three global loads, twice; and each step took two barriers (an update
// phase, then a taper phase, or the other way round). The block kernels
// also took all K = 8 steps in one pass on 32 x 64 owned cells, whose
// 32-cell halo at order 8 made each block compute 2.9x its owned cells.
//
// This body (on the strip pieces of strip.cuh, as bwd_strip.cuh's):
// - stages only the field at its two time levels, the current one whose
//   taps are read and the older one read at its own cell, with cp.async,
//   plus the taper's x ramp along the tile's rows: 74.1 KB for 64 x 64
//   owned cells at order 8, K = 4, which compute 1.43x the owned cells
//   over four steps where 32 x 64 compute 1.67x. v2*dt2 is read from
//   global memory at the cell's own position (for modeling one plane that
//   all shots share, an L2 hit) and the taper's z factor and strip flag
//   stay in registers;
// - gives each thread a strip of kStripRows cells down one column, its x
//   taps from a register window, the strips laid anew over each step's
//   shrinking region; two blocks of 16 warps share an SM, with 64
//   registers a thread and no spill at order 8;
// - takes one barrier a step: a step writes only the older time level, at
//   its own cells, and reads the current one. The taper goes where a value
//   is written or read at its own cell, never in place while neighbours
//   still read it:
//   - kstep_gpu_fwd and block_fwd (state (p, pp), p tapered, pp not): a
//     phase of its own behind a barrier tapers the staged newest field t
//     before step 0; each step computes u = (2t - o*m) + v*lap(t) from the
//     older field o, adds the point source, and stores u*m as the next
//     step's t (u after the last step, the output's pp);
//   - kstep_mod and block_mod (state (p, pp), pp tapered): each step
//     computes u = (2p - o) + v*lap(p) with o the older field as staged at
//     step 0 and o*m after it, adds amp * patch in the source window (the
//     source rows on the block kernels), stores u*m, and leaves p
//     untapered in its slot: the old body's phase that tapered p in place
//     once every neighbour had read it is the o*m of the next step's read,
//     and of the final store of pp. The trace row is the owning thread's
//     p*m.
//   One multiplication by the same m rounds the same, whenever it is done.
//   Both states compose across passes: a pass leaves pp tapered (mod) or
//   p tapered and pp not (fwd), as its next pass stages them.
//
// Exactness. Per cell and step the operations and their order are the
// earlier body's (mod_step's and rtm_fwd_step's): the taps summed as
// stencil.cuh's laplacian does, the update, the source, the taper. Built
// with -fmad=false, so the kernels stay bitwise equal to their plain
// versions; outputs go to buffers no block of the launch reads.
//
// The site. A kernel hands the body a Site: the flavour (kGpu: the
// kstep_gpu_fwd state above, else kstep_mod's), one shot's field pointers
// in the (nxf, nzf) layout (cur the newest level, old the older one, and
// the outputs of each), the taper's ramps, v2*dt2 at a cell, the source's
// injection, the trace row, if any, and which owned cells of the tile are
// stored (all of them on the K-step kernels' grid; on a block kernel's
// tile the pass's output rectangle, not its halo).
//
// The split x taps (P = 2 or 3 bf16 parts: lap_impl "mxu", "mxu6"; the block
// kernels' states, block_mod_mma's and block_fwd_mma's). Each step first takes
// the x taps of the newest field t over the step's region as the banded product
// on the tensor cores (strip.cuh's x_product) into one more staged buffer, then
// a barrier: an mma hands an output to another lane than the strip's cell
// thread. The strip walk then adds the exact z taps to the product at the cell
// (xb + accz, the order of the JAX block kernels' use_mxu branch and of the
// staged-tile bodies this replaces), and keeps everything else of the exact
// step of its state: the initial taper of t (kGpu only: the mod state stages p
// tapered, and a second multiplication by m would round otherwise), the older
// field's taper where it is read, the source, the trace, the taper where a
// value is written. No register window is loaded: the x taps are the product's.
// Two barriers a step (the product's, the step's); the product is written only
// after the end-of-step barrier that follows every read of the last one. What
// the split body stages: the field at two levels and the product, on rows
// padded to 4 mod 8 floats (strip_pitch: the product's fragment reads and
// stores without bank conflicts), and the x ramp. A second pass's buffers may
// hold no value past what the first wrote: the split instances stage 0 there
// (the site's held()), since the product multiplies every value it reads.
//
// The split z taps (Split::kZ, kstep_mod_mma and kstep_gpu_fwd_mma: the JAX
// K-step kernels split the z taps and keep the x taps exact). Each step takes
// the z product of t over the step's region (strip.cuh's z_product) into the
// product buffer, then a barrier; the strip walk keeps the exact body's
// register window of t, loaded at the padded pitch, and a Laplacian is the
// product plus the window's x taps (zb + accx, the JAX kernels' order), its
// centre the window's. The same stage and padded rows as the x split; a
// K-step pass stages whole fields, so its sites hold every cell.
#pragma once

#include "strip.cuh"

namespace pfdc {

// Owned shapes, the first that fits taken (strip_shape), and what the body
// stages: the field at two time levels. The K-step kernels take
// kFwdShapes; the block kernels kBlockFwdShapes, whose 64 x 96 first shape
// measured 10 % faster than 64 x 64 on the domain tiers' Pluto slabs and
// tiles (PERF.md).
constexpr StripShape kFwdShapes[] = {
    {64, 64}, {32, 64}, {32, 32}, {16, 32}, {16, 16}};
constexpr StripShape kBlockFwdShapes[] = {
    {64, 96}, {64, 64}, {32, 64}, {32, 32}, {16, 32}, {16, 16}};
constexpr StripStage kFwdStage{2, false};
// The split instances stage the product too, on padded rows, and take
// kFwdShapes: 64 x 64 first (115.6 KB at order 8 and a pass of 4 steps,
// two blocks an SM) ran 11 % faster than 64 x 96 (one block an SM) and 17
// % faster than 32 x 64 for block_fwd_mma on the domain tiers' Pluto slabs
// and tiles; 48 x 64, 32 x 96 and 64 x 96 ran 8-17 % slower for
// kstep_mod_mma and kstep_gpu_fwd_mma on the Pluto grid (PERF.md).
constexpr StripStage kFwdMmaStage{3, false, true};

// The k_steps steps of the site's block on its tile (blockDim.x =
// kStripThreads, a 1-D block), amps.a[k] the source amplitude of step k
// (of the pass: a block kernel's second pass gets the block's amplitudes
// from its first step on, and its site records step k as k0 + k), with
// the taps exact (P = 0) or the taps of axis A in P bf16 parts.
template <int H, int P = 0, Split A = Split::kX, class Site>
__device__ __forceinline__ void fwd_strip(float* smem, const Site& site,
                                          const StripTile& t,
                                          const Amps& amps, int k_steps,
                                          const Coefs& c) {
  constexpr int S = kStripRows;
  // the rows' pitch: padded in the split instances (strip_pitch)
  const int pitch =
      P == 0 ? t.sz : strip_pitch(t.sz, kFwdMmaStage.padded);
  const int n = t.sx * pitch;
  float* cur = smem;         // the newest level, whose taps a step reads
  float* old = smem + n;     // the older level, read at its own cell
  float* sxr = smem + 2 * n;
  float* xb = sxr + t.sx;    // P > 0: the product of cur
  const int nxf = site.nxf, nzf = site.nzf;
  const int tid = static_cast<int>(threadIdx.x);
  const int nth = static_cast<int>(blockDim.x);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
  if constexpr (P == 0) {
    stage_strip_tile<2>({cur, old}, {site.cur, site.old}, sxr, site.xramp,
                        t, nxf, nzf);
  } else {
    // the product reads every staged cell: 0 where the site's buffers
    // hold no value (past what a first pass wrote)
    stage_strip_tile<2>({cur, old}, {site.cur, site.old}, sxr, site.xramp,
                        t, nxf, nzf,
                        [&](int gx, int gz) { return site.held(gx, gz); },
                        pitch);
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (Site::kGpu && P > 0) {
    taper_strip_tile(cur, sxr, site.zfac, site.strip, t, nxf, nzf, pitch);
  } else if constexpr (Site::kGpu) {
    taper_strip_tile(cur, sxr, site.zfac, site.strip, t, nxf, nzf);
  }
  const SplitBand<H, P> band =
      split_band<H, P>(A == Split::kX ? c.x : c.z, lane);
  for (int k = 0; k < k_steps; ++k) {
    const float amp = amps.a[k];
    const bool last = k + 1 == k_steps;
    const bool old_tapered = !Site::kGpu && k == 0;
    const StripWalk<S> walk(t, (k + 1) * H);
    if constexpr (P > 0 && A == Split::kX) {
      x_product<H, P>(xb, cur, t, walk.lo, band, pitch, warp, nwarps, lane);
      __syncthreads();
    } else if constexpr (P > 0) {
      z_product<H, P>(xb, cur, t, walk.lo, band, pitch, warp, nwarps, lane);
      __syncthreads();
    }
    for (int item = warp; item < walk.items; item += nwarps) {
      int lx0, rows, lz, gz;
      if (!walk.strip(item, lane, t, nzf, lx0, rows, lz, gz)) continue;
      const float zf = site.zfac[gz];
      const bool ramp = site.strip[gz] != 0.0f;
      float w[1][S + 2 * H];
      if constexpr (P == 0) {
        strip_windows<H>(w, {cur}, t, lx0, rows, lz);
      } else if constexpr (A == Split::kZ) {
        strip_windows<H>(w, {cur}, t, lx0, rows, lz, pitch);
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int lx = lx0 + i, gx = t.gx0 + lx;
        if (i >= rows || gx < 0 || gx >= nxf) continue;
        const int j = lx * pitch + lz;
        const float m = strip_taper(sxr, lx, zf, ramp);
        const float lap = in_interior(gx, gz, H, nxf, nzf)
                              ? cell_lap<H, P, A>(w[0], i, cur, xb, j, c)
                              : 0.0f;
        const float centre = cell_centre<H, P, A>(w[0], i, cur, j);
        const float o = old_tapered ? old[j] : old[j] * m;
        float u = (2.0f * centre - o) + site.v(gx, gz) * lap;
        u = site.inject(amp, gx, gz, u);
        old[j] = Site::kGpu && last ? u : u * m;
        const int ox = lx - t.r, oz = lz - t.r;
        if (site.records(gx, gz) && ox >= 0 && ox < t.tx && oz >= 0 &&
            oz < t.tz) {
          site.record(k, gx, centre * m);
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = old;
    old = tmp;
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
    site.cur_out[q] = cur[j];
    site.old_out[q] =
        Site::kGpu ? old[j]
                   : old[j] * strip_taper(sxr, lx, site.zfac[gz],
                                          site.strip[gz] != 0.0f);
  }
}

}  // namespace pfdc
