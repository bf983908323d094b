// The domain tiers' block kernels, shared by the x tier (domain_block.cu)
// and the (x, z) tier (domain2d_block.cu): block_mod, block_fwd and
// block_bwd, each K time steps on one halo-extended tile of the grid for
// every shot of a batch, and their launchers.
//
// The tile. The extended grid is cut into n_x x n_z tiles of nxl x nzl
// owned cells; a tile's buffers also hold hs rows of halo on each x side
// and hz columns on each z side, exchanged by the caller once per block
// ((ns, nxw, nzw) buffers, nxw = nxl + 2*hs, nzw = nzl + 2*hz, z
// contiguous). An x-slab is the tile with hz = 0 and nzl = nze. An axis cut
// in one part carries no halo (hs or hz = 0): its tile edge is the grid's.
// The exact region shrinks by h a step from every edge that has a halo,
// so after k steps, k*h <= the halo, the owned cells are exact
// (communication-avoiding blocking). A block of threads owns a shape of
// cells of one shot (strip.cuh's StripShape) and stages its part of the
// tile with a k*h halo on both axes in shared memory, as the K-step
// kernels do (strip.cuh): a
// Pluto tile is thousands of rows of hundreds of floats, far beyond an
// SM. The Laplacian is zero on the tile's border (in_interior over the
// tile), and the global interior is folded into v2m = v2*dt2 (0 outside
// it), so a zero halo at the grid's edge reproduces the unsharded grid.
//
// Operands made once a run per tile by the wrapper: v2m (per shot, or one
// plane for all), the taper's 1-D ramps cut to the tile (0 beyond the
// grid; taper_at rebuilds the mask bitwise inside the grid), the source
// rows at the tile-local depth src_z around it (the Gaussian patch's rows,
// or a one-hot row), and for block_bwd the time-reversed trace rows (nt,
// nxw) of each shot. Acquisition depths are tile-local rows: a source or
// trace row is injected on every tile whose buffer holds it (its halo
// included), so that the halo evolves as the neighbour's own cells; a
// trace is recorded by the tile that owns the row only; -1 is a row that
// no cell matches. v2m is read from global memory at the cell's own
// position only, so it is not staged.
//
// What bounds it on an H100: per block the pass reads the staged fields
// and v2m once and writes the owned cells once; what is left is shared-
// memory and ALU work on the staged tile, whose halo cells are computed
// redundantly. The exact kernels run the register-strip bodies shared
// with the large-grid tier's K-step kernels: block_mod and block_fwd the
// one-field body of fwd_strip.cuh (kstep_mod's and kstep_gpu_fwd's, on 64
// x 96 owned cells, kBlockFwdShapes: over the four kernels on the Pluto
// slabs and tiles faster than 64 x 64, 64 x 112, 48 x 96, 32 x 128 and
// 64 x 128, though 64 x 112 is 2-3 % faster on the tiles alone; PERF.md),
// block_bwd the body of bwd_strip.cuh (kstep_gpu_bwd's; 32 x 64 owned cells, 32
// x 32 at order 10), and so do block_mod_mma, block_fwd_mma and block_bwd_mma,
// with the x taps split (below). Each takes the K steps of a block in passes of
// at most kBlockPassSteps (below), so that the staged halo stays that deep: at
// order 8, K = 8, two passes of 4 on 64 x 96 owned cells compute 1.35x the
// owned cells each, where the earlier forward body's one pass of 8 on 32 x 64
// computed 2.9x.
//
// Per step the operations, their order and rounding are the plain block
// functions' (parallel/domain_kernels.py) and the TPU kernels', outputs to
// buffers no block of the launch reads: the strip bodies put the taper where a
// value is written or read at its own cell (fwd_strip.cuh says why that rounds
// the same). block_bwd sums the image delta of the block from 0 in shared
// memory and adds it to the running image once, as the JAX package does
// (domain_pallas.py:161, :178, :492). Offsets into trace rows and seismograms
// are size_t.
//
// The split x taps (lap_impl "mxu", "mxu6"): P = 2 (3) is the *_mma twin
// of a kernel (block_mod_mma, ...), which takes the x taps as the 3-pass
// (6-pass) split-bf16 banded product on the tensor cores (mma_bf16.cuh;
// strip.cuh's x_product contracts down the staged tile's rows, A[m][k] a
// column of it) and the z taps exact, yx + accz, as the JAX block kernels'
// use_mxu branch does (_make_lap's MXU branch, ops/pallas_fd.py:312-332,
// through _lap_and_refs, domain_pallas.py:106-112). An mma output lands in
// another lane than the cell's thread, so the product goes into a staged
// buffer behind a barrier, and the cell's own thread then adds the exact z
// taps: the update, taper, injection, trace and image keep their threads
// and order. block_bwd_mma runs the backward strip body's split instances
// (bwd_strip.cuh: both fields' products into two buffers, one barrier,
// then the strip walk; block_bwd's shapes, 32 x 64 owned cells first) in
// the passes of block_bwd, so that a pass of 4 steps at order 8 computes
// 1.67x its owned cells, where the earlier staged-tile body's one pass of
// 8 on 16 x 32 computed 5.8x. block_mod_mma and block_fwd_mma run the
// forward strip body's split instances (fwd_strip.cuh: the newest field's
// product into one buffer, one barrier, then the strip walk; kFwdShapes,
// 64 x 64 first) in the passes of block_mod and block_fwd, where the
// staged-tile bodies they replace took all K steps in one pass on 32 x 64
// owned cells (2.9x the owned cells computed at order 8, K = 8). The TPU
// kernels' lane pad to a multiple of 128 (nxww, domain_pallas.py:252) is
// layout, with zero lanes: here a window past the tile reads 0, and every
// staged cell is finite (a second pass stages 0 past what the first
// wrote). What bounds the twins: the exact kernels' bytes; what they add is
// shared-memory and issue work (the split of every value a window reads,
// the staged product, one more barrier a step), not tensor-core time.
//
// The kernels sit in an anonymous namespace: each source that includes
// this header builds its own instances.
#pragma once

#include "bwd_strip.cuh"
#include "fwd_strip.cuh"
#include "kstep.cuh"

namespace {

// A tile's owned size and halos. kZ: an (x, z) tile, with a z halo and z
// extent of its own; false: an x-slab (no z halo, nzl = nze), whose z
// terms fold away at compile time: left to run time they cost the x
// tier's block_mod ~5 % (PERF.md).
template <bool kZ>
struct Dims {
  int hs, nxl, hz_, nzl;
  __host__ __device__ int hz() const { return kZ ? hz_ : 0; }
  __host__ __device__ int nxw() const { return nxl + 2 * hs; }
  __host__ __device__ int nzw() const { return nzl + 2 * hz(); }
  __host__ __device__ size_t plane() const {
    return static_cast<size_t>(nxw()) * nzw();
  }
  // k steps fit the halos of the axes that have one
  __host__ __device__ bool fits(int halo) const {
    return (hs == 0 || halo <= hs) && (hz() == 0 || halo <= hz());
  }
  // tile cell (gx, gz), gx past the x halo and gz past the z halo, is
  // owned
  __host__ __device__ bool owns(int gx, int gz) const {
    return gx < hs + nxl && (!kZ || gz < hz_ + nzl);
  }
};

// The kernels on strip bodies (the exact ones and their split twins) take
// the K steps of a block in passes of at most kBlockPassSteps, so that the
// staged halo stays that many steps deep (K = 8 at order 8: two passes of 4, a
// 16-cell halo, two blocks an SM, where one pass of 8 staged a 32-cell halo,
// one block an SM, and computed 1.9x the owned cells of block_mod's 64 x 96,
// 2.9x of block_bwd's 32 x 64; on the card one pass was 1.5x slower for
// block_mod on 64 x 64 and 1.8x for block_bwd, PERF.md). Above it a block takes
// two passes, of (K + 1) / 2 and K / 2 steps: the first writes its fields into
// scratch buffers over the owned cells and the margin that the second stages
// (K/2 * h rows where the tile has an x halo, as many columns where it has a z
// halo), and block_bwd's image delta, from 0, into a scratch image; the second
// reads them and writes the outputs, block_bwd summing on from the delta and
// adding it to the running image once, so the sums are the one-pass body's. The
// forward states compose across the passes as fwd_strip.cuh says.
constexpr int kBlockPassSteps = 4;

// One pass of a block kernel on a strip body: steps k0 .. k0 + k_steps - 1
// of the block, the margin (ex, ez) around the owned cells that it writes
// too, and for block_bwd where the image sum starts (nullptr: from 0) and
// ends (added to img_end, or stored).
struct BlockPass {
  int k0, k_steps, ex, ez;
  const float* img_start;
  float* img_end;
  bool add;
};

// The passes of a block of k steps on the tile d, h the half order:
// n = 1, first all k steps; or n = 2, first (k + 1) / 2 steps and the
// margin the second stages, second the rest. The image members are
// block_bwd's to set.
template <bool kZ>
struct BlockPasses {
  int n;
  BlockPass first, second;

  BlockPasses(const Dims<kZ>& d, int k, int h) {
    const int k1 = k <= kBlockPassSteps ? k : (k + 1) / 2, k2 = k - k1;
    n = k2 ? 2 : 1;
    first = {0, k1, d.hs ? k2 * h : 0, d.hz() ? k2 * h : 0, nullptr, nullptr,
             false};
    second = {k1, k2, 0, 0, nullptr, nullptr, false};
  }
};

// The amplitudes of steps k0 .. of a block: a later pass's.
inline pfdc::Amps amps_from(const pfdc::Amps& amps, int k0) {
  pfdc::Amps a{};
  for (int i = k0; i < pfdc::kMaxSteps; ++i) a.a[i - k0] = amps.a[i];
  return a;
}

// The block's staged tile in a pass: owned shape s from the pass's output
// rectangle, the owned cells and the margin (ex, ez).
template <bool kZ>
__device__ pfdc::StripTile pass_tile(int halo, pfdc::StripShape s,
                                     const BlockPass& pass,
                                     const Dims<kZ>& d) {
  return pfdc::StripTile(
      halo, s, d.hs - pass.ex + static_cast<int>(blockIdx.y) * s.tx,
      d.hz() - pass.ez + static_cast<int>(blockIdx.x) * s.tz);
}

// Tile cell (gx, gz) lies in the owned cells widened by mx rows and (on an
// (x, z) tile) mz columns on each side.
template <bool kZ>
__device__ bool in_rect(const Dims<kZ>& d, int gx, int gz, int mx, int mz) {
  return gx >= d.hs - mx && gx < d.hs + d.nxl + mx &&
         (!kZ || (gz >= d.hz() - mz && gz < d.hz() + d.nzl + mz));
}

// block_mod's site (fwd_strip.cuh, kstep_mod's state): one shot's tile
// buffers, (nxw, nzw), p the newest level and pp the older; the source
// rows (2r + 1 of the tile's x range, at depths src_z - r .. src_z + r)
// added on every cell of the buffer that holds them, halo included, so
// that the halo evolves as the neighbour's own cells; the trace row gz_rec
// recorded on the owned cells only (a first pass also computes the
// margin), as step k0 + k of the block (rec: the shot's (K, nxl) traces);
// the pass's output rectangle stored.
template <bool kZ>
struct BlockModSite {
  static constexpr bool kGpu = false;
  const float* cur;
  const float* old;
  float* cur_out;
  float* old_out;
  const float* v2m;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* src;
  float* rec;
  int r, src_z, gz_rec, k0, nxf, nzf, ex, ez;
  Dims<kZ> d;

  __device__ float v(int gx, int gz) const {
    return __ldg(v2m + static_cast<size_t>(gx) * nzf + gz);
  }
  __device__ float inject(float amp, int gx, int gz, float u) const {
    const int dz = gz - src_z;
    return dz >= -r && dz <= r
               ? u + amp * src[static_cast<size_t>(dz + r) * nxf + gx]
               : u;
  }
  __device__ bool records(int gx, int gz) const {
    return gz == gz_rec && in_rect(d, gx, gz, 0, 0);
  }
  __device__ void record(int k, int gx, float q) const {
    rec[static_cast<size_t>(k0 + k) * d.nxl + (gx - d.hs)] = q;
  }
  __device__ bool stored(int gx, int gz) const {
    return in_rect(d, gx, gz, ex, ez);
  }
};

// block_fwd's site (fwd_strip.cuh, kstep_gpu_fwd's state): one shot's tile
// buffers, pp the newest level and p the older; the source row src_z (-1:
// none in the buffer) added on every cell of it; no trace; the pass's
// output rectangle stored.
template <bool kZ>
struct BlockFwdSite {
  static constexpr bool kGpu = true;
  const float* cur;
  const float* old;
  float* cur_out;
  float* old_out;
  const float* v2m;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* src;
  int src_z, nxf, nzf, ex, ez;
  Dims<kZ> d;

  __device__ float v(int gx, int gz) const {
    return __ldg(v2m + static_cast<size_t>(gx) * nzf + gz);
  }
  __device__ float inject(float amp, int gx, int gz, float u) const {
    return gz == src_z ? u + amp * src[gx] : u;
  }
  __device__ bool records(int, int) const { return false; }
  __device__ void record(int, int, float) const {}
  __device__ bool stored(int gx, int gz) const {
    return in_rect(d, gx, gz, ex, ez);
  }
};

// A split twin's site on the forward strip body (block_mod_mma's,
// block_fwd_mma's): the exact kernel's, whose buffers, in a second pass,
// hold values on the rectangle the first wrote only, the owned cells and
// the margin (ix, iz).
template <class Site>
struct HeldSite : Site {
  int ix, iz;

  __device__ bool held(int gx, int gz) const {
    return in_rect(this->d, gx, gz, ix, iz);
  }
};

// One pass of block_mod (P = 0) or block_mod_mma (P = 2, 3) on the
// forward strip body: amps holds the pass's amplitudes from its first
// step, k_steps is the block's (the traces' shot stride).
template <int H, bool kZ, int P>
__device__ __forceinline__ void block_mod_pass(
    float* smem, const float* __restrict__ p_in,
    const float* __restrict__ pp_in, float* __restrict__ p_out,
    float* __restrict__ pp_out, const float* __restrict__ v2m,
    int v2_shot_stride, const float* __restrict__ xramp,
    const float* __restrict__ zfac, const float* __restrict__ strip,
    const float* __restrict__ src, int r, int src_z, const pfdc::Amps& amps,
    int k_steps, float* __restrict__ rec, int gz_rec, const Dims<kZ>& d,
    pfdc::StripShape shape, const BlockPass& pass, const pfdc::Coefs& c) {
  const int s = blockIdx.z;
  const size_t plane = d.plane();
  const int nxw = d.nxw();
  const BlockModSite<kZ> site{
      p_in + s * plane, pp_in + s * plane, p_out + s * plane,
      pp_out + s * plane, v2m + s * static_cast<size_t>(v2_shot_stride),
      xramp, zfac, strip, src + s * static_cast<size_t>(2 * r + 1) * nxw,
      rec + s * static_cast<size_t>(k_steps) * d.nxl, r, src_z, gz_rec,
      pass.k0, nxw, d.nzw(), pass.ex, pass.ez, d};
  const pfdc::StripTile t = pass_tile(pass.k_steps * H, shape, pass, d);
  if constexpr (P == 0) {
    pfdc::fwd_strip<H>(smem, site, t, amps, pass.k_steps, c);
  } else {
    // the input: the whole buffer, or what a first pass wrote
    const HeldSite<BlockModSite<kZ>> split{
        site, pass.k0 ? (d.hs ? pass.k_steps * H : 0) : d.hs,
        pass.k0 ? (d.hz() ? pass.k_steps * H : 0) : d.hz()};
    pfdc::fwd_strip<H, P>(smem, split, t, amps, pass.k_steps, c);
  }
}

template <int H, bool kZ>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    block_mod(const float* __restrict__ p_in,
              const float* __restrict__ pp_in, float* __restrict__ p_out,
              float* __restrict__ pp_out, const float* __restrict__ v2m,
              int v2_shot_stride, const float* __restrict__ xramp,
              const float* __restrict__ zfac,
              const float* __restrict__ strip,
              const float* __restrict__ src, int r, int src_z,
              pfdc::Amps amps, int k_steps, float* __restrict__ rec,
              int gz_rec, Dims<kZ> d, pfdc::StripShape shape,
              BlockPass pass, pfdc::Coefs c) {
  extern __shared__ float smem[];
  block_mod_pass<H, kZ, 0>(smem, p_in, pp_in, p_out, pp_out, v2m,
                           v2_shot_stride, xramp, zfac, strip, src, r, src_z,
                           amps, k_steps, rec, gz_rec, d, shape, pass, c);
}

// The split twin (P = 2, 3): the same pass with the x taps in bf16 parts.
template <int H, bool kZ, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    block_mod_mma(const float* __restrict__ p_in,
                  const float* __restrict__ pp_in, float* __restrict__ p_out,
                  float* __restrict__ pp_out, const float* __restrict__ v2m,
                  int v2_shot_stride, const float* __restrict__ xramp,
                  const float* __restrict__ zfac,
                  const float* __restrict__ strip,
                  const float* __restrict__ src, int r, int src_z,
                  pfdc::Amps amps, int k_steps, float* __restrict__ rec,
                  int gz_rec, Dims<kZ> d, pfdc::StripShape shape,
                  BlockPass pass, pfdc::Coefs c) {
  static_assert(P > 0, "block_mod is the exact kernel");
  extern __shared__ float smem[];
  block_mod_pass<H, kZ, P>(smem, p_in, pp_in, p_out, pp_out, v2m,
                           v2_shot_stride, xramp, zfac, strip, src, r, src_z,
                           amps, k_steps, rec, gz_rec, d, shape, pass, c);
}

// The modeling kernel of a pass at P.
template <int H, bool kZ, int P>
auto mod_kernel() {
  if constexpr (P == 0) {
    return block_mod<H, kZ>;
  } else {
    return block_mod_mma<H, kZ, P>;
  }
}

// One pass of block_fwd (P = 0) or block_fwd_mma (P = 2, 3) on the
// forward strip body: amps holds the pass's amplitudes.
template <int H, bool kZ, int P>
__device__ __forceinline__ void block_fwd_pass(
    float* smem, const float* __restrict__ p_in,
    const float* __restrict__ pp_in, float* __restrict__ p_out,
    float* __restrict__ pp_out, const float* __restrict__ v2m,
    int v2_shot_stride, const float* __restrict__ xramp,
    const float* __restrict__ zfac, const float* __restrict__ strip,
    const float* __restrict__ src, int src_z, const pfdc::Amps& amps,
    const Dims<kZ>& d, pfdc::StripShape shape, const BlockPass& pass,
    const pfdc::Coefs& c) {
  const int s = blockIdx.z;
  const size_t plane = d.plane();
  const int nxw = d.nxw();
  const BlockFwdSite<kZ> site{
      pp_in + s * plane, p_in + s * plane, pp_out + s * plane,
      p_out + s * plane, v2m + s * static_cast<size_t>(v2_shot_stride),
      xramp, zfac, strip, src + s * static_cast<size_t>(nxw), src_z, nxw,
      d.nzw(), pass.ex, pass.ez, d};
  const pfdc::StripTile t = pass_tile(pass.k_steps * H, shape, pass, d);
  if constexpr (P == 0) {
    pfdc::fwd_strip<H>(smem, site, t, amps, pass.k_steps, c);
  } else {
    // the input: the whole buffer, or what a first pass wrote
    const HeldSite<BlockFwdSite<kZ>> split{
        site, pass.k0 ? (d.hs ? pass.k_steps * H : 0) : d.hs,
        pass.k0 ? (d.hz() ? pass.k_steps * H : 0) : d.hz()};
    pfdc::fwd_strip<H, P>(smem, split, t, amps, pass.k_steps, c);
  }
}

template <int H, bool kZ>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    block_fwd(const float* __restrict__ p_in,
              const float* __restrict__ pp_in, float* __restrict__ p_out,
              float* __restrict__ pp_out, const float* __restrict__ v2m,
              int v2_shot_stride, const float* __restrict__ xramp,
              const float* __restrict__ zfac,
              const float* __restrict__ strip,
              const float* __restrict__ src, int src_z, pfdc::Amps amps,
              Dims<kZ> d, pfdc::StripShape shape, BlockPass pass,
              pfdc::Coefs c) {
  extern __shared__ float smem[];
  block_fwd_pass<H, kZ, 0>(smem, p_in, pp_in, p_out, pp_out, v2m,
                           v2_shot_stride, xramp, zfac, strip, src, src_z,
                           amps, d, shape, pass, c);
}

// The split twin (P = 2, 3): the same pass with the x taps in bf16 parts.
template <int H, bool kZ, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    block_fwd_mma(const float* __restrict__ p_in,
                  const float* __restrict__ pp_in, float* __restrict__ p_out,
                  float* __restrict__ pp_out, const float* __restrict__ v2m,
                  int v2_shot_stride, const float* __restrict__ xramp,
                  const float* __restrict__ zfac,
                  const float* __restrict__ strip,
                  const float* __restrict__ src, int src_z, pfdc::Amps amps,
                  Dims<kZ> d, pfdc::StripShape shape, BlockPass pass,
                  pfdc::Coefs c) {
  static_assert(P > 0, "block_fwd is the exact kernel");
  extern __shared__ float smem[];
  block_fwd_pass<H, kZ, P>(smem, p_in, pp_in, p_out, pp_out, v2m,
                           v2_shot_stride, xramp, zfac, strip, src, src_z,
                           amps, d, shape, pass, c);
}

// The forward kernel of a pass at P.
template <int H, bool kZ, int P>
auto fwd_kernel() {
  if constexpr (P == 0) {
    return block_fwd<H, kZ>;
  } else {
    return block_fwd_mma<H, kZ, P>;
  }
}

// block_bwd's site (bwd_strip.cuh): one shot's tile buffers, (nxw, nzw);
// the pass's output rectangle, the owned cells and its margin; the image
// delta summed on the owned cells; the snapshots seed steps 0 and 1 of the
// first block; the trace row is injected on every cell of row gz_rec. A
// second pass's buffers hold values on the rectangle the first wrote only,
// the owned cells and the margin (ix, iz).
template <bool kZ>
struct BlockBwdSite {
  const float* ps;
  const float* pps;
  const float* pr;
  const float* ppr;
  float* ps_out;
  float* pps_out;
  float* pr_out;
  float* ppr_out;
  const float* snap0;
  const float* snap1;
  const float* img_start;
  float* img_end;
  bool add;
  const float* v2m;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* inj;
  int gz_rec, nxf, nzf, ex, ez, ix, iz;
  Dims<kZ> d;

  __device__ float v(int gx, int gz) const {
    return __ldg(v2m + static_cast<size_t>(gx) * nzf + gz);
  }
  __device__ bool held(int gx, int gz) const {
    return in_rect(d, gx, gz, ix, iz);
  }
  __device__ bool seeded(int k) const { return snap0 != nullptr && k < 2; }
  __device__ float snapshot(int k, int gx, int gz) const {
    return (k == 0 ? snap1 : snap0)[static_cast<size_t>(gx) * nzf + gz];
  }
  __device__ float inject(int k, int gx, int gz, float u) const {
    return gz == gz_rec ? u + inj[static_cast<size_t>(k) * nxf + gx] : u;
  }
  __device__ bool imaged(int gx, int gz) const {
    return in_rect(d, gx, gz, 0, 0);
  }
  __device__ bool stored(int gx, int gz) const {
    return in_rect(d, gx, gz, ex, ez);
  }
  __device__ size_t image_index(int gx, int gz) const {
    return static_cast<size_t>(gx - d.hs) * d.nzl + (gz - d.hz());
  }
  __device__ float image_start(int gx, int gz) const {
    return img_start && imaged(gx, gz) ? img_start[image_index(gx, gz)]
                                       : 0.0f;
  }
  __device__ void image_end(int gx, int gz, float acc) const {
    float& out = img_end[image_index(gx, gz)];
    out = add ? out + acc : acc;
  }
};

// One pass of block_bwd (P = 0) or block_bwd_mma (P = 2, 3) on the
// backward strip body.
template <int H, bool kZ, int P>
__device__ __forceinline__ void block_bwd_pass(
    float* smem, const float* __restrict__ ps_in,
    const float* __restrict__ pps_in, const float* __restrict__ pr_in,
    const float* __restrict__ ppr_in, float* __restrict__ ps_out,
    float* __restrict__ pps_out, float* __restrict__ pr_out,
    float* __restrict__ ppr_out, const float* __restrict__ snap0,
    const float* __restrict__ snap1, const float* __restrict__ v2m,
    int v2_shot_stride, const float* __restrict__ xramp,
    const float* __restrict__ zfac, const float* __restrict__ strip,
    const float* __restrict__ inj, int inj_shot_stride, int gz_rec,
    const Dims<kZ>& d, pfdc::StripShape shape, const BlockPass& pass,
    const pfdc::Coefs& c) {
  const int s = blockIdx.z;
  const size_t plane = d.plane();
  const size_t image = static_cast<size_t>(d.nxl) * d.nzl;
  const bool seed = snap0 != nullptr;
  const BlockBwdSite<kZ> site{
      ps_in + s * plane,  pps_in + s * plane, pr_in + s * plane,
      ppr_in + s * plane, ps_out + s * plane, pps_out + s * plane,
      pr_out + s * plane, ppr_out + s * plane,
      seed ? snap0 + s * plane : nullptr, seed ? snap1 + s * plane : nullptr,
      pass.img_start ? pass.img_start + s * image : nullptr,
      pass.img_end + s * image, pass.add,
      v2m + s * static_cast<size_t>(v2_shot_stride), xramp, zfac, strip,
      inj + s * static_cast<size_t>(inj_shot_stride), gz_rec, d.nxw(),
      d.nzw(), pass.ex, pass.ez,
      // the input: the whole buffer, or what a first pass wrote
      pass.k0 ? (d.hs ? pass.k_steps * H : 0) : d.hs,
      pass.k0 ? (d.hz() ? pass.k_steps * H : 0) : d.hz(), d};
  const pfdc::StripTile t = pass_tile(pass.k_steps * H, shape, pass, d);
  pfdc::bwd_strip<H, P>(smem, site, t, pass.k0, pass.k_steps, c);
}

template <int H, bool kZ>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    block_bwd(const float* __restrict__ ps_in,
              const float* __restrict__ pps_in,
              const float* __restrict__ pr_in,
              const float* __restrict__ ppr_in, float* __restrict__ ps_out,
              float* __restrict__ pps_out, float* __restrict__ pr_out,
              float* __restrict__ ppr_out, const float* __restrict__ snap0,
              const float* __restrict__ snap1, const float* __restrict__ v2m,
              int v2_shot_stride, const float* __restrict__ xramp,
              const float* __restrict__ zfac,
              const float* __restrict__ strip,
              const float* __restrict__ inj, int inj_shot_stride, int gz_rec,
              Dims<kZ> d, pfdc::StripShape shape, BlockPass pass,
              pfdc::Coefs c) {
  extern __shared__ float smem[];
  block_bwd_pass<H, kZ, 0>(smem, ps_in, pps_in, pr_in, ppr_in, ps_out,
                           pps_out, pr_out, ppr_out, snap0, snap1, v2m,
                           v2_shot_stride, xramp, zfac, strip, inj,
                           inj_shot_stride, gz_rec, d, shape, pass, c);
}

// The split twin (P = 2, 3): the same pass with the x taps in bf16 parts.
template <int H, bool kZ, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    block_bwd_mma(const float* __restrict__ ps_in,
                  const float* __restrict__ pps_in,
                  const float* __restrict__ pr_in,
                  const float* __restrict__ ppr_in,
                  float* __restrict__ ps_out, float* __restrict__ pps_out,
                  float* __restrict__ pr_out, float* __restrict__ ppr_out,
                  const float* __restrict__ snap0,
                  const float* __restrict__ snap1,
                  const float* __restrict__ v2m, int v2_shot_stride,
                  const float* __restrict__ xramp,
                  const float* __restrict__ zfac,
                  const float* __restrict__ strip,
                  const float* __restrict__ inj, int inj_shot_stride,
                  int gz_rec, Dims<kZ> d, pfdc::StripShape shape,
                  BlockPass pass, pfdc::Coefs c) {
  static_assert(P > 0, "block_bwd is the exact kernel");
  extern __shared__ float smem[];
  block_bwd_pass<H, kZ, P>(smem, ps_in, pps_in, pr_in, ppr_in, ps_out,
                           pps_out, pr_out, ppr_out, snap0, snap1, v2m,
                           v2_shot_stride, xramp, zfac, strip, inj,
                           inj_shot_stride, gz_rec, d, shape, pass, c);
}

// The kernel of a pass at P.
template <int H, bool kZ, int P>
auto bwd_kernel() {
  if constexpr (P == 0) {
    return block_bwd<H, kZ>;
  } else {
    return block_bwd_mma<H, kZ, P>;
  }
}

// The owned shape (tx = 0: none fits) and bytes of a pass of k_steps of a
// kernel on the forward strip body at P: the exact kernels' shapes, or the
// split instances' shapes and stage.
struct FwdPassTile {
  pfdc::StripShape shape;
  size_t bytes;
};

template <int H, int P>
FwdPassTile fwd_pass_tile(int k_steps) {
  const pfdc::StripStage stage = P ? pfdc::kFwdMmaStage : pfdc::kFwdStage;
  const pfdc::StripShape shape =
      P ? pfdc::strip_shape(pfdc::kFwdShapes, stage, k_steps * H)
        : pfdc::strip_shape(pfdc::kBlockFwdShapes, stage, k_steps * H);
  return {shape, pfdc::strip_bytes(shape, stage, k_steps * H)};
}

template <bool kZ>
struct BlockModRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  // k > kBlockPassSteps: (p, pp) between the passes, 2 * ns * plane floats
  float* scratch;
  const float* v2m;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* src;
  int r, sz;
  pfdc::Amps amps;
  int k;
  float* rec;
  int gz, ns;
  Dims<kZ> d;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  // One pass of block_mod (block_mod_mma at P > 0) from (a, b) into
  // (a_out, b_out).
  template <int H, int P>
  cudaError_t mod_pass(const float* a, const float* b, float* a_out,
                       float* b_out, BlockPass pass) const {
    const auto [shape, bytes] = fwd_pass_tile<H, P>(pass.k_steps);
    if (shape.tx == 0) return cudaErrorInvalidValue;
    const auto kernel = mod_kernel<H, kZ, P>();
    const cudaError_t e = pfdc::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = pfdc::strip_grid(shape, ns, d.nxl + 2 * pass.ex,
                                       d.nzl + 2 * pass.ez);
    const dim3 block(pfdc::kStripThreads);
    kernel<<<grid, block, bytes, stream>>>(
        a, b, a_out, b_out, v2m, v2_shot_stride, xramp, zfac, strip, src, r,
        sz, amps_from(amps, pass.k0), k, rec, gz, d, shape, pass, c);
    return cudaGetLastError();
  }

  template <int H, int P>
  cudaError_t launch() const {
    if (!d.fits(k * H)) return cudaErrorInvalidValue;
    const BlockPasses<kZ> passes(d, k, H);
    if (passes.n == 1) {
      return mod_pass<H, P>(p, pp, p_out, pp_out, passes.first);
    }
    if (scratch == nullptr) return cudaErrorInvalidValue;
    float* mid = scratch + ns * d.plane();
    const cudaError_t e = mod_pass<H, P>(p, pp, scratch, mid, passes.first);
    if (e != cudaSuccess) return e;
    return mod_pass<H, P>(scratch, mid, p_out, pp_out, passes.second);
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

template <bool kZ>
struct BlockFwdRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  // k > kBlockPassSteps: (p, pp) between the passes, 2 * ns * plane floats
  float* scratch;
  const float* v2m;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* src;
  int sz;
  pfdc::Amps amps;
  int k, ns;
  Dims<kZ> d;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  // One pass of block_fwd (block_fwd_mma at P > 0) from (a, b) into
  // (a_out, b_out).
  template <int H, int P>
  cudaError_t fwd_pass(const float* a, const float* b, float* a_out,
                       float* b_out, BlockPass pass) const {
    const auto [shape, bytes] = fwd_pass_tile<H, P>(pass.k_steps);
    if (shape.tx == 0) return cudaErrorInvalidValue;
    const auto kernel = fwd_kernel<H, kZ, P>();
    const cudaError_t e = pfdc::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = pfdc::strip_grid(shape, ns, d.nxl + 2 * pass.ex,
                                       d.nzl + 2 * pass.ez);
    const dim3 block(pfdc::kStripThreads);
    kernel<<<grid, block, bytes, stream>>>(
        a, b, a_out, b_out, v2m, v2_shot_stride, xramp, zfac, strip, src, sz,
        amps_from(amps, pass.k0), d, shape, pass, c);
    return cudaGetLastError();
  }

  template <int H, int P>
  cudaError_t launch() const {
    if (!d.fits(k * H)) return cudaErrorInvalidValue;
    const BlockPasses<kZ> passes(d, k, H);
    if (passes.n == 1) {
      return fwd_pass<H, P>(p, pp, p_out, pp_out, passes.first);
    }
    if (scratch == nullptr) return cudaErrorInvalidValue;
    float* mid = scratch + ns * d.plane();
    const cudaError_t e = fwd_pass<H, P>(p, pp, scratch, mid, passes.first);
    if (e != cudaSuccess) return e;
    return fwd_pass<H, P>(scratch, mid, p_out, pp_out, passes.second);
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

template <bool kZ>
struct BlockBwdRun {
  const float* ps;
  const float* pps;
  const float* pr;
  const float* ppr;
  float* ps_out;
  float* pps_out;
  float* pr_out;
  float* ppr_out;
  const float* snap0;
  const float* snap1;
  float* img;
  const float* v2m;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* inj;
  int inj_shot_stride, gz, k, ns;
  Dims<kZ> d;
  pfdc::Coefs c;
  int parts;
  // a block of k > kBlockPassSteps: the four fields and the image delta
  // between its passes, 4 * ns * plane + ns * nxl * nzl floats
  float* scratch;
  cudaStream_t stream;

  // One pass of block_bwd (block_bwd_mma at P > 0) from the fields (a, b,
  // c_, d_) into the out buffers.
  template <int H, int P>
  cudaError_t bwd_pass(const float* a, const float* b, const float* c_,
                       const float* d_, float* a_out, float* b_out,
                       float* c_out, float* d_out, BlockPass pass) const {
    const pfdc::StripStage stage = P ? pfdc::kBwdMmaStage : pfdc::kBwdStage;
    const pfdc::StripShape shape =
        pfdc::strip_shape(pfdc::kBwdShapes, stage, pass.k_steps * H);
    if (shape.tx == 0) return cudaErrorInvalidValue;
    const size_t bytes = pfdc::strip_bytes(shape, stage, pass.k_steps * H);
    const auto kernel = bwd_kernel<H, kZ, P>();
    const cudaError_t e = pfdc::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = pfdc::strip_grid(shape, ns, d.nxl + 2 * pass.ex,
                                       d.nzl + 2 * pass.ez);
    const dim3 block(pfdc::kStripThreads);
    kernel<<<grid, block, bytes, stream>>>(
        a, b, c_, d_, a_out, b_out, c_out, d_out, snap0, snap1, v2m,
        v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, d,
        shape, pass, c);
    return cudaGetLastError();
  }

  template <int H, int P>
  cudaError_t launch() const {
    if (!d.fits(k * H)) return cudaErrorInvalidValue;
    BlockPasses<kZ> passes(d, k, H);
    if (passes.n == 1) {
      passes.first.img_end = img;
      passes.first.add = true;
      return bwd_pass<H, P>(ps, pps, pr, ppr, ps_out, pps_out, pr_out,
                            ppr_out, passes.first);
    }
    // two passes through the scratch fields and image delta
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const size_t n = ns * d.plane();
    float* mid[4] = {scratch, scratch + n, scratch + 2 * n, scratch + 3 * n};
    float* delta = scratch + 4 * n;
    passes.first.img_end = delta;
    const cudaError_t e = bwd_pass<H, P>(ps, pps, pr, ppr, mid[0], mid[1],
                                         mid[2], mid[3], passes.first);
    if (e != cudaSuccess) return e;
    passes.second.img_start = delta;
    passes.second.img_end = img;
    passes.second.add = true;
    return bwd_pass<H, P>(mid[0], mid[1], mid[2], mid[3], ps_out, pps_out,
                          pr_out, ppr_out, passes.second);
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

// The entry points' common checks: 1 <= k <= 8; a seeded block_bwd has
// both snapshots and k >= 2.
inline bool bad_steps(int k) { return k < 1 || k > pfdc::kMaxSteps; }

inline bool bad_seed(const float* snap0, const float* snap1, int k) {
  return (snap0 != nullptr && k < 2) ||
         ((snap0 == nullptr) != (snap1 == nullptr));
}

}  // namespace
