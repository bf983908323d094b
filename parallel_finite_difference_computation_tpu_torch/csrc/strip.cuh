// The register-strip pieces of the temporal-blocking bodies: the backward
// body of bwd_strip.cuh (kstep_gpu_bwd, block_bwd, block2_bwd; with the x
// taps split block_bwd_mma, block2_bwd_mma, with the z taps split
// kstep_gpu_bwd_mma) and the forward body of fwd_strip.cuh (kstep_mod,
// kstep_gpu_fwd, block_mod, block_fwd; with the x taps split
// block_mod_mma, block2_mod_mma, block_fwd_mma, block2_fwd_mma; with the z
// taps split kstep_mod_mma, kstep_gpu_fwd_mma), and the one-step split
// body of step_strip.cuh (fd_step_mma, gpu_step_mma, fd_update_mma,
// rec_fwd_step_mma, rec_bwd_step_mma); the split x product of both
// bodies' block instances, and the split z product of both bodies' K-step
// instances and of the one-step body.
//
// A block stages a tile of owned cells plus a halo of r = K*H cells on
// both axes in dynamic shared memory: only the fields that neighbours read
// (with cp.async, every load of a thread in flight at once) and the
// taper's x ramp along the tile's rows. Each step, each thread takes a
// strip of rows cells down one column (lanes along z) of the step's
// region, the cells at least (k+1)*H from the tile's edge: the strip's x
// taps come from a register window of rows + 2H values, so a Laplacian
// reads 2H z taps and (rows + 2H) / rows window values from shared memory
// instead of 4H + 1 taps. The strips are laid over each step's shrinking
// region anew, so no warp visits a cell outside it.
#pragma once

#include "kstep.cuh"

namespace pfdc {

// The design steps, each adopted against its variants on an H100 (PERF.md;
// scripts/torch_bwd_probe.py, scripts/torch_fwd_probe.py): 4-row strips,
// 16 warps a block, two blocks an SM (__launch_bounds__: 64 registers a
// thread).
constexpr int kStripRows = 4;       // cells of a thread's strip along x
constexpr int kStripWarps = 16;
constexpr int kStripThreads = 32 * kStripWarps;
constexpr int kStripBlocks = 2;     // blocks an SM, at least

// Owned cells of a block; a launcher takes the first shape of its body's
// list whose tile fits a block's shared memory (strip_shape).
struct StripShape {
  int tx, tz;
};

// What a body stages besides the x ramp: its fields, each over the whole
// tile, whether the owned cells' image, and whether its rows are padded
// (strip_pitch).
struct StripStage {
  int fields;
  bool image;
  bool padded = false;
};

// The pitch of a staged tile whose rows hold sz cells: sz, or padded to
// the next count that is 4 mod 8 floats, so that rows 2 apart start 8
// banks apart (the split x product's A-fragment reads and its stores,
// whose lanes t = 0..3 take rows 2t apart: 4-way bank conflicts at a
// pitch of 0 mod 32, none at 4 mod 8).
__host__ __device__ constexpr int strip_pitch(int sz, bool padded) {
  return padded ? (sz + 3) / 8 * 8 + 4 : sz;
}

// Dynamic shared memory of a tile of shape s with a halo of r cells.
inline size_t strip_bytes(StripShape s, StripStage g, int r) {
  const size_t sx = s.tx + 2 * r;
  const size_t pitch = strip_pitch(s.tz + 2 * r, g.padded);
  return sizeof(float) *
         (g.fields * sx * pitch +
          (g.image ? static_cast<size_t>(s.tx) * s.tz : 0) + sx);
}

// The first of shapes whose tile fits, or {0, 0} if none does.
template <size_t N>
inline StripShape strip_shape(const StripShape (&shapes)[N], StripStage g,
                              int r) {
  for (const StripShape& s : shapes) {
    if (strip_bytes(s, g, r) <= static_cast<size_t>(kMaxSmemBytes)) return s;
  }
  return {0, 0};
}

// The launch grid of a tile shape over an (nx, nz) region, for ns shots.
inline dim3 strip_grid(StripShape s, int ns, int nx, int nz) {
  return dim3((nz + s.tz - 1) / s.tz, (nx + s.tx - 1) / s.tx, ns);
}

// One block's staged tile: local (0, 0) is field cell (gx0, gz0); the
// owned cells are local [r, r + tx) x [r, r + tz).
struct StripTile {
  int r, tx, tz, sx, sz, gx0, gz0;

  __device__ StripTile(int halo, StripShape s, int ox, int oz)
      : r(halo),
        tx(s.tx),
        tz(s.tz),
        sx(s.tx + 2 * halo),
        sz(s.tz + 2 * halo),
        gx0(ox - halo),
        gz0(oz - halo) {}
};

// Stages the tile of each field src[f] (one shot's (nxf, nzf) field) into
// dst[f] at the given pitch with cp.async, 0 outside the grid and wherever
// held(gx, gz) is false; the caller then waits (cp_async_wait_all) and
// syncs.
template <int NF, class Held>
__device__ __forceinline__ void stage_strip_fields(
    float* const (&dst)[NF], const float* const (&src)[NF],
    const StripTile& t, int nxf, int nzf, Held&& held, int pitch) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nth = static_cast<int>(blockDim.x);
  for (int i = tid; i < t.sx * t.sz; i += nth) {
    const int lx = i / t.sz, lz = i - lx * t.sz;
    const int gx = t.gx0 + lx, gz = t.gz0 + lz;
    const bool in =
        gx >= 0 && gx < nxf && gz >= 0 && gz < nzf && held(gx, gz);
    const size_t q = in ? static_cast<size_t>(gx) * nzf + gz : 0;
    const int j = lx * pitch + lz;
#pragma unroll
    for (int f = 0; f < NF; ++f) cp_async4(dst[f] + j, src[f] + q, in);
  }
}

// The same, and the x ramp of the tile's rows into sxr.
template <int NF, class Held>
__device__ __forceinline__ void stage_strip_tile(
    float* const (&dst)[NF], const float* const (&src)[NF], float* sxr,
    const float* __restrict__ xramp, const StripTile& t, int nxf, int nzf,
    Held&& held, int pitch) {
  stage_strip_fields<NF>(dst, src, t, nxf, nzf, held, pitch);
  const int tid = static_cast<int>(threadIdx.x);
  const int nth = static_cast<int>(blockDim.x);
  for (int lx = tid; lx < t.sx; lx += nth) {
    const int gx = t.gx0 + lx;
    sxr[lx] = gx >= 0 && gx < nxf ? xramp[gx] : 0.0f;
  }
}

// The same, every cell in the grid held, at the pitch t.sz.
template <int NF>
__device__ __forceinline__ void stage_strip_tile(
    float* const (&dst)[NF], const float* const (&src)[NF], float* sxr,
    const float* __restrict__ xramp, const StripTile& t, int nxf, int nzf) {
  stage_strip_tile<NF>(dst, src, sxr, xramp, t, nxf, nzf,
                       [](int, int) { return true; }, t.sz);
}

// The taper multiplier of tile row lx in a column of z factor zf whose
// strip flag is ramp: taper_at's product, with the x ramp staged.
__device__ __forceinline__ float strip_taper(const float* sxr, int lx,
                                             float zf, bool ramp) {
  return zf * (ramp ? sxr[lx] : 1.0f);
}

// Tapers the staged field f (rows pitch apart) at every tile cell in the
// grid, in a phase of its own (the barrier after it is here; the one
// before, the staging's).
__device__ __forceinline__ void taper_strip_tile(
    float* f, const float* sxr, const float* __restrict__ zfac,
    const float* __restrict__ strip, const StripTile& t, int nxf, int nzf,
    int pitch) {
  for (int i = static_cast<int>(threadIdx.x); i < t.sx * t.sz;
       i += static_cast<int>(blockDim.x)) {
    const int lx = i / t.sz, lz = i - lx * t.sz;
    const int gx = t.gx0 + lx, gz = t.gz0 + lz;
    const int j = lx * pitch + lz;
    if (gx >= 0 && gx < nxf && gz >= 0 && gz < nzf) {
      f[j] = f[j] * strip_taper(sxr, lx, zfac[gz], strip[gz] != 0.0f);
    }
  }
  __syncthreads();
}

// The same at the pitch t.sz.
__device__ __forceinline__ void taper_strip_tile(
    float* f, const float* sxr, const float* __restrict__ zfac,
    const float* __restrict__ strip, const StripTile& t, int nxf, int nzf) {
  taper_strip_tile(f, sxr, zfac, strip, t, nxf, nzf, t.sz);
}

// The strips of S rows (fewer at the region's end) of the tile region at
// least lo cells from its edge: item i is strip i / groups, lanes along z
// in the group of 32 columns i % groups from lo; the block's warps take
// the items in turn.
template <int S>
struct StripWalk {
  int lo, groups, items;

  __device__ StripWalk(const StripTile& t, int region_lo)
      : lo(region_lo),
        groups((t.sz - 2 * region_lo + 31) / 32),
        items((t.sx - 2 * region_lo + S - 1) / S *
              ((t.sz - 2 * region_lo + 31) / 32)) {}

  // This lane's strip of the item: its first row lx0, its rows, and the
  // column lz, field row gz; false where the column lies outside the
  // region or the grid.
  __device__ bool strip(int item, int lane, const StripTile& t, int nzf,
                        int& lx0, int& rows, int& lz, int& gz) const {
    const int row = item / groups;
    lx0 = lo + row * S;
    lz = lo + (item - row * groups) * 32 + lane;
    gz = t.gz0 + lz;
    rows = t.sx - lo - lx0 < S ? t.sx - lo - lx0 : S;
    return lz < t.sz - lo && gz >= 0 && gz < nzf;
  }
};

// The x windows of a strip of the staged fields f[0..NF): w[f][q] is row
// lx0 - H + q of column lz, for the rows + 2H rows the strip reads (0 past
// them), the fields' loads of a row issued together.
template <int H, int NF, int N>
__device__ __forceinline__ void strip_windows(float (&w)[NF][N],
                                              const float* const (&f)[NF],
                                              const StripTile& t, int lx0,
                                              int rows, int lz) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int j = (lx0 - H + q) * t.sz + lz;
    const bool ok = q < rows + 2 * H;
#pragma unroll
    for (int i = 0; i < NF; ++i) w[i][q] = ok ? f[i][j] : 0.0f;
  }
}

// The same for fields whose rows lie pitch apart (strip_pitch).
template <int H, int NF, int N>
__device__ __forceinline__ void strip_windows(float (&w)[NF][N],
                                              const float* const (&f)[NF],
                                              const StripTile& t, int lx0,
                                              int rows, int lz, int pitch) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int j = (lx0 - H + q) * pitch + lz;
    const bool ok = q < rows + 2 * H;
#pragma unroll
    for (int i = 0; i < NF; ++i) w[i][q] = ok ? f[i][j] : 0.0f;
  }
}

// The x taps of strip cell i from its window w (w[q] is row lx - H + q of
// the cell's column), centre included, with the coefficients half
// (Coefs::x), summed as kstep.cuh's axis_taps sums down a column.
template <int H, int N>
__device__ __forceinline__ float window_taps(const float (&w)[N], int i,
                                             const float* half) {
  float acc = half[H] * (w[i] + w[i + 2 * H]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    acc = acc + half[k] * (w[i + H - k] + w[i + H + k]);
  }
  return acc + half[0] * w[i + H];
}

// The Laplacian of strip cell i at tile cell j: the z taps from the staged
// field f, the x taps from the strip's window w, in the order of
// stencil.cuh's laplacian (accz + accx).
template <int H, int N>
__device__ __forceinline__ float strip_lap(const float (&w)[N], int i,
                                           const float* f, int j,
                                           const Coefs& c) {
  float accz = c.z[H] * (f[j - H] + f[j + H]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accz = accz + c.z[k] * (f[j - k] + f[j + k]);
  }
  accz = accz + c.z[0] * w[i + H];
  return accz + window_taps<H>(w, i, c.x);
}

// The axis whose taps a split instance (P > 0) takes as the banded product.
enum class Split { kX, kZ };

// The Laplacian of strip cell i at tile cell j of the staged field f:
// exact from the strip's x window w (P = 0); the x product xb plus the
// exact z taps (Split::kX); or the z product (in xb) plus the window's x
// taps (Split::kZ), the order of the JAX K-step kernels' use_mxu branch.
template <int H, int P, Split A, int N>
__device__ __forceinline__ float cell_lap(const float (&w)[N], int i,
                                          const float* f, const float* xb,
                                          int j, const Coefs& c) {
  if constexpr (P == 0) {
    return strip_lap<H>(w, i, f, j, c);
  } else if constexpr (A == Split::kX) {
    return xb[j] + axis_taps<H>(f, j, 1, c.z);
  } else {
    return xb[j] + window_taps<H>(w, i, c.x);
  }
}

// The value of strip cell i at tile cell j of f: the window's where the
// instance loads one.
template <int H, int P, Split A, int N>
__device__ __forceinline__ float cell_centre(const float (&w)[N], int i,
                                             const float* f, int j) {
  if constexpr (P == 0 || A == Split::kZ) {
    return w[i + H];
  } else {
    return f[j];
  }
}

// The x taps of the staged field f, centre included, as the P-part
// split-bf16 banded product, into xb at every cell of the StripTile t at
// least lo cells from its edge, f and xb with rows pitch apart; the
// caller's barrier follows.
// Warp warp of nwarps takes the region's blocks of 16 columns (the mma's
// rows m, along z) by 8 rows (its outputs n, along x) in turn, contracting
// down x:
// A[m][k] is column z0 + m of the tile at row x0 - H + k, the window of
// output row x0 + n starting H rows before it. Reads past the tile read 0
// (the band's zeros multiply every value read, so each must be finite: the
// staged cells all are), and outputs beyond the region are not written.
template <int H, int P>
__device__ __forceinline__ void x_product(float* xb, const float* f,
                                          const StripTile& t, int lo,
                                          const Band<H, P>& band, int pitch,
                                          int warp, int nwarps, int lane) {
  const int hx = t.sx - lo, hz = t.sz - lo;
  const int nbz = (hz - lo + 15) / 16;
  const int nb = (hx - lo + 7) / 8 * nbz;
  for (int b = warp; b < nb; b += nwarps) {
    const int x0 = lo + 8 * (b / nbz);
    const int z0 = lo + 16 * (b % nbz);
    float y[4];
    banded_mma<H, P>(
        y,
        [&](int m, int k) {
          const int lx = x0 - H + k, lz = z0 + m;
          return lx < t.sx && lz < t.sz ? f[lx * pitch + lz] : 0.0f;
        },
        band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lz = z0 + frag_g(lane) + 8 * (q >> 1);
      const int lx = x0 + 2 * frag_t(lane) + (q & 1);
      if (lx < hx && lz < hz) xb[lx * pitch + lz] = y[q];
    }
  }
}

// The z taps of the staged field f, centre included, as the P-part
// split-bf16 banded product, into zb at every cell of the StripTile t at
// least lo cells from its edge, f and zb with rows pitch apart; the
// caller's barrier follows. Warp warp of nwarps takes the region's blocks
// of 16 rows (the mma's rows m, along x) by 8 columns (its outputs n,
// along z) in turn, contracting along z:
// A[m][k] is row x0 + m of the tile at column z0 - H + k, the window of
// output column z0 + n starting H columns before it. A fragment's lanes
// read 8 rows at 4 columns 2 apart: at a pitch of 4 mod 8 floats (the
// padded rows) 2-way bank conflicts, at 0 mod 32 (the unpadded 64 + 2r
// of a halo r of 16 or 32) 8-way. Reads past the tile read 0 (every value
// read must be finite, the band's zeros included: the staged cells all
// are), and outputs beyond the region are not written.
template <int H, int P>
__device__ __forceinline__ void z_product(float* zb, const float* f,
                                          const StripTile& t, int lo,
                                          const Band<H, P>& band, int pitch,
                                          int warp, int nwarps, int lane) {
  const int hx = t.sx - lo, hz = t.sz - lo;
  const int nbz = (hz - lo + 7) / 8;
  const int nb = (hx - lo + 15) / 16 * nbz;
  for (int b = warp; b < nb; b += nwarps) {
    const int x0 = lo + 16 * (b / nbz);
    const int z0 = lo + 8 * (b % nbz);
    float y[4];
    banded_mma<H, P>(
        y,
        [&](int m, int k) {
          const int lx = x0 + m, lz = z0 - H + k;
          return lx < t.sx && lz < t.sz ? f[lx * pitch + lz] : 0.0f;
        },
        band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lx = x0 + frag_g(lane) + 8 * (q >> 1);
      const int lz = z0 + 2 * frag_t(lane) + (q & 1);
      if (lx < hx && lz < hz) zb[lx * pitch + lz] = y[q];
    }
  }
}

}  // namespace pfdc
