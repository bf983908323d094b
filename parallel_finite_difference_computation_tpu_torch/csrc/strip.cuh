// The register-strip pieces of the exact temporal-blocking bodies: the
// backward body of bwd_strip.cuh (kstep_gpu_bwd, block_bwd, block2_bwd)
// and the forward body of fwd_strip.cuh (kstep_mod, kstep_gpu_fwd).
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
// tile, and whether the owned cells' image.
struct StripStage {
  int fields;
  bool image;
};

// Dynamic shared memory of a tile of shape s with a halo of r cells.
inline size_t strip_bytes(StripShape s, StripStage g, int r) {
  const size_t sx = s.tx + 2 * r, sz = s.tz + 2 * r;
  return sizeof(float) *
         (g.fields * sx * sz +
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
// dst[f] with cp.async, 0 outside the grid, and the x ramp of the tile's
// rows into sxr; the caller then waits (cp_async_wait_all) and syncs.
template <int NF>
__device__ __forceinline__ void stage_strip_tile(
    float* const (&dst)[NF], const float* const (&src)[NF], float* sxr,
    const float* __restrict__ xramp, const StripTile& t, int nxf, int nzf) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nth = static_cast<int>(blockDim.x);
  for (int i = tid; i < t.sx * t.sz; i += nth) {
    const int lx = i / t.sz, lz = i - lx * t.sz;
    const int gx = t.gx0 + lx, gz = t.gz0 + lz;
    const bool in = gx >= 0 && gx < nxf && gz >= 0 && gz < nzf;
    const size_t q = in ? static_cast<size_t>(gx) * nzf + gz : 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) cp_async4(dst[f] + i, src[f] + q, in);
  }
  for (int lx = tid; lx < t.sx; lx += nth) {
    const int gx = t.gx0 + lx;
    sxr[lx] = gx >= 0 && gx < nxf ? xramp[gx] : 0.0f;
  }
}

// The taper multiplier of tile row lx in a column of z factor zf whose
// strip flag is ramp: taper_at's product, with the x ramp staged.
__device__ __forceinline__ float strip_taper(const float* sxr, int lx,
                                             float zf, bool ramp) {
  return zf * (ramp ? sxr[lx] : 1.0f);
}

// Tapers the staged field f at every tile cell in the grid, in a phase of
// its own (the barrier after it is here; the one before, the staging's).
__device__ __forceinline__ void taper_strip_tile(
    float* f, const float* sxr, const float* __restrict__ zfac,
    const float* __restrict__ strip, const StripTile& t, int nxf, int nzf) {
  for (int i = static_cast<int>(threadIdx.x); i < t.sx * t.sz;
       i += static_cast<int>(blockDim.x)) {
    const int lx = i / t.sz, lz = i - lx * t.sz;
    const int gx = t.gx0 + lx, gz = t.gz0 + lz;
    if (gx >= 0 && gx < nxf && gz >= 0 && gz < nzf) {
      f[i] = f[i] * strip_taper(sxr, lx, zfac[gz], strip[gz] != 0.0f);
    }
  }
  __syncthreads();
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

// The Laplacian of strip cell i at tile cell j: the z taps from the staged
// field f, the x taps from the strip's window w (w[q] is row lx - H + q
// of the cell's column), in the order of stencil.cuh's laplacian.
template <int H, int N>
__device__ __forceinline__ float strip_lap(const float (&w)[N], int i,
                                           const float* f, int j,
                                           const Coefs& c) {
  const float centre = w[i + H];
  float accz = c.z[H] * (f[j - H] + f[j + H]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accz = accz + c.z[k] * (f[j - k] + f[j + k]);
  }
  accz = accz + c.z[0] * centre;
  float accx = c.x[H] * (w[i] + w[i + 2 * H]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accx = accx + c.x[k] * (w[i + H - k] + w[i + H + k]);
  }
  accx = accx + c.x[0] * centre;
  return accz + accx;
}

}  // namespace pfdc
