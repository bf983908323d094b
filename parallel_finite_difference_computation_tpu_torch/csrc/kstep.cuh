// Shared pieces of the K-step kernels of the large-grid tier (kstep_mod.cu,
// kstep_gpu_fwd.cu, kstep_gpu_bwd.cu): the shared-memory tile, the taper
// rebuilt from its 1-D ramps, the loop over a tile's cells, and the split
// z taps of their lap_impl mxu/mxu6 variants. The exact K-step kernels and
// kstep_gpu_bwd_mma run the strip bodies of fwd_strip.cuh and
// bwd_strip.cuh (on strip.cuh) and take only the constants, the taper's
// ramps and axis_taps' order from here; the other split ones and the
// domain tiers' block_mod_mma (domain_block.cuh) stage this tile.
//
// Temporal blocking on an SM. One block owns kTileX x kTileZ cells of one
// shot and stages each field of the tile plus a halo of r = K*H cells on
// both axes in dynamic shared memory (one Pluto field is 36 MB, far beyond
// an SM, so the TPU kernels' full-width row slabs do not carry over). It
// then runs K steps there: step k computes the cells at least (k+1)*H from
// the tile's edge, so the valid region shrinks by H per step and after K
// steps it is exactly the owned cells; the halo cells are computed
// redundantly by the neighbouring blocks too. Global memory is read once
// and written once per pass, into buffers that no block of the pass reads.
//
// Synchronisation. Every loop over cells maps a cell to the same thread,
// whatever the region (for_cells below), so a thread may read back a cell
// it wrote itself without a barrier; a barrier separates writing a cell
// from its neighbours' reading it.
//
// The split z taps. Each kernel is a template on P, the bf16 parts of its
// Laplacian: P = 0 is the exact kernel; P = 2 (3) takes the z taps as the
// 3-pass (6-pass) split-bf16 banded product on the tensor cores
// (mma_bf16.cuh) and the x taps exact, as the JAX K-step kernels' use_mxu
// branch does (ops/pallas_stream.py:600-608, _lap_z_mxu_full + _lap_x_slab).
// An mma hands each output to a lane other than the one for_cells maps the
// cell to, so z_band writes the product into a staged buffer behind a
// barrier, and the cell's own thread adds the x taps (tile_lap): the
// update, the taper and the rest keep their threads and their order.
#pragma once

#include <type_traits>

#include "mma_bf16.cuh"
#include "stencil.cuh"

namespace pfdc {

constexpr int kTileX = 32;         // owned rows (x) of a block
constexpr int kTileZ = 64;         // owned columns (z) of a block
constexpr int kTileThreadsZ = 32;  // threadIdx.x runs along z
constexpr int kTileThreadsX = 16;  // threadIdx.y along x, a warp each
constexpr int kTileThreads = kTileThreadsZ * kTileThreadsX;
constexpr int kMaxSteps = 8;       // K per pass
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory of a block

// The K wavelet samples of a pass, by value.
struct Amps {
  float a[kMaxSteps];
};

inline Amps make_amps(const float* host, int k) {
  Amps a{};
  for (int i = 0; i < k; ++i) a.a[i] = host[i];
  return a;
}

// Cells of one staged field for a halo of r cells.
inline size_t tile_cells(int r) {
  return static_cast<size_t>(kTileX + 2 * r) * (kTileZ + 2 * r);
}

inline dim3 tile_grid(int ns, int nxe, int nze) {
  return dim3((nze + kTileZ - 1) / kTileZ, (nxe + kTileX - 1) / kTileX, ns);
}

inline dim3 tile_block() { return dim3(kTileThreadsZ, kTileThreadsX, 1); }

// Sets the kernel's dynamic shared memory limit to bytes, or refuses a
// tile that does not fit a block.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One block's tile: local (0, 0) is global cell (gx0, gz0); the owned
// cells are local [r, r + kTileX) x [r, r + kTileZ).
struct Tile {
  int r, sx, sz, gx0, gz0;

  __device__ explicit Tile(int halo)
      : r(halo),
        sx(kTileX + 2 * halo),
        sz(kTileZ + 2 * halo),
        gx0(static_cast<int>(blockIdx.y) * kTileX - halo),
        gz0(static_cast<int>(blockIdx.x) * kTileZ - halo) {}

  __device__ int cells() const { return sx * sz; }

  __device__ bool owned(int lx, int lz) const {
    return lx >= r && lx < r + kTileX && lz >= r && lz < r + kTileZ;
  }
};

// Calls fn(lx, lz, gx, gz) for every cell of the tile at least lo cells
// from its edge that lies in the nxe x nze grid. Cells outside the grid
// are never visited: they hold 0 from load_tile. The cell -> thread map
// does not depend on lo.
template <class F>
__device__ __forceinline__ void for_cells(const Tile& t, int lo, int nxe,
                                          int nze, F&& fn) {
  for (int lx = threadIdx.y; lx < t.sx; lx += blockDim.y) {
    const int gx = t.gx0 + lx;
    if (lx < lo || lx >= t.sx - lo || gx < 0 || gx >= nxe) continue;
    for (int lz = threadIdx.x; lz < t.sz; lz += blockDim.x) {
      const int gz = t.gz0 + lz;
      if (lz < lo || lz >= t.sz - lo || gz < 0 || gz >= nze) continue;
      fn(lx, lz, gx, gz);
    }
  }
}

// Stages one shot's field f (nxe, nze) into s, 0 outside the grid.
__device__ __forceinline__ void load_tile(float* s,
                                          const float* __restrict__ f,
                                          const Tile& t, int nxe, int nze) {
  for (int lx = threadIdx.y; lx < t.sx; lx += blockDim.y) {
    const int gx = t.gx0 + lx;
    for (int lz = threadIdx.x; lz < t.sz; lz += blockDim.x) {
      const int gz = t.gz0 + lz;
      s[lx * t.sz + lz] =
          (gx >= 0 && gx < nxe && gz >= 0 && gz < nze)
              ? f[static_cast<size_t>(gx) * nze + gz]
              : 0.0f;
    }
  }
}

// Writes the owned cells of s back to one shot's field f.
__device__ __forceinline__ void store_tile(float* __restrict__ f,
                                           const float* s, const Tile& t,
                                           int nxe, int nze) {
  for_cells(t, t.r, nxe, nze, [&](int lx, int lz, int gx, int gz) {
    f[static_cast<size_t>(gx) * nze + gz] = s[lx * t.sz + lz];
  });
}

// The taper multiplier of cell (gx, gz), rebuilt from the mask's 1-D
// factors (numerics.mask_ramps): zfac[gz] * (strip[gz] ? xramp[gx] : 1),
// one rounding, bitwise the mask plane's own product (tested on the CPU
// for the 3lay and Pluto shapes). Saves streaming a 36 MB plane per pass.
__device__ __forceinline__ float taper_at(const float* __restrict__ xramp,
                                          const float* __restrict__ zfac,
                                          const float* __restrict__ strip,
                                          int gx, int gz) {
  return zfac[gz] * (strip[gz] != 0.0f ? xramp[gx] : 1.0f);
}

// One axis's taps of tile cell j, centre included, its neighbours stride
// apart (the tile's pitch for x, 1 for z) and half its coefficients
// (Coefs::x or Coefs::z), in the order of laplacian's accx and accz
// (stencil.cuh): the exact half of a split Laplacian.
template <int H>
__device__ __forceinline__ float axis_taps(const float* f, int j, int stride,
                                           const float* half) {
  float acc = half[H] * (f[j - H * stride] + f[j + H * stride]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    acc = acc + half[k] * (f[j - k * stride] + f[j + k * stride]);
  }
  return acc + half[0] * f[j];
}

// The band fragments of one axis's split taps (half: that axis's
// coefficients, Coefs::z or Coefs::x) of the thread in lane lane of its
// warp; nothing for P = 0.
struct NoBand {};
template <int H, int P>
using SplitBand = std::conditional_t<P == 0, NoBand, Band<H, P>>;

template <int H, int P>
__device__ __forceinline__ SplitBand<H, P> split_band(const float* half,
                                                      int lane) {
  if constexpr (P == 0) {
    return {};
  } else {
    return band_fragments<H, P>(half, lane);
  }
}

// The same for a block whose threadIdx.x is the lane (32 threads along x).
template <int H, int P>
__device__ __forceinline__ SplitBand<H, P> split_band(const float* half) {
  return split_band<H, P>(half, static_cast<int>(threadIdx.x));
}

// The z taps of the field f, centre included, as the P-part split-bf16
// banded product, into zb at every cell of the tile at least lo cells from
// its edge, then a barrier; nothing for P = 0. A warp (threadIdx.y) takes
// the region's 16 x 8 blocks in turn: an output's window runs from H cells
// before it along z, reads past the tile's edge read 0 (the band's zeros
// multiply every value read, so each must be finite), and outputs beyond
// the region are not written.
template <int H, int P>
__device__ __forceinline__ void z_band(float* zb, const float* f,
                                       const Tile& t, int lo,
                                       const SplitBand<H, P>& band) {
  if constexpr (P > 0) {
    const int lane = static_cast<int>(threadIdx.x);
    const int hx = t.sx - lo, hz = t.sz - lo;
    const int nbz = (hz - lo + 7) / 8;
    const int nb = (hx - lo + 15) / 16 * nbz;
    for (int b = threadIdx.y; b < nb; b += blockDim.y) {
      const int x0 = lo + 16 * (b / nbz);
      const int z0 = lo + 8 * (b % nbz);
      float y[4];
      banded_mma<H, P>(
          y,
          [&](int m, int k) {
            const int lx = x0 + m, lz = z0 - H + k;
            return lx < t.sx && lz < t.sz ? f[lx * t.sz + lz] : 0.0f;
          },
          band, lane);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int lx = x0 + frag_g(lane) + 8 * (q >> 1);
        const int lz = z0 + 2 * frag_t(lane) + (q & 1);
        if (lx < hx && lz < hz) zb[lx * t.sz + lz] = y[q];
      }
    }
    __syncthreads();
  }
}

// The Laplacian at tile cell j of the field f: the exact taps (P = 0), or
// the split z taps z_band left in zb plus the exact x taps (yz + accx).
template <int H, int P>
__device__ __forceinline__ float tile_lap(const float* f, const float* zb,
                                          int j, int sz, const Coefs& c) {
  if constexpr (P == 0) {
    return laplacian<H, false>(f, nullptr, j, sz, c);
  } else {
    return zb[j] + axis_taps<H>(f, j, sz, c.x);
  }
}

// Calls run.template launch<H, P>() for the P = parts (0, 2 or 3) of a
// kernel of the tier (the K-step kernels, gpu_step).
template <int H, class Run>
cudaError_t dispatch_parts(const Run& run, int parts) {
  switch (parts) {
    case 0: return run.template launch<H, 0>();
    case 2: return run.template launch<H, 2>();
    case 3: return run.template launch<H, 3>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pfdc
