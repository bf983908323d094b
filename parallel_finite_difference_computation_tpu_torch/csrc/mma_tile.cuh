// The staged 64 x 64 output tile of the one per-step split-bf16 kernel
// that does not run a strip body yet, rec_fwd_step_mma (rec_step.cu): its
// shape, stage, z product and cell loop. fd_step_mma, fd_update_mma,
// gpu_step_mma and rec_bwd_step_mma run the one-step strip body of
// step_strip.cuh instead.
//
// A block of four warps owns kMmaTileX x kMmaTileZ output cells of one shot
// and stages the field its taps read (zeros outside the grid). Each warp
// runs its 16 rows as eight 16 x 8 mma blocks along z (mma_bf16.cuh,
// banded_mma: the window of an output starts H cells before it), writes
// the z product into a second buffer behind a barrier (tile_z_mma), as
// strip.cuh's z_product does, and then the block takes the cells in the
// exact kernels' order, threads along z (for_tile_cells), each adding the
// exact x taps from the tile: every load and store of a warp covers whole
// 32-byte sectors (the fields, a frame of swf or rwf, the image), where an
// mma lane holds two adjacent z values of a row and its neighbour the next
// pair.
#pragma once

#include "kstep.cuh"

namespace pfdc {

constexpr int kMmaTileX = 64;     // output rows (x) of a block
constexpr int kMmaTileZ = 64;     // output columns (z)
constexpr int kMmaThreads = 128;  // four warps of 16 rows
constexpr int kZbPitch = kMmaTileZ + 4;  // 2-way bank conflicts on write

// The staged tile: rows x0 - H .. x0 + 63 + H, columns z0 - H on; the last
// window reads to column 8 * 7 + 16 * KS - 1, beyond the x taps' reach
// (63 + H). A row pitch of 8 mod 32 floats, as lap_padded's.
template <int H>
struct MmaTile {
  static constexpr int kRows = kMmaTileX + 2 * H;
  static constexpr int kCols = kMmaTileZ - 8 + 16 * band_ksteps<H>();
  static constexpr int kPitch = (kCols + 23) / 32 * 32 + 8;
  static constexpr int kCells = kRows * kPitch;
  // dynamic shared memory of a block: the tile, then the z product of the
  // output cells
  static constexpr size_t kStageBytes =
      sizeof(float) * (kCells + kMmaTileX * kZbPitch);
};

inline dim3 mma_grid(int ns, int nxe, int nze) {
  return dim3((nze + kMmaTileZ - 1) / kMmaTileZ,
              (nxe + kMmaTileX - 1) / kMmaTileX, ns);
}

// Stages one shot's field f (nxe, nze) for the block at (x0, z0) into t,
// 0 outside the grid, then a barrier.
template <int H>
__device__ __forceinline__ void stage_tile(float* t,
                                           const float* __restrict__ f,
                                           int x0, int z0, int nxe,
                                           int nze) {
  using T = MmaTile<H>;
  for (int i = threadIdx.x; i < T::kRows * T::kCols; i += kMmaThreads) {
    const int r = i / T::kCols;
    const int cc = i - r * T::kCols;
    const int ix = x0 - H + r;
    const int iz = z0 - H + cc;
    t[r * T::kPitch + cc] = (ix >= 0 && ix < nxe && iz >= 0 && iz < nze)
                                ? f[static_cast<size_t>(ix) * nze + iz]
                                : 0.0f;
  }
  __syncthreads();
}

// The z taps of the staged tile t, centre included, as the P-part
// split-bf16 banded product, into zb (row r, column cz at r * kZbPitch +
// cz) for every output cell of the block inside the grid, then a barrier.
template <int H, int P>
__device__ __forceinline__ void tile_z_mma(float* zb, const float* t,
                                           int x0, int z0, int nxe,
                                           int nze, const Coefs& c) {
  using T = MmaTile<H>;
  const int lane = threadIdx.x & 31;
  const int wr = 16 * (threadIdx.x >> 5);  // the warp's first output row
  const Band<H, P> band = band_fragments<H, P>(c.z, lane);
#pragma unroll 1
  for (int nb = 0; nb < kMmaTileZ / 8; ++nb) {
    float yz[4];
    banded_mma<H, P>(
        yz,
        [&](int m, int k) { return t[(H + wr + m) * T::kPitch + 8 * nb + k]; },
        band, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = wr + frag_g(lane) + 8 * (q >> 1);
      const int cz = 8 * nb + 2 * frag_t(lane) + (q & 1);
      if (x0 + r < nxe && z0 + cz < nze) zb[r * kZbPitch + cz] = yz[q];
    }
  }
  __syncthreads();
}

// Calls fn(ix, iz, jt, jz) for every output cell of the block at (x0, z0)
// inside the grid, threads along z: jt is the cell's index in the staged
// tile, jz in the z product.
template <int H, class F>
__device__ __forceinline__ void for_tile_cells(int x0, int z0, int nxe,
                                               int nze, F&& fn) {
  for (int i = threadIdx.x; i < kMmaTileX * kMmaTileZ; i += kMmaThreads) {
    const int r = i / kMmaTileZ;
    const int cz = i - r * kMmaTileZ;
    if (x0 + r < nxe && z0 + cz < nze) {
      fn(x0 + r, z0 + cz, (r + H) * MmaTile<H>::kPitch + cz + H,
         r * kZbPitch + cz);
    }
  }
}

// The split Laplacian of tile cell jt at grid cell (ix, iz): the z product
// zb[jz] plus the exact x taps (yz + accx, strip.cuh's cell_lap), 0 outside
// the interior [H, nxe - H) x [H, nze - H).
template <int H>
__device__ __forceinline__ float split_lap(const float* t, const float* zb,
                                           int ix, int iz, int jt, int jz,
                                           int nxe, int nze,
                                           const Coefs& c) {
  return in_interior(ix, iz, H, nxe, nze)
             ? zb[jz] + axis_taps<H>(t, jt, MmaTile<H>::kPitch, c.x)
             : 0.0f;
}

}  // namespace pfdc
