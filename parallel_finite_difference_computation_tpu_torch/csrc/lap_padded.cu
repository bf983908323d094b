// lap_padded and lap_padded_mma: one apply of the order-2H interior
// Laplacian on the port's padded layout (ops/padded.py: the (nx, nz) field
// at rows and columns [H, H + n) of an (R, W) array, R = nx + 2H, W a
// multiple of 4), writing an (R, W) array in the same layout with its pads
// zero, so applies chain. The C entry point pfdc_lap_padded_run launches
// one of them once on a stream.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stencil.py,
// _kernel_padded (:546, lap_padded: both axes' taps exact, in the JAX
// order, bitwise the plain version) and _kernel_padded_mxu (:429,
// lap_padded_mma<H, P>: the z taps as the banded product in P-part split
// bf16 on the tensor cores, mma_bf16.cuh; the x taps and x's centre tap
// exact on the CUDA cores; yz + accx), both through
// laplacian_pallas_padded (:580). The TPU kernels stream row tiles of the
// full lane width HBM -> VMEM with a double-buffered DMA; a row of an
// 8192-wide field is 32 KB, so here a block stages a 2D tile: its 64 x 64
// outputs and their halo, (64 + 2H) rows of the tile's columns, with
// cp.async (16-byte copies; the z halo rounded up to 4 floats so that
// every copy is aligned, chunks outside the array filled with zeros). A
// single stage per block: the several blocks resident on an SM overlap
// one another's copies.
//
// What bounds it on an H100: HBM. One apply reads the (R, W) plane once
// and writes it once (at 8192 x 8192, order 8: 2 x 269 MB, 0.161 ms at
// 3.35 TB/s), against 6H + 3 flop a cell (0.03 ms at 67 TFLOP/s) or the
// mma's 2 x (16 * KS) x P-term multiply-adds a cell at the bf16 tensor
// rate. The halo is re-read from L2: (64 + 2H) x (64 + 2 * HA) staged per
// 64 x 64 written. lap_padded keeps a column's 2H + 1 x taps in registers
// as it walks down its 32 rows, so that each output costs 2H + 1 shared
// loads, not 4H + 1.
#include "mma_bf16.cuh"
#include "stencil.cuh"

namespace {

constexpr int kTileX = 64;   // output rows of a block
constexpr int kTileZ = 64;   // output columns of a block
constexpr int kThreads = 128;

// The staged tile: rows x0 - H .. (kRows), columns z0 - kHA .. (kCols), a
// row pitch of 8 mod 32 floats (2-way bank conflicts at most for the mma's
// fragment loads, none for lap_padded's).
template <int H>
struct Tile {
  static constexpr int kHA = (H + 3) / 4 * 4;
  static constexpr int kKS = pfdc::band_ksteps<H>();
  static constexpr int kRows = kTileX + 2 * H;
  // lap_padded reads to column kHA + kTileZ + H - 1, lap_padded_mma's last
  // window to kHA - H + kTileZ - 8 + 16 * kKS - 1
  static constexpr int kNeed =
      kHA + kTileZ + H > kHA - H + kTileZ - 8 + 16 * kKS
          ? kHA + kTileZ + H
          : kHA - H + kTileZ - 8 + 16 * kKS;
  static constexpr int kCols = (kNeed + 3) / 4 * 4;
  static constexpr int kPitch = (kCols + 23) / 32 * 32 + 8;
};

template <int H>
using TileArray = float[Tile<H>::kRows][Tile<H>::kPitch];

// Copies the block's tile of p into shared memory (zeros outside the (R, W)
// array) and waits for it.
template <int H>
__device__ __forceinline__ void stage(TileArray<H>& tile,
                                      const float* __restrict__ p, int R,
                                      int W, int x0, int z0) {
  using T = Tile<H>;
  constexpr int kChunks = T::kCols / 4;
  for (int i = threadIdx.x; i < T::kRows * kChunks; i += kThreads) {
    const int rr = i / kChunks;
    const int cc = i - rr * kChunks;
    const int x = x0 - H + rr;
    const int z = z0 - T::kHA + 4 * cc;
    const bool valid = x >= 0 && x < R && z >= 0 && z < W;
    const float* src = valid ? p + static_cast<size_t>(x) * W + z : p;
    pfdc::cp_async16(&tile[rr][4 * cc], src, valid);
  }
  pfdc::cp_async_wait_all();
  __syncthreads();
}

// Whether padded cell (ix, iz) is in the field's Laplacian interior: rows
// and columns [2H, n) of the layout.
template <int H>
__device__ __forceinline__ bool kept(int ix, int iz, int nx, int nz) {
  return ix >= 2 * H && ix < nx && iz >= 2 * H && iz < nz;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    lap_padded(const float* __restrict__ p, float* __restrict__ out, int R,
               int W, int nx, int nz, pfdc::Coefs c) {
  using T = Tile<H>;
  __shared__ __align__(16) TileArray<H> tile;
  const int x0 = blockIdx.y * kTileX;
  const int z0 = blockIdx.x * kTileZ;
  stage<H>(tile, p, R, W, x0, z0);
  const int col = threadIdx.x % kTileZ;
  const int r0 = (threadIdx.x / kTileZ) * (kTileX / 2);
  const int iz = z0 + col;
  const int zc = T::kHA + col;
  // win[i]: tile row r0 + r + i of this column, the x taps of output row
  // r0 + r (its centre is win[H])
  float win[2 * H + 1];
#pragma unroll
  for (int i = 0; i < 2 * H; ++i) win[i] = tile[r0 + i][zc];
#pragma unroll
  for (int r = 0; r < kTileX / 2; ++r) {
    win[2 * H] = tile[r0 + r + 2 * H][zc];
    const float* row = &tile[r0 + r + H][zc];
    float accz = c.z[H] * (row[-H] + row[H]);
#pragma unroll
    for (int k = H - 1; k >= 1; --k) {
      accz = accz + c.z[k] * (row[-k] + row[k]);
    }
    accz = accz + c.z[0] * win[H];
    float accx = c.x[H] * (win[0] + win[2 * H]);
#pragma unroll
    for (int k = H - 1; k >= 1; --k) {
      accx = accx + c.x[k] * (win[H - k] + win[H + k]);
    }
    accx = accx + c.x[0] * win[H];
    const int ix = x0 + r0 + r;
    if (ix < R && iz < W) {
      out[static_cast<size_t>(ix) * W + iz] =
          kept<H>(ix, iz, nx, nz) ? accz + accx : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2 * H; ++i) win[i] = win[i + 1];
  }
}

template <int H, int P>
__global__ void __launch_bounds__(kThreads)
    lap_padded_mma(const float* __restrict__ p, float* __restrict__ out,
                   int R, int W, int nx, int nz, pfdc::Coefs c) {
  using T = Tile<H>;
  __shared__ __align__(16) TileArray<H> tile;
  const int lane = threadIdx.x & 31;
  const int wr = 16 * (threadIdx.x >> 5);   // the warp's first output row
  const pfdc::Band<H, P> band = pfdc::band_fragments<H, P>(c.z, lane);
  const int x0 = blockIdx.y * kTileX;
  const int z0 = blockIdx.x * kTileZ;
  stage<H>(tile, p, R, W, x0, z0);
  const int g = pfdc::frag_g(lane);
  const int t = pfdc::frag_t(lane);
#pragma unroll 1
  for (int n = 0; n < kTileZ / 8; ++n) {
    // outputs at tile columns 8n .. 8n + 7: the window starts H before
    const int wc = T::kHA - H + 8 * n;
    float yz[4];
    pfdc::banded_mma<H, P>(
        yz, [&](int m, int k) { return tile[H + wr + m][wc + k]; }, band,
        lane);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wr + g + 8 * hr;       // output row in the tile
      const int cz = 8 * n + 2 * t;        // first of two output columns
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int zc = T::kHA + cz + e;
        float accx = c.x[H] * (tile[r][zc] + tile[r + 2 * H][zc]);
#pragma unroll
        for (int k = H - 1; k >= 1; --k) {
          accx = accx +
                 c.x[k] * (tile[r + H - k][zc] + tile[r + H + k][zc]);
        }
        accx = accx + c.x[0] * tile[r + H][zc];
        v[e] = kept<H>(x0 + r, z0 + cz + e, nx, nz) ? yz[2 * hr + e] + accx
                                                    : 0.0f;
      }
      const int ix = x0 + r;
      const int iz = z0 + cz;   // even, and W is a multiple of 4
      if (ix < R && iz < W) {
        *reinterpret_cast<float2*>(&out[static_cast<size_t>(ix) * W + iz]) =
            make_float2(v[0], v[1]);
      }
    }
  }
}

struct PaddedRun {
  const float* p;
  float* out;
  int R, W, nx, nz, parts;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    static_assert(sizeof(TileArray<H>) <= 48 * 1024, "static shared memory");
    const dim3 grid((W + kTileZ - 1) / kTileZ, (R + kTileX - 1) / kTileX);
    const dim3 block(kThreads);
    if (parts == 0) {
      lap_padded<H><<<grid, block, 0, stream>>>(p, out, R, W, nx, nz, c);
    } else if (parts == 2) {
      lap_padded_mma<H, 2><<<grid, block, 0, stream>>>(p, out, R, W, nx, nz,
                                                      c);
    } else if (parts == 3) {
      lap_padded_mma<H, 3><<<grid, block, 0, stream>>>(p, out, R, W, nx, nz,
                                                      c);
    } else {
      return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
};

}  // namespace

// One launch of lap_padded (parts = 0) or lap_padded_mma (parts = 2 or 3
// bf16 splits) over the (rows, pitch) padded array p into out, which must
// not overlap p; nx and nz are the field's dims. Returns a cudaError_t.
extern "C" int pfdc_lap_padded_run(const float* p, float* out, int rows,
                                   int pitch, int nx, int nz, int order,
                                   int parts, const float* cx,
                                   const float* cz, void* stream) {
  if (pitch % 4 != 0 || rows != nx + order || pitch < nz + order) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PaddedRun run{p,  out, rows, pitch, nx, nz, parts,
                      pfdc::make_coefs(order / 2, cx, cz),
                      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}
