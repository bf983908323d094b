// lap_apply: the order-2H interior Laplacian (kernel K1) of one (nx, nz)
// field, with a zero border of width H, and the C entry point pfdc_lap_run
// that launches it once on a stream. This is the reference's stencil
// program (cuda_reference_stencil_computation).
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stencil.py,
// _kernel (:60), called through laplacian_pallas (:98). That kernel streams
// halo-extended 2D tiles HBM -> VMEM with a double-buffered DMA, because a
// large field does not fit in VMEM, and zeroes the z border outside the
// kernel. Here one thread computes one output cell, neighbours come
// through L1/L2, and the border is written by the same launch.
//
// What bounds it on an H100: HBM. The field is read once and the result
// written once: at 8192 x 8192 that is 2 x 268 MB, 0.16 ms at 3.35 TB/s,
// against (6H+3) flop per cell, 0.03 ms at 67 TFLOP/s for order 8. The
// 2H+1 taps along x touch rows 2H apart; with 8 rows per block they are
// reread from L2, not HBM. This first version stages nothing in shared
// memory.
//
// Offsets: a row pointer f + ix * nz in size_t, then int offsets within
// the 2H+1 rows around it, so no product of the two dims is formed in int.
#include "stencil.cuh"

namespace {

template <int H>
__global__ void lap_apply(const float* __restrict__ p, float* __restrict__ out,
                          int nx, int nz, pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= nx || iz >= nz) return;
  const size_t row = static_cast<size_t>(ix) * nz;
  out[row + iz] = pfdc::in_interior(ix, iz, H, nx, nz)
                      ? pfdc::laplacian<H, false>(p + row, nullptr, iz, nz, c)
                      : 0.0f;
}

struct LapRun {
  const float* p;
  float* out;
  int nx, nz;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    const dim3 grid = pfdc::step_grid(1, nx, nz);
    const dim3 block = pfdc::step_block();
    lap_apply<H><<<grid, block, 0, stream>>>(p, out, nx, nz, c);
    return cudaGetLastError();
  }
};

}  // namespace

// One launch of lap_apply over the (nx, nz) field p into out. Returns a
// cudaError_t.
extern "C" int pfdc_lap_run(const float* p, float* out, int nx, int nz,
                            int order, const float* cx, const float* cz,
                            void* stream) {
  const LapRun run{p, out, nx, nz, pfdc::make_coefs(order / 2, cx, cz),
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}
