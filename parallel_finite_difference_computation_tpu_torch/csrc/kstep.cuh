// Shared pieces of the temporal-blocking kernels of the large-grid tier
// (kstep_mod.cu, kstep_gpu_fwd.cu, kstep_gpu_bwd.cu) and of the kernels
// that reuse them (the strip bodies of strip.cuh, fwd_strip.cuh,
// bwd_strip.cuh and step_strip.cuh; domain_block.cuh; rtm_bwd_step_mma of
// step_mma.cu): the step limit of a pass and the wavelet samples it takes,
// a block's shared-memory limit, the taper rebuilt from its 1-D ramps, one
// axis's exact taps, the band fragments of a split axis, and the dispatch
// on the split's bf16 parts P (P = 0: the exact kernel; P = 2 (3): the
// 3-pass (6-pass) split-bf16 banded product on the tensor cores,
// mma_bf16.cuh).
#pragma once

#include <type_traits>

#include "mma_bf16.cuh"
#include "stencil.cuh"

namespace pfdc {

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

// Sets the kernel's dynamic shared memory limit to bytes, or refuses a
// tile that does not fit a block.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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

// Calls run.template launch<H, P>() for the P = parts (0, 2 or 3) of a
// kernel with a split twin.
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
