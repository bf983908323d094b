// Shared pieces of the finite-difference step kernels: the coefficient
// struct, the launch shape, and the order-2H Laplacian (kernel K1 of the
// reference, cuda_reference_RTM/src/fd-code.cu:53-78).
//
// Layout: every field is (ns, nxe, nze) float32, z contiguous; the taper
// mask is one (nxe, nze) plane shared by all shots. One thread owns one
// cell of one shot: threadIdx.x runs along z (coalesced), threadIdx.y
// along x, blockIdx.z is the shot.
//
// Rounding: the sources are built with -fmad=false, and the Laplacian sums
// its taps in the JAX package's order (ops/stencil.py:56-73): one
// accumulator per axis, symmetric pairs c[h+k]*(m+p) in descending k, the
// centre tap last, then accz + accx. The plain torch version rounds the
// same way, op by op.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace pfdc {

constexpr int kMaxHalf = 8;  // order 16
constexpr int kBlockZ = 32;
constexpr int kBlockX = 8;

// Premultiplied coefficients, upper half only: x[k] = coefs_x[h + k].
// Passed to the kernels by value.
struct Coefs {
  float x[kMaxHalf + 1];
  float z[kMaxHalf + 1];
};

inline Coefs make_coefs(int h, const float* cx, const float* cz) {
  Coefs c{};
  for (int k = 0; k <= h; ++k) {
    c.x[k] = cx[h + k];
    c.z[k] = cz[h + k];
  }
  return c;
}

inline dim3 step_grid(int ns, int nxe, int nze) {
  return dim3((nze + kBlockZ - 1) / kBlockZ, (nxe + kBlockX - 1) / kBlockX,
              ns);
}

inline dim3 step_block() { return dim3(kBlockZ, kBlockX, 1); }

// Field value at in-plane index q; with kTapered, the taper mask is
// applied on read (m[q] * f[q]) so that the stored field stays untapered.
template <bool kTapered>
__device__ __forceinline__ float tap(const float* __restrict__ f,
                                     const float* __restrict__ m, int q) {
  return kTapered ? m[q] * f[q] : f[q];
}

// Laplacian at interior cell j = ix * nze + iz of one shot's field f
// (h <= ix < nxe - h, h <= iz < nze - h; the caller checks).
template <int H, bool kTapered>
__device__ __forceinline__ float laplacian(const float* __restrict__ f,
                                           const float* __restrict__ m, int j,
                                           int nze, const Coefs& c) {
  const float centre = tap<kTapered>(f, m, j);
  float accz = c.z[H] * (tap<kTapered>(f, m, j - H) + tap<kTapered>(f, m, j + H));
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accz = accz + c.z[k] * (tap<kTapered>(f, m, j - k) + tap<kTapered>(f, m, j + k));
  }
  accz = accz + c.z[0] * centre;
  float accx = c.x[H] * (tap<kTapered>(f, m, j - H * nze) +
                         tap<kTapered>(f, m, j + H * nze));
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accx = accx + c.x[k] * (tap<kTapered>(f, m, j - k * nze) +
                            tap<kTapered>(f, m, j + k * nze));
  }
  accx = accx + c.x[0] * centre;
  return accz + accx;
}

// The same Laplacian of the taps f(dx, dz), the field at offset (dx, dz)
// from the cell, in the same order: for a taper that is not a plane
// (gpu_step.cu). The per-step kernels keep the form above: routed through
// this one, rtm_bwd_step was not shown to keep its speed (PERF.md, PR 3).
template <int H, class Tap>
__device__ __forceinline__ float laplacian_taps(Tap&& f, const Coefs& c) {
  const float centre = f(0, 0);
  float accz = c.z[H] * (f(0, -H) + f(0, H));
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accz = accz + c.z[k] * (f(0, -k) + f(0, k));
  }
  accz = accz + c.z[0] * centre;
  float accx = c.x[H] * (f(-H, 0) + f(H, 0));
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accx = accx + c.x[k] * (f(-k, 0) + f(k, 0));
  }
  accx = accx + c.x[0] * centre;
  return accz + accx;
}

__device__ __forceinline__ bool in_interior(int ix, int iz, int h, int nxe,
                                            int nze) {
  return ix >= h && ix < nxe - h && iz >= h && iz < nze - h;
}

// Calls f.template operator()<H>() for H = order / 2 in 1..kMaxHalf.
template <class F>
cudaError_t dispatch_half(int order, F&& f) {
  switch (order / 2) {
    case 1: return f.template operator()<1>();
    case 2: return f.template operator()<2>();
    case 3: return f.template operator()<3>();
    case 4: return f.template operator()<4>();
    case 5: return f.template operator()<5>();
    case 6: return f.template operator()<6>();
    case 7: return f.template operator()<7>();
    case 8: return f.template operator()<8>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pfdc
