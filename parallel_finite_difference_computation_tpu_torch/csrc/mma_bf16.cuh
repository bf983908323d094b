// The split-bf16 banded product on Hopper's tensor cores: one axis's
// Laplacian taps as the JAX package's multi-pass bf16 matrix-unit tiers
// compute them (ops/pallas_fd.py _make_lap :260-334, ops/pallas_stencil.py
// _kernel_padded_mxu :429, mm3 :335, mm_banded :346), shared by the
// lap_padded_mma kernel (lap_padded.cu) and the *_step_mma kernels
// (step_mma.cu). The plain version is ops/banded.py.
//
// A warp computes a 16 x 8 block Y[m][n] = sum_k A[m][k] * B[k][n], where
// row m of A is a window of 16 * KS field values along the contracted axis
// and B is the band B[k][n] = c[k - n] (0 <= k - n <= 2h, else 0), the
// (2h+1,) coefficients: output n of row m is the (2h+1)-tap sum centred on
// window position n + h. The field is split in registers into P bf16
// residuals a_0 + a_1 + ... (each residual formed in float32), the band
// likewise coefficient by coefficient; every cross term a_i . S_j with
// i + j < P (3 terms for P = 2, the JAX "mxu"; 6 for P = 3, "mxu6") is
// its own float32 accumulator, carried over the KS k-steps, and the terms
// are added in the JAX order (mm3: (a0S0 + a0S1) + a1S0; mm_banded: the
// deepest split level first). One accumulator carried through all passes
// would round otherwise than the TPU kernel.
//
// The band fragments are the same for every tile: each thread builds its
// share once (band_fragments). The one tensor-core instruction is
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (sm_80 and later),
// behind mma_bf16_16816 alone. Built with PFDC_CPU_SHIM defined, that
// function and the cp.async helpers call the host stand-ins a CPU
// emulation provides instead (pfdc_shim_mma follows the PTX fragment
// layout with a scalar loop), so that the fragment indexing can be checked
// without a card.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#ifdef PFDC_CPU_SHIM
void pfdc_shim_mma(float (&d)[4], const uint32_t (&a)[4],
                   const uint32_t (&b)[2]);
void pfdc_shim_cp_async16(void* dst, const void* src, bool valid);
void pfdc_shim_cp_async4(void* dst, const void* src, bool valid);
#endif

namespace pfdc {

// Fragment rows and columns of one lane: groupID and threadID_in_group.
__device__ __forceinline__ int frag_g(int lane) { return lane >> 2; }
__device__ __forceinline__ int frag_t(int lane) { return lane & 3; }

// k-steps of 16 for a window of 8 outputs and their 2H halo.
template <int H>
__host__ __device__ constexpr int band_ksteps() {
  return (8 + 2 * H + 15) / 16;
}

// Cross terms (i, j) of a P-part product in the order they are added.
__host__ __device__ constexpr int n_terms(int P) { return P == 2 ? 3 : 6; }
__host__ __device__ constexpr int term_i(int P, int n) {
  return P == 2 ? (n == 2 ? 1 : 0)
                : (n == 0 ? 2 : (n == 1 || n == 3 ? 1 : 0));
}
__host__ __device__ constexpr int term_j(int P, int n) {
  return P == 2 ? (n == 1 ? 1 : 0)
                : (n == 1 || n == 4 ? 1 : (n == 2 ? 2 : 0));
}

// The P bf16 residual splits of a, hi first.
template <int P>
__device__ __forceinline__ void split_bf16(float a, __nv_bfloat16 (&s)[P]) {
  float r = a;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    s[i] = __float2bfloat16_rn(r);
    r = r - __bfloat162float(s[i]);
  }
}

// Two bf16 values in one 32-bit register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D += A B, m16n8k16, bf16 operands, float32 accumulate. A: 4 registers of
// two bf16 (rows g, g+8 x columns 2t, 2t+1, then the same +8 columns);
// B: 2 registers (rows 2t, 2t+1 and 2t+8, 2t+9 of column g); D: rows g,
// g+8 x columns 2t, 2t+1 (PTX ISA, "Matrix Fragments for mma.m16n8k16").
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
#ifdef PFDC_CPU_SHIM
  pfdc_shim_mma(d, a, b);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// This lane's B fragments of the band, for every split level j and k-step:
// B[k][n] = c_full[k - n], with c_full[i] = half[|i - H|] for 0 <= i <= 2H
// (the coefficients are symmetric; half[k] = coefs[H + k]) and 0 elsewhere.
template <int H, int P>
struct Band {
  uint32_t b[P][band_ksteps<H>()][2];
};

template <int H, int P>
__device__ __forceinline__ Band<H, P> band_fragments(const float* half,
                                                     int lane) {
  const int g = frag_g(lane), t = frag_t(lane);
  Band<H, P> band;
#pragma unroll
  for (int ks = 0; ks < band_ksteps<H>(); ++ks) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16 s[2][P];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 16 * ks + 2 * t + 8 * r + e - g;
        const float c =
            (i >= 0 && i <= 2 * H) ? half[i >= H ? i - H : H - i] : 0.0f;
        split_bf16<P>(c, s[e]);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        band.b[j][ks][r] = pack_bf16(s[0][j], s[1][j]);
      }
    }
  }
  return band;
}

// One warp's 16 x 8 banded block: y[q] for q = 0, 1 (row g, columns 2t,
// 2t+1) and q = 2, 3 (row g + 8). a(m, k) is the field value at row m
// (0..15) and window position k (0..16*KS-1); every value read must be
// finite, the band's zeros included.
template <int H, int P, class A>
__device__ __forceinline__ void banded_mma(float (&y)[4], A&& a,
                                           const Band<H, P>& band,
                                           int lane) {
  const int g = frag_g(lane), t = frag_t(lane);
  constexpr int kTerms = n_terms(P);
  float acc[kTerms][4];
#pragma unroll
  for (int n = 0; n < kTerms; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < band_ksteps<H>(); ++ks) {
    uint32_t af[P][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = g + 8 * (q & 1);
      const int k = 16 * ks + 2 * t + 8 * (q >> 1);
      __nv_bfloat16 lo[P], hi[P];
      split_bf16<P>(a(m, k), lo);
      split_bf16<P>(a(m, k + 1), hi);
#pragma unroll
      for (int i = 0; i < P; ++i) af[i][q] = pack_bf16(lo[i], hi[i]);
    }
#pragma unroll
    for (int n = 0; n < kTerms; ++n) {
      mma_bf16_16816(acc[n], af[term_i(P, n)], band.b[term_j(P, n)][ks]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = acc[0][q];
#pragma unroll
    for (int n = 1; n < kTerms; ++n) s = s + acc[n][q];
    y[q] = s;
  }
}

// 16 bytes from global to shared memory without a register, or 16 zero
// bytes where !valid (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
#ifdef PFDC_CPU_SHIM
  pfdc_shim_cp_async16(dst, src, valid);
#else
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
#endif
}

// 4 bytes from global to shared memory without a register, or 4 zero
// bytes where !valid (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
#ifdef PFDC_CPU_SHIM
  pfdc_shim_cp_async4(dst, src, valid);
#else
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
#endif
}

// Waits for every cp_async16 and cp_async4 of this thread; a
// __syncthreads() must follow before other threads read the tile.
__device__ __forceinline__ void cp_async_wait_all() {
#ifndef PFDC_CPU_SHIM
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

}  // namespace pfdc
