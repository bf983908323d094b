// kstep_mod: K forward-modeling steps (mod_main's loop, mod_main.cpp:
// 146-168) in one pass over the grid, for every shot of a batch, and the C
// entry points pfdc_kstep_mod_run and pfdc_kstep_mod_mma_run that launch
// one pass.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kstep_kernel (:574), called through fd_kstep_padded (:650) by the JAX
// package's forward_modeling_tiled with block_k > 1: kstep_mod_strip<H>
// its exact taps, kstep_mod_mma<H, 2 or 3> its use_mxu branch (:600-608),
// the z taps in split bf16 on the tensor cores. That kernel streams
// full-width row slabs through VMEM; here a block stages a 2-D tile with a
// K*H halo on both axes in shared memory.
//
// Both run the one-field strip body of fwd_strip.cuh on a block's tile of
// 64 x 64 owned cells (a smaller shape where the halo leaves that no
// room). The exact kernel stages the field at two time levels and the x
// ramp, 74.1 KB at order 8, K = 4, two blocks of 16 warps an SM. The split
// kernel (Split::kZ) stages the z product of p too, on rows padded to 4
// mod 8 floats (115.6 KB at order 8, K = 4, two blocks an SM), and keeps
// the x taps exact from the strip's register window. On the Pluto grid
// 48 x 64, 32 x 96 and 64 x 96 ran 8-13 % slower (PERF.md).
//
// What bounds it on an H100: at the Pluto grid (7040 x 1281, 36 MB a field)
// the per-step mod_step moves ~180 MB a shot-step through HBM; this pass
// reads p, pp and v2*dt2 once and writes p, pp once per K steps, and
// rebuilds the taper from its ramps instead of reading the mask plane. What
// is left is shared-memory and ALU work, with the halo cells computed
// redundantly.
//
// Per step, from the state (p, pp) with pp tapered (the plain version's
// state): u = (2p - pp) + v*lap(p); u += amp * patch around the source;
// pp' = u * m; p' = p * m, whose row gz is the step's trace. The operations
// and their order are mod_step's, so with -fmad=false the exact kernel is
// bitwise the per-step kernel; the split one sums each mma's 16 products in
// the tensor cores' own order.
#include "fwd_strip.cuh"

namespace {

// The kernels' site (fwd_strip.cuh): one shot's fields on the (nxe, nze)
// grid, p the newest level and pp the older, every cell of which holds a
// value; the source window's patch added around (src_x, sz); the trace row
// at depth gz_rec on the interior's columns.
struct KstepModSite {
  static constexpr bool kGpu = false;
  const float* cur;
  const float* old;
  float* cur_out;
  float* old_out;
  const float* v2dt2;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* patch;
  float* rec;
  int r, src_x, sz, gz_rec, nxb, nx, nxf, nzf;

  __device__ float v(int gx, int gz) const {
    return __ldg(v2dt2 + static_cast<size_t>(gx) * nzf + gz);
  }
  __device__ float inject(float amp, int gx, int gz, float u) const {
    const int dx = gx - src_x;
    const int dz = gz - sz;
    return dx >= -r && dx <= r && dz >= -r && dz <= r
               ? u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)]
               : u;
  }
  __device__ bool records(int gx, int gz) const {
    return gz == gz_rec && gx >= nxb && gx < nxb + nx;
  }
  __device__ void record(int k, int gx, float q) const {
    rec[static_cast<size_t>(k) * nx + (gx - nxb)] = q;
  }
  __device__ bool held(int, int) const { return true; }
  __device__ bool stored(int, int) const { return true; }
};

// One pass of the kernel with the taps exact (P = 0) or the z taps in P
// bf16 parts.
template <int H, int P>
__device__ __forceinline__ void kstep_mod_pass(
    float* smem, const float* __restrict__ p_in,
    const float* __restrict__ pp_in, float* __restrict__ p_out,
    float* __restrict__ pp_out, const float* __restrict__ v2dt2,
    int v2_shot_stride, const float* __restrict__ xramp,
    const float* __restrict__ zfac, const float* __restrict__ strip,
    const float* __restrict__ patch, int r, const int* __restrict__ sx,
    int sz, int gz_rec, const pfdc::Amps& amps, int k_steps,
    float* __restrict__ rec, int nxb, int nx, int nxe, int nze,
    pfdc::StripShape shape, const pfdc::Coefs& c) {
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const KstepModSite site{
      p_in + s * plane, pp_in + s * plane, p_out + s * plane,
      pp_out + s * plane, v2dt2 + s * static_cast<size_t>(v2_shot_stride),
      xramp, zfac, strip, patch, rec + s * static_cast<size_t>(k_steps) * nx,
      r, sx[s], sz, gz_rec, nxb, nx, nxe, nze};
  const pfdc::StripTile t(k_steps * H, shape,
                          static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::fwd_strip<H, P, pfdc::Split::kZ>(smem, site, t, amps, k_steps, c);
}

template <int H>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    kstep_mod_strip(const float* __restrict__ p_in,
                    const float* __restrict__ pp_in,
                    float* __restrict__ p_out, float* __restrict__ pp_out,
                    const float* __restrict__ v2dt2, int v2_shot_stride,
                    const float* __restrict__ xramp,
                    const float* __restrict__ zfac,
                    const float* __restrict__ strip,
                    const float* __restrict__ patch, int r,
                    const int* __restrict__ sx, int sz, int gz_rec,
                    pfdc::Amps amps, int k_steps, float* __restrict__ rec,
                    int nxb, int nx, int nxe, int nze,
                    pfdc::StripShape shape, pfdc::Coefs c) {
  extern __shared__ float smem[];
  kstep_mod_pass<H, 0>(smem, p_in, pp_in, p_out, pp_out, v2dt2,
                       v2_shot_stride, xramp, zfac, strip, patch, r, sx, sz,
                       gz_rec, amps, k_steps, rec, nxb, nx, nxe, nze, shape,
                       c);
}

// The split twin (P = 2, 3): the same pass with the z taps in bf16 parts.
template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    kstep_mod_mma(const float* __restrict__ p_in,
                  const float* __restrict__ pp_in,
                  float* __restrict__ p_out, float* __restrict__ pp_out,
                  const float* __restrict__ v2dt2, int v2_shot_stride,
                  const float* __restrict__ xramp,
                  const float* __restrict__ zfac,
                  const float* __restrict__ strip,
                  const float* __restrict__ patch, int r,
                  const int* __restrict__ sx, int sz, int gz_rec,
                  pfdc::Amps amps, int k_steps, float* __restrict__ rec,
                  int nxb, int nx, int nxe, int nze, pfdc::StripShape shape,
                  pfdc::Coefs c) {
  static_assert(P > 0, "kstep_mod_strip is the exact kernel");
  extern __shared__ float smem[];
  kstep_mod_pass<H, P>(smem, p_in, pp_in, p_out, pp_out, v2dt2,
                       v2_shot_stride, xramp, zfac, strip, patch, r, sx, sz,
                       gz_rec, amps, k_steps, rec, nxb, nx, nxe, nze, shape,
                       c);
}

// The kernel at P.
template <int H, int P>
auto mod_kernel() {
  if constexpr (P == 0) {
    return kstep_mod_strip<H>;
  } else {
    return kstep_mod_mma<H, P>;
  }
}

struct KstepModRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  const float* v2dt2;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* patch;
  int r;
  const int* sx;
  int sz, gz;
  pfdc::Amps amps;
  int k;
  float* rec;
  int ns, nxe, nze, nxb, nx;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t launch() const {
    const pfdc::StripStage stage = P ? pfdc::kFwdMmaStage : pfdc::kFwdStage;
    const pfdc::StripShape shape =
        pfdc::strip_shape(pfdc::kFwdShapes, stage, k * H);
    if (shape.tx == 0) return cudaErrorInvalidValue;
    const size_t bytes = pfdc::strip_bytes(shape, stage, k * H);
    const auto kernel = mod_kernel<H, P>();
    const cudaError_t e = pfdc::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
    const dim3 block(pfdc::kStripThreads);
    kernel<<<grid, block, bytes, stream>>>(
        p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp, zfac, strip,
        patch, r, sx, sz, gz, amps, k, rec, nxb, nx, nxe, nze, shape, c);
    return cudaGetLastError();
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

int kstep_mod_run(const float* p, const float* pp, float* p_out,
                  float* pp_out, const float* v2dt2, int v2_shot_stride,
                  const float* xramp, const float* zfac, const float* strip,
                  const float* patch, int r, const int* sx, int sz, int gz,
                  const float* amps, int k, float* rec, int ns, int nxe,
                  int nze, int nxb, int order, int parts, const float* cx,
                  const float* cz, void* stream) {
  if (k < 1 || k > pfdc::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KstepModRun run{p,     pp,    p_out, pp_out, v2dt2, v2_shot_stride,
                        xramp, zfac,  strip, patch,  r,     sx,
                        sz,    gz,    pfdc::make_amps(amps, k),
                        k,     rec,   ns,    nxe,    nze,   nxb,
                        nxe - 2 * nxb, pfdc::make_coefs(order / 2, cx, cz),
                        parts, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs one pass of k steps (1 <= k <= 8) of kstep_mod from the state
// (p, pp) into (p_out, pp_out), all (ns, nxe, nze), and writes the k traces
// of each shot to rec (ns, k, nx). amps is a host array of k samples.
// Returns a cudaError_t.
extern "C" int pfdc_kstep_mod_run(const float* p, const float* pp,
                                  float* p_out, float* pp_out,
                                  const float* v2dt2, int v2_shot_stride,
                                  const float* xramp, const float* zfac,
                                  const float* strip, const float* patch,
                                  int r, const int* sx, int sz, int gz,
                                  const float* amps, int k, float* rec,
                                  int ns, int nxe, int nze, int nxb,
                                  int order, const float* cx,
                                  const float* cz, void* stream) {
  return kstep_mod_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp,
                       zfac, strip, patch, r, sx, sz, gz, amps, k, rec, ns,
                       nxe, nze, nxb, order, 0, cx, cz, stream);
}

// The same pass with the z taps in parts (2 or 3) bf16 splits: kstep_mod_mma.
extern "C" int pfdc_kstep_mod_mma_run(const float* p, const float* pp,
                                      float* p_out, float* pp_out,
                                      const float* v2dt2, int v2_shot_stride,
                                      const float* xramp, const float* zfac,
                                      const float* strip, const float* patch,
                                      int r, const int* sx, int sz, int gz,
                                      const float* amps, int k, float* rec,
                                      int ns, int nxe, int nze, int nxb,
                                      int order, int parts, const float* cx,
                                      const float* cz, void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kstep_mod_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp,
                       zfac, strip, patch, r, sx, sz, gz, amps, k, rec, ns,
                       nxe, nze, nxb, order, parts, cx, cz, stream);
}
