// kstep_gpu_fwd: K steps of the GPU suite's forward propagation (fd_forward,
// cuda_reference_RTM/src/fd-code.cu:247-288) in one pass over the grid, for
// every shot of a batch, and the C entry points pfdc_kstep_gpu_fwd_run and
// pfdc_kstep_gpu_fwd_mma_run that launch one pass.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kstep_gpu_fwd_kernel (:740), called through fd_kstep_gpu_fwd_padded
// (:796) by the JAX package's rtm_shot_snapshot_tiled with block_k > 1:
// kstep_gpu_fwd_strip<H> its exact taps, kstep_gpu_fwd_mma<H, 2 or 3> its
// use_mxu branch (:753-761), the z taps in split bf16 on the tensor cores.
//
// Both run the one-field strip body of fwd_strip.cuh on a block's tile of
// 64 x 64 owned cells (a smaller shape where the halo leaves that no
// room). The exact kernel stages the field at two time levels and the x
// ramp, 74.1 KB at order 8, K = 4, two blocks of 16 warps an SM. The split
// kernel (Split::kZ) stages the z product of the newest field too, on rows
// padded to 4 mod 8 floats (115.6 KB at order 8, K = 4, two blocks an SM),
// and keeps the x taps exact from the strip's register window. On the
// Pluto grid 48 x 64, 32 x 96 and 64 x 96 ran 9-17 % slower, and
// __launch_bounds__(512, 1) 27 % slower (PERF.md), though at order 16 and
// P = 3 the 64 registers of two blocks an SM spill 8 bytes.
//
// What bounds it on an H100: at the Pluto grid the per-step rtm_fwd_step
// moves ~180 MB a shot-step through HBM; this pass reads p, pp and v2*dt2
// and writes p, pp once per K steps, and rebuilds the top-strip taper from
// its ramps. What is left is shared-memory and ALU work, with the halo
// cells computed redundantly.
//
// Per step, from the state (p, pp) with p tapered and pp not: t = pp*m,
// u = (2t - p*m) + v*lap(t), u += amp at the source cell; the next state
// is (t, u). These are rtm_fwd_step's operations in its order (its taper
// on read rounds the same), so with -fmad=false the exact kernel is
// bitwise the per-step kernel; the split one sums each mma's 16 products
// in the tensor cores' own order.
#include "fwd_strip.cuh"

namespace {

// The kernels' site (fwd_strip.cuh): one shot's fields on the (nxe, nze)
// grid, pp the newest level and p the older, every cell of which holds a
// value; the point source at (src_x, sz); no trace.
struct KstepFwdSite {
  static constexpr bool kGpu = true;
  const float* cur;
  const float* old;
  float* cur_out;
  float* old_out;
  const float* v2dt2;
  const float* xramp;
  const float* zfac;
  const float* strip;
  int src_x, sz, nxf, nzf;

  __device__ float v(int gx, int gz) const {
    return __ldg(v2dt2 + static_cast<size_t>(gx) * nzf + gz);
  }
  __device__ float inject(float amp, int gx, int gz, float u) const {
    return gx == src_x && gz == sz ? u + amp : u;
  }
  __device__ bool records(int, int) const { return false; }
  __device__ void record(int, int, float) const {}
  __device__ bool held(int, int) const { return true; }
  __device__ bool stored(int, int) const { return true; }
};

// One pass of the kernel with the taps exact (P = 0) or the z taps in P
// bf16 parts.
template <int H, int P>
__device__ __forceinline__ void kstep_gpu_fwd_pass(
    float* smem, const float* __restrict__ p_in,
    const float* __restrict__ pp_in, float* __restrict__ p_out,
    float* __restrict__ pp_out, const float* __restrict__ v2dt2,
    int v2_shot_stride, const float* __restrict__ xramp,
    const float* __restrict__ zfac, const float* __restrict__ strip,
    const int* __restrict__ sx, int sz, const pfdc::Amps& amps, int k_steps,
    int nxe, int nze, pfdc::StripShape shape, const pfdc::Coefs& c) {
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const KstepFwdSite site{
      pp_in + s * plane, p_in + s * plane, pp_out + s * plane,
      p_out + s * plane, v2dt2 + s * static_cast<size_t>(v2_shot_stride),
      xramp, zfac, strip, sx[s], sz, nxe, nze};
  const pfdc::StripTile t(k_steps * H, shape,
                          static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::fwd_strip<H, P, pfdc::Split::kZ>(smem, site, t, amps, k_steps, c);
}

template <int H>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    kstep_gpu_fwd_strip(const float* __restrict__ p_in,
                        const float* __restrict__ pp_in,
                        float* __restrict__ p_out,
                        float* __restrict__ pp_out,
                        const float* __restrict__ v2dt2, int v2_shot_stride,
                        const float* __restrict__ xramp,
                        const float* __restrict__ zfac,
                        const float* __restrict__ strip,
                        const int* __restrict__ sx, int sz, pfdc::Amps amps,
                        int k_steps, int nxe, int nze,
                        pfdc::StripShape shape, pfdc::Coefs c) {
  extern __shared__ float smem[];
  kstep_gpu_fwd_pass<H, 0>(smem, p_in, pp_in, p_out, pp_out, v2dt2,
                           v2_shot_stride, xramp, zfac, strip, sx, sz, amps,
                           k_steps, nxe, nze, shape, c);
}

// The split twin (P = 2, 3): the same pass with the z taps in bf16 parts.
template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    kstep_gpu_fwd_mma(const float* __restrict__ p_in,
                      const float* __restrict__ pp_in,
                      float* __restrict__ p_out,
                      float* __restrict__ pp_out,
                      const float* __restrict__ v2dt2, int v2_shot_stride,
                      const float* __restrict__ xramp,
                      const float* __restrict__ zfac,
                      const float* __restrict__ strip,
                      const int* __restrict__ sx, int sz, pfdc::Amps amps,
                      int k_steps, int nxe, int nze, pfdc::StripShape shape,
                      pfdc::Coefs c) {
  static_assert(P > 0, "kstep_gpu_fwd_strip is the exact kernel");
  extern __shared__ float smem[];
  kstep_gpu_fwd_pass<H, P>(smem, p_in, pp_in, p_out, pp_out, v2dt2,
                           v2_shot_stride, xramp, zfac, strip, sx, sz, amps,
                           k_steps, nxe, nze, shape, c);
}

// The kernel at P.
template <int H, int P>
auto fwd_kernel() {
  if constexpr (P == 0) {
    return kstep_gpu_fwd_strip<H>;
  } else {
    return kstep_gpu_fwd_mma<H, P>;
  }
}

struct KstepFwdRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  const float* v2dt2;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const int* sx;
  int sz;
  pfdc::Amps amps;
  int k, ns, nxe, nze;
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
    const auto kernel = fwd_kernel<H, P>();
    const cudaError_t e = pfdc::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
    const dim3 block(pfdc::kStripThreads);
    kernel<<<grid, block, bytes, stream>>>(
        p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp, zfac, strip, sx,
        sz, amps, k, nxe, nze, shape, c);
    return cudaGetLastError();
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

int kstep_gpu_fwd_run(const float* p, const float* pp, float* p_out,
                      float* pp_out, const float* v2dt2, int v2_shot_stride,
                      const float* xramp, const float* zfac,
                      const float* strip, const int* sx, int sz,
                      const float* amps, int k, int ns, int nxe, int nze,
                      int order, int parts, const float* cx, const float* cz,
                      void* stream) {
  if (k < 1 || k > pfdc::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KstepFwdRun run{p,     pp,   p_out, pp_out, v2dt2, v2_shot_stride,
                        xramp, zfac, strip, sx,     sz,
                        pfdc::make_amps(amps, k), k, ns, nxe, nze,
                        pfdc::make_coefs(order / 2, cx, cz), parts,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs one pass of k steps (1 <= k <= 8) of kstep_gpu_fwd from the state
// (p, pp) into (p_out, pp_out), all (ns, nxe, nze). amps is a host array of
// k samples. Returns a cudaError_t.
extern "C" int pfdc_kstep_gpu_fwd_run(const float* p, const float* pp,
                                      float* p_out, float* pp_out,
                                      const float* v2dt2, int v2_shot_stride,
                                      const float* xramp, const float* zfac,
                                      const float* strip, const int* sx,
                                      int sz, const float* amps, int k,
                                      int ns, int nxe, int nze, int order,
                                      const float* cx, const float* cz,
                                      void* stream) {
  return kstep_gpu_fwd_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride,
                           xramp, zfac, strip, sx, sz, amps, k, ns, nxe, nze,
                           order, 0, cx, cz, stream);
}

// The same pass with the z taps in parts (2 or 3) bf16 splits:
// kstep_gpu_fwd_mma.
extern "C" int pfdc_kstep_gpu_fwd_mma_run(
    const float* p, const float* pp, float* p_out, float* pp_out,
    const float* v2dt2, int v2_shot_stride, const float* xramp,
    const float* zfac, const float* strip, const int* sx, int sz,
    const float* amps, int k, int ns, int nxe, int nze, int order, int parts,
    const float* cx, const float* cz, void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kstep_gpu_fwd_run(p, pp, p_out, pp_out, v2dt2, v2_shot_stride,
                           xramp, zfac, strip, sx, sz, amps, k, ns, nxe, nze,
                           order, parts, cx, cz, stream);
}
