// kstep_gpu_bwd: K steps of the GPU suite's backward propagation and
// imaging (fd_back, cuda_reference_RTM/src/fd-code.cu:290-341, it >= 2) in
// one pass over the grid, for every shot of a batch, and the C entry points
// pfdc_kstep_gpu_bwd_run and pfdc_kstep_gpu_bwd_mma_run that launch one
// pass.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kstep_gpu_bwd_kernel (:857), called through fd_kstep_gpu_bwd_padded
// (:932) by the JAX package's rtm_shot_snapshot_tiled with block_k > 1:
// kstep_gpu_bwd_strip<H> its exact taps, kstep_gpu_bwd_mma<H, 2 or 3> its
// use_mxu branch (:875-883), the z taps of both Laplacians in split bf16
// on the tensor cores.
//
// Both run the strip body of bwd_strip.cuh on a block's tile with a K*H
// halo. The exact kernel stages four fields, the owned image and the x
// ramp on 32 x 64 owned cells (a smaller shape where the halo leaves that
// no room), 107 KB at order 8 and K = 4, so two blocks share an SM. The
// split kernel (Split::kZ) stages the z products of the source and the
// receiver field too, on rows padded to 4 mod 8 floats, on 32 x 96 owned
// cells first (215 KB at order 8 and K = 4, one block an SM; on 32 x 64,
// at the tile's pitch of 96 floats, the product's 8-way bank conflicts
// made it 19 % slower on the card), and keeps the x taps exact from the
// strip's register window; the staged-tile body it replaces staged
// v2*dt2 as well, with dependent loads, a taper phase and its barrier
// every step, and a Laplacian that read 2H + 1 x taps from shared
// memory.
//
// What bounds it on an H100: at the Pluto grid the per-step rtm_bwd_step
// moves ~340 MB a shot-step through HBM; this pass reads four fields,
// v2*dt2, the K trace rows and the image once and writes them once per K
// steps. What is left is shared-memory and ALU work: two Laplacians a cell
// and step, with the halo cells computed redundantly.
//
// Per step, from the state (ps, pps, pr, ppr, img) with ppr tapered: the
// source s = (2ps - pps) + v*lap(ps), untapered; the receiver t = pr*m,
// u = (2t - ppr*m) + v*lap(t), plus the trace row at depth gz (K5, into
// every computed cell of the row, halo included); img += s*u on the owned
// interior cells (K6), summed in time order. These are rtm_bwd_step's
// operations in its order, so with -fmad=false the exact kernel is
// bitwise the per-step kernel; the split one sums each mma's 16 products
// in the tensor cores' own order.
#include "bwd_strip.cuh"

namespace {

// The kernels' site (bwd_strip.cuh): one shot's fields on the (nxe, nze)
// grid, every cell of which holds a value; the image is the interior's,
// summed from its running value; the trace row is injected on the
// receiver row's interior cells.
struct KstepBwdSite {
  const float* ps;
  const float* pps;
  const float* pr;
  const float* ppr;
  float* ps_out;
  float* pps_out;
  float* pr_out;
  float* ppr_out;
  float* img;
  const float* v2dt2;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* inj;
  int gz_rec, nxb, nzb, nx, nz, nxf, nzf;

  __device__ float v(int gx, int gz) const {
    return __ldg(v2dt2 + static_cast<size_t>(gx) * nzf + gz);
  }
  __device__ bool held(int, int) const { return true; }
  __device__ bool seeded(int) const { return false; }
  __device__ float snapshot(int, int, int) const { return 0.0f; }
  __device__ float inject(int k, int gx, int gz, float u) const {
    return gz == gz_rec && gx >= nxb && gx < nxb + nx
               ? u + inj[static_cast<size_t>(k) * nx + (gx - nxb)]
               : u;
  }
  __device__ bool imaged(int gx, int gz) const {
    return gx >= nxb && gx < nxb + nx && gz >= nzb && gz < nzb + nz;
  }
  __device__ bool stored(int, int) const { return true; }
  __device__ float& image_at(int gx, int gz) const {
    return img[static_cast<size_t>(gx - nxb) * nz + (gz - nzb)];
  }
  __device__ float image_start(int gx, int gz) const {
    return imaged(gx, gz) ? image_at(gx, gz) : 0.0f;
  }
  __device__ void image_end(int gx, int gz, float acc) const {
    image_at(gx, gz) = acc;
  }
};

// One pass of the kernel with the taps exact (P = 0) or the z taps in P
// bf16 parts.
template <int H, int P>
__device__ __forceinline__ void kstep_gpu_bwd_pass(
    float* smem, const float* __restrict__ ps_in,
    const float* __restrict__ pps_in, const float* __restrict__ pr_in,
    const float* __restrict__ ppr_in, float* __restrict__ ps_out,
    float* __restrict__ pps_out, float* __restrict__ pr_out,
    float* __restrict__ ppr_out, float* __restrict__ img,
    const float* __restrict__ v2dt2, int v2_shot_stride,
    const float* __restrict__ xramp, const float* __restrict__ zfac,
    const float* __restrict__ strip, const float* __restrict__ inj,
    int inj_shot_stride, int gz_rec, int k_steps, int nxb, int nzb, int nx,
    int nz, int nxe, int nze, pfdc::StripShape shape, const pfdc::Coefs& c) {
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const KstepBwdSite site{
      ps_in + s * plane,    pps_in + s * plane,  pr_in + s * plane,
      ppr_in + s * plane,   ps_out + s * plane,  pps_out + s * plane,
      pr_out + s * plane,   ppr_out + s * plane,
      img + s * static_cast<size_t>(nx) * nz,
      v2dt2 + s * static_cast<size_t>(v2_shot_stride), xramp, zfac, strip,
      inj + s * static_cast<size_t>(inj_shot_stride), gz_rec, nxb, nzb, nx,
      nz, nxe, nze};
  const pfdc::StripTile t(k_steps * H, shape,
                          static_cast<int>(blockIdx.y) * shape.tx,
                          static_cast<int>(blockIdx.x) * shape.tz);
  pfdc::bwd_strip<H, P, pfdc::Split::kZ>(smem, site, t, 0, k_steps, c);
}

template <int H>
__global__ void __launch_bounds__(pfdc::kStripThreads, pfdc::kStripBlocks)
    kstep_gpu_bwd_strip(const float* __restrict__ ps_in,
                        const float* __restrict__ pps_in,
                        const float* __restrict__ pr_in,
                        const float* __restrict__ ppr_in,
                        float* __restrict__ ps_out,
                        float* __restrict__ pps_out,
                        float* __restrict__ pr_out,
                        float* __restrict__ ppr_out, float* __restrict__ img,
                        const float* __restrict__ v2dt2, int v2_shot_stride,
                        const float* __restrict__ xramp,
                        const float* __restrict__ zfac,
                        const float* __restrict__ strip,
                        const float* __restrict__ inj, int inj_shot_stride,
                        int gz_rec, int k_steps, int nxb, int nzb, int nx,
                        int nz, int nxe, int nze, pfdc::StripShape shape,
                        pfdc::Coefs c) {
  extern __shared__ float smem[];
  kstep_gpu_bwd_pass<H, 0>(smem, ps_in, pps_in, pr_in, ppr_in, ps_out,
                           pps_out, pr_out, ppr_out, img, v2dt2,
                           v2_shot_stride, xramp, zfac, strip, inj,
                           inj_shot_stride, gz_rec, k_steps, nxb, nzb, nx, nz,
                           nxe, nze, shape, c);
}

// The split twin (P = 2, 3): the same pass with the z taps in bf16 parts.
// Its tile takes one block an SM at order 8, so its launch bounds leave
// it 128 registers a thread: at two blocks an SM's 64 it spilled and ran
// 5 % slower on the Pluto grid (PERF.md).
template <int H, int P>
__global__ void __launch_bounds__(pfdc::kStripThreads, 1)
    kstep_gpu_bwd_mma(const float* __restrict__ ps_in,
                      const float* __restrict__ pps_in,
                      const float* __restrict__ pr_in,
                      const float* __restrict__ ppr_in,
                      float* __restrict__ ps_out,
                      float* __restrict__ pps_out,
                      float* __restrict__ pr_out,
                      float* __restrict__ ppr_out, float* __restrict__ img,
                      const float* __restrict__ v2dt2, int v2_shot_stride,
                      const float* __restrict__ xramp,
                      const float* __restrict__ zfac,
                      const float* __restrict__ strip,
                      const float* __restrict__ inj, int inj_shot_stride,
                      int gz_rec, int k_steps, int nxb, int nzb, int nx,
                      int nz, int nxe, int nze, pfdc::StripShape shape,
                      pfdc::Coefs c) {
  static_assert(P > 0, "kstep_gpu_bwd_strip is the exact kernel");
  extern __shared__ float smem[];
  kstep_gpu_bwd_pass<H, P>(smem, ps_in, pps_in, pr_in, ppr_in, ps_out,
                           pps_out, pr_out, ppr_out, img, v2dt2,
                           v2_shot_stride, xramp, zfac, strip, inj,
                           inj_shot_stride, gz_rec, k_steps, nxb, nzb, nx, nz,
                           nxe, nze, shape, c);
}

// The kernel at P.
template <int H, int P>
auto bwd_kernel() {
  if constexpr (P == 0) {
    return kstep_gpu_bwd_strip<H>;
  } else {
    return kstep_gpu_bwd_mma<H, P>;
  }
}

struct KstepBwdRun {
  const float* ps;
  const float* pps;
  const float* pr;
  const float* ppr;
  float* ps_out;
  float* pps_out;
  float* pr_out;
  float* ppr_out;
  float* img;
  const float* v2dt2;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* inj;
  int inj_shot_stride, gz, k, nxb, nzb, ns, nxe, nze;
  pfdc::Coefs c;
  int parts;
  cudaStream_t stream;

  template <int H, int P>
  cudaError_t launch() const {
    const pfdc::StripStage stage = P ? pfdc::kBwdMmaStage : pfdc::kBwdStage;
    const pfdc::StripShape shape =
        P ? pfdc::strip_shape(pfdc::kBwdZMmaShapes, stage, k * H)
          : pfdc::strip_shape(pfdc::kBwdShapes, stage, k * H);
    if (shape.tx == 0) return cudaErrorInvalidValue;
    const size_t bytes = pfdc::strip_bytes(shape, stage, k * H);
    const auto kernel = bwd_kernel<H, P>();
    const cudaError_t e = pfdc::allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
    const dim3 block(pfdc::kStripThreads);
    kernel<<<grid, block, bytes, stream>>>(
        ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out, img, v2dt2,
        v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, k, nxb,
        nzb, nxe - 2 * nxb, nze - 2 * nzb, nxe, nze, shape, c);
    return cudaGetLastError();
  }

  template <int H>
  cudaError_t operator()() const {
    return pfdc::dispatch_parts<H>(*this, parts);
  }
};

int kstep_gpu_bwd_run(const float* ps, const float* pps, const float* pr,
                      const float* ppr, float* ps_out, float* pps_out,
                      float* pr_out, float* ppr_out, float* img,
                      const float* v2dt2, int v2_shot_stride,
                      const float* xramp, const float* zfac,
                      const float* strip, const float* inj,
                      int inj_shot_stride, int gz, int k, int nxb, int nzb,
                      int ns, int nxe, int nze, int order, int parts,
                      const float* cx, const float* cz, void* stream) {
  if (k < 1 || k > pfdc::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KstepBwdRun run{ps,    pps,    pr,     ppr,   ps_out, pps_out,
                        pr_out, ppr_out, img,  v2dt2, v2_shot_stride,
                        xramp, zfac,   strip,  inj,   inj_shot_stride,
                        gz,    k,      nxb,    nzb,   ns,     nxe,
                        nze,   pfdc::make_coefs(order / 2, cx, cz), parts,
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs one pass of k steps (1 <= k <= 8) of kstep_gpu_bwd from the state
// (ps, pps, pr, ppr) into the *_out buffers, all (ns, nxe, nze), and adds
// the pass's imaging into img (ns, nx, nz) in place. inj points at the
// pass's first trace row of shot 0: row i of shot s is inj[s *
// inj_shot_stride + i * nx + ix]. Returns a cudaError_t.
extern "C" int pfdc_kstep_gpu_bwd_run(const float* ps, const float* pps,
                                      const float* pr, const float* ppr,
                                      float* ps_out, float* pps_out,
                                      float* pr_out, float* ppr_out,
                                      float* img, const float* v2dt2,
                                      int v2_shot_stride, const float* xramp,
                                      const float* zfac, const float* strip,
                                      const float* inj, int inj_shot_stride,
                                      int gz, int k, int nxb, int nzb,
                                      int ns, int nxe, int nze, int order,
                                      const float* cx, const float* cz,
                                      void* stream) {
  return kstep_gpu_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out,
                           ppr_out, img, v2dt2, v2_shot_stride, xramp, zfac,
                           strip, inj, inj_shot_stride, gz, k, nxb, nzb, ns,
                           nxe, nze, order, 0, cx, cz, stream);
}

// The same pass with the z taps in parts (2 or 3) bf16 splits:
// kstep_gpu_bwd_mma.
extern "C" int pfdc_kstep_gpu_bwd_mma_run(
    const float* ps, const float* pps, const float* pr, const float* ppr,
    float* ps_out, float* pps_out, float* pr_out, float* ppr_out, float* img,
    const float* v2dt2, int v2_shot_stride, const float* xramp,
    const float* zfac, const float* strip, const float* inj,
    int inj_shot_stride, int gz, int k, int nxb, int nzb, int ns, int nxe,
    int nze, int order, int parts, const float* cx, const float* cz,
    void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return kstep_gpu_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out,
                           ppr_out, img, v2dt2, v2_shot_stride, xramp, zfac,
                           strip, inj, inj_shot_stride, gz, k, nxb, nzb, ns,
                           nxe, nze, order, parts, cx, cz, stream);
}
