// kstep_gpu_bwd: K steps of the GPU suite's backward propagation and
// imaging (fd_back, cuda_reference_RTM/src/fd-code.cu:290-341, it >= 2) in
// one pass over the grid, for every shot of a batch, and the C entry points
// pfdc_kstep_gpu_bwd_run and pfdc_kstep_gpu_bwd_mma_run that launch one
// pass.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kstep_gpu_bwd_kernel (:857), called through fd_kstep_gpu_bwd_padded
// (:932) by the JAX package's rtm_shot_snapshot_tiled with block_k > 1:
// kstep_gpu_bwd_strip<H> its exact taps, kstep_gpu_bwd<H, 2 or 3>
// (kstep_gpu_bwd_mma) its use_mxu branch (:875-883), the z taps of both
// Laplacians in split bf16 on the tensor cores (kstep.cuh, z_band).
//
// The exact kernel runs the strip body of bwd_strip.cuh on a block's tile
// of 32 x 64 owned cells (a smaller shape where the halo leaves that no
// room) with a K*H halo: four staged fields, the owned image and the x
// ramp, 107 KB at order 8 and K = 4, so two blocks share an SM.
// The split kernel stages a 2-D tile of the four fields and v2*dt2 with a
// K*H halo on both axes, and its owned part of the image (kstep.cuh),
// plus two tiles for the z taps of the two fields, so that one loop over
// the cells takes both Laplacians: 180 KB at order 8 and K = 4, 218 KB at
// order 10.
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
#include "kstep.cuh"

namespace {

// Staged tiles of the split kernel: four fields, v2*dt2, and the z
// products of the source and the receiver field.
constexpr int kSplitFields = 7;

template <int H, int P>
__global__ void __launch_bounds__(pfdc::kTileThreads)
    kstep_gpu_bwd(const float* __restrict__ ps_in,
                  const float* __restrict__ pps_in,
                  const float* __restrict__ pr_in,
                  const float* __restrict__ ppr_in,
                  float* __restrict__ ps_out, float* __restrict__ pps_out,
                  float* __restrict__ pr_out, float* __restrict__ ppr_out,
                  float* __restrict__ img, const float* __restrict__ v2dt2,
                  int v2_shot_stride, const float* __restrict__ xramp,
                  const float* __restrict__ zfac,
                  const float* __restrict__ strip,
                  const float* __restrict__ inj, int inj_shot_stride,
                  int gz_rec, int k_steps, int nxb, int nzb, int nx, int nz,
                  int nxe, int nze, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const pfdc::Tile t(k_steps * H);
  const int n = t.cells();
  float* sps = smem;
  float* spps = smem + n;
  float* spr = smem + 2 * n;
  float* sppr = smem + 3 * n;
  float* sv = smem + 4 * n;
  float* simg = smem + 5 * n;   // kTileX x kTileZ, owned cells
  float* zs = simg + pfdc::kTileX * pfdc::kTileZ;   // P > 0: z taps of sps
  float* zr = zs + n;                               // and of spr
  const auto band = pfdc::split_band<H, P>(c.z);
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  pfdc::load_tile(sps, ps_in + s * plane, t, nxe, nze);
  pfdc::load_tile(spps, pps_in + s * plane, t, nxe, nze);
  pfdc::load_tile(spr, pr_in + s * plane, t, nxe, nze);
  pfdc::load_tile(sppr, ppr_in + s * plane, t, nxe, nze);
  pfdc::load_tile(sv, v2dt2 + s * static_cast<size_t>(v2_shot_stride), t,
                  nxe, nze);
  float* img_s = img + s * static_cast<size_t>(nx) * nz;
  auto imaged = [&](int gx, int gz) {
    return gx >= nxb && gx < nxb + nx && gz >= nzb && gz < nzb + nz;
  };
  auto img_at = [&](int gx, int gz) -> float& {
    return img_s[static_cast<size_t>(gx - nxb) * nz + (gz - nzb)];
  };
  pfdc::for_cells(t, t.r, nxe, nze, [&](int lx, int lz, int gx, int gz) {
    if (imaged(gx, gz)) {
      simg[(lx - t.r) * pfdc::kTileZ + (lz - t.r)] = img_at(gx, gz);
    }
  });
  const float* inj_s = inj + s * static_cast<size_t>(inj_shot_stride);
  for (int k = 0; k < k_steps; ++k) {
    // taper the receiver field over every cell this step's taps read
    pfdc::for_cells(t, k * H, nxe, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      spr[j] = spr[j] * pfdc::taper_at(xramp, zfac, strip, gx, gz);
    });
    __syncthreads();
    pfdc::z_band<H, P>(zs, sps, t, (k + 1) * H, band);
    pfdc::z_band<H, P>(zr, spr, t, (k + 1) * H, band);
    pfdc::for_cells(t, (k + 1) * H, nxe, nze,
                    [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const bool interior = pfdc::in_interior(gx, gz, H, nxe, nze);
      const float v = sv[j];
      const float lap_s =
          interior ? pfdc::tile_lap<H, P>(sps, zs, j, t.sz, c) : 0.0f;
      const float us = (2.0f * sps[j] - spps[j]) + v * lap_s;
      spps[j] = us;
      const float m = pfdc::taper_at(xramp, zfac, strip, gx, gz);
      const float lap_r =
          interior ? pfdc::tile_lap<H, P>(spr, zr, j, t.sz, c) : 0.0f;
      float ur = (2.0f * spr[j] - sppr[j] * m) + v * lap_r;
      if (gz == gz_rec && gx >= nxb && gx < nxb + nx) {
        ur = ur + inj_s[static_cast<size_t>(k) * nx + (gx - nxb)];
      }
      sppr[j] = ur;
      if (t.owned(lx, lz) && imaged(gx, gz)) {
        float& acc = simg[(lx - t.r) * pfdc::kTileZ + (lz - t.r)];
        acc = acc + us * ur;
      }
    });
    float* tmp = sps;
    sps = spps;
    spps = tmp;
    tmp = spr;
    spr = sppr;
    sppr = tmp;
  }
  pfdc::store_tile(ps_out + s * plane, sps, t, nxe, nze);
  pfdc::store_tile(pps_out + s * plane, spps, t, nxe, nze);
  pfdc::store_tile(pr_out + s * plane, spr, t, nxe, nze);
  pfdc::store_tile(ppr_out + s * plane, sppr, t, nxe, nze);
  pfdc::for_cells(t, t.r, nxe, nze, [&](int lx, int lz, int gx, int gz) {
    if (imaged(gx, gz)) {
      img_at(gx, gz) = simg[(lx - t.r) * pfdc::kTileZ + (lz - t.r)];
    }
  });
}

// The exact kernel's site (bwd_strip.cuh): one shot's fields on the
// (nxe, nze) grid; the image is the interior's, summed from its running
// value; the trace row is injected on the receiver row's interior cells.
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
  pfdc::bwd_strip<H>(smem, site, t, 0, k_steps, c);
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
    if constexpr (P == 0) {
      const pfdc::StripShape shape =
          pfdc::strip_shape(pfdc::kBwdShapes, pfdc::kBwdStage, k * H);
      if (shape.tx == 0) return cudaErrorInvalidValue;
      const size_t bytes = pfdc::strip_bytes(shape, pfdc::kBwdStage, k * H);
      const cudaError_t e = pfdc::allow_smem(kstep_gpu_bwd_strip<H>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
      const dim3 block(pfdc::kStripThreads);
      kstep_gpu_bwd_strip<H><<<grid, block, bytes, stream>>>(
          ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out, img, v2dt2,
          v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, k,
          nxb, nzb, nxe - 2 * nxb, nze - 2 * nzb, nxe, nze, shape, c);
    } else {
      const size_t bytes =
          sizeof(float) * (kSplitFields * pfdc::tile_cells(k * H) +
                           static_cast<size_t>(pfdc::kTileX) * pfdc::kTileZ);
      const cudaError_t e = pfdc::allow_smem(kstep_gpu_bwd<H, P>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::tile_grid(ns, nxe, nze);
      const dim3 block = pfdc::tile_block();
      kstep_gpu_bwd<H, P><<<grid, block, bytes, stream>>>(
          ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out, img, v2dt2,
          v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, k,
          nxb, nzb, nxe - 2 * nxb, nze - 2 * nzb, nxe, nze, c);
    }
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
