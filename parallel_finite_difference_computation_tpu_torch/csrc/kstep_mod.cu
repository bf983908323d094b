// kstep_mod: K forward-modeling steps (mod_main's loop, mod_main.cpp:
// 146-168) in one pass over the grid, for every shot of a batch, and the C
// entry points pfdc_kstep_mod_run and pfdc_kstep_mod_mma_run that launch
// one pass.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stream.py,
// _kstep_kernel (:574), called through fd_kstep_padded (:650) by the JAX
// package's forward_modeling_tiled with block_k > 1: kstep_mod_strip<H>
// its exact taps, kstep_mod<H, 2 or 3> (kstep_mod_mma) its use_mxu branch
// (:600-608), the z taps in split bf16 on the tensor cores (kstep.cuh,
// z_band). That kernel streams full-width row slabs through VMEM; here a
// block stages a 2-D tile with a K*H halo on both axes in shared memory.
//
// The exact kernel runs the one-field strip body of fwd_strip.cuh on a
// block's tile of 64 x 64 owned cells (a smaller shape where the halo
// leaves that no room): the field at two time levels and the x ramp, 74.1
// KB at order 8, K = 4, two blocks of 16 warps an SM. The split kernel
// stages p, pp, v2*dt2 and the z product of p over a 2-D tile with a
// K*H halo (kstep.cuh).
//
// What bounds it on an H100: at the Pluto grid (7040 x 1281, 36 MB a field)
// the per-step mod_step moves ~180 MB a shot-step through HBM; this pass
// reads p, pp and v2*dt2 once and writes p, pp once per K steps, and
// rebuilds the taper from its ramps instead of reading the mask plane. What
// is left is shared-memory and ALU work, with the halo cells computed
// redundantly (1.43x the owned cells over a pass of four steps at order 8
// on the exact kernel's 64 x 64 tile).
//
// Per step, from the state (p, pp) with pp tapered (the plain version's
// state): u = (2p - pp) + v*lap(p); u += amp * patch around the source;
// pp' = u * m; p' = p * m, whose row gz is the step's trace. The operations
// and their order are mod_step's, so with -fmad=false the exact kernel is
// bitwise the per-step kernel; the split one sums each mma's 16 products in
// the tensor cores' own order.
#include "fwd_strip.cuh"
#include "kstep.cuh"

namespace {

// Staged tiles of the split kernel: p, pp, v2*dt2 and the z product of p.
constexpr int kSplitFields = 4;

template <int H, int P>
__global__ void __launch_bounds__(pfdc::kTileThreads)
    kstep_mod(const float* __restrict__ p_in, const float* __restrict__ pp_in,
              float* __restrict__ p_out, float* __restrict__ pp_out,
              const float* __restrict__ v2dt2, int v2_shot_stride,
              const float* __restrict__ xramp, const float* __restrict__ zfac,
              const float* __restrict__ strip, const float* __restrict__ patch,
              int r, const int* __restrict__ sx, int sz, int gz_rec,
              pfdc::Amps amps, int k_steps, float* __restrict__ rec, int nxb,
              int nx, int nxe, int nze, pfdc::Coefs c) {
  static_assert(P > 0, "the exact kernel is kstep_mod_strip");
  extern __shared__ float smem[];
  const pfdc::Tile t(k_steps * H);
  const int n = t.cells();
  float* sp = smem;
  float* spp = smem + n;
  float* sv = smem + 2 * n;
  float* zb = smem + 3 * n;     // P > 0: the z taps of sp
  const auto band = pfdc::split_band<H, P>(c.z);
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  pfdc::load_tile(sp, p_in + s * plane, t, nxe, nze);
  pfdc::load_tile(spp, pp_in + s * plane, t, nxe, nze);
  pfdc::load_tile(sv, v2dt2 + s * static_cast<size_t>(v2_shot_stride), t,
                  nxe, nze);
  __syncthreads();
  const int src_x = sx[s];
  float* rec_s = rec + s * static_cast<size_t>(k_steps) * nx;
  for (int k = 0; k < k_steps; ++k) {
    const int lo = (k + 1) * H;
    const float amp = amps.a[k];
    pfdc::z_band<H, P>(zb, sp, t, lo, band);
    // the update, into the older field's slot (read only at its own cell)
    pfdc::for_cells(t, lo, nxe, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const float lap = pfdc::in_interior(gx, gz, H, nxe, nze)
                            ? pfdc::tile_lap<H, P>(sp, zb, j, t.sz, c)
                            : 0.0f;
      float u = (2.0f * sp[j] - spp[j]) + sv[j] * lap;
      const int dx = gx - src_x;
      const int dz = gz - sz;
      if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
        u = u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)];
      }
      spp[j] = u * pfdc::taper_at(xramp, zfac, strip, gx, gz);
    });
    __syncthreads();
    // taper the old field once every neighbour has read it; record row gz
    pfdc::for_cells(t, lo, nxe, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const float q = sp[j] * pfdc::taper_at(xramp, zfac, strip, gx, gz);
      sp[j] = q;
      if (gz == gz_rec && gx >= nxb && gx < nxb + nx && t.owned(lx, lz)) {
        rec_s[static_cast<size_t>(k) * nx + (gx - nxb)] = q;
      }
    });
    float* tmp = sp;
    sp = spp;
    spp = tmp;
  }
  pfdc::store_tile(p_out + s * plane, sp, t, nxe, nze);
  pfdc::store_tile(pp_out + s * plane, spp, t, nxe, nze);
}

// The exact kernel's site (fwd_strip.cuh): one shot's fields on the
// (nxe, nze) grid, p the newest level and pp the older; the source
// window's patch added around (src_x, sz); the trace row at depth gz_rec
// on the interior's columns.
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
  __device__ bool stored(int, int) const { return true; }
};

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
  pfdc::fwd_strip<H>(smem, site, t, amps, k_steps, c);
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
    if constexpr (P == 0) {
      const pfdc::StripShape shape =
          pfdc::strip_shape(pfdc::kFwdShapes, pfdc::kFwdStage, k * H);
      if (shape.tx == 0) return cudaErrorInvalidValue;
      const size_t bytes = pfdc::strip_bytes(shape, pfdc::kFwdStage, k * H);
      const cudaError_t e = pfdc::allow_smem(kstep_mod_strip<H>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::strip_grid(shape, ns, nxe, nze);
      const dim3 block(pfdc::kStripThreads);
      kstep_mod_strip<H><<<grid, block, bytes, stream>>>(
          p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp, zfac, strip,
          patch, r, sx, sz, gz, amps, k, rec, nxb, nx, nxe, nze, shape, c);
    } else {
      const size_t bytes =
          kSplitFields * sizeof(float) * pfdc::tile_cells(k * H);
      const cudaError_t e = pfdc::allow_smem(kstep_mod<H, P>, bytes);
      if (e != cudaSuccess) return e;
      const dim3 grid = pfdc::tile_grid(ns, nxe, nze);
      const dim3 block = pfdc::tile_block();
      kstep_mod<H, P><<<grid, block, bytes, stream>>>(
          p, pp, p_out, pp_out, v2dt2, v2_shot_stride, xramp, zfac, strip,
          patch, r, sx, sz, gz, amps, k, rec, nxb, nx, nxe, nze, c);
    }
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
