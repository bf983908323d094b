// domain_block: the x-domain tier's three block kernels, each K time steps
// on one halo-extended x-slab for every shot of a batch, and their C entry
// points pfdc_block_{mod,fwd,bwd}_run (one launch a block and slab).
//
// Replaces: parallel_finite_difference_computation_tpu/parallel/
// domain_pallas.py, _mod_block_kernel (:189), _fwd_block_kernel (:115) and
// _bwd_block_kernel (:136), called by make_sharded_forward_modeling_pallas
// (:220) and make_sharded_rtm_snapshot_pallas (:346).
//
// The slab. The extended grid's x axis is cut into n_x slabs of nxl rows;
// slab j holds its nxl owned rows and hs = K*h rows of each neighbour, the
// halo, exchanged by the caller once per block ((ns, nxw, nze) buffers, nxw
// = nxl + 2*hs, z contiguous: a halo is hs*nze contiguous floats a side,
// not the TPU kernels' lane-offset columns). The exact region shrinks by h
// a step, so after k <= K steps the owned rows are exact: the redundant
// halo compute replaces K-1 of every K exchanges (communication-avoiding
// blocking). A block of threads owns kTX x kTZ cells of owned rows of one
// shot and stages its tile with a k*h halo on both axes in shared memory,
// as the K-step kernels do (kstep.cuh): a slab row of Pluto is 1281 floats
// and a slab 1824 rows, far beyond an SM. The Laplacian is zero on the
// slab's border (in_interior over the slab), and the global interior is
// folded into v2m = v2*dt2 (0 outside it), so an edge slab's zero halo
// reproduces the unsharded grid.
//
// Operands made once a run per slab by the wrapper: v2m (per shot, or one
// plane for all), the taper's 1-D ramps with the x ramp cut to the slab
// (0 beyond the grid; taper_at rebuilds the mask bitwise inside the grid),
// the source rows at depth sz around it (the Gaussian patch's rows, or a
// one-hot row), and for block_bwd the time-reversed trace rows (nt, nxw) of
// each shot. v2m is read from global memory at the cell's own position
// only, so it is not staged.
//
// What bounds it on an H100: per block the pass reads the staged fields
// and v2m once and writes the owned rows once; what is left is shared-
// memory and ALU work on a tile (32 + 2kh)(64 + 2kh) for 32 x 64 owned
// cells (block_bwd: 32 x 32, to fit four fields at order 10 and K = 8).
//
// Per step the operations, their order and rounding are the plain block
// functions' (parallel/domain_kernels.py) and the TPU kernels': the older
// field tapered in place in a phase of its own, then a barrier, outputs to
// buffers no block of the launch reads. block_bwd sums the image delta of
// the block from 0 in shared memory and adds it to the running image once,
// as the JAX package does (domain_pallas.py:161, :178, :492). Offsets into
// trace rows and seismograms are size_t.
#include "kstep.cuh"

namespace {

constexpr int kModTX = 32, kModTZ = 64;   // block_mod, block_fwd
constexpr int kBwdTX = 32, kBwdTZ = 32;   // block_bwd

// One block's tile of the slab: local (0, 0) is slab cell (x0, z0); the
// owned cells are local [r, r + TX) x [r, r + TZ) within the owned rows.
template <int TX, int TZ>
struct SlabTile {
  int r, sx, sz, x0, z0;

  __device__ SlabTile(int halo, int hs)
      : r(halo),
        sx(TX + 2 * halo),
        sz(TZ + 2 * halo),
        x0(hs + static_cast<int>(blockIdx.y) * TX - halo),
        z0(static_cast<int>(blockIdx.x) * TZ - halo) {}

  __device__ int cells() const { return sx * sz; }

  __device__ bool owned(int lx, int lz, int gx, int hs, int nxl) const {
    return lx >= r && lx < r + TX && lz >= r && lz < r + TZ && gx < hs + nxl;
  }
};

template <int TX, int TZ>
size_t tile_bytes(int fields, int halo, bool image) {
  const size_t cells = static_cast<size_t>(TX + 2 * halo) * (TZ + 2 * halo);
  return sizeof(float) * (fields * cells + (image ? TX * TZ : 0));
}

template <int TX, int TZ>
dim3 slab_grid(int ns, int nxl, int nze) {
  return dim3((nze + TZ - 1) / TZ, (nxl + TX - 1) / TX, ns);
}

// Calls fn(lx, lz, gx, gz) for every tile cell at least lo cells from the
// tile's edge that lies in the nxw x nze slab (gx: slab row). The cell ->
// thread map does not depend on lo.
template <class T, class F>
__device__ __forceinline__ void for_cells(const T& t, int lo, int nxw, int nze,
                                          F&& fn) {
  for (int lx = threadIdx.y; lx < t.sx; lx += blockDim.y) {
    const int gx = t.x0 + lx;
    if (lx < lo || lx >= t.sx - lo || gx < 0 || gx >= nxw) continue;
    for (int lz = threadIdx.x; lz < t.sz; lz += blockDim.x) {
      const int gz = t.z0 + lz;
      if (lz < lo || lz >= t.sz - lo || gz < 0 || gz >= nze) continue;
      fn(lx, lz, gx, gz);
    }
  }
}

// Stages one shot's slab field f (nxw, nze) into s, 0 outside the slab.
template <class T>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ f,
                                          const T& t, int nxw, int nze) {
  for (int lx = threadIdx.y; lx < t.sx; lx += blockDim.y) {
    const int gx = t.x0 + lx;
    for (int lz = threadIdx.x; lz < t.sz; lz += blockDim.x) {
      const int gz = t.z0 + lz;
      s[lx * t.sz + lz] = (gx >= 0 && gx < nxw && gz >= 0 && gz < nze)
                              ? f[static_cast<size_t>(gx) * nze + gz]
                              : 0.0f;
    }
  }
}

// Writes the owned cells of s to one shot's slab field f.
template <class T>
__device__ __forceinline__ void store_tile(float* __restrict__ f,
                                           const float* s, const T& t, int hs,
                                           int nxl, int nxw, int nze) {
  for_cells(t, t.r, nxw, nze, [&](int lx, int lz, int gx, int gz) {
    if (t.owned(lx, lz, gx, hs, nxl)) {
      f[static_cast<size_t>(gx) * nze + gz] = s[lx * t.sz + lz];
    }
  });
}

// Per step, from the state (p, pp), pp tapered: u = (2p - pp) + v*lap(p);
// u += amp * src on the source rows; pp' = u*m; p' = p*m, whose row gz on
// the owned rows is the step's trace (mod_main.cpp:146-168).
template <int H>
__global__ void block_mod(const float* __restrict__ p_in,
                          const float* __restrict__ pp_in,
                          float* __restrict__ p_out, float* __restrict__ pp_out,
                          const float* __restrict__ v2m, int v2_shot_stride,
                          const float* __restrict__ xramp,
                          const float* __restrict__ zfac,
                          const float* __restrict__ strip,
                          const float* __restrict__ src, int r, int src_z,
                          pfdc::Amps amps, int k_steps, float* __restrict__ rec,
                          int gz_rec, int hs, int nxl, int nze, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int nxw = nxl + 2 * hs;
  const SlabTile<kModTX, kModTZ> t(k_steps * H, hs);
  const int n = t.cells();
  float* sp = smem;
  float* spp = smem + n;
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxw) * nze;
  load_tile(sp, p_in + s * plane, t, nxw, nze);
  load_tile(spp, pp_in + s * plane, t, nxw, nze);
  __syncthreads();
  const float* v = v2m + s * static_cast<size_t>(v2_shot_stride);
  const float* src_s = src + s * static_cast<size_t>(2 * r + 1) * nxw;
  float* rec_s = rec + s * static_cast<size_t>(k_steps) * nxl;
  for (int k = 0; k < k_steps; ++k) {
    const int lo = (k + 1) * H;
    const float amp = amps.a[k];
    // the update, into the older field's slot (read only at its own cell)
    for_cells(t, lo, nxw, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const float lap = pfdc::in_interior(gx, gz, H, nxw, nze)
                            ? pfdc::laplacian<H, false>(sp, nullptr, j, t.sz, c)
                            : 0.0f;
      float u = (2.0f * sp[j] - spp[j]) +
                v[static_cast<size_t>(gx) * nze + gz] * lap;
      const int dz = gz - src_z;
      if (dz >= -r && dz <= r) {
        u = u + amp * src_s[static_cast<size_t>(dz + r) * nxw + gx];
      }
      spp[j] = u * pfdc::taper_at(xramp, zfac, strip, gx, gz);
    });
    __syncthreads();
    // taper the old field once every neighbour has read it; record row gz
    for_cells(t, lo, nxw, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const float q = sp[j] * pfdc::taper_at(xramp, zfac, strip, gx, gz);
      sp[j] = q;
      if (gz == gz_rec && t.owned(lx, lz, gx, hs, nxl)) {
        rec_s[static_cast<size_t>(k) * nxl + (gx - hs)] = q;
      }
    });
    float* tmp = sp;
    sp = spp;
    spp = tmp;
  }
  store_tile(p_out + s * plane, sp, t, hs, nxl, nxw, nze);
  store_tile(pp_out + s * plane, spp, t, hs, nxl, nxw, nze);
}

// Per step, from the state (p, pp), p tapered and pp not (fd-code.cu:
// 259-267): t = pp*m (in place, then a barrier), u = (2t - p*m) + v*lap(t),
// u += amp * src on row sz; the next state is (t, u).
template <int H>
__global__ void block_fwd(const float* __restrict__ p_in,
                          const float* __restrict__ pp_in,
                          float* __restrict__ p_out, float* __restrict__ pp_out,
                          const float* __restrict__ v2m, int v2_shot_stride,
                          const float* __restrict__ xramp,
                          const float* __restrict__ zfac,
                          const float* __restrict__ strip,
                          const float* __restrict__ src, int src_z,
                          pfdc::Amps amps, int k_steps, int hs, int nxl,
                          int nze, pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int nxw = nxl + 2 * hs;
  const SlabTile<kModTX, kModTZ> t(k_steps * H, hs);
  const int n = t.cells();
  float* sx_ = smem;      // p: the older field, tapered
  float* sy = smem + n;   // pp: the newest field
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxw) * nze;
  load_tile(sx_, p_in + s * plane, t, nxw, nze);
  load_tile(sy, pp_in + s * plane, t, nxw, nze);
  const float* v = v2m + s * static_cast<size_t>(v2_shot_stride);
  const float* src_s = src + s * static_cast<size_t>(nxw);
  for (int k = 0; k < k_steps; ++k) {
    // taper the newest field over every cell this step's taps read
    for_cells(t, k * H, nxw, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      sy[j] = sy[j] * pfdc::taper_at(xramp, zfac, strip, gx, gz);
    });
    __syncthreads();
    const float amp = amps.a[k];
    for_cells(t, (k + 1) * H, nxw, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const float m = pfdc::taper_at(xramp, zfac, strip, gx, gz);
      const float lap = pfdc::in_interior(gx, gz, H, nxw, nze)
                            ? pfdc::laplacian<H, false>(sy, nullptr, j, t.sz, c)
                            : 0.0f;
      float u = (2.0f * sy[j] - sx_[j] * m) +
                v[static_cast<size_t>(gx) * nze + gz] * lap;
      if (gz == src_z) u = u + amp * src_s[gx];
      sx_[j] = u;
    });
    float* tmp = sx_;
    sx_ = sy;
    sy = tmp;
  }
  store_tile(p_out + s * plane, sx_, t, hs, nxl, nxw, nze);
  store_tile(pp_out + s * plane, sy, t, hs, nxl, nxw, nze);
}

// Per step, from the state (ps, pps, pr, ppr) (fd-code.cu:302-333): the
// source s = (2ps - pps) + v*lap(ps), untapered, or with snap0/snap1 given
// (the first block) the snapshot snap1 at step 0 and snap0 at step 1; the
// receiver t = pr*m (in place, then a barrier), u = (2t - ppr*m) +
// v*lap(t), plus trace row k at depth gz (K5); the block's image delta
// += s*u on the owned cells (K6), added to img at the end.
template <int H>
__global__ void block_bwd(const float* __restrict__ ps_in,
                          const float* __restrict__ pps_in,
                          const float* __restrict__ pr_in,
                          const float* __restrict__ ppr_in,
                          float* __restrict__ ps_out,
                          float* __restrict__ pps_out,
                          float* __restrict__ pr_out,
                          float* __restrict__ ppr_out,
                          const float* __restrict__ snap0,
                          const float* __restrict__ snap1,
                          float* __restrict__ img,
                          const float* __restrict__ v2m, int v2_shot_stride,
                          const float* __restrict__ xramp,
                          const float* __restrict__ zfac,
                          const float* __restrict__ strip,
                          const float* __restrict__ inj, int inj_shot_stride,
                          int gz_rec, int k_steps, int hs, int nxl, int nze,
                          pfdc::Coefs c) {
  extern __shared__ float smem[];
  const int nxw = nxl + 2 * hs;
  const SlabTile<kBwdTX, kBwdTZ> t(k_steps * H, hs);
  const int n = t.cells();
  float* sps = smem;
  float* spps = smem + n;
  float* spr = smem + 2 * n;
  float* sppr = smem + 3 * n;
  float* simg = smem + 4 * n;   // kBwdTX x kBwdTZ, owned cells
  const int s = blockIdx.z;
  const size_t plane = static_cast<size_t>(nxw) * nze;
  load_tile(sps, ps_in + s * plane, t, nxw, nze);
  load_tile(spps, pps_in + s * plane, t, nxw, nze);
  load_tile(spr, pr_in + s * plane, t, nxw, nze);
  load_tile(sppr, ppr_in + s * plane, t, nxw, nze);
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < kBwdTX * kBwdTZ;
       i += blockDim.x * blockDim.y) {
    simg[i] = 0.0f;
  }
  const float* v = v2m + s * static_cast<size_t>(v2_shot_stride);
  const float* inj_s = inj + s * static_cast<size_t>(inj_shot_stride);
  const bool seed = snap0 != nullptr;
  for (int k = 0; k < k_steps; ++k) {
    // taper the receiver field over every cell this step's taps read
    for_cells(t, k * H, nxw, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      spr[j] = spr[j] * pfdc::taper_at(xramp, zfac, strip, gx, gz);
    });
    __syncthreads();
    for_cells(t, (k + 1) * H, nxw, nze, [&](int lx, int lz, int gx, int gz) {
      const int j = lx * t.sz + lz;
      const size_t q = static_cast<size_t>(gx) * nze + gz;
      const bool interior = pfdc::in_interior(gx, gz, H, nxw, nze);
      const float vq = v[q];
      float us;
      if (seed && k < 2) {
        us = (k == 0 ? snap1 : snap0)[s * plane + q];
      } else {
        const float lap_s =
            interior ? pfdc::laplacian<H, false>(sps, nullptr, j, t.sz, c)
                     : 0.0f;
        us = (2.0f * sps[j] - spps[j]) + vq * lap_s;
      }
      spps[j] = us;
      const float m = pfdc::taper_at(xramp, zfac, strip, gx, gz);
      const float lap_r =
          interior ? pfdc::laplacian<H, false>(spr, nullptr, j, t.sz, c) : 0.0f;
      float ur = (2.0f * spr[j] - sppr[j] * m) + vq * lap_r;
      if (gz == gz_rec) {
        ur = ur + inj_s[static_cast<size_t>(k) * nxw + gx];
      }
      sppr[j] = ur;
      if (t.owned(lx, lz, gx, hs, nxl)) {
        float& acc = simg[(lx - t.r) * kBwdTZ + (lz - t.r)];
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
  store_tile(ps_out + s * plane, sps, t, hs, nxl, nxw, nze);
  store_tile(pps_out + s * plane, spps, t, hs, nxl, nxw, nze);
  store_tile(pr_out + s * plane, spr, t, hs, nxl, nxw, nze);
  store_tile(ppr_out + s * plane, sppr, t, hs, nxl, nxw, nze);
  float* img_s = img + s * static_cast<size_t>(nxl) * nze;
  for_cells(t, t.r, nxw, nze, [&](int lx, int lz, int gx, int gz) {
    if (t.owned(lx, lz, gx, hs, nxl)) {
      float& out = img_s[static_cast<size_t>(gx - hs) * nze + gz];
      out = out + simg[(lx - t.r) * kBwdTZ + (lz - t.r)];
    }
  });
}

struct BlockModRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  const float* v2m;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* src;
  int r, sz;
  pfdc::Amps amps;
  int k;
  float* rec;
  int gz, ns, hs, nxl, nze;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    if (k * H > hs) return cudaErrorInvalidValue;
    const size_t bytes = tile_bytes<kModTX, kModTZ>(2, k * H, false);
    const cudaError_t e = pfdc::allow_smem(block_mod<H>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = slab_grid<kModTX, kModTZ>(ns, nxl, nze);
    const dim3 block = pfdc::tile_block();
    block_mod<H><<<grid, block, bytes, stream>>>(
        p, pp, p_out, pp_out, v2m, v2_shot_stride, xramp, zfac, strip, src, r,
        sz, amps, k, rec, gz, hs, nxl, nze, c);
    return cudaGetLastError();
  }
};

struct BlockFwdRun {
  const float* p;
  const float* pp;
  float* p_out;
  float* pp_out;
  const float* v2m;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* src;
  int sz;
  pfdc::Amps amps;
  int k, ns, hs, nxl, nze;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    if (k * H > hs) return cudaErrorInvalidValue;
    const size_t bytes = tile_bytes<kModTX, kModTZ>(2, k * H, false);
    const cudaError_t e = pfdc::allow_smem(block_fwd<H>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = slab_grid<kModTX, kModTZ>(ns, nxl, nze);
    const dim3 block = pfdc::tile_block();
    block_fwd<H><<<grid, block, bytes, stream>>>(
        p, pp, p_out, pp_out, v2m, v2_shot_stride, xramp, zfac, strip, src,
        sz, amps, k, hs, nxl, nze, c);
    return cudaGetLastError();
  }
};

struct BlockBwdRun {
  const float* ps;
  const float* pps;
  const float* pr;
  const float* ppr;
  float* ps_out;
  float* pps_out;
  float* pr_out;
  float* ppr_out;
  const float* snap0;
  const float* snap1;
  float* img;
  const float* v2m;
  int v2_shot_stride;
  const float* xramp;
  const float* zfac;
  const float* strip;
  const float* inj;
  int inj_shot_stride, gz, k, ns, hs, nxl, nze;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    if (k * H > hs) return cudaErrorInvalidValue;
    const size_t bytes = tile_bytes<kBwdTX, kBwdTZ>(4, k * H, true);
    const cudaError_t e = pfdc::allow_smem(block_bwd<H>, bytes);
    if (e != cudaSuccess) return e;
    const dim3 grid = slab_grid<kBwdTX, kBwdTZ>(ns, nxl, nze);
    const dim3 block = pfdc::tile_block();
    block_bwd<H><<<grid, block, bytes, stream>>>(
        ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out, snap0, snap1, img,
        v2m, v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, k,
        hs, nxl, nze, c);
    return cudaGetLastError();
  }
};

}  // namespace

// Runs k steps (1 <= k <= 8, k*h <= hs) of block_mod on the slabs (ns, nxl
// + 2*hs, nze) from the state (p, pp) into the owned rows of (p_out,
// pp_out), and writes each shot's k traces of the owned rows to rec (ns, k,
// nxl). src holds each shot's 2r+1 source rows (depths sz-r..sz+r) of the
// slab; amps is a host array of k samples. Returns a cudaError_t.
extern "C" int pfdc_block_mod_run(const float* p, const float* pp,
                                  float* p_out, float* pp_out,
                                  const float* v2m, int v2_shot_stride,
                                  const float* xramp, const float* zfac,
                                  const float* strip, const float* src, int r,
                                  int sz, const float* amps, int k, float* rec,
                                  int gz, int ns, int hs, int nxl, int nze,
                                  int order, const float* cx, const float* cz,
                                  void* stream) {
  if (k < 1 || k > pfdc::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlockModRun run{p,     pp,   p_out, pp_out, v2m,  v2_shot_stride,
                        xramp, zfac, strip, src,    r,    sz,
                        pfdc::make_amps(amps, k),    k,    rec,
                        gz,    ns,   hs,    nxl,    nze,
                        pfdc::make_coefs(order / 2, cx, cz),
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// Runs k steps of block_fwd on the slabs from the state (p, pp) into the
// owned rows of (p_out, pp_out). src holds each shot's source row (depth
// sz) of the slab. Returns a cudaError_t.
extern "C" int pfdc_block_fwd_run(const float* p, const float* pp,
                                  float* p_out, float* pp_out,
                                  const float* v2m, int v2_shot_stride,
                                  const float* xramp, const float* zfac,
                                  const float* strip, const float* src,
                                  int sz, const float* amps, int k, int ns,
                                  int hs, int nxl, int nze, int order,
                                  const float* cx, const float* cz,
                                  void* stream) {
  if (k < 1 || k > pfdc::kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlockFwdRun run{p,     pp,   p_out, pp_out, v2m, v2_shot_stride,
                        xramp, zfac, strip, src,    sz,
                        pfdc::make_amps(amps, k),   k,   ns,
                        hs,    nxl,  nze,
                        pfdc::make_coefs(order / 2, cx, cz),
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// Runs k steps of block_bwd on the slabs from the state (ps, pps, pr, ppr)
// into the owned rows of the *_out buffers, and adds the block's image
// delta into img (ns, nxl, nze) in place. snap0/snap1 (the slabs of the
// forward snapshots) are given for the first block only, else NULL. inj
// points at the block's first trace row of shot 0: row i of shot s is
// inj[s * inj_shot_stride + i * nxw + x]. Returns a cudaError_t.
extern "C" int pfdc_block_bwd_run(const float* ps, const float* pps,
                                  const float* pr, const float* ppr,
                                  float* ps_out, float* pps_out,
                                  float* pr_out, float* ppr_out,
                                  const float* snap0, const float* snap1,
                                  float* img, const float* v2m,
                                  int v2_shot_stride, const float* xramp,
                                  const float* zfac, const float* strip,
                                  const float* inj, int inj_shot_stride,
                                  int gz, int k, int ns, int hs, int nxl,
                                  int nze, int order, const float* cx,
                                  const float* cz, void* stream) {
  if (k < 1 || k > pfdc::kMaxSteps || (snap0 != nullptr && k < 2) ||
      (snap0 == nullptr) != (snap1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlockBwdRun run{ps,     pps,     pr,    ppr,   ps_out, pps_out,
                        pr_out, ppr_out, snap0, snap1, img,    v2m,
                        v2_shot_stride,  xramp, zfac,  strip,  inj,
                        inj_shot_stride, gz,    k,     ns,     hs,
                        nxl,    nze,     pfdc::make_coefs(order / 2, cx, cz),
                        static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}
