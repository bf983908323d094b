// The GPU suite's backward propagation and imaging (fd_back,
// cuda_reference_RTM/src/fd-code.cu:290-341) for every shot of a batch,
// and the C entry point pfdc_rtm_bwd_run that runs the whole time loop on a
// stream, on one of two routes, chosen by the shape (pfdc::cluster_plan):
//
// - rtm_bwd_cluster, where a shot fits a thread-block cluster: one launch
//   runs all nt steps, each shot's four field levels held in its cluster's
//   shared memory and its image summed in registers (cluster_loop.cuh);
// - rtm_bwd_step elsewhere (Pluto's grid): one launch a step over all
//   shots, the host looping.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_fd.py,
// the backward half of _rtm_kernel (:534, called through
// rtm_snapshot_pallas :629) and _bwd_gpu_kernel (:729, called through
// fd_back_pallas :808).
//
// A step does both propagations and the imaging: the untapered source
// reconstruction (seeded from the two snapshots at it = 0 and 1), the
// tapered receiver update with the time-reversed trace added at row gz
// (K5), and img += p_src * p_rec over the interior (K6). Each thread
// multiplies its own two new values, so imaging needs no second pass and
// no atomics.
//
// What bounds rtm_bwd_step on an H100: at the 3lay size (231 x 231, 8
// shots) a step touches 4 fields, v2*dt2, the mask and the image, about 12
// MB, inside the 50 MB L2; the pace is launch latency and L2 bandwidth, not
// HBM. Threads run along z for coalesced loads; nothing is staged in
// shared memory. The resident route removes the launches and the L2 round
// trips.
//
// Taper without a race: as in rtm_fwd_step.cu, the per-step route's
// receiver buffers hold untapered fields; the taps read m[q] * pr[q] and
// the older field is read as m * (m * ppr), which equals the JAX loop's
// in-place taper. The resident route stores m * u instead
// (cluster_loop.cuh). The source pair is never tapered.
#include "cluster_loop.cuh"

namespace {

template <int H>
__global__ void rtm_bwd_step(const float* __restrict__ s_cur,
                             float* __restrict__ s_old,
                             const float* __restrict__ snap,
                             const float* __restrict__ r_cur,
                             float* __restrict__ r_old,
                             const float* __restrict__ v2dt2,
                             int v2_shot_stride,
                             const float* __restrict__ mask,
                             const float* __restrict__ inj_it,
                             int inj_shot_stride,
                             float* __restrict__ img, int gz, int nxb,
                             int nzb, int nx, int nz, int nxe, int nze,
                             pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const bool interior = pfdc::in_interior(ix, iz, H, nxe, nze);
  const float v = v2dt2[s * static_cast<size_t>(v2_shot_stride) + j];

  // source field: untapered, seeded from the snapshots at it = 0, 1
  float* so = s_old + s * plane;
  float us;
  if (snap != nullptr) {
    us = snap[s * plane + j];
  } else {
    const float* ps = s_cur + s * plane;
    const float lap =
        interior ? pfdc::laplacian<H, false>(ps, mask, j, nze, c) : 0.0f;
    us = (2.0f * ps[j] - so[j]) + v * lap;
  }
  so[j] = us;

  // receiver field: tapered on read, trace added at row gz
  const float m = mask[j];
  const float* pr = r_cur + s * plane;
  float* ro = r_old + s * plane;
  const float lap =
      interior ? pfdc::laplacian<H, true>(pr, mask, j, nze, c) : 0.0f;
  float ur = (2.0f * (m * pr[j]) - m * (m * ro[j])) + v * lap;
  if (iz == gz && ix >= nxb && ix < nxb + nx) {
    ur = ur + inj_it[s * static_cast<size_t>(inj_shot_stride) + (ix - nxb)];
  }
  ro[j] = ur;

  // imaging over the interior
  if (ix >= nxb && ix < nxb + nx && iz >= nzb && iz < nzb + nz) {
    float* im = img + s * static_cast<size_t>(nx) * nz +
                static_cast<size_t>(ix - nxb) * nz + (iz - nzb);
    *im = *im + us * ur;
  }
}

// All nt steps of rtm_bwd_step for the shot of this cluster (blockIdx.x /
// cluster size), each CTA a slab, each thread a strip (cluster_loop.cuh).
// Shared memory holds four levels, each with its halo rows: the source
// field's two (untapered), then the receiver field's two (times the mask).
// The image of a thread's cells is summed in registers, img = img + us * ur
// in time order from 0, as the per-step loop sums it in the zeroed img, and
// written once at the end.
template <int H>
__global__ void __launch_bounds__(pfdc::kClusterThreads, 1)
    rtm_bwd_cluster(const float* __restrict__ snap0,
                    const float* __restrict__ snap1,
                    const float* __restrict__ v2dt2, int v2_shot_stride,
                    const float* __restrict__ mask,
                    const float* __restrict__ inj, float* __restrict__ img,
                    int gz, int nxb, int nzb, int nxe, int nze, int rows,
                    int nt, pfdc::Coefs c) {
  constexpr int R = pfdc::kClusterRows, V = pfdc::kClusterCols;
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  extern __shared__ float smem[];
  const pfdc::Slab sl = pfdc::make_slab(cl, smem, rows, nxe, nze);
  const pfdc::Strip st = pfdc::strip_of(sl);
  const int s = blockIdx.x / cl.num_blocks();
  const int nx = nxe - 2 * nxb, nz = nze - 2 * nzb;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const size_t level = pfdc::level_floats<H>(sl);
  for (size_t k = threadIdx.x; k < 4 * level; k += blockDim.x) smem[k] = 0.0f;
  // per-cell constants; 0 at a column group's padding, whose values stay 0
  float vr[R][V], mr[R][V], acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int col = 0; col < V; ++col) {
      const int lx = st.lx0 + r, iz = st.iz0 + col;
      const bool own = st.valid && lx < sl.n && iz < nze;
      const int j = (sl.x0 + lx) * nze + iz;
      vr[r][col] =
          own ? v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] : 0.0f;
      mr[r][col] = own ? mask[j] : 0.0f;
      acc[r][col] = 0.0f;
    }
  }
  cl.sync();
  for (int it = 0; it < nt; ++it) {
    const size_t scur = (it & 1) * level, sold = level - scur;
    const size_t rcur = 2 * level + scur, rold = 2 * level + sold;
    if (st.valid) {
      // source field: untapered, seeded from the snapshots at it = 0, 1
      pfdc::Cols us[R];
      if (it < 2) {
        const float* snap = (it == 0 ? snap1 : snap0) + s * plane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int lx = st.lx0 + r;
          if (lx >= sl.n) continue;
#pragma unroll
          for (int col = 0; col < V; ++col) {
            const int iz = st.iz0 + col;
            us[r].v[col] =
                iz < nze ? snap[static_cast<size_t>(sl.x0 + lx) * nze + iz]
                         : 0.0f;
          }
          pfdc::store_cols(smem + sold + pfdc::level_cell<H>(sl, lx, st.iz0),
                           us[r]);
          pfdc::push_halo<H>(sl, sold, lx, st, us[r]);
        }
      } else {
        pfdc::Cols w[R + 2 * H];
        pfdc::load_window<H>(w, smem + scur, sl, st);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int lx = st.lx0 + r;
          if (lx >= sl.n) continue;
          const int gx = sl.x0 + lx;
          const bool x_in = gx >= H && gx < nxe - H;
          const int q = pfdc::level_cell<H>(sl, lx, st.iz0);
          float z[2 * pfdc::z_reach<H>() + V];
          pfdc::load_row<H>(z, smem + scur, sl, lx, st);
          const pfdc::Cols pps = pfdc::load_cols(smem + sold + q);
#pragma unroll
          for (int col = 0; col < V; ++col) {
            const int iz = st.iz0 + col;
            const float lap = pfdc::cell_lap<H>(
                w, z, r, col, x_in && iz >= H && iz < nze - H, c);
            us[r].v[col] =
                (2.0f * w[r + H].v[col] - pps.v[col]) + vr[r][col] * lap;
          }
          pfdc::store_cols(smem + sold + q, us[r]);
          pfdc::push_halo<H>(sl, sold, lx, st, us[r]);
        }
      }
      // receiver field: tapered, trace added at row gz; imaging
      pfdc::Cols w[R + 2 * H];
      pfdc::load_window<H>(w, smem + rcur, sl, st);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int lx = st.lx0 + r;
        if (lx >= sl.n) continue;
        const int gx = sl.x0 + lx;
        const bool x_in = gx >= H && gx < nxe - H;
        const int q = pfdc::level_cell<H>(sl, lx, st.iz0);
        float z[2 * pfdc::z_reach<H>() + V];
        pfdc::load_row<H>(z, smem + rcur, sl, lx, st);
        const pfdc::Cols ro = pfdc::load_cols(smem + rold + q);
        const bool in_x = gx >= nxb && gx < nxb + nx;
        pfdc::Cols stored;
#pragma unroll
        for (int col = 0; col < V; ++col) {
          const int iz = st.iz0 + col;
          const float m = mr[r][col];
          const float lap = pfdc::cell_lap<H>(
              w, z, r, col, x_in && iz >= H && iz < nze - H, c);
          float ur = (2.0f * w[r + H].v[col] - m * ro.v[col]) +
                     vr[r][col] * lap;
          if (iz == gz && in_x) {
            ur = ur + inj[(s * static_cast<size_t>(nt) + it) * nx + (gx - nxb)];
          }
          stored.v[col] = m * ur;
          if (in_x && iz >= nzb && iz < nzb + nz) {
            acc[r][col] = acc[r][col] + us[r].v[col] * ur;
          }
        }
        pfdc::store_cols(smem + rold + q, stored);
        pfdc::push_halo<H>(sl, rold, lx, st, stored);
      }
    }
    pfdc::step_barrier(cl);
  }
  cl.sync();  // no neighbour writes this CTA's shared memory after it exits
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int col = 0; col < V; ++col) {
      const int gx = sl.x0 + st.lx0 + r, iz = st.iz0 + col;
      if (st.valid && st.lx0 + r < sl.n && gx >= nxb && gx < nxb + nx &&
          iz >= nzb && iz < nzb + nz) {
        img[s * static_cast<size_t>(nx) * nz +
            static_cast<size_t>(gx - nxb) * nz + (iz - nzb)] = acc[r][col];
      }
    }
  }
}

struct BwdRun {
  float* sa;
  float* sb;
  const float* snap0;
  const float* snap1;
  float* ra;
  float* rb;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* inj;  // (ns, nt, nx): inj[s, it, ix] = dobs[s, ix, nt-1-it]
  float* img;        // (ns, nx, nz)
  int gz, nxb, nzb, nx, nz, ns, nxe, nze, nt;
  pfdc::Coefs c;
  pfdc::ClusterPlan plan;  // plan.cluster == 0: the per-step route
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    if (plan.cluster) {
      return pfdc::launch_cluster(rtm_bwd_cluster<H>, plan, ns,
                                  plan.bwd_bytes, stream, snap0, snap1,
                                  v2dt2, v2_shot_stride, mask, inj, img, gz,
                                  nxb, nzb, nxe, nze, plan.rows, nt, c);
    }
    const dim3 grid = pfdc::step_grid(ns, nxe, nze);
    const dim3 block = pfdc::step_block();
    for (int it = 0; it < nt; ++it) {
      const bool even = it % 2 == 0;
      const float* snap = it == 0 ? snap1 : (it == 1 ? snap0 : nullptr);
      rtm_bwd_step<H><<<grid, block, 0, stream>>>(
          even ? sa : sb, even ? sb : sa, snap, even ? ra : rb,
          even ? rb : ra, v2dt2, v2_shot_stride, mask,
          inj + static_cast<size_t>(it) * nx, nt * nx, img, gz, nxb, nzb, nx,
          nz, nxe, nze, c);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

struct BwdClusters {
  pfdc::ClusterPlan plan;
  int* out;
  template <int H>
  cudaError_t operator()() const {
    *out = pfdc::active_clusters(rtm_bwd_cluster<H>, plan, plan.bwd_bytes);
    return cudaSuccess;
  }
};

}  // namespace

// Runs nt steps of the backward propagation and imaging: rtm_bwd_cluster
// where the shot fits a cluster (pfdc::cluster_plan) and per_step is 0,
// else nt launches of rtm_bwd_step; *resident says which (1: the cluster
// kernel). The per-shot images accumulate into img (zeroed by the caller,
// as are ra and rb). sa and sb are scratch for the source pair of the
// per-step route; the resident route leaves the four field buffers as they
// were. Returns a cudaError_t.
extern "C" int pfdc_rtm_bwd_run(float* sa, float* sb, const float* snap0,
                                const float* snap1, float* ra, float* rb,
                                const float* v2dt2, int v2_shot_stride,
                                const float* mask, const float* inj,
                                float* img, int gz, int nxb, int nzb, int ns,
                                int nxe, int nze, int nt, int order,
                                const float* cx, const float* cz,
                                int per_step, int* resident,
                                void* stream) {
  pfdc::ClusterPlan plan;
  if (!per_step) plan = pfdc::cluster_plan(nxe, nze, order);
  *resident = plan.cluster != 0;
  const BwdRun run{sa,   sb,   snap0, snap1, ra,  rb,
                   v2dt2, v2_shot_stride, mask, inj, img, gz,
                   nxb,  nzb,  nxe - 2 * nxb, nze - 2 * nzb, ns, nxe,
                   nze,  nt,   pfdc::make_coefs(order / 2, cx, cz), plan,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// The most clusters of rtm_bwd_cluster the card holds at once at (nxe, nze,
// order), or -1 where the shot takes the per-step route or on an error.
extern "C" int pfdc_rtm_bwd_clusters(int nxe, int nze, int order) {
  int n = -1;
  const BwdClusters f{pfdc::cluster_plan(nxe, nze, order), &n};
  if (f.plan.cluster) pfdc::dispatch_half(order, f);
  return n;
}
