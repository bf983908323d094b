// The GPU suite's forward propagation (fd_forward,
// cuda_reference_RTM/src/fd-code.cu:247-288) for every shot of a batch, and
// the C entry point pfdc_rtm_fwd_run that runs the whole time loop on a
// stream, on one of two routes, chosen by the shape (pfdc::cluster_plan):
//
// - rtm_fwd_cluster, where a shot fits a thread-block cluster: one launch
//   runs all nt steps, each shot's two field levels held in its cluster's
//   shared memory (cluster_loop.cuh);
// - rtm_fwd_step elsewhere (Pluto's grid): one launch a step over all
//   shots, the host looping.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_fd.py,
// the forward half of _rtm_kernel (:534, called through
// rtm_snapshot_pallas :629) and _fwd_gpu_kernel (:702, called through
// fd_forward_pallas :776). Both keep one shot in VMEM for all nt steps, as
// the resident route keeps it in a cluster.
//
// What bounds rtm_fwd_step on an H100: at the 3lay size (231 x 231, 8
// shots) a step touches 2 fields, v2*dt2 and the mask, about 7 MB, inside
// the 50 MB L2; the pace is launch latency and L2 bandwidth, not HBM.
// Threads run along z for coalesced loads; nothing is staged in shared
// memory. The resident route removes the launches and the L2 round trips.
//
// Taper without a race: the JAX loop tapers both fields in place before the
// update (top strip, K3), so the Laplacian reads m * p and the older field
// has been tapered twice, m * (m * pp). A GPU thread that wrote m * p back
// would race the neighbours reading p for their taps. Here the per-step
// route's buffers hold the fields untapered; the taps read m[q] * p[q], the
// older field is read as m * (m * pp), and the new field is stored as
// computed. The resident route stores m * u in its other level, which no
// one reads during the step (cluster_loop.cuh), and leaves a and b
// untapered. The caller forms the tapered pair the JAX loop
// returns: (m * p_prev, p_new).
#include "cluster_loop.cuh"

namespace {

template <int H>
__global__ void rtm_fwd_step(const float* __restrict__ cur,
                             float* __restrict__ old,
                             const float* __restrict__ v2dt2,
                             int v2_shot_stride,
                             const float* __restrict__ mask,
                             const int* __restrict__ sx, int sz,
                             const float* __restrict__ wav, int it, int nxe,
                             int nze, pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;

  const float m = mask[j];
  const float pc = m * p[j];
  const float ppc = m * (m * pp[j]);
  const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                        ? pfdc::laplacian<H, true>(p, mask, j, nze, c)
                        : 0.0f;
  float u = (2.0f * pc - ppc) +
            v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
  if (ix == sx[s] && iz == sz) u = u + wav[it];
  pp[j] = u;
}

// All nt steps of rtm_fwd_step for the shot of this cluster (blockIdx.x /
// cluster size), each CTA a slab, each thread a strip (cluster_loop.cuh).
// The two levels of the field live in shared memory, one after the other,
// each with its halo rows; level L holds what buffer a (L = 0) or b (L = 1)
// holds after the per-step loop, times the mask. A thread keeps its cells'
// newest untapered values in registers (last), so the last step writes the
// newest field and the previous one, untapered, to a and b as that loop
// leaves them.
template <int H>
__global__ void __launch_bounds__(pfdc::kClusterThreads, 1)
    rtm_fwd_cluster(float* __restrict__ a, float* __restrict__ b,
                    const float* __restrict__ v2dt2, int v2_shot_stride,
                    const float* __restrict__ mask,
                    const int* __restrict__ sx, int sz,
                    const float* __restrict__ wav, int nxe, int nze,
                    int rows, int nt, pfdc::Coefs c) {
  constexpr int R = pfdc::kClusterRows, V = pfdc::kClusterCols;
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  extern __shared__ float smem[];
  const pfdc::Slab sl = pfdc::make_slab(cl, smem, rows, nxe, nze);
  const pfdc::Strip st = pfdc::strip_of(sl);
  const int s = blockIdx.x / cl.num_blocks();
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const size_t level = pfdc::level_floats<H>(sl);
  const int src_x = sx[s];
  for (size_t k = threadIdx.x; k < 2 * level; k += blockDim.x) smem[k] = 0.0f;
  // per-cell constants; 0 at a column group's padding, whose values stay 0
  float vr[R][V], mr[R][V], last[R][V];
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
      last[r][col] = 0.0f;
    }
  }
  cl.sync();
  // one step; the last (kLast) also writes the newest and the previous
  // field to a and b
  const auto step = [&](int it, auto last_step) {
    constexpr bool kLast = decltype(last_step)::value;
    const size_t cur = (it & 1) * level;
    const size_t old = level - cur;
    if (st.valid) {
      pfdc::Cols w[R + 2 * H];
      pfdc::load_window<H>(w, smem + cur, sl, st);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int lx = st.lx0 + r;
        if (lx >= sl.n) continue;
        const int gx = sl.x0 + lx;
        const bool x_in = gx >= H && gx < nxe - H;
        const int q = pfdc::level_cell<H>(sl, lx, st.iz0);
        float z[2 * pfdc::z_reach<H>() + V];
        pfdc::load_row<H>(z, smem + cur, sl, lx, st);
        const pfdc::Cols ps = pfdc::load_cols(smem + old + q);
        pfdc::Cols stored;
#pragma unroll
        for (int col = 0; col < V; ++col) {
          const int iz = st.iz0 + col;
          const float m = mr[r][col];
          const float lap = pfdc::cell_lap<H>(
              w, z, r, col, x_in && iz >= H && iz < nze - H, c);
          float u = (2.0f * w[r + H].v[col] - m * ps.v[col]) +
                    vr[r][col] * lap;
          if (gx == src_x && iz == sz) u = u + wav[it];
          stored.v[col] = m * u;
          if (kLast && iz < nze) {
            const size_t j = s * plane + static_cast<size_t>(gx) * nze + iz;
            ((nt & 1) ? b : a)[j] = u;
            ((nt & 1) ? a : b)[j] = last[r][col];
          }
          last[r][col] = u;
        }
        pfdc::store_cols(smem + old + q, stored);
        pfdc::push_halo<H>(sl, old, lx, st, stored);
      }
    }
    pfdc::step_barrier(cl);
  };
  for (int it = 0; it + 1 < nt; ++it) step(it, std::false_type{});
  if (nt > 0) step(nt - 1, std::true_type{});
  cl.sync();  // no neighbour writes this CTA's shared memory after it exits
}

struct FwdRun {
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const int* sx;
  int sz;
  const float* wav;  // device, nt samples
  int ns, nxe, nze, nt;
  pfdc::Coefs c;
  pfdc::ClusterPlan plan;  // plan.cluster == 0: the per-step route
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    if (plan.cluster) {
      return pfdc::launch_cluster(rtm_fwd_cluster<H>, plan, ns,
                                  plan.fwd_bytes, stream, a, b, v2dt2,
                                  v2_shot_stride, mask, sx, sz, wav, nxe, nze,
                                  plan.rows, nt, c);
    }
    const dim3 grid = pfdc::step_grid(ns, nxe, nze);
    const dim3 block = pfdc::step_block();
    for (int it = 0; it < nt; ++it) {
      float* cur = (it % 2 == 0) ? a : b;
      float* old = (it % 2 == 0) ? b : a;
      rtm_fwd_step<H><<<grid, block, 0, stream>>>(
          cur, old, v2dt2, v2_shot_stride, mask, sx, sz, wav, it, nxe, nze, c);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

struct FwdClusters {
  pfdc::ClusterPlan plan;
  int* out;
  template <int H>
  cudaError_t operator()() const {
    *out = pfdc::active_clusters(rtm_fwd_cluster<H>, plan, plan.fwd_bytes);
    return cudaSuccess;
  }
};

}  // namespace

// Runs nt steps of the forward propagation: rtm_fwd_cluster where the shot
// fits a cluster (pfdc::cluster_plan) and per_step is 0, else nt launches
// of rtm_fwd_step; *resident says which (1: the cluster kernel). a and b
// hold the two untapered fields (zeroed by the caller); after the loop the
// newest field is in b when nt is odd, else in a. wav is the nt-sample
// wavelet on the device. Returns a cudaError_t.
extern "C" int pfdc_rtm_fwd_run(float* a, float* b, const float* v2dt2,
                                int v2_shot_stride, const float* mask,
                                const int* sx, int sz, const float* wav,
                                int ns, int nxe, int nze, int nt, int order,
                                const float* cx, const float* cz,
                                int per_step, int* resident, void* stream) {
  pfdc::ClusterPlan plan;
  if (!per_step) plan = pfdc::cluster_plan(nxe, nze, order);
  *resident = plan.cluster != 0;
  const FwdRun run{a,   b,   v2dt2, v2_shot_stride, mask,
                   sx,  sz,  wav,   ns,             nxe,
                   nze, nt,  pfdc::make_coefs(order / 2, cx, cz), plan,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// The route rule at (nxe, nze, order) into out: cluster CTAs a shot (0:
// the per-step route), slab rows, threads a CTA, and the forward's and
// backward's dynamic shared memory a CTA. Returns 1 on the resident route,
// else 0.
extern "C" int pfdc_cluster_plan(int nxe, int nze, int order, int* out) {
  const pfdc::ClusterPlan p = pfdc::cluster_plan(nxe, nze, order);
  const int v[] = {p.cluster, p.rows, p.threads, p.fwd_bytes, p.bwd_bytes};
  for (int k = 0; k < 5; ++k) out[k] = v[k];
  return p.cluster != 0;
}

// The most clusters of rtm_fwd_cluster the card holds at once at (nxe, nze,
// order), or -1 where the shot takes the per-step route or on an error.
extern "C" int pfdc_rtm_fwd_clusters(int nxe, int nze, int order) {
  int n = -1;
  const FwdClusters f{pfdc::cluster_plan(nxe, nze, order), &n};
  if (f.plan.cluster) pfdc::dispatch_half(order, f);
  return n;
}
