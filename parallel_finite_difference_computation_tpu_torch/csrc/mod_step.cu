// mod_step: one time step of forward modeling (mod_main's loop,
// mod_main.cpp:146-168) for every shot of a batch; mod_cluster, all nt
// steps in one launch; and the C entry point pfdc_mod_run that runs the
// whole time loop on a stream, on one of two routes, chosen by the shape
// (pfdc::cluster_plan, as for the two-snapshot RTM's forward pass):
//
// - mod_cluster, where a shot fits a thread-block cluster: each shot's two
//   field levels held in its cluster's shared memory for all nt steps
//   (mod_loop, cluster_loop.cuh), recording the trace row or nothing;
// - mod_step elsewhere (Pluto's grid): one launch a step over all shots,
//   the host looping.
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_fd.py,
// _fwd_mod_kernel (:423), called through forward_modeling_pallas (:474).
// That kernel keeps one shot's fields in VMEM and runs all nt steps in one
// call, as the resident route keeps a shot in a cluster.
//
// What bounds mod_step on an H100: at the 3lay size (231 x 231 extended
// grid, 8 shots) a step touches 2 fields, v2*dt2 and the mask, about 7 MB,
// which stays in the 50 MB L2. Each cell does 2*h+1 taps per axis on one
// field. So the pace of a step is set by launch latency and L2 bandwidth,
// not by HBM: threads run along z for coalesced loads, neighbours come from
// L1/L2, and nothing is staged in shared memory. The resident route removes
// the launches and the L2 round trips.
//
// Taper without a race: the JAX loop tapers the old field in place while
// the same step reads it. Here both buffers hold fields as written (the new
// field is tapered once on write, as in the reference), the Laplacian
// reads the current field as stored, the older field is tapered on read
// (m * pp), and the recorded trace is m * p. The values equal the lax
// loop's, and no thread writes a cell another thread reads.
#include "cluster_loop.cuh"

namespace {

template <int H>
__global__ void mod_step(const float* __restrict__ cur, float* __restrict__ old,
                         const float* __restrict__ v2dt2, int v2_shot_stride,
                         const float* __restrict__ mask,
                         const float* __restrict__ patch, int r,
                         const int* __restrict__ sx, int sz, float amp,
                         float* __restrict__ seis_it, int seis_shot_stride,
                         int gz, int nxb, int nx, int nxe, int nze,
                         pfdc::Coefs c) {
  const int iz = blockIdx.x * blockDim.x + threadIdx.x;
  const int ix = blockIdx.y * blockDim.y + threadIdx.y;
  const int s = blockIdx.z;
  if (ix >= nxe || iz >= nze) return;
  const int j = ix * nze + iz;
  const size_t plane = static_cast<size_t>(nxe) * nze;
  const float* p = cur + s * plane;
  float* pp = old + s * plane;

  const float m = mask[j];
  const float pc = p[j];
  const float lap = pfdc::in_interior(ix, iz, H, nxe, nze)
                        ? pfdc::laplacian<H, false>(p, mask, j, nze, c)
                        : 0.0f;
  float u = (2.0f * pc - pp[j] * m) +
            v2dt2[s * static_cast<size_t>(v2_shot_stride) + j] * lap;
  const int dx = ix - sx[s];
  const int dz = iz - sz;
  if (dx >= -r && dx <= r && dz >= -r && dz <= r) {
    u = u + amp * patch[(dx + r) * (2 * r + 1) + (dz + r)];
  }
  pp[j] = u * m;
  if (iz == gz && ix >= nxb && ix < nxb + nx) {
    seis_it[s * static_cast<size_t>(seis_shot_stride) + (ix - nxb)] = pc * m;
  }
}

// mod_step's loop as one launch (mod_loop, cluster_loop.cuh): kRecord is
// pfdc::kRecordTrace (the trace row gz into g.rec) or pfdc::kRecordNone.
template <int H, int kRecord>
__global__ void __launch_bounds__(pfdc::kClusterThreads, 1)
    mod_cluster(pfdc::ModArgs g, pfdc::Coefs c) {
  extern __shared__ float smem[];
  pfdc::mod_loop<H, kRecord>(smem, g, c);
}

struct ModRun {
  pfdc::ModArgs g;   // g.wav: the device wavelet, for the resident route
  const float* wav;  // host, nt samples, for the per-step route
  int ns;
  bool trace;
  pfdc::Coefs c;
  pfdc::ClusterPlan plan;  // plan.cluster == 0: the per-step route
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    if (plan.cluster) {
      return trace ? pfdc::launch_cluster(mod_cluster<H, pfdc::kRecordTrace>,
                                          plan, ns, plan.fwd_bytes, stream, g,
                                          c)
                   : pfdc::launch_cluster(mod_cluster<H, pfdc::kRecordNone>,
                                          plan, ns, plan.fwd_bytes, stream, g,
                                          c);
    }
    const dim3 grid = pfdc::step_grid(ns, g.nxe, g.nze);
    const dim3 block = pfdc::step_block();
    for (int it = 0; it < g.nt; ++it) {
      float* cur = (it % 2 == 0) ? g.a : g.b;
      float* old = (it % 2 == 0) ? g.b : g.a;
      mod_step<H><<<grid, block, 0, stream>>>(
          cur, old, g.v2dt2, g.v2_shot_stride, g.mask, g.patch, g.r, g.sx,
          g.sz, wav[it], g.rec + static_cast<size_t>(it) * g.nx, g.nt * g.nx,
          g.gz, g.nxb, g.nx, g.nxe, g.nze, c);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

struct ModClusters {
  pfdc::ClusterPlan plan;
  int* out;
  template <int H>
  cudaError_t operator()() const {
    *out = pfdc::active_clusters(mod_cluster<H, pfdc::kRecordTrace>, plan,
                                 plan.fwd_bytes);
    return cudaSuccess;
  }
};

}  // namespace

// Runs nt steps of forward modeling: mod_cluster where the shot fits a
// cluster (pfdc::cluster_plan) and per_step is 0, else nt launches of
// mod_step; *resident says which (1: the cluster kernel). a and b hold the
// two fields (zeroed by the caller); after the loop the newest field is in
// b when nt is odd, else in a. wav is the nt-sample wavelet on the host (the
// per-step route passes a sample a launch), dwav the same on the device
// (the resident route). seis (ns, nt, nx) takes row gz of each step's
// field; record 0 leaves it unwritten on the resident route (the per-step
// route writes it always). Returns a cudaError_t.
extern "C" int pfdc_mod_run(float* a, float* b, const float* v2dt2,
                            int v2_shot_stride, const float* mask,
                            const float* patch, int r, const int* sx, int sz,
                            int gz, const float* wav, const float* dwav,
                            float* seis, int record, int ns, int nxe, int nze,
                            int nxb, int nx, int nt, int order,
                            const float* cx, const float* cz, int per_step,
                            int* resident, void* stream) {
  pfdc::ClusterPlan plan;
  if (!per_step) plan = pfdc::cluster_plan(nxe, nze, order);
  *resident = plan.cluster != 0;
  const pfdc::ModArgs g{a,  b,    v2dt2, v2_shot_stride, mask, patch, r,
                        sx, sz,   dwav,  seis,           gz,   nxb,   0,
                        nx, 0,    nxe,   nze,            plan.rows, nt};
  const ModRun run{g,
                   wav,
                   ns,
                   record != 0,
                   pfdc::make_coefs(order / 2, cx, cz),
                   plan,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// The most clusters of mod_cluster (the trace) the card holds at once at
// (nxe, nze, order), or -1 where the shot takes the per-step route or on
// an error.
extern "C" int pfdc_mod_clusters(int nxe, int nze, int order) {
  int n = -1;
  const ModClusters f{pfdc::cluster_plan(nxe, nze, order), &n};
  if (f.plan.cluster) pfdc::dispatch_half(order, f);
  return n;
}
