// The cluster-resident time loop of the exact two-snapshot RTM kernels
// (rtm_fwd_cluster in rtm_fwd_step.cu, rtm_bwd_cluster in rtm_bwd_step.cu)
// and of the exact CPU-flavor kernels (mod_loop below: mod_cluster in
// mod_step.cu, rec_fwd_cluster and rec_bwd_cluster in rec_step.cu): one
// launch runs all nt steps of a pass for every shot of a batch.
//
// The TPU kernels they replace (ops/pallas_fd.py _rtm_kernel :534,
// _fwd_gpu_kernel :702, _bwd_gpu_kernel :729) keep one shot in VMEM for all
// nt steps. One SM cannot hold a shot (3lay: 231 x 231 x 4 B = 209 KiB a
// field, the backward needs four), but a thread-block cluster can: each
// shot is one cluster, and each CTA of it owns a slab of whole x rows
// (rows [x0, x0 + n), all nze columns: the (nxe, nze) layout, z
// contiguous), the slabs' rows differing by one at most. The slab's field
// levels live in the CTA's dynamic shared memory for the whole loop, each
// with H halo rows above and below the slab. A thread that computes one of
// the slab's first or last H rows also stores the value into the
// neighbour CTA's halo rows of the same level through distributed shared
// memory (map_shared_rank), so every read of a step is a local one: a
// remote store does not wait, a remote load does (reading the neighbour's
// rows at each tap instead cost the forward 2.0 of its 5.3 ms at 3lay on
// an H100, PERF.md). Every slab holds at least H rows, so a halo row
// comes from the next CTA only.
//
// One cluster barrier a step: step t reads the current level everywhere
// and the older level only at a thread's own cells, and writes the new
// value into the older level at those same cells and the neighbours' halo
// copies of them. So one cluster.sync() between steps orders every read of
// step t before the writes of step t + 1, and the halo stores of step t
// before the reads of step t + 1. A first cluster.sync() comes before any
// store to a neighbour (all CTAs have started and zeroed their levels),
// and a last one before any CTA exits (no neighbour writes a CTA's shared
// memory after it has left).
//
// A thread owns one strip of kClusterRows x kClusterCols cells (lanes
// along z), read and written kClusterCols floats at a time: rows are padded
// with zeros to a 16-byte pitch. The strip's x taps come from a register
// window of kClusterRows + 2H vectors, each row's z taps from a register
// window of its columns and H on each side (a 7-shot forward pass at 3lay:
// 2.58 ms, one column a lane 3.00 in the same run). Per-cell constants
// (v2*dt2, the mask, the backward's image sum) stay in registers for all
// nt steps; the image goes to global memory once, at the end. A shot whose
// slabs need more strips than a CTA has threads takes the per-step route.
//
// Rounding: the taps keep pfdc::laplacian's order (stencil.cuh): one
// accumulator per axis, pairs in descending k, the centre last, then
// accz + accx; built with -fmad=false, bitwise the per-step kernels and the
// plain version. A tapered field is stored as m * u: a tap reads the stored
// product, which rounds as forming m * p at the tap does, and the older
// level is read as m * (m * u) = m * stored. (Storing u and reading the
// mask at every tap cost the forward 2.3x at 3lay, PERF.md.)
//
// What bounds it on an H100: the instructions a step issues (the fp32
// operations of the taps, -fmad=false, and the shared-memory vector
// loads), not HBM; plus the cluster barrier, ~0.8 us a step at 3lay. The
// card holds 7 clusters of 16 at once (one GPC each), so 8 shots run in
// two waves; clusters of 9 run them in one but take 1.5x as long a shot
// (scripts/torch_step_probe.py --rtm; PERF.md).
#pragma once

#include <cooperative_groups.h>

#include "kstep.cuh"

namespace pfdc {

// The route rule's constants. Cluster sizes are tried in turn: 16 CTAs
// need the non-portable cluster size.
constexpr int kClusterSizes[] = {16, 8, 4, 2};
constexpr int kClusterRows = 4;       // rows of a thread's strip (x)
constexpr int kClusterCols = 2;       // columns of a thread's strip (z)
constexpr int kClusterZPad = 8;       // zero columns on each side of a row
constexpr int kClusterThreads = 512;  // threads of a CTA, at most
constexpr int kClusterLevels = 4;     // the backward's: 2 fields x 2 levels
static_assert(kClusterZPad >= kMaxHalf && kClusterZPad % 4 == 0 &&
                  4 % kClusterCols == 0,
              "a row's z taps and vectors stay inside its padded pitch");

// Floats of a level's row: nze columns and kClusterZPad zeros on each side,
// rounded up to 16 bytes, so that every column group of kClusterCols
// starts on a vector.
__host__ __device__ constexpr int cluster_pitch(int nze) {
  return (nze + 2 * kClusterZPad + 3) / 4 * 4;
}

// How a shot runs on the resident route: cluster CTAs (0: the shot does not
// fit, the per-step kernels run), each a slab of rows or rows - 1 x nze
// cells, threads a CTA (one strip each), and the dynamic shared memory of
// a forward and a backward CTA (its levels, H halo rows on each side).
struct ClusterPlan {
  int cluster = 0;
  int rows = 0;
  int threads = 0;
  int fwd_bytes = 0;
  int bwd_bytes = 0;
};

// The route rule: the first cluster size whose slabs hold at least H rows
// each, whose strips are at most kClusterThreads and whose backward levels
// fit a CTA's shared memory.
inline ClusterPlan cluster_plan(int nxe, int nze, int order) {
  ClusterPlan p;
  const int h = order / 2;
  if (order % 2 || h < 1 || h > kMaxHalf) return p;
  for (const int cs : kClusterSizes) {
    const int rows = (nxe + cs - 1) / cs;
    if (nxe / cs < h) continue;
    const long strips =
        static_cast<long>((rows + kClusterRows - 1) / kClusterRows) *
        ((nze + kClusterCols - 1) / kClusterCols);
    const long bytes = sizeof(float) * kClusterLevels *
                       static_cast<long>(rows + 2 * h) * cluster_pitch(nze);
    if (strips > kClusterThreads || bytes > kMaxSmemBytes) continue;
    p.cluster = cs;
    p.rows = rows;
    p.threads = static_cast<int>((strips + 31) / 32 * 32);
    p.fwd_bytes = static_cast<int>(bytes / 2);
    p.bwd_bytes = static_cast<int>(bytes);
    return p;
  }
  return p;
}

// One CTA's slab: rows [x0, x0 + n) of the shot's nxe, the first nxe % cs
// slabs one row more than the others; prev and next are the neighbour
// CTAs' dynamic shared memory (nullptr at the grid's edges), prev_n the
// rows of the previous slab. A level is (rows + 2H) rows of pitch floats,
// slab row lx at row lx + H, column iz at kClusterZPad + iz (level_cell).
struct Slab {
  int x0, n, prev_n, rows, nxe, nze, pitch;
  float* prev;
  float* next;
};

__device__ __forceinline__ Slab make_slab(cooperative_groups::cluster_group& cl,
                                          float* smem, int rows, int nxe,
                                          int nze) {
  const int rank = static_cast<int>(cl.block_rank());
  const int cs = static_cast<int>(cl.num_blocks());
  const int small = nxe / cs, extra = nxe % cs;
  Slab s;
  s.x0 = rank * small + (rank < extra ? rank : extra);
  s.n = small + (rank < extra);
  s.prev_n = small + (rank - 1 < extra);
  s.rows = rows;
  s.nxe = nxe;
  s.nze = nze;
  s.pitch = cluster_pitch(nze);
  s.prev = rank > 0 ? cl.map_shared_rank(smem, rank - 1) : nullptr;
  s.next = rank + 1 < cs ? cl.map_shared_rank(smem, rank + 1) : nullptr;
  return s;
}

// Floats of a level, and the index of slab row lx, column iz in one.
template <int H>
__device__ __forceinline__ size_t level_floats(const Slab& s) {
  return static_cast<size_t>(s.rows + 2 * H) * s.pitch;
}

template <int H>
__device__ __forceinline__ int level_cell(const Slab& s, int lx, int iz) {
  return (lx + H) * s.pitch + kClusterZPad + iz;
}

// kClusterCols floats read and written as one vector.
struct __align__(4 * kClusterCols) Cols {
  float v[kClusterCols];
};

__device__ __forceinline__ Cols load_cols(const float* p) {
  return *reinterpret_cast<const Cols*>(p);
}

__device__ __forceinline__ void store_cols(float* p, const Cols& c) {
  *reinterpret_cast<Cols*>(p) = c;
}

// A thread's strip: rows lx0 .. lx0 + kClusterRows - 1 and columns iz0 ..
// iz0 + kClusterCols - 1 of the slab (those below s.n and s.nze are the
// thread's cells; the others of a column group are padding, kept 0).
struct Strip {
  bool valid;
  int lx0, iz0;
};

__device__ __forceinline__ Strip strip_of(const Slab& s) {
  const int t = threadIdx.x;
  const int groups = (s.nze + kClusterCols - 1) / kClusterCols;
  const int strips = (s.rows + kClusterRows - 1) / kClusterRows * groups;
  return {t < strips, t / groups * kClusterRows, t % groups * kClusterCols};
}

// The x window of strip st in level lvl (this CTA's shared memory): rows
// st.lx0 - H .. st.lx0 + kClusterRows + H - 1 of its columns, halo rows
// included, those no cell of the slab reads (H or more past the slab) 0.
template <int H>
__device__ __forceinline__ void load_window(Cols (&w)[kClusterRows + 2 * H],
                                            const float* lvl, const Slab& s,
                                            Strip st) {
#pragma unroll
  for (int q = 0; q < kClusterRows + 2 * H; ++q) {
    const int lx = st.lx0 - H + q;
    w[q] = lx < s.n + H ? load_cols(lvl + level_cell<H>(s, lx, st.iz0))
                        : Cols{};
  }
}

// The z window of slab row lx of strip st in level lvl: columns st.iz0 - Z
// .. st.iz0 + kClusterCols + Z - 1, Z = H rounded up to kClusterCols, the
// padding's zeros outside the grid.
template <int H>
__host__ __device__ constexpr int z_reach() {
  return (H + kClusterCols - 1) / kClusterCols * kClusterCols;
}

template <int H>
__device__ __forceinline__ void load_row(
    float (&z)[2 * z_reach<H>() + kClusterCols], const float* lvl,
    const Slab& s, int lx, Strip st) {
  const float* row = lvl + level_cell<H>(s, lx, st.iz0) - z_reach<H>();
#pragma unroll
  for (int k = 0; k < (2 * z_reach<H>() + kClusterCols) / kClusterCols; ++k) {
    const Cols c = load_cols(row + k * kClusterCols);
#pragma unroll
    for (int j = 0; j < kClusterCols; ++j) z[k * kClusterCols + j] = c.v[j];
  }
}

// Stores c, the new values of slab row lx of strip st in the level at
// offset off, into the halo rows of the neighbours that read them: the
// slab's first H rows are the previous CTA's last halo rows, its last H
// rows the next CTA's first. A remote store does not wait.
template <int H>
__device__ __forceinline__ void push_halo(const Slab& s, size_t off, int lx,
                                          Strip st, const Cols& c) {
  if (lx < H && s.prev != nullptr) {
    store_cols(s.prev + off + level_cell<H>(s, s.prev_n + lx, st.iz0), c);
  }
  if (lx >= s.n - H && s.next != nullptr) {
    store_cols(s.next + off + level_cell<H>(s, lx - s.n, st.iz0), c);
  }
}

// The barrier between two steps of the resident loop: one a step.
__device__ __forceinline__ void step_barrier(
    cooperative_groups::cluster_group& cl) {
  cl.sync();
}

// The Laplacian of cell (r, col) of a strip, or 0 outside the interior, as
// the per-step kernels take it, in pfdc::laplacian's order: the z taps from
// its row's z window z, the x taps from the window w. Every tap of every
// cell lies in the level (halo rows, the rows' zero padding; a row's last
// column group may reach the next row's padding), so the taps are summed
// for every cell and the interior selected without a branch.
template <int H>
__device__ __forceinline__ float cell_lap(
    const Cols (&w)[kClusterRows + 2 * H],
    const float (&z)[2 * z_reach<H>() + kClusterCols], int r, int col,
    bool interior, const Coefs& c) {
  constexpr int Z = z_reach<H>();
  const auto t = [&](int k) { return z[Z + col + k]; };
  const float centre = w[r + H].v[col];
  float accz = c.z[H] * (t(-H) + t(H));
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accz = accz + c.z[k] * (t(-k) + t(k));
  }
  accz = accz + c.z[0] * centre;
  float accx = c.x[H] * (w[r].v[col] + w[r + 2 * H].v[col]);
#pragma unroll
  for (int k = H - 1; k >= 1; --k) {
    accx = accx + c.x[k] * (w[r + H - k].v[col] + w[r + H + k].v[col]);
  }
  accx = accx + c.x[0] * centre;
  const float lap = accz + accx;
  return interior ? lap : 0.0f;
}

// What the CPU-flavor loop records each step: nothing, the trace row
// (mod_step at gz), the interior frame (rec_fwd_step, rec_bwd_step's frame
// mode) or the image, the frame correlated with the source wavefield read
// back in reverse (rec_bwd_step's image mode).
constexpr int kRecordNone = 0;
constexpr int kRecordTrace = 1;
constexpr int kRecordFrames = 2;
constexpr int kRecordImage = 3;

// The arguments of the modeling loop (mod_loop with the source's patch):
// the two fields (zeroed by the caller), v2*dt2, the taper mask, the source
// patch of radius r around (sx[s], sz), the nt-sample wavelet on the
// device, and what is recorded: rec is (ns, nt, nx) traces of row gz
// (kRecordTrace) or (ns, nt, nx, nz) interior frames (kRecordFrames); nxb,
// nzb the borders.
struct ModArgs {
  static constexpr bool kPatch = true;
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* patch;
  int r;
  const int* sx;
  int sz;
  const float* wav;
  float* rec;
  int gz, nxb, nzb, nx, nz;
  int nxe, nze, rows, nt;
};

// The arguments of the receiver loop (mod_loop with an injection row,
// rec_bwd_step's): the two fields (zeroed by the caller), v2*dt2, the
// taper mask, the (ns, nt, nx) injection rows, added on row gz at x0 <= x
// < x0 + nx (x0 clamped into the grid by the caller), and what is
// recorded: rec is (ns, nt, nx, nz) interior frames (kRecordFrames), or
// with swf, the (ns, nt, nx, nz) source frames, the (ns, nx, nz) images
// (kRecordImage).
struct RecvArgs {
  static constexpr bool kPatch = false;
  float* a;
  float* b;
  const float* v2dt2;
  int v2_shot_stride;
  const float* mask;
  const float* inj;
  int x0;
  const float* swf;
  float* rec;
  int gz, nxb, nzb, nx, nz;
  int nxe, nze, rows, nt;
};

// The source's x of shot s (mod_loop with the patch).
template <class Args>
__device__ __forceinline__ int source_x(const Args& g, int s) {
  if constexpr (Args::kPatch) {
    return g.sx[s];
  } else {
    return 0;
  }
}

// All nt steps of the CPU-flavor step (mod_step.cu, rec_step.cu) for the
// shot of this cluster, on the resident loop of rtm_fwd_cluster
// (rtm_fwd_step.cu): u = (2p - m*pp) + v2dt2*lap(p), the source added into
// u (Args::kPatch: the patch where its window covers the cell, scaled by
// the wavelet; else the injection row), stored as m*u, the record m*p of
// the time-t field. The levels hold what the per-step kernels' buffers
// hold (the stored m*u), so level L is buffer a (L = 0) or b (L = 1) of the
// per-step loop, and the last step writes the newest stored field and the
// previous one into a and b as that loop leaves them (not in image mode:
// the image is the result).
// A thread reads its cells' patch values once, into registers (reading the
// patch at each step cost the modeling 7 % at 3lay on an H100, PERF.md),
// and records the trace row only where its column group holds gz; the
// frames are stored as scalars (pairs of columns as one vector where a
// frame row allows cost 6 %). Every global value a step reads (the
// wavelet sample, the injection row's samples of the thread's cells, in
// image mode their source frame values) is loaded a step ahead, into
// registers, by the threads that use it: a load a warp waits on at its
// step holds the whole cluster at the barrier. The image of a thread's
// cells is summed in registers, img = img + swf * (m*p) in time order from
// 0, as rec_bwd_step sums it in the zeroed image, and written once at the
// end.
template <int H, int kRecord, class Args>
__device__ __forceinline__ void mod_loop(float* smem, const Args& g,
                                         const Coefs& c) {
  constexpr int R = kClusterRows, V = kClusterCols;
  constexpr bool kPatch = Args::kPatch;
  constexpr bool kImage = kRecord == kRecordImage;
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const Slab sl = make_slab(cl, smem, g.rows, g.nxe, g.nze);
  const Strip st = strip_of(sl);
  const int s = blockIdx.x / cl.num_blocks();
  const size_t plane = static_cast<size_t>(g.nxe) * g.nze;
  const size_t level = level_floats<H>(sl);
  const int src_x = source_x(g, s);
  const bool trace = kRecord == kRecordTrace && st.valid &&
                     g.gz >= st.iz0 && g.gz < st.iz0 + V;
  float* const rec_shot =
      kRecord == kRecordNone
          ? nullptr
      : kImage ? g.rec + static_cast<size_t>(s) * g.nx * g.nz
               : g.rec + static_cast<size_t>(s) * g.nt * g.nx *
                             (kRecord == kRecordFrames ? g.nz : 1);
  for (size_t k = threadIdx.x; k < 2 * level; k += blockDim.x) smem[k] = 0.0f;
  // per-cell constants; 0 at a column group's padding, whose values stay 0;
  // the source's patch value of each cell in its window (bit r * V + col
  // of pw)
  float vr[R][V], mr[R][V], pr[R][V];
  unsigned pw = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int col = 0; col < V; ++col) {
      const int lx = st.lx0 + r, iz = st.iz0 + col;
      const bool own = st.valid && lx < sl.n && iz < g.nze;
      const int j = (sl.x0 + lx) * g.nze + iz;
      vr[r][col] =
          own ? g.v2dt2[s * static_cast<size_t>(g.v2_shot_stride) + j] : 0.0f;
      mr[r][col] = own ? g.mask[j] : 0.0f;
      if constexpr (kPatch) {
        const int dx = sl.x0 + lx - src_x, dz = iz - g.sz;
        const bool in_w =
            own && dx >= -g.r && dx <= g.r && dz >= -g.r && dz <= g.r;
        pr[r][col] =
            in_w ? g.patch[(dx + g.r) * (2 * g.r + 1) + (dz + g.r)] : 0.0f;
        pw |= static_cast<unsigned>(in_w) << (r * V + col);
      }
    }
  }
  // the receiver loop's operands: the injection row's cells of the thread
  // (bit r of rw: row r of the strip takes inj[s, it, x - x0] at column
  // gz), their samples of the next step (in_next), and in image mode the
  // frame cells of the strip (bit r * V + col of fw: interior, at offset
  // f0 + r * nz + col of a frame), their source frame values of the next
  // step (sw_next) and the image sums (acc)
  unsigned rw = 0, fw = 0;
  float in_next[R], sw_next[R][V], acc[R][V];
  const float* inj_shot = nullptr;
  const float* swf_shot = nullptr;
  const int f0 = (sl.x0 + st.lx0 - g.nxb) * g.nz + (st.iz0 - g.nzb);
  if constexpr (!kPatch) {
    inj_shot = g.inj + static_cast<ptrdiff_t>(s) * g.nt * g.nx +
               (sl.x0 + st.lx0 - g.x0);
    const bool row = st.valid && g.gz >= st.iz0 && g.gz < st.iz0 + V;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gx = sl.x0 + st.lx0 + r;
      rw |= static_cast<unsigned>(row && st.lx0 + r < sl.n && gx >= g.x0 &&
                                  gx < g.x0 + g.nx)
            << r;
      in_next[r] = (rw >> r) & 1u && g.nt > 0 ? inj_shot[r] : 0.0f;
    }
    if constexpr (kImage) {
      swf_shot = g.swf + static_cast<ptrdiff_t>(s) * g.nt * g.nx * g.nz;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int col = 0; col < V; ++col) {
          const int gx = sl.x0 + st.lx0 + r, iz = st.iz0 + col;
          fw |= static_cast<unsigned>(st.valid && st.lx0 + r < sl.n &&
                                      gx >= g.nxb && gx < g.nxb + g.nx &&
                                      iz >= g.nzb && iz < g.nzb + g.nz)
                << (r * V + col);
          acc[r][col] = 0.0f;
        }
      }
      // frame nt - 1 of the source wavefield is the first step's
      const float* frame =
          swf_shot + static_cast<ptrdiff_t>(g.nt - 1) * g.nx * g.nz + f0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int col = 0; col < V; ++col) {
          sw_next[r][col] = (fw >> (r * V + col)) & 1u && g.nt > 0
                                ? frame[r * g.nz + col]
                                : 0.0f;
        }
      }
    }
  }
  cl.sync();
  // the wavelet sample of the step, loaded a step ahead by the threads the
  // source's window covers (the 3lay frames' loop 5 % faster than with
  // the load at the step, PERF.md)
  float amp_next = 0.0f;
  if constexpr (kPatch) amp_next = pw && g.nt > 0 ? g.wav[0] : 0.0f;
  // one step; the last (kLast) also writes the newest and the previous
  // stored field to a and b
  const auto step = [&](int it, auto last_step) {
    constexpr bool kLast = decltype(last_step)::value;
    const size_t cur = (it & 1) * level;
    const size_t old = level - cur;
    if (st.valid) {
      float amp = 0.0f;
      if constexpr (kPatch) {
        amp = amp_next;
        if (pw && it + 1 < g.nt) amp_next = g.wav[it + 1];
      }
      float in_now[R], sw_now[R][V];
      if constexpr (!kPatch) {
        const bool ahead = it + 1 < g.nt;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          in_now[r] = in_next[r];
          if ((rw >> r) & 1u && ahead) {
            in_next[r] = inj_shot[static_cast<ptrdiff_t>(it + 1) * g.nx + r];
          }
        }
        if constexpr (kImage) {
          const float* frame =
              swf_shot +
              static_cast<ptrdiff_t>(g.nt - 2 - it) * g.nx * g.nz + f0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int col = 0; col < V; ++col) {
              sw_now[r][col] = sw_next[r][col];
              if ((fw >> (r * V + col)) & 1u && ahead) {
                sw_next[r][col] = frame[r * g.nz + col];
              }
            }
          }
        }
      }
      Cols w[R + 2 * H];
      load_window<H>(w, smem + cur, sl, st);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int lx = st.lx0 + r;
        if (lx >= sl.n) continue;
        const int gx = sl.x0 + lx;
        const bool x_in = gx >= H && gx < g.nxe - H;
        const int q = level_cell<H>(sl, lx, st.iz0);
        float z[2 * z_reach<H>() + V];
        load_row<H>(z, smem + cur, sl, lx, st);
        const Cols ps = load_cols(smem + old + q);
        Cols stored;
#pragma unroll
        for (int col = 0; col < V; ++col) {
          const int iz = st.iz0 + col;
          const float m = mr[r][col];
          const float centre = w[r + H].v[col];
          const float lap = cell_lap<H>(
              w, z, r, col, x_in && iz >= H && iz < g.nze - H, c);
          float u = (2.0f * centre - m * ps.v[col]) + vr[r][col] * lap;
          if constexpr (kPatch) {
            if ((pw >> (r * V + col)) & 1u) u = u + amp * pr[r][col];
          } else {
            if ((rw >> r) & 1u && iz == g.gz) u = u + in_now[r];
          }
          stored.v[col] = m * u;
          if (trace && iz == g.gz && gx >= g.nxb && gx < g.nxb + g.nx) {
            rec_shot[static_cast<size_t>(it) * g.nx + (gx - g.nxb)] =
                m * centre;
          }
          if (kRecord == kRecordFrames && gx >= g.nxb &&
              gx < g.nxb + g.nx && iz >= g.nzb && iz < g.nzb + g.nz) {
            rec_shot[(static_cast<size_t>(it) * g.nx + (gx - g.nxb)) * g.nz +
                     (iz - g.nzb)] = m * centre;
          }
          if constexpr (kImage) {
            if ((fw >> (r * V + col)) & 1u) {
              acc[r][col] = acc[r][col] + sw_now[r][col] * (m * centre);
            }
          }
          if (kLast && !kImage && iz < g.nze) {
            const size_t j =
                s * plane + static_cast<size_t>(gx) * g.nze + iz;
            ((g.nt & 1) ? g.b : g.a)[j] = stored.v[col];
            ((g.nt & 1) ? g.a : g.b)[j] = centre;
          }
        }
        store_cols(smem + old + q, stored);
        push_halo<H>(sl, old, lx, st, stored);
      }
    }
    step_barrier(cl);
  };
  for (int it = 0; it + 1 < g.nt; ++it) step(it, std::false_type{});
  if (g.nt > 0) step(g.nt - 1, std::true_type{});
  cl.sync();  // no neighbour writes this CTA's shared memory after it exits
  if constexpr (kImage) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int col = 0; col < V; ++col) {
        if ((fw >> (r * V + col)) & 1u) rec_shot[f0 + r * g.nz + col] =
            acc[r][col];
      }
    }
  }
}

// Launches kernel over ns shots, one cluster of plan.cluster CTAs a shot,
// with bytes of dynamic shared memory a CTA. A cluster the card cannot
// hold (cudaOccupancyMaxActiveClusters of 0) is refused; there is no
// fallback.
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, const ClusterPlan& plan, int ns,
                           int bytes, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && plan.cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cluster * ns);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) return e;
  if (active < 1) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The most clusters of kernel the card holds at once at plan, or -1 on an
// error (a diagnostic for the probe and chip_smoke.py).
template <class Kernel>
int active_clusters(Kernel kernel, const ClusterPlan& plan, int bytes) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.cluster);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  return cudaOccupancyMaxActiveClusters(
             &active, reinterpret_cast<const void*>(kernel), &cfg) == cudaSuccess
             ? active
             : -1;
}

}  // namespace pfdc
