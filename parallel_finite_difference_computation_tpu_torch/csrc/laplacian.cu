// lap_apply: the order-2H interior Laplacian (kernel K1) of one (nx, nz)
// field, with a zero border of width H, and the C entry point pfdc_lap_run
// that launches it once on a stream. This is the reference's stencil
// program (cuda_reference_stencil_computation).
//
// Replaces: parallel_finite_difference_computation_tpu/ops/pallas_stencil.py,
// _kernel (:60), called through laplacian_pallas (:98). That kernel streams
// halo-extended row tiles HBM -> VMEM with a double-buffered DMA, because a
// large field does not fit in VMEM, and zeroes the z border outside the
// kernel.
//
// What bounds it on an H100: HBM. The field is read once and the result
// written once: at 8192 x 8192 that is 2 x 268 MB, 0.160 ms at 3.35 TB/s,
// against 6H+3 flop a cell at 33.5 TFLOP/s (-fmad=false): 0.055 ms at
// order 8, 0.103 ms at order 16. Those flop are also most of the
// instructions a cell, so the design keeps every other instruction out of
// the per-row loop.
//
// Design. A CTA owns a band of kLapBand output columns and walks down a run
// of output rows; the run comes from the grid (lap_shape), so that the
// launch makes about kLapWaves waves of kLapCtasPerSm CTAs an SM. The CTA's
// input rows, each the band and its halo columns, pass through a ring of
// Lap<H>::kSlots row buffers in dynamic shared memory: each row is copied
// by cp.async kAhead rows ahead of the newest row the threads read, one
// commit group a row, one barrier a row (the TPU kernel's double-buffered
// DMA, made deeper). A thread owns 2 adjacent columns and keeps their
// 2H + 1 x taps in a register window that slides down x. The row loop is
// unrolled kSlots times, a multiple of 2H + 1, so the window's registers,
// the ring's slots and every shared-memory offset are compile-time: no
// value moves and no index is computed a row. The z taps come from the
// centre row in the ring, loaded as float2s with the thread's neighbours'
// columns. So each input element leaves HBM once and crosses L2 -> SM
// about (1 + 2H/band)(1 + 2H/run) times. A slot holds its row by column,
// so that where nz % 4 == 0 and the field starts on 16 bytes rows are
// copied in 16-byte chunks and stored as float2s; elsewhere each element
// is a 4-byte copy and a 4-byte store. Copies skip what no output reads
// (rows and columns outside the field). The same launch writes the zero
// border.
//
// Rounding: the sums of pfdc::laplacian (stencil.cuh) in the JAX order,
// built with -fmad=false: bitwise ops/stencil.laplacian.
#include <cstdint>

#include "stencil.cuh"

#ifdef PFDC_CPU_SHIM
#include <cstring>
#include <vector>
#endif

namespace {

constexpr int kLapBand = 256;      // output columns a CTA
constexpr int kLapCols = 2;        // adjacent columns a thread: a float2
constexpr int kLapAhead = 4;       // rows in flight past the newest read,
                                   // at least
constexpr bool kLapWide = true;    // 16-byte copies where the field allows
constexpr int kLapCtasPerSm = 8;   // CTAs an SM holds, for the run rule
constexpr int kLapWaves = 2;       // waves of them the grid should make
constexpr int kLapMinRun = 4;      // the shortest run of output rows

// The shape of lap_apply at order 2H: its threads, the window, the ring.
template <int H>
struct Lap {
  static constexpr int kThreads = kLapBand / kLapCols;
  static constexpr int kG = 2 * H + 1;   // input row q at window slot q % kG
  // the ring's slots, a multiple of the window's, and the rows in flight
  // (at most 8: cp.async.wait_group 7)
  static constexpr int kSlots = kG * ((H + 1 + kLapAhead + kG - 1) / kG);
  static constexpr int kAhead = kSlots - H - 1 < 8 ? kSlots - H - 1 : 8;
  // the z taps a thread loads either side of its columns, in float2s
  static constexpr int kReach = (H + 1) / 2 * 2;
  // a slot: columns z0 - kLead .. z0 + kLapBand + kLead - 1 of its row
  static constexpr int kLead = (H + 3) / 4 * 4;
  static constexpr int kPitch = kLead + kLapBand + kLead;
  static constexpr int kBytes =
      kSlots * kPitch * static_cast<int>(sizeof(float));
  static_assert(kLapCols == 2 && kLapBand % kLapCols == 0 &&
                    kReach <= kLead,
                "a float2 a thread; the band");
  static_assert(kBytes <= 48 * 1024, "the ring needs no opt-in attribute");
};

#ifdef PFDC_CPU_SHIM
// The CPU shim: a thread's copies wait in their commit groups and land at
// the wait that completes their group, as late as cp.async allows, so that
// a read before its wait finds the NaNs the shared memory starts with; or,
// with pfdc_shim_copy_early set, as they are issued, as early as it allows,
// so that a slot overwritten before every thread has read it shows.
struct ShimCopy {
  float* dst;
  const float* src;
  int bytes;

  void land() const { std::memcpy(dst, src, bytes); }
};
thread_local std::vector<std::vector<ShimCopy>> shim_groups(1);
extern "C" {
int pfdc_shim_copy_early = 0;
}
#endif

// kBytes (16 or 4) from global to shared memory without a register; dst
// and src on kBytes.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef PFDC_CPU_SHIM
  const ShimCopy copy{dst, src, kBytes};
  if (pfdc_shim_copy_early) {
    copy.land();
  } else {
    shim_groups.back().push_back(copy);
  }
#else
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
#endif
}

// Closes this thread's commit group of one row's copies.
__device__ __forceinline__ void commit_row() {
#ifdef PFDC_CPU_SHIM
  shim_groups.emplace_back();
#else
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Waits until at most N of this thread's commit groups are pending; a
// __syncthreads() must follow before other threads read the rows.
template <int N>
__device__ __forceinline__ void wait_rows() {
#ifdef PFDC_CPU_SHIM
  while (shim_groups.size() > N + 1) {   // the closed groups, the open one
    for (const ShimCopy& c : shim_groups.front()) c.land();
    shim_groups.erase(shim_groups.begin());
  }
#else
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// kWide: nz % 4 == 0 and both fields on 16 bytes (16-byte copies, vector
// stores).
template <int H, bool kWide>
__global__ void __launch_bounds__(Lap<H>::kThreads)
    lap_apply(const float* __restrict__ p, float* __restrict__ out, int nx,
              int nz, int run, pfdc::Coefs c) {
  using L = Lap<H>;
  constexpr int C = kLapCols;
  constexpr int T = L::kThreads;
  constexpr int G = L::kG;
  constexpr int S = L::kSlots;
  constexpr int P = L::kPitch;
  // a thread's copies of a slot: 16-byte chunks or elements, T apart
  constexpr int kWidth = kWide ? 4 : 1;
  constexpr int kUnits = P / kWidth;
  constexpr int kPer = (kUnits + T - 1) / T;
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int z0 = blockIdx.x * kLapBand;
  const int x0 = blockIdx.y * run;
  const int rows = nx - x0 < run ? nx - x0 : run;   // output rows x0 + i
  // input row q is field row x0 - H + q; those in the field
  const int q_lo = H - x0 > 0 ? H - x0 : 0;
  const int q_hi = rows + 2 * H < nx - x0 + H ? rows + 2 * H : nx - x0 + H;
  bool unit_in[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int j = t + m * T;
    const int z = z0 - L::kLead + kWidth * j;   // whole chunks: nz % 4 == 0
    unit_in[m] = j < kUnits && z >= 0 && z < nz;
  }
  // this thread's first unit in input row q, advanced a row each stage
  const float* src = p + static_cast<long long>(x0 - H) * nz +
                     (z0 - L::kLead + kWidth * t);
  float* const dst = smem + kWidth * t;

  // Copies the next input row q into slot `slot`.
  auto stage = [&](int q, int slot) {
    if (q >= q_lo && q < q_hi) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        if (unit_in[m]) {
          copy_async<4 * kWidth>(dst + slot * P + kWidth * m * T,
                                 src + kWidth * m * T);
        }
      }
    }
    commit_row();
    src += nz;
  };

  // the thread's columns zt + col, and which of them are kept
  const int zt = z0 + C * t;
  bool col_in[C], col_kept[C];
#pragma unroll
  for (int col = 0; col < C; ++col) {
    col_in[col] = zt + col < nz;
    col_kept[col] = zt + col >= H && zt + col < nz - H;
  }
  const float* const mine = smem + L::kLead + C * t;   // column zt, slot 0
  float* orow = out + static_cast<size_t>(x0) * nz + zt;
  float win[C][G];

#pragma unroll
  for (int q = 0; q < L::kAhead; ++q) stage(q, q);
  for (int i0 = -2 * H; i0 < rows; i0 += S) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      // output row x0 + i; its newest input row qn = i + 2H lies in slot k
      // and window slot k % G
      const int i = i0 + k;
      if (i < rows) {
        wait_rows<L::kAhead - 1>();
        __syncthreads();
        stage(i + 2 * H + L::kAhead, (k + L::kAhead) % S);
        const float2 a = *reinterpret_cast<const float2*>(mine + k * P);
        win[0][k % G] = a.x;
        win[1][k % G] = a.y;
        if (i >= 0) {
          // the centre row qn - H: columns zt - kReach .. zt + C - 1 +
          // kReach at zr[0 ..]
          constexpr int W = 2 * L::kReach + C;
          const float* f = mine + ((k - H + S) % S) * P - L::kReach;
          float zr[W];
#pragma unroll
          for (int v = 0; v < W / 2; ++v) {
            const float2 u = *reinterpret_cast<const float2*>(f + 2 * v);
            zr[2 * v] = u.x;
            zr[2 * v + 1] = u.y;
          }
          const int ix = x0 + i;
          const bool row_kept = ix >= H && ix < nx - H;
          float y[C];
#pragma unroll
          for (int col = 0; col < C; ++col) {
            // zr[kReach + col + d]: column zt + col + d of the centre row;
            // win[col][(k - H + d) mod G]: row qn - H + d of the column
            const float* fz = zr + L::kReach + col;
            const float centre = win[col][(k - H + G) % G];
            float accz = c.z[H] * (fz[-H] + fz[H]);
#pragma unroll
            for (int m = H - 1; m >= 1; --m) {
              accz = accz + c.z[m] * (fz[-m] + fz[m]);
            }
            accz = accz + c.z[0] * centre;
            float accx = c.x[H] * (win[col][(k - 2 * H + 2 * G) % G] +
                                   win[col][k % G]);
#pragma unroll
            for (int m = H - 1; m >= 1; --m) {
              accx = accx + c.x[m] * (win[col][(k - H - m + 2 * G) % G] +
                                      win[col][(k - H + m + 2 * G) % G]);
            }
            accx = accx + c.x[0] * centre;
            y[col] = row_kept && col_kept[col] ? accz + accx : 0.0f;
          }
          if constexpr (kWide) {
            if (col_in[0]) {
              *reinterpret_cast<float2*>(orow) = make_float2(y[0], y[1]);
            }
          } else {
#pragma unroll
            for (int col = 0; col < C; ++col) {
              if (col_in[col]) orow[col] = y[col];
            }
          }
          orow += nz;
        }
      }
    }
  }
}

// The launch over an (nx, nz) field on a device of sms SMs: bands x runs
// CTAs, each a run of `run` output rows.
struct LapShape {
  int bands, runs, run;
};

LapShape lap_shape(int nx, int nz, int sms) {
  const int bands = (nz + kLapBand - 1) / kLapBand;
  const long long want = static_cast<long long>(kLapWaves) * kLapCtasPerSm *
                         (sms > 0 ? sms : 1);
  const long long per_band = (want + bands - 1) / bands;
  long long run = (nx + per_band - 1) / per_band;
  if (run < kLapMinRun) run = kLapMinRun;
  return {bands, static_cast<int>((nx + run - 1) / run),
          static_cast<int>(run)};
}

cudaError_t device_sms(int& sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

struct LapRun {
  const float* p;
  float* out;
  int nx, nz;
  pfdc::Coefs c;
  cudaStream_t stream;

  template <int H>
  cudaError_t operator()() const {
    int sms = 0;
    const cudaError_t e = device_sms(sms);
    if (e != cudaSuccess) return e;
    const LapShape s = lap_shape(nx, nz, sms);
    const dim3 grid(s.bands, s.runs);
    const dim3 block(Lap<H>::kThreads);
    const size_t bytes = Lap<H>::kBytes;
    const bool aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (kLapWide && aligned && nz % 4 == 0) {
      lap_apply<H, true><<<grid, block, bytes, stream>>>(p, out, nx, nz,
                                                         s.run, c);
    } else {
      lap_apply<H, false><<<grid, block, bytes, stream>>>(p, out, nx, nz,
                                                          s.run, c);
    }
    return cudaGetLastError();
  }
};

// Its threads a CTA and ring bytes at order 2H, into out[0], out[1].
struct LapSizes {
  int* out;

  template <int H>
  cudaError_t operator()() const {
    out[0] = Lap<H>::kThreads;
    out[1] = Lap<H>::kBytes;
    return cudaSuccess;
  }
};

}  // namespace

// One launch of lap_apply over the (nx, nz) field p into out, which must
// not overlap p. Returns a cudaError_t.
extern "C" int pfdc_lap_run(const float* p, float* out, int nx, int nz,
                            int order, const float* cx, const float* cz,
                            void* stream) {
  const LapRun run{p, out, nx, nz, pfdc::make_coefs(order / 2, cx, cz),
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

// The launch pfdc_lap_run makes over an (nx, nz) field at `order` on the
// current device, into out: bands, runs, rows a run, columns a band,
// threads a CTA and the ring's bytes of dynamic shared memory. Returns a
// cudaError_t.
extern "C" int pfdc_lap_shape(int nx, int nz, int order, int* out) {
  int sms = 0;
  const cudaError_t e = device_sms(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const LapShape s = lap_shape(nx, nz, sms);
  out[0] = s.bands;
  out[1] = s.runs;
  out[2] = s.run;
  out[3] = kLapBand;
  return static_cast<int>(pfdc::dispatch_half(order, LapSizes{out + 4}));
}
