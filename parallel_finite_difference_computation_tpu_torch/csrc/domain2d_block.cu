// domain2d_block: the (x, z)-domain tier's three block kernels, each K time
// steps on one halo-extended (x, z) tile for every shot of a batch: the C
// entry points pfdc_block2_{mod,fwd,bwd}_run and, with the x taps in split
// bf16, pfdc_block2_{mod,fwd,bwd}_mma_run (each, as the exact kernels,
// two launches for a block of more than 4 steps) of the kernels in
// domain_block.cuh, which the x tier shares.
//
// Replaces: parallel_finite_difference_computation_tpu/parallel/
// domain2d_pallas.py, _mod2_block_kernel (:178), _fwd2_block_kernel (:99)
// and _bwd2_block_kernel (:124), called by
// make_sharded_forward_modeling_2d_pallas (:453) and
// make_sharded_rtm_snapshot_2d_pallas (:296): block2_* their exact taps,
// block2_*_mma their use_mxu lowering (_use_mxu_lap, :234-239).
//
// The tile. Both grid axes are cut, x into n_x parts of nxl rows and z into
// n_z parts of nzl columns (zero-padded); tile (j, l) holds its nxl x nzl
// owned cells, hs = K*h rows of halo on each x side (0 when n_x = 1) and hz
// = K*h columns on each z side (0 when n_z = 1), filled by the caller's
// two-stage exchange once per block: z first on the owned rows of every
// tile, then x on the whole z-extended rows, so that the corners come from
// the diagonal neighbours. Buffers are (ns, nxw, nzw), z contiguous: an x
// halo is hs*nzw contiguous floats a side, a z halo an hz-wide strided
// band of every row. The TPU kernels' z-major layout with a dynamic
// sublane offset for the acquisition rows becomes tile-local rows passed
// by value, -1 for a row outside the tile. The design, what bounds the
// kernels and how they round: domain_block.cuh.
#include "domain_block.cuh"

namespace {

int block2_mod_run(const float* p, const float* pp, float* p_out,
                   float* pp_out, float* scratch, const float* v2m,
                   int v2_shot_stride, const float* xramp, const float* zfac,
                   const float* strip, const float* src, int r, int sz,
                   const float* amps, int k, float* rec, int gz, int ns,
                   int hs, int nxl, int hz, int nzl, int order, int parts,
                   const float* cx, const float* cz, void* stream) {
  if (bad_steps(k)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockModRun<true> run{
      p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride, xramp, zfac, strip,
      src, r, sz, pfdc::make_amps(amps, k), k, rec, gz, ns,
      Dims<true>{hs, nxl, hz, nzl}, pfdc::make_coefs(order / 2, cx, cz),
      parts, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

int block2_fwd_run(const float* p, const float* pp, float* p_out,
                   float* pp_out, float* scratch, const float* v2m,
                   int v2_shot_stride, const float* xramp, const float* zfac,
                   const float* strip, const float* src, int sz,
                   const float* amps, int k, int ns, int hs, int nxl, int hz,
                   int nzl, int order, int parts, const float* cx,
                   const float* cz, void* stream) {
  if (bad_steps(k)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockFwdRun<true> run{
      p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride, xramp, zfac, strip,
      src, sz, pfdc::make_amps(amps, k), k, ns, Dims<true>{hs, nxl, hz, nzl},
      pfdc::make_coefs(order / 2, cx, cz), parts,
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

int block2_bwd_run(const float* ps, const float* pps, const float* pr,
                   const float* ppr, float* ps_out, float* pps_out,
                   float* pr_out, float* ppr_out, const float* snap0,
                   const float* snap1, float* img, float* scratch,
                   const float* v2m,
                   int v2_shot_stride, const float* xramp, const float* zfac,
                   const float* strip, const float* inj, int inj_shot_stride,
                   int gz, int k, int ns, int hs, int nxl, int hz, int nzl,
                   int order, int parts, const float* cx, const float* cz,
                   void* stream) {
  if (bad_steps(k) || bad_seed(snap0, snap1, k) ||
      (gz >= 0 && inj == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlockBwdRun<true> run{
      ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out, snap0, snap1, img,
      v2m, v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, k,
      ns, Dims<true>{hs, nxl, hz, nzl}, pfdc::make_coefs(order / 2, cx, cz),
      parts, scratch, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs k steps (1 <= k <= 8, k*h <= each nonzero halo) of block_mod on the
// tiles (ns, nxl + 2*hs, nzl + 2*hz) from the state (p, pp) into the owned
// cells of (p_out, pp_out), and writes each shot's k traces of the owned
// rows at tile row gz (-1: none; the owned columns only) to rec (ns, k,
// nxl). src holds each shot's 2r+1 source rows (tile rows sz-r..sz+r,
// which may lie partly or wholly outside the tile) of the tile's x range;
// amps is a host array of k samples. For k > 4, scratch holds (p, pp)
// between the block's two passes (2 * ns * nxw * nzw floats; may be NULL
// for k <= 4). Returns a cudaError_t.
extern "C" int pfdc_block2_mod_run(const float* p, const float* pp,
                                   float* p_out, float* pp_out,
                                   float* scratch, const float* v2m,
                                   int v2_shot_stride, const float* xramp,
                                   const float* zfac, const float* strip,
                                   const float* src, int r, int sz,
                                   const float* amps, int k, float* rec,
                                   int gz, int ns, int hs, int nxl, int hz,
                                   int nzl, int order, const float* cx,
                                   const float* cz, void* stream) {
  return block2_mod_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                        xramp, zfac, strip, src, r, sz, amps, k, rec, gz, ns,
                        hs, nxl, hz, nzl, order, 0, cx, cz, stream);
}

// The same block with the x taps in parts (2 or 3) bf16 splits:
// block_mod_mma on an (x, z) tile, in two passes for k > 4 (scratch as
// above).
extern "C" int pfdc_block2_mod_mma_run(const float* p, const float* pp,
                                       float* p_out, float* pp_out,
                                       float* scratch, const float* v2m,
                                       int v2_shot_stride,
                                       const float* xramp, const float* zfac,
                                       const float* strip, const float* src,
                                       int r, int sz, const float* amps,
                                       int k, float* rec, int gz, int ns,
                                       int hs, int nxl, int hz, int nzl,
                                       int order, int parts, const float* cx,
                                       const float* cz, void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return block2_mod_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                        xramp, zfac, strip, src, r, sz, amps, k, rec, gz, ns,
                        hs, nxl, hz, nzl, order, parts, cx, cz, stream);
}

// Runs k steps of block_fwd on the tiles from the state (p, pp) into the
// owned cells of (p_out, pp_out). src holds each shot's one-hot source row
// of the tile's x range, added at tile row sz (-1: none). For k > 4,
// scratch holds (p, pp) between the block's two passes (2 * ns * nxw *
// nzw floats; may be NULL for k <= 4). Returns a cudaError_t.
extern "C" int pfdc_block2_fwd_run(const float* p, const float* pp,
                                   float* p_out, float* pp_out,
                                   float* scratch, const float* v2m,
                                   int v2_shot_stride, const float* xramp,
                                   const float* zfac, const float* strip,
                                   const float* src, int sz,
                                   const float* amps, int k, int ns, int hs,
                                   int nxl, int hz, int nzl, int order,
                                   const float* cx, const float* cz,
                                   void* stream) {
  return block2_fwd_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                        xramp, zfac, strip, src, sz, amps, k, ns, hs, nxl, hz,
                        nzl, order, 0, cx, cz, stream);
}

// The same block with the x taps in parts (2 or 3) bf16 splits:
// block_fwd_mma on an (x, z) tile, in two passes for k > 4 (scratch as
// above).
extern "C" int pfdc_block2_fwd_mma_run(const float* p, const float* pp,
                                       float* p_out, float* pp_out,
                                       float* scratch, const float* v2m,
                                       int v2_shot_stride,
                                       const float* xramp, const float* zfac,
                                       const float* strip, const float* src,
                                       int sz, const float* amps, int k,
                                       int ns, int hs, int nxl, int hz,
                                       int nzl, int order, int parts,
                                       const float* cx, const float* cz,
                                       void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return block2_fwd_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                        xramp, zfac, strip, src, sz, amps, k, ns, hs, nxl, hz,
                        nzl, order, parts, cx, cz, stream);
}

// Runs k steps of block_bwd on the tiles from the state (ps, pps, pr, ppr)
// into the owned cells of the *_out buffers, and adds the block's image
// delta into img (ns, nxl, nzl) in place. snap0/snap1 (the tiles of the
// forward snapshots) are given for the first block only, else NULL. The
// trace rows are added at tile row gz (-1: none, and inj may be NULL);
// inj points at the block's first trace row of shot 0: row i of shot s is
// inj[s * inj_shot_stride + i * nxw + x]. For k > 4, scratch holds the
// state and image delta between the block's two passes (4 * ns * nxw * nzw
// + ns * nxl * nzl floats; may be NULL for k <= 4). Returns a cudaError_t.
extern "C" int pfdc_block2_bwd_run(const float* ps, const float* pps,
                                   const float* pr, const float* ppr,
                                   float* ps_out, float* pps_out,
                                   float* pr_out, float* ppr_out,
                                   const float* snap0, const float* snap1,
                                   float* img, float* scratch,
                                   const float* v2m,
                                   int v2_shot_stride, const float* xramp,
                                   const float* zfac, const float* strip,
                                   const float* inj, int inj_shot_stride,
                                   int gz, int k, int ns, int hs, int nxl,
                                   int hz, int nzl, int order,
                                   const float* cx, const float* cz,
                                   void* stream) {
  return block2_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out,
                        snap0, snap1, img, scratch, v2m, v2_shot_stride, xramp,
                        zfac, strip, inj, inj_shot_stride, gz, k, ns, hs, nxl,
                        hz, nzl, order, 0, cx, cz, stream);
}

// The same block with the x taps in parts (2 or 3) bf16 splits:
// block_bwd_mma on an (x, z) tile, which takes a block of k > 4 in two
// passes as well (scratch as above).
extern "C" int pfdc_block2_bwd_mma_run(const float* ps, const float* pps,
                                       const float* pr, const float* ppr,
                                       float* ps_out, float* pps_out,
                                       float* pr_out, float* ppr_out,
                                       const float* snap0,
                                       const float* snap1, float* img,
                                       float* scratch, const float* v2m,
                                       int v2_shot_stride, const float* xramp,
                                       const float* zfac,
                                       const float* strip, const float* inj,
                                       int inj_shot_stride, int gz, int k,
                                       int ns, int hs, int nxl, int hz,
                                       int nzl, int order, int parts,
                                       const float* cx, const float* cz,
                                       void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return block2_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out,
                        snap0, snap1, img, scratch, v2m, v2_shot_stride, xramp,
                        zfac, strip, inj, inj_shot_stride, gz, k, ns, hs, nxl,
                        hz, nzl, order, parts, cx, cz, stream);
}
