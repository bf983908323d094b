// domain_block: the x-domain tier's three block kernels, each K time steps
// on one halo-extended x-slab for every shot of a batch: the C entry points
// pfdc_block_{mod,fwd,bwd}_run and, with the x taps in split bf16,
// pfdc_block_{mod,fwd,bwd}_mma_run (each, as the exact kernels, two
// launches for a block of more than 4 steps) of the kernels in
// domain_block.cuh, for a slab, the tile that spans the whole z axis (no
// z halo).
//
// Replaces: parallel_finite_difference_computation_tpu/parallel/
// domain_pallas.py, _mod_block_kernel (:189), _fwd_block_kernel (:115) and
// _bwd_block_kernel (:136), called by make_sharded_forward_modeling_pallas
// (:220) and make_sharded_rtm_snapshot_pallas (:346): block_* their exact
// taps, block_*_mma their use_mxu lowering (_lap_and_refs :106-112).
//
// The slab. The extended grid's x axis is cut into n_x slabs of nxl rows;
// slab j holds its nxl owned rows and hs = K*h rows of each neighbour, the
// halo, exchanged by the caller once per block ((ns, nxw, nze) buffers, nxw
// = nxl + 2*hs, z contiguous: a halo is hs*nze contiguous floats a side,
// not the TPU kernels' lane-offset columns). The design, what bounds the
// kernels and how they round: domain_block.cuh.
#include "domain_block.cuh"

namespace {

int block_mod_run(const float* p, const float* pp, float* p_out,
                  float* pp_out, float* scratch, const float* v2m,
                  int v2_shot_stride, const float* xramp, const float* zfac,
                  const float* strip, const float* src, int r, int sz,
                  const float* amps, int k, float* rec, int gz, int ns,
                  int hs, int nxl, int nze, int order, int parts,
                  const float* cx, const float* cz, void* stream) {
  if (bad_steps(k)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockModRun<false> run{
      p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride, xramp, zfac, strip,
      src, r, sz, pfdc::make_amps(amps, k), k, rec, gz, ns,
      Dims<false>{hs, nxl, 0, nze}, pfdc::make_coefs(order / 2, cx, cz),
      parts, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

int block_fwd_run(const float* p, const float* pp, float* p_out,
                  float* pp_out, float* scratch, const float* v2m,
                  int v2_shot_stride, const float* xramp, const float* zfac,
                  const float* strip, const float* src, int sz,
                  const float* amps, int k, int ns, int hs, int nxl, int nze,
                  int order, int parts, const float* cx, const float* cz,
                  void* stream) {
  if (bad_steps(k)) return static_cast<int>(cudaErrorInvalidValue);
  const BlockFwdRun<false> run{
      p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride, xramp, zfac, strip,
      src, sz, pfdc::make_amps(amps, k), k, ns, Dims<false>{hs, nxl, 0, nze},
      pfdc::make_coefs(order / 2, cx, cz), parts,
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

int block_bwd_run(const float* ps, const float* pps, const float* pr,
                  const float* ppr, float* ps_out, float* pps_out,
                  float* pr_out, float* ppr_out, const float* snap0,
                  const float* snap1, float* img, float* scratch,
                  const float* v2m,
                  int v2_shot_stride, const float* xramp, const float* zfac,
                  const float* strip, const float* inj, int inj_shot_stride,
                  int gz, int k, int ns, int hs, int nxl, int nze, int order,
                  int parts, const float* cx, const float* cz,
                  void* stream) {
  if (bad_steps(k) || bad_seed(snap0, snap1, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlockBwdRun<false> run{
      ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out, snap0, snap1, img,
      v2m, v2_shot_stride, xramp, zfac, strip, inj, inj_shot_stride, gz, k,
      ns, Dims<false>{hs, nxl, 0, nze}, pfdc::make_coefs(order / 2, cx, cz),
      parts, scratch, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(pfdc::dispatch_half(order, run));
}

}  // namespace

// Runs k steps (1 <= k <= 8, k*h <= hs) of block_mod on the slabs (ns, nxl
// + 2*hs, nze) from the state (p, pp) into the owned rows of (p_out,
// pp_out), and writes each shot's k traces of the owned rows to rec (ns, k,
// nxl). src holds each shot's 2r+1 source rows (depths sz-r..sz+r) of the
// slab; amps is a host array of k samples. For k > 4, scratch holds (p,
// pp) between the block's two passes (2 * ns * nxw * nze floats; may be
// NULL for k <= 4). Returns a cudaError_t.
extern "C" int pfdc_block_mod_run(const float* p, const float* pp,
                                  float* p_out, float* pp_out,
                                  float* scratch, const float* v2m,
                                  int v2_shot_stride, const float* xramp,
                                  const float* zfac, const float* strip,
                                  const float* src, int r, int sz,
                                  const float* amps, int k, float* rec,
                                  int gz, int ns, int hs, int nxl, int nze,
                                  int order, const float* cx, const float* cz,
                                  void* stream) {
  return block_mod_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                       xramp, zfac, strip, src, r, sz, amps, k, rec, gz, ns,
                       hs, nxl, nze, order, 0, cx, cz, stream);
}

// The same block with the x taps in parts (2 or 3) bf16 splits:
// block_mod_mma, which takes a block of k > 4 in two passes as well
// (scratch as above).
extern "C" int pfdc_block_mod_mma_run(const float* p, const float* pp,
                                      float* p_out, float* pp_out,
                                      float* scratch, const float* v2m,
                                      int v2_shot_stride,
                                      const float* xramp, const float* zfac,
                                      const float* strip, const float* src,
                                      int r, int sz, const float* amps, int k,
                                      float* rec, int gz, int ns, int hs,
                                      int nxl, int nze, int order, int parts,
                                      const float* cx, const float* cz,
                                      void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return block_mod_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                       xramp, zfac, strip, src, r, sz, amps, k, rec, gz, ns,
                       hs, nxl, nze, order, parts, cx, cz, stream);
}

// Runs k steps of block_fwd on the slabs from the state (p, pp) into the
// owned rows of (p_out, pp_out). src holds each shot's source row (depth
// sz) of the slab. For k > 4, scratch holds (p, pp) between the block's
// two passes (2 * ns * nxw * nze floats; may be NULL for k <= 4). Returns
// a cudaError_t.
extern "C" int pfdc_block_fwd_run(const float* p, const float* pp,
                                  float* p_out, float* pp_out,
                                  float* scratch, const float* v2m,
                                  int v2_shot_stride, const float* xramp,
                                  const float* zfac, const float* strip,
                                  const float* src, int sz, const float* amps,
                                  int k, int ns, int hs, int nxl, int nze,
                                  int order, const float* cx, const float* cz,
                                  void* stream) {
  return block_fwd_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                       xramp, zfac, strip, src, sz, amps, k, ns, hs, nxl, nze,
                       order, 0, cx, cz, stream);
}

// The same block with the x taps in parts (2 or 3) bf16 splits:
// block_fwd_mma, which takes a block of k > 4 in two passes as well
// (scratch as above).
extern "C" int pfdc_block_fwd_mma_run(const float* p, const float* pp,
                                      float* p_out, float* pp_out,
                                      float* scratch, const float* v2m,
                                      int v2_shot_stride,
                                      const float* xramp, const float* zfac,
                                      const float* strip, const float* src,
                                      int sz, const float* amps, int k,
                                      int ns, int hs, int nxl, int nze,
                                      int order, int parts, const float* cx,
                                      const float* cz, void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return block_fwd_run(p, pp, p_out, pp_out, scratch, v2m, v2_shot_stride,
                       xramp, zfac, strip, src, sz, amps, k, ns, hs, nxl, nze,
                       order, parts, cx, cz, stream);
}

// Runs k steps of block_bwd on the slabs from the state (ps, pps, pr, ppr)
// into the owned rows of the *_out buffers, and adds the block's image
// delta into img (ns, nxl, nze) in place. snap0/snap1 (the slabs of the
// forward snapshots) are given for the first block only, else NULL. inj
// points at the block's first trace row of shot 0: row i of shot s is
// inj[s * inj_shot_stride + i * nxw + x]. For k > 4, scratch holds the
// state and image delta between the block's two passes (4 * ns * nxw * nze
// + ns * nxl * nze floats; may be NULL for k <= 4). Returns a cudaError_t.
extern "C" int pfdc_block_bwd_run(const float* ps, const float* pps,
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
                                  int nze, int order, const float* cx,
                                  const float* cz, void* stream) {
  return block_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out,
                       snap0, snap1, img, scratch, v2m, v2_shot_stride, xramp,
                       zfac, strip, inj, inj_shot_stride, gz, k, ns, hs, nxl,
                       nze, order, 0, cx, cz, stream);
}

// The same block with the x taps in parts (2 or 3) bf16 splits:
// block_bwd_mma, which takes a block of k > 4 in two passes as well
// (scratch as above).
extern "C" int pfdc_block_bwd_mma_run(const float* ps, const float* pps,
                                      const float* pr, const float* ppr,
                                      float* ps_out, float* pps_out,
                                      float* pr_out, float* ppr_out,
                                      const float* snap0, const float* snap1,
                                      float* img, float* scratch,
                                      const float* v2m, int v2_shot_stride,
                                      const float* xramp, const float* zfac,
                                      const float* strip,
                                      const float* inj, int inj_shot_stride,
                                      int gz, int k, int ns, int hs, int nxl,
                                      int nze, int order, int parts,
                                      const float* cx, const float* cz,
                                      void* stream) {
  if (parts != 2 && parts != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return block_bwd_run(ps, pps, pr, ppr, ps_out, pps_out, pr_out, ppr_out,
                       snap0, snap1, img, scratch, v2m, v2_shot_stride, xramp,
                       zfac, strip, inj, inj_shot_stride, gz, k, ns, hs, nxl,
                       nze, order, parts, cx, cz, stream);
}
