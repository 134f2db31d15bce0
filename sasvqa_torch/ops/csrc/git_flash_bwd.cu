// K2: the fused GIT-mask flash-attention backward for Hopper (sm_90a),
// bf16 in and out, with the K4 dropout hash inside at rate > 0.  A thin
// instantiation of the fused program of the shared backward mainloop in
// flash_bwd_sm90.cuh (kGitMask): one CTA a 128-key tile, two consumer
// warpgroups of 64 keys over the same streamed query tiles.
//
// Replaces the Pallas TPU kernel sasvqa_tpu/ops/git_flash.py:
// _fused_bwd_kernel (driven by _backward_fused), with the K4 keep factor
// (hash_keep in git_flash_common.cuh, the JAX _hash_keep bit for bit)
// regenerated from coordinates, once a pair.  Per (b, h), query row r and
// key c, with p the forward's softmax probability (0 where git_mask_ok is
// false) and keep(r, c) the dropout factor {0, 1/(1-rate)} (1 at rate 0):
//   D   = rowsum(dO * O)                    over the dropped O (a prologue)
//   dS  = bf16(p * (dO V^T * keep - D) * scale)  the scale folded into the
//                                           cast, as the TPU kernel does
//   dK  = dS^T Q,  dV = bf16(p * keep)^T dO   f32 sums, written once in bf16
//   dQ  = dS K                              f32, summed into a workspace
// The TPU kernel carries dQ in a full-row VMEM block that its sequential
// key grid revisits.  CUDA blocks run in no order, so each CTA adds the
// f32 dQ of every query tile it visits, summed over its 128 keys, into a
// zeroed (B, H, S, Dh) f32 workspace by two TMA reductions (bulk, issued
// by one thread, under the next tiles' products); the launcher casts it to
// bf16.  The order of those additions varies from run to run, so dQ is not
// bit-reproducible; dK and dV are.
//
// Bound at the GIT-base training shape (B=16, H=12, S=1608, num_img=1576,
// Dh=64): about 4.9e8 attended pairs at 10*Dh FLOP a pair (5 products:
// S, dP, dV, dK, dQ), ~3.1e11 FLOP, ~0.32 ms at the 989 TFLOP/s bf16 dense
// peak, against ~0.32 GB of q/k/v/O/dO/LSE read and dQ/dK/dV written once,
// ~0.1 ms at 3.35 TB/s: compute-bound.  The split backward (K3) does
// 14*Dh a pair, recomputing S and dP and the hash in both its programs;
// this kernel pays instead for the dQ reductions: 13 key tiles x 26 query
// tiles x 192 (b, h) x 16 KB, ~1.06 GB a call into L2 (vitl16: ~3.4 GB),
// half what 64-key tiles would add.

#include "flash_bwd_sm90.cuh"

namespace {

template <bool PRODUCTS>
int launch_git_fused(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     const void* text_mask, const void* seed, void* dq,
                     void* dk, void* dv, void* delta, int B, int H, int S,
                     int num_img, int L, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh,
                     long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, long long o_sb, long long o_sh,
                     long long o_ss, long long do_sb, long long do_sh,
                     long long do_ss, long long dq_sb, long long dq_sh,
                     long long dq_ss, long long dk_sb, long long dk_sh,
                     long long dk_ss, long long dv_sb, long long dv_sh,
                     long long dv_ss, float scale, unsigned int thresh,
                     float inv_keep, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_rowsum_product(o, dout, delta, B, H, S, o_sb, o_sh,
                                        o_ss, do_sb, do_sh, do_ss, st);
  if (err) return err;
  BwdParams p = git_params(lse, delta, text_mask, seed, H, S, num_img, L,
                           scale, 1.f, scale, thresh, inv_keep);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dk_sb = dk_sb;
  p.dk_sh = dk_sh;
  p.dk_ss = dk_ss;
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dv_sb = dv_sb;
  p.dv_sh = dv_sh;
  p.dv_ss = dv_ss;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  const long long dq_strides[3] = {dq_sb, dq_sh, dq_ss};
  auto launch = thresh ? launch_flash_bwd_fused<kGitMask, true, PRODUCTS>
                       : launch_flash_bwd_fused<kGitMask, false, PRODUCTS>;
  return launch(p, q, k, v, dout, dq, B, strides, dq_strides, st);
}

}  // namespace

extern "C" {

// Launches the D prologue and the fused backward on `stream`; returns 0, a
// cudaError_t or an ERR_TMA_* code of sm90_common.cuh (the first error
// stops).  Strides are in elements, for (B, H, S, DH) views with unit
// stride on DH and 16-byte aligned rows and strides; lse and delta are
// (B, H, S) contiguous f32; dq is f32 and must hold zeros; text_mask is
// (B, L) int32; seed is a device int32.  thresh == 0 (rate 0) launches the
// kernel without the dropout code.
int git_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, const void* text_mask,
                  const void* seed, void* dq, void* dk, void* dv, void* delta,
                  int B, int H, int S, int num_img, int L,
                  long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss,
                  long long v_sb, long long v_sh, long long v_ss,
                  long long o_sb, long long o_sh, long long o_ss,
                  long long do_sb, long long do_sh, long long do_ss,
                  long long dq_sb, long long dq_sh, long long dq_ss,
                  long long dk_sb, long long dk_sh, long long dk_ss,
                  long long dv_sb, long long dv_sh, long long dv_ss,
                  float scale, unsigned int thresh, float inv_keep,
                  void* stream) {
  return launch_git_fused<true>(
      q, k, v, o, dout, lse, text_mask, seed, dq, dk, dv, delta, B, H, S,
      num_img, L, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh,
      dk_ss, dv_sb, dv_sh, dv_ss, scale, thresh, inv_keep, stream);
}

// The same launch with the products and elementwise work compiled out: the
// ring, the dQ staging and the reductions of zero tiles only (dk and dv are
// written with zeros).  A measurement of the reduction's cost, not a
// backward.
int git_flash_bwd_reduce_only(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* text_mask,
    const void* seed, void* dq, void* dk, void* dv, void* delta, int B,
    int H, int S, int num_img, int L, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, float scale, unsigned int thresh,
    float inv_keep, void* stream) {
  return launch_git_fused<false>(
      q, k, v, o, dout, lse, text_mask, seed, dq, dk, dv, delta, B, H, S,
      num_img, L, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
      o_sh, o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh,
      dk_ss, dv_sb, dv_sh, dv_ss, scale, thresh, inv_keep, stream);
}

}  // extern "C"
