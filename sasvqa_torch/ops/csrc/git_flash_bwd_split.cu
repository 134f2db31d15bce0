// K3: the split GIT-mask flash-attention backward for Hopper (sm_90a),
// bf16 in and out, with the K4 dropout hash inside at rate > 0.  A thin
// instantiation of the shared backward mainloop in flash_bwd_sm90.cuh
// (kGitMask): a dQ program per 64-query tile, a dK/dV program per 64-key
// tile, no atomics, so dQ, dK and dV are the same bits from run to run.
//
// Replaces the Pallas TPU kernels sasvqa_tpu/ops/git_flash.py: _dq_kernel
// and _dkv_kernel (driven by _backward_split), with the K4 keep factor
// (hash_keep in git_flash_common.cuh, the JAX _hash_keep bit for bit)
// regenerated from coordinates.  Per (b, h), query row r and key c, with
// p the forward's softmax probability (0 where git_mask_ok is false) and
// keep(r, c) the dropout factor {0, 1/(1-rate)} (1 at rate 0):
//   D   = rowsum(dO * O)               over the dropped O (one prologue)
//   dS  = bf16(p * (dO V^T * keep - D))   unscaled, as the TPU kernels
//   dQ  = scale * (dS K),  dK = scale * (dS^T Q),  dV = bf16(p * keep)^T dO
// with f32 accumulation and the scale applied after it.
//
// Bound at the ViT-L/14 16-frame training shape (B=8, H=12, S=4144,
// num_img=4112, Dh=64): about 1.64e9 attended pairs; at 10*Dh FLOP a pair
// (one fused pass) 1.05e12 FLOP, ~1.06 ms at the 989 TFLOP/s bf16 dense
// peak, against ~0.5 GB of q/k/v/O/dO read and dQ/dK/dV written once,
// ~0.15 ms at 3.35 TB/s: compute-bound.  The split recomputes S and dP in
// both programs (14*Dh FLOP a pair: dQ S, dP, dQ; dK/dV S, dP, dV, dK), so
// its own floor is 1.4x that; the design (flash_bwd_sm90.cuh) keeps the
// tensor cores fed with wgmma on TMA-filled tiles and skips the masked
// tile pairs: a query tile of image rows visits only the key tiles that
// hold image columns (the TPU's _n_unmasked_blocks prefix), a key tile of
// text keys starts at its own first row, and a key or query tile wholly
// inside the image prefix runs no mask code.

#include "flash_bwd_sm90.cuh"

extern "C" {

// Both launchers run on `stream` and return 0, a cudaError_t or an
// ERR_TMA_* code of sm90_common.cuh (the first error stops).  Strides are
// in elements, for (B, H, S, DH) views with unit stride on DH and 16-byte
// aligned rows and strides; lse and delta are (B, H, S) contiguous f32;
// text_mask is (B, L) int32; seed is a device int32.  thresh == 0 (rate 0)
// launches the kernels without the dropout code.
//
// git_flash_bwd_dq writes delta = rowsum(dout * o) (the prologue), then dq.
int git_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     const void* text_mask, const void* seed, void* delta,
                     void* dq, int B, int H, int S, int num_img, int L,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss,
                     long long do_sb, long long do_sh, long long do_ss,
                     long long dq_sb, long long dq_sh, long long dq_ss,
                     float scale, unsigned int thresh, float inv_keep,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_rowsum_product(o, dout, delta, B, H, S, o_sb, o_sh,
                                        o_ss, do_sb, do_sh, do_ss, st);
  if (err) return err;
  BwdParams p = git_params(lse, delta, text_mask, seed, H, S, num_img, L,
                           1.f, scale, scale, thresh, inv_keep);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb;
  p.dq_sh = dq_sh;
  p.dq_ss = dq_ss;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  auto launch = thresh ? launch_flash_bwd<false, kGitMask, true>
                       : launch_flash_bwd<false, kGitMask, false>;
  return launch(p, q, k, v, dout, B, strides, st);
}

// git_flash_bwd_dkv reads the delta that git_flash_bwd_dq wrote.
int git_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* text_mask, const void* seed, void* dk,
                      void* dv, int B, int H, int S, int num_img, int L,
                      long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long do_sb, long long do_sh, long long do_ss,
                      long long dk_sb, long long dk_sh, long long dk_ss,
                      long long dv_sb, long long dv_sh, long long dv_ss,
                      float scale, unsigned int thresh, float inv_keep,
                      void* stream) {
  BwdParams p = git_params(lse, delta, text_mask, seed, H, S, num_img, L,
                           1.f, scale, scale, thresh, inv_keep);
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
  auto launch = thresh ? launch_flash_bwd<true, kGitMask, true>
                       : launch_flash_bwd<true, kGitMask, false>;
  return launch(p, q, k, v, dout, B, strides,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
