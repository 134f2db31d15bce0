// K6: flash-attention backward with an optional additive bias, for Hopper
// (sm_90a), bf16 in and out.  A thin instantiation of the shared backward
// mainloop in flash_bwd_sm90.cuh (kNoMask, or kBias): a dQ program per
// 64-query tile, a dK/dV program per 64-key tile, no atomics, so dQ, dK
// and dV are the same bits from run to run.
//
// Replaces the Pallas TPU kernels sasvqa_tpu/ops/flash_attention.py:
// _dq_core (through _dq_b/_dq_n) and _dkv_core (through _dkv_b/_dkv_n),
// driven by _flash_backward.  Per (b, h), query row r and key c, with the
// forward's LSE and s as in flash_fwd.cu (scores scaled after the product,
// plus the bias, read through its broadcast strides):
//   p   = exp(s[r, c] - LSE[r])           (an LSE of -inf, a row with no
//                                           attendable key, gives p = 0)
//   D   = rowsum(dO * O)                  f32, one prologue kernel
//   dS  = bf16(p * (dO V^T - D) * scale)  the scale folded into the cast
//   dQ  = dS K,  dK = dS^T Q,  dV = bf16(p)^T dO
// All with f32 accumulation, written once as bf16.  The TPU kernels keep p
// and dS in f32 for these products; here they enter the tensor cores in
// bf16 (a relative step of 2^-8).  The bias's own cotangent is the dense
// plain expression (ops/flash_attention.py), as in the JAX package.
//
// Bound at the BLIP-base training shape (B*T = 32 frames, H = 12,
// Lq = Lk = 577, Dh = 64): 384 x 577^2 pairs; dQ does 3 products
// (S, dP, dQ) and dK/dV 4 (S, dV, dP, dK), so 14*Dh FLOP a pair for the
// pair of programs (~1.1e11, ~0.116 ms at 989 TFLOP/s) against
// q/k/v/O/dO read and dQ/dK/dV written once (~0.23 GB, ~0.068 ms at
// 3.35 TB/s): compute-bound, so the design (flash_bwd_sm90.cuh) is wgmma
// on TMA-filled tiles, no mask code on the 9 of 10 key tiles wholly below
// Lk, and the last query or key tile of one row at 577 computed 16 wide.

#include "flash_bwd_sm90.cuh"

namespace {

BwdParams bias_params(const void* lse, const void* delta, const void* bias,
                      int H, int Lq, int Lk, long long b_sb, long long b_sh,
                      long long b_sq, long long b_sk, float scale) {
  BwdParams p{};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.scale_log2 = scale * LOG2E;
  p.ds_scale = scale;
  p.out_scale = 1.f;
  p.bias = static_cast<const float*>(bias);
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.b_sq = b_sq;
  p.b_sk = b_sk;
  return p;
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return 0, a cudaError_t or an
// ERR_TMA_* code of sm90_common.cuh (the first error stops).  Strides are
// in elements, for (B, H, Lq, DH) views of q/o/dout/dq and (B, H, Lk, DH)
// views of k/v/dk/dv, with unit stride on DH and 16-byte aligned rows and
// strides; lse and delta are (B, H, Lq) contiguous f32; bias is f32 read
// at bias[b*b_sb + h*b_sh + r*b_sq + c*b_sk], or null for no bias.
//
// flash_bwd_dq writes delta = rowsum(dout * o) (the prologue), then dq.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, const void* bias,
                 void* delta, void* dq, int B, int H, int Lq, int Lk,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 long long do_sb, long long do_sh, long long do_ss,
                 long long dq_sb, long long dq_sh, long long dq_ss,
                 long long b_sb, long long b_sh, long long b_sq,
                 long long b_sk, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_rowsum_product(o, dout, delta, B, H, Lq, o_sb, o_sh,
                                        o_ss, do_sb, do_sh, do_ss, st);
  if (err) return err;
  BwdParams p = bias_params(lse, delta, bias, H, Lq, Lk, b_sb, b_sh, b_sq,
                            b_sk, scale);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb;
  p.dq_sh = dq_sh;
  p.dq_ss = dq_ss;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, do_sb, do_sh, do_ss};
  auto launch = bias ? launch_flash_bwd<false, kBias, false>
                     : launch_flash_bwd<false, kNoMask, false>;
  return launch(p, q, k, v, dout, B, strides, st);
}

// flash_bwd_dkv reads the delta that flash_bwd_dq wrote.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* bias, void* dk, void* dv, int B, int H, int Lq,
                  int Lk, long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss,
                  long long v_sb, long long v_sh, long long v_ss,
                  long long do_sb, long long do_sh, long long do_ss,
                  long long dk_sb, long long dk_sh, long long dk_ss,
                  long long dv_sb, long long dv_sh, long long dv_ss,
                  long long b_sb, long long b_sh, long long b_sq,
                  long long b_sk, float scale, void* stream) {
  BwdParams p = bias_params(lse, delta, bias, H, Lq, Lk, b_sb, b_sh, b_sq,
                            b_sk, scale);
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
  auto launch = bias ? launch_flash_bwd<true, kBias, false>
                     : launch_flash_bwd<true, kNoMask, false>;
  return launch(p, q, k, v, dout, B, strides,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
