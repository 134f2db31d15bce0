// K5: flash-attention forward with an optional additive bias, for Hopper
// (sm_90a): bf16 q/k/v in, bf16 O and f32 LSE out.  A thin instantiation
// of the shared mainloop in flash_fwd_sm90.cuh (kNoMask, or kBias).
//
// Replaces the Pallas TPU kernel sasvqa_tpu/ops/flash_attention.py:
// _flash_core (through _fwd_b/_fwd_n/_fwd_b_lse/_fwd_n_lse, driven by
// _flash_forward).  Per (b, h) and query row r of q (B, H, Lq, Dh) against
// k/v (B, H, Lk, Dh): s = (q_r . k_c) * Dh^-0.5 + bias[b, h, r, c], online
// softmax with f32 statistics, P cast to bf16 for P.V (the TPU kernel keeps
// P in f32 there: the one difference, a relative step of 2^-8 on P),
// O = acc / l (l == 0 gives O = 0), LSE = m + log(l).  The TPU kernel
// scales q before Q.K^T; with Dh = 64 the scale 0.125 is a power of two,
// so scaling the f32 scores after the product is exact.  The bias is f32,
// read through its own strides (stride 0 on a broadcast axis, so a row
// bias (B, 1, 1, Lk) is read as O(Lk)); no main path passes one.  Keys at
// or past Lk are masked, rows past Lq are not written: no padding (the TPU
// kernel pads both to its 512 blocks).
//
// Bound at the BLIP-base vision shapes (Lq = Lk = 577, Dh = 64): serving
// (B*T = 64 frames, H = 12) is 768 x 577^2 pairs at 4*Dh FLOP, 6.5e10 FLOP,
// 0.066 ms at the 989 TFLOP/s bf16 dense peak, against 227 MB of q/k/v/O
// (+ LSE) moved once, 0.068 ms at 3.35 TB/s: at the ridge, so the kernel
// must keep the tensor cores fed without a warp ever waiting on a load.
// The design: wgmma for both products, TMA into a 4-stage mbarrier ring
// filled by a producer warp, three CTAs an SM so that one's softmax runs
// under another's products, no mask code on the key tiles wholly below Lk
// (9 of 10 at 577), and the last tile, which holds one key at 577,
// computed 16 keys wide instead of 64.  With Dh = 64 the softmax is as long
// as the products (one exp per pair against 4*Dh FLOP), so its instruction
// count is cut to an FFMA and an ex2 a score.

#include "flash_fwd_sm90.cuh"

extern "C" {

// Launches on `stream`; returns 0, a cudaError_t, or an ERR_TMA_* code of
// flash_fwd_sm90.cuh.  q/o strides are in elements for (B, H, Lq, DH)
// views, k/v for (B, H, Lk, DH) views, all with unit stride on DH and
// 16-byte aligned rows and strides; bias is f32 read at
// bias[b*b_sb + h*b_sh + r*b_sq + c*b_sk] (stride 0 on broadcast axes), or
// null for no bias; lse is (B, H, Lq) contiguous f32.
int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
              void* o, void* lse, int B, int H, int Lq, int Lk,
              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss, long long o_sb, long long o_sh, long long o_ss,
              long long b_sb, long long b_sh, long long b_sq, long long b_sk,
              float scale, void* stream) {
  FwdParams p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.scale_log2 = scale * LOG2E;
  p.bias = static_cast<const float*>(bias);
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.b_sq = b_sq;
  p.b_sk = b_sk;
  auto launch = bias ? launch_flash_fwd<kBias, false>
                     : launch_flash_fwd<kNoMask, false>;
  return launch(p, q, k, v, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                v_sh, v_ss, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
