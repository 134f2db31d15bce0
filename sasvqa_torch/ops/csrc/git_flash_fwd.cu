// K1: GIT-mask flash-attention forward for Hopper (sm_90a), bf16 in, bf16
// O and f32 LSE out, with the K4 dropout hash inside at rate > 0.  A thin
// instantiation of the shared mainloop in flash_fwd_sm90.cuh (kGitMask).
//
// Replaces the Pallas TPU kernel sasvqa_tpu/ops/git_flash.py:_fwd_kernel
// (mask: _mask_ok/_mask_block).  Per (b, h) and query row r of
// (B, H, S, Dh) with S = num_img + L:
//   s[r, c] = (q_r . k_c) * Dh^-0.5            (f32 accumulate, scale after)
//           + (ok(r, c) ? 0 : -1e9)            (additive NEG_INF)
//   ok(r, c) = c < num_img                     (image columns: every row)
//           || (r >= num_img && c <= r && text_mask[b, c - num_img] != 0)
//   online softmax with f32 running max m and sum l (l sums the f32 p);
//   with dropout (rate > 0), p is then multiplied by the K4 keep factor
//   {0, 1/(1-rate)} of hash_keep (git_flash_common.cuh), so l and LSE stay
//   those of the undropped softmax;
//   P is cast to bf16 for P.V with f32 accumulation;
//   O = acc / l, LSE = m + log(l).
// Columns >= S are masked (the TPU kernel pads S to a block multiple and
// zeroes their column mask instead).
//
// Bound: at the training shape (B=16, H=12, S=1608, num_img=1576) 4.9e8
// attended pairs at 4*Dh FLOP, 0.126 ms at the 989 TFLOP/s bf16 peak,
// against 0.04 ms of q/k/v/O/LSE traffic at 3.35 TB/s; at the serving
// shape (B=8, S=1596) 0.0625 ms: compute-bound.  So the design is about
// the tensor cores: wgmma for both products, TMA into a 4-stage mbarrier
// ring so that no warp waits on a load, no mask code on the key tiles
// wholly below num_img (the TPU kernel's unmasked image prefix: 24 of the
// 25 tiles an image-row CTA visits at S = 1608), no tile past
// max(num_img, the CTA's last row), and three CTAs an SM, so that at
// rate > 0 one CTA's hash (16 integer operations a pair, more than the
// pair's share of the products) and softmax run while another's products
// do.

#include "flash_fwd_sm90.cuh"

extern "C" {

// Launches on `stream`; returns 0, a cudaError_t, or an ERR_TMA_* code of
// flash_fwd_sm90.cuh.  q/k/v/o strides are in elements, for a
// (B, H, S, DH) view with unit stride on DH and 16-byte aligned rows and
// strides; lse is (B, H, S) contiguous; text_mask is (B, L) int32; seed
// is a device int32.  thresh == 0 (rate 0) launches the kernel without
// the dropout code.
int git_flash_fwd(const void* q, const void* k, const void* v,
                  const void* text_mask, void* o, void* lse, int B, int H,
                  int S, int num_img, int L, long long q_sb, long long q_sh,
                  long long q_ss, long long k_sb, long long k_sh,
                  long long k_ss, long long v_sb, long long v_sh,
                  long long v_ss, long long o_sb, long long o_sh,
                  long long o_ss, float scale, const void* seed,
                  unsigned int thresh, float inv_keep, void* stream) {
  FwdParams p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.H = H;
  p.Lq = S;
  p.Lk = S;
  p.scale_log2 = scale * LOG2E;
  p.text_mask = static_cast<const int32_t*>(text_mask);
  p.num_img = num_img;
  p.L = L;
  p.seed_ptr = static_cast<const int32_t*>(seed);
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  auto launch = thresh ? launch_flash_fwd<kGitMask, true>
                       : launch_flash_fwd<kGitMask, false>;
  return launch(p, q, k, v, B, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                v_sh, v_ss, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
