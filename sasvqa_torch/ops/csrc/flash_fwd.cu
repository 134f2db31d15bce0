// Flash-attention forward with an optional additive bias, for Hopper
// (sm_90a): bf16 q/k/v in, bf16 O and f32 LSE out.
//
// Replaces the Pallas TPU kernel sasvqa_tpu/ops/flash_attention.py:
// _flash_core (through _fwd_b/_fwd_n/_fwd_b_lse/_fwd_n_lse, driven by
// _flash_forward).  Per (b, h) and query row r of q (B, H, Lq, Dh) against
// k/v (B, H, Lk, Dh):
//   s[r, c] = (q_r . k_c) * Dh^-0.5 + bias[b, h, r, c]    f32
//   online softmax with f32 running max m and sum l;
//   P cast to bf16 for P.V with f32 accumulation (the TPU kernel keeps P
//   in f32 there: the one difference, a relative step of 2^-8 on P);
//   O = acc / l (l == 0 gives O = 0), LSE = m + log(l).
// The TPU kernel scales q before Q.K^T; with Dh = 64 the scale 0.125 is a
// power of two, so scaling the f32 scores after the product is exact.
// The bias is f32, read through its own strides: a broadcast axis has
// stride 0, so a row bias (B, 1, 1, Lk) is read as O(Lk) and no
// (B, H, Lq, Lk) copy exists.  Keys at or past Lk are masked without
// being read, and rows past Lq are not written: no padding to a block
// multiple (the TPU kernel pads both to its 512 blocks).
//
// Bound at the BLIP-base vision shape (B*T = 64 frames, H = 12,
// Lq = Lk = 577, Dh = 64): 768 x 577^2 pairs at 4*Dh FLOP each, 6.5e10
// FLOP, ~0.066 ms at the 989 TFLOP/s bf16 dense peak, against ~227 MB of
// q/k/v/O (+ LSE) moved once, ~0.068 ms at 3.35 TB/s: at the ridge.
//
// First design, simple and right (the K1 structure of git_flash_fwd.cu):
// one CTA of 4 warps per (b*h, 64-query tile); each warp owns 16 query
// rows, keeps Q as mma A-fragments in registers and streams 64-key K/V
// tiles through shared memory (single-buffered), with warp-level
// mma.sync m16n8k16 bf16 products; P is re-packed from the score
// accumulators straight into A-fragments for P.V.  The bias is read from
// global memory per score element (no bias on the BLIP path).  wgmma,
// TMA, warp specialisation and double buffering are left for later work.

#include "mma_common.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 rows

template <bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Lq, int Lk,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 long long b_sb, long long b_sh, long long b_sq,
                 long long b_sk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within the quad
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BM;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const float* bp = HAS_BIAS ? bias + b * b_sb + h * b_sh : nullptr;

  load_tile<BM, NTHREADS>(sQ, qp, q_ss, q0, Lq, tid);
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[DH / 16][4];
  load_a_frags(qa, sQ, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BN, NTHREADS>(sK, kp, k_ss, k0, Lk, tid);
    load_tile<BN, NTHREADS>(sV, vp, v_ss, k0, Lk, tid);
    __syncthreads();

    // S tile (16 x 64 per warp) = Q K^T
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kr = &sK[(j * 8 + g) * PITCH + kk * 16 + 2 * t];
        mma_16816(s[j], qa[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // scale, bias, mask past Lk, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1];
        const int c = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (c >= Lk) {
          x = -INFINITY;
        } else if (HAS_BIAS && r < Lq) {
          x += __ldg(bp + r * b_sq + c * b_sk);
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // a row whose scores are all -inf so far (an -inf bias) keeps
      // p = 0 and l = 0 instead of exp(-inf - -inf) = NaN
      m_use[i] = (m_new == -INFINITY) ? 0.f : m_new;
      corr[i] = expf(m_run[i] - m_use[i]);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_use[e >> 1]);
        l_run[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += bf16(P) V; the C-fragments of two adjacent 8-key slices form
    // one A-fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = ld_u16(&sV[key * PITCH + d]) |
                            (ld_u16(&sV[(key + 1) * PITCH + d]) << 16);
        const uint32_t b1 = ld_u16(&sV[(key + 8) * PITCH + d]) |
                            (ld_u16(&sV[(key + 9) * PITCH + d]) << 16);
        mma_16816(acc[j], pa, b0, b1);
      }
    }
  }

  // full row sums across the quad, then O = acc / l and LSE = m + log(l)
  float denom[2], lse_v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float safe_l = (l == 0.f) ? 1.f : l;
    denom[i] = safe_l;
    lse_v[i] = m_run[i] + logf(safe_l);
  }
  __nv_bfloat16* op = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Lq) continue;
    __nv_bfloat16* orow = op + (long long)row[i] * o_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * i] / denom[i], acc[j][2 * i + 1] / denom[i]);
    }
    if (t == 0) lse[(long long)bh * Lq + row[i]] = lse_v[i];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// q/o strides are in elements for (B, H, Lq, DH) views, k/v for
// (B, H, Lk, DH) views, all with unit stride on DH and 16-byte aligned
// rows; bias is f32 read at bias[b*b_sb + h*b_sh + r*b_sq + c*b_sk]
// (stride 0 on broadcast axes), or null for no bias; lse is (B, H, Lq)
// contiguous f32.
int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
              void* o, void* lse, int B, int H, int Lq, int Lk,
              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
              long long v_ss, long long o_sb, long long o_sh, long long o_ss,
              long long b_sb, long long b_sh, long long b_sq, long long b_sk,
              float scale, void* stream) {
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  auto kernel = bias ? flash_fwd_kernel<true> : flash_fwd_kernel<false>;
  kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Lq, Lk,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
      b_sb, b_sh, b_sq, b_sk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
