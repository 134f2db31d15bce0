// Flash-attention backward with an optional additive bias, for Hopper
// (sm_90a): dQ from one kernel, dK and dV from another, bf16 in and out.
//
// Replaces the Pallas TPU kernels sasvqa_tpu/ops/flash_attention.py:
// _dq_core (through _dq_b/_dq_n) and _dkv_core (through _dkv_b/_dkv_n),
// driven by _flash_backward.  Per (b, h), query row r and key c, with the
// forward's LSE and s as in flash_fwd.cu (scores scaled after the product,
// plus the bias):
//   p   = exp(s[r, c] - LSE[r])           (an LSE of -inf, a row with no
//                                           attendable key, gives p = 0)
//   D   = rowsum(dO * O)                  f32, one prologue kernel
//   dP  = dO V^T
//   dS  = bf16(p * (dP - D) * scale)      the scale folded into the cast
//   dQ  = dS K        (flash_bwd_dq: one CTA per query tile, streams keys)
//   dK  = dS^T Q, dV = bf16(p)^T dO
//                     (flash_bwd_dkv: one CTA per key tile, streams queries)
// All with f32 accumulation, written once as bf16.  The TPU kernels keep p
// and dS in f32 for these products; here they enter the tensor cores in
// bf16 (a relative step of 2^-8).
//
// D comes from one prologue (rowsum_product_kernel, mma_common.cuh) that
// both kernels read, where the TPU kernels recompute it per tile.  Each
// CTA owns its output tile, so no atomics are needed and dQ, dK and dV are
// deterministic.  Keys past Lk and rows past Lq are zero-filled in shared
// memory and masked; nothing is padded.
//
// Bound at the BLIP-base training shape (B*T = 32 frames, H = 12,
// Lq = Lk = 577, Dh = 64): 384 x 577^2 pairs; dQ does 3 products
// (S, dP, dQ) and dK/dV 4 (S, dV, dP, dK), so 14*Dh FLOP a pair for the
// pair of kernels (~1.1e11, ~0.116 ms at 989 TFLOP/s) against
// q/k/v/O/dO read and dQ/dK/dV written once (~0.23 GB, ~0.068 ms at
// 3.35 TB/s): compute-bound.  The recompute of S and dP in both kernels
// is the price of no atomics (the fused K2 does 5 products a pair).
//
// First design, simple and right: mma.sync m16n8k16 bf16 products in 4
// warps of 16 rows (dQ: query rows; dK/dV: keys, as git_flash_bwd.cu),
// single-buffered shared-memory tiles, the bias read from global memory
// per score element.  wgmma, TMA and double buffering are left for later.

#include "mma_common.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;         // queries per tile
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps

__device__ __forceinline__ float finite_lse(float x) {
  return x == -INFINITY ? INFINITY : x;  // exp(s - inf) = 0 for that row
}

template <bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long do_sb, long long do_sh, long long do_ss,
                    long long dq_sb, long long dq_sh, long long dq_ss,
                    long long b_sb, long long b_sh, long long b_sq,
                    long long b_sk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sA[BM * PITCH];  // Q, then dO
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int wr = warp * 16;

  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const float* bp = HAS_BIAS ? bias + b * b_sb + h * b_sh : nullptr;

  // this warp's 16 query rows of Q and dO as A-fragments
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_tile<BM, NTHREADS>(sA, q + b * q_sb + h * q_sh, q_ss, q0, Lq, tid);
  __syncthreads();
  load_a_frags(qa, sA, wr, g, t);
  __syncthreads();
  load_tile<BM, NTHREADS>(sA, dout + b * do_sb + h * do_sh, do_ss, q0, Lq,
                          tid);
  __syncthreads();
  load_a_frags(da, sA, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < Lq;
    lse_r[i] = in ? finite_lse(lse[(long long)bh * Lq + row[i]]) : 0.f;
    d_r[i] = in ? delta[(long long)bh * Lq + row[i]] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BN, NTHREADS>(sK, kp, k_ss, k0, Lk, tid);
    load_tile<BN, NTHREADS>(sV, vp, v_ss, k0, Lk, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 x 64 per warp)
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kr = &sK[(j * 8 + g) * PITCH + kk * 16 + 2 * t];
        mma_16816(s[j], qa[kk], ld_u32(kr), ld_u32(kr + 8));
        const __nv_bfloat16* vr = &sV[(j * 8 + g) * PITCH + kk * 16 + 2 * t];
        mma_16816(dp[j], da[kk], ld_u32(vr), ld_u32(vr + 8));
      }
    }

    // dS = p * (dP - D) * scale, kept in s
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = k0 + j * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (row[i] < Lq && c < Lk) {
          float x = s[j][e] * scale;
          if (HAS_BIAS) x += __ldg(bp + row[i] * b_sq + c * b_sk);
          p = expf(x - lse_r[i]);
        }
        s[j][e] = p * (dp[j][e] - d_r[i]) * scale;
      }
    }

    // dQ += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = ld_u16(&sK[key * PITCH + d]) |
                            (ld_u16(&sK[(key + 1) * PITCH + d]) << 16);
        const uint32_t b1 = ld_u16(&sK[(key + 8) * PITCH + d]) |
                            (ld_u16(&sK[(key + 9) * PITCH + d]) << 16);
        mma_16816(acc[j], sa, b0, b1);
      }
    }
  }

  __nv_bfloat16* dqp = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Lq) continue;
    __nv_bfloat16* drow = dqp + (long long)row[i] * dq_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(drow + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long do_sb, long long do_sh, long long do_ss,
                     long long dk_sb, long long dk_sh, long long dk_ss,
                     long long dv_sb, long long dv_sh, long long dv_ss,
                     long long b_sb, long long b_sh, long long b_sq,
                     long long b_sk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sQ[BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sdO[BM * PITCH];
  __shared__ float sLse[BM];
  __shared__ float sD[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BN;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dop = dout + b * do_sb + h * do_sh;
  const float* bp = HAS_BIAS ? bias + b * b_sb + h * b_sh : nullptr;

  load_tile<BN, NTHREADS>(sK, k + b * k_sb + h * k_sh, k_ss, k0, Lk, tid);
  load_tile<BN, NTHREADS>(sV, v + b * v_sb + h * v_sh, v_ss, k0, Lk, tid);

  // this warp's 16 keys
  const int wr = warp * 16;
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  float dk_acc[DH / 8][4];
  float dv_acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += BM) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<BM, NTHREADS>(sQ, qp, q_ss, q0, Lq, tid);
    load_tile<BM, NTHREADS>(sdO, dop, do_ss, q0, Lq, tid);
    if (tid < BM) {
      const int r = q0 + tid;
      sLse[tid] = (r < Lq) ? finite_lse(lse[(long long)bh * Lq + r]) : 0.f;
      sD[tid] = (r < Lq) ? delta[(long long)bh * Lq + r] : 0.f;
    }
    __syncthreads();

    // S^T (16 keys x 64 queries per warp) = K Q^T
    float st[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t ka[4];
      ka[0] = ld_u32(&sK[(wr + g) * PITCH + c]);
      ka[1] = ld_u32(&sK[(wr + g + 8) * PITCH + c]);
      ka[2] = ld_u32(&sK[(wr + g) * PITCH + c + 8]);
      ka[3] = ld_u32(&sK[(wr + g + 8) * PITCH + c + 8]);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const __nv_bfloat16* qr = &sQ[(j * 8 + g) * PITCH + c];
        mma_16816(st[j], ka, ld_u32(qr), ld_u32(qr + 8));
      }
    }

    // P^T = exp(S^T * scale + bias - LSE) on in-range pairs
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        const int r = q0 + ql;
        const int c = key[e >> 1];
        float p = 0.f;
        if (r < Lq && c < Lk) {
          float x = st[j][e] * scale;
          if (HAS_BIAS) x += __ldg(bp + r * b_sq + c * b_sk);
          p = expf(x - sLse[ql]);
        }
        st[j][e] = p;
      }
    }

    // dV (16 keys x 64 dims) += bf16(P^T) dO
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16x2(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      const int qq = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = ld_u16(&sdO[qq * PITCH + d]) |
                            (ld_u16(&sdO[(qq + 1) * PITCH + d]) << 16);
        const uint32_t b1 = ld_u16(&sdO[(qq + 8) * PITCH + d]) |
                            (ld_u16(&sdO[(qq + 9) * PITCH + d]) << 16);
        mma_16816(dv_acc[j], pa, b0, b1);
      }
    }

    // dP^T (16 keys x 64 queries) = V dO^T
    float dpt[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t va[4];
      va[0] = ld_u32(&sV[(wr + g) * PITCH + c]);
      va[1] = ld_u32(&sV[(wr + g + 8) * PITCH + c]);
      va[2] = ld_u32(&sV[(wr + g) * PITCH + c + 8]);
      va[3] = ld_u32(&sV[(wr + g + 8) * PITCH + c + 8]);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const __nv_bfloat16* dr = &sdO[(j * 8 + g) * PITCH + c];
        mma_16816(dpt[j], va, ld_u32(dr), ld_u32(dr + 8));
      }
    }

    // dS^T = P^T * (dP^T - D) * scale, then dK (16 keys x 64 dims) +=
    // bf16(dS^T) Q
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        dpt[j][e] = st[j][e] * (dpt[j][e] - sD[ql]) * scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = pack_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[1] = pack_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[2] = pack_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[3] = pack_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
      const int qq = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = ld_u16(&sQ[qq * PITCH + d]) |
                            (ld_u16(&sQ[(qq + 1) * PITCH + d]) << 16);
        const uint32_t b1 = ld_u16(&sQ[(qq + 8) * PITCH + d]) |
                            (ld_u16(&sQ[(qq + 9) * PITCH + d]) << 16);
        mma_16816(dk_acc[j], sa, b0, b1);
      }
    }
  }

  __nv_bfloat16* dkp = dk + b * dk_sb + h * dk_sh;
  __nv_bfloat16* dvp = dv + b * dv_sb + h * dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Lk) continue;
    __nv_bfloat16* dkrow = dkp + (long long)key[i] * dk_ss;
    __nv_bfloat16* dvrow = dvp + (long long)key[i] * dv_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkrow + j * 8 + 2 * t) =
          pack_bf16x2(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvrow + j * 8 + 2 * t) =
          pack_bf16x2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() after their
// launches (the first error stops).  Strides are in elements, for
// (B, H, Lq, DH) views of q/o/dout/dq and (B, H, Lk, DH) views of
// k/v/dk/dv, with unit stride on DH and 16-byte aligned rows; lse and
// delta are (B, H, Lq) contiguous f32; bias is f32 read at
// bias[b*b_sb + h*b_sh + r*b_sq + c*b_sk], or null for no bias.
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
  const dim3 dgrid((Lq + DELTA_ROWS - 1) / DELTA_ROWS, B * H);
  rowsum_product_kernel<<<dgrid, DELTA_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta), H,
      Lq, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((Lq + BM - 1) / BM, B * H);
  auto kernel = bias ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dq), H,
      Lq, Lk, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb,
      do_sh, do_ss, dq_sb, dq_sh, dq_ss, b_sb, b_sh, b_sq, b_sk, scale);
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid((Lk + BN - 1) / BN, B * H);
  auto kernel = bias ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Lq, Lk, q_sb, q_sh, q_ss, k_sb,
      k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, dk_sb, dk_sh, dk_ss,
      dv_sb, dv_sh, dv_ss, b_sb, b_sh, b_sq, b_sk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
