// GIT-mask flash-attention backward for Hopper (sm_90a), split in two
// kernels: dQ per query tile, dK/dV per key tile, bf16 in and out.
//
// Replaces the Pallas TPU kernels sasvqa_tpu/ops/git_flash.py: _dq_kernel
// and _dkv_kernel (driven by _backward_split), with the K4 dropout hash
// (hash_keep in git_flash_common.cuh) regenerated from coordinates.  Per
// (b, h), query row r and key c, with P the forward's softmax
// probabilities and keep(r, c) the dropout factor {0, 1/(1-rate)} (1 at
// rate 0):
//   p   = exp(s[r, c] - LSE[r])        s as in the forward (masked, scaled)
//   D   = rowsum(dO * O)               over the dropped O (one prologue)
//   dS  = bf16(p * (dO V^T * keep - D))   unscaled, as the TPU kernels
//   dQ  = scale * (dS K)               git_flash_bwd_dq: one CTA per
//                                      64-query tile, streams key tiles
//   dK  = scale * (dS^T Q),  dV = bf16(p * keep)^T dO
//                                      git_flash_bwd_dkv: one CTA per
//                                      64-key tile, streams query tiles
// with f32 accumulation and the scale applied after it, each gradient
// written once as bf16 in the (B, S, H, Dh) layout the wrapper allocates.
//
// The TPU kernels carry nothing between grid steps either, so the split
// maps onto independent CTAs directly: each CTA owns its output tile, no
// atomics are needed, and dQ, dK and dV are the same bits from run to run
// (K2, git_flash_bwd.cu, adds dQ tiles with atomics in run-dependent
// order).  The price is recomputing S and dP in both kernels: 14*Dh FLOP
// an attended pair (dQ: S, dP, dQ; dK/dV: S, dV, dP, dK) against the fused
// pass's 10*Dh.  D comes from rowsum_product_kernel (mma_common.cuh),
// launched with the dQ kernel, where the TPU kernels recompute it per
// tile.
//
// Masked tile pairs are skipped: a query tile of image rows only visits
// the key tiles that hold image columns (the TPU's _n_unmasked_blocks
// prefix, as a loop bound), a query tile with text rows stops after its
// last row's key; a key tile of text columns only starts at its own first
// key (no earlier row attends it).
//
// Bound at the ViT-L/14 16-frame training shape (B=8, H=12, S=4144,
// num_img=4112, Dh=64): about 1.64e9 attended pairs; at 10*Dh FLOP a pair
// (one fused pass) 1.05e12 FLOP, ~1.06 ms at the 989 TFLOP/s bf16 dense
// peak, against ~0.5 GB of q/k/v/O/dO read and dQ/dK/dV written once,
// ~0.15 ms at 3.35 TB/s: compute-bound.  The split issues 14*Dh FLOP a
// pair, so its own floor is 1.4x that.
//
// First design, simple and right, as K2 and K6: mma.sync m16n8k16 bf16
// products in 4 warps of 16 rows (dQ: query rows; dK/dV: keys), single-
// buffered shared-memory tiles, ragged edges zero-filled and masked, no
// padding.  wgmma, TMA and double buffering are left for later work.

#include "git_flash_common.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;         // queries per tile
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps

// key column c's text-mask value, 1 for an image column
__device__ __forceinline__ int col_ok(int c, int num_img, int S,
                                      const int32_t* tm) {
  return (c < num_img) ? 1 : (c < S && tm[c - num_img] != 0);
}

template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
git_flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int32_t* __restrict__ text_mask,
                        const int32_t* __restrict__ seed_ptr,
                        __nv_bfloat16* __restrict__ dq, int H, int S,
                        int num_img, int L,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long do_sb, long long do_sh, long long do_ss,
                        long long dq_sb, long long dq_sh, long long dq_ss,
                        float scale, uint32_t thresh, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 sA[BM * PITCH];  // Q, then dO
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];
  __shared__ int sColOk[BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within the quad
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int wr = warp * 16;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(seed_ptr[0]) : 0u;

  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const int32_t* tm = text_mask + (long long)b * L;

  // this warp's 16 query rows of Q and dO as A-fragments
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_tile<BM, NTHREADS>(sA, q + b * q_sb + h * q_sh, q_ss, q0, S, tid);
  __syncthreads();
  load_a_frags(qa, sA, wr, g, t);
  __syncthreads();
  load_tile<BM, NTHREADS>(sA, dout + b * do_sb + h * do_sh, do_ss, q0, S,
                          tid);
  __syncthreads();
  load_a_frags(da, sA, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < S;
    lse_r[i] = in ? lse[(long long)bh * S + row[i]] : 0.f;
    d_r[i] = in ? delta[(long long)bh * S + row[i]] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // image rows attend image columns only; text rows attend up to themselves
  const int k_end = (q0 + BM <= num_img) ? num_img : min(S, q0 + BM);
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BN, NTHREADS>(sK, kp, k_ss, k0, S, tid);
    load_tile<BN, NTHREADS>(sV, vp, v_ss, k0, S, tid);
    if (tid < BN) sColOk[tid] = col_ok(k0 + tid, num_img, S, tm);
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

    // dS = p * (dP * keep - D), unscaled, kept in s (a masked pair's p is 0)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int cl = j * 8 + 2 * t + (e & 1);
        const int c = k0 + cl;
        const bool ok = row[i] < S && c < S &&
                        git_mask_ok(row[i], c, num_img, sColOk[cl]);
        const float p = ok ? expf(s[j][e] * scale - lse_r[i]) : 0.f;
        float dpv = dp[j][e];
        if (DROPOUT) {
          dpv = hash_keep(bh, row[i], c, seed, thresh) ? dpv * inv_keep : 0.f;
        }
        s[j][e] = p * (dpv - d_r[i]);
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
    if (row[i] >= S) continue;
    __nv_bfloat16* drow = dqp + (long long)row[i] * dq_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(drow + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
    }
  }
}

template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
git_flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ text_mask,
                         const int32_t* __restrict__ seed_ptr,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int S,
                         int num_img, int L,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long do_sb, long long do_sh, long long do_ss,
                         long long dk_sb, long long dk_sh, long long dk_ss,
                         long long dv_sb, long long dv_sh, long long dv_ss,
                         float scale, uint32_t thresh, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sQ[BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sdO[BM * PITCH];
  __shared__ float sLse[BM];
  __shared__ float sD[BM];
  __shared__ int sColOk[BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BN;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(seed_ptr[0]) : 0u;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dop = dout + b * do_sb + h * do_sh;

  load_tile<BN, NTHREADS>(sK, k + b * k_sb + h * k_sh, k_ss, k0, S, tid);
  load_tile<BN, NTHREADS>(sV, v + b * v_sb + h * v_sh, v_ss, k0, S, tid);
  if (tid < BN) {
    sColOk[tid] = col_ok(k0 + tid, num_img, S, text_mask + (long long)b * L);
  }

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

  // a tile of text keys only is attended by no row before its first key
  const int q_begin = (k0 >= num_img) ? k0 : 0;
  for (int q0 = q_begin; q0 < S; q0 += BM) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<BM, NTHREADS>(sQ, qp, q_ss, q0, S, tid);
    load_tile<BM, NTHREADS>(sdO, dop, do_ss, q0, S, tid);
    if (tid < BM) {
      const int r = q0 + tid;
      sLse[tid] = (r < S) ? lse[(long long)bh * S + r] : 0.f;
      sD[tid] = (r < S) ? delta[(long long)bh * S + r] : 0.f;
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

    // P^T = exp(S^T * scale - LSE) on attendable pairs; bit j*4+e of
    // keep_bits = kept
    uint32_t keep_bits = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        const int r = q0 + ql;
        const int c = key[e >> 1];
        const bool ok = r < S && c < S &&
                        git_mask_ok(r, c, num_img, sColOk[c - k0]);
        st[j][e] = ok ? expf(st[j][e] * scale - sLse[ql]) : 0.f;
        if (DROPOUT && !hash_keep(bh, r, c, seed, thresh)) {
          keep_bits &= ~(1u << (j * 4 + e));
        }
      }
    }

    // dV (16 keys x 64 dims) += bf16(P^T * keep) dO
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      float pk[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kk + half;
          const float p = st[j][e];
          pk[half][e] = !DROPOUT ? p
                        : ((keep_bits >> (j * 4 + e)) & 1u) ? p * inv_keep
                                                             : 0.f;
        }
      }
      uint32_t pa[4];
      pa[0] = pack_bf16x2(pk[0][0], pk[0][1]);
      pa[1] = pack_bf16x2(pk[0][2], pk[0][3]);
      pa[2] = pack_bf16x2(pk[1][0], pk[1][1]);
      pa[3] = pack_bf16x2(pk[1][2], pk[1][3]);
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

    // dS^T = P^T * (dP^T * keep - D), unscaled; dK += bf16(dS^T) Q
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        float dp = dpt[j][e];
        if (DROPOUT) {
          dp = ((keep_bits >> (j * 4 + e)) & 1u) ? dp * inv_keep : 0.f;
        }
        dpt[j][e] = st[j][e] * (dp - sD[ql]);
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
    if (key[i] >= S) continue;
    __nv_bfloat16* dkrow = dkp + (long long)key[i] * dk_ss;
    __nv_bfloat16* dvrow = dvp + (long long)key[i] * dv_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkrow + j * 8 + 2 * t) = pack_bf16x2(
          dk_acc[j][2 * i] * scale, dk_acc[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvrow + j * 8 + 2 * t) =
          pack_bf16x2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() after their
// launches (the first error stops).  Strides are in elements, for
// (B, H, S, DH) views with unit stride on DH and 16-byte aligned rows; lse
// and delta are (B, H, S) contiguous f32; text_mask is (B, L) int32; seed
// is a device int32.  thresh == 0 (rate 0) launches the kernels without
// the dropout code.
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
  const dim3 dgrid((S + DELTA_ROWS - 1) / DELTA_ROWS, B * H);
  rowsum_product_kernel<<<dgrid, DELTA_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta), H,
      S, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((S + BM - 1) / BM, B * H);
  auto kernel = thresh ? git_flash_bwd_dq_kernel<true>
                       : git_flash_bwd_dq_kernel<false>;
  kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(text_mask),
      static_cast<const int32_t*>(seed), static_cast<__nv_bfloat16*>(dq), H,
      S, num_img, L, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, scale, thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
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
  const dim3 grid((S + BN - 1) / BN, B * H);
  auto kernel = thresh ? git_flash_bwd_dkv_kernel<true>
                       : git_flash_bwd_dkv_kernel<false>;
  kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(text_mask),
      static_cast<const int32_t*>(seed), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, S, num_img, L, q_sb, q_sh, q_ss,
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, dk_sb, dk_sh,
      dk_ss, dv_sb, dv_sh, dv_ss, scale, thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
