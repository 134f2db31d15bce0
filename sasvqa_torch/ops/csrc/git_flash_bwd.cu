// GIT-mask flash-attention backward for Hopper (sm_90a): dQ, dK, dV from
// one recompute of each score tile, bf16 in and out.
//
// Replaces the Pallas TPU kernel sasvqa_tpu/ops/git_flash.py:
// _fused_bwd_kernel (driven by _backward_fused), with the K4 dropout hash
// (_hash_keep, here hash_keep in git_flash_common.cuh) regenerated from
// coordinates.  Per (b, h), query row r and key c, with P the forward's
// softmax probabilities and keep(r, c) the dropout factor {0, 1/(1-rate)}
// (1 at rate 0):
//   p   = exp(s[r, c] - LSE[r])     s as in the forward (masked, scaled)
//   dV += (p * keep)^T dO           P*keep cast to bf16, f32 accumulate
//   dp  = (dO V^T) * keep
//   D   = rowsum(dO * O)            over the dropped O (a prologue kernel)
//   dS  = bf16(p * (dp - D) * scale)   the scale folded into the cast
//   dK += dS^T Q,  dQ += dS K       f32 accumulate
// dK and dV are written once as bf16.
//
// dQ: the TPU kernel keeps a (S_pad, Dh) f32 row block in VMEM that the
// sequential key-block grid revisits.  CUDA blocks run in parallel in no
// order, so here every (key tile, query tile) pair adds its dQ tile into a
// zeroed (B, H, S, Dh) f32 buffer with atomicAdd (red.global.add.f32), and
// the wrapper casts the buffer to bf16.  The order of those additions
// changes from run to run, so dQ is not bit-for-bit deterministic (dK, dV
// are).
//
// Bound at the training shape (B=16, H=12, S=1608, num_img=1576, Dh=64):
// about 4.9e8 attended pairs at 10*Dh FLOP each (5 products of 2*Dh),
// ~312 GFLOP a call, ~0.32 ms at the 989 TFLOP/s bf16 dense peak, against
// ~0.32 GB of q/k/v/O/dO/LSE read and dQ/dK/dV written once, ~0.1 ms at
// 3.35 TB/s: compute-bound.  The dQ atomics move about
// (key tiles) x S x Dh x 4 B per (b, h), ~2 GB a call, through L2; they are
// the first suspect if the kernel is slow.
//
// First design, simple and right: one CTA of 4 warps per (b*h, 64-key
// tile) that streams 64-query tiles; each warp owns 16 keys of the tile
// for S^T = K Q^T, dV, dP^T = V dO^T and dK (all as mma.sync m16n8k16 bf16
// products with f32 accumulators in registers), writes its dS^T slice to
// shared memory, and then owns 16 queries for dQ = dS K.  Pure text-key
// tiles skip every query tile below their first key (no row there attends
// them).  No padding: rows and keys at or past S are zero-filled in
// shared memory and masked.  wgmma, TMA and double buffering are left for
// later work.

#include "git_flash_common.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;         // queries per streamed tile
constexpr int BN = 64;         // keys per CTA
constexpr int NTHREADS = 128;  // 4 warps
constexpr int DELTA_ROWS = 16;  // rows per block of the D prologue

// D[b, h, r] = sum_d dO[r, d] * O[r, d] in f32; 8 threads per row
__global__ void __launch_bounds__(NTHREADS)
git_flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           float* __restrict__ delta, int H, int S,
                           long long o_sb, long long o_sh, long long o_ss,
                           long long do_sb, long long do_sh,
                           long long do_ss) {
  const int tid = threadIdx.x;
  const int r = blockIdx.x * DELTA_ROWS + tid / 8;
  const int c = (tid % 8) * 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  float acc = 0.f;
  if (r < S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_sb + h * o_sh + (long long)r * o_ss + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * do_sb + h * do_sh + (long long)r * do_ss + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 d = __bfloat1622float2(d2[i]);
      acc += a.x * d.x + a.y * d.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (r < S && tid % 8 == 0) delta[(long long)bh * S + r] = acc;
}

template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
git_flash_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int32_t* __restrict__ text_mask,
                     const int32_t* __restrict__ seed_ptr,
                     float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int H, int S, int num_img, int L,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long do_sb, long long do_sh, long long do_ss,
                     long long dq_sb, long long dq_sh, long long dq_ss,
                     long long dk_sb, long long dk_sh, long long dk_ss,
                     long long dv_sb, long long dv_sh, long long dv_ss,
                     float scale, uint32_t thresh, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sQ[BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sdO[BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sdS[BM * PITCH];  // [query][key]
  __shared__ float sLse[BM];
  __shared__ float sD[BM];
  __shared__ int sColOk[BN];  // text-mask value of each key of the tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within the quad
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BN;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(seed_ptr[0]) : 0u;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* dop = dout + b * do_sb + h * do_sh;
  float* dqp = dq + b * dq_sb + h * dq_sh;
  const int32_t* tm = text_mask + (long long)b * L;

  load_tile<BN, NTHREADS>(sK, kp, k_ss, k0, S, tid);
  load_tile<BN, NTHREADS>(sV, vp, v_ss, k0, S, tid);
  if (tid < BN) {
    const int c = k0 + tid;
    sColOk[tid] = (c < num_img) ? 1 : (c < S && tm[c - num_img] != 0);
  }

  // this warp's 16 keys for S^T, dV, dP^T and dK; its 16 queries for dQ
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

    // P^T = exp(S^T * scale - LSE) on attendable pairs (a masked pair's
    // exp(s - 1e9 - LSE) is 0 in f32); bit j*4+e of keep_bits = kept
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

    // dS^T = P^T * (dP^T * keep - D) * scale, rounded to bf16 once for both
    // dK and dQ; its slice goes to shared memory as [query][key]
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        float dp = dpt[j][e];
        if (DROPOUT) {
          dp = ((keep_bits >> (j * 4 + e)) & 1u) ? dp * inv_keep : 0.f;
        }
        const __nv_bfloat16 ds =
            __float2bfloat16_rn(st[j][e] * (dp - sD[ql]) * scale);
        dpt[j][e] = __bfloat162float(ds);
        sdS[ql * PITCH + wr + g + 8 * (e >> 1)] = ds;
      }
    }

    // dK (16 keys x 64 dims) += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1]);
      da[1] = pack_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3]);
      da[2] = pack_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      da[3] = pack_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
      const int qq = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = ld_u16(&sQ[qq * PITCH + d]) |
                            (ld_u16(&sQ[(qq + 1) * PITCH + d]) << 16);
        const uint32_t b1 = ld_u16(&sQ[(qq + 8) * PITCH + d]) |
                            (ld_u16(&sQ[(qq + 9) * PITCH + d]) << 16);
        mma_16816(dk_acc[j], da, b0, b1);
      }
    }
    __syncthreads();  // the whole dS tile is in shared memory

    // dQ (16 queries x 64 dims per warp) = dS K, added into the f32 buffer
    float dqa[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t sa[4];
      sa[0] = ld_u32(&sdS[(wr + g) * PITCH + c]);
      sa[1] = ld_u32(&sdS[(wr + g + 8) * PITCH + c]);
      sa[2] = ld_u32(&sdS[(wr + g) * PITCH + c + 8]);
      sa[3] = ld_u32(&sdS[(wr + g + 8) * PITCH + c + 8]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = ld_u16(&sK[c * PITCH + d]) |
                            (ld_u16(&sK[(c + 1) * PITCH + d]) << 16);
        const uint32_t b1 = ld_u16(&sK[(c + 8) * PITCH + d]) |
                            (ld_u16(&sK[(c + 9) * PITCH + d]) << 16);
        mma_16816(dqa[j], sa, b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + wr + g + 8 * i;
      if (r >= S) continue;
      float* dqrow = dqp + (long long)r * dq_ss;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        atomicAdd(dqrow + j * 8 + 2 * t, dqa[j][2 * i]);
        atomicAdd(dqrow + j * 8 + 2 * t + 1, dqa[j][2 * i + 1]);
      }
    }
  }

  // dK (scale already folded into dS) and dV, once, as bf16
  __nv_bfloat16* dkp = dk + b * dk_sb + h * dk_sh;
  __nv_bfloat16* dvp = dv + b * dv_sb + h * dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
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

// Launches the D prologue and the backward on `stream`; returns
// cudaGetLastError() after each launch (the first error stops).  Strides
// are in elements, for (B, H, S, DH) views with unit stride on DH; lse and
// delta are (B, H, S) contiguous f32; dq is f32 and must hold zeros;
// text_mask is (B, L) int32; seed is a device int32.  thresh == 0 (rate 0)
// launches the kernel without the dropout code.
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 dgrid((S + DELTA_ROWS - 1) / DELTA_ROWS, B * H);
  git_flash_bwd_delta_kernel<<<dgrid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta), H,
      S, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((S + BN - 1) / BN, B * H);
  auto kernel = thresh ? git_flash_bwd_kernel<true>
                       : git_flash_bwd_kernel<false>;
  kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(text_mask),
      static_cast<const int32_t*>(seed), static_cast<float*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, S,
      num_img, L, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb,
      dv_sh, dv_ss, scale, thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
