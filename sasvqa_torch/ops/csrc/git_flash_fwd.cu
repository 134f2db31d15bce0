// GIT-mask flash-attention forward for Hopper (sm_90a), bf16 in, bf16 O and
// f32 LSE out.
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
// Columns >= S are masked without being read (the TPU kernel pads S to a
// block multiple and zeroes their column mask instead).
//
// Bound at the serving shape (B=8, H=12, S=1596, num_img=1576, Dh=64):
// about 2.4e8 attended (row, col) pairs at 4*Dh FLOP each, ~62 GFLOP, or
// ~62 us at the 989 TFLOP/s bf16 dense peak, against ~79 MB of q/k/v/O/LSE
// traffic, ~24 us at 3.35 TB/s: compute-bound.
//
// First design, simple and right: one CTA of 4 warps per (b*h, 64-query
// tile); each warp owns 16 query rows.  K/V tiles of 64 keys are staged
// through shared memory (single-buffered) and multiplied with warp-level
// mma.sync m16n8k16 bf16 tensor-core products; Q stays in registers as
// A-fragments, P is re-packed from the score accumulators straight into
// A-fragments for P.V.  Key tiles beyond max(num_img, last row of the
// query tile) hold no attendable column for any row of the tile and are
// skipped.  wgmma, TMA, warp specialisation and double buffering are left
// for later work.

#include "git_flash_common.cuh"

#include <math.h>

namespace {

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 rows

template <bool DROPOUT>
__global__ void __launch_bounds__(NTHREADS)
git_flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int32_t* __restrict__ text_mask,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int S, int num_img, int L,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss,
                     float scale, const int32_t* __restrict__ seed_ptr,
                     uint32_t thresh, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BM * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sK[BN * PITCH];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * PITCH];
  __shared__ int sColOk[BN];  // text-mask value of each column of the tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int t = lane & 3;   // column pair within the quad
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BM;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(seed_ptr[0]) : 0u;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const int32_t* tm = text_mask + (long long)b * L;

  load_tile<BM, NTHREADS>(sQ, qp, q_ss, q0, S, tid);
  __syncthreads();

  // Q A-fragments for this warp's 16 rows, one per 16-wide slice of DH
  const int wr = warp * 16;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld_u32(&sQ[(wr + g) * PITCH + c]);
    qa[kk][1] = ld_u32(&sQ[(wr + g + 8) * PITCH + c]);
    qa[kk][2] = ld_u32(&sQ[(wr + g) * PITCH + c + 8]);
    qa[kk][3] = ld_u32(&sQ[(wr + g + 8) * PITCH + c + 8]);
  }

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  // no row of this tile attends a column at or past kv_end
  const int kv_end = min(S, max(num_img, q0 + BM));
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BN, NTHREADS>(sK, kp, k_ss, k0, S, tid);
    load_tile<BN, NTHREADS>(sV, vp, v_ss, k0, S, tid);
    if (tid < BN) {
      const int c = k0 + tid;
      sColOk[tid] = (c < num_img) ? 1 : (c < S && tm[c - num_img] != 0);
    }
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

    // scale, mask, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1];
        const int cl = j * 8 + 2 * t + (e & 1);
        const int c = k0 + cl;
        float x = s[j][e] * scale;
        if (c >= S) {
          x = -INFINITY;
        } else if (!git_mask_ok(r, c, num_img, sColOk[cl])) {
          x += MASK_BIAS;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);  // finite: col 0 is valid
      corr[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        // dropout multiplies P after l is updated, as _fwd_kernel does
        if (DROPOUT) {
          const int c = k0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = hash_keep(bh, row[e >> 1], c, seed, thresh) ? p * inv_keep
                                                                : 0.f;
        } else {
          s[j][e] = p;
        }
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
    if (row[i] >= S) continue;
    __nv_bfloat16* orow = op + (long long)row[i] * o_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * i] / denom[i], acc[j][2 * i + 1] / denom[i]);
    }
    if (t == 0) lse[(long long)bh * S + row[i]] = lse_v[i];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// q/k/v/o strides are in elements, for a (B, H, S, DH) view with unit
// stride on DH; lse is (B, H, S) contiguous; text_mask is (B, L) int32;
// seed is a device int32.  thresh == 0 (rate 0) launches the kernel
// without the dropout code, bit for bit the kernel before dropout existed.
int git_flash_fwd(const void* q, const void* k, const void* v,
                  const void* text_mask, void* o, void* lse, int B, int H,
                  int S, int num_img, int L, long long q_sb, long long q_sh,
                  long long q_ss, long long k_sb, long long k_sh,
                  long long k_ss, long long v_sb, long long v_sh,
                  long long v_ss, long long o_sb, long long o_sh,
                  long long o_ss, float scale, const void* seed,
                  unsigned int thresh, float inv_keep, void* stream) {
  const dim3 grid((S + BM - 1) / BM, B * H);
  auto kernel = thresh ? git_flash_fwd_kernel<true>
                       : git_flash_fwd_kernel<false>;
  kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(text_mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, S, num_img,
      L, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss, scale, static_cast<const int32_t*>(seed), thresh, inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
