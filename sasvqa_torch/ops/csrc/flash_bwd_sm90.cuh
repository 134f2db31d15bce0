// The Hopper (sm_90a) flash-attention backward mainloop shared by K6
// (flash_bwd.cu: no mask, or an additive bias), K3 (git_flash_bwd_split.cu:
// the GIT mask, with the K4 dropout hash at rate > 0) and K2
// (git_flash_bwd.cu: the same, fused).  Three programs: a dQ program per
// 64-query tile that streams key tiles and a dK/dV program per 64-key tile
// that streams query tiles (the split backward, no atomics), and a fused
// program per 128-key tile that streams query tiles and adds each query
// tile's dQ into an f32 workspace by TMA reductions.  Each .cu file only
// fills BwdParams and picks the mask policy.  D = rowsum(dO * O) comes from
// rowsum_product_kernel (mma_common.cuh), launched first.
//
// Per (b, h), query row r and key c, with the forward's LSE:
//   p   = exp(s[r, c] - LSE[r])    s = (q_r . k_c) * scale + mask(r, c);
//                                  in base 2, scale * log2(e) and LSE *
//                                  log2(e) folded into one FFMA; a masked
//                                  pair, a key >= Lk or a row whose LSE is
//                                  -inf (every key at an -inf bias) gives 0
//   keep = the K4 factor {0, 1/(1-rate)} (1 without dropout)
//   dS  = bf16(p * (dP * keep - D) * ds_scale)    dP = dO . v_c
//   dQ  = out_scale * dS K,  dK = out_scale * dS^T Q,  dV = bf16(p*keep)^T dO
// with f32 accumulation, dK and dV written once in bf16 (the split dQ too;
// the fused dQ is an f32 sum the launcher casts).  K6 and K2 fold the
// scale into dS (ds_scale = scale, out_scale = 1), K3 applies it to the
// f32 sums as the TPU split kernels do (ds_scale = 1, out_scale = scale);
// with Dh = 64 the scale is a power of two and the two round alike.
//
// Design, from the forward's parts (sm90_common.cuh): 64-row tiles arrive
// by TMA (128-byte swizzle) through a 4-stage ring of mbarriers; all
// products are wgmma.  A streamed tile serves as a K-major operand (its
// Dh contracted) and as an MN-major operand (its rows contracted) through
// two descriptors on one swizzled buffer, as V is read in the forward.  A
// split CTA is one consumer warpgroup and one producer warp.
//
// dQ program: Q and dO load once; K/V tiles stream over the key tiles of
// the forward's plan (kGitMask: none past max(num_img, last row of the
// tile)).  S = Q.K^T and dP = dO.V^T are wgmma SS; dS stays in registers
// as the A-fragment of dQ += dS.K (RS, K MN-major).  The dQ product of
// tile j is issued behind S and dP of tile j + 1, and P is computed while
// dP and that product run.
//
// dK/dV program: K and V load once; Q/dO tiles stream with their LSE and
// D rows, which the producer warp stages into shared memory beside each
// stage (LSE pre-scaled to base 2, +inf past Lq so p = 0 there).
// S^T = K.Q^T and dP^T = V.dO^T are SS, P^T is computed while dP^T runs;
// P^T * keep and dS^T, in registers, are the A-fragments of
// dV += (P^T keep).dO and dK += dS^T.Q (RS, dO and Q MN-major), which
// complete before the next tile's products (registers, below).  The keep
// factor is computed once a pair for both P and dP.  kGitMask starts a
// key tile of text keys at its own first row (no earlier row attends it)
// and runs no mask code at all in a CTA whose keys lie below num_img.
//
// Fused program (K2): the dK/dV program's step, run by two consumer
// warpgroups on the two 64-key halves of a 128-key tile over the same
// streamed query tiles.  Each also stores its dS^T in bf16 to a swizzled
// shared tile; after a named barrier one warpgroup, alternately, computes
// dQ = dS.K over all 128 keys (wgmma SS, dS^T and K both read MN-major),
// behind which the next query tile's S^T and dP^T run; once it completes
// the f32 tile goes to shared memory and one thread adds it into the
// workspace by two TMA reductions (cp.reduce.async.bulk.tensor), which
// run under the next tiles' products.  Summing 128 keys before each
// reduction halves the workspace traffic of a 64-key CTA.  One CTA an SM
// (163 KB of shared memory).  It has no producer warp: a ninth warp would
// cap registers at 168 a thread (three warps a sub-partition), too few to
// keep the dQ product in flight beside S^T, dP^T, dK and dV, and ptxas
// keeps that cap under setmaxnreg; with 8 warps the cap is 255.  Warp 0
// refills a stage once both warpgroups are past the barrier that ends its
// step: Q and dO by TMA, the LSE and D rows by cp.async, both arriving on
// the stage's mbarrier.  The order of the f32 additions varies from run to
// run, so dQ does (dK, dV do not).
//
// All: a tile that needs no mask (kNoMask: wholly below Lk; kGitMask:
// wholly below num_img) runs no mask code.  The split programs compute a
// last streamed tile of at most 16 rows (577 = 9 * 64 + 1) 16 wide.  Two
// split CTAs share an SM (83 KB of shared memory each), so one CTA's
// elementwise step and hash run under the other's products.  Their 10
// warps leave at most 168 registers a thread (an SM sub-partition's 16K
// registers hold three warps), too few for the dK/dV program to keep S^T,
// dP^T, dK, dV (four 64 x 64 f32 fragments) and the previous tile's bf16
// operands at once.
#pragma once

#include "git_flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int BWD_BM = TILE_ROWS;     // query rows a dQ CTA, a query tile
constexpr int BWD_BN = TILE_ROWS;     // keys a dK/dV CTA, a key tile
constexpr int BWD_THREADS = 160;      // a consumer warpgroup + producer warp
constexpr int BWD_STAGES = 4;         // ring depth
constexpr int BWD_CTAS_PER_SM = 2;    // registers: at most 168 a thread
// dQ program: Q, dO, the K and V rings; full_qdo, full[STAGES],
// empty[STAGES]; slack to align the base to the 1024 B swizzle pattern
constexpr int DQ_BAR_OFF = (2 + 2 * BWD_STAGES) * TILE_BYTES;
constexpr int DQ_SMEM_BYTES = DQ_BAR_OFF + 8 * (1 + 2 * BWD_STAGES) + 1024;
// dK/dV program: K, V, the Q and dO rings, each stage's LSE and D rows
// (f32), then full_kv, full[STAGES], empty[STAGES]
constexpr int DKV_ROWS_OFF = (2 + 2 * BWD_STAGES) * TILE_BYTES;
constexpr int DKV_BAR_OFF = DKV_ROWS_OFF + BWD_STAGES * 2 * BWD_BM * 4;
constexpr int DKV_SMEM_BYTES = DKV_BAR_OFF + 8 * (1 + 2 * BWD_STAGES) + 1024;
// fused program: a consumer warpgroup a 64-key half, one CTA an SM
constexpr int FUSED_BN = 2 * TILE_ROWS;  // keys a fused CTA
// two consumer warpgroups and no producer warp: 8 warps, two an SM
// sub-partition, leave 255 registers a thread (a ninth warp would cap
// them at 168)
constexpr int FUSED_THREADS = 256;
// ptxas (CUDA 12.9) crashes on this program from a cap of 200 registers;
// it takes 176-184 of these 184
constexpr int FUSED_MAX_REGS = 184;
// K and V (128 rows each), the Q and dO rings, dS^T of two query tiles
// (two key halves each), an f32 dQ tile a warpgroup (two 64 x 32 boxes),
// each stage's LSE and D rows, then full_kv, full[STAGES]
constexpr int FUSED_DS_OFF = (4 + 2 * BWD_STAGES) * TILE_BYTES;
constexpr int FUSED_DQ_OFF = FUSED_DS_OFF + 4 * TILE_BYTES;
constexpr int FUSED_ROWS_OFF = FUSED_DQ_OFF + 4 * TILE_BYTES;
constexpr int FUSED_BAR_OFF = FUSED_ROWS_OFF + BWD_STAGES * 2 * BWD_BM * 4;
constexpr int FUSED_SMEM_BYTES =
    FUSED_BAR_OFF + 8 * (1 + BWD_STAGES) + 1024;

struct BwdParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  CUtensorMap tm_dq;   // fused: the f32 (B, H, Lq, Dh) dQ workspace
  // gradients, element strides of (B, H, L, Dh) views
  __nv_bfloat16* dq;
  long long dq_sb, dq_sh, dq_ss;
  __nv_bfloat16* dk;
  long long dk_sb, dk_sh, dk_ss;
  __nv_bfloat16* dv;
  long long dv_sb, dv_sh, dv_ss;
  const float* lse;    // (B, H, Lq), natural log
  const float* delta;  // (B, H, Lq)
  int H, Lq, Lk;
  float scale_log2;    // scale * log2(e)
  float ds_scale;      // multiplies dS before its bf16 cast
  float out_scale;     // multiplies the f32 sums of dQ and dK
  // kBias
  const float* bias;
  long long b_sb, b_sh, b_sq, b_sk;
  // kGitMask (Lq == Lk == S = num_img + L)
  const int32_t* text_mask;
  int num_img, L;
  const int32_t* seed_ptr;
  uint32_t thresh;
  float inv_keep;
};

// the forward's LSE as the base-2 offset of p; an LSE of -inf (a row with
// no attendable key) becomes +inf, so p = exp2(x - inf) = 0
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * LOG2E;
}

// dQ program: keys [0, kv_end) hold every column a row of query tile q0
// attends (the forward's plan)
template <int MASK>
__device__ __forceinline__ int bwd_kv_end(const BwdParams& p, int q0) {
  return MASK == kGitMask ? min(p.Lk, max(p.num_img, q0 + BWD_BM)) : p.Lk;
}

// dK/dV program: rows [q_begin, Lq) hold every row that attends a key of
// tile k0; no row before a text key attends it
template <int MASK>
__device__ __forceinline__ int bwd_q_begin(const BwdParams& p, int k0) {
  return (MASK == kGitMask && k0 >= p.num_img) ? k0 / BWD_BM * BWD_BM : 0;
}

// what a dQ consumer thread needs: its two rows with their base-2 LSE and
// D, its column pair within the quad, and the row pointers of the inputs
struct DqCtx {
  int row[2];
  float lse2[2], d[2];
  int t, bh;
  uint32_t seed;
  const int32_t* tm;     // kGitMask: this example's text mask
  const float* brow[2];  // kBias: the bias rows (null past Lq)
};

// Phase 1 of a key tile in the dQ program: P in s from S in s (0 where
// masked or past Lk); with dropout, bit e of the result is the keep of
// element e (columns k0 + 8j + 2t + {0, 1})
template <int MASK, bool DROPOUT, int NS>
__device__ __forceinline__ uint32_t dq_probs(float (&s)[NS],
                                             const BwdParams& p,
                                             const DqCtx& x, int k0,
                                             int tile_keys) {
  const bool masked = MASK == kBias ||
                      (MASK == kNoMask ? k0 + tile_keys > p.Lk
                                       : k0 + tile_keys > p.num_img);
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
      const int c = k0 + j * 8 + 2 * x.t + cb;
      int col_ok = 1;
      if (MASK == kGitMask && masked) {
        col_ok = c < p.num_img ? 1
                               : (c < p.Lk && __ldg(x.tm + c - p.num_img));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i + cb;
        float arg = fmaf(s[e], p.scale_log2, -x.lse2[i]);
        bool ok = true;
        if (masked) {
          ok = c < p.Lk;
          if (MASK == kBias && ok && x.brow[i]) {
            arg = fmaf(__ldg(x.brow[i] + c * p.b_sk), LOG2E, arg);
          }
          if (MASK == kGitMask) {
            ok = ok && git_mask_ok(x.row[i], c, p.num_img, col_ok);
          }
        }
        s[e] = ok ? ex2(arg) : 0.f;
        if (DROPOUT && hash_keep(x.bh, x.row[i], c, x.seed, p.thresh)) {
          keep |= 1u << e;
        }
      }
    }
  }
  return keep;
}

// Phase 2: dS (times ds_scale) in s, from P in s and dP in dp
template <bool DROPOUT, int NS>
__device__ __forceinline__ void dq_grads(float (&s)[NS],
                                         const float (&dp)[NS],
                                         const BwdParams& p, const DqCtx& x,
                                         uint32_t keep) {
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    float dpv = dp[e];
    if (DROPOUT) dpv = ((keep >> e) & 1u) ? dpv * p.inv_keep : 0.f;
    s[e] = s[e] * (dpv - x.d[(e >> 1) & 1]) * p.ds_scale;
  }
}

// One key tile of the dQ program (NS = 32: 64 keys; 8: a narrow last
// tile): S = Q.K^T and dP = dO.V^T by wgmma SS, with the previous tile's
// dQ product (acc += dS_prev . K_prev) issued behind them when `prev`;
// P is computed while dP and that product run.  Leaves dS in s.
template <int MASK, bool DROPOUT, int NS>
__device__ __forceinline__ void dq_step(float (&s)[NS], float (&dp)[NS],
                                        float (&acc)[32],
                                        const uint32_t (&dsa_prev)[4][4],
                                        bool prev, uint32_t sk_prev,
                                        const BwdParams& p, const DqCtx& x,
                                        int k0, int tile_keys, uint32_t sq,
                                        uint32_t sdo, uint32_t sk,
                                        uint32_t sv) {
  pin(s);
  pin(dp);
  pin(acc);
  wg_fence();
  issue_ss(s, sq, sk);  // S = Q K^T
  wg_commit();
  issue_ss(dp, sdo, sv);  // dP = dO V^T
  wg_commit();
  if (prev) issue_rs(acc, dsa_prev, sk_prev);  // dQ += dS K
  wg_commit();  // an empty group on the first tile
  wg_wait<2>();
  pin(s);
  const uint32_t keep = dq_probs<MASK, DROPOUT>(s, p, x, k0, tile_keys);
  wg_wait<1>();
  pin(dp);
  dq_grads<DROPOUT>(s, dp, p, x, keep);
  wg_wait<0>();
  pin(acc);
}

// what a dK/dV consumer thread needs: its two keys with their text-mask
// values and bias columns, its query pair within the quad
struct DkvCtx {
  int key[2];
  int col_ok[2];          // kGitMask
  const float* bcol[2];   // kBias: the bias at (b, h, 0, key), null past Lk
  int t, bh;
  uint32_t seed;
};

// Phase 1 of a query tile in the dK/dV program: P^T in s from S^T in s
// (columns: queries q0 + 8j + 2t + {0, 1}, whose base-2 LSE is staged at
// slse, or their natural LSE when RAW_LSE); with dropout, bit e of the
// result is the keep of element e
template <int MASK, bool DROPOUT, int NS, bool RAW_LSE = false>
__device__ __forceinline__ uint32_t dkv_probs(float (&s)[NS],
                                              const BwdParams& p,
                                              const DkvCtx& x, bool masked,
                                              int q0, const float* slse) {
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(slse + j * 8 + 2 * x.t);
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
      const int q = q0 + j * 8 + 2 * x.t + cb;
      const float lse2 = RAW_LSE ? lse_log2(cb ? l2.y : l2.x)
                                 : (cb ? l2.y : l2.x);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i + cb;
        float arg = fmaf(s[e], p.scale_log2, -lse2);
        bool ok = true;
        if (MASK == kBias && x.bcol[i] && q < p.Lq) {
          arg = fmaf(__ldg(x.bcol[i] + q * p.b_sq), LOG2E, arg);
        }
        if (MASK == kGitMask && masked) {
          ok = git_mask_ok(q, x.key[i], p.num_img, x.col_ok[i]);
        }
        s[e] = ok ? ex2(arg) : 0.f;
        if (DROPOUT && hash_keep(x.bh, q, x.key[i], x.seed, p.thresh)) {
          keep |= 1u << e;
        }
      }
    }
  }
  return keep;
}

// Phase 2: P^T * keep in s and dS^T (times ds_scale) in dp, from P^T in s
// and dP^T in dp, with the queries' D staged at sd
template <bool DROPOUT, int NS>
__device__ __forceinline__ void dkv_grads(float (&s)[NS], float (&dp)[NS],
                                          const BwdParams& p,
                                          const DkvCtx& x, uint32_t keep,
                                          const float* sd) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float2 dd = *reinterpret_cast<const float2*>(sd + j * 8 + 2 * x.t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * j + k;
      const float pv = s[e];
      float dpv = dp[e];
      if (DROPOUT) {
        const float kf = ((keep >> e) & 1u) ? p.inv_keep : 0.f;
        dpv *= kf;
        s[e] = pv * kf;
      }
      dp[e] = pv * (dpv - ((k & 1) ? dd.y : dd.x)) * p.ds_scale;
    }
  }
}

// One query tile of the dK/dV program (NS = 32: 64 queries; 8: a narrow
// last tile): S^T = K.Q^T and dP^T = V.dO^T by wgmma SS, P^T computed
// while dP^T runs, then dV += (P^T keep).dO and dK += dS^T.Q by wgmma RS
// from registers, Q and dO read MN-major.  The RS products complete before
// the next tile's SS: the four 64 x 64 f32 fragments and the bf16 A
// operands do not fit the 168 registers a thread of two CTAs an SM.
template <int MASK, bool DROPOUT, int NS>
__device__ __forceinline__ void dkv_step(float (&dk_acc)[32],
                                         float (&dv_acc)[32],
                                         const BwdParams& p, const DkvCtx& x,
                                         bool masked, int q0,
                                         const float* srow, uint32_t sk,
                                         uint32_t sv, uint32_t sq,
                                         uint32_t sdo) {
  float s[NS], dp[NS];
  pin(dk_acc);
  pin(dv_acc);
  wg_fence();
  issue_ss(s, sk, sq);  // S^T = K Q^T
  wg_commit();
  issue_ss(dp, sv, sdo);  // dP^T = V dO^T
  wg_commit();
  wg_wait<1>();
  pin(s);
  const uint32_t keep = dkv_probs<MASK, DROPOUT>(s, p, x, masked, q0, srow);
  wg_wait<0>();
  pin(dp);
  dkv_grads<DROPOUT>(s, dp, p, x, keep, srow + BWD_BM);
  uint32_t pa[NS / 8][4], dsa[NS / 8][4];
  pack_a(pa, s);
  pack_a(dsa, dp);
  wg_fence();
  issue_rs(dv_acc, pa, sdo);   // dV += (P^T keep) dO
  issue_rs(dk_acc, dsa, sq);   // dK += dS^T Q
  wg_commit();
  wg_wait<0>();
  pin(dk_acc);
  pin(dv_acc);
}

// one 64 x Dh f32 fragment (rows r0 + 16w + g + 8i) times `scale` to a
// bf16 (B, H, L, Dh) output, rows below `rows` only
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[32],
                                           const int (&row)[2], int rows,
                                           int t, float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    __nv_bfloat16* orow = out + static_cast<long long>(row[i]) * ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16x2(acc[4 * j + 2 * i] * scale,
                      acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

template <int MASK, bool DROPOUT>
__global__ void __launch_bounds__(BWD_THREADS, BWD_CTAS_PER_SM)
flash_bwd_dq_sm90_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + TILE_BYTES;
  const uint32_t sk0 = base + 2 * TILE_BYTES;
  const uint32_t sv0 = sk0 + BWD_STAGES * TILE_BYTES;
  const uint32_t full_qdo = base + DQ_BAR_OFF;
  const uint32_t full0 = full_qdo + 8;
  const uint32_t empty0 = full0 + 8 * BWD_STAGES;

  const int q0 = blockIdx.x * BWD_BM;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kv_end = bwd_kv_end<MASK>(p, q0);
  const int n_tiles = (kv_end + BWD_BN - 1) / BWD_BN;

  if (threadIdx.x == 0) {
    mbar_init(full_qdo, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // broadcast from lane 0, so the compiler knows it is warp-uniform
  const int warp_id = __shfl_sync(0xffffffffu,
                                  static_cast<int>(threadIdx.x / 32), 0);
  if (warp_id == 4) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(full_qdo, 2 * TILE_BYTES);
      tma_load(sq, &p.tm_q, full_qdo, q0, h, b);
      tma_load(sdo, &p.tm_do, full_qdo, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % BWD_STAGES;
        mbar_wait(empty0 + 8 * s, ((it / BWD_STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * TILE_BYTES);
        tma_load(sk0 + s * TILE_BYTES, &p.tm_k, full0 + 8 * s, it * BWD_BN,
                 h, b);
        tma_load(sv0 + s * TILE_BYTES, &p.tm_v, full0 + 8 * s, it * BWD_BN,
                 h, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 16 query rows a warp ----
  const int lane = threadIdx.x % 32;
  DqCtx x;
  x.t = lane % 4;
  x.bh = bh;
  x.seed = DROPOUT ? static_cast<uint32_t>(p.seed_ptr[0]) : 0u;
  x.tm = MASK == kGitMask ? p.text_mask + static_cast<long long>(b) * p.L
                          : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp_id * 16 + lane / 4 + 8 * i;
    x.row[i] = r;
    const bool in = r < p.Lq;
    const long long at = static_cast<long long>(bh) * p.Lq + r;
    x.lse2[i] = in ? lse_log2(p.lse[at]) : INFINITY;
    x.d[i] = in ? p.delta[at] : 0.f;
    x.brow[i] = (MASK == kBias && in)
                    ? p.bias + b * p.b_sb + h * p.b_sh + r * p.b_sq
                    : nullptr;
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t dsa[BWD_BN / 16][4];  // bf16 dS of the previous tile

  // a last tile of at most TAIL_BN keys is computed TAIL_BN wide
  const bool narrow_tail = kv_end - (n_tiles - 1) * BWD_BN <= TAIL_BN;
  const int n_full = n_tiles - (narrow_tail ? 1 : 0);

  mbar_wait(full_qdo, 0);
  for (int it = 0; it < n_full; ++it) {
    const int st = it % BWD_STAGES;
    const int sp = (it + BWD_STAGES - 1) % BWD_STAGES;  // previous tile's
    mbar_wait(full0 + 8 * st, (it / BWD_STAGES) & 1);
    dq_step<MASK, DROPOUT>(s, dp, acc, dsa, it > 0, sk0 + sp * TILE_BYTES,
                           p, x, it * BWD_BN, BWD_BN, sq, sdo,
                           sk0 + st * TILE_BYTES, sv0 + st * TILE_BYTES);
    if (it > 0) mbar_arrive(empty0 + 8 * sp);
    pack_a(dsa, s);
  }

  if (narrow_tail) {
    // the same step on a TAIL_BN-key tile (S and dP m64n16), then its
    // one-k-step dQ product
    const int it = n_full;
    const int st = it % BWD_STAGES;
    const int sp = (it + BWD_STAGES - 1) % BWD_STAGES;
    float s_t[TAIL_BN / 2], dp_t[TAIL_BN / 2];
    uint32_t dsa_t[1][4];
    mbar_wait(full0 + 8 * st, (it / BWD_STAGES) & 1);
    dq_step<MASK, DROPOUT>(s_t, dp_t, acc, dsa, it > 0,
                           sk0 + sp * TILE_BYTES, p, x, it * BWD_BN, TAIL_BN,
                           sq, sdo, sk0 + st * TILE_BYTES,
                           sv0 + st * TILE_BYTES);
    if (it > 0) mbar_arrive(empty0 + 8 * sp);
    pack_a(dsa_t, s_t);
    wg_fence();
    issue_rs(acc, dsa_t, sk0 + st * TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(acc);
  } else if (n_tiles > 0) {  // the last tile's dQ product
    const int sp = (n_tiles - 1) % BWD_STAGES;
    wg_fence();
    issue_rs(acc, dsa, sk0 + sp * TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(acc);
  }

  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, acc, x.row, p.Lq,
             x.t, p.out_scale);
}

template <int MASK, bool DROPOUT>
__global__ void __launch_bounds__(BWD_THREADS, BWD_CTAS_PER_SM)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = base + TILE_BYTES;
  const uint32_t sq0 = base + 2 * TILE_BYTES;
  const uint32_t sdo0 = sq0 + BWD_STAGES * TILE_BYTES;
  // each stage's LSE (base 2) and D rows, through a generic pointer
  float* const srows = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + DKV_ROWS_OFF);
  const uint32_t full_kv = base + DKV_BAR_OFF;
  const uint32_t full0 = full_kv + 8;
  const uint32_t empty0 = full0 + 8 * BWD_STAGES;

  const int k0 = blockIdx.x * BWD_BN;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q_begin = bwd_q_begin<MASK>(p, k0);
  const int n_tiles = (p.Lq - q_begin + BWD_BM - 1) / BWD_BM;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      // the producer warp's 32 lanes each stage two LSE and D rows; lane
      // 0's arrival also expects the tiles' bytes
      mbar_init(full0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_id = __shfl_sync(0xffffffffu,
                                  static_cast<int>(threadIdx.x / 32), 0);
  const int lane = threadIdx.x % 32;
  if (warp_id == 4) {
    // ---- producer warp: lane 0 issues the copies, every lane stages
    // LSE and D rows ----
    if (lane == 0) {
      mbar_expect_tx(full_kv, 2 * TILE_BYTES);
      tma_load(sk, &p.tm_k, full_kv, k0, h, b);
      tma_load(sv, &p.tm_v, full_kv, k0, h, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % BWD_STAGES;
      const int q0 = q_begin + it * BWD_BM;
      mbar_wait(empty0 + 8 * s, ((it / BWD_STAGES) & 1) ^ 1);
      float* rows = srows + s * 2 * BWD_BM;
      for (int r = lane; r < BWD_BM; r += 32) {
        const int q = q0 + r;
        const long long at = static_cast<long long>(bh) * p.Lq + q;
        rows[r] = q < p.Lq ? lse_log2(__ldg(p.lse + at)) : INFINITY;
        rows[BWD_BM + r] = q < p.Lq ? __ldg(p.delta + at) : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full0 + 8 * s, 2 * TILE_BYTES);
        tma_load(sq0 + s * TILE_BYTES, &p.tm_q, full0 + 8 * s, q0, h, b);
        tma_load(sdo0 + s * TILE_BYTES, &p.tm_do, full0 + 8 * s, q0, h, b);
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 16 keys a warp ----
  DkvCtx x;
  x.t = lane % 4;
  x.bh = bh;
  x.seed = DROPOUT ? static_cast<uint32_t>(p.seed_ptr[0]) : 0u;
  const int32_t* tm = MASK == kGitMask
                          ? p.text_mask + static_cast<long long>(b) * p.L
                          : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + warp_id * 16 + lane / 4 + 8 * i;
    x.key[i] = c;
    x.col_ok[i] = (MASK != kGitMask || c < p.num_img)
                      ? 1
                      : (c < p.Lk && __ldg(tm + c - p.num_img));
    x.bcol[i] = (MASK == kBias && c < p.Lk)
                    ? p.bias + b * p.b_sb + h * p.b_sh + c * p.b_sk
                    : nullptr;
  }
  // kGitMask: a CTA of image keys only is attended by every row
  const bool masked = MASK == kGitMask && k0 + BWD_BN > p.num_img;

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // a last tile of at most TAIL_BN queries is computed TAIL_BN wide
  const bool narrow_tail =
      p.Lq - (q_begin + (n_tiles - 1) * BWD_BM) <= TAIL_BN;

  mbar_wait(full_kv, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % BWD_STAGES;
    mbar_wait(full0 + 8 * st, (it / BWD_STAGES) & 1);
    const int q0 = q_begin + it * BWD_BM;
    const float* srow = srows + st * 2 * BWD_BM;
    const uint32_t sq = sq0 + st * TILE_BYTES;
    const uint32_t sdo = sdo0 + st * TILE_BYTES;
    if (narrow_tail && it == n_tiles - 1) {
      dkv_step<MASK, DROPOUT, TAIL_BN / 2>(dk_acc, dv_acc, p, x, masked, q0,
                                           srow, sk, sv, sq, sdo);
    } else {
      dkv_step<MASK, DROPOUT, 32>(dk_acc, dv_acc, p, x, masked, q0, srow,
                                  sk, sv, sq, sdo);
    }
    mbar_arrive(empty0 + 8 * st);
  }

  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, dk_acc, x.key, p.Lk,
             x.t, p.out_scale);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, dv_acc, x.key, p.Lk,
             x.t, 1.f);
}

// ---- the fused program (K2) -------------------------------------------------

// this warpgroup's dS^T (its 64 keys x 64 queries, the bf16 A-fragments of
// dK) into the 128-byte-swizzled tile at `dst`, a row a key: chunk j of
// row r lies at chunk j ^ (r % 8), as a TMA copy would have put it
__device__ __forceinline__ void store_ds_tile(uint32_t dst,
                                              const uint32_t (&dsa)[4][4],
                                              int wl, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wl * 16 + g + 8 * i;  // r % 8 == g
      st_shared_u32(dst + r * ROW_BYTES + ((j ^ g) << 4) + 4 * t,
                    dsa[j / 2][2 * (j % 2) + i]);
    }
  }
}

// the f32 dQ fragment (query rows 16 wl + g + 8i, columns 8j + 2t) into
// two 64 x 32 f32 tiles at `dst`, 128-byte swizzled as encode_f32_map's
// boxes (32 floats a 128-byte row)
__device__ __forceinline__ void store_dq_tile(uint32_t dst,
                                              const float (&acc)[32],
                                              int wl, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int chunk = 2 * (j % 4) + t / 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wl * 16 + g + 8 * i;
      st_shared_f32x2(dst + (j / 4) * TILE_BYTES + r * ROW_BYTES +
                          ((chunk ^ g) << 4) + 8 * (t % 2),
                      acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// dQ (64 queries x Dh, f32) = dS . K over the CTA's 128 keys: A = the two
// dS^T tiles at `ds` read MN-major, B = the two K tiles at `sk` read
// MN-major; both regions run on contiguously, 2048 B a 16-key k-step
__device__ __forceinline__ void issue_dq_fused(float (&acc)[32], uint32_t ds,
                                               uint32_t sk) {
  const uint64_t da = mnmajor_desc(ds);
  const uint64_t db = mnmajor_desc(sk);
  wgmma_ss_n64_tt<false>(acc, da, db);
#pragma unroll
  for (int kk = 1; kk < FUSED_BN / 16; ++kk) {
    const uint64_t step = (kk * 16 * ROW_BYTES) >> 4;
    wgmma_ss_n64_tt<true>(acc, da + step, db + step);
  }
}

// one warpgroup's dQ tile of query rows [q0, q0 + 64) into the workspace:
// shared staging tile `sdq` (free once this warpgroup's last reduction has
// read it), then two TMA reductions issued by the warpgroup's first thread
__device__ __forceinline__ void reduce_dq(const BwdParams& p, uint32_t sdq,
                                          const float (&acc)[32], int q0,
                                          int h, int b, int wg, int wl,
                                          int lane) {
  const bool leader = wl == 0 && lane == 0;
  if (leader) bulk_wait_read<0>();
  named_sync(2 + wg, 128);
  store_dq_tile(sdq, acc, wl, lane);
  fence_proxy_async();
  named_sync(2 + wg, 128);
  if (leader) {
    tma_reduce_add(&p.tm_dq, sdq, 0, q0, h, b);
    tma_reduce_add(&p.tm_dq, sdq + TILE_BYTES, DH / 2, q0, h, b);
    bulk_commit();
  }
}

// the loads of query tile `it` into its stage, by the 32 lanes of warp 0:
// lane 0 copies Q and dO by TMA, every lane two LSE and two D rows by
// cp.async (zeros past Lq, which add nothing: Q and dO are zero there)
__device__ __forceinline__ void fused_load_tile(const BwdParams& p, int it,
                                                int q_begin, int bh, int b,
                                                int h, int lane,
                                                uint32_t base) {
  const int st = it % BWD_STAGES;
  const int q0 = q_begin + it * BWD_BM;
  const uint32_t full = base + FUSED_BAR_OFF + 8 + 8 * st;
  const uint32_t rows = base + FUSED_ROWS_OFF + st * 2 * BWD_BM * 4;
#pragma unroll
  for (int r = lane; r < BWD_BM; r += 32) {
    const int q = q0 + r;
    const bool in = q < p.Lq;
    const long long at = static_cast<long long>(bh) * p.Lq + (in ? q : 0);
    cp_async_4(rows + 4 * r, p.lse + at, in);
    cp_async_4(rows + 4 * (BWD_BM + r), p.delta + at, in);
  }
  cp_async_arrive_noinc(full);
  if (lane == 0) {
    const uint32_t sq = base + (4 + st) * TILE_BYTES;
    mbar_expect_tx(full, 2 * TILE_BYTES);
    tma_load(sq, &p.tm_q, full, q0, h, b);
    tma_load(sq + BWD_STAGES * TILE_BYTES, &p.tm_do, full, q0, h, b);
  }
}

// PRODUCTS false compiles the products and the elementwise work out and
// reduces a zero tile in their place: the ring, the staging and the dQ
// reductions alone, to measure what the reduction costs
template <int MASK, bool DROPOUT, bool PRODUCTS>
__global__ void __maxnreg__(FUSED_MAX_REGS)
flash_bwd_fused_sm90_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base;  // 128 rows: one tile a key half
  const uint32_t sv = base + 2 * TILE_BYTES;
  const uint32_t sq0 = base + 4 * TILE_BYTES;
  const uint32_t sdo0 = sq0 + BWD_STAGES * TILE_BYTES;
  const uint32_t sds0 = base + FUSED_DS_OFF;  // [query tile parity][half]
  const uint32_t sdq0 = base + FUSED_DQ_OFF;  // [warpgroup][column half]
  // each stage's natural LSE and D rows, through a generic pointer
  const float* const srows = reinterpret_cast<const float*>(
      smem_raw + (base - smem_u32(smem_raw)) + FUSED_ROWS_OFF);
  const uint32_t full_kv = base + FUSED_BAR_OFF;
  const uint32_t full0 = full_kv + 8;

  const int k0 = blockIdx.x * FUSED_BN;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q_begin = bwd_q_begin<MASK>(p, k0);
  const int n_tiles = (p.Lq - q_begin + BWD_BM - 1) / BWD_BM;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    // warp 0's 32 cp.async arrivals and lane 0's expect_tx
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(full0 + 8 * s, 33);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // broadcast from lane 0, so the compiler knows it is warp-uniform
  const int warp_id = __shfl_sync(0xffffffffu,
                                  static_cast<int>(threadIdx.x / 32), 0);
  const int lane = threadIdx.x % 32;
  if (warp_id == 0) {
    // K and V once, and the ring's first tiles; a tile's stage is loaded
    // again once both warpgroups are past the barrier that ends its step
    if (lane == 0) {
      mbar_expect_tx(full_kv, 4 * TILE_BYTES);
      tma_load(sk, &p.tm_k, full_kv, k0, h, b);
      tma_load(sk + TILE_BYTES, &p.tm_k, full_kv, k0 + TILE_ROWS, h, b);
      tma_load(sv, &p.tm_v, full_kv, k0, h, b);
      tma_load(sv + TILE_BYTES, &p.tm_v, full_kv, k0 + TILE_ROWS, h, b);
    }
    for (int it = 0; it < min(n_tiles, BWD_STAGES); ++it) {
      fused_load_tile(p, it, q_begin, bh, b, h, lane, base);
    }
  }

  // ---- two consumer warpgroups: warpgroup wg owns keys
  // [k0 + 64 wg, k0 + 64 wg + 64), 16 a warp ----
  const int wg = warp_id / 4;
  const int wl = warp_id % 4;
  DkvCtx x;
  x.t = lane % 4;
  x.bh = bh;
  x.seed = DROPOUT ? static_cast<uint32_t>(p.seed_ptr[0]) : 0u;
  const int32_t* tm = MASK == kGitMask
                          ? p.text_mask + static_cast<long long>(b) * p.L
                          : nullptr;
  const int kh = k0 + wg * TILE_ROWS;  // this warpgroup's first key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kh + wl * 16 + lane / 4 + 8 * i;
    x.key[i] = c;
    x.col_ok[i] = (MASK != kGitMask || c < p.num_img)
                      ? 1
                      : (c < p.Lk && __ldg(tm + c - p.num_img));
    x.bcol[i] = (MASK == kBias && c < p.Lk)
                    ? p.bias + b * p.b_sb + h * p.b_sh + c * p.b_sk
                    : nullptr;
  }
  const bool masked = MASK == kGitMask && kh + TILE_ROWS > p.num_img;
  const uint32_t sk_w = sk + wg * TILE_BYTES;
  const uint32_t sv_w = sv + wg * TILE_BYTES;
  const uint32_t sdq = sdq0 + wg * 2 * TILE_BYTES;

  float dk_acc[32], dv_acc[32], dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = dq_acc[i] = 0.f;

  // the dQ product of query tile it - 1 (both halves of its dS^T stored
  // before the barrier that ended step it - 1) runs after step it's dV and
  // dK products, in turn by warpgroup (it - 1) % 2, under the other
  // warpgroup's work.  Every wgmma completes inside its step and dS^T is
  // stored before the products that read its registers: ptxas serializes
  // the wgmma and spills otherwise, and crashes from a cap of 200
  // registers
  mbar_wait(full_kv, 0);
  for (int it = 0; it <= n_tiles; ++it) {
    const int st = it % BWD_STAGES;
    const int q0 = q_begin + it * BWD_BM;
    const bool dq_turn = it > 0 && wg == (it - 1) % 2;
    const uint32_t sds_prev = sds0 + ((it + 1) % 2) * 2 * TILE_BYTES;
    if (it == n_tiles) {  // the last tile's dQ
      if (dq_turn) {
        if (PRODUCTS) {
          wg_fence();
          issue_dq_fused(dq_acc, sds_prev, sk);
          wg_commit();
          wg_wait<0>();
          pin(dq_acc);
        }
        reduce_dq(p, sdq, dq_acc, q0 - BWD_BM, h, b, wg, wl, lane);
      }
      break;
    }
    mbar_wait(full0 + 8 * st, (it / BWD_STAGES) & 1);
    if constexpr (PRODUCTS) {
      const float* srow = srows + st * 2 * BWD_BM;
      const uint32_t sq = sq0 + st * TILE_BYTES;
      const uint32_t sdo = sdo0 + st * TILE_BYTES;
      float s[32], dp[32];
      pin(dk_acc);
      pin(dv_acc);
      wg_fence();
      issue_ss(s, sk_w, sq);  // S^T = K Q^T
      wg_commit();
      issue_ss(dp, sv_w, sdo);  // dP^T = V dO^T
      wg_commit();
      wg_wait<1>();
      pin(s);
      const uint32_t keep =
          dkv_probs<MASK, DROPOUT, 32, true>(s, p, x, masked, q0, srow);
      wg_wait<0>();
      pin(dp);
      dkv_grads<DROPOUT>(s, dp, p, x, keep, srow + BWD_BM);
      uint32_t pa[4][4], dsa[4][4];
      pack_a(pa, s);
      pack_a(dsa, dp);
      store_ds_tile(sds0 + (it % 2) * 2 * TILE_BYTES + wg * TILE_BYTES, dsa,
                    wl, lane);
      fence_proxy_async();
      wg_fence();
      issue_rs(dv_acc, pa, sdo);  // dV += (P^T keep) dO
      issue_rs(dk_acc, dsa, sq);  // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      pin(dk_acc);
      pin(dv_acc);
      if (dq_turn) {
        wg_fence();
        issue_dq_fused(dq_acc, sds_prev, sk);
        wg_commit();
        wg_wait<0>();
        pin(dq_acc);
      }
    }
    if (dq_turn) reduce_dq(p, sdq, dq_acc, q0 - BWD_BM, h, b, wg, wl, lane);
    // both halves of this tile's dS^T are stored, and neither warpgroup
    // reads its stage again
    named_sync(1, FUSED_THREADS);
    if (warp_id == 0 && it + BWD_STAGES < n_tiles) {
      fused_load_tile(p, it + BWD_STAGES, q_begin, bh, b, h, lane, base);
    }
  }

  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, dk_acc, x.key, p.Lk,
             x.t, p.out_scale);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, dv_acc, x.key, p.Lk,
             x.t, 1.f);
  // shared memory stays until the reductions are done with it
  if (wl == 0 && lane == 0) bulk_wait<0>();
}

// ---- host side ------------------------------------------------------------

// Encodes the q/k/v/dO maps into `p` (element strides `st`: (sb, sh, ss)
// of q, k, v, dO in turn); 0 or an ERR_TMA_* code
int encode_bwd_maps(BwdParams& p, const void* q, const void* k,
                    const void* v, const void* dout, int B,
                    const long long (&st)[12]) {
  int err = encode_qkv_map(&p.tm_q, q, p.Lq, p.H, B, st[0], st[1], st[2],
                           TILE_ROWS);
  if (!err) {
    err = encode_qkv_map(&p.tm_k, k, p.Lk, p.H, B, st[3], st[4], st[5],
                         TILE_ROWS);
  }
  if (!err) {
    err = encode_qkv_map(&p.tm_v, v, p.Lk, p.H, B, st[6], st[7], st[8],
                         TILE_ROWS);
  }
  if (!err) {
    err = encode_qkv_map(&p.tm_do, dout, p.Lq, p.H, B, st[9], st[10],
                         st[11], TILE_ROWS);
  }
  return err;
}

template <typename Kernel>
int launch_bwd_kernel(Kernel kernel, const BwdParams& p, dim3 grid,
                      int threads, int smem, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Encodes the maps and launches the dQ program (DKV false) or the dK/dV
// program on `stream`.  Returns 0, a cudaError_t, or an ERR_TMA_* code;
// nothing is launched on an error.
template <bool DKV, int MASK, bool DROPOUT>
int launch_flash_bwd(BwdParams& p, const void* q, const void* k,
                     const void* v, const void* dout, int B,
                     const long long (&st)[12], cudaStream_t stream) {
  const int err = encode_bwd_maps(p, q, k, v, dout, B, st);
  if (err) return err;
  const dim3 grid(((DKV ? p.Lk : p.Lq) + TILE_ROWS - 1) / TILE_ROWS,
                  B * p.H);
  if (DKV) {
    return launch_bwd_kernel(flash_bwd_dkv_sm90_kernel<MASK, DROPOUT>, p,
                             grid, BWD_THREADS, DKV_SMEM_BYTES, stream);
  }
  return launch_bwd_kernel(flash_bwd_dq_sm90_kernel<MASK, DROPOUT>, p, grid,
                           BWD_THREADS, DQ_SMEM_BYTES, stream);
}

// The fused program: as launch_flash_bwd, with the map of the f32 dQ
// workspace `dq` (element strides dq_st: sb, sh, ss), which must hold
// zeros (or a sum to add to)
template <int MASK, bool DROPOUT, bool PRODUCTS>
int launch_flash_bwd_fused(BwdParams& p, const void* q, const void* k,
                           const void* v, const void* dout, void* dq, int B,
                           const long long (&st)[12],
                           const long long (&dq_st)[3], cudaStream_t stream) {
  int err = encode_bwd_maps(p, q, k, v, dout, B, st);
  if (!err) {
    err = encode_f32_map(&p.tm_dq, dq, p.Lq, p.H, B, dq_st[0], dq_st[1],
                         dq_st[2], TILE_ROWS);
  }
  if (err) return err;
  const dim3 grid((p.Lk + FUSED_BN - 1) / FUSED_BN, B * p.H);
  return launch_bwd_kernel(
      flash_bwd_fused_sm90_kernel<MASK, DROPOUT, PRODUCTS>, p, grid,
      FUSED_THREADS, FUSED_SMEM_BYTES, stream);
}

// D = rowsum(dO * O) into `delta`, (B, H, Lq) f32, before the dQ program
int launch_rowsum_product(const void* o, const void* dout, void* delta,
                          int B, int H, int Lq, long long o_sb,
                          long long o_sh, long long o_ss, long long do_sb,
                          long long do_sh, long long do_ss,
                          cudaStream_t stream) {
  const dim3 grid((Lq + DELTA_ROWS - 1) / DELTA_ROWS, B * H);
  rowsum_product_kernel<<<grid, DELTA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta), H,
      Lq, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss);
  return static_cast<int>(cudaGetLastError());
}

// the GIT-mask parameters of K2 and K3 (Lq == Lk == S = num_img + L)
BwdParams git_params(const void* lse, const void* delta,
                     const void* text_mask, const void* seed, int H, int S,
                     int num_img, int L, float ds_scale, float out_scale,
                     float scale, unsigned int thresh, float inv_keep) {
  BwdParams p{};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.Lq = S;
  p.Lk = S;
  p.scale_log2 = scale * LOG2E;
  p.ds_scale = ds_scale;
  p.out_scale = out_scale;
  p.text_mask = static_cast<const int32_t*>(text_mask);
  p.num_img = num_img;
  p.L = L;
  p.seed_ptr = static_cast<const int32_t*>(seed);
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  return p;
}

}  // namespace
