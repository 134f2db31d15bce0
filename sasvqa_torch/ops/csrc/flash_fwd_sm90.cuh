// The Hopper (sm_90a) flash-attention forward mainloop shared by K5
// (flash_fwd.cu: no mask, or an additive bias) and K1 (git_flash_fwd.cu:
// the GIT mask, with the K4 dropout hash at rate > 0).  bf16 q/k/v in,
// bf16 O and f32 LSE (natural log) out; each .cu file only fills
// FwdParams and picks the mask policy.
//
// Per (b, h) and query row r, over key columns c < Lk:
//   s[r, c] = (q_r . k_c) * scale + mask(r, c)          f32
//   online softmax, in base 2 (scale * log2(e) folded into one multiply);
//   l sums the f32 p; with dropout, p is then multiplied by the K4 keep
//   factor, so l and LSE stay those of the undropped softmax;
//   P cast to bf16 for P.V with f32 accumulation;
//   O = acc / l (l == 0 gives O = 0), LSE = (m + log2(l)) * ln(2).
// mask(r, c): keys >= Lk are -inf (TMA zero-fills them, and a zero key
// scores 0, not -inf); kBias adds bias[b, h, r, c] (f32, read through its
// broadcast strides); kGitMask adds -1e9 where git_mask_ok is false.
//
// Design.  A CTA is one consumer warpgroup (64 query rows) and one
// producer warp.  The producer's lane 0 loads the CTA's Q tile once and
// keeps 64-key K and V tiles in flight through a 4-stage ring in shared
// memory with the Tensor Memory Accelerator (4-D tensor maps over
// (Dh, L, H, B), byte strides from the view, so the split-head
// (B, S, H, Dh) order needs no copy; 128-byte swizzle, since a Dh = 64
// bf16 row is 128 B), guarded by full (transaction-count) and empty
// (consumer-arrival) mbarriers.  The consumers compute S = Q.K^T with
// wgmma m64n64k16 from shared memory on both sides, mask and exponentiate
// S in registers, and accumulate P.V with wgmma m64n64k16 with P in
// registers (the accumulator layout of S is the A-fragment layout of P)
// and V read transposed (MN-major) from its row-major tile.  The P.V of
// tile j is issued behind S of tile j + 1 and runs on under the softmax
// of tile j + 1.  Three CTAs share an SM (73 KB of shared memory and at
// most 136 registers a thread each), so one CTA's softmax and dropout hash
// run while another's products do.  Measured on an H100, this beat both
// 128-key tiles and two consumer warpgroups a CTA taking turns at the
// tensor cores through named barriers (PERF.md).  The 64-key tile also
// keeps the online softmax's rescale points every 64 keys, so P rounds to
// bf16 against the same running maxima as in the mma.sync kernels before
// it.  A key tile that needs no mask (kNoMask: wholly below Lk; kGitMask:
// wholly below num_img, the TPU kernel's unmasked image prefix) runs no
// mask code, kGitMask visits no tile past kv_end = max(num_img, last row
// of the CTA), and a last tile of at most 16 keys (577 = 9 * 64 + 1) is
// computed 16 keys wide (wgmma m64n16k16, one P.V step).
#pragma once

#include "git_flash_common.cuh"

#include <cuda.h>
#include <math.h>

namespace {

enum MaskKind { kNoMask = 0, kBias = 1, kGitMask = 2 };

constexpr int FWD_BM = 64;          // query rows a CTA: one warpgroup
constexpr int FWD_THREADS = 160;    // the consumer warpgroup + a producer warp
constexpr int FWD_BN = 64;          // keys a tile
constexpr int TAIL_BN = 16;         // keys of a narrow last tile
constexpr int FWD_STAGES = 4;       // K/V ring depth
constexpr int FWD_CTAS_PER_SM = 3;  // registers: at most 136 a thread
constexpr int S_REGS = FWD_BN / 2;  // f32 scores a thread holds
constexpr int ROW_BYTES = DH * 2;                  // one bf16 row: 128 B
constexpr int Q_TILE_BYTES = FWD_BM * ROW_BYTES;   // 8 KB
constexpr int KV_TILE_BYTES = FWD_BN * ROW_BYTES;  // 8 KB
constexpr int BAR_OFF = Q_TILE_BYTES + 2 * FWD_STAGES * KV_TILE_BYTES;
// full_q, full_k[STAGES], full_v[STAGES], empty[STAGES], and slack to
// align the base to the 1024 B of the swizzle pattern: 73 KB, three CTAs
// an SM
constexpr int FWD_SMEM_BYTES = BAR_OFF + 8 * (1 + 3 * FWD_STAGES) + 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// nonzero return codes of the launchers beyond cudaError_t (decoded by
// kernel_error_string in mma_common.cuh)
constexpr int ERR_TMA_ENCODE = 10000;      // + the CUresult
constexpr int ERR_TMA_ENTRY_POINT = 20000;

struct FwdParams {
  CUtensorMap tm_q, tm_k, tm_v;
  __nv_bfloat16* o;
  float* lse;
  long long o_sb, o_sh, o_ss;
  int H, Lq, Lk;
  float scale_log2;
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

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// never ends (a copy that cannot arrive) traps, so a fault surfaces as a
// launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == (1u << 28)) __trap();
  } while (!done);
}

// one (Dh, rows, 1, 1) box at (0, row, h, b) into shared memory; rows
// past the tensor's extent arrive as zeros and still count their bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// 2^x in one MUFU op; denormal results flush to 0 (p < 2^-126 adds nothing
// to l or to the bf16 P)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile of 128-byte
// rows: `sbo` = 1024 B between 8-row groups; `lbo` is read only by an
// MN-major operand wider than one 64-element swizzle atom
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma registers
// across the fences and waits around them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d(64 x 64, f32) (+)= A(64 x 16, smem K-major) * B(16 x 64, smem K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 16, f32) (+)= A(64 x 16, smem K-major) * B(16 x 16, smem K-major)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 64, f32) += A(64 x 16, bf16 registers) * B(16 x 64, smem MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the kernel -----------------------------------------------------------

// keys [0, kv_end) hold every column any row of the CTA attends
template <int MASK>
__device__ __forceinline__ int fwd_kv_end(const FwdParams& p, int q0) {
  return MASK == kGitMask ? min(p.Lk, max(p.num_img, q0 + FWD_BM)) : p.Lk;
}

// what a consumer thread needs to mask and drop its scores: its two rows,
// its column pair within the quad, and the row pointers of the inputs
struct TileCtx {
  int row0, row1, t, bh;
  uint32_t seed;
  const int32_t* tm;            // kGitMask: this example's text mask
  const float* brow0;           // kBias: the bias rows (null past Lq)
  const float* brow1;
};

// One key tile's softmax step on this thread's NS scores (rows row0 and
// row1, columns k0 + 8j + 2t + {0, 1}): scale to base 2 and mask (a tile
// that needs no mask keeps S unscaled and folds the scale into the
// exponent's FFMA), update the running max m and sum l, and leave the f32
// P (times the keep factor with dropout) in s; corr rescales the
// accumulator.
template <int MASK, bool DROPOUT, int NS>
__device__ __forceinline__ void tile_softmax(float (&s)[NS], float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&corr)[2],
                                             const FwdParams& p,
                                             const TileCtx& x, int k0,
                                             int tile_keys) {
  const int row[2] = {x.row0, x.row1};
  const bool masked = MASK == kBias ||
                      (MASK == kNoMask ? k0 + tile_keys > p.Lk
                                       : k0 + tile_keys > p.num_img);
  const float sc = masked ? 1.f : p.scale_log2;
  float mx[2] = {-INFINITY, -INFINITY};
  if (masked) {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        const int c = k0 + j * 8 + 2 * x.t + cb;
        int col_ok = 1;
        if (MASK == kGitMask) {
          col_ok = c < p.num_img ? 1
                                 : (c < p.Lk && __ldg(x.tm + c - p.num_img));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = s[4 * j + 2 * i + cb] * p.scale_log2;
          if (c >= p.Lk) {
            v = -INFINITY;
          } else if (MASK == kBias) {
            const float* brow = i ? x.brow1 : x.brow0;
            if (brow) v += __ldg(brow + c * p.b_sk) * LOG2E;
          } else if (MASK == kGitMask) {
            if (!git_mask_ok(row[i], c, p.num_img, col_ok)) {
              v += MASK_BIAS * LOG2E;
            }
          }
          s[4 * j + 2 * i + cb] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
  }

  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i] * sc);
    // a row with every score -inf so far (an -inf bias) keeps p = 0 and
    // l = 0 instead of exp2(-inf - -inf) = NaN
    m_use[i] = (m_new == -INFINITY) ? 0.f : m_new;
    corr[i] = ex2(m_run[i] - m_use[i]);
    m_run[i] = m_new;
    l_run[i] *= corr[i];
  }
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const int i = (e >> 1) & 1;
    const float pv = ex2(fmaf(s[e], sc, -m_use[i]));
    l_run[i] += pv;
    if (DROPOUT) {
      // dropout multiplies P after l is updated, as _fwd_kernel does
      const int c = k0 + (e >> 2) * 8 + 2 * x.t + (e & 1);
      s[e] = hash_keep(x.bh, row[i], c, x.seed, p.thresh) ? pv * p.inv_keep
                                                          : 0.f;
    } else {
      s[e] = pv;
    }
  }
}

// acc *= corr per row; then P to bf16 A-fragments (the C-fragments of two
// adjacent 8-key slices form one A-fragment of 16 keys)
template <int NS>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[32],
                                                 uint32_t (&pa)[NS / 8][4],
                                                 const float (&s)[NS],
                                                 const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[4 * j + 0] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
    pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// acc += P V over KS 16-key steps of the V tile at shared address `sv`
template <int KS>
__device__ __forceinline__ void issue_pv(float (&acc)[32],
                                         const uint32_t (&pa)[KS][4],
                                         uint32_t sv) {
  const uint64_t dv = sw128_desc(sv, KV_TILE_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    // 16 keys = two 8-row groups: +2048 B
    wgmma_rs_n64(acc, pa[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));
  }
}

template <int MASK, bool DROPOUT>
__global__ void __launch_bounds__(FWD_THREADS, FWD_CTAS_PER_SM)
flash_fwd_sm90_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk0 = base + Q_TILE_BYTES;
  const uint32_t sv0 = sk0 + FWD_STAGES * KV_TILE_BYTES;
  const uint32_t full_q = base + BAR_OFF;
  const uint32_t full_k0 = full_q + 8;
  const uint32_t full_v0 = full_k0 + 8 * FWD_STAGES;
  const uint32_t empty0 = full_v0 + 8 * FWD_STAGES;

  const int q0 = blockIdx.x * FWD_BM;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int n_tiles = (fwd_kv_end<MASK>(p, q0) + FWD_BN - 1) / FWD_BN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(full_k0 + 8 * s, 1);
      mbar_init(full_v0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // broadcast from lane 0, so the compiler knows it is warp-uniform (a
  // wgmma on a path it thinks divergent is serialized)
  const int warp_id = __shfl_sync(0xffffffffu,
                                  static_cast<int>(threadIdx.x / 32), 0);
  if (warp_id == 4) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(full_q, Q_TILE_BYTES);
      tma_load(sq, &p.tm_q, full_q, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % FWD_STAGES;
        const uint32_t phase = (it / FWD_STAGES) & 1;
        mbar_wait(empty0 + 8 * s, phase ^ 1);  // the first round is free
        mbar_expect_tx(full_k0 + 8 * s, KV_TILE_BYTES);
        tma_load(sk0 + s * KV_TILE_BYTES, &p.tm_k, full_k0 + 8 * s,
                 it * FWD_BN, h, b);
        mbar_expect_tx(full_v0 + 8 * s, KV_TILE_BYTES);
        tma_load(sv0 + s * KV_TILE_BYTES, &p.tm_v, full_v0 + 8 * s,
                 it * FWD_BN, h, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 16 query rows a warp ----
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the warp's 8-row half
  const int t = lane % 4;  // column pair within the quad
  const int row[2] = {q0 + warp_id * 16 + g, q0 + warp_id * 16 + g + 8};
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(p.seed_ptr[0]) : 0u;
  const int32_t* tm =
      MASK == kGitMask ? p.text_mask + static_cast<long long>(b) * p.L
                       : nullptr;
  const float* brow[2] = {nullptr, nullptr};
  if (MASK == kBias) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] < p.Lq) {
        brow[i] = p.bias + b * p.b_sb + h * p.b_sh + row[i] * p.b_sq;
      }
    }
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // base-2 running max
  float l_run[2] = {0.f, 0.f};              // this thread's partial sums
  float s[S_REGS];
  uint32_t pa[FWD_BN / 16][4];  // bf16 P of the previous tile, A-fragments
  const TileCtx ctx{row[0], row[1], t, bh, seed, tm, brow[0], brow[1]};

  // a last tile of at most TAIL_BN keys (577 = 9 x 64 + 1) is computed
  // TAIL_BN wide
  const int kv_end = fwd_kv_end<MASK>(p, q0);
  const bool narrow_tail = kv_end - (n_tiles - 1) * FWD_BN <= TAIL_BN;
  const int n_full = n_tiles - (narrow_tail ? 1 : 0);

  const uint64_t dq = sw128_desc(sq, 16, 1024);
  mbar_wait(full_q, 0);

  for (int it = 0; it < n_full; ++it) {
    const int st = it % FWD_STAGES;
    const uint32_t phase = (it / FWD_STAGES) & 1;
    const int sp = (it + FWD_STAGES - 1) % FWD_STAGES;  // previous tile's
    const uint32_t phase_p = ((it - 1) / FWD_STAGES) & 1;
    const int k0 = it * FWD_BN;

    mbar_wait(full_k0 + 8 * st, phase);
    const uint64_t dk = sw128_desc(sk0 + st * KV_TILE_BYTES, 16, 1024);
    pin(s);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // 16 bf16 of a 128-byte swizzled row: +32 B, +2 in the descriptor
      wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk);
    }
    wg_commit();
    if (it > 0) {
      mbar_wait(full_v0 + 8 * sp, phase_p);
      issue_pv(acc, pa, sv0 + sp * KV_TILE_BYTES);
    }
    wg_commit();  // an empty group on the first tile
    // S is ready; the previous tile's P.V runs on under the softmax below,
    // which touches neither acc nor pa until the second wait
    wg_wait<1>();
    pin(s);
    float corr[2];
    tile_softmax<MASK, DROPOUT>(s, m_run, l_run, corr, p, ctx, k0,
                                /*tile_keys=*/FWD_BN);
    wg_wait<0>();
    pin(acc);
    if (it > 0) mbar_arrive(empty0 + 8 * sp);
    rescale_and_pack(acc, pa, s, corr);
  }

  if (narrow_tail) {
    // the same steps on a TAIL_BN-key tile: S is m64n16, one P.V k-step
    const int it = n_full;
    const int st = it % FWD_STAGES;
    const int sp = (it + FWD_STAGES - 1) % FWD_STAGES;
    float s_t[TAIL_BN / 2];
    uint32_t pa_t[1][4];
    mbar_wait(full_k0 + 8 * st, (it / FWD_STAGES) & 1);
    const uint64_t dk = sw128_desc(sk0 + st * KV_TILE_BYTES, 16, 1024);
    pin(s_t);
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n16(s_t, dq + 2 * kk, dk + 2 * kk, kk);
    }
    wg_commit();
    if (it > 0) {
      mbar_wait(full_v0 + 8 * sp, ((it - 1) / FWD_STAGES) & 1);
      issue_pv(acc, pa, sv0 + sp * KV_TILE_BYTES);
    }
    wg_commit();
    wg_wait<1>();
    pin(s_t);
    float corr[2];
    tile_softmax<MASK, DROPOUT>(s_t, m_run, l_run, corr, p, ctx,
                                it * FWD_BN, /*tile_keys=*/TAIL_BN);
    wg_wait<0>();
    pin(acc);
    if (it > 0) mbar_arrive(empty0 + 8 * sp);
    rescale_and_pack(acc, pa_t, s_t, corr);
    mbar_wait(full_v0 + 8 * st, (it / FWD_STAGES) & 1);
    pin(acc);
    wg_fence();
    issue_pv(acc, pa_t, sv0 + st * KV_TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(acc);
  } else if (n_tiles > 0) {  // the last tile's P.V
    const int sp = (n_tiles - 1) % FWD_STAGES;
    mbar_wait(full_v0 + 8 * sp, ((n_tiles - 1) / FWD_STAGES) & 1);
    pin(acc);
    wg_fence();
    issue_pv(acc, pa, sv0 + sp * KV_TILE_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(acc);
  }

  // full row sums across the quad, then O = acc / l and the natural LSE
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[i] >= p.Lq) continue;
    const float safe_l = (l == 0.f) ? 1.f : l;
    __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh +
                          static_cast<long long>(row[i]) * p.o_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = pack_bf16x2(
          acc[4 * j + 2 * i] / safe_l, acc[4 * j + 2 * i + 1] / safe_l);
    }
    if (t == 0) {
      p.lse[static_cast<long long>(bh) * p.Lq + row[i]] =
          (m_run[i] + log2f(safe_l)) * LN2;
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
int encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) {
      return ERR_TMA_ENTRY_POINT;
    }
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  *out = fn;
  return 0;
}

// a 4-D (Dh, rows, H, B) bf16 map with (box_rows, Dh) boxes and 128-byte
// swizzle over a (B, H, rows, Dh) view with element strides (sb, sh, ss)
int encode_qkv_map(CUtensorMap* map, const void* ptr, int rows, int H, int B,
                   long long sb, long long sh, long long ss, int box_rows) {
  EncodeTiledFn encode;
  const int err = encode_tiled_fn(&encode);
  if (err) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long st[3] = {ss, sh, sb};
  const int ext[3] = {rows, H, B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // the stride of an axis of extent 1 is never used: any legal value
    strides[i] = static_cast<cuuint64_t>(ext[i] > 1 ? st[i] : DH) * 2;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(DH),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TMA_ENCODE + static_cast<int>(res);
}

// Encodes the q/k/v maps into `p` (strides in elements, (sb, sh, ss) for
// each) and launches on `stream`.  Returns 0, a cudaError_t, or an
// ERR_TMA_* code; nothing is launched on an error.
template <int MASK, bool DROPOUT>
int launch_flash_fwd(FwdParams& p, const void* q, const void* k,
                     const void* v, int B, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh,
                     long long k_ss, long long v_sb, long long v_sh,
                     long long v_ss, cudaStream_t stream) {
  int err = encode_qkv_map(&p.tm_q, q, p.Lq, p.H, B, q_sb, q_sh, q_ss,
                           FWD_BM);
  if (!err) {
    err = encode_qkv_map(&p.tm_k, k, p.Lk, p.H, B, k_sb, k_sh, k_ss, FWD_BN);
  }
  if (!err) {
    err = encode_qkv_map(&p.tm_v, v, p.Lk, p.H, B, v_sb, v_sh, v_ss, FWD_BN);
  }
  if (err) return err;
  auto kernel = flash_fwd_sm90_kernel<MASK, DROPOUT>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.Lq + FWD_BM - 1) / FWD_BM, B * p.H);
  kernel<<<grid, FWD_THREADS, FWD_SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
