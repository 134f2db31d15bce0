// Hopper (sm_90a) building blocks shared by the flash-attention forward
// mainloop (flash_fwd_sm90.cuh: K1, K5) and backward mainloop
// (flash_bwd_sm90.cuh: K2, K3, K6): the mask policies, mbarrier, TMA and
// bulk-reduction PTX wrappers, wgmma descriptors and products on
// 128-byte-swizzled 64-row tiles, and the host-side tensor-map encode.
//
// Tile layout.  Every tile is ROWS x Dh bf16 (Dh = 64: one 128-byte row),
// copied by TMA with the 128-byte swizzle into a 1024 B-aligned buffer.
// The same buffer serves wgmma as a K-major operand (Dh is the contracted
// axis: descriptor sw128_desc(addr, 16, 1024), +32 B = +2 a 16-element
// k-step) and as an MN-major operand (rows are the contracted axis:
// sw128_desc(addr, tile bytes, 1024), +2048 B a 16-row k-step).
#pragma once

#include "mma_common.cuh"

#include <cuda.h>
#include <math.h>

namespace {

enum MaskKind { kNoMask = 0, kBias = 1, kGitMask = 2 };

constexpr int ROW_BYTES = DH * 2;   // one bf16 row: 128 B
constexpr int TILE_ROWS = 64;       // rows of a TMA tile: one wgmma M
constexpr int TILE_BYTES = TILE_ROWS * ROW_BYTES;  // 8 KB
constexpr int TAIL_BN = 16;         // rows of a narrow last streamed tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// nonzero return codes of the launchers beyond cudaError_t (decoded by
// kernel_error_string in mma_common.cuh)
constexpr int ERR_TMA_ENCODE = 10000;      // + the CUresult
constexpr int ERR_TMA_ENTRY_POINT = 20000;

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

// a 4-byte copy from global to shared memory that zero-fills `dst`
// instead when !valid (then `src` is not read)
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed;
// the arrival is one of those the barrier expects
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// adds the f32 box at `src` (shared memory, the map's swizzle) into the
// global tensor at (col, row, h, b) by a TMA reduction in L2; rows past
// the tensor's extent are skipped.  Tracked by the issuing thread's bulk
// groups (bulk_commit / bulk_wait_read)
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               uint32_t src, int col, int row,
                                               int h, int b) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands, TMA stores and reductions)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a named barrier over `threads` threads (whole warps); id 0 is
// __syncthreads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float a,
                                                float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
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

// the tile at `addr` as a K-major operand (Dh contracted) and as an
// MN-major B operand (its rows contracted)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, TILE_BYTES, 1024);
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

// d(64 x 64, f32) (+)= A(64 x 16, smem MN-major) * B(16 x 64, smem
// MN-major): both operands stored with their contracted axis as rows.
// ACC false writes d (d = A.B) without reading it, so d holds nothing
// live before the product
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t da,
                                                uint64_t db) {
#define SASVQA_WGMMA_TT(C)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31},"                             \
      " %32, %33, p, 1, 1, 1, 1;\n}\n"                                       \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]),      \
        C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]),  \
        C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]),         \
        C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]),         \
        C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])          \
      : "l"(da), "l"(db), "r"(ACC ? 1 : 0))
#define SASVQA_RW(x) "+f"(x)
#define SASVQA_W(x) "=f"(x)
  if constexpr (ACC) {
    SASVQA_WGMMA_TT(SASVQA_RW);
  } else {
    SASVQA_WGMMA_TT(SASVQA_W);
  }
#undef SASVQA_W
#undef SASVQA_RW
#undef SASVQA_WGMMA_TT
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

// d(64 x Dh) (+)= A(64 x 16 KS, bf16 registers) B over KS 16-row steps of
// the tile at `addr` read MN-major: P.V in the forward, dS.K, P^T.dO and
// dS^T.Q in the backward
template <int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[32],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t addr) {
  const uint64_t db = mnmajor_desc(addr);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    // 16 rows = two 8-row groups: +2048 B
    wgmma_rs_n64(acc, a[kk], db + ((kk * 16 * ROW_BYTES) >> 4));
  }
}

// d (+)= A . B^T over Dh (four k-steps), both tiles K-major: S = Q.K^T in
// the forward, S, dP and their transposes in the backward; NS = 32 gives
// 64 columns, NS = 8 a narrow 16-column tile
template <int NS>
__device__ __forceinline__ void issue_ss(float (&d)[NS], uint32_t a_addr,
                                         uint32_t b_addr) {
  const uint64_t da = kmajor_desc(a_addr);
  const uint64_t db = kmajor_desc(b_addr);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    // 16 bf16 of a 128-byte swizzled row: +32 B, +2 in the descriptor
    if constexpr (NS == 32) {
      wgmma_ss_n64(d, da + 2 * kk, db + 2 * kk, kk);
    } else {
      wgmma_ss_n16(d, da + 2 * kk, db + 2 * kk, kk);
    }
  }
}

// f32 accumulator fragments to bf16 A-fragments: the C-fragments of two
// adjacent 8-column slices form one A-fragment of 16 (contracted) columns
template <int NS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NS / 8][4],
                                       const float (&s)[NS]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
    a[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
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

// a 4-D (Dh, rows, H, B) map with (box_rows, box_cols) boxes and 128-byte
// swizzle over a (B, H, rows, Dh) view with element strides (sb, sh, ss)
int encode_rows_map(CUtensorMap* map, CUtensorMapDataType type,
                    int elem_bytes, const void* ptr, int rows, int H, int B,
                    long long sb, long long sh, long long ss, int box_rows,
                    int box_cols) {
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
    strides[i] = static_cast<cuuint64_t>(ext[i] > 1 ? st[i] : DH) *
                 elem_bytes;
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TMA_ENCODE + static_cast<int>(res);
}

// a bf16 q/k/v/dO map: (box_rows, Dh) boxes of 128-byte rows
int encode_qkv_map(CUtensorMap* map, const void* ptr, int rows, int H, int B,
                   long long sb, long long sh, long long ss, int box_rows) {
  return encode_rows_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows,
                         H, B, sb, sh, ss, box_rows, DH);
}

// an f32 gradient map: (box_rows, Dh / 2) boxes, 128-byte rows again
int encode_f32_map(CUtensorMap* map, const void* ptr, int rows, int H, int B,
                   long long sb, long long sh, long long ss, int box_rows) {
  return encode_rows_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows,
                         H, B, sb, sh, ss, box_rows, DH / 2);
}

}  // namespace
