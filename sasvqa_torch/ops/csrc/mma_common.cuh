// Pieces shared by every flash-attention kernel of the port (the GIT-mask
// kernels git_flash_{fwd,bwd}.cu and the additive-bias kernels
// flash_{fwd,bwd}.cu): the bf16 tensor-core product, fragment packing, the
// tile loader, the D = rowsum(dO * O) prologue and the error string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;         // head dim (the wrappers reject others)
constexpr int PITCH = DH + 8;  // smem row pitch in bf16: 144 B, conflict-free

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_u16(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

// D += A(16x16 bf16, row) * B(16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ROWS x DH bf16 tile from global (row stride `ss` elements) into smem;
// rows at or past S are zero-filled
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S,
                                          int tid) {
  constexpr int VEC = 8;  // 8 bf16 = 16 B per load
  for (int i = tid; i < ROWS * (DH / VEC); i += NTHREADS) {
    const int r = i / (DH / VEC);
    const int c = (i % (DH / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ss + c);
    }
    *reinterpret_cast<uint4*>(dst + r * PITCH + c) = val;
  }
}

// The A-fragments of a warp's 16 rows x DH from a smem tile (rows r0..r0+15),
// one per 16-wide slice of DH
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DH / 16][4],
                                             const __nv_bfloat16* tile, int r0,
                                             int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = ld_u32(&tile[(r0 + g) * PITCH + c]);
    a[kk][1] = ld_u32(&tile[(r0 + g + 8) * PITCH + c]);
    a[kk][2] = ld_u32(&tile[(r0 + g) * PITCH + c + 8]);
    a[kk][3] = ld_u32(&tile[(r0 + g + 8) * PITCH + c + 8]);
  }
}

constexpr int DELTA_THREADS = 128;
constexpr int DELTA_ROWS = DELTA_THREADS / 8;  // rows per block, 8 threads each

// D[b, h, r] = sum_d dO[r, d] * O[r, d] in f32, for the backward kernels;
// grid ((S + DELTA_ROWS - 1) / DELTA_ROWS, B * H)
__global__ void __launch_bounds__(DELTA_THREADS)
rowsum_product_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ delta, int H, int S,
                      long long o_sb, long long o_sh, long long o_ss,
                      long long do_sb, long long do_sh, long long do_ss) {
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

}  // namespace

// a launcher's nonzero return code: a cudaError_t, or the tensor-map
// codes of flash_fwd_sm90.cuh (10000 + CUresult, 20000)
extern "C" const char* kernel_error_string(int code) {
  if (code >= 20000) return "cuTensorMapEncodeTiled: no driver entry point";
  if (code >= 10000) {
    return "cuTensorMapEncodeTiled refused the tensor map (code - 10000 is "
           "the CUresult)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
