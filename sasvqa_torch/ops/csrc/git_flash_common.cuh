// Pieces shared by the GIT-mask flash-attention kernels (git_flash_fwd.cu,
// git_flash_bwd.cu): the mask test, the in-kernel dropout hash, the
// bf16 tensor-core product and the tile loader.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;         // head dim (the wrappers reject others)
constexpr int PITCH = DH + 8;  // smem row pitch in bf16: 144 B, conflict-free
constexpr float MASK_BIAS = -1e9f;

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

// GIT mask: image columns are attended by every row; text rows also attend
// causal text columns whose text-mask value (`col_ok`) is set
__device__ __forceinline__ bool git_mask_ok(int r, int c, int num_img,
                                            int col_ok) {
  return c < num_img || (r >= num_img && c <= r && col_ok);
}

// Attention-probability dropout (K4, replaces sasvqa_tpu/ops/git_flash.py
// _hash_keep): keep the element iff the 31 low bits of a lowbias32-style
// finalizer of its absolute (b*H + h, row, col) coordinates plus the seed
// reach `thresh` = int(rate * 2^31).  uint32 multiplies wrap and unsigned
// shifts are logical, which is the JAX int32 arithmetic bit for bit, so the
// forward, the backward and the plain version draw the same mask.
__device__ __forceinline__ bool hash_keep(uint32_t bh, uint32_t row,
                                          uint32_t col, uint32_t seed,
                                          uint32_t thresh) {
  uint32_t h = seed + bh * 0x9E3779B9u + row * 0x85EBCA6Bu +
               col * 0xC2B2AE35u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return (h & 0x7FFFFFFFu) >= thresh;
}

}  // namespace

extern "C" const char* git_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
