// Pieces shared by the GIT-mask flash-attention kernels (git_flash_fwd.cu,
// git_flash_bwd.cu): the mask test and the in-kernel dropout hash, over the
// tensor-core helpers of mma_common.cuh.
#pragma once

#include "mma_common.cuh"

namespace {

constexpr float MASK_BIAS = -1e9f;

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
