// Pieces shared by every flash-attention kernel of the port: bf16
// packing, the D = rowsum(dO * O) prologue of the backward kernels and the
// launchers' error string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;  // head dim (the wrappers reject others)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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
// codes of sm90_common.cuh (10000 + CUresult, 20000)
extern "C" const char* kernel_error_string(int code) {
  if (code >= 20000) return "cuTensorMapEncodeTiled: no driver entry point";
  if (code >= 10000) {
    return "cuTensorMapEncodeTiled refused the tensor map (code - 10000 is "
           "the CUresult)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
