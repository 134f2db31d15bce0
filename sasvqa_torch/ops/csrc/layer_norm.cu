// LayerNorm over the last axis, forward and backward, for Hopper (sm_90a):
// bf16 or f32 rows in and out (one type for x, y, dy and dx), f32
// statistics and f32 parameter gradients.
//
// Replaces no TPU kernel: the JAX package writes LayerNorm as plain jnp
// (sasvqa_tpu/models/layers.py) and XLA fuses the formula into one pass.
// Without this kernel the port's plain formula (models/layers.LayerNorm)
// runs as 14 ATen kernels forward and 30 backward and saves three (N, D)
// f32 tensors.  Per row of x (N, D):
//   mean = E[x], var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps)
//   y    = (x - mean) * (rstd * w) + b            (f32, rounded once)
// and the backward, with g = dy * w and xhat = (x - mean) * rstd:
//   dx   = rstd * (g - mean(g) - xhat * mean(g * xhat))
// where the last term is dropped on a row whose variance the clamp set to
// 0 (autograd of the clamp passes no gradient there), and
//   dw   = sum over rows of dy * xhat,   db = sum over rows of dy.
//
// Bound: both passes are memory-bound (a few FLOP an element).  At the
// BLIP-large vision stream (18,464 x 1024, bf16) the forward moves x and y
// (75.6 MB), 22.6 us at 3.35 TB/s; the backward x, dy and dx (113 MB),
// 33.8 us.  So the design is about bytes: one warp a row, the row held in
// registers between the statistics and the output (no second read of x),
// 16-byte loads and stores, w and b staged once a block in shared memory
// (element-major, [i][chunk], so that a warp's reads of element i of its
// 32 chunks fall in 32 banks), and a persistent grid of the blocks that
// fit on the card at once, so that the backward's per-block dw/db partials
// stay (grid, D) f32 (about 264 x D) and are summed by a second, small
// pass over columns.  No
// atomics: every sum has a fixed order, so a replayed CUDA graph gives the
// same bits every time.
//
// Row r is taken by warp (r mod (grid * WARPS)) of the flattened grid;
// each warp adds its rows' dy * xhat and dy into registers in row order,
// the block adds its warps' sums in warp order into shared memory and
// writes them as its partial row; the column pass sums the partials of
// column j over row groups g = t, t + 32, ... (t < 32) in order, then the
// 32 group sums in order (ops/layer_norm.kernel_order_sums is that order
// in PyTorch).  xhat, the products and the sums are rounded op by op
// (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), so that order
// can be replayed bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows in flight a block, one warp a row
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;  // elements of a chunk: 16 bytes of bf16
constexpr int COL_GROUPS = 32;  // row groups of the column pass
// chunks a lane holds at most: rows up to 1024 wide, the widest LayerNorm
// of any model the port runs; a lane holds chunks lane, lane + 32, ... of
// its row
constexpr int CPL = 4;
constexpr int MAX_D = CPL * 32 * VEC;

// A chunk of 8 consecutive elements of a row as loaded (bf16: one 16-byte
// load; f32: two), unpacked to f32 on use.
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void unpack(float (&f)[VEC]) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    lo = make_float4(0.f, 0.f, 0.f, 0.f);
    hi = lo;
  }
  __device__ __forceinline__ void unpack(float (&f)[VEC]) const {
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  // round to nearest even, as a cast of the f32 value (NaN kept)
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float (&f)[VEC]) {
  uint4 v;
  v.x = pack_bf16x2(f[0], f[1]);
  v.y = pack_bf16x2(f[2], f[3]);
  v.z = pack_bf16x2(f[4], f[5]);
  v.w = pack_bf16x2(f[6], f[7]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store_chunk(float* p, const float (&f)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Shared memory holds (D) vectors as [i][chunk]: element i of chunk c at
// i * chunks + c.
__device__ __forceinline__ void stage(float* dst, const float* src, int D) {
  const int chunks = D / VEC;
  for (int t = threadIdx.x; t < D; t += THREADS) {
    dst[(t % VEC) * chunks + t / VEC] = src[t];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
    layer_norm_fwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int N, int D,
                          float eps) {
  extern __shared__ float smem[];
  float* sw = smem;
  float* sb = smem + D;
  stage(sw, w, D);
  stage(sb, b, D);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int chunks = D / VEC;
  const float inv_d = 1.f / static_cast<float>(D);
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < N;
       row += gridDim.x * WARPS) {
    const long long base = static_cast<long long>(row) * D;
    Chunk<T> v[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) v[k].load(x + base + c * VEC); else v[k].zero();
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      float f[VEC];
      v[k].unpack(f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s += f[i];
        ss += f[i] * f[i];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s * inv_d;
    const float raw_var = ss * inv_d - mean * mean;
    // a NaN stays NaN, as through torch.clamp
    const float rstd = rsqrtf((raw_var < 0.f ? 0.f : raw_var) + eps);
    if (mean_out != nullptr && lane == 0) {
      mean_out[row] = mean;
      // the sign marks a row whose variance the clamp raised to 0
      rstd_out[row] = raw_var < 0.f ? -rstd : rstd;
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        float f[VEC];
        v[k].unpack(f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int j = i * chunks + c;
          f[i] = __fadd_rn(__fmul_rn(__fsub_rn(f[i], mean),
                                     __fmul_rn(rstd, sw[j])),
                           sb[j]);
        }
        store_chunk(y + base + c * VEC, f);
      }
    }
  }
}

// dw_part/db_part: (gridDim.x, D) f32, or null when neither parameter
// needs its gradient.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    layer_norm_bwd_kernel(const T* __restrict__ x,
                          const T* __restrict__ dy,
                          const float* __restrict__ w,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          T* __restrict__ dx, float* __restrict__ dw_part,
                          float* __restrict__ db_part, int N, int D) {
  extern __shared__ float smem[];
  float* sw = smem;
  float* sdw = smem + D;
  float* sdb = smem + 2 * D;
  stage(sw, w, D);
  for (int i = threadIdx.x; i < D; i += THREADS) {
    sdw[i] = 0.f;
    sdb[i] = 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = D / VEC;
  const float inv_d = 1.f / static_cast<float>(D);
  const bool params = dw_part != nullptr;
  float acc_dw[CPL][VEC], acc_db[CPL][VEC];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc_dw[k][i] = 0.f;
      acc_db[k][i] = 0.f;
    }
  }
  for (int row = blockIdx.x * WARPS + warp; row < N;
       row += gridDim.x * WARPS) {
    const long long base = static_cast<long long>(row) * D;
    Chunk<T> xv[CPL], gv[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        xv[k].load(x + base + c * VEC);
        gv[k].load(dy + base + c * VEC);
      } else {
        xv[k].zero();
        gv[k].zero();
      }
    }
    const float m = __ldg(mean + row);
    const float r_signed = __ldg(rstd + row);
    const float r = fabsf(r_signed);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        float xf[VEC], df[VEC];
        xv[k].unpack(xf);
        gv[k].unpack(df);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xf[i], m), r);
          const float g = df[i] * sw[i * chunks + c];
          sg += g;
          sgx += g * xh;
          if (params) {
            acc_dw[k][i] = __fadd_rn(acc_dw[k][i], __fmul_rn(df[i], xh));
            acc_db[k][i] = __fadd_rn(acc_db[k][i], df[i]);
          }
        }
      }
    }
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    const float mg = sg * inv_d;
    const float mgx = r_signed > 0.f ? sgx * inv_d : 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < chunks) {
        float xf[VEC], df[VEC];
        xv[k].unpack(xf);
        gv[k].unpack(df);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xf[i], m), r);
          const float g = df[i] * sw[i * chunks + c];
          xf[i] = r * (g - mg - xh * mgx);
        }
        store_chunk(dx + base + c * VEC, xf);
      }
    }
  }
  if (!params) return;
  // the block's partial: its warps' sums added in warp order
  for (int wi = 0; wi < WARPS; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        if (c < chunks) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int j = i * chunks + c;
            sdw[j] = __fadd_rn(sdw[j], acc_dw[k][i]);
            sdb[j] = __fadd_rn(sdb[j], acc_db[k][i]);
          }
        }
      }
    }
    __syncthreads();
  }
  const long long out = static_cast<long long>(blockIdx.x) * D;
  for (int t = threadIdx.x; t < D; t += THREADS) {
    const int j = (t % VEC) * chunks + t / VEC;
    dw_part[out + t] = sdw[j];
    db_part[out + t] = sdb[j];
  }
}

// part: (2, G, D) f32 (the dw partials, then the db partials); out: (2, D).
// Block (32 columns, COL_GROUPS row groups), grid (ceil(D / 32), 2).
__global__ void __launch_bounds__(32 * COL_GROUPS)
    layer_norm_bwd_cols_kernel(const float* __restrict__ part,
                               float* __restrict__ out, int G, int D) {
  __shared__ float s[COL_GROUPS][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + static_cast<long long>(blockIdx.y) * G * D;
  float acc = 0.f;
  if (col < D) {
    for (int g = threadIdx.y; g < G; g += COL_GROUPS) {
      acc = __fadd_rn(acc, p[static_cast<long long>(g) * D + col]);
    }
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < COL_GROUPS; ++i) t = __fadd_rn(t, s[i][threadIdx.x]);
    out[static_cast<long long>(blockIdx.y) * D + col] = t;
  }
}

template <typename T>
const void* kernel_of(int pass) {
  return pass == 0
             ? reinterpret_cast<const void*>(layer_norm_fwd_kernel<T>)
             : reinterpret_cast<const void*>(layer_norm_bwd_kernel<T>);
}

// the kernel for (pass, type); pass 0 forward, 1 backward
const void* kernel_for(int pass, int f32) {
  return f32 ? kernel_of<float>(pass) : kernel_of<__nv_bfloat16>(pass);
}

size_t smem_bytes(int pass, int D) {
  return static_cast<size_t>(pass == 0 ? 2 : 3) * D * sizeof(float);
}

bool width_ok(int D) { return D > 0 && D % VEC == 0 && D <= MAX_D; }

}  // namespace

extern "C" {

// The blocks of (pass, type, D) that the current device holds at once
// (blocks an SM times SMs): the persistent grid.  A negative return is
// -(cudaError_t), or -1 for a width the kernels do not take.
int layer_norm_max_blocks(int pass, int f32, int D) {
  if (!width_ok(D)) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_for(pass, f32), THREADS,
        smem_bytes(pass, D));
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms > 0 ? per_sm * sms : 1;
}

// Forward on `stream` over `grid` blocks: x and y (N, D) contiguous,
// 16-byte aligned, f32 (f32 != 0) or bf16; w, b (D) f32; mean, rstd (N)
// f32, or both null (nothing is saved).  Returns 0 or a cudaError_t.
int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, int N, int D, float eps, int f32,
                   int grid, void* stream) {
  if (!width_ok(D) || grid < 1) return cudaErrorInvalidValue;
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&w),
                  const_cast<void**>(&b), &y, &mean, &rstd, &N, &D, &eps};
  cudaError_t err = cudaLaunchKernel(
      kernel_for(0, f32), dim3(grid), dim3(THREADS), args,
      smem_bytes(0, D), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Backward on `stream` over `grid` blocks: x, dy, dx (N, D) f32 (f32 != 0)
// or bf16, contiguous and 16-byte aligned; mean and the signed rstd (N) of
// the forward; w (D) f32.
// With part a (2, grid, D) f32 scratch and dwdb a (2, D) f32 output, the
// column pass then writes dw into dwdb[0] and db into dwdb[1]; with part
// null no parameter gradient is computed.  Returns 0 or a cudaError_t.
int layer_norm_bwd(const void* x, const void* dy, const void* w,
                   const void* mean, const void* rstd, void* dx, void* part,
                   void* dwdb, int N, int D, int f32, int grid,
                   void* stream) {
  if (!width_ok(D) || grid < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dw_part = static_cast<float*>(part);
  float* db_part =
      part == nullptr ? nullptr : dw_part + static_cast<long long>(grid) * D;
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&dy),
                  const_cast<void**>(&w), const_cast<void**>(&mean),
                  const_cast<void**>(&rstd), &dx, &dw_part, &db_part, &N,
                  &D};
  cudaError_t err = cudaLaunchKernel(kernel_for(1, f32),
                                     dim3(grid), dim3(THREADS), args,
                                     smem_bytes(1, D), st);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  layer_norm_bwd_cols_kernel<<<dim3((D + 31) / 32, 2), dim3(32, COL_GROUPS),
                               0, st>>>(static_cast<const float*>(part),
                                        static_cast<float*>(dwdb), grid, D);
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
