// Row LayerNorm for Hopper (sm_90a), the CUDA counterpart of the Pallas TPU
// kernel multimodal_embedding_tpu/ops/layernorm_pallas.py: fused_layer_norm
// (grid body _ln_kernel).
//
// For x [M, D], scale [D] and bias [D] of one dtype T (bf16 or f32), each row
// gets the semantics of _ln_kernel: the mean in f32, then the variance as
// mean((x - mu)^2) in f32 over the whole row, y = (x - mu) * rsqrt(var + eps)
// * scale + bias in f32, and one rounding to T.
//
// Design. The TPU kernel takes blocks of up to 1024 rows to fill VMEM. Here a
// row of up to 4 KB (D 2048 in bf16, 1024 in f32) goes to one warp, 8 rows per
// block: each lane holds its share of the row in registers (kVecs 16-byte
// vectors), so the row is read from device memory once and written once, and
// the two reductions are warp shuffles. A wider row goes to a block of 8 warps,
// which reads it three times (the later reads hit L2) and reduces through
// shared memory.
//
// Bound on an H100 SXM at the rows of ViT-L batch 64 (M 36928, D 1024, bf16):
// 75.6 MB read and 75.6 MB written, 45 us at 3.35 TB/s: bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
    ln_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ y,
              int M, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (long long)row * D;
  T* yr = y + (long long)row * D;
  float v[kVecs][V];
  float s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < D) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
      const T* xe = reinterpret_cast<const T*>(&xv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[i][e] = to_f(xe[e]);
        s1 += v[i][e];
      }
    }
  }
  const float inv_d = 1.0f / (float)D;
  const float mu = warp_sum(s1) * inv_d;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if ((i * 32 + lane) * V < D) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[i][e] -= mu;
        s2 += v[i][e] * v[i][e];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(s2) * inv_d + eps);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < D) {
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < V; ++e) oe[e] = from_f<T>(v[i][e] * rstd * to_f(scale[c + e]) + to_f(bias[c + e]));
      *reinterpret_cast<uint4*>(yr + c) = ov;
    }
  }
}

// Sum over the block's 8 warps; every thread gets the total.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();  // red is free (an earlier call's readers are done)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// One row per block, for rows wider than a warp's registers hold.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_row_block_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
                        T* __restrict__ y, int D, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kWarps];
  const T* xr = x + (long long)blockIdx.x * D;
  T* yr = y + (long long)blockIdx.x * D;
  const float inv_d = 1.0f / (float)D;
  float s1 = 0.0f;
  for (int c = threadIdx.x * V; c < D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const T* xe = reinterpret_cast<const T*>(&xv);
#pragma unroll
    for (int e = 0; e < V; ++e) s1 += to_f(xe[e]);
  }
  const float mu = block_sum(s1, red) * inv_d;
  float s2 = 0.0f;
  for (int c = threadIdx.x * V; c < D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const T* xe = reinterpret_cast<const T*>(&xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = to_f(xe[e]) - mu;
      s2 += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(s2, red) * inv_d + eps);
  for (int c = threadIdx.x * V; c < D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const T* xe = reinterpret_cast<const T*>(&xv);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < V; ++e) oe[e] = from_f<T>((to_f(xe[e]) - mu) * rstd * to_f(scale[c + e]) + to_f(bias[c + e]));
    *reinterpret_cast<uint4*>(yr + c) = ov;
  }
}

template <typename T, int kVecs>
int launch(const void* x, const void* scale, const void* bias, void* y, int M, int D, float eps,
           cudaStream_t stream) {
  const int blocks = (M + kWarps - 1) / kWarps;
  ln_kernel<T, kVecs><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                                       static_cast<const T*>(bias), static_cast<T*>(y), M, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* y, int M, int D, float eps,
             cudaStream_t s) {
  const int vecs = (D + 32 * (16 / (int)sizeof(T)) - 1) / (32 * (16 / (int)sizeof(T)));
  if (vecs <= 1) return launch<T, 1>(x, scale, bias, y, M, D, eps, s);
  if (vecs <= 2) return launch<T, 2>(x, scale, bias, y, M, D, eps, s);
  if (vecs <= 4) return launch<T, 4>(x, scale, bias, y, M, D, eps, s);
  if (vecs <= 8) return launch<T, 8>(x, scale, bias, y, M, D, eps, s);
  ln_row_block_kernel<T><<<M, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                                static_cast<const T*>(bias), static_cast<T*>(y), D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y [M, D] contiguous and 16-byte
// aligned, D a multiple of 8. Returns a cudaError_t code.
extern "C" int layernorm_fwd(int dtype, const void* x, const void* scale, const void* bias, void* y, int M,
                             int D, float eps, void* stream) {
  if (D % 8 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, scale, bias, y, M, D, eps, s);
  if (dtype == 0) return dispatch<float>(x, scale, bias, y, M, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
