// Row LayerNorm for Hopper (sm_90a), the CUDA counterpart of the Pallas TPU
// kernel multimodal_embedding_tpu/ops/layernorm_pallas.py: fused_layer_norm
// (grid body _ln_kernel).
//
// For x [M, D], scale [D] and bias [D] of one dtype T (bf16 or f32), each row
// gets the semantics of _ln_kernel: the mean in f32, then the variance as
// mean((x - mu)^2) in f32 over the whole row, y = (x - mu) * rsqrt(var + eps)
// * scale + bias in f32, and one rounding to T.
//
// Bound on an H100 SXM at the rows of ViT-L batch 64 (M 36928, D 1024, bf16):
// 75.6 MB read and 75.6 MB written, 45 us at 3.35 TB/s: bound by bytes, so the
// design is about keeping enough loads in flight and moving each byte once.
//
// Design. The TPU kernel takes blocks of up to 1024 rows to fill VMEM. Here a
// row of up to 8 16-byte vectors a lane (D 2048 in bf16, 1024 in f32) goes to
// one warp, 8 warps a block. The kernel is instantiated for the exact number
// of vectors a lane holds (kVecs: 3, 4, 5 and 8 at the towers' D 768, 1024,
// 1152 and 2048 in bf16), so no register slot is dead; other widths take the
// next instance up. All of a row's loads are issued before its first
// reduction, with scale and bias as 16-byte vectors held in registers for the
// row (a runtime flag takes element loads for a misaligned view); the row
// stays in registers in T and is widened to f32 where it is used, which
// costs ALU work this byte-bound kernel has to spare. A wider
// row goes to a block of 8 warps, which reads it three times (the later reads
// hit L2) and reduces through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecs = 8;  // 16-byte vectors a lane holds on the warp-per-row path

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

// The 16-byte vector of p at element c: one load when aligned, else V loads.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, int c, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint4*>(p + c);
  uint4 v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) e[i] = p[c + i];
  return v;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  return to_f(reinterpret_cast<const T*>(&v)[e]);
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
    ln_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ y,
              int M, int D, float eps, int sb_vec) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (long long)row * D;
  T* yr = y + (long long)row * D;
  // every load of the row, then scale and bias, in flight before the first reduction
  uint4 xv[kVecs], sv[kVecs], bv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < D) xv[i] = *reinterpret_cast<const uint4*>(xr + c);
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < D) {
      sv[i] = load_vec(scale, c, sb_vec);
      bv[i] = load_vec(bias, c, sb_vec);
    }
  }
  const float inv_d = 1.0f / (float)D;
  float s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if ((i * 32 + lane) * V < D)
#pragma unroll
      for (int e = 0; e < V; ++e) s1 += elem<T>(xv[i], e);
  const float mu = warp_sum(s1) * inv_d;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if ((i * 32 + lane) * V < D)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = elem<T>(xv[i], e) - mu;
        s2 += d * d;
      }
  const float rstd = rsqrtf(warp_sum(s2) * inv_d + eps);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < D) {
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < V; ++e)
        oe[e] = from_f<T>((elem<T>(xv[i], e) - mu) * rstd * elem<T>(sv[i], e) + elem<T>(bv[i], e));
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

// One row per block, for rows wider than kMaxVecs vectors a lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_row_block_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
                        T* __restrict__ y, int D, float eps, int sb_vec) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kWarps];
  const T* xr = x + (long long)blockIdx.x * D;
  T* yr = y + (long long)blockIdx.x * D;
  const float inv_d = 1.0f / (float)D;
  float s1 = 0.0f;
  for (int c = threadIdx.x * V; c < D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < V; ++e) s1 += elem<T>(xv, e);
  }
  const float mu = block_sum(s1, red) * inv_d;
  float s2 = 0.0f;
  for (int c = threadIdx.x * V; c < D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = elem<T>(xv, e) - mu;
      s2 += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(s2, red) * inv_d + eps);
  for (int c = threadIdx.x * V; c < D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 sv = load_vec(scale, c, sb_vec), bv = load_vec(bias, c, sb_vec);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < V; ++e) oe[e] = from_f<T>((elem<T>(xv, e) - mu) * rstd * elem<T>(sv, e) + elem<T>(bv, e));
    *reinterpret_cast<uint4*>(yr + c) = ov;
  }
}

template <typename T, int kVecs>
int launch(const void* x, const void* scale, const void* bias, void* y, int M, int D, float eps, int sb_vec,
           cudaStream_t stream) {
  ln_kernel<T, kVecs><<<(M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(bias), static_cast<T*>(y), M,
      D, eps, sb_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* y, int M, int D, float eps, int sb_vec,
             cudaStream_t s) {
  const int per_lane = 32 * (16 / (int)sizeof(T));
  switch ((D + per_lane - 1) / per_lane) {
    case 1: return launch<T, 1>(x, scale, bias, y, M, D, eps, sb_vec, s);
    case 2: return launch<T, 2>(x, scale, bias, y, M, D, eps, sb_vec, s);
    case 3: return launch<T, 3>(x, scale, bias, y, M, D, eps, sb_vec, s);
    case 4: return launch<T, 4>(x, scale, bias, y, M, D, eps, sb_vec, s);
    case 5: return launch<T, 5>(x, scale, bias, y, M, D, eps, sb_vec, s);
    case 6: return launch<T, 6>(x, scale, bias, y, M, D, eps, sb_vec, s);
    case 7:
    case kMaxVecs: return launch<T, kMaxVecs>(x, scale, bias, y, M, D, eps, sb_vec, s);
    default:
      ln_row_block_kernel<T><<<M, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                                    static_cast<const T*>(bias), static_cast<T*>(y), D, eps, sb_vec);
      return (int)cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x and y [M, D] contiguous and 16-byte
// aligned, D a multiple of 8; sb_vec: 1 when scale and bias are both 16-byte
// aligned, else 0 (element loads). Returns a cudaError_t code.
extern "C" int layernorm_fwd(int dtype, const void* x, const void* scale, const void* bias, void* y, int M,
                             int D, float eps, int sb_vec, void* stream) {
  if (D % 8 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, scale, bias, y, M, D, eps, sb_vec, s);
  if (dtype == 0) return dispatch<float>(x, scale, bias, y, M, D, eps, sb_vec, s);
  return (int)cudaErrorInvalidValue;
}
