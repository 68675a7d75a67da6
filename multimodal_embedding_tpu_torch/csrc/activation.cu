// The towers' MLP activation for Hopper (sm_90a): y = act(x) elementwise over
// a contiguous tensor, read in T (bf16, f16 or f32), computed in f32 and
// rounded once to T.
//
// It replaces no Pallas kernel. The JAX package computes the activation in one
// line, multimodal_embedding_tpu/models/layers.py:425,
// ACTIVATIONS[act](h.astype(f32)).astype(x.dtype), and XLA fuses that line
// into one elementwise pass. Eager PyTorch runs the same line as separate
// launches, each reading and writing the whole [tokens, mlp_dim] tensor: in
// bf16 five for quick_gelu (the cast up, 1.702 * x, the sigmoid, the product,
// the cast down: 40 bytes an element) and three for the erf and tanh GELUs
// (20 bytes). This kernel reads each element once and writes it once: 4 bytes
// an element in bf16.
//
// Numerics: ATen's formulas in ATen's order (its sigmoid and multiply kernels
// for quick_gelu, GeluCUDAKernelImpl for the two GELUs), with the accurate
// expf, erff and tanhf and IEEE division (no __expf or __fdividef, and this
// file builds without --use_fast_math), so each element gets the value of the
// unfused ops. The only rounding to T is the last one; in f32 the unfused ops
// also rounded 1.702 * x and the sigmoid to f32 between launches, as this
// kernel does in registers.
//
// Bound on an H100 SXM: bytes. CLIP-L's vision MLP, [18464, 4096] in bf16, is
// 302 MB read and written, 90 us at 3.35 TB/s, against a few tens of f32
// instructions an element (expf and the division for quick_gelu, tanhf or
// erff for the GELUs), which the SMs issue in less time. So the design is
// about keeping loads in flight:
// - each thread loads 16-byte vectors, neighbouring threads on neighbouring
//   addresses, kUnroll vectors issued before any math;
// - a block takes one tile of kThreads * kUnroll vectors and the grid has as
//   many blocks as tiles, so the block scheduler refills each SM as blocks
//   retire. On an H100 this reaches a plain copy's rate (86-88% of the bound
//   at the vision towers' shapes). A persistent grid of one resident wave
//   walking the tiles read 72-80%, and 4 vectors a thread or a 32-register
//   cap for full occupancy no better than 2;
// - the last, partial tile goes one guarded vector at a time, and the ragged
//   tail (fewer than one vector's elements) one element a thread of the last
//   block.
// bf16 and f16 are widened and narrowed two at a time (one instruction a pair).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // 16-byte vectors in flight a thread

// glibc's M_SQRT2, M_2_SQRTPI and M_SQRT1_2, which ATen's kernels read
constexpr double kSqrt2 = 1.41421356237309504880;
constexpr double kTwoOverSqrtPi = 1.12837916709551257390;
constexpr double kSqrtHalf = 0.70710678118654752440;

// act codes of the C entry point: those of fused_ln_matmul.cu
struct Gelu {  // x * 0.5 * (1 + erf(x / sqrt(2)))
  __device__ __forceinline__ static float f(float x) {
    constexpr float kAlpha = kSqrtHalf;
    return x * 0.5f * (1.0f + erff(x * kAlpha));
  }
};

struct QuickGelu {  // x * sigmoid(1.702 * x): ATen's scalar multiply, sigmoid, then product
  __device__ __forceinline__ static float f(float x) {
    const float z = 1.702f * x;
    const float s = 1.0f / (1.0f + expf(-z));
    return x * s;
  }
};

struct GeluTanh {  // 0.5 * x * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x^3)))
  __device__ __forceinline__ static float f(float x) {
    constexpr float kBeta = kSqrt2 * kTwoOverSqrtPi * 0.5;
    constexpr float kKappa = 0.044715;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
};

// A 16-byte vector of T as f32 values and back.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static float to_f(float x) { return x; }
  __device__ __forceinline__ static float from_f(float x) { return x; }
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

template <>
struct Io<__half> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float to_f(__half x) { return __half2float(x); }
  __device__ __forceinline__ static __half from_f(float x) { return __float2half_rn(x); }
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    const __half2* p = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(p[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    uint4 v;
    __half2* p = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

template <typename T, typename Act>
__device__ __forceinline__ uint4 apply(const uint4& v) {
  float f[Io<T>::V];
  Io<T>::widen(v, f);
#pragma unroll
  for (int e = 0; e < Io<T>::V; ++e) f[e] = Act::f(f[e]);
  return Io<T>::narrow(f);
}

constexpr long long kTile = (long long)kThreads * kUnroll;  // vectors a block takes

template <typename T, typename Act>
__global__ void __launch_bounds__(kThreads)
    mlp_act_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int V = Io<T>::V;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
  const long long nvec = n / V;
  const long long base = blockIdx.x * kTile + threadIdx.x;  // this thread's first vector
  if (base + (kUnroll - 1) * kThreads < nvec) {  // all of this thread's vectors: loads first
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(xv + base + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) yv[base + u * kThreads] = apply<T, Act>(r[u]);
  } else {  // the partial last tile
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < nvec) yv[i] = apply<T, Act>(__ldg(xv + i));
    }
  }
  if (blockIdx.x == gridDim.x - 1) {  // the ragged tail: fewer than V elements
    const long long i = nvec * V + threadIdx.x;
    if (i < n) y[i] = Io<T>::from_f(Act::f(Io<T>::to_f(x[i])));
  }
}

template <typename T, typename Act>
int launch(const void* x, void* y, long long n, cudaStream_t s) {
  const long long tiles = (n / Io<T>::V + kTile - 1) / kTile;
  const long long blocks = tiles > 0 ? tiles : 1;  // one block for a tensor shorter than a vector
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mlp_act_kernel<T, Act><<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int act, const void* x, void* y, long long n, cudaStream_t s) {
  switch (act) {
    case 1: return launch<T, Gelu>(x, y, n, s);
    case 2: return launch<T, QuickGelu>(x, y, n, s);
    case 3: return launch<T, GeluTanh>(x, y, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; act: 1 = gelu, 2 =
// quick_gelu, 3 = gelu_pytorch_tanh. x and y hold n > 0 contiguous elements
// and are 16-byte aligned. Returns a cudaError_t code.
extern "C" int mlp_activation_fwd(int dtype, int act, const void* x, void* y, long long n, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(act, x, y, n, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(act, x, y, n, s);
  if (dtype == 2) return dispatch<__half>(act, x, y, n, s);
  return (int)cudaErrorInvalidValue;
}
