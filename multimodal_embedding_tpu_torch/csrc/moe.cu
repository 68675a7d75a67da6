// The MoE layer's two elementwise passes for Hopper (sm_90a), each read in T
// (bf16 or f32), computed in f32 and written in T:
// - SwiGLU between the grouped expert products: h [M, 2I], the gate half then
//   the up half of each row, to y [M, I] = silu(gate) * up;
// - the weighted combine: each token's k expert rows, read through the inverse
//   of the sort by expert (rows [n, k], the sorted row of each choice), summed
//   with their router weights, plus the shared experts' output where given:
//   out[t] = T(T(sum_j w[t, j] * y[rows[t, j]]) + shared[t]).
//
// They replace no Pallas kernel: the JAX package has no MoE layer. They replace
// the ATen chains of ops/moe.py, which eager PyTorch runs as separate passes
// over the whole tensor: for SwiGLU the cast of h to f32, SiLU on the strided
// gate half, the f32 product and the cast back (38 bytes an output element
// in bf16); for the combine the permutation back to token order
// (index_put), the cast to f32, the product with the broadcast weights, the
// sum over the k choices, the cast back and the add of the shared output
// (about 150 bytes an output element at k = 6). Each kernel reads its inputs
// once and writes its output once: SwiGLU 6 bytes an output element in bf16,
// the combine 2 (k + 2) at k choices with the addend.
//
// Numerics: every rounding point of the ATen chains is kept.
// - SwiGLU: ATen's silu formula and order, g / (1 + expf(-g)) in f32 with the
//   accurate expf and IEEE division (this file builds without
//   --use_fast_math), then the f32 product with up (__fmul_rn), then one
//   round-to-nearest-even to T: bit-equal to the chain.
// - The combine: each product w * y rounded in f32 (__fmul_rn), the k
//   products summed in f32 in choice order, the first product first, with no
//   FMA contraction (__fadd_rn); then the two roundings to T of the chain: the
//   routed sum, then its sum with the shared output. ATen's sum over the k
//   choices adds in another order, so the routed sum can differ from the
//   chain's by one step of T. No atomics: every run gives the same bits.
//
// Bound on an H100 SXM: bytes. Kimi-VL-A3B's routed SwiGLU at a page batch,
// [49440, 2816] in bf16, reads 278 MB and writes 139 MB, 0.124 ms at 3.35
// TB/s; its combine (n 8240, k 6, D 2048, with the addend) moves 270 MB,
// 0.081 ms. The f32 math (an expf and a division an element for SwiGLU, k
// products and sums for the combine) issues in less time. So both passes
// follow csrc/activation.cu's design, which reads 85-89% of its bytes bound:
// - 16-byte vectors, neighbouring threads on neighbouring addresses, every
//   load of a thread issued before its math;
// - 256-thread blocks, one tile a block, as many blocks as tiles;
// - SwiGLU: two output vectors a thread, four loads in flight (each vector's
//   gate and up); the combine: one output vector a thread, its k expert
//   vectors and the addend's in flight (k + 1 loads, each expert row a
//   contiguous D * sizeof(T) bytes), the token's k row indices and weights
//   loaded first, once a warp (one address for the whole warp).
// Widths are whole vectors (I and D multiples of 8 in bf16, 4 in f32), which
// the C entry points check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSwigluUnroll = 2;  // output vectors a thread
constexpr int kMaxChoices = 16;   // the largest k the combine takes: up to 8 in one build, up to 16 in another

// A 16-byte vector of T as f32 values and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  // x rounded to bf16 and widened back
  __device__ __forceinline__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
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

template <typename T>
__device__ __forceinline__ uint4 swiglu_vec(const uint4& gate, const uint4& up) {
  constexpr int V = Vec<T>::V;
  float g[V], u[V];
  Vec<T>::widen(gate, g);
  Vec<T>::widen(up, u);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float s = g[e] / (1.0f + expf(-g[e]));  // ATen's silu
    g[e] = __fmul_rn(s, u[e]);
  }
  return Vec<T>::narrow(g);
}

// y [rows, I] as nvec vectors of V, row_vecs = I / V of them a row; h [rows, 2I].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ h, T* __restrict__ y, unsigned nvec, unsigned row_vecs) {
  const uint4* __restrict__ hv = reinterpret_cast<const uint4*>(h);
  uint4* __restrict__ yv = reinterpret_cast<uint4*>(y);
  const unsigned base = blockIdx.x * (kThreads * kSwigluUnroll) + threadIdx.x;
  uint4 g[kSwigluUnroll], u[kSwigluUnroll];
#pragma unroll
  for (int k = 0; k < kSwigluUnroll; ++k) {  // every load first
    const unsigned i = base + k * kThreads;
    if (i < nvec) {
      const unsigned row = i / row_vecs;
      const long long src = 2LL * row * row_vecs + (i - row * row_vecs);  // the gate vector
      g[k] = __ldg(hv + src);
      u[k] = __ldg(hv + src + row_vecs);
    }
  }
#pragma unroll
  for (int k = 0; k < kSwigluUnroll; ++k) {
    const unsigned i = base + k * kThreads;
    if (i < nvec) yv[i] = swiglu_vec<T>(g[k], u[k]);
  }
}

// out [n, D] as nvec vectors of V, row_vecs = D / V of them a row; y [>= n k, D]
// the sorted expert rows; rows and w [n, k], k <= kMaxK; shared [n, D] where
// kAddend.
template <typename T, bool kAddend, int kMaxK>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ y, const long long* __restrict__ rows, const float* __restrict__ w,
                   const T* __restrict__ shared, T* __restrict__ out, unsigned nvec, unsigned row_vecs, int k) {
  constexpr int V = Vec<T>::V;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  const unsigned t = i / row_vecs;
  const unsigned col = i - t * row_vecs;
  const uint4* __restrict__ yv = reinterpret_cast<const uint4*>(y);
  long long r[kMaxK];
  float wt[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      r[j] = __ldg(rows + (long long)t * k + j);
      wt[j] = __ldg(w + (long long)t * k + j);
    }
  }
  uint4 v[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) v[j] = __ldg(yv + r[j] * row_vecs + col);
  }
  uint4 s = make_uint4(0, 0, 0, 0);
  if (kAddend) s = __ldg(reinterpret_cast<const uint4*>(shared) + i);
  float acc[V], f[V];
  Vec<T>::widen(v[0], f);
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(wt[0], f[e]);
#pragma unroll
  for (int j = 1; j < kMaxK; ++j) {
    if (j < k) {
      Vec<T>::widen(v[j], f);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wt[j], f[e]));
    }
  }
  if (kAddend) {  // the routed sum rounded to T, then its sum with the shared output
    Vec<T>::widen(s, f);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(Vec<T>::round(acc[e]), f[e]);
  }
  reinterpret_cast<uint4*>(out)[i] = Vec<T>::narrow(acc);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int swiglu_launch(const void* h, void* y, long long rows, long long width, cudaStream_t s) {
  constexpr int V = Vec<T>::V;
  if (rows <= 0 || width <= 0 || width % V || !aligned(h) || !aligned(y)) return (int)cudaErrorInvalidValue;
  const long long nvec = rows * (width / V);
  if (nvec >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  constexpr long long tile = (long long)kThreads * kSwigluUnroll;
  const unsigned blocks = (unsigned)((nvec + tile - 1) / tile);
  swiglu_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(h), static_cast<T*>(y), (unsigned)nvec,
                                                (unsigned)(width / V));
  return (int)cudaGetLastError();
}

template <typename T, int kMaxK>
void combine_grid(const T* y, const long long* rows, const float* w, const T* shared, T* out, unsigned nvec,
                  unsigned row_vecs, int k, cudaStream_t s) {
  const unsigned blocks = (nvec + kThreads - 1) / kThreads;
  if (shared != nullptr)
    combine_kernel<T, true, kMaxK><<<blocks, kThreads, 0, s>>>(y, rows, w, shared, out, nvec, row_vecs, k);
  else
    combine_kernel<T, false, kMaxK><<<blocks, kThreads, 0, s>>>(y, rows, w, shared, out, nvec, row_vecs, k);
}

template <typename T>
int combine_launch(const void* y, const long long* rows, const float* w, const void* shared, void* out, long long n,
                   long long k, long long d, cudaStream_t s) {
  constexpr int V = Vec<T>::V;
  if (n <= 0 || k < 1 || k > kMaxChoices || d <= 0 || d % V || !aligned(y) || !aligned(out) ||
      (shared != nullptr && !aligned(shared)))
    return (int)cudaErrorInvalidValue;
  const long long nvec = n * (d / V);
  if (nvec >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const T* yt = static_cast<const T*>(y);
  const T* st = static_cast<const T*>(shared);
  T* ot = static_cast<T*>(out);
  // DeepSeek's k = 6 takes the build of at most 8 choices, Granite's k = 10 the one of 16: each keeps
  // only the registers its choices need
  if (k <= 8)
    combine_grid<T, 8>(yt, rows, w, st, ot, (unsigned)nvec, (unsigned)(d / V), (int)k, s);
  else
    combine_grid<T, kMaxChoices>(yt, rows, w, st, ot, (unsigned)nvec, (unsigned)(d / V), (int)k, s);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h [rows, 2 * width] and y [rows, width]
// contiguous and 16-byte aligned, width a whole number of 16-byte vectors.
// Returns a cudaError_t code.
extern "C" int moe_swiglu_fwd(int dtype, const void* h, void* y, long long rows, long long width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return swiglu_launch<float>(h, y, rows, width, s);
  if (dtype == 1) return swiglu_launch<__nv_bfloat16>(h, y, rows, width, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, of y, shared and out. y the sorted expert
// rows [>= n * k, d]; rows [n, k] int64, each a row of y; w [n, k] float32;
// shared [n, d] or null; out [n, d]. All contiguous; y, shared and out 16-byte
// aligned, d a whole number of 16-byte vectors, 1 <= k <= 16. Returns a
// cudaError_t code.
extern "C" int moe_combine_fwd(int dtype, const void* y, const void* rows, const void* w, const void* shared,
                               void* out, long long n, long long k, long long d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* r = static_cast<const long long*>(rows);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return combine_launch<float>(y, r, wf, shared, out, n, k, d, s);
  if (dtype == 1) return combine_launch<__nv_bfloat16>(y, r, wf, shared, out, n, k, d, s);
  return (int)cudaErrorInvalidValue;
}
