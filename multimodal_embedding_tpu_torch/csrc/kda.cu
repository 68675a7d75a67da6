// Kimi Delta Attention's recurrence (KDA, arXiv:2510.26692) for Hopper
// (sm_90a): for each sequence b and head h, with the head's state S [K, V] in
// f32 (K = V = 128),
//   S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T,
//   o_t = S_t^T (q_t / sqrt(K)),
// q_t and k_t L2-normalised in the kernel (x * rsqrt(sum x^2 + 1e-6)); q, k, v
// [B, T, H, 128] and o [B, T, H, 128] in the inputs' type T (bf16 or f32), g
// [B, T, H, 128] (the log decays, one a key channel, each at most 0) and beta
// [B, T, H] in f32, every other number in f32. q, k and v may be views into
// one projection (heads and channels contiguous, their token and sequence
// strides shared); g, beta and o are contiguous.
//
// It replaces no Pallas kernel: the JAX package has no linear-attention
// layer. Its plain counterpart is ops/kda.py:kda_plain, the chunked (WY) form
// of the same recurrence in f32 ATen.
//
// The recurrence as written, token by token on the CUDA cores, for both
// types. One block takes one sequence, one head and one half of the columns
// (64), and holds its half of the state, 128 x 64 f32, in registers: thread
// (column c, part r) of the block's 256 holds rows 32 r .. 32 r + 31 of
// column c, 32 registers. The four parts of a column are four neighbouring
// lanes of one warp, so each token's two sums over the rows (k^T S and q^T S)
// close with two xor shuffles. The sequence is walked kSteps tokens at a
// time: the block stages those tokens' normalised q (scaled by 128^-1/2) and
// k, the decays exp(g), its half of v and beta in shared memory, each row of
// q, k and exp(g) as four 32-float segments 36 floats apart, so the four
// parts of a warp read four different bank groups with one 16-byte load each.
// Each thread then advances its rows token by token:
//   s   = exp(g) * s                         (32 multiplies)
//   kv  = sum_r k_r s_r      (over the column, the 4 parts' partial sums)
//   d   = beta (v_c - kv)
//   s  += k d,   o_c = sum_r q_r s_r         (64 FMAs)
// and leaves o_c in shared memory; after the stretch the block writes its
// tokens' half rows of o, rounded once. Its bound is instruction issue: 4 x
// 128 x 128 state operations a token and head. Every number but the inputs
// and the output is f32, so a bf16 output is the f32 recurrence rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;               // K = V
constexpr int kHalf = 64;               // the state's columns a block
constexpr int kParts = 4;               // threads that share one column
constexpr int kRows = kDim / kParts;    // rows a thread: 32
constexpr int kSeg = kRows + 4;         // a staged row's segment stride (floats)
constexpr int kRow = kParts * kSeg;     // a staged row (floats)
constexpr int kSteps = 16;              // tokens staged at a time
constexpr int kThreads = kHalf * kParts;  // 256
constexpr float kEps = 1e-6f;

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store(float v);
template <>
__device__ __forceinline__ float store<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* beta;
  void* o;
  long long x_seq, x_tok;  // q's, k's and v's strides (elements) between sequences and tokens
  int seqlen, heads;
};

// The staged position of channel c in a row: its part's segment, then its row.
__device__ __forceinline__ int seg(int c) { return (c >> 5) * kSeg + (c & 31); }

// ---------------------------------------------------------------------------
// The recurrent body

// grid (2 H, B), kThreads threads; static shared memory: 3 x 16 x 144 floats
// of q, k and exp(g), 2 x 16 x 64 of v and o, 16 of beta (36 KB).
template <typename T>
__device__ __forceinline__ void recurrent_body(const Args& a) {
  __shared__ __align__(16) float s_q[kSteps][kRow];
  __shared__ __align__(16) float s_k[kSteps][kRow];
  __shared__ __align__(16) float s_a[kSteps][kRow];
  __shared__ float s_v[kSteps][kHalf];
  __shared__ float s_o[kSteps][kHalf];
  __shared__ float s_b[kSteps];

  const int h = blockIdx.x >> 1, half = blockIdx.x & 1;
  const long long seq = blockIdx.y;
  const int T_ = a.seqlen, H = a.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid >> 2, part = tid & 3;
  const long long row_stride = (long long)H * kDim;  // g's and o's between tokens, in elements
  const long long base = (seq * T_ * H + h) * kDim;  // token 0 of this head in g and o
  const long long xbase = seq * a.x_seq + (long long)h * kDim, x_tok = a.x_tok;
  const T* __restrict__ q = static_cast<const T*>(a.q) + xbase;
  const T* __restrict__ k = static_cast<const T*>(a.k) + xbase;
  const T* __restrict__ v = static_cast<const T*>(a.v) + xbase + half * kHalf;
  const float* __restrict__ g = a.g + base;
  const float* __restrict__ beta = a.beta + seq * T_ * H + h;
  T* __restrict__ o = static_cast<T*>(a.o) + base + half * kHalf;
  const float scale = rsqrtf((float)kDim);

  float s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) s[i] = 0.0f;

  for (int t0 = 0; t0 < T_; t0 += kSteps) {
    const int n = min(kSteps, T_ - t0);
    // q and k rows, each normalised by one warp (lane: channels 4 lane .. + 3)
    for (int r = warp; r < 2 * n; r += kThreads / 32) {
      const int j = r >> 1;
      const T* src = ((r & 1) ? k : q) + (long long)(t0 + j) * x_tok + 4 * lane;
      float x[4], ss = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = load<T>(src + e);
        ss = fmaf(x[e], x[e], ss);
      }
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o_);
      const float inv = rsqrtf(ss + kEps) * ((r & 1) ? 1.0f : scale);
      float* dst = ((r & 1) ? s_k[j] : s_q[j]) + seg(4 * lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = x[e] * inv;
    }
    for (int i = tid; i < n * kDim; i += kThreads) {
      const int j = i >> 7, c = i & (kDim - 1);
      s_a[j][seg(c)] = expf(__ldg(g + (long long)(t0 + j) * row_stride + c));
    }
    for (int i = tid; i < n * kHalf; i += kThreads) {
      const int j = i >> 6, c = i & (kHalf - 1);
      s_v[j][c] = load<T>(v + (long long)(t0 + j) * x_tok + c);
    }
    if (tid < n) s_b[tid] = __ldg(beta + (long long)(t0 + tid) * H);
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float4* __restrict__ ap = reinterpret_cast<const float4*>(&s_a[j][part * kSeg]);
      const float4* __restrict__ kp = reinterpret_cast<const float4*>(&s_k[j][part * kSeg]);
      const float4* __restrict__ qp = reinterpret_cast<const float4*>(&s_q[j][part * kSeg]);
      float kv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const float4 a4 = ap[i], k4 = kp[i];
        s[4 * i + 0] *= a4.x;
        s[4 * i + 1] *= a4.y;
        s[4 * i + 2] *= a4.z;
        s[4 * i + 3] *= a4.w;
        kv[0] = fmaf(k4.x, s[4 * i + 0], kv[0]);
        kv[1] = fmaf(k4.y, s[4 * i + 1], kv[1]);
        kv[2] = fmaf(k4.z, s[4 * i + 2], kv[2]);
        kv[3] = fmaf(k4.w, s[4 * i + 3], kv[3]);
      }
      float sum = (kv[0] + kv[1]) + (kv[2] + kv[3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float d = s_b[j] * (s_v[j][col] - sum);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const float4 k4 = kp[i], q4 = qp[i];
        s[4 * i + 0] = fmaf(k4.x, d, s[4 * i + 0]);
        s[4 * i + 1] = fmaf(k4.y, d, s[4 * i + 1]);
        s[4 * i + 2] = fmaf(k4.z, d, s[4 * i + 2]);
        s[4 * i + 3] = fmaf(k4.w, d, s[4 * i + 3]);
        acc[0] = fmaf(q4.x, s[4 * i + 0], acc[0]);
        acc[1] = fmaf(q4.y, s[4 * i + 1], acc[1]);
        acc[2] = fmaf(q4.z, s[4 * i + 2], acc[2]);
        acc[3] = fmaf(q4.w, s[4 * i + 3], acc[3]);
      }
      float out = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      out += __shfl_xor_sync(0xffffffffu, out, 1);
      out += __shfl_xor_sync(0xffffffffu, out, 2);
      if (part == 0) s_o[j][col] = out;
    }
    __syncthreads();
    for (int i = tid; i < n * kHalf; i += kThreads) {
      const int j = i >> 6, c = i & (kHalf - 1);
      o[(long long)(t0 + j) * row_stride + c] = store<T>(s_o[j][c]);
    }
    // the next stretch's staging overwrites nothing this one still reads:
    // s_o is read above, after the barrier that ends the token loop, and is
    // written again only after the next stretch's barrier
  }
}

// ---------------------------------------------------------------------------
// The kernel and its launch

template <typename T>
__global__ void __launch_bounds__(kThreads) kda_scan_kernel(Args args) {
  recurrent_body<T>(args);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T>
int launch(const Args& args, int batch, cudaStream_t s) {
  kda_scan_kernel<T><<<dim3(2 * args.heads, batch), kThreads, 0, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of q, k, v and o; g and beta float32.
// q, k and v [batch, seqlen, heads, 128] with strides (x_seq, x_tok, 128, 1);
// g and o [batch, seqlen, heads, 128] and beta [batch, seqlen, heads]
// contiguous. Returns a cudaError_t code.
extern "C" int kda_scan_fwd(int dtype, const void* q, const void* k, const void* v, long long x_seq, long long x_tok,
                            const float* g, const float* beta, void* o, long long batch, long long seqlen,
                            long long heads, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || batch > 65535 || heads > 32767 || seqlen > (1LL << 31) - 1 ||
      !aligned(g, 16) || !aligned(beta, 4))
    return (int)cudaErrorInvalidValue;
  Args args{q, k, v, g, beta, o, x_seq, x_tok, (int)seqlen, (int)heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(args, (int)batch, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(args, (int)batch, s);
}
