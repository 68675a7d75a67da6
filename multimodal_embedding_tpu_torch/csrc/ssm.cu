// Mamba-2's selective state-space scan for Hopper (sm_90a), in its recurrent
// form: for each sequence b and head h, with the head's state S [P, N] in f32,
//   S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) B_t^T,
//   y_t = S_t C_t + D_h * x_t,
// x [B, T, H, P], dt [B, T, H] (after the softplus), B and C [B, T, N] (one
// group, shared by every head), A [H] in f32, D [H]; y [B, T, H, P] in the
// inputs' type T (bf16 or f32), every other number in f32.
//
// It replaces no Pallas kernel: the JAX package has no state-space layer. Its
// plain counterpart is ops/ssm.py:scan_plain, the chunked (SSD) form of the
// same recurrence in f32 ATen.
//
// Design: one block a (sequence, head), 2P threads. Thread (half, p) holds
// row p of the state over half of the N state columns, N/2 f32 registers, for
// the whole sequence; no state ever leaves the registers. The sequence is
// walked kSteps tokens at a time: the block stages those tokens' B and C rows,
// its head's x rows, dt and decays exp(dt * A) in shared memory (converted to
// f32 once), then each thread advances its state token by token, reading B
// and C as 16-byte broadcasts (a warp's threads share one half, so one
// address), and leaves its half of y_t's dot product in shared memory; after
// the stretch the two halves and the D skip are summed and y written. One
// __syncthreads a stage, none a token.
//
// Numerics: the decay exp(dt * A) in f32 with the accurate expf (this file
// builds without --use_fast_math), then each state element
// fmaf(decay, s, (dt * x_p) * B_n), the dot product with C accumulated in four
// f32 partial sums over the thread's columns, the two halves added, then
// D * x added (one fmaf) and the sum rounded once to T. The chunked plain form sums in
// another order: the two agree to f32 rounding of the state, not bit for bit.
//
// Bound on an H100 SXM: instruction issue. Each (token, head) is P * N
// elements of two FMAs and a multiply, 24.6 K instructions a head at P 64 and
// N 128, about 2.6e10 over a page batch (8 x 1030 tokens, 128 heads), 0.78 ms
// of the CUDA cores' issue at 1.98 GHz, against the 275 MB it reads and writes
// (x and y in bf16, 0.08 ms at 3.35 TB/s): the cores and not the memory set its
// time. The chunked tensor-core form (SSD) moves most of that work
// onto wgmma; this kernel is the recurrence as written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 2;   // threads that share one state row, each N / kSplit of its columns
constexpr int kSteps = 16;  // tokens staged in shared memory at a time
constexpr int kMaxP = 128;  // the largest head dim: 2P threads a block

template <typename T>
__device__ __forceinline__ float load(const T* p);

template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
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
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const void* d;
  void* y;
  long long x_seq, x_tok;    // x's strides (elements) between sequences and tokens; heads then P contiguous
  long long bc_seq, bc_tok;  // B's and C's strides; N contiguous
  int seqlen, heads, p;
};

// grid (H, B), block 2P threads; N the state size (a multiple of 4 kSplit). Static shared
// memory: 40 KB at N 128.
template <typename T, int N>
__global__ void __launch_bounds__(2 * kMaxP) ssm_scan_kernel(Args args) {
  constexpr int NH = N / kSplit;  // state columns a thread
  __shared__ __align__(16) float s_b[kSteps][N];
  __shared__ __align__(16) float s_c[kSteps][N];
  __shared__ float s_x[kSteps][kMaxP];
  __shared__ float s_part[kSplit][kSteps][kMaxP];
  __shared__ float s_dt[kSteps];
  __shared__ float s_decay[kSteps];

  const int h = blockIdx.x, seq = blockIdx.y;
  const int P = args.p, nthreads = kSplit * P;
  const int tid = threadIdx.x;
  const int half = tid / P, row = tid - half * P;
  const T* __restrict__ x = static_cast<const T*>(args.x) + seq * args.x_seq + (long long)h * P;
  const T* __restrict__ dt = static_cast<const T*>(args.dt) + (long long)seq * args.seqlen * args.heads + h;
  const T* __restrict__ bm = static_cast<const T*>(args.b) + seq * args.bc_seq;
  const T* __restrict__ cm = static_cast<const T*>(args.c) + seq * args.bc_seq;
  T* __restrict__ y = static_cast<T*>(args.y) + ((long long)seq * args.seqlen * args.heads + h) * P;
  const float a_h = args.a[h];
  const float d_h = load<T>(static_cast<const T*>(args.d) + h);

  float s[NH];
#pragma unroll
  for (int k = 0; k < NH; ++k) s[k] = 0.0f;

  for (int t0 = 0; t0 < args.seqlen; t0 += kSteps) {
    const int steps = min(kSteps, args.seqlen - t0);
    for (int i = tid; i < steps * N; i += nthreads) {  // B and C rows, coalesced along N
      const int j = i / N, n = i - j * N;
      const long long off = (long long)(t0 + j) * args.bc_tok + n;
      s_b[j][n] = load<T>(bm + off);
      s_c[j][n] = load<T>(cm + off);
    }
    for (int i = tid; i < steps * P; i += nthreads) {
      const int j = i / P, q = i - j * P;
      s_x[j][q] = load<T>(x + (long long)(t0 + j) * args.x_tok + q);
    }
    if (tid < steps) {
      const float v = load<T>(dt + (long long)(t0 + tid) * args.heads);
      s_dt[tid] = v;
      s_decay[tid] = expf(v * a_h);
    }
    __syncthreads();
    for (int j = 0; j < steps; ++j) {
      const float u = s_dt[j] * s_x[j][row];
      const float decay = s_decay[j];
      const float4* __restrict__ bv = reinterpret_cast<const float4*>(&s_b[j][half * NH]);
      const float4* __restrict__ cv = reinterpret_cast<const float4*>(&s_c[j][half * NH]);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < NH / 4; ++q) {
        const float4 b4 = bv[q], c4 = cv[q];
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& st = s[4 * q + e];
          st = fmaf(decay, st, u * bb[e]);
          acc[e] = fmaf(st, cc[e], acc[e]);
        }
      }
      s_part[half][j][row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    for (int i = tid; i < steps * P; i += nthreads) {
      const int j = i / P, q = i - j * P;
      float v = s_part[0][j][q];
#pragma unroll
      for (int k = 1; k < kSplit; ++k) v += s_part[k][j][q];
      y[(long long)(t0 + j) * args.heads * P + q] = store<T>(fmaf(d_h, s_x[j][q], v));
    }
    __syncthreads();  // the stage is read before the next one overwrites it
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, int N>
int launch(const Args& args, int batch, cudaStream_t s) {
  ssm_scan_kernel<T, N><<<dim3(args.heads, batch), kSplit * args.p, 0, s>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& args, int batch, int n, cudaStream_t s) {
  switch (n) {
    case 16: return launch<T, 16>(args, batch, s);
    case 32: return launch<T, 32>(args, batch, s);
    case 64: return launch<T, 64>(args, batch, s);
    case 128: return launch<T, 128>(args, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of x, dt, B, C, D and y; a float32.
// x [batch, seqlen, heads, p] with strides (x_seq, x_tok, p, 1); dt [batch,
// seqlen, heads] contiguous; B and C [batch, seqlen, n] with strides (bc_seq,
// bc_tok, 1); a and d [heads]; y [batch, seqlen, heads, p] contiguous.
// 1 <= p <= 128; n one of 16, 32, 64, 128. Returns a cudaError_t code.
extern "C" int ssm_scan_fwd(int dtype, const void* x, long long x_seq, long long x_tok, const void* dt,
                            const float* a, const void* b, const void* c, long long bc_seq, long long bc_tok,
                            const void* d, void* y, long long batch, long long seqlen, long long heads, long long p,
                            long long n, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || p < 1 || p > kMaxP || batch > 65535 || heads > (1LL << 31) - 1 ||
      seqlen > (1LL << 31) - 1 || !aligned(a, 4))
    return (int)cudaErrorInvalidValue;
  Args args{x, dt, a, b, c, d, y, x_seq, x_tok, bc_seq, bc_tok, (int)seqlen, (int)heads, (int)p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(args, (int)batch, (int)n, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(args, (int)batch, (int)n, s);
  return (int)cudaErrorInvalidValue;
}
