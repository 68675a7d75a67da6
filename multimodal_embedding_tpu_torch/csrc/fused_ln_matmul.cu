// Fused residual add + normalization + matmul prologue for Hopper (sm_90a),
// the CUDA counterpart of the Pallas TPU kernel
// multimodal_embedding_tpu/ops/fused_ln_matmul.py: fused_res_norm_matmul
// (grid body _kernel).
//
// For x [M, D], an optional delta [M, D], gamma [D], an optional beta [D],
// W [D, N] and an optional bias [N], all of one dtype T (bf16 or f32):
//
//   x_new = T(f32(x) + f32(delta))                       (the residual stream)
//   h     = T(norm(f32(x_new)))                          (LayerNorm or Gemma RMSNorm, f32)
//   y     = T(act(f32(T(h W + bias))))   with an activation, else T(h W + bias)
//
// with the rounding points of _reference: x_new is rounded before it is
// normalized, h is rounded before the product, the product accumulates in
// f32, the bias is added in f32, and y is rounded before the f32 activation.
// LayerNorm takes the mean, then the population variance mean((x - mu)^2),
// both in f32 over the whole row, and (x - mu) * rsqrt(var + eps) * gamma +
// beta; "rms_gemma" takes mean(x^2) and x * rsqrt(var + eps) * (1 + gamma).
//
// Design: two launches on one stream. The TPU kernel blocks the sequence
// dimension because a flatten is a relayout there; on the card [B, T, D] ->
// [B*T, D] is free, so rows are flattened.
//
// 1. Row pass (row_kernel): a warp per row, registers only, the design of
//    csrc/layernorm.cu (its row code is repeated here, since each source is
//    built and hashed alone). It reads x and delta once, and writes x_new and
//    h, both in T. The kernel is instantiated for the exact number of 16-byte
//    vectors a lane holds; all of a row's loads (x, delta, then gamma and
//    beta as 16-byte vectors) are in flight before its first reduction.
//    A row wider than 8 vectors a lane takes a block of 8 warps
//    (row_block_kernel), which reads its x_new back from L2, so any D that is
//    a multiple of 8 is taken.
// 2. Product pass (product_kernel): y = epilogue(h W + bias), a GEMM from
//    device memory. A block owns a 128 x 256 output tile; 8 warps of 64 x 64
//    each (every k16 slice runs 32 mma.sync a warp against 8 ldmatrix), so
//    one block fills an SM (255 registers a thread). A and B tiles go through
//    a 4-stage cp.async ring of 32-deep slices, zero-filled past M, N and D.
//    bf16: ldmatrix + mma.sync m16n8k16 with f32 accumulators; f32: plain FMA
//    in the same fragment layout (no TF32). Blocks are numbered with the
//    column tile fastest, so the blocks resident at one time share a few row
//    tiles of h and all of W stays in L2. The bias sits in shared memory from
//    the start; the epilogue adds it, rounds, runs the activation in f32
//    (one instance of the kernel per activation) and stores column pairs.
//    128-column tiles (two blocks an SM, 64 x 32 warp tiles) ran no faster
//    and move a third more from L2.
//
// Why h goes to device memory. The earlier design normalized a 32-row tile
// of h into shared memory and multiplied it there. A 128-row tile of h does
// not fit (128 x 1024 x 2 B = 256 KB, above the 227 KB a block gets), so W
// was re-read from L2 for every 32 rows (1154 times at ViT-L b64, about 7 GB)
// and each warp's 16 x 32 tile ran four mma.sync per three ldmatrix. Writing
// h costs one write and one read of [M, D] (151 MB, about 45 us at ViT-L b64)
// against a 0.235 ms bound that counts operations; in exchange the product
// pass takes its A operand as it is, with no transform on load, which is
// also what a later TMA + wgmma product pass needs (TMA cannot transform a
// tile on its way in). Normalizing A inside the product's shared-memory
// stages would cost an extra pass and barrier in every k-step.
//
// Bound on an H100 SXM at ViT-L batch 64 (M 36928, D 1024): the QKV prologue
// (N 3072) is 2*36928*1024*3072 = 232 GFLOP, 0.235 ms at the 989 TFLOP/s bf16
// dense peak, against about 0.46 GB of x, delta, W, x_new and y (0.14 ms at
// 3.35 TB/s): bound by operations; the MLP prologue (N 4096) is 310 GFLOP,
// 0.313 ms. With 128 x 256 tiles W is read from L2 289 times and h 12 times
// at ViT-L b64 QKV, 2.7 GB in all, and that delivery, not the mma.sync loop,
// is what the product pass waits on: on an H100 SXM the same kernel with its
// copies taken out runs the QKV product in about two thirds of its time,
// with its products taken out in over four fifths. Left to later work: wgmma
// fed by TMA with W multicast over a cluster (one L2 read for several
// blocks), a persistent schedule that overlaps one tile's epilogue with the
// next tile's loads, and stores of y staged through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecs = 8;  // 16-byte vectors a lane holds on the row pass's warp-per-row path

// Product pass tiling.
constexpr int kBM = 128;    // output rows per block
constexpr int kBN = 256;    // output columns per block
constexpr int kBK = 32;     // depth of one ring stage
constexpr int kStages = 4;  // ring stages (kStages - 1 in flight)
constexpr int kWarpsM = 2;  // warps along the rows; kWarps / kWarpsM along the columns
constexpr int kWarpsN = kWarps / kWarpsM;
constexpr int kMT = kBM / kWarpsM / 16;  // m16 tiles a warp
constexpr int kNT = kBN / kWarpsN / 8;   // n8 tiles a warp (even)

enum Norm { kLayerNorm = 0, kRmsGemma = 1 };
enum Act { kNone = 0, kGelu = 1, kQuickGelu = 2, kGeluTanh = 3 };

struct RowParams {
  const void* x;      // [M, D] contiguous, 16-byte aligned
  const void* delta;  // [M, D] contiguous, 16-byte aligned, or nullptr
  const void* gamma;  // [D]
  const void* beta;   // [D], or nullptr
  void* x_new;        // [M, D]
  void* h;            // [M, D]
  int M, D, norm;
  float eps;
  int gb_vec;  // 1: gamma and beta are 16-byte aligned (vector loads); 0: element loads
};

struct ProductParams {
  const void* h;     // [M, D] contiguous, 16-byte aligned
  const void* w;     // [D, N] contiguous
  const void* bias;  // [N], or nullptr
  void* y;           // [M, N]
  int M, D, N;
  int w_vec;  // 1: W rows are 16-byte aligned, loaded by cp.async; 0: element loads
};

extern __shared__ __align__(128) unsigned char smem[];

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

template <typename T>
__device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  return to_f(reinterpret_cast<const T*>(&v)[e]);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// The activations in f32. quick_gelu is v * sigmoid(1.702 v), and the tanh
// GELU 0.5 v (1 + tanh(u)) is the same function as v * sigmoid(2u): both are
// taken as v / (1 + exp(-z)) with the fast exponential and division (about
// 1e-6 relative; a huge exp(-z) gives 0, the limit). In the product's
// epilogue every output takes one, so their cost shows wherever no other
// block's products hide it.
__device__ __forceinline__ float sigmoid_times(float v, float z) { return __fdividef(v, 1.0f + __expf(-z)); }

template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if constexpr (kAct == kGelu) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if constexpr (kAct == kQuickGelu) return sigmoid_times(v, 1.702f * v);
  if constexpr (kAct == kGeluTanh) return sigmoid_times(v, 1.5957691216057308f * (v + 0.044715f * v * v * v));
  return v;
}

// --- 1. the row pass ------------------------------------------------------------

// The sum (LayerNorm) or sum of squares (RMSNorm) term of one x_new value.
__device__ __forceinline__ float stat_term(bool ln, float v) { return ln ? v : v * v; }

// h = norm(x_new) for one value, with the row's mu and rstd.
__device__ __forceinline__ float norm_value(bool ln, float v, float mu, float rstd, float g, float b) {
  return ln ? (v - mu) * rstd * g + b : v * rstd * (1.0f + g);
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads) row_kernel(RowParams p) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.M) return;
  const bool ln = p.norm == kLayerNorm;
  const long long off = (long long)row * p.D;
  const T* xr = static_cast<const T*>(p.x) + off;
  const T* dr = p.delta ? static_cast<const T*>(p.delta) + off : nullptr;
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* beta = static_cast<const T*>(p.beta);
  // every load of the row, then gamma and beta, in flight before the first reduction
  uint4 xv[kVecs], dv[kVecs], gv[kVecs], bv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < p.D) {
      xv[i] = *reinterpret_cast<const uint4*>(xr + c);
      if (dr) dv[i] = *reinterpret_cast<const uint4*>(dr + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < p.D) {
      gv[i] = load_vec(gamma, c, p.gb_vec);
      bv[i] = beta ? load_vec(beta, c, p.gb_vec) : make_uint4(0, 0, 0, 0);
    }
  }
  T* xnr = static_cast<T*>(p.x_new) + off;
  T* hr = static_cast<T*>(p.h) + off;
  // x_new = T(x + delta), kept in xv, and its sum or sum of squares
  float s1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < p.D) {
      T* xe = reinterpret_cast<T*>(&xv[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xe[e] = from_f<T>(dr ? to_f(xe[e]) + elem<T>(dv[i], e) : to_f(xe[e]));
        s1 += stat_term(ln, to_f(xe[e]));
      }
      *reinterpret_cast<uint4*>(xnr + c) = xv[i];
    }
  }
  const float inv_d = 1.0f / (float)p.D;
  const float mean = warp_sum(s1) * inv_d;
  float mu = 0.0f, rstd;
  if (ln) {
    mu = mean;
    float s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      if ((i * 32 + lane) * V < p.D)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = elem<T>(xv[i], e) - mu;
          s2 += d * d;
        }
    rstd = rsqrtf(warp_sum(s2) * inv_d + p.eps);
  } else {
    rstd = rsqrtf(mean + p.eps);  // mean(x^2)
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < p.D) {
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < V; ++e)
        oe[e] = from_f<T>(norm_value(ln, elem<T>(xv[i], e), mu, rstd, elem<T>(gv[i], e), elem<T>(bv[i], e)));
      *reinterpret_cast<uint4*>(hr + c) = ov;
    }
  }
}

// One row per block, for rows wider than kMaxVecs vectors a lane. Each thread
// reads back only the x_new vectors it wrote itself.
template <typename T>
__global__ void __launch_bounds__(kThreads) row_block_kernel(RowParams p) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kWarps];
  const bool ln = p.norm == kLayerNorm;
  const float inv_d = 1.0f / (float)p.D;
  const long long off = (long long)blockIdx.x * p.D;
  const T* xr = static_cast<const T*>(p.x) + off;
  const T* dr = p.delta ? static_cast<const T*>(p.delta) + off : nullptr;
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* beta = static_cast<const T*>(p.beta);
  T* xnr = static_cast<T*>(p.x_new) + off;
  T* hr = static_cast<T*>(p.h) + off;
  float s1 = 0.0f;
  for (int c = threadIdx.x * V; c < p.D; c += kThreads * V) {
    uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 dv = dr ? *reinterpret_cast<const uint4*>(dr + c) : make_uint4(0, 0, 0, 0);
    T* xe = reinterpret_cast<T*>(&xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xe[e] = from_f<T>(dr ? to_f(xe[e]) + elem<T>(dv, e) : to_f(xe[e]));
      s1 += stat_term(ln, to_f(xe[e]));
    }
    *reinterpret_cast<uint4*>(xnr + c) = xv;
  }
  const float mean = block_sum(s1, red) * inv_d;
  float mu = 0.0f, rstd;
  if (ln) {
    mu = mean;
    float s2 = 0.0f;
    for (int c = threadIdx.x * V; c < p.D; c += kThreads * V) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xnr + c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = elem<T>(xv, e) - mu;
        s2 += d * d;
      }
    }
    rstd = rsqrtf(block_sum(s2, red) * inv_d + p.eps);
  } else {
    rstd = rsqrtf(mean + p.eps);
  }
  for (int c = threadIdx.x * V; c < p.D; c += kThreads * V) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xnr + c);
    const uint4 gv = load_vec(gamma, c, p.gb_vec);
    const uint4 bv = beta ? load_vec(beta, c, p.gb_vec) : make_uint4(0, 0, 0, 0);
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < V; ++e)
      oe[e] = from_f<T>(norm_value(ln, elem<T>(xv, e), mu, rstd, elem<T>(gv, e), elem<T>(bv, e)));
    *reinterpret_cast<uint4*>(hr + c) = ov;
  }
}

template <typename T, int kVecs>
int launch_rows(const RowParams& p, cudaStream_t stream) {
  row_kernel<T, kVecs><<<(p.M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int rows(const RowParams& p, cudaStream_t s) {
  const int per_lane = 32 * (16 / (int)sizeof(T));
  switch ((p.D + per_lane - 1) / per_lane) {
    case 1: return launch_rows<T, 1>(p, s);
    case 2: return launch_rows<T, 2>(p, s);
    case 3: return launch_rows<T, 3>(p, s);
    case 4: return launch_rows<T, 4>(p, s);
    case 5: return launch_rows<T, 5>(p, s);
    case 6: return launch_rows<T, 6>(p, s);
    case 7:
    case kMaxVecs: return launch_rows<T, kMaxVecs>(p, s);
    default:
      row_block_kernel<T><<<p.M, kThreads, 0, s>>>(p);
      return (int)cudaGetLastError();
  }
}

// --- 2. the product pass ----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most kStages - 2 copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout of the product pass: kStages ring stages, each an A
// tile [kBM, kBK] and a B tile [kBK, kBN] with rows padded by one 16-byte
// vector (ldmatrix rows then fall in distinct banks), then the bias [kBN] in f32.
template <typename T>
struct Smem {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int lda = kBK + V;
  static constexpr int ldb = kBN + V;
  static constexpr int a_bytes = align128(kBM * lda * (int)sizeof(T));
  static constexpr int stage_bytes = a_bytes + align128(kBK * ldb * (int)sizeof(T));
  static constexpr int bias_off = kStages * stage_bytes;
  static constexpr int total = bias_off + kBN * 4;
};

// Start copying depth slice kt of the block's A (rows m0..) and B (columns
// n0..) tiles into ring stage `stage`, zero-filling past M, N and D.
template <typename T>
__device__ __forceinline__ void load_stage(const ProductParams& p, int stage, int kt, int m0, int n0) {
  using S = Smem<T>;
  constexpr int V = S::V;
  T* as = reinterpret_cast<T*>(smem + stage * S::stage_bytes);
  T* bs = reinterpret_cast<T*>(smem + stage * S::stage_bytes + S::a_bytes);
  const T* h = static_cast<const T*>(p.h);
  const T* w = static_cast<const T*>(p.w);
  const int k0 = kt * kBK;
  constexpr int a_vecs = kBK / V;  // per A row
  static_assert(kBM * a_vecs % kThreads == 0, "A copies split evenly over the threads");
#pragma unroll
  for (int j = 0; j < kBM * a_vecs / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / a_vecs, c = (i % a_vecs) * V;
    const int gm = m0 + r, gk = k0 + c;
    const bool valid = gm < p.M && gk < p.D;  // D % 8 == 0: a vector lies wholly inside or outside
    cp_async16(as + r * S::lda + c, valid ? h + (long long)gm * p.D + gk : h, valid);
  }
  constexpr int b_vecs = kBN / V;  // per B row
  static_assert(kBK * b_vecs % kThreads == 0, "B copies split evenly over the threads");
#pragma unroll
  for (int j = 0; j < kBK * b_vecs / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / b_vecs, c = (i % b_vecs) * V;
    const int gk = k0 + r, gn = n0 + c;
    T* d = bs + r * S::ldb + c;
    if (p.w_vec) {  // N % V == 0: a vector lies wholly inside or outside
      const bool valid = gk < p.D && gn < p.N;
      cp_async16(d, valid ? w + (long long)gk * p.N + gn : w, valid);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool valid = gk < p.D && gn + e < p.N;
        d[e] = valid ? w[(long long)gk * p.N + gn + e] : from_f<T>(0.0f);
      }
    }
  }
}

// kAct: the epilogue's activation, a template parameter so that each
// instance carries the code of one.
template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads, 1) product_kernel(ProductParams p) {
  using S = Smem<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * kBM;  // column tile fastest
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int k_tiles = (p.D + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage<T>(p, s, s, m0, n0);
    cp_async_commit();  // one group per stage, empty past the end
  }
  // the bias, ahead of the epilogue (visible after the first barrier)
  float* bias_s = reinterpret_cast<float*>(smem + S::bias_off);
  const T* bias = static_cast<const T*>(p.bias);
  for (int c = threadIdx.x; c < kBN; c += kThreads) bias_s[c] = bias && n0 + c < p.N ? to_f(bias[n0 + c]) : 0.0f;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int row_w = wm * kMT * 16;  // the warp's first row in the tile
  const int col_w = wn * kNT * 8;   // the warp's first column in the tile
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  cp_async_wait_ring();  // depth slice 0 has landed (for this thread)
  __syncthreads();       // ... for every thread; the bias is in place

  // bf16 fragments, two buffers: slice ki + 1's ldmatrix are issued before
  // slice ki's mma.sync. The barrier that frees a stage for refilling sits
  // before the last slice's mma.sync, so the next depth slice's first
  // ldmatrix, too, overlap this slice's products.
  constexpr int kSlices = kBK / 16;
  static_assert(kSlices % 2 == 0, "slice 0 of every depth slice lands in fragment buffer 0");
  unsigned a[2][kMT][4], b[2][kNT / 2][4];
  const unsigned a_lane = sbase + 2 * ((row_w + (lane & 15)) * S::lda + (lane >> 4) * 8);
  const unsigned b_lane =
      sbase + S::a_bytes + 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * S::ldb + col_w + (lane >> 4) * 8);
  auto load_frags = [&](int buf, int stage_off, int ki) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) ldsm_x4(a_lane + stage_off + 2 * (mt * 16 * S::lda + ki * 16), a[buf][mt]);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np)
      ldsm_x4_trans(b_lane + stage_off + 2 * (ki * 16 * S::ldb + np * 16), b[buf][np]);
  };
  if constexpr (kBf16) load_frags(0, 0, 0);

  for (int kt = 0; kt < k_tiles; ++kt) {
    {
      // refill the stage depth slice kt - 1 used: every warp read it before
      // the last barrier
      const int nk = kt + kStages - 1;
      if (nk < k_tiles) load_stage<T>(p, nk % kStages, nk, m0, n0);
      cp_async_commit();  // one group per depth slice, empty past the end
    }
    const int stage_off = (kt % kStages) * S::stage_bytes;
    if constexpr (kBf16) {
#pragma unroll
      for (int ki = 0; ki < kSlices; ++ki) {
        if (ki + 1 < kSlices) {
          load_frags((ki + 1) & 1, stage_off, ki + 1);
        } else {
          cp_async_wait_ring();  // depth slice kt + 1 has landed
          __syncthreads();       // ... everywhere; every warp is done reading slice kt's stage
          if (kt + 1 < k_tiles) load_frags(0, ((kt + 1) % kStages) * S::stage_bytes, 0);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[ki & 1][mt], b[ki & 1][np][0], b[ki & 1][np][1]);
            mma_bf16(acc[mt][2 * np + 1], a[ki & 1][mt], b[ki & 1][np][2], b[ki & 1][np][3]);
          }
      }
    } else {
      const T* as = reinterpret_cast<const T*>(smem + stage_off);
      const T* bs = reinterpret_cast<const T*>(smem + stage_off + S::a_bytes);
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kMT][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            av[mt][half] = to_f(as[(row_w + mt * 16 + (lane >> 2) + half * 8) * S::lda + kk]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const T* br = bs + kk * S::ldb + col_w + nt * 8 + (lane & 3) * 2;
          const float b0 = to_f(br[0]), b1 = to_f(br[1]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              acc[mt][nt][2 * half] = fmaf(av[mt][half], b0, acc[mt][nt][2 * half]);
              acc[mt][nt][2 * half + 1] = fmaf(av[mt][half], b1, acc[mt][nt][2 * half + 1]);
            }
        }
      }
      cp_async_wait_ring();
      __syncthreads();
    }
  }

  // epilogue straight from the accumulators: rows g and g + 8, columns 2*tig, +1
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + row_w + mt * 16 + (lane >> 2) + half * 8;
      if (r >= p.M) continue;
      T* yr = y + (long long)r * p.N;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int cl = col_w + nt * 8 + (lane & 3) * 2;  // column in the tile
        const int col = n0 + cl;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = acc[mt][nt][2 * half + e] + bias_s[cl + e];
          if constexpr (kAct != kNone) t = activate<kAct>(round_t<T>(t));
          v[e] = t;
        }
        bool paired = false;
        if constexpr (kBf16) {
          paired = col + 1 < p.N && (p.N & 1) == 0;  // 4-byte aligned pair
          if (paired) *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(v[0], v[1]);
        }
        if (!paired) {
          if (col < p.N) yr[col] = from_f<T>(v[0]);
          if (col + 1 < p.N) yr[col + 1] = from_f<T>(v[1]);
        }
      }
    }
}

template <typename T, int kAct>
int product(const ProductParams& p, cudaStream_t stream) {
  static bool attr_set = false;
  auto kernel = product_kernel<T, kAct>;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::total);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long blocks = (long long)((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, Smem<T>::total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int product_act(const ProductParams& p, int act, cudaStream_t s) {
  switch (act) {
    case kNone: return product<T, kNone>(p, s);
    case kGelu: return product<T, kGelu>(p, s);
    case kQuickGelu: return product<T, kQuickGelu>(p, s);
    case kGeluTanh: return product<T, kGeluTanh>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; norm: 0 = LayerNorm, 1 = Gemma RMSNorm.
// The row pass alone: x_new and h [M, D] from x and delta (nullptr for none).
// x, delta, x_new and h contiguous and 16-byte aligned, D a multiple of 8;
// gb_vec: 1 when gamma and beta (beta may be nullptr) are 16-byte aligned.
// Returns a cudaError_t code.
extern "C" int fused_ln_rows_fwd(int dtype, const void* x, const void* delta, const void* gamma, const void* beta,
                                 void* x_new, void* h, int M, int D, int norm, float eps, int gb_vec, void* stream) {
  if (D % 8 != 0 || D <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  RowParams p{x, delta, gamma, beta, x_new, h, M, D, norm, eps, gb_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return rows<__nv_bfloat16>(p, s);
  if (dtype == 0) return rows<float>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The whole prologue, two launches on `stream`: the row pass into x_new and
// the scratch h [M, D], then y [M, N] = act(h W + bias). act: 0 none, 1
// gelu, 2 quick_gelu, 3 gelu_pytorch_tanh; bias may be nullptr; w_vec: 1 when
// W is 16-byte aligned and N * sizeof(T) a multiple of 16. Returns a
// cudaError_t code.
extern "C" int fused_ln_matmul_fwd(int dtype, const void* x, const void* delta, const void* gamma,
                                   const void* beta, const void* w, const void* bias, void* x_new, void* h, void* y,
                                   int M, int D, int N, int norm, int act, float eps, int gb_vec, int w_vec,
                                   void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const int code = fused_ln_rows_fwd(dtype, x, delta, gamma, beta, x_new, h, M, D, norm, eps, gb_vec, stream);
  if (code != 0) return code;
  ProductParams p{h, w, bias, y, M, D, N, w_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return product_act<__nv_bfloat16>(p, act, s);
  return product_act<float>(p, act, s);
}
