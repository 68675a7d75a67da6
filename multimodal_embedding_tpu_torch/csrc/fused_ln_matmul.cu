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
// Design. The TPU kernel blocks the sequence dimension because a flatten is
// a relayout there; on the card [B, T, D] -> [B*T, D] is free, so rows are
// flattened. One block of 8 warps owns BM rows (32, or 16 when the h tile of
// 32 rows does not fit) and a group of the kBN-column tiles of the output:
// tiles blockIdx.y, blockIdx.y + splits, ... (splits is chosen by the host so
// that the grid fills the card). The block first normalizes its rows, one
// warp per row, from device memory into an h tile in T held whole in shared
// memory ([BM, D], 64 KB at ViT-L's D 1024, 72 KB at SigLIP's D 1152),
// writing x_new on the way when it is the block of the first tile group. It
// then streams W in kBK-row steps through a double-buffered cp.async ring,
// one step after another over all of its column tiles, so the ring never
// drains at a tile boundary; the first step is in flight while the rows are
// being normalized. Two blocks fit on an SM at D 1024 and 1152 (about 100 KB
// of shared memory each), so one block's normalization, barrier waits and
// epilogue overlap the other's products. bf16: ldmatrix + mma.sync m16n8k16
// with f32 accumulators, each k16 slice's fragments loaded one slice ahead
// (warp tile 16 x 32); f32: plain FMA in the same fragment layout (no TF32).
// At a tile's last step the epilogue adds the bias (loaded at the tile's
// first step) and runs the activation in f32 and stores y from the
// accumulators.
//
// Bound on an H100 SXM at ViT-L batch 64 (M 36928, D 1024): the QKV
// prologue (N 3072) is 2*36928*1024*3072 = 232 GFLOP, 0.235 ms at the
// 989 TFLOP/s bf16 dense peak, against about 0.46 GB of x, delta, W, x_new
// and y (0.14 ms at 3.35 TB/s): bound by operations; the MLP prologue
// (N 4096) is 310 GFLOP, 0.313 ms. This version feeds the tensor cores with
// mma.sync, re-reads W from L2 for every row tile (W traffic grows as 1/BM)
// and does not overlap a block's own normalization and epilogue with its
// products; wgmma with TMA multicast of W across a cluster is later work
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;    // output columns per tile
constexpr int kBK = 64;     // rows of W per pipeline step
constexpr int kStages = 2;  // steps in the shared-memory ring (kStages - 1 in flight)
constexpr size_t kSmemLimit = 232448;  // 227 KB, the per-block maximum

enum Norm { kLayerNorm = 0, kRmsGemma = 1 };
enum Act { kNone = 0, kGelu = 1, kQuickGelu = 2, kGeluTanh = 3 };

struct Params {
  const void* x;      // [M, D] contiguous
  const void* delta;  // [M, D] contiguous, or nullptr
  const void* gamma;  // [D]
  const void* beta;   // [D], or nullptr
  const void* w;      // [D, N] contiguous
  const void* bias;   // [N], or nullptr
  void* x_new;        // [M, D]
  void* y;            // [M, N]
  int M, D, N;
  int norm, act;
  float eps;
  int w_vec;   // 1: W rows are 16-byte aligned, loaded by cp.async; 0: element loads
  int splits;  // column-tile groups (gridDim.y)
  int dk;      // D rounded up to a multiple of 16 (the h tile's product depth)
  int ldh;     // shared-memory row stride of the h tile in elements: dk + 16 / sizeof(T)
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case kGelu:
      return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case kQuickGelu:
      return v / (1.0f + expf(-1.702f * v));
    case kGeluTanh:
      return 0.5f * v * (1.0f + tanhf(0.79788456080286536f * (v + 0.044715f * v * v * v)));
    default:
      return v;
  }
}

// Warp tiling of the BM x kBN output tile over the 8 warps.
template <int BM>
struct Tiling {
  static constexpr int WM = BM >= 32 ? 2 : 1;  // warps along the rows
  static constexpr int WN = kWarps / WM;       // warps along the columns
  static constexpr int MT = BM / WM / 16;      // m16 tiles per warp
  static constexpr int NT = kBN / WN / 8;      // n8 tiles per warp (even)
};

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int ldw() { return kBN + vec_elems<T>(); }  // padded W stage row

__host__ __device__ inline int align128(int bytes) { return (bytes + 127) / 128 * 128; }

template <typename T>
__host__ __device__ inline int h_bytes(int bm, int ldh) { return align128(bm * ldh * (int)sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int w_stage_bytes() { return kBK * ldw<T>() * (int)sizeof(T); }

// Normalize rows [m0, m0 + BM) into the h tile, one warp per row. Each lane
// keeps to the same 16-byte column vectors in every sweep, so it reads back
// only what it wrote itself. Rows past M and the columns D .. dk are zeros.
template <typename T, int BM>
__device__ __forceinline__ void normalize_rows(const Params& p, int m0, bool write_xnew) {
  constexpr int V = vec_elems<T>();
  T* Hs = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* beta = static_cast<const T*>(p.beta);
  const float inv_d = 1.0f / (float)p.D;
  for (int r = warp; r < BM; r += kWarps) {
    T* hrow = Hs + r * p.ldh;
    const int m = m0 + r;
    if (m >= p.M) {
      for (int c = lane; c < p.dk; c += 32) hrow[c] = from_f<T>(0.0f);
      continue;
    }
    const T* xr = static_cast<const T*>(p.x) + (long long)m * p.D;
    const T* dr = p.delta ? static_cast<const T*>(p.delta) + (long long)m * p.D : nullptr;
    T* xnr = static_cast<T*>(p.x_new) + (long long)m * p.D;
    // sweep 1: x_new = T(x + delta) into the tile (and out), its sum or sum of squares
    float s1 = 0.0f;
    for (int c = lane * V; c < p.D; c += 32 * V) {
      uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
      const T* xe = reinterpret_cast<const T*>(&xv);
      uint4 dv = make_uint4(0, 0, 0, 0);
      if (dr) dv = *reinterpret_cast<const uint4*>(dr + c);
      const T* de = reinterpret_cast<const T*>(&dv);
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = dr ? to_f(xe[e]) + to_f(de[e]) : to_f(xe[e]);
        oe[e] = from_f<T>(f);
        const float v = to_f(oe[e]);
        s1 += p.norm == kLayerNorm ? v : v * v;
      }
      *reinterpret_cast<uint4*>(hrow + c) = ov;
      if (write_xnew) *reinterpret_cast<uint4*>(xnr + c) = ov;
    }
    const float mean = warp_sum(s1) * inv_d;
    float mu = 0.0f, rstd;
    if (p.norm == kLayerNorm) {
      // sweep 2: the population variance about the mean
      mu = mean;
      float s2 = 0.0f;
      for (int c = lane * V; c < p.D; c += 32 * V) {
        uint4 hv = *reinterpret_cast<const uint4*>(hrow + c);
        const T* he = reinterpret_cast<const T*>(&hv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float dv = to_f(he[e]) - mu;
          s2 += dv * dv;
        }
      }
      rstd = rsqrtf(warp_sum(s2) * inv_d + p.eps);
    } else {
      rstd = rsqrtf(mean + p.eps);  // mean(x^2)
    }
    // sweep 3: h = T(norm(x_new)) over the same columns
    for (int c = lane * V; c < p.D; c += 32 * V) {
      uint4 hv = *reinterpret_cast<const uint4*>(hrow + c);
      T* he = reinterpret_cast<T*>(&hv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float g = to_f(gamma[c + e]);
        float v;
        if (p.norm == kLayerNorm) {
          v = (to_f(he[e]) - mu) * rstd * g + (beta ? to_f(beta[c + e]) : 0.0f);
        } else {
          v = to_f(he[e]) * rstd * (1.0f + g);
        }
        he[e] = from_f<T>(v);
      }
      *reinterpret_cast<uint4*>(hrow + c) = hv;
    }
    for (int c = p.D + lane; c < p.dk; c += 32) hrow[c] = from_f<T>(0.0f);
  }
}

// Start copying rows [k0, k0 + kBK) x columns [n0, n0 + kBN) of W into a ring
// stage, zero-filling rows >= D and columns >= N.
template <typename T>
__device__ __forceinline__ void load_w_step(const Params& p, T* dst, int k0, int n0) {
  constexpr int V = vec_elems<T>();
  constexpr int kVecs = kBN / V;
  const T* w = static_cast<const T*>(p.w);
  for (int i = threadIdx.x; i < kBK * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * V;
    const int gk = k0 + r, gn = n0 + c;
    T* d = dst + r * ldw<T>() + c;
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

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) ln_matmul_kernel(Params p) {
  using Tl = Tiling<BM>;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / Tl::WN, wn = warp - (warp / Tl::WN) * Tl::WN;
  const int m0 = blockIdx.x * BM;
  const int rows_valid = min(BM, p.M - m0);
  const int n_tiles = (p.N + kBN - 1) / kBN;
  const int k_steps = (p.D + kBK - 1) / kBK;
  const int my_tiles = (n_tiles - (int)blockIdx.y + p.splits - 1) / p.splits;
  const int total = my_tiles * k_steps;

  const int w_off = h_bytes<T>(BM, p.ldh);
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  auto issue = [&](int s) {
    if (s < total) {
      const int tile = blockIdx.y + (s / k_steps) * p.splits;
      load_w_step<T>(p, reinterpret_cast<T*>(smem + w_off + (s % kStages) * w_stage_bytes<T>()),
                     (s % k_steps) * kBK, tile * kBN);
    }
    cp_async_commit();  // one group per step, empty past the end
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  normalize_rows<T, BM>(p, m0, blockIdx.y == 0);

  float acc[Tl::MT][Tl::NT][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int row_w = wm * Tl::MT * 16;  // the warp's first row in the tile
  const int col_w = wn * Tl::NT * 8;   // the warp's first column in the tile
  const T* bias = static_cast<const T*>(p.bias);
  T* y = static_cast<T*>(p.y);
  float bv[Tl::NT][2];  // the bias of the thread's output columns in the current tile

  for (int s = 0; s < total; ++s) {
    cp_async_wait_ring();  // step s has landed (for this thread)
    __syncthreads();       // ... for every thread; the h tile is complete; step s-1's stage is free
    issue(s + kStages - 1);
    const int ks = s % k_steps;
    const int k0 = ks * kBK;
    const int stage_off = w_off + (s % kStages) * w_stage_bytes<T>();
    const int n0 = (blockIdx.y + (s / k_steps) * p.splits) * kBN;  // the tile's first column
    if (bias && ks == 0) {
      // loaded a tile ahead of the epilogue, where its latency would stall
      // every store (the compiler may not move a load of bias past a store to y)
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + col_w + nt * 8 + (lane & 3) * 2 + e;
          bv[nt][e] = col < p.N ? to_f(bias[col]) : 0.0f;
        }
    }
    if constexpr (kBf16) {
      // The step's k16 slices, unrolled; each slice's fragments are loaded
      // one slice ahead (two register sets), so ldmatrix latency hides
      // behind the previous slice's mma.sync. kc is a multiple of 16.
      const int kc = min(kBK, p.dk - k0);
      const unsigned a_base = sbase + 2 * ((row_w + (lane & 15)) * p.ldh + k0 + (lane >> 4) * 8);
      const unsigned b_base =
          sbase + stage_off + 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * ldw<T>() + col_w + (lane >> 4) * 8);
      unsigned a[2][Tl::MT][4], bb[2][Tl::NT / 2][4];
      auto load_frags = [&](int buf, int kk) {
#pragma unroll
        for (int mt = 0; mt < Tl::MT; ++mt) ldsm_x4(a_base + 2 * (mt * 16 * p.ldh + kk), a[buf][mt]);
#pragma unroll
        for (int np = 0; np < Tl::NT / 2; ++np) ldsm_x4_trans(b_base + 2 * (kk * ldw<T>() + np * 16), bb[buf][np]);
      };
      load_frags(0, 0);
#pragma unroll
      for (int ki = 0; ki < kBK / 16; ++ki) {
        if (ki * 16 < kc) {
          if (ki + 1 < kBK / 16 && (ki + 1) * 16 < kc) load_frags((ki + 1) & 1, (ki + 1) * 16);
#pragma unroll
          for (int np = 0; np < Tl::NT / 2; ++np)
#pragma unroll
            for (int mt = 0; mt < Tl::MT; ++mt) {
              mma_bf16(acc[mt][2 * np], a[ki & 1][mt], bb[ki & 1][np][0], bb[ki & 1][np][1]);
              mma_bf16(acc[mt][2 * np + 1], a[ki & 1][mt], bb[ki & 1][np][2], bb[ki & 1][np][3]);
            }
        }
      }
    } else {
      const T* Hs = reinterpret_cast<const T*>(smem);
      const T* Ws = reinterpret_cast<const T*>(smem + stage_off);
      const int kc = min(kBK, p.D - k0);
      for (int kk = 0; kk < kc; ++kk) {
        float av[Tl::MT][2];
#pragma unroll
        for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            av[mt][half] = to_f(Hs[(row_w + mt * 16 + (lane >> 2) + half * 8) * p.ldh + k0 + kk]);
#pragma unroll
        for (int nt = 0; nt < Tl::NT; ++nt) {
          const T* wr = Ws + kk * ldw<T>() + col_w + nt * 8 + (lane & 3) * 2;
          const float b0 = to_f(wr[0]), b1 = to_f(wr[1]);
#pragma unroll
          for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              acc[mt][nt][2 * half] = fmaf(av[mt][half], b0, acc[mt][nt][2 * half]);
              acc[mt][nt][2 * half + 1] = fmaf(av[mt][half], b1, acc[mt][nt][2 * half + 1]);
            }
        }
      }
    }
    if (ks == k_steps - 1) {
      // epilogue straight from the accumulators: rows g and g + 8, columns 2*tig, +1
#pragma unroll
      for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row_w + mt * 16 + (lane >> 2) + half * 8;
            const int col = n0 + col_w + nt * 8 + (lane & 3) * 2;
            if (r < rows_valid) {
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float t = acc[mt][nt][2 * half + e];
                if (bias) t += bv[nt][e];
                if (p.act != kNone) t = activate(p.act, round_t<T>(t));
                v[e] = t;
              }
              T* yr = y + (long long)(m0 + r) * p.N;
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
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[mt][nt][2 * half + e] = 0.0f;
          }
    }
  }
}

template <typename T>
size_t smem_bytes(int bm, int ldh) {
  return (size_t)h_bytes<T>(bm, ldh) + (size_t)kStages * w_stage_bytes<T>();
}

template <typename T, int BM>
int launch(Params p, cudaStream_t stream) {
  static bool attr_set = false;
  auto kernel = ln_matmul_kernel<T, BM>;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = smem_bytes<T>(BM, p.ldh);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // Tile groups: the fewest (each re-normalizes its rows) whose grid fills at
  // least 85% of its last wave of resident blocks.
  const int slots = sms * per_sm;
  const int row_tiles = (p.M + BM - 1) / BM;
  const int n_tiles = (p.N + kBN - 1) / kBN;
  int splits = 1;
  for (; splits < n_tiles; ++splits) {
    const long long blocks = (long long)row_tiles * splits;
    const long long waves = (blocks + slots - 1) / slots;
    if (blocks >= 0.85 * waves * slots) break;
  }
  p.splits = splits;
  dim3 grid(row_tiles, splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(Params p, cudaStream_t stream) {
  p.ldh = p.dk + vec_elems<T>();
  if (smem_bytes<T>(32, p.ldh) <= kSmemLimit) return launch<T, 32>(p, stream);
  if (smem_bytes<T>(16, p.ldh) <= kSmemLimit) return launch<T, 16>(p, stream);
  return (int)cudaErrorInvalidValue;  // the h tile of 16 rows does not fit
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; norm: 0 = LayerNorm, 1 = Gemma RMSNorm;
// act: 0 none, 1 gelu, 2 quick_gelu, 3 gelu_pytorch_tanh. delta, beta and
// bias may be nullptr. All arrays contiguous; D a multiple of 8; x, delta
// and x_new 16-byte aligned. Returns a cudaError_t code.
extern "C" int fused_ln_matmul_fwd(int dtype, const void* x, const void* delta, const void* gamma,
                                   const void* beta, const void* w, const void* bias, void* x_new, void* y,
                                   int M, int D, int N, int norm, int act, float eps, int w_vec,
                                   void* stream) {
  if (D % 8 != 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  Params p{x, delta, gamma, beta, w, bias, x_new, y, M, D, N, norm, act, eps, w_vec, 1, (D + 15) / 16 * 16, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  if (dtype == 0) return dispatch<float>(p, s);
  return (int)cudaErrorInvalidValue;
}
