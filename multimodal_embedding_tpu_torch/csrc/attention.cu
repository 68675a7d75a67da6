// Fused softmax attention for Hopper (sm_90a), the CUDA counterpart of the
// Pallas TPU kernel multimodal_embedding_tpu/ops/attention_pallas.py:
// fused_attention (grid bodies _attn_kernel / _attn_kernel_packed over
// _attn_core).
//
// Semantics (identical to _attn_core):
//   - QK^T accumulates in f32;
//   - invalid logits are the finite -1e30; validity is key_mask != 0 and,
//     when causal, col <= row;
//   - the row max is taken over the whole key row; p = expf((l - m) * scale)
//     and its f32 row sum;
//   - p is cast to V's dtype before PV, PV accumulates in f32;
//   - the output is multiplied by any_valid / denom AFTER PV, so a fully
//     masked row is exact zeros;
//   - grouped-query attention: kv head = h / (H / KVH).
//
// One kernel serves both TPU layouts: q, k, v and o are addressed through
// (batch, token, head) element strides with a contiguous head dim, so the
// packed [B, T, H*Dh] projection output is read in place and [B, H, T, Dh]
// is the same code with other strides.
//
// Design: one block of 8 warps per (query tile, head, batch). Pass 1 writes
// the tile's f32 logits for the whole key row into dynamic shared memory
// (bf16 inputs: mma.sync m16n8k16 tensor-core tiles fed by ldmatrix; f32
// inputs: plain FMA, so no TF32 rounding), with key rows streamed kKC at a
// time through a cp.async ring of kStages buffers. Each warp then takes the
// exact two-sweep softmax of its rows (max, then exp and sum) and writes p
// in V's dtype over the same row of the buffer. Pass 2 streams V the same
// way and accumulates PV in registers. Shared-memory row strides are padded
// against bank conflicts. The tile height (64, 32 or 16 rows) is the largest
// whose rows*Tk*4 logits fit, preferring two blocks per SM. No online
// softmax: p is rounded against the true row max, as on the TPU.
//
// Bound on an H100 SXM at ViT-L batch 64, one layer (B 64, H 16, T 577,
// Dh 64): 4*64*16*577^2*64 = 87 GFLOP, 88 us at the 989 TFLOP/s bf16 dense
// peak; q, k, v and o are 4 * 64*577*1024*2 B = 0.30 GB, 90 us at 3.35 TB/s.
// The bound is about 90 us. This version re-reads its head's K and V from L2
// for every query tile and uses mma.sync, not wgmma/TMA; it is far from the
// bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;         // key rows staged per chunk
constexpr int kStages = 2;      // chunks in the shared-memory ring (kStages - 1 in flight)
constexpr int kMaxFrags = 8;    // 16x16 PV accumulator tiles per warp (bf16 path)
constexpr int kMaxOut = 64;     // PV outputs per thread (f32 path)
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;      // 227 KB, the per-block maximum
constexpr size_t kSmemTwoPerSM = 113 * 1024;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* km;
  void* o;
  int B, H, KVH, Tq, Tk, Dh;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, skmb;
  int causal;
  float scale;
  int bq;   // query rows per block (multiple of 16)
  int dp;   // head dim padded to a multiple of 16
  int ldq;  // shared-memory row stride of the q/k/v tiles: dp + 8 elements
  int lds;  // row stride of the f32 logits buffer: >= Tk and >= dp + 4, = 4 mod 32
};

// Row strides are padded so that consecutive rows start 16 bytes apart in
// the 128-byte bank cycle: the 16-byte row segments an ldmatrix reads
// then fall on distinct banks.
__host__ __device__ inline int pad_ldq(int dp) { return dp + 8; }
__host__ __device__ inline int pad_lds(int tkp, int dp) {
  const int c = tkp > dp + 4 ? tkp : dp + 4;
  return c + ((4 - c % 32) + 32) % 32;
}

__device__ __forceinline__ float to_f(float x) { return x; }

// Dynamic shared memory. Every shared-memory pointer is derived from this
// array in the scope that dereferences it, so the compiler emits shared loads
// (a pointer passed into a lambda would become a generic one).
extern __shared__ __align__(128) unsigned char smem[];

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16-byte asynchronous global->shared copy (cp.async); src_size 0 fills
// the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most kStages - 2 copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// Tensor-core tiles through explicit shared-memory addresses: ldmatrix loads
// 8x8 b16 matrices (x4: four of them, one row address per lane), and
// mma.m16n8k16 multiplies a 16x16 bf16 A fragment by a 16x8 B fragment into
// an f32 16x8 accumulator. Fragment layouts: PTX ISA, "mma.m16n8k16".
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

// Start copying a rows x dp tile of T from global rows (row stride in
// elements) into shared-memory rows ld elements apart, zero-filling rows >=
// rows_valid and columns >= dh. 16-byte vectors: the wrapper guarantees
// 16-byte aligned bases and strides that are multiples of 8 elements, and
// dh is a multiple of 8.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, long long row_stride, int rows,
                                                int rows_valid, int dh, int dp, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int vec_per_row = dp / V;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * V;
    const bool valid = r < rows_valid && c < dh;
    cp_async16(dst + r * ld + c, valid ? src + r * row_stride + c : src, valid);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stream rows [0, tkp) of a K or V operand through a ring of kStages
// shared-memory buffers (buffer j at byte offset buf_off + j * buf_bytes),
// kKC rows at a time: chunks i+1 .. i+kStages-1 are in flight while every
// warp computes on chunk i. compute(off, c0, kc) sees rows c0 .. c0+kc-1 at
// byte offset off of smem.
template <typename T, typename F>
__device__ __forceinline__ void stream_chunks(int buf_off, int buf_bytes, const T* src, long long stride,
                                              const Params& p, int tkp, F&& compute) {
  const int n = (tkp + kKC - 1) / kKC;
  auto issue = [&](int i) {
    if (i < n) {
      const int c0 = i * kKC, kc = min(kKC, tkp - c0);
      load_rows_async(reinterpret_cast<T*>(smem + buf_off + (i % kStages) * buf_bytes),
                      src + (long long)c0 * stride, stride, kc, min(kc, p.Tk - c0), p.Dh, p.dp, p.ldq);
    }
    cp_async_commit();  // one group per chunk, empty past the end
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait_ring();  // chunk i has landed (for this thread)
    __syncthreads();       // ... for every thread; and chunk i-1's buffer is free
    issue(i + kStages - 1);
    compute(buf_off + (i % kStages) * buf_bytes, i * kKC, min(kKC, tkp - i * kKC));
  }
  __syncthreads();  // the ring is free for the next stream
}

// kMasked: a key mask or causal masking is in play (else every key is valid
// and the softmax skips the validity tests).
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads) attn_kernel(Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * p.bq;
  const int rows_valid = min(p.bq, p.Tq - q0);
  const int tkp = (p.Tk + 15) / 16 * 16;

  // layout: S [bq][lds] f32 | Q [bq][ldq] T | K/V [kStages][kKC][ldq] T | rscale [bq] f32
  const int q_off = p.bq * p.lds * 4;
  const int kv_off = q_off + p.bq * p.ldq * (int)sizeof(T);
  const int kv_bytes = kKC * p.ldq * (int)sizeof(T);
  float* S = reinterpret_cast<float*>(smem);
  T* Qs = reinterpret_cast<T*>(smem + q_off);
  float* rscale = reinterpret_cast<float*>(smem + kv_off + kStages * kv_bytes);
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + kvh * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh;

  load_rows_async(Qs, qg, p.sqt, p.bq, rows_valid, p.Dh, p.dp, p.ldq);  // lands with chunk 0

  // ---- pass 1: logits S = Q K^T for the whole key row ----
  stream_chunks(kv_off, kv_bytes, kg, p.skt, p, tkp, [=](int off, int c0, int kc) {
    float* S = reinterpret_cast<float*>(smem);
    if constexpr (kBf16) {
      // warp tile: 16 query rows x 16 keys (two n8 halves), Dh in k-steps of 16
      const int tcols = kc / 16;
      const int nt = (p.bq / 16) * tcols;
      for (int t = warp; t < nt; t += kWarps) {
        const int tr = t / tcols, tc = t - (t / tcols) * tcols;
        float acc[2][4] = {};
        const unsigned a_addr = sbase + q_off + 2 * ((tr * 16 + (lane & 15)) * p.ldq + (lane >> 4) * 8);
        const unsigned b_addr =
            sbase + off + 2 * ((tc * 16 + (lane & 7) + ((lane >> 4) << 3)) * p.ldq + ((lane >> 3) & 1) * 8);
        for (int kk = 0; kk < p.dp; kk += 16) {
          unsigned a[4], bb[4];
          ldsm_x4(a_addr + 2 * kk, a);
          ldsm_x4(b_addr + 2 * kk, bb);
          mma_bf16(acc[0], a, bb[0], bb[1]);
          mma_bf16(acc[1], a, bb[2], bb[3]);
        }
        float* s0 = S + (tr * 16 + (lane >> 2)) * p.lds + c0 + tc * 16 + (lane & 3) * 2;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          *reinterpret_cast<float2*>(s0 + nb * 8) = make_float2(acc[nb][0], acc[nb][1]);
          *reinterpret_cast<float2*>(s0 + 8 * p.lds + nb * 8) = make_float2(acc[nb][2], acc[nb][3]);
        }
      }
    } else {
      const T* Ks = reinterpret_cast<const T*>(smem + off);
      const T* Qs = reinterpret_cast<const T*>(smem + q_off);
      for (int i = tid; i < p.bq * kc; i += kThreads) {
        const int j = i / p.bq, r = i - (i / p.bq) * p.bq;
        const T* qr = Qs + r * p.ldq;
        const T* kr = Ks + j * p.ldq;
        float s = 0.0f;
        for (int d = 0; d < p.Dh; ++d) s = fmaf(to_f(qr[d]), to_f(kr[d]), s);
        S[r * p.lds + c0 + j] = s;
      }
    }
  });

  // ---- exact softmax, one warp per row; p overwrites its own row ----
  // Each lane takes 4 consecutive logits per step (float4 reads).
  const int* kmr = p.km ? p.km + b * p.skmb : nullptr;
  for (int r = warp; r < p.bq; r += kWarps) {
    float* srow = S + r * p.lds;
    const int qrow = q0 + r;
    auto is_valid = [&](int j) {
      return j < p.Tk && (!kMasked || ((kmr == nullptr || kmr[j] != 0) && (!p.causal || j <= qrow)));
    };
    float m = kNegInf;
    int anyv = 0;
    for (int j = 4 * lane; j < p.Tk; j += 128) {
      const float4 l4 = *reinterpret_cast<const float4*>(srow + j);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = is_valid(j + e);
        m = fmaxf(m, valid ? lv[e] : kNegInf);
        anyv |= valid ? 1 : 0;
      }
    }
    m = warp_max(m);
    anyv = __any_sync(0xffffffffu, anyv);
    float sum = 0.0f;
    // In place: for bf16, p[j..j+3] land on the bytes of logits j/2..j/2+1,
    // which this warp read in this or an earlier step.
    for (int j0 = 0; j0 < tkp; j0 += 128) {
      const int j = j0 + 4 * lane;
      float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < p.Tk) {
        const float4 l4 = *reinterpret_cast<const float4*>(srow + j);
        const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < p.Tk) {
            const float l = is_valid(j + e) ? lv[e] : kNegInf;
            pv[e] = expf((l - m) * p.scale);
            sum += pv[e];
          }
        }
      }
      __syncwarp();
      if (j < tkp) {
        if constexpr (kBf16) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(pv[0], pv[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(pv[2], pv[3]);
          uint2 packed;
          packed.x = *reinterpret_cast<unsigned*>(&lo);
          packed.y = *reinterpret_cast<unsigned*>(&hi);
          *reinterpret_cast<uint2*>(reinterpret_cast<T*>(srow) + j) = packed;
        } else {
          *reinterpret_cast<float4*>(srow + j) = make_float4(pv[0], pv[1], pv[2], pv[3]);
        }
      }
      __syncwarp();
    }
    sum = warp_sum(sum);
    if (lane == 0) rscale[r] = (kMasked ? (anyv ? 1.0f : 0.0f) : 1.0f) / sum;
  }

  // ---- pass 2: O = P V, then the deferred 1/denom ----
  const int ld_p = kBf16 ? 2 * p.lds : p.lds;  // P row stride in T elements
  T* og = static_cast<T*>(p.o) + b * p.sob + h * p.soh + (long long)q0 * p.sot;

  if constexpr (kBf16) {
    // warp tiles: 16 query rows x 16 head-dim columns (two n8 halves)
    const int tcols = p.dp / 16;
    const int nt = (p.bq / 16) * tcols;
    float acc[kMaxFrags][2][4] = {};
    stream_chunks(kv_off, kv_bytes, vg, p.svt, p, tkp, [=, &acc](int off, int c0, int kc) {
#pragma unroll
      for (int f = 0; f < kMaxFrags; ++f) {
        const int t = warp + f * kWarps;
        if (t < nt) {
          const int tr = t / tcols, tc = t - (t / tcols) * tcols;
          const unsigned a_addr = sbase + 2 * ((tr * 16 + (lane & 15)) * ld_p + c0 + (lane >> 4) * 8);
          const unsigned b_addr =
              sbase + off + 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * p.ldq + tc * 16 + (lane >> 4) * 8);
          for (int kk = 0; kk < kc; kk += 16) {
            unsigned a[4], bb[4];
            ldsm_x4(a_addr + 2 * kk, a);
            ldsm_x4_trans(b_addr + 2 * kk * p.ldq, bb);
            mma_bf16(acc[f][0], a, bb[0], bb[1]);
            mma_bf16(acc[f][1], a, bb[2], bb[3]);
          }
        }
      }
    });
    // epilogue straight from the accumulators: row g and g + 8, columns 2*tig, +1
#pragma unroll
    for (int f = 0; f < kMaxFrags; ++f) {
      const int t = warp + f * kWarps;
      if (t < nt) {
        const int tr = t / tcols, tc = t - (t / tcols) * tcols;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int col = tc * 16 + nb * 8 + (lane & 3) * 2;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = tr * 16 + (lane >> 2) + half * 8;
            if (col < p.Dh && r < rows_valid) {
              const float sc = rscale[r];
              *reinterpret_cast<__nv_bfloat162*>(og + r * p.sot + col) =
                  __floats2bfloat162_rn(acc[f][nb][2 * half] * sc, acc[f][nb][2 * half + 1] * sc);
            }
          }
        }
      }
    }
  } else {
    const int nout = p.bq * p.Dh;
    float acc[kMaxOut];
#pragma unroll
    for (int f = 0; f < kMaxOut; ++f) acc[f] = 0.0f;
    stream_chunks(kv_off, kv_bytes, vg, p.svt, p, tkp, [=, &acc](int off, int c0, int kc) {
      const T* Vs = reinterpret_cast<const T*>(smem + off);
      const T* P = reinterpret_cast<const T*>(smem);
#pragma unroll
      for (int f = 0; f < kMaxOut; ++f) {
        const int e = tid + f * kThreads;
        if (e < nout) {
          const int r = e / p.Dh, d = e - (e / p.Dh) * p.Dh;
          const T* pr = P + r * ld_p + c0;
          float a = acc[f];
          for (int jj = 0; jj < kc; ++jj) a = fmaf(to_f(pr[jj]), to_f(Vs[jj * p.ldq + d]), a);
          acc[f] = a;
        }
      }
    });
#pragma unroll
    for (int f = 0; f < kMaxOut; ++f) {
      const int e = tid + f * kThreads;
      if (e < nout) {
        const int r = e / p.Dh, d = e - (e / p.Dh) * p.Dh;
        if (r < rows_valid) og[r * p.sot + d] = from_f<T>(acc[f] * rscale[r]);
      }
    }
  }
}

size_t smem_bytes(int bq, int lds, int ldq, int esize) {
  return (size_t)bq * lds * 4 + (size_t)bq * ldq * esize + (size_t)kStages * kKC * ldq * esize +
         (size_t)bq * 4;
}

// Largest query tile whose logits fit, preferring two blocks per SM; 0 when
// even 16 rows do not fit.
int pick_bq(int lds, int ldq, int esize) {
  const int cands[3] = {64, 32, 16};
  for (int i = 0; i < 3; ++i)
    if (smem_bytes(cands[i], lds, ldq, esize) <= kSmemTwoPerSM) return cands[i];
  for (int i = 0; i < 3; ++i)
    if (smem_bytes(cands[i], lds, ldq, esize) <= kSmemLimit) return cands[i];
  return 0;
}

template <typename T, bool kMasked>
int launch(Params p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attn_kernel<T, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int tkp = (p.Tk + 15) / 16 * 16;
  p.dp = (p.Dh + 15) / 16 * 16;
  p.ldq = pad_ldq(p.dp);
  p.lds = pad_lds(tkp, p.dp);
  p.bq = pick_bq(p.lds, p.ldq, (int)sizeof(T));
  if (p.bq == 0) return (int)cudaErrorInvalidValue;  // key row too long for shared memory
  const size_t smem = smem_bytes(p.bq, p.lds, p.ldq, (int)sizeof(T));
  dim3 grid((p.Tq + p.bq - 1) / p.bq, p.H, p.B);
  attn_kernel<T, kMasked><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; km is an int32
// [B, Tk] key mask (nullptr for none). Returns a cudaError_t code.
extern "C" int attention_fwd(int dtype, const void* q, const void* k, const void* v, const int* km,
                             void* o, int B, int H, int KVH, int Tq, int Tk, int Dh,
                             long long sqb, long long sqt, long long sqh, long long skb,
                             long long skt, long long skh, long long svb, long long svt,
                             long long svh, long long sob, long long sot, long long soh,
                             long long skmb, int causal, float scale, void* stream) {
  Params p{q, k, v, km, o, B, H, KVH, Tq, Tk, Dh, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
           sob, sot, soh, skmb, causal, scale, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = km != nullptr || causal;
  if (dtype == 1) return masked ? launch<__nv_bfloat16, true>(p, s) : launch<__nv_bfloat16, false>(p, s);
  if (dtype == 0) return masked ? launch<float, true>(p, s) : launch<float, false>(p, s);
  return (int)cudaErrorInvalidValue;
}
