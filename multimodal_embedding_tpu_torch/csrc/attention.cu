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
// Both kernels address q, k, v and o through (batch, token, head) element
// strides with a contiguous head dim, so the packed [B, T, H*Dh] projection
// output (and three views of a stacked q|k|v projection) is read in place and
// [B, H, T, Dh] is the same code with other strides.
//
// bf16: flash_kernel, flash-style, with logits, probabilities and the output
// accumulator in registers. One block of 4 warps covers 64 query rows of one
// (head, batch); each warp owns 16 rows end to end, so a row's max and sum
// are reduced across the 4 lanes of its quad with shuffles and never cross
// warps. Q's tile is loaded once into shared memory; K (and V) stream through
// a 2-stage cp.async ring in tiles of Bc = 32 keys. Two sweeps keep the exact
// row max and today's rounding points: sweep 1 computes S = Q K^T per tile
// with ldmatrix + mma.sync m16n8k16 and keeps only the running max and an
// any-valid flag per row; sweep 2 recomputes S, forms p = expf((l - m) *
// scale) in f32 against the final max, adds it to the f32 row sum, rounds it
// to bf16 in registers (the C fragments of two adjacent n8 logit tiles are
// the A fragment of the PV mma) and accumulates O += P V in f32 registers, V
// read by ldmatrix.trans. The head dim is a template parameter, padded to 64,
// 80, 128 or 256 with zero-filled columns. Under causal masking, key tiles
// wholly above the block's diagonal are skipped in both sweeps.
//
// What this does about the previous design's costs (a [rows, Tk] f32 logits
// buffer in shared memory): shared memory no longer grows with Tk (27 KB at
// Dh 64, 99 KB at Dh 256), so the query tile stays 64 rows, any Tk is taken,
// and five blocks (20 warps) are resident per SM up to Dh 80, four at Dh 128,
// two at Dh 256; no logit or probability makes a round trip through shared
// memory; the softmax is per warp, not a serial pass per row; one block-wide
// barrier per key tile remains, for the ring.
// What it still leaves: mma.sync, not wgmma, and cp.async, not TMA; K and V of
// a head re-read from L2 by every query tile (and by every head of a GQA
// group); QK^T computed twice (1.5x the tensor work of one pass), the price
// of the exact row max without online rescaling. Registers per thread
// (-Xptxas -v, printed by chip_smoke.py phase 1): 96 up to Dh 128 (the cap of
// five blocks per SM; no spill at Dh 64, 8 bytes at Dh 80 masked, 40-48 at
// Dh 128), 233-234 at Dh 256 with no spill.
//
// f32: attn_f32_kernel, the two-pass design of plain FMA (no TF32 rounding):
// one block of 8 warps per (query tile, head, batch) writes the tile's f32
// logits for the whole key row into dynamic shared memory, with key rows
// streamed kKC at a time through a cp.async ring; each warp takes the exact
// softmax of its rows (max, then exp and sum) and writes p over the same row;
// pass 2 streams V the same way and accumulates PV in registers. The tile
// height (64, 32 or 16 rows) is the largest whose rows*Tk*4 logits fit, so
// past about Tk 3300 the launch returns cudaErrorInvalidValue. Only tests and
// chip_smoke.py's f32 cases reach it.
//
// Bound on an H100 SXM at ViT-L batch 64, one layer (B 64, H 16, T 577,
// Dh 64): 4*64*16*577^2*64 = 87 GFLOP, 88 us at the 989 TFLOP/s bf16 dense
// peak; q, k, v and o are 4 * 64*577*1024*2 B = 0.30 GB, 90 us at 3.35 TB/s.
// The bound is about 90 us (PERF.md has the kernel's time beside it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;  // buffers in a shared-memory ring (kStages - 1 in flight)
constexpr float kNegInf = -1e30f;

// f32 two-pass kernel
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;       // key rows staged per chunk
constexpr int kMaxOut = 64;   // PV outputs per thread
constexpr size_t kSmemLimit = 232448;  // 227 KB, the per-block maximum
constexpr size_t kSmemTwoPerSM = 113 * 1024;

// bf16 flash kernel
constexpr int kFlashWarps = 4;
constexpr int kFlashThreads = kFlashWarps * 32;
constexpr int kBr = kFlashWarps * 16;  // query rows per block, 16 per warp

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
  // f32 kernel only
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

// Dynamic shared memory. Every shared-memory pointer is derived from this
// array in the scope that dereferences it, so the compiler emits shared loads
// (a pointer passed into a lambda would become a generic one).
extern __shared__ __align__(128) unsigned char smem[];

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
// Two floats rounded to bf16, the first in the low half (the lower column of
// an mma fragment register).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Start copying a rows x dp tile of T from global rows (row stride in
// elements) into shared-memory rows ld elements apart, zero-filling rows >=
// rows_valid and columns >= dh, with kN threads. 16-byte vectors: the wrapper
// guarantees 16-byte aligned bases and strides that are multiples of 8
// elements, and dh is a multiple of 8.
template <int kN, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, long long row_stride, int rows,
                                                int rows_valid, int dh, int dp, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int vec_per_row = dp / V;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += kN) {
    const int r = i / vec_per_row;
    const int c = (i - r * vec_per_row) * V;
    const bool valid = r < rows_valid && c < dh;
    cp_async16(dst + r * ld + c, valid ? src + r * row_stride + c : src, valid);
  }
}

// ---------------------------------------------------------------------------
// bf16: the flash-style kernel

template <int kDp>
struct FlashShape {
  static constexpr int kBc = 32;  // keys per tile
  // least blocks per SM the register allocation must allow (__launch_bounds__);
  // Dh 256 needs its 128 f32 accumulators a thread, so no cap there
  static constexpr int kMinBlocks = kDp > 128 ? 1 : 5;
  static constexpr int kLd = kDp + 8;              // shared-memory row stride, elements
  static constexpr int kQBytes = kBr * kLd * 2;
  static constexpr int kTileBytes = kBc * kLd * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // a K tile, then a V tile
  static constexpr int kSmem = kQBytes + kStages * kStageBytes;
};

// kMasked: a key mask or causal masking is in play (else every key < Tk is
// valid and the softmax skips the mask tests).
template <int kDp, bool kMasked>
__global__ void __launch_bounds__(kFlashThreads, FlashShape<kDp>::kMinBlocks) flash_kernel(Params p) {
  using Shape = FlashShape<kDp>;
  using bf16 = __nv_bfloat16;
  constexpr int kBc = Shape::kBc;
  constexpr int kLd = Shape::kLd;
  constexpr int kNt = kBc / 8;  // n8 tiles of a warp's 16 x kBc logit tile
  constexpr int kOt = kDp / 8;  // n8 tiles of its 16 x kDp output
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row (and row + 8), column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kBr;
  const int rows_valid = min(kBr, p.Tq - q0);
  // causal: keys past the block's last query row are invalid for every row
  const int kend = kMasked && p.causal ? min(p.Tk, q0 + rows_valid) : p.Tk;
  const int n = (kend + kBc - 1) / kBc;  // key tiles per sweep

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kvh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kvh * p.svh;
  const int* kmr = kMasked && p.km ? p.km + b * p.skmb : nullptr;
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // layout: Q [kBr][kLd] | stage j: K [kBc][kLd], V [kBc][kLd]
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto stage_off = [](int s) { return Shape::kQBytes + (s % kStages) * Shape::kStageBytes; };

  load_rows_async<kFlashThreads>(reinterpret_cast<bf16*>(smem), qg, p.sqt, kBr, rows_valid, p.Dh, kDp,
                                 kLd);  // lands with step 0
  // Steps 0 .. n-1 are sweep 1 (K tile s), n .. 2n-1 sweep 2 (K and V tile
  // s - n); the ring runs on across the boundary.
  auto issue = [&](int s) {
    if (s < 2 * n) {
      const int c0 = (s < n ? s : s - n) * kBc;
      const int rv = min(kBc, p.Tk - c0);
      bf16* kd = reinterpret_cast<bf16*>(smem + stage_off(s));
      load_rows_async<kFlashThreads>(kd, kg + (long long)c0 * p.skt, p.skt, kBc, rv, p.Dh, kDp, kLd);
      if (s >= n)
        load_rows_async<kFlashThreads>(kd + kBc * kLd, vg + (long long)c0 * p.svt, p.svt, kBc, rv, p.Dh, kDp,
                                       kLd);
    }
    cp_async_commit();  // one group per step, empty past the end
  };
  // Step s's tile has landed for every thread, and every warp is done with
  // step s-1's stage, which step s+1's copies then overwrite.
  auto advance = [&](int s) {
    cp_async_wait_ring();
    __syncthreads();
    issue(s + 1);
  };

  // S = Q K^T for this warp's 16 rows and the kBc keys of the K tile at kb.
  const unsigned a_addr = sbase + 2 * ((warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8);
  const unsigned k_lane = 2 * (((lane & 7) + ((lane >> 4) << 3)) * kLd + ((lane >> 3) & 1) * 8);
  auto logits = [&](unsigned kb, float (&s)[kNt][4]) {
#pragma unroll
    for (int j = 0; j < kNt; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kDp; kk += 16) {
      unsigned a[4];
      ldsm_x4(a_addr + 2 * kk, a);
#pragma unroll
      for (int j = 0; j < kNt; j += 2) {
        unsigned bb[4];
        ldsm_x4(kb + k_lane + 2 * (j * 8 * kLd + kk), bb);
        mma_bf16(s[j], a, bb[0], bb[1]);
        mma_bf16(s[j + 1], a, bb[2], bb[3]);
      }
    }
  };
  // Element e of n8 tile j of a thread's fragment: row g + 8 * (e >> 1),
  // key c0 + 8 * j + 2 * t + (e & 1).
  auto valid = [&](int c, int r) {
    return c < p.Tk && (!kMasked || ((kmr == nullptr || kmr[c] != 0) && (!p.causal || c <= qrow[r])));
  };

  // ---- sweep 1: the row max and any-valid flag ----
  float m[2] = {kNegInf, kNegInf};
  int anyv[2] = {0, 0};
  issue(0);
  for (int s = 0; s < n; ++s) {
    advance(s);
    const int c0 = s * kBc;
    float sc[kNt][4];
    logits(sbase + stage_off(s), sc);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = valid(c0 + 8 * j + 2 * t + (e & 1), e >> 1);
        m[e >> 1] = fmaxf(m[e >> 1], v ? sc[j][e] : kNegInf);
        anyv[e >> 1] |= v ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
      anyv[r] |= __shfl_xor_sync(0xffffffffu, anyv[r], o);
    }
  }

  // ---- sweep 2: p against the final max, its f32 sum, O += P V ----
  float acc[kOt][4];
#pragma unroll
  for (int d = 0; d < kOt; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float sum[2] = {0.0f, 0.0f};
  const unsigned v_lane = 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8);
  for (int s = n; s < 2 * n; ++s) {
    advance(s);
    const int c0 = (s - n) * kBc;
    const unsigned kb = sbase + stage_off(s);
    float sc[kNt][4];
    logits(kb, sc);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        const float l = valid(c, e >> 1) ? sc[j][e] : kNegInf;
        const float pe = c < p.Tk ? expf((l - m[e >> 1]) * p.scale) : 0.0f;
        sum[e >> 1] += pe;
        sc[j][e] = pe;
      }
    }
    const unsigned vb = kb + Shape::kTileBytes + v_lane;
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      // the C fragments of logit tiles 2kk and 2kk+1 are the A fragment of keys 16kk .. 16kk+15
      const unsigned a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < kOt; d += 2) {
        unsigned bb[4];
        ldsm_x4_trans(vb + 2 * (kk * 16 * kLd + d * 8), bb);
        mma_bf16(acc[d], a, bb[0], bb[1]);
        mma_bf16(acc[d + 1], a, bb[2], bb[3]);
      }
    }
  }

  // ---- epilogue: the deferred any_valid / denom, bf16 pairs through the strides ----
  float rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    rs[r] = (kMasked ? (anyv[r] ? 1.0f : 0.0f) : 1.0f) / sum[r];
  }
  bf16* og = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh + (long long)q0 * p.sot;
#pragma unroll
  for (int d = 0; d < kOt; ++d) {
    const int col = d * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      if (col < p.Dh && row < rows_valid)
        *reinterpret_cast<__nv_bfloat162*>(og + row * p.sot + col) =
            __floats2bfloat162_rn(acc[d][2 * r] * rs[r], acc[d][2 * r + 1] * rs[r]);
    }
  }
}

template <int kDp, bool kMasked>
int launch_flash(const Params& p, cudaStream_t stream) {
  constexpr int smem_bytes = FlashShape<kDp>::kSmem;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<kDp, kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((p.Tq + kBr - 1) / kBr, p.H, p.B);
  flash_kernel<kDp, kMasked><<<grid, kFlashThreads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int launch_bf16(const Params& p, cudaStream_t stream) {
  if (p.Dh <= 64) return launch_flash<64, kMasked>(p, stream);
  if (p.Dh <= 80) return launch_flash<80, kMasked>(p, stream);
  if (p.Dh <= 128) return launch_flash<128, kMasked>(p, stream);
  if (p.Dh <= 256) return launch_flash<256, kMasked>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32: the two-pass kernel

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
template <typename F>
__device__ __forceinline__ void stream_chunks(int buf_off, int buf_bytes, const float* src, long long stride,
                                              const Params& p, int tkp, F&& compute) {
  const int n = (tkp + kKC - 1) / kKC;
  auto issue = [&](int i) {
    if (i < n) {
      const int c0 = i * kKC, kc = min(kKC, tkp - c0);
      load_rows_async<kThreads>(reinterpret_cast<float*>(smem + buf_off + (i % kStages) * buf_bytes),
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
template <bool kMasked>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(Params p) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * p.bq;
  const int rows_valid = min(p.bq, p.Tq - q0);
  const int tkp = (p.Tk + 15) / 16 * 16;

  // layout: S [bq][lds] f32 | Q [bq][ldq] | K/V [kStages][kKC][ldq] | rscale [bq] f32
  const int q_off = p.bq * p.lds * 4;
  const int kv_off = q_off + p.bq * p.ldq * 4;
  const int kv_bytes = kKC * p.ldq * 4;
  float* S = reinterpret_cast<float*>(smem);
  float* Qs = reinterpret_cast<float*>(smem + q_off);
  float* rscale = reinterpret_cast<float*>(smem + kv_off + kStages * kv_bytes);

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;

  load_rows_async<kThreads>(Qs, qg, p.sqt, p.bq, rows_valid, p.Dh, p.dp, p.ldq);  // lands with chunk 0

  // ---- pass 1: logits S = Q K^T for the whole key row ----
  stream_chunks(kv_off, kv_bytes, kg, p.skt, p, tkp, [=](int off, int c0, int kc) {
    float* S = reinterpret_cast<float*>(smem);
    const float* Ks = reinterpret_cast<const float*>(smem + off);
    const float* Qs = reinterpret_cast<const float*>(smem + q_off);
    for (int i = tid; i < p.bq * kc; i += kThreads) {
      const int j = i / p.bq, r = i - (i / p.bq) * p.bq;
      const float* qr = Qs + r * p.ldq;
      const float* kr = Ks + j * p.ldq;
      float s = 0.0f;
      for (int d = 0; d < p.Dh; ++d) s = fmaf(qr[d], kr[d], s);
      S[r * p.lds + c0 + j] = s;
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
      if (j < tkp) *reinterpret_cast<float4*>(srow + j) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      __syncwarp();
    }
    sum = warp_sum(sum);
    if (lane == 0) rscale[r] = (kMasked ? (anyv ? 1.0f : 0.0f) : 1.0f) / sum;
  }

  // ---- pass 2: O = P V, then the deferred 1/denom ----
  float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh + (long long)q0 * p.sot;
  const int nout = p.bq * p.Dh;
  float acc[kMaxOut];
#pragma unroll
  for (int f = 0; f < kMaxOut; ++f) acc[f] = 0.0f;
  stream_chunks(kv_off, kv_bytes, vg, p.svt, p, tkp, [=, &acc](int off, int c0, int kc) {
    const float* Vs = reinterpret_cast<const float*>(smem + off);
    const float* P = reinterpret_cast<const float*>(smem);
#pragma unroll
    for (int f = 0; f < kMaxOut; ++f) {
      const int e = tid + f * kThreads;
      if (e < nout) {
        const int r = e / p.Dh, d = e - (e / p.Dh) * p.Dh;
        const float* pr = P + r * p.lds + c0;
        float a = acc[f];
        for (int jj = 0; jj < kc; ++jj) a = fmaf(pr[jj], Vs[jj * p.ldq + d], a);
        acc[f] = a;
      }
    }
  });
#pragma unroll
  for (int f = 0; f < kMaxOut; ++f) {
    const int e = tid + f * kThreads;
    if (e < nout) {
      const int r = e / p.Dh, d = e - (e / p.Dh) * p.Dh;
      if (r < rows_valid) og[r * p.sot + d] = acc[f] * rscale[r];
    }
  }
}

size_t smem_bytes_f32(int bq, int lds, int ldq) {
  return (size_t)bq * lds * 4 + (size_t)bq * ldq * 4 + (size_t)kStages * kKC * ldq * 4 + (size_t)bq * 4;
}

// Largest query tile whose logits fit, preferring two blocks per SM; 0 when
// even 16 rows do not fit.
int pick_bq(int lds, int ldq) {
  const int cands[3] = {64, 32, 16};
  for (int i = 0; i < 3; ++i)
    if (smem_bytes_f32(cands[i], lds, ldq) <= kSmemTwoPerSM) return cands[i];
  for (int i = 0; i < 3; ++i)
    if (smem_bytes_f32(cands[i], lds, ldq) <= kSmemLimit) return cands[i];
  return 0;
}

template <bool kMasked>
int launch_f32(Params p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel<kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int tkp = (p.Tk + 15) / 16 * 16;
  p.dp = (p.Dh + 15) / 16 * 16;
  p.ldq = pad_ldq(p.dp);
  p.lds = pad_lds(tkp, p.dp);
  p.bq = pick_bq(p.lds, p.ldq);
  if (p.bq == 0) return (int)cudaErrorInvalidValue;  // key row too long for shared memory
  const size_t smem = smem_bytes_f32(p.bq, p.lds, p.ldq);
  dim3 grid((p.Tq + p.bq - 1) / p.bq, p.H, p.B);
  attn_f32_kernel<kMasked><<<grid, kThreads, smem, stream>>>(p);
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
  if (dtype == 1) return masked ? launch_bf16<true>(p, s) : launch_bf16<false>(p, s);
  if (dtype == 0) return masked ? launch_f32<true>(p, s) : launch_f32<false>(p, s);
  return (int)cudaErrorInvalidValue;
}
