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
// f32: flash_f32_kernel, the same data flow with f32 operands and 3xTF32
// tensor-core products. A block of 4 warps covers 64 query rows of one
// (head, batch), 16 rows a warp end to end; Q's tile is loaded once; K and V
// stream through a cp.async ring (3 stages at Dh 64, 2 above) in tiles of
// Bc = 32 keys; the same two sweeps (the exact row max and any-valid flag,
// then p against that max, its f32 sum and PV), the same causal tile skip,
// the logits, p and the output accumulator in registers. Every product runs
// as mma.sync.m16n8k8.f32.tf32.tf32.f32 three times: each f32 operand is
// split in registers, after its fragment is read from shared memory, into
// a TF32 high part (rounded to nearest, ties away) and a TF32 low part (the
// exact remainder, truncated), and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// accumulates in f32 (a_lo.b_lo, about 2^-22 of a.b, is dropped). Its error
// against f32 is about 2^-21 a product, against 2^-11 for one TF32 pass,
// which fails the 1e-5 gate (tests/torch_tf32.py emulates both). The tensor
// core's accumulator rounds toward zero: a chain of n accumulations drifts
// low by up to n ulps (on the card, PV over 4096 keys in one chain was
// 2.9e-5 low on average), so hi.hi and the cross terms accumulate in two
// chains of one key tile (PV) or 64 dims (QK^T) that are then added into
// f32 registers, rounded to nearest. p stays f32 into PV. Reduced dims are permuted inside each chunk of 8 so that
// every fragment is read without shuffles: k-index t of a chunk is element
// 2t, k-index t + 4 is element 2t + 1. So Q's and K's fragments are float2
// reads (rows kDp + 8 floats apart: a half-warp's reads hit 32 banks), and
// the C fragment of an n8 logit tile (keys 2t, 2t + 1 of rows g, g + 8) is
// the A fragment of its 8 keys in PV; V's fragment is two float reads
// (rows kDp + 4 floats apart). Key tiles wholly outside the batch row's
// first and last valid keys are skipped (their p are exact zeros): a
// left-padded prefill sweeps no pad tile. The head dim is padded to 64,
// 128 or 256 with zero columns. Shared memory does not grow with Tk (71 KB at Dh 64, 101 KB
// at Dh 128, 197 KB at Dh 256), so any key row length is taken.
// Consumers: Workload B's f32 models (cli/train_rl.py and cli/verify_rl.py
// at the default --model-size small, a --save-base base read back by
// --base-params, dryrun_multichip), and any f32 call of the attention
// routes.
// Bound on an H100 SXM at Qwen3-14B's heads in f32 (B 64, T 256, 40 over 8
// heads, Dh 128, causal): 43.1 GFLOP of causal work, 0.644 ms at the 67
// TFLOP/s f32 peak outside the tensor cores (0.261 ms at 165, a third of the
// 495 TFLOP/s TF32 peak: the three passes); q, k, v and o move 0.81 GB,
// 0.240 ms at 3.35 TB/s.
//
// Bound on an H100 SXM at ViT-L batch 64, one layer (B 64, H 16, T 577,
// Dh 64): 4*64*16*577^2*64 = 87 GFLOP, 88 us at the 989 TFLOP/s bf16 dense
// peak; q, k, v and o are 4 * 64*577*1024*2 B = 0.30 GB, 90 us at 3.35 TB/s.
// The bound is about 90 us (PERF.md has the kernel's time beside it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;  // buffers in the bf16 kernel's shared-memory ring (kStages - 1 in flight)
constexpr float kNegInf = -1e30f;

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
};

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
// Wait until at most N copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// f32: the flash-style kernel on 3xTF32 tensor-core products

// TF32 parts of an f32 for 3xTF32: hi is x rounded to nearest (ties away
// from zero) at 10 mantissa bits, lo the exact remainder x - hi truncated
// to 10 bits. Both are bit patterns the mma reads as .tf32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// d += a.b for a 16x8 tf32 A fragment and an 8x8 B fragment (fragment
// layouts: PTX ISA, "mma.m16n8k8").
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a.b in 3xTF32: hi.hi into big, the two cross terms into small (two
// independent accumulator chains).
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(small, al, bh[0], bh[1]);
  mma_tf32(small, ah, bl[0], bl[1]);
  mma_tf32(big, ah, bh[0], bh[1]);
}
// d += big + small in f32 registers, rounded to nearest: the tensor core's
// accumulator rounds toward zero, a bias that grows with the chain, so each
// chain spans one key tile or 64 dims and then lands here.
__device__ __forceinline__ void promote(float (&d)[4], float (&big)[4], float (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] += big[e] + small[e];
    big[e] = small[e] = 0.0f;
  }
}

template <int kDp>
struct F32Shape {
  static constexpr int kBc = 32;                  // keys per tile
  static constexpr int kStages = kDp <= 64 ? 3 : 2;
  static constexpr int kMinBlocks = kDp <= 64 ? 3 : kDp <= 128 ? 2 : 1;  // blocks per SM the smem allows
  static constexpr int kLdK = kDp + 8;            // Q and K row stride, floats: 8 mod 32
  static constexpr int kLdV = kDp + 4;            // V row stride: 4 mod 32
  static constexpr int kQBytes = kBr * kLdK * 4;
  static constexpr int kKBytes = kBc * kLdK * 4;
  static constexpr int kStageBytes = kKBytes + kBc * kLdV * 4;  // a K tile, then a V tile
  static constexpr int kSmem = kQBytes + kStages * kStageBytes;
};

template <int kDp, bool kMasked>
__global__ void __launch_bounds__(kFlashThreads, F32Shape<kDp>::kMinBlocks) flash_f32_kernel(Params p) {
  using Shape = F32Shape<kDp>;
  constexpr int kBc = Shape::kBc;
  constexpr int kS = Shape::kStages;
  constexpr int kLdK = Shape::kLdK;
  constexpr int kLdV = Shape::kLdV;
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

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;
  const int* kmr = kMasked && p.km ? p.km + b * p.skmb : nullptr;
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Key tiles [t0, t0 + n) hold every valid key below kend. A tile wholly
  // before the batch row's first valid key or after its last (a left-padded
  // prompt's pad tiles, a right-padded one's tail) gives its rows p = 0
  // exactly, so both sweeps skip it; a row with no valid key is zeros.
  int t0 = 0, n = (kend + kBc - 1) / kBc;
  if (kMasked && kmr != nullptr) {
    __shared__ int span[2 * kFlashWarps];
    int lo = kend, hi = -1;
    for (int c = threadIdx.x; c < kend; c += kFlashThreads)
      if (kmr[c] != 0) lo = min(lo, c), hi = max(hi, c);
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) span[warp] = lo, span[kFlashWarps + warp] = hi;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kFlashWarps; ++w) lo = min(lo, span[w]), hi = max(hi, span[kFlashWarps + w]);
    t0 = hi < 0 ? 0 : lo / kBc;
    n = hi < 0 ? 0 : hi / kBc + 1 - t0;
  }

  // layout: Q [kBr][kLdK] | stage j: K [kBc][kLdK], V [kBc][kLdV]
  auto stage_off = [](int s) { return Shape::kQBytes + (s % kS) * Shape::kStageBytes; };

  load_rows_async<kFlashThreads>(reinterpret_cast<float*>(smem), qg, p.sqt, kBr, rows_valid, p.Dh, kDp,
                                 kLdK);  // lands with step 0
  // Steps 0 .. n-1 are sweep 1 (K tile s), n .. 2n-1 sweep 2 (K and V tile
  // s - n); the ring runs on across the boundary.
  auto issue = [&](int s) {
    if (s < 2 * n) {
      const int c0 = (t0 + (s < n ? s : s - n)) * kBc;
      const int rv = min(kBc, p.Tk - c0);
      float* kd = reinterpret_cast<float*>(smem + stage_off(s));
      load_rows_async<kFlashThreads>(kd, kg + (long long)c0 * p.skt, p.skt, kBc, rv, p.Dh, kDp, kLdK);
      if (s >= n)
        load_rows_async<kFlashThreads>(kd + kBc * kLdK, vg + (long long)c0 * p.svt, p.svt, kBc, rv, p.Dh, kDp,
                                       kLdV);
    }
    cp_async_commit();  // one group per step, empty past the end
  };
  // Step s's tile has landed for every thread, and every warp is done with
  // step s-1's stage, which step s+kS-1's copies then overwrite.
  auto advance = [&](int s) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    issue(s + kS - 1);
  };

  // S = Q K^T for this warp's 16 rows and the kBc keys of the K tile at
  // byte offset koff. A fragment: Q rows g, g + 8 at columns kk + 2t, +1;
  // B fragment: K row (key) 8j + g at the same columns. Promoted every 64
  // dims.
  auto logits = [&](int koff, float (&s)[kNt][4]) {
    const float* qa = reinterpret_cast<const float*>(smem) + (warp * 16 + g) * kLdK + 2 * t;
    const float* kb = reinterpret_cast<const float*>(smem + koff) + g * kLdK + 2 * t;
    float big[kNt][4], small[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = big[j][e] = small[j][e] = 0.0f;
#pragma unroll 2
    for (int k0 = 0; k0 < kDp; k0 += 64) {
#pragma unroll
      for (int kk = k0; kk < k0 + 64; kk += 8) {
        const float2 x0 = *reinterpret_cast<const float2*>(qa + kk);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * kLdK + kk);
        unsigned ah[4], al[4];
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float2 y = *reinterpret_cast<const float2*>(kb + j * 8 * kLdK + kk);
          unsigned bh[2], bl[2];
          split_tf32(y.x, bh[0], bl[0]);
          split_tf32(y.y, bh[1], bl[1]);
          mma_3xtf32(big[j], small[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) promote(s[j], big[j], small[j]);
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
  for (int s = 0; s < kS - 1; ++s) issue(s);
  for (int s = 0; s < n; ++s) {
    advance(s);
    const int c0 = (t0 + s) * kBc;
    float sc[kNt][4];
    logits(stage_off(s), sc);
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
  for (int s = n; s < 2 * n; ++s) {
    advance(s);
    const int c0 = (t0 + s - n) * kBc;
    float sc[kNt][4];
    logits(stage_off(s), sc);
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
    // keys 8j + 2t and 8j + 2t + 1 are k-indices t and t + 4: logit tile
    // j's C fragment is the A fragment of its 8 keys
    unsigned ph[kNt][4], pl[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      split_tf32(sc[j][0], ph[j][0], pl[j][0]);
      split_tf32(sc[j][2], ph[j][1], pl[j][1]);
      split_tf32(sc[j][1], ph[j][2], pl[j][2]);
      split_tf32(sc[j][3], ph[j][3], pl[j][3]);
    }
    // V fragment: rows (keys) 8j + 2t and 8j + 2t + 1, column 8d + g; each
    // output tile's products over the key tile promoted once
    const float* vb = reinterpret_cast<const float*>(smem + stage_off(s) + Shape::kKBytes) + 2 * t * kLdV + g;
#pragma unroll
    for (int d = 0; d < kOt; ++d) {
      float big[4] = {0.0f, 0.0f, 0.0f, 0.0f}, small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float* vr = vb + 8 * j * kLdV + 8 * d;
        unsigned bh[2], bl[2];
        split_tf32(vr[0], bh[0], bl[0]);
        split_tf32(vr[kLdV], bh[1], bl[1]);
        mma_3xtf32(big, small, ph[j], pl[j], bh, bl);
      }
      promote(acc[d], big, small);
    }
  }

  // ---- epilogue: the deferred any_valid / denom, f32 pairs through the strides ----
  float rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    rs[r] = !kMasked || anyv[r] ? 1.0f / sum[r] : 0.0f;
  }
  float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh + (long long)q0 * p.sot;
#pragma unroll
  for (int d = 0; d < kOt; ++d) {
    const int col = d * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      if (col < p.Dh && row < rows_valid)
        *reinterpret_cast<float2*>(og + row * p.sot + col) =
            make_float2(acc[d][2 * r] * rs[r], acc[d][2 * r + 1] * rs[r]);
    }
  }
}

template <int kDp, bool kMasked>
int launch_flash_f32(const Params& p, cudaStream_t stream) {
  constexpr int smem_bytes = F32Shape<kDp>::kSmem;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<kDp, kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((p.Tq + kBr - 1) / kBr, p.H, p.B);
  flash_f32_kernel<kDp, kMasked><<<grid, kFlashThreads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int launch_f32(const Params& p, cudaStream_t stream) {
  if (p.Dh <= 64) return launch_flash_f32<64, kMasked>(p, stream);
  if (p.Dh <= 128) return launch_flash_f32<128, kMasked>(p, stream);
  if (p.Dh <= 256) return launch_flash_f32<256, kMasked>(p, stream);
  return (int)cudaErrorInvalidValue;
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
           sob, sot, soh, skmb, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = km != nullptr || causal;
  if (dtype == 1) return masked ? launch_bf16<true>(p, s) : launch_bf16<false>(p, s);
  if (dtype == 0) return masked ? launch_f32<true>(p, s) : launch_f32<false>(p, s);
  return (int)cudaErrorInvalidValue;
}
