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
// accumulator in registers, in one of two bodies chosen by the head dim
// alone (ops/attention_cuda.py:uses_wgmma decides, the wrapper passes the
// body):
//
// Dh <= 80, padded to 64 or 80 (CLIP, SigLIP, ViT-H, ColPali's SigLIP-448):
// the warpgroup body. Both products are wgmma. A block has two warpgroups
// on 128 query rows of one (head, batch), which share every K and V tile
// the block copies (half the L2 traffic of 64-row blocks), or one warpgroup
// on 64 rows where the rows fit in 64 (text towers, the MAP head). Q's tile
// is loaded once; K and V stream through cp.async rings in tiles of Bc = 64
// keys, each thread writing its 16-byte chunks where wgmma's descriptors
// read them: head dims 0-63 as a 128B-swizzled region of 128-byte rows,
// dims 64-79 (Dh 72, 80) as a 32B-swizzled region of 32-byte rows after
// it. S = Q K^T is wgmma.m64n64k16 with both operands in shared memory
// (K-major), 4 or 5 k steps a tile. O += P V is the register-A wgmma: p's
// f32 C fragments, rounded to bf16, are A (an accumulator's two adjacent n8
// column groups are an A fragment's 16 keys, as in the mma.sync body), and
// V is an MN-major B read with the transpose bit (m64n64k16 over dims 0-63,
// m64n16k16 over 64-79). A tile's PV runs on into the next step, whose
// QK^T wait retires it. The copies run one step ahead with one warpgroup
// (rings of 2 K and 3 V tiles), two with two (3 and 4). Sweep 2 starts
// with the last tile of sweep 1, whose logits are still in registers: its
// QK^T would give the same bits. With a key mask, key tiles wholly outside
// the batch row's valid keys are skipped, as the f32 body does (a caption
// batch is mostly padding); their p are exact zeros. The MN-major
// descriptors set their leading and stride byte offsets equal, so which of
// the two the hardware reads as the key stride does not matter: N spans one
// swizzle atom (64 dims at 128B, 16 at 32B).
// What wgmma changed: ViT-L b64 [64,577,16x64] 0.93 -> about 0.48 ms,
// SigLIP-400M b32 [32,729,16x72] 0.77 -> about 0.46 ms on an H100 SXM
// (PERF.md has each shape). Sweep 2 holds about 3/4 of the time; the body
// is bound by instruction issue (about 12 instructions a logit for p, the
// accurate expf 9 of them) and by the warpgroups of a block running in step,
// so little of one's softmax hides another's products. Tried and no
// faster: 64-row blocks everywhere (twice the L2 traffic); the next tile's
// QK^T issued before the softmax (a second logit buffer: one block a SM, or
// spills at two; in sweep 1 alone, no gain); a third tile of copy lookahead.
//
// Dh 128 and 256 (Qwen3, Gemma, Kimi's MLA at q/k 192): the mma.sync body.
// One block of 4 warps covers 64 query rows; each warp owns 16 rows end to
// end. Q's tile is loaded once; K (and V) stream through a 2-stage cp.async
// ring in tiles of Bc = 32 keys; products are ldmatrix + mma.sync m16n8k16,
// V read by ldmatrix.trans. At Dh 256 a 64-row wgmma accumulator alone would
// take 128 registers a thread: that wants a tile plan of its own.
//
// Both bodies keep the same two sweeps and rounding points: sweep 1 computes
// S = Q K^T per tile and keeps only the running max and an any-valid flag
// per row; sweep 2 forms p = expf((l - m) * scale) in f32 against the final
// max, adds it to the f32 row sum, rounds it to bf16 once and accumulates
// O += P V in f32. A row's max and sum are reduced across the 4 lanes of its
// quad with shuffles and never cross warps. Unused head dims are zero-filled
// columns. Under causal masking, key tiles wholly above the block's
// diagonal are skipped in both sweeps. Shared memory does not grow with Tk
// (49/61 KB at Dh 64/80 with one warpgroup, 73/91 KB with two, 99 KB at Dh
// 256), so any Tk is taken.
// What is still left: TMA with a producer warp in place of the threads'
// cp.async; overlapping one warpgroup's softmax with another's products;
// one QK^T pass (online softmax) in place of two, which moves where p is
// rounded; K and V of a head re-read from L2 by every query tile (and every
// head of a GQA group). Registers per thread (-Xptxas -v, printed by
// chip_smoke.py phase 1; PERF.md's kernel table): the warpgroup body is
// capped at 128 (four warpgroups a SM) and spills nothing; at Dh 80 ptxas
// reports its wgmmas serialized for want of registers (C7512); a build of
// the same body without that report measured the same. 96 at Dh 128 (5
// blocks), none at Dh 256.
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

#include <type_traits>

namespace {

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
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  cp_async16(static_cast<unsigned>(__cvta_generic_to_shared(dst)), src, valid);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
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
// bf16: what both bodies share

// A row's max and any-valid flag over the 4 lanes of its quad.
__device__ __forceinline__ void quad_max(float (&m)[2], int (&anyv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
      anyv[r] |= __shfl_xor_sync(0xffffffffu, anyv[r], o);
    }
  }
}

// A row's f32 sum over the 4 lanes of its quad, then the deferred
// any_valid / denom (0 for a row with no valid key, whose sum may be 0).
template <bool kMasked>
__device__ __forceinline__ void row_scale(float (&sum)[2], const int (&anyv)[2], float (&rs)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    rs[r] = !kMasked || anyv[r] ? 1.0f / sum[r] : 0.0f;
  }
}

// Columns col, col + 1 of rows r0 and r0 + 8 of the block's output (an
// accumulator's c0, c1 and c2, c3), times the rows' rs, as bf16 pairs
// through the strides.
__device__ __forceinline__ void store_rows(__nv_bfloat16* og, const Params& p, int r0, int col, int rows_valid,
                                           float c0, float c1, float c2, float c3, const float (&rs)[2]) {
  if (col >= p.Dh) return;
  if (r0 < rows_valid)
    *reinterpret_cast<__nv_bfloat162*>(og + r0 * p.sot + col) = __floats2bfloat162_rn(c0 * rs[0], c1 * rs[0]);
  if (r0 + 8 < rows_valid)
    *reinterpret_cast<__nv_bfloat162*>(og + (r0 + 8) * p.sot + col) = __floats2bfloat162_rn(c2 * rs[1], c3 * rs[1]);
}

// ---------------------------------------------------------------------------
// bf16, Dh 128 and 256: the mma.sync body

template <int kDp>
struct MmaShape {
  static constexpr int kThreads = kFlashThreads;
  static constexpr int kRows = kBr;   // query rows of a block, 16 a warp
  static constexpr int kBc = 32;      // keys per tile
  static constexpr int kStages = 2;   // ring buffers, one tile in flight
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
__device__ __forceinline__ void mma_body(const Params& p) {
  using Shape = MmaShape<kDp>;
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
  auto stage_off = [](int s) { return Shape::kQBytes + (s % Shape::kStages) * Shape::kStageBytes; };

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
    cp_async_wait<0>();
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
  quad_max(m, anyv);

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
  row_scale<kMasked>(sum, anyv, rs);
  bf16* og = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh + (long long)q0 * p.sot;
#pragma unroll
  for (int d = 0; d < kOt; ++d)
    store_rows(og, p, warp * 16 + g, d * 8 + 2 * t, rows_valid, acc[d][0], acc[d][1], acc[d][2], acc[d][3], rs);
}

// ---------------------------------------------------------------------------
// bf16, Dh <= 80: the warpgroup body (wgmma)

template <int kDp, int kWgs>
struct WgShape {
  static_assert(kDp == 64 || kDp == 80, "the warpgroup body pads Dh to 64 or 80");
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kRows = 64 * kWgs;       // query rows of a block, 64 a warpgroup
  static constexpr int kBc = 64;                // keys per tile
  static constexpr int kAhead = kWgs;           // steps whose copies are in flight ahead of the one computed
  static constexpr int kKStages = kAhead + 1;   // K ring
  static constexpr int kVStages = kAhead + 2;   // V ring: a tile's PV runs on into the next step
  static constexpr int kMinBlocks = 4 / kWgs;   // 128 registers a thread
  static constexpr int kQBytes = kRows * kDp * 2;
  static constexpr int kTileBytes = kBc * kDp * 2;
  static constexpr int kSmem = 1024 + kQBytes + (kKStages + kVStages) * kTileBytes;  // from a 1024-aligned base
};

// The shared-memory layout wgmma reads, for a tile of R rows of kDp head
// dims: dims 0-63 are a region of R rows x 128 bytes in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), dims 64-79 a
// region of R rows x 32 bytes after it in the 32-byte swizzle (chunk c - 8
// at (c - 8) ^ (r / 4 % 2)). Both start 1024-aligned when the tile does, as
// the swizzles' address bits require.
//
// Start copying such a tile from global rows (row stride ld elements) to
// shared address dst with kN threads, zero-filling rows >= rows_valid and
// columns >= dh. Thread i takes chunk i % 8 of rows i / 8 + j kN / 8 of the
// 128B region (a row's 128 bytes from 8 neighbouring threads, its chunk's
// swizzled place the same in every such row) and, at Dh 80, chunk i % 2 of
// row i / 2 of the 32B region.
template <int R, int kDp, int kN>
__device__ __forceinline__ void load_tile_wg(unsigned dst, const __nv_bfloat16* src, long long ld, int rows_valid,
                                             int dh) {
  constexpr int kStep = kN / 8;
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const bool c_ok = 8 * c < dh;
  const unsigned d0 = dst + r0 * 128 + ((c ^ (r0 & 7)) << 4);
  const __nv_bfloat16* s0 = src + r0 * ld + 8 * c;
#pragma unroll
  for (int j = 0; j < R / kStep; ++j) {
    const bool valid = c_ok && r0 + j * kStep < rows_valid;
    cp_async16(d0 + j * kStep * 128, valid ? s0 + j * kStep * ld : src, valid);
  }
  if constexpr (kDp == 80) {
    const int c1 = threadIdx.x & 1, r1 = threadIdx.x >> 1;
#pragma unroll
    for (int j = 0; j < (2 * R + kN - 1) / kN; ++j) {
      const int r = r1 + j * (kN / 2);
      if (2 * R % kN != 0 && r >= R) break;
      const bool valid = 64 + 8 * c1 < dh && r < rows_valid;
      cp_async16(dst + R * 128 + r * 32 + ((c1 ^ ((r >> 2) & 1)) << 4), valid ? src + r * ld + 64 + 8 * c1 : src,
                 valid);
    }
  }
}

// A wgmma matrix descriptor: the start address >> 4 (bits 0-13), the leading
// and stride byte offsets >> 4 (bits 16-29, 32-45), base offset 0 (the
// regions are aligned to their swizzle's repeat), the swizzle mode (bits
// 62-63: 1 = 128B, 3 = 32B). K-major (Q and K, head dims contiguous): the
// stride byte offset is the step between 8-row core matrices (1024 at 128B,
// 256 at 32B), the leading one unused; a k step of 16 dims advances the start
// by 32 bytes inside a 128-byte row, and the hardware applies the swizzle to
// the address it forms. MN-major (V, read with the transpose bit: keys are
// the reduced dim, head dims contiguous): N spans one swizzle atom, so only
// the step between 8-key groups is read, and both offsets are set to it.
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lbo, unsigned sbo, unsigned mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)mode << 62);
}
constexpr unsigned kSw128 = 1, kSw32 = 3;

// d (+)= A B for a 64 x 64 f32 accumulator, A and B K-major in shared memory
// (descriptors da, db); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d += A B for a 64 x 64 f32 accumulator, A a bf16 fragment in registers
// (the mma.m16n8k16 A layout, each warp its 16 rows), B MN-major in shared
// memory (transpose bit set); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// The same for a 64 x 16 accumulator (head dims 64-79).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const unsigned (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each thread fences its landed copies before the barrier.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <int kDp, bool kMasked, int kWgs>
__device__ __forceinline__ void wg_body(const Params& p) {
  using Shape = WgShape<kDp, kWgs>;
  using bf16 = __nv_bfloat16;
  constexpr int kN = Shape::kThreads;
  constexpr int kRows = Shape::kRows;
  constexpr int kBc = Shape::kBc;
  constexpr int kTile = Shape::kTileBytes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;               // warpgroup: rows 64 wg .. 64 wg + 63 of the block
  const int g = lane >> 2, t = lane & 3;  // accumulator row (and row + 8) of the warp's 16, column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = blockIdx.x * kRows;
  const int rows_valid = min(kRows, p.Tq - q0);
  // causal: keys past the block's last query row are invalid for every row
  const int kend = kMasked && p.causal ? min(p.Tk, q0 + rows_valid) : p.Tk;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh + (long long)q0 * p.sqt;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kvh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kvh * p.svh;
  const int* kmr = kMasked && p.km ? p.km + b * p.skmb : nullptr;
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Key tiles [t0, t0 + n) hold every valid key below kend. A tile wholly
  // before the batch row's first valid key or after its last (a caption's
  // padding) gives its rows p = 0 exactly, so both sweeps skip it (the f32
  // body's rule); a batch row with no valid key is zeros.
  int t0 = 0, n = (kend + kBc - 1) / kBc;
  if (kMasked && kmr != nullptr) {
    __shared__ int span[2 * kN / 32];
    int lo = kend, hi = -1;
    for (int c = threadIdx.x; c < kend; c += kN)
      if (kmr[c] != 0) lo = min(lo, c), hi = max(hi, c);
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) span[warp] = lo, span[kN / 32 + warp] = hi;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kN / 32; ++w) lo = min(lo, span[w]), hi = max(hi, span[kN / 32 + w]);
    t0 = hi < 0 ? 0 : lo / kBc;
    n = hi < 0 ? 0 : hi / kBc + 1 - t0;
  }
  bf16* og = static_cast<bf16*>(p.o) + b * p.sob + h * p.soh + (long long)q0 * p.sot;
  if (n == 0) {
    const float zero[2] = {0.0f, 0.0f};
    for (int col = 2 * t; col < kDp; col += 8)
      store_rows(og, p, warp * 16 + g, col, rows_valid, 0.0f, 0.0f, 0.0f, 0.0f, zero);
    return;
  }

  // layout (from a 1024-aligned base): Q [kRows rows] | K ring [kKStages][kBc rows] | V ring [kVStages][kBc rows]
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned q_s = (raw + 1023) & ~1023u;
  const unsigned k_ring = q_s + Shape::kQBytes;
  const unsigned v_ring = k_ring + Shape::kKStages * kTile;

  // Steps 0 .. n-1 are sweep 1 over key tiles 0 .. n-1. Sweep 2 starts with
  // tile n-1, whose logits step n-1 left in the accumulator, so step n
  // needs no QK^T and no K copy; steps n+1 .. 2n-1 take tiles 0 .. n-2.
  // Step s's K tile sits in K slot s % kKStages, its V tile (sweep 2) in V
  // slot s % kVStages. Step s issues the copies of step s+kAhead's tiles,
  // runs its QK^T and waits for it (which also retires step s-1's PV), then
  // its softmax, then issues its PV and leaves it running. The block copies
  // each K and V tile once for all its warpgroups.
  auto tile0 = [&](int s) { return (t0 + (s < n ? s : s == n ? n - 1 : s - n - 1)) * kBc; };
  auto issue = [&](int s) {
    if (s < 2 * n) {
      const int c0 = tile0(s);
      if (s != n)
        load_tile_wg<kBc, kDp, kN>(k_ring + s % Shape::kKStages * kTile, kg + (long long)c0 * p.skt, p.skt, p.Tk - c0,
                                   p.Dh);
      if (s >= n)
        load_tile_wg<kBc, kDp, kN>(v_ring + s % Shape::kVStages * kTile, vg + (long long)c0 * p.svt, p.svt, p.Tk - c0,
                                   p.Dh);
    }
    cp_async_commit();  // one group per step, empty past the end
  };
  // Descriptors: a base for each region, plus (byte offset >> 4) for a
  // slot and k step (the start address field cannot carry: shared
  // addresses are below 256 KB).
  const uint64_t qd128 = wg_desc(q_s + wg * 64 * 128, 16, 1024, kSw128);
  const uint64_t qd32 = wg_desc(q_s + kRows * 128 + wg * 64 * 32, 16, 256, kSw32);
  const uint64_t kd128 = wg_desc(k_ring, 16, 1024, kSw128), kd32 = wg_desc(k_ring + kBc * 128, 16, 256, kSw32);
  const uint64_t vd128 = wg_desc(v_ring, 1024, 1024, kSw128), vd32 = wg_desc(v_ring + kBc * 128, 256, 256, kSw32);
  // S = Q K^T for the warpgroup's 64 rows and the kBc keys of step s's K
  // tile: 4 k steps of 16 dims in the 128B region, a fifth in the 32B one at
  // Dh 80. Every wgmma reads and writes its accumulator in place ("+f" on an
  // array that lives across the loop, the first k step's scale-d 0 making it
  // an overwrite), nothing else touches an accumulator between a wgmma and
  // the wait that retires it, and at most two wgmma groups are in flight:
  // otherwise ptxas serializes every wgmma.
  auto logits = [&](int s, float (&sc)[kBc / 2]) {
    const unsigned k_off = s % Shape::kKStages * (kTile >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      const bool sw128 = kk < 4;
      const uint64_t da = sw128 ? qd128 + 2 * kk : qd32;
      const uint64_t db = sw128 ? kd128 + k_off + 2 * kk : kd32 + k_off;
      wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // Accumulator element i of a thread: row g + 8 * ((i >> 1) & 1) of its
  // warp's 16, key c0 + 8 * (i >> 2) + 2 t + (i & 1).
  auto valid = [&](int c, int r) {
    return c < p.Tk && (!kMasked || ((kmr == nullptr || kmr[c] != 0) && (!p.causal || c <= qrow[r])));
  };

  float m[2] = {kNegInf, kNegInf};
  int anyv[2] = {0, 0};
  float sum[2] = {0.0f, 0.0f};
  float sc[kBc / 2];
  float o0[32];  // head dims 0-63; the first PV overwrites
  float o1[8];   // head dims 64-79 (Dh 80)

  // head: step s's tiles have landed for every thread and every warp is past
  // step s-1; issue step s+kAhead's copies. qk (every step but n): step s's
  // QK^T and its wait, which also retires step s-1's PV.
  auto head = [&](int s) {
    cp_async_wait<Shape::kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    issue(s + Shape::kAhead);
  };
  auto qk = [&](int s) {
    logits(s, sc);
    wgmma_wait<0>();
    fence_regs(sc);
  };
  // Sweep 2, step s: p against the final max and its f32 sum, rounded to
  // bf16 in pairs (column groups 2kk and 2kk+1 of the accumulator are the A
  // fragment of keys 16kk .. 16kk+15), then O += P V, left running.
  auto sweep2 = [&](int s) {
    const int c0 = tile0(s);
    unsigned pa[kBc / 16][4];
    auto probs = [&](auto full_tile) {
#pragma unroll
      for (int i = 0; i < kBc / 2; i += 2) {
        const int r = (i >> 1) & 1;
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (decltype(full_tile)::value) {
            pe[e] = expf((sc[i + e] - m[r]) * p.scale);
          } else {  // no branch around expf: a key past Tk is a select after it
            const int c = c0 + 8 * (i >> 2) + 2 * t + e;
            const float l = valid(c, r) ? sc[i + e] : kNegInf;
            const float x = expf((l - m[r]) * p.scale);
            pe[e] = c < p.Tk ? x : 0.0f;
          }
          sum[r] += pe[e];
        }
        pa[i >> 3][(i >> 1) & 3] = pack_bf16(pe[0], pe[1]);
      }
    };
    if (!kMasked && c0 + kBc <= p.Tk)
      probs(std::true_type{});
    else
      probs(std::false_type{});
    const unsigned v_off = s % Shape::kVStages * (kTile >> 4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const int acc = s > n || kk > 0;
      wgmma_rs_n64(o0, pa[kk], vd128 + v_off + kk * (16 * 128 >> 4), acc);
      if constexpr (kDp == 80) wgmma_rs_n16(o1, pa[kk], vd32 + v_off + kk * (16 * 32 >> 4), acc);
    }
    wgmma_commit();
  };

  load_tile_wg<kRows, kDp, kN>(q_s, qg, p.sqt, rows_valid, p.Dh);  // lands with step 0
#pragma unroll
  for (int s = 0; s < Shape::kAhead; ++s) issue(s);

  // ---- sweep 1: the row max and any-valid flag ----
  for (int s = 0; s < n; ++s) {
    head(s);
    qk(s);
    const int c0 = tile0(s);
    if (!kMasked && c0 + kBc <= p.Tk) {  // every key of the tile valid
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], sc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) {
        const int r = (i >> 1) & 1;
        const bool v = valid(c0 + 8 * (i >> 2) + 2 * t + (i & 1), r);
        m[r] = fmaxf(m[r], v ? sc[i] : kNegInf);
        anyv[r] |= v ? 1 : 0;
      }
    }
  }
  quad_max(m, anyv);

  // ---- sweep 2: p against the final max, its f32 sum, O += P V ----
  head(n);
  sweep2(n);
  for (int s = n + 1; s < 2 * n; ++s) {
    head(s);
    qk(s);
    sweep2(s);
  }
  wgmma_wait<0>();
  fence_regs(o0);
  if constexpr (kDp == 80) fence_regs(o1);

  // ---- epilogue: the deferred any_valid / denom, bf16 pairs through the strides ----
  float rs[2];
  row_scale<kMasked>(sum, anyv, rs);
#pragma unroll
  for (int d = 0; d < 8; ++d)
    store_rows(og, p, warp * 16 + g, d * 8 + 2 * t, rows_valid, o0[4 * d], o0[4 * d + 1], o0[4 * d + 2],
               o0[4 * d + 3], rs);
  if constexpr (kDp == 80) {
#pragma unroll
    for (int d = 0; d < 2; ++d)
      store_rows(og, p, warp * 16 + g, 64 + d * 8 + 2 * t, rows_valid, o1[4 * d], o1[4 * d + 1], o1[4 * d + 2],
                 o1[4 * d + 3], rs);
  }
}

// ---------------------------------------------------------------------------
// bf16: the kernel and its launch

template <int kDp, int kWgs>
using FlashShape = std::conditional_t<(kDp <= 80), WgShape<kDp, kWgs>, MmaShape<kDp>>;

// One __global__ name for both bodies, so a trace sums every bf16 launch
// under flash_kernel.
// kWgs: the warpgroup body's warpgroups a block (1 at Dh 128 and 256).
template <int kDp, bool kMasked, int kWgs>
__global__ void __launch_bounds__(FlashShape<kDp, kWgs>::kThreads, FlashShape<kDp, kWgs>::kMinBlocks)
    flash_kernel(Params p) {
  if constexpr (kDp <= 80)
    wg_body<kDp, kMasked, kWgs>(p);
  else
    mma_body<kDp, kMasked>(p);
}

template <int kDp, bool kMasked, int kWgs = 1>
int launch_flash(const Params& p, cudaStream_t stream) {
  using Shape = FlashShape<kDp, kWgs>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<kDp, kMasked, kWgs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((p.Tq + Shape::kRows - 1) / Shape::kRows, p.H, p.B);
  flash_kernel<kDp, kMasked, kWgs><<<grid, Shape::kThreads, Shape::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The warpgroup body: one warpgroup a block where a head's query rows fit
// in 64 (text towers, the MAP head), else two, which share each K and V tile.
template <int kDp, bool kMasked>
int launch_wg(const Params& p, cudaStream_t stream) {
  return p.Tq > 64 ? launch_flash<kDp, kMasked, 2>(p, stream) : launch_flash<kDp, kMasked, 1>(p, stream);
}

// wgmma: the warpgroup body (Dh <= 80); else the mma.sync body (Dh <= 256).
template <bool kMasked>
int launch_bf16(const Params& p, bool wgmma, cudaStream_t stream) {
  if (wgmma) {
    if (p.Dh <= 64) return launch_wg<64, kMasked>(p, stream);
    if (p.Dh <= 80) return launch_wg<80, kMasked>(p, stream);
    return (int)cudaErrorInvalidValue;
  }
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

// body: 0 = float32 (flash_f32_kernel), 1 = bfloat16 on the mma.sync body
// (Dh <= 256), 2 = bfloat16 on the warpgroup body (Dh <= 80); the wrapper
// chooses (ops/attention_cuda.py:uses_wgmma). Strides are in elements; km is
// an int32 [B, Tk] key mask (nullptr for none). Returns a cudaError_t code.
extern "C" int attention_fwd(int body, const void* q, const void* k, const void* v, const int* km,
                             void* o, int B, int H, int KVH, int Tq, int Tk, int Dh,
                             long long sqb, long long sqt, long long sqh, long long skb,
                             long long skt, long long skh, long long svb, long long svt,
                             long long svh, long long sob, long long sot, long long soh,
                             long long skmb, int causal, float scale, void* stream) {
  Params p{q, k, v, km, o, B, H, KVH, Tq, Tk, Dh, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
           sob, sot, soh, skmb, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = km != nullptr || causal;
  if (body == 1 || body == 2) {
    const bool wgmma = body == 2;
    return masked ? launch_bf16<true>(p, wgmma, s) : launch_bf16<false>(p, wgmma, s);
  }
  if (body == 0) return masked ? launch_f32<true>(p, s) : launch_f32<false>(p, s);
  return (int)cudaErrorInvalidValue;
}
