// Mamba-2's selective state-space scan for Hopper (sm_90a): for each sequence
// b and head h, with the head's state S [P, N] in f32,
//   S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) B_t^T,
//   y_t = S_t C_t + D_h * x_t,
// x [B, T, H, P], dt [B, T, H] (after the softplus), B and C [B, T, N] (one
// group, shared by every head), A [H] in f32, D [H]; y [B, T, H, P] in the
// inputs' type T (bf16 or f32), every other number in f32.
//
// It replaces no Pallas kernel: the JAX package has no state-space layer. Its
// plain counterpart is ops/ssm.py:scan_plain, the chunked (SSD) form of the
// same recurrence in f32 ATen. One __global__ name, ssm_scan_kernel, has two
// bodies chosen by the inputs' type alone (ops/ssm_cuda.py:uses_chunked):
// bf16 takes the chunked body, f32 the recurrent one.
//
// bf16: the chunked body (Mamba-2's SSD, arXiv:2405.21060) on wgmma. One
// block of one warpgroup takes one sequence, one head and 64 of its head dims
// (P > 64 takes two blocks: the state's rows are independent), and walks the
// sequence in chunks of Q = 64 tokens (wgmma's M) in order. The head's state
// [64 dims x 128 columns] lives in the warpgroup's f32 accumulator registers
// (64 a thread) for the whole sequence and never leaves them. A chunk's B and
// C rows (N zero-padded to 128) and the head's x rows land by cp.async in the
// 128B-swizzled layouts wgmma reads, one chunk ahead in a two-stage ring.
// With cum the chunk's inclusive f32 prefix sum of dt * A (a warp scan) and
// s <= l tokens of the chunk, each chunk computes
//   G = C B^T                                  (bf16 x bf16, f32 sum; K 128)
//   W[l, s] = G[l, s] exp(cum_l - cum_s) dt_s   (f32, in G's registers)
//   y = W X + exp(cum_l) (C S^T) + D x
//   S <- exp(cum_Q) S + (X exp(cum_Q - cum) dt)^T B
// G and S^T C^T (the state as the register A operand, C as a K-major B) are
// issued first; the second is scaled by exp(cum_l) and staged transposed in
// shared memory as f32, then added to W X (W as the register A operand, X an
// MN-major B) in the epilogue, rounded once to bf16. The state's update takes
// X^T through ldmatrix.trans as the register A operand, B MN-major.
//
// Numerics: every exponent is the accurate expf of an f32 difference (this
// file builds without --use_fast_math), never exp(cum_l) exp(-cum_s); cum,
// the decays and the carried state stay f32. Only the kernel's bf16 inputs
// enter a product as they are (G, C in S C^T, X in W X). Each operand the
// kernel builds in f32 (W, the state read back as an operand, the scaled X)
// enters as a two-term bf16 split, hi = bf16(v) and lo = bf16(v - hi), two
// bf16 products summed in f32: within about 2^-17 of v, where tf32 keeps
// 2^-11 and one bf16 rounding 2^-9. exp(cum_l) scales C S^T after its
// product, so C needs no split. The chunked plain form sums in another order
// (chunks of 256): the two agree to f32 rounding, not bit for bit.
//
// Bound on an H100 SXM at a page batch (8 x 1030 tokens, 128 heads of 64,
// state 128): the bytes, 276 MB read and written once (0.0825 ms at 3.35
// TB/s). The chunked form's products are 6.3 MFLOP a chunk and head (G 1.05,
// S C^T 2 x 1.05, W X 2 x 0.52, the update 2 x 1.05), 110 GFLOP over 17
// chunks x 8 x 128, 0.11 ms at the bf16 peak; the recurrence's 2.6e10
// CUDA-core instructions (0.77 ms of issue, the recurrent body's bound) drop
// to about 1.5 K a thread a chunk: the exponents of W, the splits, the
// staging. A (sequence, head) is a chain of 17 dependent chunks, 1024 chains
// at a page batch, two blocks (99 KB of shared memory each) on an SM.
// What was hard: a chunk's work is a chain of dependent products inside one
// warpgroup, and the state (32 KB a head) must stay in registers. Producing
// C S^T in the state's own orientation ([P x Q]) and staging it transposed
// (17 KB of f32) keeps W in registers and the state out of shared memory;
// the alternative, the state split into shared memory as a B operand every
// chunk, needs 32 KB more a block and one block an SM. At most two wgmma
// groups are in flight, nothing touches an accumulator between its wgmma and
// the wait that retires it, and no branch surrounds a wgmma.
//
// f32: the recurrent body, the recurrence as written: one block a (sequence,
// head), 2P threads. Thread (half, p) holds row p of the state over half of
// the N state columns, N/2 f32 registers, for the whole sequence. The
// sequence is walked kSteps tokens at a time: the block stages those tokens'
// B and C rows, its head's x rows, dt and decays exp(dt * A) in shared memory
// (converted to f32 once), then each thread advances its state token by
// token, reading B and C as 16-byte broadcasts (a warp's threads share one
// half, so one address), and leaves its half of y_t's dot product in shared
// memory; after the stretch the two halves and the D skip are summed and y
// written. One __syncthreads a stage, none a token. Each state element is
// fmaf(decay, s, (dt * x_p) * B_n) with the decay expf(dt * A); the dot
// product with C accumulates in four f32 partial sums over the thread's
// columns, the two halves are added, then D * x (one fmaf) and the sum is
// rounded once. Its bound is instruction issue: P * N elements of two FMAs
// and a multiply a token and head.

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

template <typename T>
__device__ __forceinline__ T store(float v);

template <>
__device__ __forceinline__ float store<float>(float v) {
  return v;
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
  int seqlen, heads, p, n;
  int vec;  // x, B and C rows load as 16-byte vectors (aligned bases, strides and P multiples of 8)
};

// ---------------------------------------------------------------------------
// f32: the recurrent body

// grid (H, B), block 2P threads; N the state size (a multiple of 4 kSplit). Static shared
// memory: 40 KB at N 128.
template <typename T, int N>
__device__ __forceinline__ void recurrent_body(const Args& args) {
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

// ---------------------------------------------------------------------------
// bf16: the chunked body (wgmma)

constexpr int kQ = 64;     // tokens a chunk: wgmma's M
constexpr int kPt = 64;    // head dims a block
constexpr int kNs = 128;   // state columns, N zero-padded to it
constexpr int kYld = 68;   // f32 row stride of C S^T's transposed staging (conflict-free column writes)

struct Chunked {
  static constexpr int kThreads = 128;                      // one warpgroup
  static constexpr int kMinBlocks = 2;                      // two chains an SM
  static constexpr int kRegion = kQ * 128;                  // 64 rows x 128 bytes, one 128B-swizzled region
  static constexpr int kC = 0;                              // C: state columns 0-63, then 64-127
  static constexpr int kB = 2 * kRegion;                    // B: the same
  static constexpr int kX = 4 * kRegion;                    // x: the block's 64 head dims
  static constexpr int kStage = 5 * kRegion;                // 40 KB a chunk, two stages
  static constexpr int kYst = 2 * kStage;                   // f32 [kQ][kYld]
  static constexpr int kScal = kYst + kQ * kYld * 4;        // cum, exp(cum), into_end, dt [kQ] f32; the decay
  static constexpr int kSmem = 1024 + kScal + 4 * kQ * 4 + 16;  // from a 1024-aligned base
};

extern __shared__ __align__(128) unsigned char smem[];

// 16-byte asynchronous global->shared copy (cp.async); src_size 0 fills
// the destination with zeros.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// ldmatrix: four 8x8 b16 matrices, transposed, one row address per lane.
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
// The two-term split of a pair: hi = bf16(v), lo = bf16(v - hi) (the
// difference exact in f32), each a packed pair as pack_bf16 packs it.
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - __uint_as_float(hi << 16), v1 - __uint_as_float(hi & 0xffff0000u));
}

// The byte offset of element (row r, column k) of a tile of 64-wide 128B-
// swizzled regions (16-byte chunk c of row r at chunk c ^ (r % 8)).
__device__ __forceinline__ unsigned sw_offset(int r, int k) {
  return (k >> 6) * Chunked::kRegion + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + ((k & 7) << 1);
}

// A wgmma matrix descriptor of a 128B-swizzled region (the regions are
// 1024-aligned): the start address >> 4 (bits 0-13), the leading and stride
// byte offsets >> 4 (bits 16-29, 32-45), swizzle mode 1 = 128B (bits 62-63).
// K-major (rows of 64 reduced elements): the stride byte offset is the step
// between 8-row core matrices, 1024; a k step of 16 advances the start by
// 32 bytes. MN-major (rows are the reduced dim, 64 output columns a row, read
// with the transpose bit): N spans one swizzle atom, so only the step between
// 8-row groups is read and both offsets are set to it; a k step of 16 rows
// advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t wg_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(unsigned addr) { return wg_desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mnmajor_desc(unsigned addr) { return wg_desc(addr, 1024, 1024); }
constexpr unsigned kKStep = 32 >> 4;          // a K-major k step, in descriptor units
constexpr unsigned kMnStep = 16 * 128 >> 4;   // an MN-major k step
constexpr unsigned kRegionStep = Chunked::kRegion >> 4;

// d (+)= A B for a 64 x 64 f32 accumulator, A and B K-major in shared memory;
// scale_d 0 overwrites d.
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
// d (+)= A B for a 64 x 64 f32 accumulator, A a bf16 fragment in registers
// (the mma.m16n8k16 A layout, each warp its 16 rows), B in shared memory,
// MN-major with the transpose bit (kTransB 1) or K-major (0).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of an accumulator across the wait.
__device__ __forceinline__ void fence_regs(float (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(a[i])::"memory");
}
// cp.async and plain stores write through the generic proxy, wgmma reads
// through the async proxy: each thread fences its writes before the barrier.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Start loading chunk rows [t0, t0 + 64) into a stage (generic address
// stage_g, shared address stage_s): B and C (columns past N zero), the
// block's x (dims past pw zero), rows past T zero. 16-byte cp.async where
// args.vec, else element by element.
__device__ __forceinline__ void load_chunk(const Args& a, unsigned char* stage_g, unsigned stage_s,
                                           const __nv_bfloat16* bm, const __nv_bfloat16* cm,
                                           const __nv_bfloat16* xm, int t0, int pw) {
  const int tid = threadIdx.x;
  if (a.vec) {
    const int c16 = tid & 15, rb = tid >> 4;  // chunk c16 of rows rb + 8 j (B, C: 16 chunks a row)
    const bool n_ok = 8 * c16 < a.n;
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const int r = rb + 8 * j, t = t0 + r;
      const bool valid = n_ok && t < a.seqlen;
      const long long off = valid ? (long long)t * a.bc_tok + 8 * c16 : 0;
      const unsigned dst = sw_offset(r, 8 * c16);
      cp_async16(stage_s + Chunked::kC + dst, cm + off, valid);
      cp_async16(stage_s + Chunked::kB + dst, bm + off, valid);
    }
    const int c8 = tid & 7, rx = tid >> 3;  // chunk c8 of rows rx + 16 j (x: 8 chunks a row)
    const bool p_ok = 8 * c8 < pw;
#pragma unroll
    for (int j = 0; j < kQ / 16; ++j) {
      const int r = rx + 16 * j, t = t0 + r;
      const bool valid = p_ok && t < a.seqlen;
      cp_async16(stage_s + Chunked::kX + sw_offset(r, 8 * c8), xm + (valid ? (long long)t * a.x_tok + 8 * c8 : 0),
                 valid);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < kQ * kNs; i += Chunked::kThreads) {
      const int r = i / kNs, k = i - r * kNs, t = t0 + r;
      const bool valid = k < a.n && t < a.seqlen;
      const long long off = (long long)t * a.bc_tok + k;
      *reinterpret_cast<__nv_bfloat16*>(stage_g + Chunked::kC + sw_offset(r, k)) = valid ? cm[off] : zero;
      *reinterpret_cast<__nv_bfloat16*>(stage_g + Chunked::kB + sw_offset(r, k)) = valid ? bm[off] : zero;
    }
    for (int i = tid; i < kQ * kPt; i += Chunked::kThreads) {
      const int r = i / kPt, k = i - r * kPt, t = t0 + r;
      const bool valid = k < pw && t < a.seqlen;
      *reinterpret_cast<__nv_bfloat16*>(stage_g + Chunked::kX + sw_offset(r, k)) =
          valid ? xm[(long long)t * a.x_tok + k] : zero;
    }
  }
}

// grid (H * ceil(P / 64), B), 128 threads, Chunked::kSmem bytes of dynamic
// shared memory.
__device__ __forceinline__ void chunked_body(const Args& a) {
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row (and row + 8) of the warp's 16, column pair
  const int ptiles = (a.p + kPt - 1) / kPt;
  const int h = blockIdx.x / ptiles;
  const int p0 = (blockIdx.x - h * ptiles) * kPt, pw = min(kPt, a.p - p0);
  const long long seq = blockIdx.y;
  const int T = a.seqlen;
  const bf16* xm = static_cast<const bf16*>(a.x) + seq * a.x_seq + (long long)h * a.p + p0;
  const bf16* dtm = static_cast<const bf16*>(a.dt) + seq * T * a.heads + h;
  const bf16* bm = static_cast<const bf16*>(a.b) + seq * a.bc_seq;
  const bf16* cm = static_cast<const bf16*>(a.c) + seq * a.bc_seq;
  bf16* ym = static_cast<bf16*>(a.y) + (seq * T * a.heads + h) * a.p + p0;
  const long long y_tok = (long long)a.heads * a.p;
  const float a_h = a.a[h];
  const float d_h = __bfloat162float(static_cast<const bf16*>(a.d)[h]);

  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* const base = smem + pad;
  const unsigned sbase = raw + pad;
  float* const yst = reinterpret_cast<float*>(base + Chunked::kYst);
  float* const s_cum = reinterpret_cast<float*>(base + Chunked::kScal);
  float* const s_ecum = s_cum + kQ;   // exp(cum_l)
  float* const s_ie = s_ecum + kQ;    // exp(cum_Q - cum_l) dt_l: token l's weight into the chunk's end
  float* const s_dt = s_ie + kQ;
  float* const s_decay = s_dt + kQ;   // exp(cum_Q)

  float s0[32], s1[32];  // the state [64 dims][state columns 0-63 | 64-127], f32, the whole sequence
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.0f;

  // warp 0 keeps the dt of tokens 2 lane and 2 lane + 1 of the next chunk in flight
  float dtn0 = 0.0f, dtn1 = 0.0f;
  auto fetch_dt = [&](int t0) {
    const int t = t0 + 2 * lane;
    dtn0 = t < T ? __bfloat162float(dtm[(long long)t * a.heads]) : 0.0f;
    dtn1 = t + 1 < T ? __bfloat162float(dtm[(long long)(t + 1) * a.heads]) : 0.0f;
  };
  const int nc = (T + kQ - 1) / kQ;
  load_chunk(a, base, sbase, bm, cm, xm, 0, pw);
  cp_async_commit();
  if (warp == 0) fetch_dt(0);

  for (int c = 0; c < nc; ++c) {
    const int cur = (c & 1) * Chunked::kStage;
    const unsigned st = sbase + cur;
    const float dt0 = dtn0, dt1 = dtn1;
    // chunk c has landed for every thread, and every thread is past chunk c-1
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (c + 1 < nc) {
      const int nxt = ((c + 1) & 1) * Chunked::kStage;
      load_chunk(a, base + nxt, sbase + nxt, bm, cm, xm, (c + 1) * kQ, pw);
    }
    cp_async_commit();
    if (warp == 0 && c + 1 < nc) fetch_dt((c + 1) * kQ);

    // The state's share before the decays, (S C^T)[p, l], and G = C B^T. The
    // state enters as hi + lo A fragments (accumulator column pairs 2q, 2q + 1
    // of n-block k are register q of k step k / 2's fragment).
    unsigned sa[2][8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * (kk & 3) + 2 * q;
        split2(kk < 4 ? s0[i] : s1[i], kk < 4 ? s0[i + 1] : s1[i + 1], sa[0][kk][q], sa[1][kk][q]);
      }
    }
    const uint64_t cd = kmajor_desc(st + Chunked::kC), bd = kmajor_desc(st + Chunked::kB);
    float yt[32], gacc[32];
    wgmma_fence();
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n64<0>(yt, sa[hl][kk], cd + (kk >> 2) * kRegionStep + (kk & 3) * kKStep, hl > 0 || kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const unsigned k_off = (kk >> 2) * kRegionStep + (kk & 3) * kKStep;
      wgmma_ss_n64(gacc, cd + k_off, bd + k_off, kk > 0);
    }
    wgmma_commit();

    // The chunk's scalars (warp 0): cum by a warp scan over token pairs.
    if (warp == 0) {
      const float v0 = dt0 * a_h, v1 = dt1 * a_h;
      float inc = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += n;
      }
      float ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) ex = 0.0f;
      const float c0 = ex + v0, c1 = c0 + v1;
      const float cq = __shfl_sync(0xffffffffu, c1, 31);
      const int i = 2 * lane;
      *reinterpret_cast<float2*>(s_cum + i) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(s_ecum + i) = make_float2(expf(c0), expf(c1));
      *reinterpret_cast<float2*>(s_ie + i) = make_float2(expf(cq - c0) * dt0, expf(cq - c1) * dt1);
      *reinterpret_cast<float2*>(s_dt + i) = make_float2(dt0, dt1);
      if (lane == 0) *s_decay = expf(cq);
    }
    __syncthreads();

    // S C^T done: scaled by exp(cum_l), staged transposed, [l][p] in f32.
    // Accumulator element i: row (dim) 16 warp + g + 8 ((i >> 1) & 1), column
    // (token) 8 (i >> 2) + 2 t4 + (i & 1).
    wgmma_wait<1>();
    fence_regs(yt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = 16 * warp + g + 8 * ((i >> 1) & 1), l = 8 * (i >> 2) + 2 * t4 + (i & 1);
      yst[l * kYld + p] = yt[i] * s_ecum[l];
    }

    // G done: W = G exp(cum_l - cum_s) dt_s for s <= l, as hi + lo A
    // fragments. k step kk covers tokens 16 kk .. 16 kk + 15, all past the
    // warp's rows where kk > warp.
    wgmma_wait<0>();
    fence_regs(gacc);
    unsigned wa[2][4][4];
    const int l0 = 16 * warp + g;
    const float cl[2] = {s_cum[l0], s_cum[l0 + 8]};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float w[2] = {0.0f, 0.0f};
        if (kk <= warp) {
          const int r = q & 1, l = l0 + 8 * r;
          const int s = 16 * kk + 8 * (q >> 1) + 2 * t4;
          const float2 cs = *reinterpret_cast<const float2*>(s_cum + s);
          const float2 ds = *reinterpret_cast<const float2*>(s_dt + s);
          const float e0 = expf(cl[r] - cs.x), e1 = expf(cl[r] - cs.y);  // selected away above the diagonal
          const int i = 8 * kk + 2 * q;
          w[0] = s <= l ? gacc[i] * e0 * ds.x : 0.0f;
          w[1] = s + 1 <= l ? gacc[i + 1] * e1 * ds.y : 0.0f;
        }
        split2(w[0], w[1], wa[0][kk][q], wa[1][kk][q]);
      }
    }

    // The state's update: S <- exp(cum_Q) S + (X exp(cum_Q - cum) dt)^T B.
    // X^T's fragments by ldmatrix.trans: matrix m of k step kk holds dims
    // 16 warp + 8 (m & 1) .. + 7 and tokens 16 kk + 8 (m >> 1) .. + 7; a
    // register's low half is the even token.
    const float decay = *s_decay;
#pragma unroll
    for (int i = 0; i < 32; ++i) s0[i] *= decay, s1[i] *= decay;
    unsigned xa[2][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int m = lane >> 3, r = 16 * kk + 8 * (m >> 1) + (lane & 7);
      unsigned xr[4];
      ldsm_x4_trans(st + Chunked::kX + sw_offset(r, 16 * warp + 8 * (m & 1)), xr);
      const float2 ia = *reinterpret_cast<const float2*>(s_ie + 16 * kk + 2 * t4);
      const float2 ib = *reinterpret_cast<const float2*>(s_ie + 16 * kk + 8 + 2 * t4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 w = q < 2 ? ia : ib;
        split2(__uint_as_float(xr[q] << 16) * w.x, __uint_as_float(xr[q] & 0xffff0000u) * w.y, xa[0][kk][q],
               xa[1][kk][q]);
      }
    }

    // y's within-chunk part W X, then the state's update, both running while
    // the staging is completed.
    float yacc[32];
    const uint64_t xd = mnmajor_desc(st + Chunked::kX);
    const uint64_t b0d = mnmajor_desc(st + Chunked::kB), b1d = b0d + kRegionStep;
    wgmma_fence();
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64<1>(yacc, wa[hl][kk], xd + kk * kMnStep, hl > 0 || kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int hl = 0; hl < 2; ++hl) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64<1>(s0, xa[hl][kk], b0d + kk * kMnStep, 1);
        wgmma_rs_n64<1>(s1, xa[hl][kk], b1d + kk * kMnStep, 1);
      }
    }
    wgmma_commit();
    __syncthreads();  // the staging is complete

    // Epilogue: y = W X + staged + D x, rounded once. Element i: row (token)
    // 16 warp + g + 8 ((i >> 1) & 1), column (dim) 8 (i >> 2) + 2 t4 + (i & 1).
    wgmma_wait<1>();
    fence_regs(yacc);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int l = l0 + 8 * ((i >> 1) & 1), p = 8 * (i >> 2) + 2 * t4, t = c * kQ + l;
      const unsigned xp = *reinterpret_cast<const unsigned*>(base + cur + Chunked::kX + sw_offset(l, p));
      const float2 ys = *reinterpret_cast<const float2*>(yst + l * kYld + p);
      const float v0 = fmaf(d_h, __uint_as_float(xp << 16), yacc[i] + ys.x);
      const float v1 = fmaf(d_h, __uint_as_float(xp & 0xffff0000u), yacc[i + 1] + ys.y);
      if (t < T && p < pw) {
        bf16* dst = ym + (long long)t * y_tok + p;
        if ((a.p & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (p + 1 < pw) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(s0);
    fence_regs(s1);
  }
}

// ---------------------------------------------------------------------------
// The kernel and its launch

// One __global__ name for both bodies, so a trace sums every launch under
// ssm_scan_kernel: kChunked the bf16 chunked body (N padded to 128), else
// the recurrent body at state size N.
template <typename T, int N, bool kChunked>
__global__ void __launch_bounds__(kChunked ? Chunked::kThreads : 2 * kMaxP, kChunked ? Chunked::kMinBlocks : 1)
    ssm_scan_kernel(Args args) {
  if constexpr (kChunked)
    chunked_body(args);
  else
    recurrent_body<T, N>(args);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <int N>
int launch_recurrent(const Args& args, int batch, cudaStream_t s) {
  ssm_scan_kernel<float, N, false><<<dim3(args.heads, batch), kSplit * args.p, 0, s>>>(args);
  return (int)cudaGetLastError();
}

int launch_chunked(const Args& args, int batch, cudaStream_t s) {
  auto kernel = ssm_scan_kernel<__nv_bfloat16, kNs, true>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Chunked::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int ptiles = (args.p + kPt - 1) / kPt;
  kernel<<<dim3(args.heads * ptiles, batch), Chunked::kThreads, Chunked::kSmem, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of x, dt, B, C, D and y; a float32.
// x [batch, seqlen, heads, p] with strides (x_seq, x_tok, p, 1); dt [batch,
// seqlen, heads] contiguous; B and C [batch, seqlen, n] with strides (bc_seq,
// bc_tok, 1); a and d [heads]; y [batch, seqlen, heads, p] contiguous.
// 1 <= p <= 128; n one of 16, 32, 64, 128. bfloat16 runs the chunked body,
// float32 the recurrent one. Returns a cudaError_t code.
extern "C" int ssm_scan_fwd(int dtype, const void* x, long long x_seq, long long x_tok, const void* dt,
                            const float* a, const void* b, const void* c, long long bc_seq, long long bc_tok,
                            const void* d, void* y, long long batch, long long seqlen, long long heads, long long p,
                            long long n, void* stream) {
  if (batch <= 0 || seqlen <= 0 || heads <= 0 || p < 1 || p > kMaxP || batch > 65535 || heads > (1LL << 30) - 1 ||
      seqlen > (1LL << 31) - 1 || !aligned(a, 4) || (n != 16 && n != 32 && n != 64 && n != 128))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned(x, 16) && aligned(b, 16) && aligned(c, 16) && x_seq % 8 == 0 && x_tok % 8 == 0 &&
                  bc_seq % 8 == 0 && bc_tok % 8 == 0 && p % 8 == 0;
  Args args{x, dt, a, b, c, d, y, x_seq, x_tok, bc_seq, bc_tok, (int)seqlen, (int)heads, (int)p, (int)n, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_chunked(args, (int)batch, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 16: return launch_recurrent<16>(args, (int)batch, s);
    case 32: return launch_recurrent<32>(args, (int)batch, s);
    case 64: return launch_recurrent<64>(args, (int)batch, s);
    default: return launch_recurrent<128>(args, (int)batch, s);
  }
}
