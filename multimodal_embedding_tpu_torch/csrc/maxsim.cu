// MaxSim late-interaction scoring for Hopper (sm_90a), the CUDA counterpart
// of the Pallas TPU kernel multimodal_embedding_tpu/ops/maxsim.py:
// _maxsim_pallas (:128; its body _maxsim_kernel, :79), which maxsim_scores
// drives.
//
// For query-token embeddings q [NQ, TQ, D], doc-token embeddings d [ND, TD, D],
// a query-token weight qm [NQ, TQ] (f32) and a doc-token mask dm [ND, TD]:
//
//   out[i, j] = sum_t qm[i, t] * max_{s : dm[j, s] != 0} <q[i, t], d[j, s]>
//
// with the semantics of _maxsim_kernel: every dot product accumulates in f32,
// a masked doc token counts as -1e30 (so a doc with no valid token gives
// -1e30 per weighted query token), the running max per (query token, doc)
// starts at -1e30, and the weighted sum over query tokens is f32. The TPU
// wrapper's 64-token query chunking only changes the order of that sum. The
// order here is fixed and there are no atomics, so every run gives the same
// result.
//
// Bound on an H100 SXM at the ColPali T2I shape of a 128-image run (q
// [128, 32, 128], d [128, 1030, 128], bf16): 2*128*32*128*1030*128 =
// 138 GFLOP, 0.14 ms at the 989 TFLOP/s bf16 dense peak, against 35 MB of
// inputs (10 us at 3.35 TB/s): bound by operations. I2T (q [128, 1030, 128],
// d [640, 32, 128]) is 5x the work, 0.70 ms.
//
// bf16 design (wgmma_kernel). A GEMM whose epilogue is a masked running max,
// then a weighted sum, never written out as similarities:
//  - a block of two warpgroups owns a group of whole queries (qpb of them:
//    4 text queries of 32 tokens fill 128 rows; 1, 2 or 4 image queries of
//    1030 tokens, 4 taking 33 row tiles, at most 1088 rows a query) and a
//    slice of docs; the grid is planned in ops/maxsim_cuda.py:plan_grid to
//    fill the SMs in whole waves;
//  - the queries' tokens, flattened, are walked in row tiles of 128 rows;
//    each row tile stays resident in shared memory (128B-swizzled) for the
//    whole sweep over the slice's docs, one warpgroup on each 64 rows (D is
//    zero-padded to 128, ColPali's width);
//  - the slice's doc tokens are packed across doc boundaries (each doc padded
//    to a multiple of 8 tokens, so that every 8-column group of a tile holds
//    one doc) and streamed in tiles of 128 tokens through a 4-stage cp.async
//    ring; each thread writes its 16-byte chunks at their swizzled places;
//  - each warpgroup computes its 64 x 128 similarity tile with 8
//    wgmma.m64n128k16 (f32 accumulators, both operands from shared memory);
//  - the accumulators of tile i are reduced, in straight-line code, to the
//    masked maxima of each 8-column group (32 registers a thread); the doc
//    bookkeeping on those (branches, shuffles) runs while the wgmma of tile
//    i + 1 does. No branch surrounds a wgmma or reads an accumulator between
//    a wgmma and its wait: ptxas would serialize every wgmma of the kernel;
//  - at a doc's last column group the quad's maxima are combined with
//    shuffles, weighted by qm and stored per (doc, row); after the sweep one
//    warp per (query, doc) sums its rows in a fixed order into the block's
//    accumulator, which is written out once.
//
// f32 design (tf32x3_kernel): the same data flow on mma.sync. Every f32
// index search runs it: cli/encode_cli.py writes f32 embeddings, and
// retrieval/search.py casts the queries to the index's dtype, so
// cli/search.py on a multi-vector (ColPali) index scores through it.
//  - a block of 8 warps owns qpb whole queries and a slice of docs, planned
//    by ops/maxsim_cuda.py:plan_grid_f32 (plan_grid's search for f32's
//    tiles) on a one-dimensional grid;
//  - the 128-row query tile (f32, rows 136 floats apart) stays resident for
//    the sweep; each warp owns 16 rows;
//  - the doc tokens are packed across doc boundaries as in bf16 (td8 a doc)
//    and stream through a 3-stage cp.async ring in tiles of 64 tokens,
//    8 column groups each;
//  - each warp's 16 x 64 similarity tile is 8 n8 tiles of
//    mma.sync.m16n8k8.f32.tf32.tf32.f32, each product three of them
//    (3xTF32): every f32 fragment element is split in registers into a TF32
//    high part (rounded to nearest, ties away) and the truncated TF32
//    remainder, a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32, about 2^-21
//    of a.b a product (one TF32 pass, 2^-11, fails the 1e-5 gate;
//    tests/torch_tf32.py emulates both). hi.hi and the cross terms
//    accumulate in two chains of 64 dims each, added into f32 registers
//    rounded to nearest (the tensor core's accumulator rounds toward zero,
//    a bias that grows with the chain). D is permuted inside each chunk of
//    8 (k-index t is element 2t, t + 4 is 2t + 1), so both fragments are
//    float2 reads, a half-warp's on 32 banks;
//  - n8 tile j is column group j: its masked maxima, the doc bookkeeping,
//    the per-(doc, row) values and the fixed-order sums are the bf16
//    kernel's (templated on the group count).
// Bound on an H100 SXM at a COCO-5k-sized ColPali index searched by 64
// queries of 32 tokens (d [5000, 1030, 128] f32, 2.64 GB): 2.70 TFLOP, 40 ms
// at the 67 TFLOP/s f32 peak outside the tensor cores (16 ms at 165, a
// third of the TF32 peak: the three passes), against 0.8 ms of bytes: bound
// by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 128;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the per-block maximum

extern __shared__ __align__(128) unsigned char smem[];

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int kWThreads = 256;  // two warpgroups
constexpr int kRows = 128;      // query rows of a row tile, 64 per warpgroup
constexpr int kBN = 128;        // doc tokens of a ring tile
constexpr int kStages = 4;
constexpr int kRegion = kRows * 128;  // bytes of one 64-wide K slice of a 128-row tile
constexpr int kTileBytes = 2 * kRegion;  // a 128-row tile at D 128
constexpr int kChunks = kMaxD / 8;     // 16-byte chunks of a row

// The shared-memory layout wgmma reads, for a 128-row tile of K-major bf16
// rows (query or doc tokens, D contiguous). D is cut into K slices of 64
// elements (128 bytes a row); slice k of the tile is its own region of
// 128 rows x 128 bytes (kRegion). Inside a region, the 16-byte chunk c of row
// r sits at chunk c ^ (r % 8) of that row: the 128-byte swizzle, so the 8 rows
// of a core matrix land in 8 different bank groups. Regions start on 1024-byte
// boundaries, as the swizzle's address bits require.
__device__ __forceinline__ unsigned sw128_offset(int row, int chunk) {
  return (chunk >> 3) * kRegion + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// The wgmma matrix descriptor of a K-major, 128B-swizzled operand starting at
// shared address addr: start address >> 4 (bits 0-13), leading byte offset 1
// (unused by swizzled K-major layouts, bits 16-29), stride byte offset
// 1024 >> 4 between 8-row core matrices (bits 32-45), base offset 0 (the
// regions are 1024-aligned; bits 49-51), swizzle mode 1 = 128B (bits 62-63).
// A k step of 16 elements inside a 64-wide slice advances addr by 32 bytes;
// the hardware applies the swizzle to the address it forms.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of an accumulator set across the wait.
__device__ __forceinline__ void fence_acc(float (&a)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(a[i])::"memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each thread fences its landed copies before the barrier.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <typename T>
struct MParams {
  const T* q;              // [NQ, TQ, D], last dim contiguous
  const T* d;              // [ND, TD, D], last dim contiguous
  const float* qm;         // [NQ, TQ] contiguous f32 weights, or nullptr (all ones)
  const int* dm;           // [ND, TD] contiguous int32 mask, or nullptr (all valid)
  float* out;              // [NQ, ND] contiguous
  int NQ, TQ, ND, TD, D;
  long long sqn, sqt, sdn, sdt;  // element strides
  int qpb;      // whole queries per block
  int dps;      // docs per slice
  int nslices;  // slices of the docs
  int td8;      // TD rounded up to 8: the packed stride of a doc's tokens
  unsigned long long inv_td8;  // ceil(2^40 / td8): pos / td8 is (pos * inv_td8) >> 40 while pos * td8 < 2^40
  int aligned;  // td8 divides the ring tile: every doc lies inside one
};
using WParams = MParams<__nv_bfloat16>;
using FParams = MParams<float>;

template <typename P>
__device__ __forceinline__ int div_td8(int pos, const P& p) {
  return (int)(((unsigned long long)pos * p.inv_td8) >> 40);
}

// Start the copy of the 128-row query tile whose first row is lr0 of the
// block's flattened (query, token) rows; rows past nrows and columns past D
// are zeros. Thread tid copies chunk tid % 16 of rows tid / 16 + 16 k.
__device__ __forceinline__ void load_q_tile(unsigned dst, const WParams& p, int q0, int nrows, int lr0) {
  const int c = threadIdx.x & (kChunks - 1);
  for (int k = 0; k < 8; ++k) {
    const int r = (threadIdx.x >> 4) + 16 * k;
    const int lr = lr0 + r;
    const int ql = lr / p.TQ;
    const bool valid = lr < nrows && c < p.D / 8;
    const __nv_bfloat16* src =
        valid ? p.q + (long long)(q0 + ql) * p.sqn + (long long)(lr - ql * p.TQ) * p.sqt + c * 8 : p.q;
    cp_async16(dst + sw128_offset(r, c), src, valid);
  }
}

// Start the copy of ring tile t of the slice's packed doc tokens (positions
// 128 t .. 128 t + 127; doc j of the slice holds positions j * td8 + s for
// s < TD) into slot dst, and write the tile's column bias (0 for a valid
// token, -1e30 for a masked or padding one).
__device__ __forceinline__ void load_d_tile(unsigned dst, float* bias, const WParams& p, int d0, int ndocs,
                                            int t) {
  const int c = threadIdx.x & (kChunks - 1);
  const int total = ndocs * p.td8;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = (threadIdx.x >> 4) + 16 * k;
    const int pos = t * kBN + r;
    const int doc = div_td8(pos, p);
    const int s = pos - doc * p.td8;
    const bool valid = pos < total && s < p.TD && c < p.D / 8;
    const __nv_bfloat16* src = valid ? p.d + (long long)(d0 + doc) * p.sdn + (long long)s * p.sdt + c * 8 : p.d;
    cp_async16(dst + sw128_offset(r, c), src, valid);
  }
  if (threadIdx.x < kBN) {
    const int pos = t * kBN + threadIdx.x;
    const int doc = div_td8(pos, p);
    const int s = pos - doc * p.td8;
    bool valid = pos < total && s < p.TD;
    if (valid && p.dm != nullptr) valid = __ldg(p.dm + (long long)(d0 + doc) * p.TD + s) != 0;
    bias[threadIdx.x] = valid ? 0.0f : kNegInf;
  }
}

// One warpgroup's 64 x 128 similarity tile: its 64 query rows (a_base) against
// the ring tile (b_base), D in 8 k steps of 16, into acc (overwritten). No
// wgmma sits under a branch the compiler cannot prove uniform: it would then
// serialize them.
__device__ __forceinline__ void mma_tile(float (&acc)[64], unsigned a_base, unsigned b_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) {
    const unsigned koff = (kk >> 2) * kRegion + (kk & 3) * 32;
    wgmma_m64n128k16(acc, sw128_desc(a_base + koff), sw128_desc(b_base + koff), kk > 0);
  }
  wgmma_commit();
}

// Per-thread state of one row tile's sweep: the doc whose running max is
// open, the running max of the thread's two rows r0 and r0 + 8 (of the row
// tile) over the columns it holds, and what the flush needs.
struct Sweep {
  int cur;       // the open doc (slice-local)
  float m0, m1;  // running maxima of rows r0, r1
  float w0, w1;  // qm weights of rows r0, r1 (0 for padding rows)
  float* rv;     // [dps][128]: each doc's weighted row maxima of the row tile, + r0
};

// Close the open doc: the quad's maxima, weighted by qm, stored per row.
// Two shuffles deep, so the many short docs of a tile (4 captions of 32
// tokens) close quickly; the sum over rows waits for the row tile's end.
__device__ __forceinline__ void flush(Sweep& sw, int lane) {
  float m0 = sw.m0, m1 = sw.m1;
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if ((lane & 3) == 0) {
    sw.rv[sw.cur * kRows] = sw.w0 * m0;
    sw.rv[sw.cur * kRows + 8] = sw.w1 * m1;
  }
}

// Tile t's column maxima, per 8-column group and row: every accumulator is
// read once, in straight-line code (no branch, so ptxas keeps the wgmma
// pipeline), with the column bias added first (0 for a valid token, -1e30
// for a masked or padding one; a + (-1e30) rounds to -1e30 for every |a| the
// products reach).
__device__ __forceinline__ void group_max(const float (&acc)[64], const float* bias, int lane, float (&g0)[16],
                                          float (&g1)[16]) {
  const float* bq = bias + 2 * (lane & 3);
#pragma unroll
  for (int g = 0; g < kBN / 8; ++g) {
    const float2 b = *reinterpret_cast<const float2*>(bq + 8 * g);
    g0[g] = fmaxf(acc[4 * g] + b.x, acc[4 * g + 1] + b.y);
    g1[g] = fmaxf(acc[4 * g + 2] + b.x, acc[4 * g + 3] + b.y);
  }
}

__device__ __forceinline__ void open_doc(Sweep& sw, int doc, int lane) {
  if (doc != sw.cur) {
    flush(sw, lane);
    sw.cur = doc;
    sw.m0 = sw.m1 = kNegInf;
  }
}

// Tile t's docs when td8 = 8 K divides the tile's 8 NG columns: NG / K
// whole docs, doc j on groups [j K, j K + K). Each doc's maxima, their quad
// shuffles interleaved (one shuffle latency for all docs, not one a doc),
// stored per row.
template <int K, int NG>
__device__ __forceinline__ void aligned_max(const float (&g0)[NG], const float (&g1)[NG], const Sweep& sw, int t,
                                            int ndocs, int lane) {
  constexpr int D = NG / K;
  float m0[D], m1[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    m0[j] = g0[j * K];
    m1[j] = g1[j * K];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      m0[j] = fmaxf(m0[j], g0[j * K + k]);
      m1[j] = fmaxf(m1[j], g1[j * K + k]);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      m0[j] = fmaxf(m0[j], __shfl_xor_sync(0xffffffffu, m0[j], o));
      m1[j] = fmaxf(m1[j], __shfl_xor_sync(0xffffffffu, m1[j], o));
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int doc = t * D + j;
      if (doc < ndocs) {
        sw.rv[doc * kRows] = sw.w0 * m0[j];
        sw.rv[doc * kRows + 8] = sw.w1 * m1[j];
      }
    }
  }
}

// The running max over tile t's NG group maxima, flushing each doc whose
// columns end. Column group g belongs to one doc, the same for every thread,
// so every branch here is uniform; a tile inside one doc takes a tree of
// maxima.
template <int NG, typename P>
__device__ __forceinline__ void doc_max(float (&g0)[NG], float (&g1)[NG], Sweep& sw, const P& p, int t, int total,
                                        int lane) {
  constexpr int kCols = 8 * NG;
  int pos = t * kCols;
  if (pos >= total) return;  // past the sweep's last tile
  if (p.aligned) {
    const int ndocs = total / p.td8;
    switch (p.td8) {
      case 8: aligned_max<1>(g0, g1, sw, t, ndocs, lane); break;
      case 16: aligned_max<2>(g0, g1, sw, t, ndocs, lane); break;
      case 32: aligned_max<4>(g0, g1, sw, t, ndocs, lane); break;
      case 64: aligned_max<8>(g0, g1, sw, t, ndocs, lane); break;
      default: aligned_max<NG>(g0, g1, sw, t, ndocs, lane); break;  // td8 = 8 NG: a doc a tile
    }
    return;
  }
  int doc = div_td8(pos, p);
  if (pos + kCols <= total && div_td8(pos + kCols - 1, p) == doc) {
    open_doc(sw, doc, lane);
    if constexpr (NG == 16) {
#pragma unroll
      for (int g = 0; g < 8; ++g) g0[g] = fmaxf(g0[g], g0[g + 8]), g1[g] = fmaxf(g1[g], g1[g + 8]);
    }
    static_assert(NG == 16 || NG == 8, "a ring tile of 64 or 128 doc tokens");
#pragma unroll
    for (int g = 0; g < 4; ++g) g0[g] = fmaxf(g0[g], g0[g + 4]), g1[g] = fmaxf(g1[g], g1[g + 4]);
#pragma unroll
    for (int g = 0; g < 2; ++g) g0[g] = fmaxf(g0[g], g0[g + 2]), g1[g] = fmaxf(g1[g], g1[g + 2]);
    sw.m0 = fmaxf(sw.m0, fmaxf(g0[0], g0[1]));
    sw.m1 = fmaxf(sw.m1, fmaxf(g1[0], g1[1]));
    return;
  }
  int off = pos - doc * p.td8;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (pos < total) {
      open_doc(sw, doc, lane);
      sw.m0 = fmaxf(sw.m0, g0[g]);
      sw.m1 = fmaxf(sw.m1, g1[g]);
    }
    pos += 8;
    off += 8;
    if (off == p.td8) {
      off = 0;
      ++doc;
    }
  }
}

// What one row tile's sweep over the ring needs.
struct Ring {
  unsigned ring_s;  // shared address of slot 0
  unsigned a_base;  // shared address of this warpgroup's 64 query rows
  float* bias;      // [kStages][kBN] column bias
  int d0, ndocs, n, total;
};

// Step i of the sweep. On entry g0/g1 hold tile i's group maxima and tile
// i's wgmma is done. Tile i + 1 has landed; refill tile i's slot with tile
// i + kStages; start wgmma(i + 1); while it runs, take tile i's running max
// (branches and shuffles on g0/g1, no accumulator); then wait for it and
// reduce it into g0/g1. kStages - 2 copy groups stay in flight across the
// wait. No branch surrounds the wgmma or reads its accumulators (ptxas would
// serialize every wgmma of the kernel): at the last step the wgmma reads a
// stale slot, and its maxima are never used.
__device__ __forceinline__ void sweep_step(int i, float (&acc)[64], float (&g0)[16], float (&g1)[16], Sweep& sw,
                                           const Ring& rg, const WParams& p, int lane) {
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
  const int t = i + kStages;
  const int slot = i % kStages;
  if (t < rg.n) load_d_tile(rg.ring_s + slot * kTileBytes, rg.bias + slot * kBN, p, rg.d0, rg.ndocs, t);
  cp_async_commit();
  const int nslot = (i + 1) % kStages;
  mma_tile(acc, rg.a_base, rg.ring_s + nslot * kTileBytes);
  doc_max(g0, g1, sw, p, i, rg.total, lane);
  wgmma_wait<0>();
  fence_acc(acc);
  group_max(acc, rg.bias + nslot * kBN, lane, g0, g1);
}

__global__ void __launch_bounds__(kWThreads, 1) wgmma_kernel(WParams p) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;
  const int group = blockIdx.x / p.nslices;
  const int slice = blockIdx.x - group * p.nslices;
  const int q0 = group * p.qpb;
  const int nq = min(p.qpb, p.NQ - q0);
  const int nrows = nq * p.TQ;  // flattened (query, token) rows this block owns
  const int d0 = slice * p.dps;
  const int ndocs = min(p.dps, p.ND - d0);
  const int total = ndocs * p.td8;
  const int n = (total + kBN - 1) / kBN;  // ring tiles a row tile sweeps

  // layout (from a 1024-aligned base): Q tile | ring [kStages] | bias [kStages][kBN] |
  // rv [dps][kRows] | accs [qpb][dps]
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned pad = ((raw + 1023) & ~1023u) - raw;
  const unsigned q_s = raw + pad;
  const unsigned ring_s = q_s + kTileBytes;
  float* bias = reinterpret_cast<float*>(smem + pad + (1 + kStages) * kTileBytes);
  float* rv = bias + kStages * kBN;
  float* accs = rv + p.dps * kRows;

  for (int i = tid; i < p.qpb * p.dps; i += kWThreads) accs[i] = 0.0f;

  const int nrt = (nrows + kRows - 1) / kRows;
  for (int rt = 0; rt < nrt; ++rt) {
    const int lr0 = rt * kRows;
    Sweep sw;
    sw.cur = 0;
    sw.m0 = sw.m1 = kNegInf;
    sw.rv = rv + 16 * warp + (lane >> 2);
    {
      const int r0 = lr0 + 16 * warp + (lane >> 2);
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lr = r0 + 8 * e;
        const int qq = lr / p.TQ;
        w[e] = lr < nrows ? (p.qm ? __ldg(p.qm + (long long)(q0 + qq) * p.TQ + (lr - qq * p.TQ)) : 1.0f) : 0.0f;
      }
      sw.w0 = w[0];
      sw.w1 = w[1];
    }

    __syncthreads();  // the last row tile's reads of Q, the ring and rv are done
    load_q_tile(q_s, p, q0, nrows, lr0);
#pragma unroll
    for (int t = 0; t < kStages; ++t) {  // Q lands with tile 0
      if (t < n) load_d_tile(ring_s + t * kTileBytes, bias + t * kBN, p, d0, ndocs, t);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    fence_proxy_async();
    __syncthreads();

    // a warpgroup whose 64 rows are all padding (the last tile of a
    // 1030-token query) computes them too; their rows are never summed
    const unsigned a_base = q_s + wg * (64 * 128);
    float acc[64], g0[16], g1[16];
    mma_tile(acc, a_base, ring_s);
    wgmma_wait<0>();
    fence_acc(acc);
    group_max(acc, bias, lane, g0, g1);
    const Ring rg{ring_s, a_base, bias, d0, ndocs, n, total};
    for (int i = 0; i < n; ++i) sweep_step(i, acc, g0, g1, sw, rg, p, lane);
    if (!p.aligned) flush(sw, lane);  // the last doc
    __syncthreads();

    // one warp per (query, doc) pair of this row tile: its rows' values
    // summed in a fixed order, into the accumulator
    const int lr1 = min(lr0 + kRows, nrows);
    const int qa = lr0 / p.TQ, qb = (lr1 - 1) / p.TQ;
    const int npairs = (qb - qa + 1) * ndocs;
    for (int pp = warp; pp < npairs; pp += kWThreads / 32) {
      const int ql = qa + pp / ndocs;
      const int dl = pp - (pp / ndocs) * ndocs;
      const int lo = max(ql * p.TQ, lr0) - lr0;
      const int hi = min((ql + 1) * p.TQ, lr1) - lr0;
      float s = 0.0f;
      for (int r = lo + lane; r < hi; r += 32) s += rv[dl * kRows + r];
      s = warp_sum(s);
      if (lane == 0) accs[ql * p.dps + dl] += s;
    }
  }
  __syncthreads();
  for (int pp = tid; pp < nq * ndocs; pp += kWThreads) {
    const int ql = pp / ndocs;
    const int dl = pp - ql * ndocs;
    p.out[(long long)(q0 + ql) * p.ND + d0 + dl] = accs[ql * p.dps + dl];
  }
}

size_t wgmma_smem_bytes(const WParams& p) {
  return 1024 + (size_t)(1 + kStages) * kTileBytes + (size_t)kStages * kBN * sizeof(float) +
         (size_t)p.dps * kRows * sizeof(float) + (size_t)p.qpb * p.dps * sizeof(float);
}

int launch_bf16(WParams p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  p.td8 = (p.TD + 7) / 8 * 8;
  p.inv_td8 = ((1ull << 40) + p.td8 - 1) / p.td8;
  p.aligned = kBN % p.td8 == 0;
  const size_t smem = wgmma_smem_bytes(p);
  const long long groups = (p.NQ + p.qpb - 1) / p.qpb;
  const long long blocks = groups * p.nslices;
  if (p.qpb <= 0 || p.dps <= 0 || p.nslices != (p.ND + p.dps - 1) / p.dps ||
      ((long long)p.dps * p.td8 + kBN) * p.td8 >= (1LL << 40) || smem > kSmemLimit || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  wgmma_kernel<<<(unsigned)blocks, kWThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync on the bf16 kernel's data flow
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;       // 8 warps, 16 rows of the row tile each
constexpr int kFNG = 8;              // column groups of a ring tile
constexpr int kFBN = 8 * kFNG;       // doc tokens of a ring tile
constexpr int kFStages = 3;
constexpr int kFLd = kMaxD + 8;      // shared row stride, floats: 8 mod 32
constexpr int kFQBytes = kRows * kFLd * 4;
constexpr int kFTileBytes = kFBN * kFLd * 4;
constexpr int kFChunks = kMaxD / 4;  // 16-byte chunks of a row

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
// chain spans 64 dims and then lands here.
__device__ __forceinline__ void promote(float (&d)[4], float (&big)[4], float (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] += big[e] + small[e];
    big[e] = small[e] = 0.0f;
  }
}

// Start the copy of the 128-row query tile whose first row is lr0 of the
// block's flattened (query, token) rows into rows kFLd floats apart; rows
// past nrows and columns past D are zeros. Warp w copies rows w + 8 k, a
// 16-byte chunk a lane.
__device__ __forceinline__ void load_q_tile_f32(unsigned dst, const FParams& p, int q0, int nrows, int lr0) {
  const int c = threadIdx.x & (kFChunks - 1);
#pragma unroll 4
  for (int k = 0; k < kRows / 8; ++k) {
    const int r = (threadIdx.x >> 5) + 8 * k;
    const int lr = lr0 + r;
    const int ql = lr / p.TQ;
    const bool valid = lr < nrows && c < p.D / 4;
    const float* src = valid ? p.q + (long long)(q0 + ql) * p.sqn + (long long)(lr - ql * p.TQ) * p.sqt + c * 4 : p.q;
    cp_async16(dst + (r * kFLd + c * 4) * 4, src, valid);
  }
}

// Start the copy of ring tile t of the slice's packed doc tokens (positions
// 64 t .. 64 t + 63; doc j of the slice holds positions j * td8 + s for
// s < TD) into slot dst, and write the tile's column bias (0 for a valid
// token, -1e30 for a masked or padding one).
__device__ __forceinline__ void load_d_tile_f32(unsigned dst, float* bias, const FParams& p, int d0, int ndocs,
                                                int t) {
  const int c = threadIdx.x & (kFChunks - 1);
  const int total = ndocs * p.td8;
#pragma unroll
  for (int k = 0; k < kFBN / 8; ++k) {
    const int r = (threadIdx.x >> 5) + 8 * k;
    const int pos = t * kFBN + r;
    const int doc = div_td8(pos, p);
    const int s = pos - doc * p.td8;
    const bool valid = pos < total && s < p.TD && c < p.D / 4;
    const float* src = valid ? p.d + (long long)(d0 + doc) * p.sdn + (long long)s * p.sdt + c * 4 : p.d;
    cp_async16(dst + (r * kFLd + c * 4) * 4, src, valid);
  }
  if (threadIdx.x < kFBN) {
    const int pos = t * kFBN + threadIdx.x;
    const int doc = div_td8(pos, p);
    const int s = pos - doc * p.td8;
    bool valid = pos < total && s < p.TD;
    if (valid && p.dm != nullptr) valid = __ldg(p.dm + (long long)(d0 + doc) * p.TD + s) != 0;
    bias[threadIdx.x] = valid ? 0.0f : kNegInf;
  }
}

__global__ void __launch_bounds__(kFThreads, 1) tf32x3_kernel(FParams p) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row (and row + 8), column pair
  const int group = blockIdx.x / p.nslices;
  const int slice = blockIdx.x - group * p.nslices;
  const int q0 = group * p.qpb;
  const int nq = min(p.qpb, p.NQ - q0);
  const int nrows = nq * p.TQ;  // flattened (query, token) rows this block owns
  const int d0 = slice * p.dps;
  const int ndocs = min(p.dps, p.ND - d0);
  const int total = ndocs * p.td8;
  const int n = (total + kFBN - 1) / kFBN;  // ring tiles a row tile sweeps

  // layout: Q tile | ring [kFStages] | bias [kFStages][kFBN] | rv [dps][kRows] | accs [qpb][dps]
  const unsigned q_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned ring_s = q_s + kFQBytes;
  float* bias = reinterpret_cast<float*>(smem + kFQBytes + kFStages * kFTileBytes);
  float* rv = bias + kFStages * kFBN;
  float* accs = rv + p.dps * kRows;

  for (int i = tid; i < p.qpb * p.dps; i += kFThreads) accs[i] = 0.0f;

  const int nrt = (nrows + kRows - 1) / kRows;
  for (int rt = 0; rt < nrt; ++rt) {
    const int lr0 = rt * kRows;
    Sweep sw;
    sw.cur = 0;
    sw.m0 = sw.m1 = kNegInf;
    sw.rv = rv + 16 * warp + g;
    {
      const int r0 = lr0 + 16 * warp + g;
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lr = r0 + 8 * e;
        const int qq = lr / p.TQ;
        w[e] = lr < nrows ? (p.qm ? __ldg(p.qm + (long long)(q0 + qq) * p.TQ + (lr - qq * p.TQ)) : 1.0f) : 0.0f;
      }
      sw.w0 = w[0];
      sw.w1 = w[1];
    }

    __syncthreads();  // the last row tile's reads of Q, the ring and rv are done
    load_q_tile_f32(q_s, p, q0, nrows, lr0);
#pragma unroll
    for (int i = 0; i < kFStages - 1; ++i) {  // Q lands with tile 0
      if (i < n) load_d_tile_f32(ring_s + i * kFTileBytes, bias + i * kFBN, p, d0, ndocs, i);
      cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
      // tile i has landed for every thread, and every warp is done with
      // tile i - 1, whose slot tile i + kFStages - 1 then takes
      cp_async_wait<kFStages - 2>();
      __syncthreads();
      const int tn = i + kFStages - 1;
      if (tn < n)
        load_d_tile_f32(ring_s + (tn % kFStages) * kFTileBytes, bias + (tn % kFStages) * kFBN, p, d0, ndocs, tn);
      cp_async_commit();
      const int slot = i % kFStages;

      // the warp's 16 x 64 similarity tile: A fragment, query rows g and
      // g + 8 at columns kk + 2t, +1; B fragment, doc token 8j + g there
      float acc[kFNG][4];
      {
        const float* qa = reinterpret_cast<const float*>(smem) + (16 * warp + g) * kFLd + 2 * t;
        const float* db = reinterpret_cast<const float*>(smem + kFQBytes + slot * kFTileBytes) + g * kFLd + 2 * t;
        float big[kFNG][4], small[kFNG][4];
#pragma unroll
        for (int j = 0; j < kFNG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = big[j][e] = small[j][e] = 0.0f;
#pragma unroll
        for (int k0 = 0; k0 < kMaxD; k0 += 64) {  // each chain spans 64 dims
#pragma unroll 4
          for (int kk = k0; kk < k0 + 64; kk += 8) {
            const float2 x0 = *reinterpret_cast<const float2*>(qa + kk);
            const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * kFLd + kk);
            unsigned ah[4], al[4];
            split_tf32(x0.x, ah[0], al[0]);
            split_tf32(x1.x, ah[1], al[1]);
            split_tf32(x0.y, ah[2], al[2]);
            split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < kFNG; ++j) {
              const float2 y = *reinterpret_cast<const float2*>(db + j * 8 * kFLd + kk);
              unsigned bh[2], bl[2];
              split_tf32(y.x, bh[0], bl[0]);
              split_tf32(y.y, bh[1], bl[1]);
              mma_3xtf32(big[j], small[j], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int j = 0; j < kFNG; ++j) promote(acc[j], big[j], small[j]);
        }
      }
      // n8 tile j is column group j: its masked maxima per row, then the
      // running max over the tile's docs
      float g0[kFNG], g1[kFNG];
      const float* bt = bias + slot * kFBN + 2 * t;
#pragma unroll
      for (int j = 0; j < kFNG; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j);
        g0[j] = fmaxf(acc[j][0] + bb.x, acc[j][1] + bb.y);
        g1[j] = fmaxf(acc[j][2] + bb.x, acc[j][3] + bb.y);
      }
      doc_max(g0, g1, sw, p, i, total, lane);
    }
    if (!p.aligned) flush(sw, lane);  // the last doc
    __syncthreads();

    // one warp per (query, doc) pair of this row tile: its rows' values
    // summed in a fixed order, into the accumulator
    const int lr1 = min(lr0 + kRows, nrows);
    const int qa = lr0 / p.TQ, qb = (lr1 - 1) / p.TQ;
    const int npairs = (qb - qa + 1) * ndocs;
    for (int pp = warp; pp < npairs; pp += kFThreads / 32) {
      const int ql = qa + pp / ndocs;
      const int dl = pp - (pp / ndocs) * ndocs;
      const int lo = max(ql * p.TQ, lr0) - lr0;
      const int hi = min((ql + 1) * p.TQ, lr1) - lr0;
      float s = 0.0f;
      for (int r = lo + lane; r < hi; r += 32) s += rv[dl * kRows + r];
      s = warp_sum(s);
      if (lane == 0) accs[ql * p.dps + dl] += s;
    }
  }
  __syncthreads();
  for (int pp = tid; pp < nq * ndocs; pp += kFThreads) {
    const int ql = pp / ndocs;
    const int dl = pp - ql * ndocs;
    p.out[(long long)(q0 + ql) * p.ND + d0 + dl] = accs[ql * p.dps + dl];
  }
}

size_t f32_smem_bytes(const FParams& p) {
  return (size_t)kFQBytes + (size_t)kFStages * kFTileBytes + (size_t)kFStages * kFBN * sizeof(float) +
         (size_t)p.dps * kRows * sizeof(float) + (size_t)p.qpb * p.dps * sizeof(float);
}

int launch_f32(FParams p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  p.td8 = (p.TD + 7) / 8 * 8;
  p.inv_td8 = ((1ull << 40) + p.td8 - 1) / p.td8;
  p.aligned = kFBN % p.td8 == 0;
  const size_t smem = f32_smem_bytes(p);
  const long long groups = (p.NQ + p.qpb - 1) / p.qpb;
  const long long blocks = groups * p.nslices;  // a one-dimensional grid: up to 2^31 - 1 blocks
  if (p.qpb <= 0 || p.dps <= 0 || p.nslices != (p.ND + p.dps - 1) / p.dps ||
      ((long long)p.dps * p.td8 + kFBN) * p.td8 >= (1LL << 40) || smem > kSmemLimit || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  tf32x3_kernel<<<(unsigned)blocks, kFThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [NQ, TQ, D] and d [ND, TD, D] with a
// contiguous last dim and 16-byte aligned rows; qm f32 [NQ, TQ] or nullptr;
// dm int32 [ND, TD] or nullptr; out f32 [NQ, ND]. Strides in elements. qpb
// and dps are the grid plan (queries per block, docs per slice) of
// ops/maxsim_cuda.py: plan_grid for bf16, plan_grid_f32 for f32. Returns a
// cudaError_t code.
extern "C" int maxsim_fwd(int dtype, const void* q, const void* d, const float* qm, const int* dm, float* out,
                          int NQ, int TQ, int ND, int TD, int D, long long sqn, long long sqt, long long sdn,
                          long long sdt, int qpb, int dps, void* stream) {
  if (NQ <= 0 || TQ <= 0 || ND <= 0 || TD <= 0 || D <= 0 || D > kMaxD || D % 8 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& p) {
    p.qm = qm;
    p.dm = dm;
    p.out = out;
    p.NQ = NQ, p.TQ = TQ, p.ND = ND, p.TD = TD, p.D = D;
    p.sqn = sqn, p.sqt = sqt, p.sdn = sdn, p.sdt = sdt;
    p.qpb = qpb, p.dps = dps;
    p.nslices = dps > 0 ? (ND + dps - 1) / dps : 0;
  };
  if (dtype == 1) {
    WParams p{};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.d = static_cast<const __nv_bfloat16*>(d);
    fill(p);
    return launch_bf16(p, s);
  }
  FParams p{};
  p.q = static_cast<const float*>(q);
  p.d = static_cast<const float*>(d);
  fill(p);
  return launch_f32(p, s);
}
