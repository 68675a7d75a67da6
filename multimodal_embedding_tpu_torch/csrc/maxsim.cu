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
// f32 inputs keep the first design (f32_kernel): plain FMA in the mma.sync
// fragment layout (no TF32), a double-buffered ring of 32 or 64 doc tokens,
// 8 docs a block; no main path feeds MaxSim f32.

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

struct WParams {
  const __nv_bfloat16* q;  // [NQ, TQ, D], last dim contiguous
  const __nv_bfloat16* d;  // [ND, TD, D], last dim contiguous
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
  int aligned;  // td8 divides 128: every doc lies inside one ring tile
};

__device__ __forceinline__ int div_td8(int pos, const WParams& p) {
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

// Tile t's docs when td8 = 8 K divides 128: 16 / K whole docs, doc j on
// groups [j K, j K + K). Each doc's maxima, their quad shuffles interleaved
// (one shuffle latency for all docs, not one a doc), stored per row.
template <int K>
__device__ __forceinline__ void aligned_max(const float (&g0)[16], const float (&g1)[16], const Sweep& sw, int t,
                                            int ndocs, int lane) {
  constexpr int D = 16 / K;
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

// The running max over tile t's group maxima, flushing each doc whose columns
// end. Column group g belongs to one doc, the same for every thread, so every
// branch here is uniform; a tile inside one doc takes a tree of maxima.
__device__ __forceinline__ void doc_max(float (&g0)[16], float (&g1)[16], Sweep& sw, const WParams& p, int t,
                                       int total, int lane) {
  int pos = t * kBN;
  if (pos >= total) return;  // past the sweep's last tile
  if (p.aligned) {
    const int ndocs = total / p.td8;
    switch (p.td8) {
      case 8: aligned_max<1>(g0, g1, sw, t, ndocs, lane); break;
      case 16: aligned_max<2>(g0, g1, sw, t, ndocs, lane); break;
      case 32: aligned_max<4>(g0, g1, sw, t, ndocs, lane); break;
      case 64: aligned_max<8>(g0, g1, sw, t, ndocs, lane); break;
      default: aligned_max<16>(g0, g1, sw, t, ndocs, lane); break;
    }
    return;
  }
  int doc = div_td8(pos, p);
  if (pos + kBN <= total && div_td8(pos + kBN - 1, p) == doc) {
    open_doc(sw, doc, lane);
#pragma unroll
    for (int g = 0; g < 8; ++g) g0[g] = fmaxf(g0[g], g0[g + 8]), g1[g] = fmaxf(g1[g], g1[g + 8]);
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
  for (int g = 0; g < kBN / 8; ++g) {
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
// f32: FMA in the mma.sync fragment layout
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = kWarps * 16;  // query-token rows per row tile
constexpr int kMaxBN = 64;        // doc tokens per doc tile
constexpr int kMaxSub = kMaxBN / 8;
constexpr int kBD = 8;            // docs per block

struct Params {
  const float* q;   // [NQ, TQ, D], last dim contiguous
  const float* d;   // [ND, TD, D], last dim contiguous
  const float* qm;  // [NQ, TQ] contiguous f32 weights, or nullptr (all ones)
  const int* dm;    // [ND, TD] contiguous int32 mask, or nullptr (all valid)
  float* out;       // [NQ, ND] contiguous
  int NQ, TQ, ND, TD, D;
  long long sqn, sqt, sdn, sdt;  // element strides
  int qpb;  // whole queries per block
  int bn;   // doc tokens per tile (32 or 64)
  int dp;   // D padded to a multiple of 16
  int ld;   // shared-memory row stride in elements: dp + 8
};

// Start copying rows [0, rows) of a tile into shared memory (row stride ld),
// 16 bytes at a time; row r of the tile is global row src_row(r), or zeros
// where src_row returns nullptr. Columns >= D are zero-filled; D is a
// multiple of 8, so a 16-byte vector never straddles it.
template <typename RowFn>
__device__ __forceinline__ void load_tile_async(float* dst, int rows, const Params& p, RowFn src_row) {
  constexpr int V = 4;
  const int vpr = p.dp / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * V;
    const float* row = src_row(r);
    const bool valid = row != nullptr && c < p.D;
    cp_async16(static_cast<unsigned>(__cvta_generic_to_shared(dst + r * p.ld + c)), valid ? row + c : p.q, valid);
  }
}

__global__ void __launch_bounds__(kThreads) f32_kernel(Params p) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d0 = blockIdx.x * kBD;
  const int q0 = blockIdx.y * p.qpb;
  const int ndocs = min(kBD, p.ND - d0);
  const int nrows = p.qpb * p.TQ;  // flattened (query, token) rows this block owns
  const int nrt = (nrows + kBM - 1) / kBM;
  const int tpd = (p.TD + p.bn - 1) / p.bn;  // token tiles per doc
  const int nsub = p.bn / 8;

  // layout: Q [kBM][ld] | ring [2][kMaxBN][ld] | qms [kBM] | rv [kBD][kBM] | acc [qpb][kBD]
  const int tile_bytes = kMaxBN * p.ld * (int)sizeof(float);
  const int ring_off = kBM * p.ld * (int)sizeof(float);
  float* qms = reinterpret_cast<float*>(smem + ring_off + 2 * tile_bytes);
  float* rv = qms + kBM;
  float* accs = rv + kBD * kBM;

  for (int i = tid; i < p.qpb * kBD; i += kThreads) accs[i] = 0.0f;

  // this thread's rows of a row tile, in the mma accumulator layout
  const int r0 = warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;

  for (int rt = 0; rt < nrt; ++rt) {
    const int lr0 = rt * kBM;
    auto q_row = [&](int r) -> const float* {
      const int lr = lr0 + r;
      const int ql = lr / p.TQ;
      if (lr >= nrows || q0 + ql >= p.NQ) return nullptr;
      return p.q + (long long)(q0 + ql) * p.sqn + (long long)(lr - ql * p.TQ) * p.sqt;
    };
    load_tile_async(reinterpret_cast<float*>(smem), kBM, p, q_row);  // lands with doc tile 0
    for (int r = tid; r < kBM; r += kThreads) {
      const int lr = lr0 + r;
      const int ql = lr / p.TQ;
      const bool valid = lr < nrows && q0 + ql < p.NQ;
      qms[r] = valid ? (p.qm ? p.qm[(long long)(q0 + ql) * p.TQ + (lr - ql * p.TQ)] : 1.0f) : 0.0f;
    }

    const int n = ndocs * tpd;
    auto issue = [&](int i) {
      if (i < n) {
        const int dl = i / tpd;
        const int s0 = (i - dl * tpd) * p.bn;
        const float* doc = p.d + (long long)(d0 + dl) * p.sdn;
        load_tile_async(reinterpret_cast<float*>(smem + ring_off + (i & 1) * tile_bytes), p.bn, p,
                        [&](int r) -> const float* { return s0 + r < p.TD ? doc + (long long)(s0 + r) * p.sdt : nullptr; });
      }
      cp_async_commit();  // one group per tile, empty past the end
    };

    float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0 and r1 over the current doc
    issue(0);
    for (int i = 0; i < n; ++i) {
      cp_async_wait<0>();  // tile i (and the Q tile) landed, for this thread
      __syncthreads();     // ... for every thread; and tile i-1's buffer is free
      issue(i + 1);
      const int dl = i / tpd;
      const int st = i - dl * tpd;
      const int buf_off = ring_off + (i & 1) * tile_bytes;

      float acc[kMaxSub][4];
      const float* Qs = reinterpret_cast<const float*>(smem);
      const float* Ds = reinterpret_cast<const float*>(smem + buf_off);
      const float* qa = Qs + r0 * p.ld;
      const float* qb = Qs + r1 * p.ld;
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j) {
        if (j < nsub) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* dr = Ds + (j * 8 + 2 * (lane & 3) + e) * p.ld;
            float sa = 0.0f, sb = 0.0f;
            for (int k = 0; k < p.D; ++k) {
              sa = fmaf(qa[k], dr[k], sa);
              sb = fmaf(qb[k], dr[k], sb);
            }
            acc[j][e] = sa;
            acc[j][2 + e] = sb;
          }
        }
      }

      // masked running max over this tile's doc tokens
      const int s0 = st * p.bn;
      const int* dmr = p.dm ? p.dm + (long long)(d0 + dl) * p.TD : nullptr;
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j) {
        if (j < nsub) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = s0 + j * 8 + 2 * (lane & 3) + e;
            const bool valid = s < p.TD && (dmr == nullptr || __ldg(dmr + s) != 0);
            m0 = fmaxf(m0, valid ? acc[j][e] : kNegInf);
            m1 = fmaxf(m1, valid ? acc[j][2 + e] : kNegInf);
          }
        }
      }
      if (st == tpd - 1) {  // the doc's last tile: combine the quad, weight, store
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        if ((lane & 3) == 0) {
          rv[dl * kBM + r0] = m0 * qms[r0];
          rv[dl * kBM + r1] = m1 * qms[r1];
        }
        m0 = m1 = kNegInf;
      }
    }
    __syncthreads();  // rv complete; Q and the ring are free

    // one warp per (query, doc) pair of this row tile: a fixed-order sum
    const int lr1 = min(lr0 + kBM, nrows);
    const int qa = lr0 / p.TQ, qb = (lr1 - 1) / p.TQ;
    const int npairs = (qb - qa + 1) * ndocs;
    for (int pp = warp; pp < npairs; pp += kWarps) {
      const int ql = qa + pp / ndocs;
      const int dl = pp - (pp / ndocs) * ndocs;
      const int lo = max(ql * p.TQ, lr0) - lr0;
      const int hi = min((ql + 1) * p.TQ, lr1) - lr0;
      float s = 0.0f;
      for (int r = lo + lane; r < hi; r += 32) s += rv[dl * kBM + r];
      s = warp_sum(s);
      if (lane == 0) accs[ql * kBD + dl] += s;
    }
    __syncthreads();
  }

  for (int i = tid; i < p.qpb * ndocs; i += kThreads) {
    const int ql = i / ndocs;
    const int dl = i - ql * ndocs;
    if (q0 + ql < p.NQ) p.out[(long long)(q0 + ql) * p.ND + d0 + dl] = accs[ql * kBD + dl];
  }
}

int launch_f32(Params p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  p.dp = (p.D + 15) / 16 * 16;
  p.ld = p.dp + 8;
  p.bn = p.TD <= 32 ? 32 : kMaxBN;
  p.qpb = p.TQ >= kBM ? 1 : kBM / p.TQ;
  const size_t smem = (size_t)(kBM + 2 * kMaxBN) * p.ld * sizeof(float) +
                      (size_t)(kBM + kBD * kBM + p.qpb * kBD) * sizeof(float);
  const unsigned gy = (unsigned)((p.NQ + p.qpb - 1) / p.qpb);
  if (smem > kSmemLimit || gy > 65535u) return (int)cudaErrorInvalidValue;
  dim3 grid((p.ND + kBD - 1) / kBD, gy);
  f32_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [NQ, TQ, D] and d [ND, TD, D] with a
// contiguous last dim and 16-byte aligned rows; qm f32 [NQ, TQ] or nullptr;
// dm int32 [ND, TD] or nullptr; out f32 [NQ, ND]. Strides in elements. qpb
// and dps are the bf16 kernel's grid plan (ops/maxsim_cuda.py:plan_grid:
// queries per block, docs per slice); the f32 kernel plans its own. Returns a
// cudaError_t code.
extern "C" int maxsim_fwd(int dtype, const void* q, const void* d, const float* qm, const int* dm, float* out,
                          int NQ, int TQ, int ND, int TD, int D, long long sqn, long long sqt, long long sdn,
                          long long sdt, int qpb, int dps, void* stream) {
  if (NQ <= 0 || TQ <= 0 || ND <= 0 || TD <= 0 || D <= 0 || D > kMaxD || D % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    WParams p{};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.d = static_cast<const __nv_bfloat16*>(d);
    p.qm = qm;
    p.dm = dm;
    p.out = out;
    p.NQ = NQ, p.TQ = TQ, p.ND = ND, p.TD = TD, p.D = D;
    p.sqn = sqn, p.sqt = sqt, p.sdn = sdn, p.sdt = sdt;
    p.qpb = qpb, p.dps = dps;
    p.nslices = dps > 0 ? (ND + dps - 1) / dps : 0;
    return launch_bf16(p, s);
  }
  if (dtype == 0) {
    Params p{static_cast<const float*>(q), static_cast<const float*>(d), qm, dm, out, NQ, TQ, ND, TD, D,
             sqn, sqt, sdn, sdt, 0, 0, 0, 0};
    return launch_f32(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
