// MaxSim late-interaction scoring for Hopper (sm_90a), the CUDA counterpart
// of the Pallas TPU kernel multimodal_embedding_tpu/ops/maxsim.py:
// _maxsim_pallas (_maxsim_kernel), which maxsim_scores drives.
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
// wrapper's 64-token query chunking only changes the order of that sum.
//
// Design (simple and right first): a GEMM with a max-then-sum epilogue. One
// block of 8 warps owns a group of whole queries (qpb of them, so that short
// text queries fill a 128-row tile) and kBD docs. It walks its queries'
// tokens in row tiles of 128 rows (16 per warp, staged in shared memory with
// cp.async); for each row tile it streams the docs' token tiles (32 or 64
// tokens, never spanning two docs) through a double-buffered cp.async ring.
// bf16 inputs: each warp computes its 16 x bn tile of similarities with
// ldmatrix + mma.sync m16n8k16 (f32 accumulators, D in k-steps of 16); f32
// inputs: plain FMA in the same fragment layout (no TF32). Each thread keeps
// the running max of its rows; at a doc's last tile the quad's maxima are
// combined with shuffles and, weighted by qm, written to shared memory. After
// the row tile, one warp per (query, doc) pair sums its rows in a fixed order
// and adds the result to the block's accumulator, which is written out once:
// no atomics, so the result is the same on every run.
//
// Bound on an H100 SXM at the ColPali T2I shape of a 128-image run (q
// [128, 32, 128], d [128, 1030, 128], bf16): 2*128*32*128*1030*128 =
// 138 GFLOP, 0.14 ms at the 989 TFLOP/s bf16 dense peak, against 35 MB of
// inputs (10 us at 3.35 TB/s): bound by operations. I2T (q [128, 1030, 128],
// d [640, 32, 128]) is 5x the work. This version re-reads each doc tile from
// L2 once per row tile and uses mma.sync, not wgmma/TMA (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = kWarps * 16;  // query-token rows per row tile
constexpr int kMaxBN = 64;        // doc tokens per doc tile
constexpr int kMaxSub = kMaxBN / 8;
constexpr int kBD = 8;            // docs per block
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the per-block maximum

struct Params {
  const void* q;    // [NQ, TQ, D], last dim contiguous
  const void* d;    // [ND, TD, D], last dim contiguous
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

extern __shared__ __align__(128) unsigned char smem[];

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// Start copying rows [0, rows) of a tile into shared memory (row stride ld),
// 16 bytes at a time; row r of the tile is global row src_row(r), or zeros
// where src_row returns nullptr. Columns >= D are zero-filled; D is a
// multiple of 8, so a 16-byte vector never straddles it.
template <typename T, typename RowFn>
__device__ __forceinline__ void load_tile_async(T* dst, int rows, const Params& p, RowFn src_row) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = p.dp / V;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * V;
    const T* row = src_row(r);
    const bool valid = row != nullptr && c < p.D;
    cp_async16(dst + r * p.ld + c, valid ? row + c : static_cast<const T*>(p.q), valid);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) maxsim_kernel(Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
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

  // layout: Q [kBM][ld] T | ring [2][kMaxBN][ld] T | qms [kBM] | rv [kBD][kBM] | acc [qpb][kBD]
  const int tile_bytes = kMaxBN * p.ld * (int)sizeof(T);
  const int ring_off = kBM * p.ld * (int)sizeof(T);
  float* qms = reinterpret_cast<float*>(smem + ring_off + 2 * tile_bytes);
  float* rv = qms + kBM;
  float* accs = rv + kBD * kBM;
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  const T* qg = static_cast<const T*>(p.q);
  const T* dg = static_cast<const T*>(p.d);

  for (int i = tid; i < p.qpb * kBD; i += kThreads) accs[i] = 0.0f;

  // this thread's rows of a row tile, in the mma accumulator layout
  const int r0 = warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;

  for (int rt = 0; rt < nrt; ++rt) {
    const int lr0 = rt * kBM;
    auto q_row = [&](int r) -> const T* {
      const int lr = lr0 + r;
      const int ql = lr / p.TQ;
      if (lr >= nrows || q0 + ql >= p.NQ) return nullptr;
      return qg + (long long)(q0 + ql) * p.sqn + (long long)(lr - ql * p.TQ) * p.sqt;
    };
    load_tile_async(reinterpret_cast<T*>(smem), kBM, p, q_row);  // lands with doc tile 0
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
        const T* doc = dg + (long long)(d0 + dl) * p.sdn;
        load_tile_async(reinterpret_cast<T*>(smem + ring_off + (i & 1) * tile_bytes), p.bn, p,
                        [&](int r) -> const T* { return s0 + r < p.TD ? doc + (long long)(s0 + r) * p.sdt : nullptr; });
      }
      cp_async_commit();  // one group per tile, empty past the end
    };

    float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0 and r1 over the current doc
    issue(0);
    for (int i = 0; i < n; ++i) {
      cp_async_wait_all();  // tile i (and the Q tile) landed, for this thread
      __syncthreads();      // ... for every thread; and tile i-1's buffer is free
      issue(i + 1);
      const int dl = i / tpd;
      const int st = i - dl * tpd;
      const int buf_off = ring_off + (i & 1) * tile_bytes;

      float acc[kMaxSub][4];
#pragma unroll
      for (int j = 0; j < kMaxSub; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      if constexpr (kBf16) {
        const unsigned a_addr = sbase + 2 * ((warp * 16 + (lane & 15)) * p.ld + (lane >> 4) * 8);
        const unsigned b_addr =
            sbase + buf_off + 2 * (((lane & 7) + ((lane >> 4) << 3)) * p.ld + ((lane >> 3) & 1) * 8);
        for (int kk = 0; kk < p.dp; kk += 16) {
          unsigned a[4];
          ldsm_x4(a_addr + 2 * kk, a);
#pragma unroll
          for (int j = 0; j < kMaxSub / 2; ++j) {
            if (2 * j < nsub) {
              unsigned bb[4];
              ldsm_x4(b_addr + 2 * (j * 16 * p.ld + kk), bb);
              mma_bf16(acc[2 * j], a, bb[0], bb[1]);
              mma_bf16(acc[2 * j + 1], a, bb[2], bb[3]);
            }
          }
        }
      } else {
        const T* Qs = reinterpret_cast<const T*>(smem);
        const T* Ds = reinterpret_cast<const T*>(smem + buf_off);
        const T* qa = Qs + r0 * p.ld;
        const T* qb = Qs + r1 * p.ld;
#pragma unroll
        for (int j = 0; j < kMaxSub; ++j) {
          if (j < nsub) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const T* dr = Ds + (j * 8 + 2 * (lane & 3) + e) * p.ld;
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

template <typename T>
int launch(Params p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(maxsim_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  p.dp = (p.D + 15) / 16 * 16;
  p.ld = p.dp + 8;
  p.bn = p.TD <= 32 ? 32 : kMaxBN;
  p.qpb = p.TQ >= kBM ? 1 : kBM / p.TQ;
  const size_t smem = (size_t)(kBM + 2 * kMaxBN) * p.ld * sizeof(T) +
                      (size_t)(kBM + kBD * kBM + p.qpb * kBD) * sizeof(float);
  const unsigned gy = (unsigned)((p.NQ + p.qpb - 1) / p.qpb);
  if (smem > kSmemLimit || gy > 65535u) return (int)cudaErrorInvalidValue;
  dim3 grid((p.ND + kBD - 1) / kBD, gy);
  maxsim_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [NQ, TQ, D] and d [ND, TD, D] with a
// contiguous last dim and 16-byte aligned rows; qm f32 [NQ, TQ] or nullptr;
// dm int32 [ND, TD] or nullptr; out f32 [NQ, ND]. Strides in elements.
// Returns a cudaError_t code.
extern "C" int maxsim_fwd(int dtype, const void* q, const void* d, const float* qm, const int* dm, float* out,
                          int NQ, int TQ, int ND, int TD, int D, long long sqn, long long sqt, long long sdn,
                          long long sdt, void* stream) {
  if (NQ <= 0 || TQ <= 0 || ND <= 0 || TD <= 0 || D <= 0 || D > kMaxD || D % 8)
    return (int)cudaErrorInvalidValue;
  Params p{q, d, qm, dm, out, NQ, TQ, ND, TD, D, sqn, sqt, sdn, sdt, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  if (dtype == 0) return launch<float>(p, s);
  return (int)cudaErrorInvalidValue;
}
