// PIL-exact image preprocessing for Hopper (sm_90a), the CUDA counterpart of
// the Pallas TPU kernel multimodal_embedding_tpu/ops/preprocess_pallas.py:
// preprocess_pallas (_kernel).
//
// Per image and channel, uint8 [H, W] -> normalized f32 [C, C]:
//   1. cast to f32;
//   2. horizontal pass: y = x @ Wh^T with the cropped PIL weights, [H, W] x [W, C];
//   3. round half to even (rintf), clamp to [0, 255];
//   4. vertical pass: z = Wv @ y, [C, H] x [H, C]; round and clamp again;
//   5. z * scale + shift per channel, as two separately rounded operations
//      (__fmul_rn, __fadd_rn), like the plain version;
//   6. written NHWC [B, C, C, 3].
// All arithmetic is f32 FMA on the CUDA cores: TF32 would move values across
// the rounding boundaries.
//
// Design: one block per (output row tile, channel, image). The resize
// matrices are banded: the host passes, for each output column, the input
// columns [lo, hi) outside which its horizontal weights are exactly zero
// (with those weights packed), for each output row the same for its vertical
// weights, and for each tile of rows_per_tile output rows the union of its
// rows' input rows. The block computes those rows of the horizontal pass
// into shared memory, then the tile's vertical pass from them. Every sum
// runs over its band in ascending order, so it equals the dense ascending
// sum bit for bit: the skipped terms are products with exact zero weights.
//
// Bound on an H100 SXM, one 480x640 image to 336x336: the dense function is
// 2*3*(480*640*336 + 480*336*336) = 0.94 GFLOP (14 us at the 67 TFLOP/s
// non-tensor f32 rate); the banded weights need about 2*3*(480*336*9 +
// 336*336*9) = 15 MFLOP, 0.2 us, while the bytes are 0.92 MB in and
// 1.35 MB out, 0.7 us at 3.35 TB/s. With the bands the kernel is bound by
// bytes; chip_smoke.py counts the taps of this run's weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // horizontal-pass rows per weight load
constexpr size_t kSmemLimit = 232448;

struct Params {
  const uint8_t* x;    // [B, 3, H, W]
  const float* whb;    // [C, htaps]: horizontal weights of each output column's band
  const int* hband;    // [C, 2]: input columns [lo, hi) of each output column
  const float* wv;     // [C, H]: cropped vertical weights
  const int* vband;    // [C, 2]: input rows [lo, hi) of each output row
  const int* tiles;    // [ntiles, 2]: input rows [hlo, hhi) of each row tile
  float* out;          // [B, C, C, 3]
  int H, W, C, htaps, rows_per_tile;
  float scale[3], shift[3];
};

__device__ __forceinline__ float quant(float v) { return fminf(fmaxf(rintf(v), 0.0f), 255.0f); }

__global__ void __launch_bounds__(kThreads) preprocess_kernel(Params p) {
  extern __shared__ __align__(16) float ys[];  // [span][C] horizontal pass, quantized
  const int tile = blockIdx.x, ch = blockIdx.y, b = blockIdx.z;
  const int hlo = p.tiles[2 * tile], hhi = p.tiles[2 * tile + 1];
  const int span = hhi - hlo;
  const int C = p.C;
  const uint8_t* img = p.x + ((size_t)b * 3 + ch) * p.H * p.W;

  const int groups = (span + kRowsPerThread - 1) / kRowsPerThread;
  for (int e = threadIdx.x; e < groups * C; e += kThreads) {
    const int g = e / C, col = e - (e / C) * C;
    const int r0 = g * kRowsPerThread;
    const uint8_t* rows[kRowsPerThread];
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      // rows past the span re-read the last row; their results are dropped
      rows[i] = img + (size_t)(hlo + min(r0 + i, span - 1)) * p.W;
      acc[i] = 0.0f;
    }
    const int lo = p.hband[2 * col], n = p.hband[2 * col + 1] - lo;
    const float* wrow = p.whb + (size_t)col * p.htaps;
    for (int t = 0; t < n; ++t) {
      const float wt = __ldg(wrow + t);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i] = fmaf((float)__ldg(rows[i] + lo + t), wt, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      if (r0 + i < span) ys[(r0 + i) * C + col] = quant(acc[i]);
  }
  __syncthreads();

  const int o0 = tile * p.rows_per_tile;
  const int rows = min(p.rows_per_tile, C - o0);
  const float sc = p.scale[ch], sh = p.shift[ch];
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int orow = e / C, col = e - (e / C) * C;
    const int o = o0 + orow;
    const float* wrow = p.wv + (size_t)o * p.H;
    float s = 0.0f;
    for (int h = p.vband[2 * o]; h < p.vband[2 * o + 1]; ++h)
      s = fmaf(__ldg(wrow + h), ys[(h - hlo) * C + col], s);
    const float z = quant(s);
    p.out[(((size_t)b * C + o0 + orow) * C + col) * 3 + ch] = __fadd_rn(__fmul_rn(z, sc), sh);
  }
}

}  // namespace

// x uint8 [B, 3, H, W]; whb f32 [C, htaps]; hband, vband int32 [C, 2];
// wv f32 [C, H]; tiles int32 [ntiles, 2]; out f32 [B, C, C, 3]. max_span is
// the largest hhi - hlo of the tiles. Returns a cudaError_t code.
extern "C" int preprocess_fwd(const uint8_t* x, const float* whb, const int* hband, const float* wv,
                              const int* vband, const int* tiles, float* out, int B, int H, int W,
                              int C, int htaps, int rows_per_tile, int ntiles, int max_span, float s0,
                              float s1, float s2, float h0, float h1, float h2, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = (size_t)max_span * C * sizeof(float);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  Params p{x, whb, hband, wv, vband, tiles, out, H, W, C, htaps, rows_per_tile, {s0, s1, s2}, {h0, h1, h2}};
  dim3 grid(ntiles, 3, B);
  preprocess_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
