// PIL-exact image preprocessing for Hopper (sm_90a), the CUDA counterpart of
// the Pallas TPU kernel multimodal_embedding_tpu/ops/preprocess_pallas.py:
// preprocess_pallas (:57; its body _kernel, :28).
//
// Per image and channel, uint8 [H, W] -> normalized f32 [C, C]:
//   1. cast to f32;
//   2. horizontal pass: y = x @ Wh^T with the cropped PIL weights, [H, W] x [W, C];
//   3. round half to even (as rintf), clamp to [0, 255];
//   4. vertical pass: z = Wv @ y, [C, H] x [H, C]; round and clamp again;
//   5. z * scale + shift per channel, as two separately rounded operations
//      (__fmul_rn, __fadd_rn), like the plain version;
//   6. written NHWC [B, C, C, 3].
// All arithmetic is f32 FMA on the CUDA cores: TF32 would move values across
// the rounding boundaries.
//
// The resize matrices are banded: the host passes, for each output column,
// the input columns [lo, hi) outside which its horizontal weights are exactly
// zero (with those weights packed), for each output row the same for its
// vertical weights, and for each tile of rows_per_tile output rows the union
// [hlo, hhi) of its rows' input rows. Every sum runs over its band in
// ascending order, so it equals the dense ascending sum bit for bit: the
// skipped terms are products with exact zero weights.
//
// Bound on an H100 SXM, one 480x640 image to 336x336: the banded weights need
// about 2*3*(480*336*9 + 336*336*9) = 15 MFLOP (0.2 us at the 67 TFLOP/s
// non-tensor f32 rate), while the bytes are 0.92 MB in and 1.35 MB out,
// 0.7 us at 3.35 TB/s: bound by bytes (chip_smoke.py counts the taps of each
// run's weights).
//
// Design: one block per (output row tile, image) computes all three channels.
//  1. It stages the tile's input rows of the three channels in shared memory
//     with 16-byte cp.async copies, only the columns [xc0, xc0 + xw) that
//     some output column reads (the crop drops the rest), in chunks of
//     chunk_rows rows when a very wide image's rows do not fit at once;
//  2. computes their horizontal pass, one (channel, output column) a thread
//     with its band's weights in registers, walking the rows; the quantized
//     values go to shared memory as uint8 (whole numbers in [0, 255]);
//  3. computes the vertical pass for four neighbouring pixels of one output
//     row a thread, all three channels, and writes their 12 floats as three
//     16-byte vectors: a warp writes whole NHWC pixel rows, contiguously.
// The kernel is bound by instruction issue, not bytes: every tap is a load,
// a byte-to-f32 step and an FMA. So bytes become f32 in the f32 adder (an
// I2F conversion runs at a quarter of its rate), each band is a block of
// kTaps unrolled taps whose loads issue together, and the host picks
// rows_per_tile as the tallest tile whose staged bytes fit a budget that
// leaves four blocks resident on an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
  int max_span;        // the largest hhi - hlo
  int chunk_rows;      // input rows staged at once
  int xc0, xw;         // staged input columns [xc0, xc0 + xw)
  float scale[3], shift[3];
};

// Round half to even, as rintf, in the f32 adder: 1.5 * 2^23 + v holds
// round(v) in its low mantissa bits (|v| < 2^22: the sums here stay under
// about 400). Then clamp to [0, 255].
__device__ __forceinline__ float quant(float v) {
  return fminf(fmaxf(__fsub_rn(__fadd_rn(v, 12582912.0f), 12582912.0f), 0.0f), 255.0f);
}
// A byte b (the low byte of w) as f32: 2^23 + b holds b in its low mantissa bits.
__device__ __forceinline__ float u8f(unsigned b) { return __fsub_rn(__int_as_float(0x4B000000u | b), 8388608.0f); }
// Byte j of w as f32, the same way, its bits placed by one byte permute.
__device__ __forceinline__ float byte_f32(unsigned w, int j) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B00u, 0x5440u | j)), 8388608.0f);
}
// A whole number in [0, 255] as its byte.
__device__ __forceinline__ uint8_t f2u8(float q) { return (uint8_t)(__float_as_int(__fadd_rn(q, 8388608.0f)) & 255); }

__device__ __forceinline__ size_t ys_bytes(const Params& p) { return ((size_t)3 * p.max_span * p.C + 15) & ~(size_t)15; }

// kVec: C % 4 == 0, so four neighbouring output pixels are 48 aligned bytes
// and four quantized columns one aligned 32-bit word. kTaps: the taps of a
// band block; a band longer than kTaps takes several blocks, and a tap past
// the band adds x * 0, exactly nothing, so every sum stays the ascending band
// sum.
template <bool kVec, int kTaps>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int hlo = p.tiles[2 * tile], hhi = p.tiles[2 * tile + 1];
  const int span = hhi - hlo;
  const int C = p.C, xw = p.xw;
  uint8_t* ys = sm;                 // [3][span][C] horizontal pass, quantized
  uint8_t* xs = sm + ys_bytes(p);   // [3][chunk_rows][xw] staged input rows
  const uint8_t* img = p.x + (size_t)b * 3 * p.H * p.W + p.xc0;
  const bool vec_in = (xw & 15) == 0 && (p.W & 15) == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;

  for (int r0 = 0; r0 < span; r0 += p.chunk_rows) {
    const int k = min(p.chunk_rows, span - r0);
    // 1. input rows hlo + r0 .. + k of each channel
    if (vec_in) {
      const int vpr = xw / 16;
      for (int i = threadIdx.x; i < 3 * k * vpr; i += kThreads) {
        const int cr = i / vpr;  // channel * k + row
        const int v = i - cr * vpr;
        const int ch = cr / k, rr = cr - ch * k;
        const uint8_t* src = img + ((size_t)ch * p.H + hlo + r0 + rr) * p.W + 16 * v;
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(xs + (ch * p.chunk_rows + rr) * xw + 16 * v));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
    } else {
      for (int i = threadIdx.x; i < 3 * k * xw; i += kThreads) {
        const int cr = i / xw;
        const int c = i - cr * xw;
        const int ch = cr / k, rr = cr - ch * k;
        xs[(ch * p.chunk_rows + rr) * xw + c] = __ldg(img + ((size_t)ch * p.H + hlo + r0 + rr) * p.W + c);
      }
    }
    __syncthreads();

    // 2. their horizontal pass: a (channel, output column) a thread, its
    // band's weights in registers across the rows
    for (int e = threadIdx.x; e < 3 * C; e += kThreads) {
      const int ch = e / C;
      const int col = e - ch * C;
      const int lo = p.hband[2 * col], n = p.hband[2 * col + 1] - lo;
      const float* wrow = p.whb + (size_t)col * p.htaps;
      const uint8_t* xr = xs + ch * p.chunk_rows * xw + (lo - p.xc0);
      uint8_t* yr = ys + (ch * span + r0) * C + col;
      if (n <= kTaps) {  // the whole band in one block: the common case
        float wt[kTaps];
        int off[kTaps];
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          wt[j] = j < n ? __ldg(wrow + j) : 0.0f;
          off[j] = j < n ? j : 0;
        }
#pragma unroll 2
        for (int r = 0; r < k; ++r) {
          const uint8_t* x = xr + r * xw;
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < kTaps; ++j) acc = fmaf(u8f(x[off[j]]), wt[j], acc);
          yr[r * C] = f2u8(quant(acc));
        }
      } else {
        for (int r = 0; r < k; ++r) {
          const uint8_t* x = xr + r * xw;
          float acc = 0.0f;
          for (int t0 = 0; t0 < n; t0 += kTaps) {
#pragma unroll
            for (int j = 0; j < kTaps; ++j) {
              const bool live = t0 + j < n;
              acc = fmaf(u8f(x[live ? t0 + j : 0]), live ? __ldg(wrow + t0 + j) : 0.0f, acc);
            }
          }
          yr[r * C] = f2u8(quant(acc));
        }
      }
    }
    __syncthreads();  // ys rows done; xs free for the next chunk
  }

  // 3. the vertical pass, all three channels of kPix neighbouring pixels a thread
  constexpr int kPix = kVec ? 4 : 1;
  const int o0 = tile * p.rows_per_tile;
  const int rows = min(p.rows_per_tile, C - o0);
  const int per_row = C / kPix;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int orow = e / per_row;
    const int col = (e - orow * per_row) * kPix;
    const int o = o0 + orow;
    const float* wrow = p.wv + (size_t)o * p.H;
    float s[3][kPix];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int j = 0; j < kPix; ++j) s[ch][j] = 0.0f;
    const int vlo = p.vband[2 * o], vn = p.vband[2 * o + 1] - vlo;
    for (int t0 = 0; t0 < vn; t0 += kTaps) {  // the loads of a block first
      float w[kTaps];
      unsigned yv[kTaps][3];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const bool live = t0 + t < vn;
        const int h = live ? vlo + t0 + t : vlo;
        w[t] = live ? __ldg(wrow + h) : 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const uint8_t* yr = ys + (ch * span + h - hlo) * C + col;
          if constexpr (kVec) {
            yv[t][ch] = *reinterpret_cast<const unsigned*>(yr);
          } else {
            yv[t][ch] = yr[0];
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
#pragma unroll
          for (int j = 0; j < kPix; ++j) s[ch][j] = fmaf(w[t], byte_f32(yv[t][ch], j), s[ch][j]);
    }
    float r[3 * kPix];  // pixel-major, as NHWC lays them out
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) r[3 * j + ch] = __fadd_rn(__fmul_rn(quant(s[ch][j]), p.scale[ch]), p.shift[ch]);
    float* dst = p.out + (((size_t)b * C + o) * C + col) * 3;
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < 3; ++v)
        reinterpret_cast<float4*>(dst)[v] = make_float4(r[4 * v], r[4 * v + 1], r[4 * v + 2], r[4 * v + 3]);
    } else {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) dst[ch] = r[ch];
    }
  }
}

template <bool kVec, int kTaps>
int launch(const Params& p, int ntiles, int B, size_t smem, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(preprocess_kernel<kVec, kTaps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(ntiles, B);
  preprocess_kernel<kVec, kTaps><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x uint8 [B, 3, H, W]; whb f32 [C, htaps]; hband, vband int32 [C, 2];
// wv f32 [C, H]; tiles int32 [ntiles, 2]; out f32 [B, C, C, 3], 16-byte
// aligned. max_span is the largest hhi - hlo of the tiles, chunk_rows the
// input rows a block stages at once, [xc0, xc0 + xw) the input columns it
// stages, vtaps the longest vertical band (ops/preprocess_cuda.py).
// Returns a cudaError_t code.
extern "C" int preprocess_fwd(const uint8_t* x, const float* whb, const int* hband, const float* wv,
                              const int* vband, const int* tiles, float* out, int B, int H, int W,
                              int C, int htaps, int vtaps, int rows_per_tile, int ntiles, int max_span,
                              int chunk_rows, int xc0, int xw, float s0, float s1, float s2, float h0,
                              float h1, float h2, void* stream) {
  if (B <= 0 || ntiles <= 0 || max_span <= 0 || chunk_rows <= 0 || B > 65535 || xc0 < 0 || xw <= 0 ||
      xc0 + xw > W)
    return (int)cudaErrorInvalidValue;
  Params p{x, whb, hband, wv, vband, tiles, out, H, W, C, htaps, rows_per_tile, max_span, chunk_rows, xc0, xw,
           {s0, s1, s2}, {h0, h1, h2}};
  const size_t smem = (((size_t)3 * max_span * C + 15) & ~(size_t)15) + (size_t)3 * chunk_rows * xw;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0, short_bands = htaps <= 6 && vtaps <= 6;
  if (vec) return short_bands ? launch<true, 6>(p, ntiles, B, smem, s) : launch<true, 8>(p, ntiles, B, smem, s);
  return short_bands ? launch<false, 6>(p, ntiles, B, smem, s) : launch<false, 8>(p, ntiles, B, smem, s);
}
