// The int8 trunk's stem convolution, 7×7 at stride 2 with 3 rows and columns
// of zero padding, from 3 input channels to 64, in bf16 with f32
// accumulation, summed in one fixed order.
//
// Replaces the stem of airpose_tpu/ops/int8_trunk.py (:175-180), which XLA
// computed as a bf16 convolution on the TPU; the port ran it as cuDNN's bf16
// conv2d. cuDNN picks its algorithm, and with it the order in which each
// output's 147 products are summed, by batch size, so the same crop's stem
// map differed by one bf16 step on some elements between 1 and 60 crops, and
// the int8 quantization of the next layers carried such flips on into the
// features. This kernel sums every output in the same order whatever the
// batch, the crop's place in it or the grid: c, then kh, then kw, each step
// one f32 fused multiply-add of an exact bf16·bf16 product, starting from
// +0, rounded to bf16 once at the end. No split over K, no atomics.
//
// Layouts: x (N, H, W, 3) f32 NHWC, rounded to bf16 (to nearest even) as it
// is read, exactly as the plain version's x.to(bfloat16); w (64, 3, 7, 7)
// bf16 OIHW; out (N, Ho, Wo, 64) bf16 NHWC, Ho = (H − 1) / 2 + 1, before the
// bias: the max-pool, the folded BN's bias and the relu stay in PyTorch
// (max is exact and order-free).
//
// What bounds it on an H100 at the main path's shapes (128 crops of 224²):
// 30.2 GFLOP (0.03 ms at the dense bf16 tensor-core rate, 0.45 ms as f32
// FMAs on the CUDA cores at 67 TFLOP/s) against 282 MB to move (77 MB of f32
// crops in, 206 MB of bf16 map out: 0.084 ms at 3.35 TB/s). The design is the
// simple one: f32 FMAs on the CUDA cores, so the FMA floor bounds it. A block
// of 256 threads computes a tile of 4 output rows × 32 output columns × all
// 64 channels; its 13 × 69 × 3 input patch (as f32, each row split into its
// even and odd columns) and the 147 × 64 weights (as f32, tap-major) sit in
// shared memory. Warp w takes channels 8w .. 8w + 7 and lane l output column
// l of the tile, in each of the 4 rows: per tap a lane reads two float4 of
// weights (the same address across the warp: one broadcast each) and 4 input
// values (stride 2 in the image is stride 1 in its column-parity half, so a
// warp's 32 reads hit 32 banks) for 32 FMAs into 32 accumulators, and writes
// each pixel's 8 channels as one 16-byte store. Shared memory then serves
// 6 wavefronts for a warp's 32 FMAs. The weights are transposed into shared
// memory a tap row at a time, lanes on consecutive channels: written the
// other way round (lanes on consecutive taps, 64 floats apart) every store
// of a warp fell in one bank, and the staging took as long as the FMAs.
// A tensor-core version (wgmma over K = 147 padded to 160, no split-K) would
// be batch-invariant too; it is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUT = 64;
constexpr int CIN = 3;
constexpr int KS = 7;
constexpr int TAPS = CIN * KS * KS;  // 147
constexpr int TILE_R = 4;            // output rows of a block
constexpr int TILE_C = 32;           // output columns of a block
constexpr int IN_R = 2 * (TILE_R - 1) + KS;  // 13 input rows
constexpr int IN_C = 2 * (TILE_C - 1) + KS;  // 69 input columns
constexpr int IN_XP = 36;  // pitch of a row's even or odd columns (35 and 34 of them)
constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
stem_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            __nv_bfloat16* __restrict__ out, int H, int W, int Ho, int Wo) {
  __shared__ __align__(16) float sw[TAPS * COUT];             // [tap][cout]
  __shared__ float sx[CIN * IN_R * 2 * IN_XP];                // [c][row][col % 2][col / 2]

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * TILE_R;
  const int ox0 = blockIdx.x * TILE_C;
  const int iy0 = 2 * oy0 - 3;
  const int ix0 = 2 * ox0 - 3;

  // weights, OIHW → [tap = (c·7 + kh)·7 + kw][cout], exact in f32; lanes take
  // consecutive output channels of a tap, so their stores hit 32 banks (the
  // reads gather at stride 147 from the 18 KB weight, which stays in L1)
  for (int j = tid; j < TAPS * COUT; j += NTHREADS) {
    const int tap = j / COUT, o = j % COUT;
    sw[j] = __bfloat162float(w[o * TAPS + tap]);
  }
  // the input patch, rounded to bf16 and back (exact), zeros outside the image
  const float* xn = x + (size_t)n * H * W * CIN;
  for (int i = tid; i < IN_R * IN_C * CIN; i += NTHREADS) {
    const int c = i % CIN, rest = i / CIN;
    const int col = rest % IN_C, row = rest / IN_C;
    const int iy = iy0 + row, ix = ix0 + col;
    float v = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = __bfloat162float(__float2bfloat16_rn(xn[((size_t)iy * W + ix) * CIN + c]));
    sx[((c * IN_R + row) * 2 + (col & 1)) * IN_XP + (col >> 1)] = v;
  }
  __syncthreads();

  const int cg = tid >> 5;  // channels 8·cg .. 8·cg + 7: one group a warp
  const int pc = tid & 31;  // output column ox0 + pc: one a lane
  float acc[TILE_R][8];
#pragma unroll
  for (int i = 0; i < TILE_R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // the fixed order: c, kh, kw; each output's chain of FMAs runs in it
  for (int c = 0; c < CIN; ++c) {
    for (int kh = 0; kh < KS; ++kh) {
      // input column 2·pc + kw: index pc + kw / 2 of the row's kw % 2 half
      const float* xrow = sx + (c * IN_R + kh) * 2 * IN_XP + pc;
      const float* wrow = sw + ((c * KS + kh) * KS) * COUT + 8 * cg;
#pragma unroll
      for (int kw = 0; kw < KS; ++kw) {
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + kw * COUT);
        const float4 w1 = *reinterpret_cast<const float4*>(wrow + kw * COUT + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < TILE_R; ++i) {
          const float xv = xrow[(4 * i + (kw & 1)) * IN_XP + (kw >> 1)];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(xv, wv[j], acc[i][j]);
        }
      }
    }
  }

  const int ox = ox0 + pc;
  if (ox >= Wo) return;
#pragma unroll
  for (int i = 0; i < TILE_R; ++i) {
    const int oy = oy0 + i;
    if (oy >= Ho) break;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(acc[i][j]);
    *reinterpret_cast<uint4*>(out + (((size_t)n * Ho + oy) * Wo + ox) * COUT + 8 * cg) =
        *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

// x (N, H, W, 3) f32 NHWC, w (64, 3, 7, 7) bf16 → out (N, Ho, Wo, 64) bf16
// NHWC with Ho = (H − 1) / 2 + 1, Wo = (W − 1) / 2 + 1. Requires a 16-byte
// aligned out. Returns a cudaError_t.
extern "C" int airpose_int8_stem(const void* x, const void* w, void* out, int N, int H,
                                 int W, void* stream) {
  if (N < 0 || H < 1 || W < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const dim3 grid((Wo + TILE_C - 1) / TILE_C, (Ho + TILE_R - 1) / TILE_R, N);
  stem_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}
