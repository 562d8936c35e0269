// ResNet-50 layer1 on Hopper, eval mode with BatchNorm folded: one launch
// per bottleneck block, y1 and y2 kept on chip.
//
// Replaces airpose_tpu/ops/fused_bottleneck.py::fused_stage1 (the Pallas
// TPU kernel _make_stage1_kernel), which kept one whole 56×56 image and its
// intermediates resident in ~6 MB of VMEM and ran all three blocks in one
// pass. A Hopper block has at most 227 KB of shared memory, so the image is
// cut into bands of TH = 4 output rows. Each block of this kernel:
//   1. computes y1 = relu(x·W1 + b1) for its band plus a one-row halo above
//      and below (recomputed by the neighbouring band) into shared memory,
//      with a zero column on each side: that is the 3×3 conv's padding;
//   2. computes y2 = relu(conv3×3(y1) + b2) as an implicit im2col GEMM of
//      depth 9·64 over shared memory, into shared memory;
//   3. computes out = relu(y2·W3 + b3 + residual), where the residual is
//      x·Wp + bp (block 0, 64 → 256 projection) or x itself (blocks 1-2),
//      and writes the 256-channel block output to device memory.
// Only the block inputs and outputs touch device memory; the three launches
// of layer1 write two 256-channel intermediates that the TPU kernel did not.
//
// Numerics follow the TPU kernel: bf16 operands, f32 accumulation (bf16
// mma.sync m16n8k16), f32 biases, relu and round-to-nearest bf16 after y1,
// after y2 and after each block output; the identity residual is added in
// f32. Weights are read through L1/L2 in this version.
//
// What bounds it on an H100: at 128 crops layer1 does ~171 GFLOP against
// ~257 MB of compulsory traffic, so the bound is the bf16 tensor-core rate
// (~0.17 ms). mma.sync fed from shared memory and L1 is well below that
// rate; wgmma with TMA-fed weight tiles and a single launch with a 3-row
// halo are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CMID = 64;
constexpr int COUT = 256;
constexpr int TH = 4;            // output rows per block
constexpr int LDS = CMID + 8;    // shared row stride in bf16: 144 B, conflict-free fragments
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulates a 16-row × (8·NT)-column tile of A·Bᵀ over K: rows a_lo (this
// lane's row g) and a_hi (row g + 8) of A, each already offset by 2·(lane%4);
// B is (N, K) row-major with row stride ldb, already offset to the tile's
// first row + g and by 2·(lane%4). A comes from shared (SHARED) or global
// memory, B from global memory.
template <int NT, int K, bool SHARED>
__device__ __forceinline__ void mma_rows(float acc[][4], const bf16* a_lo,
                                         const bf16* a_hi, const bf16* b,
                                         int ldb) {
#pragma unroll 4
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    if (SHARED) {
      a[0] = lds32(a_lo + k); a[1] = lds32(a_hi + k);
      a[2] = lds32(a_lo + k + 8); a[3] = lds32(a_hi + k + 8);
    } else {
      a[0] = ldg32(a_lo + k); a[1] = ldg32(a_hi + k);
      a[2] = ldg32(a_lo + k + 8); a[3] = ldg32(a_hi + k + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* w = b + (size_t)nt * 8 * ldb + k;
      const uint32_t bb[2] = {ldg32(w), ldg32(w + 8)};
      mma16816(acc[nt], a, bb);
    }
  }
}

template <int CIN>
__global__ void __launch_bounds__(NTHREADS, 2) bottleneck_kernel(
    const bf16* __restrict__ x,    // (B, H, W, CIN)
    const bf16* __restrict__ w1,   // (CMID, CIN)
    const float* __restrict__ b1,  // (CMID)
    const bf16* __restrict__ w2,   // (CMID, 9·CMID), k = (kh·3 + kw)·CMID + cin
    const float* __restrict__ b2,  // (CMID)
    const bf16* __restrict__ w3,   // (COUT, CMID)
    const float* __restrict__ b3,  // (COUT)
    const bf16* __restrict__ wp,   // (COUT, CIN), projection blocks only
    const float* __restrict__ bp,  // (COUT), projection blocks only
    bf16* __restrict__ out,        // (B, H, W, COUT)
    int H, int W) {
  constexpr bool PROJ = CIN != COUT;
  extern __shared__ uint4 smem_raw[];
  bf16* y1 = reinterpret_cast<bf16*>(smem_raw);  // (TH + 2, W + 2, LDS)
  bf16* y2 = y1 + (TH + 2) * (W + 2) * LDS;      // (TH · W, LDS)

  const int bands = (H + TH - 1) / TH;
  const int img = blockIdx.x / bands;
  const int r0 = (blockIdx.x - img * bands) * TH;
  const int nrows = min(TH, H - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;

  // y1's border (and its rows outside the image) is the 3×3 zero padding.
  for (int i = threadIdx.x; i < (TH + 2) * (W + 2) * LDS / 8; i += NTHREADS)
    smem_raw[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // ---- 1. y1 over the band and its halo rows (pixels are contiguous) ----
  const int rlo = max(r0 - 1, 0);
  const int m1 = (min(r0 + nrows + 1, H) - rlo) * W;
  const bf16* x1 = x + ((size_t)img * H + rlo) * W * CIN;
  for (int task = warp; task < (m1 + 15) / 16 * 2; task += NWARPS) {
    const int pa = (task >> 1) * 16 + g, pb = pa + 8, n0 = (task & 1) * 32;
    float acc[4][4] = {};
    mma_rows<4, CIN, false>(acc, x1 + (size_t)min(pa, m1 - 1) * CIN + 2 * tg,
                            x1 + (size_t)min(pb, m1 - 1) * CIN + 2 * tg,
                            w1 + (size_t)(n0 + g) * CIN + 2 * tg, CIN);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = h ? pb : pa;
      if (p >= m1) continue;
      const int row = rlo + p / W - (r0 - 1), col = p % W + 1;
      bf16* dst = y1 + (row * (W + 2) + col) * LDS;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + nt * 8 + 2 * tg;
        *reinterpret_cast<uint32_t*>(dst + n) =
            pack_bf16(fmaxf(acc[nt][2 * h] + b1[n], 0.f),
                      fmaxf(acc[nt][2 * h + 1] + b1[n + 1], 0.f));
      }
    }
  }
  __syncthreads();

  // ---- 2. y2 = relu(conv3×3(y1) + b2), 9 taps × 64 channels ----
  const int m2 = nrows * W;
  for (int task = warp; task < (m2 + 15) / 16 * 2; task += NWARPS) {
    const int pa = (task >> 1) * 16 + g, pb = pa + 8, n0 = (task & 1) * 32;
    const int qa = min(pa, m2 - 1), qb = min(pb, m2 - 1);
    // output (r, c) reads y1 rows r..r+2 and columns c..c+2
    const bf16* ya = y1 + ((qa / W) * (W + 2) + qa % W) * LDS + 2 * tg;
    const bf16* yb = y1 + ((qb / W) * (W + 2) + qb % W) * LDS + 2 * tg;
    float acc[4][4] = {};
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * (W + 2) + tap % 3) * LDS;
      mma_rows<4, CMID, true>(acc, ya + off, yb + off,
                              w2 + (size_t)(n0 + g) * 9 * CMID + tap * CMID + 2 * tg,
                              9 * CMID);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = h ? pb : pa;
      if (p >= m2) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + nt * 8 + 2 * tg;
        *reinterpret_cast<uint32_t*>(y2 + p * LDS + n) =
            pack_bf16(fmaxf(acc[nt][2 * h] + b2[n], 0.f),
                      fmaxf(acc[nt][2 * h + 1] + b2[n + 1], 0.f));
      }
    }
  }
  __syncthreads();

  // ---- 3. out = relu(y2·W3 + b3 + residual), 64 output channels per task ----
  const bf16* xo = x + ((size_t)img * H + r0) * W * CIN;
  bf16* o = out + ((size_t)img * H + r0) * W * COUT;
  for (int task = warp; task < (m2 + 15) / 16 * 4; task += NWARPS) {
    const int pa = (task >> 2) * 16 + g, pb = pa + 8, n0 = (task & 3) * 64;
    const int qa = min(pa, m2 - 1), qb = min(pb, m2 - 1);
    float acc[8][4] = {};
    mma_rows<8, CMID, true>(acc, y2 + qa * LDS + 2 * tg, y2 + qb * LDS + 2 * tg,
                            w3 + (size_t)(n0 + g) * CMID + 2 * tg, CMID);
    if constexpr (PROJ)
      mma_rows<8, CIN, false>(acc, xo + (size_t)qa * CIN + 2 * tg,
                              xo + (size_t)qb * CIN + 2 * tg,
                              wp + (size_t)(n0 + g) * CIN + 2 * tg, CIN);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = h ? pb : pa;
      if (p >= m2) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + nt * 8 + 2 * tg;
        float v0 = acc[nt][2 * h] + b3[n], v1 = acc[nt][2 * h + 1] + b3[n + 1];
        if constexpr (PROJ) {
          v0 += bp[n];
          v1 += bp[n + 1];
        } else {
          const unsigned int r = ldg32(xo + (size_t)p * CIN + n);
          const float2 rf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r));
          v0 += rf.x;
          v1 += rf.y;
        }
        *reinterpret_cast<uint32_t*>(o + (size_t)p * COUT + n) =
            pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

template <int CIN>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wp,
           const void* bp, void* out, int B, int H, int W,
           cudaStream_t stream) {
  const int smem = ((TH + 2) * (W + 2) + TH * W) * LDS * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = (H + TH - 1) / TH;
  bottleneck_kernel<CIN><<<B * bands, NTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)wp,
      (const float*)bp, (bf16*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer1 bottleneck block over (B, H, W, cin) bf16 NHWC → (B, H, W, 256).
// cin = 64: block 0, with the projection shortcut (wp, bp); cin = 256: an
// identity block (wp, bp unused). Returns a cudaError_t.
extern "C" int airpose_bottleneck_block(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* wp,
    const void* bp, void* out, int B, int H, int W, int cin, void* stream) {
  if (cin == CMID)
    return launch<CMID>(x, w1, b1, w2, b2, w3, b3, wp, bp, out, B, H, W,
                        (cudaStream_t)stream);
  if (cin == COUT)
    return launch<COUT>(x, w1, b1, w2, b2, w3, b3, wp, bp, out, B, H, W,
                        (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
