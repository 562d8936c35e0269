// ResNet-50 layer1 on Hopper, eval mode with BatchNorm folded: one launch
// per bottleneck block, y1 and y2 kept on chip, the block's weights resident
// in shared memory.
//
// Replaces airpose_tpu/ops/fused_bottleneck.py::fused_stage1 (the Pallas
// TPU kernel _make_stage1_kernel), which kept one whole 56×56 image and its
// intermediates resident in ~6 MB of VMEM and ran all three blocks in one
// pass. A Hopper block has at most 227 KB of shared memory, so the image is
// cut into bands of TH output rows (TH = 4 at 56 columns). For each band:
//   1. y1 = relu(x·W1 + b1) over the band plus a one-row halo above and below
//      (recomputed by the neighbouring band), into shared memory with a zero
//      column on each side and zero rows outside the image: the 3×3 conv's
//      padding;
//   2. y2 = relu(conv3×3(y1) + b2), an implicit im2col GEMM of depth 9·64
//      over shared memory, into shared memory;
//   3. out = relu(y2·W3 + b3 + residual), where the residual is x·Wp + bp
//      (block 0, 64 → 256 projection) or x itself (blocks 1-2), written to
//      device memory.
//
// What bounds it on an H100: at 128 crops layer1 does 171 GFLOP (0.173 ms
// at 989 TFLOP/s bf16); its three launches move 1.08 GB (0.32 ms at
// 3.35 TB/s: each block reads its input and writes a 256-channel output),
// the TPU kernel's single pass 0.26 GB. The kernel's first version ran at
// 4% of the bf16 rate: every MMA read its weight fragments from L1 with
// 4-byte loads, phase 1 and the projection read x by uncoalesced 4-byte
// loads, and each of the 1,792 blocks of 4 rows fetched every weight again.
// This version:
//   * is persistent: min(bands, SMs) blocks of 256 threads walk over the
//     bands, and each stages the block's weights into shared memory once,
//     by 16-byte cp.async;
//   * keeps every shared operand in rows of 128 bytes (64 bf16 channels)
//     with the 16-byte chunks swizzled (chunk c of row r at c ^ (r mod 8)),
//     the layout of wgmma's 128-byte swizzle, so that the weights, y2 and
//     the projection's x tile are wgmma operands as they lie;
//   * runs the 3×3 and conv3 (+ projection) on wgmma, one 64-pixel tile per
//     warpgroup: the 3×3 with A in registers, because its A rows are the
//     tap-shifted y1 rows (one ldmatrix.x4 address per row; the im2col is
//     never formed) and B, the tap's weights, from shared memory; conv3 and
//     the projection with A and B from shared memory, into one accumulator,
//     in two halves of 128 output channels;
//   * keeps phase 1 (the 1×1 into y1, 4-16k MACs a pixel) on mma.sync
//     m16n8k16 fed by ldmatrix, with x staged by coalesced 16-byte cp.async
//     into a per-warp ring of two 16-pixel × 64-channel buffers, so that no
//     warp waits on a block-wide barrier for its A tiles.
// chip_smoke.py's phase 3 on H100 80GB HBM3 cards at 700 W measured the
// wgmma version at 1.11 ms at (128, 56, 56, 64) and the same design with
// mma.sync in phases 2 and 3 at 1.20 ms.
// Shared memory (bytes), at W = 56, TH = 4: weights 147,456 (block 0: w1
// 8,192, w2 73,728, w3 32,768, wp 32,768) or 139,264 (blocks 1-2: w1 32,768);
// y1 (TH + 2)·(W + 2) rows = 44,544, rounded to 45,056 so that every region
// starts 1,024-byte aligned; y2 in whole 64-row tiles, 32,768 (in phase 1 the
// warps' x buffers). With 1,024 bytes to align the base: 226,304 / 218,112 of
// 232,448, one block per SM. TH falls to 2 or 1 for wider images (up to 128
// columns).
//
// Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
// biases, relu and round-to-nearest bf16 after y1, after y2 and after each
// block output; the identity residual is added in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CMID = 64;
constexpr int COUT = 256;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROW = 128;    // bytes of one shared row: 64 bf16 channels
constexpr int STG = 2048;   // one x buffer of phase 1: 16 rows
constexpr int MT = 64;      // pixels per wgmma tile (phases 2 and 3)
constexpr int XT = MT * ROW;  // one x tile of phase 3: 64 rows

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

__host__ __device__ constexpr int weight_bytes(int cin) {
  return cin * ROW + 9 * CMID * ROW + COUT * ROW + (cin == CMID ? COUT * ROW : 0);
}
// y1 holds the band and its halo; in phase 3 it holds the projection's x
// tile of each warpgroup. Regions start 1024-byte aligned, as the wgmma
// operands' 128-byte swizzle needs.
__host__ __device__ inline int y1_bytes(int th, int W) {
  const int n = (th + 2) * (W + 2) * ROW;
  return round_up(n > 2 * XT ? n : 2 * XT, 1024);
}
// y2 holds the band's y2, in whole 64-row tiles; in phase 1 it holds the
// two x buffers of each warp.
__host__ __device__ inline int y2_bytes(int th, int W) {
  const int n = round_up(th * W, MT) * ROW;
  return n > NWARPS * 2 * STG ? n : NWARPS * 2 * STG;
}

// Byte offset of 16-byte chunk c of row r in a swizzled region.
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)(r * ROW + ((c ^ (r & 7)) << 4));
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// wgmma: bf16 operands, f32 accumulation, B (and A, for SS) read from
// shared memory through descriptors: K-major rows of 128 bytes in the
// 128-byte swizzle (the layout of sw()), 8-row groups 1024 bytes apart,
// the tile's base 1024-byte aligned; a k16 step adds 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// st.shared and cp.async write through the generic proxy; wgmma reads
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// 128 threads of one warpgroup.
__device__ __forceinline__ void bar_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// D (64 × 64) += A (64 × 16, this warp's 16 rows in mma.sync's A fragment
// layout, in registers) · B (64 × 16 at `db`)ᵀ.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 × 128) += A (64 × 16 at `da`) · B (128 × 16 at `db`)ᵀ.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies w (N, K) bf16 row-major into shared memory at `base` as K / 64
// blocks of N swizzled rows.
__device__ __forceinline__ void stage_weights(uint32_t base, const bf16* w, int N, int K) {
  const int per_row = K / 8;
  for (int i = threadIdx.x; i < N * per_row; i += NTHREADS) {
    const int n = i / per_row, kc = i - n * per_row;
    cp_async16(base + (kc >> 3) * N * ROW + sw(n, kc & 7), w + (size_t)n * K + kc * 8);
  }
}

// One warp's 16 × (16·NP) tile over one 64-deep K block: acc += A·Bᵀ. The
// lane's A row (row lane % 16 of the tile) starts at `arow` with swizzle key
// `akey`; B's first row (n-tile 0) starts at `b` and is 16-row aligned.
template <int NP>
__device__ __forceinline__ void mma_k64(float (&acc)[2 * NP][4], uint32_t arow, int akey,
                                        uint32_t b, int lane) {
  const int a_hi = lane >> 4, b_hi = (lane >> 3) & 1, bkey = lane & 7;
  const uint32_t brow = b + (((lane >> 4) << 3) | (lane & 7)) * ROW;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + (((ks * 2 + a_hi) ^ akey) << 4));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bb[4];
      ldmatrix_x4(bb, brow + np * 16 * ROW + (((ks * 2 + b_hi) ^ bkey) << 4));
      mma16816(acc[2 * np], a, bb);
      mma16816(acc[2 * np + 1], a, bb + 2);
    }
  }
}

// Copies 16 pixel rows × channels [64·kb, 64·kb + 64) of x, starting at
// pixel p0 (rows past `last` repeat it), into a swizzled x buffer.
template <int CIN>
__device__ __forceinline__ void stage_x(uint32_t buf, const bf16* x, int p0, int last,
                                        int kb, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (lane >> 3) + 4 * j, c = lane & 7;
    cp_async16(buf + sw(r, c), x + (size_t)min(p0 + r, last) * CIN + kb * 64 + c * 8);
  }
}

template <int CIN>
__global__ void __launch_bounds__(NTHREADS, 1) bottleneck_kernel(
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
    int B, int H, int W, int th) {
  constexpr bool PROJ = CIN != COUT;
  constexpr int W1 = 0, W2 = CIN * ROW, W3 = W2 + 9 * CMID * ROW, WPO = W3 + COUT * ROW;
  constexpr int Y1 = weight_bytes(CIN);
  extern __shared__ uint4 smem_raw[];
  // 1024-byte alignment, which the 128-byte swizzle's 8-row atoms need
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_raw);
  sm += (1024 - (smem_u32(sm) & 1023)) & 1023;
  const uint32_t su = smem_u32(sm);
  const int Y2 = Y1 + y1_bytes(th, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3, arow = lane & 15;
  const int wg = warp >> 2, wr = (warp & 3) * 16;  // warpgroup; the warp's rows in a wgmma tile

  stage_weights(su + W1, w1, CMID, CIN);
  stage_weights(su + W2, w2, CMID, 9 * CMID);
  stage_weights(su + W3, w3, COUT, CMID);
  if constexpr (PROJ) stage_weights(su + WPO, wp, COUT, CIN);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int bands = (H + th - 1) / th;
  for (int band = blockIdx.x; band < B * bands; band += gridDim.x) {
    const int img = band / bands, r0 = (band - img * bands) * th;
    const int nrows = min(th, H - r0);

    // y1's border columns and its rows outside the image are the zero padding.
    for (int i = threadIdx.x; i < (th + 2) * (W + 2) * 8; i += NTHREADS) {
      const int idx = i >> 3, srow = idx / (W + 2), col = idx - srow * (W + 2);
      const int t = r0 - 1 + srow;
      if (col == 0 || col == W + 1 || t < 0 || t >= H)
        reinterpret_cast<uint4*>(sm + Y1)[i] = make_uint4(0u, 0u, 0u, 0u);
    }

    // ---- 1. y1 over the band's rows and halo (pixels are contiguous in x) ----
    {
      const int rlo = max(r0 - 1, 0), m1 = (min(r0 + th, H - 1) - rlo + 1) * W;
      const int srow0 = rlo - (r0 - 1);
      const bf16* x1 = x + ((size_t)img * H + rlo) * W * CIN;
      const uint32_t stg = su + Y2 + warp * 2 * STG;
      for (int task = warp; task < (m1 + 15) / 16; task += NWARPS) {
        const int p0 = task * 16;
        float acc[8][4] = {};
        stage_x<CIN>(stg, x1, p0, m1 - 1, 0, lane);
        cp_async_commit();
#pragma unroll
        for (int kb = 0; kb < CIN / 64; ++kb) {
          if (kb + 1 < CIN / 64) stage_x<CIN>(stg + ((kb + 1) & 1) * STG, x1, p0, m1 - 1, kb + 1, lane);
          cp_async_commit();
          cp_async_wait<1>();
          __syncwarp();
          mma_k64<4>(acc, stg + (kb & 1) * STG + arow * ROW, arow & 7,
                     su + W1 + kb * CMID * ROW, lane);
          __syncwarp();  // the buffer is refilled two K blocks on
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h;
          if (p >= m1) continue;
          const int rr = p / W;
          const int idx = (srow0 + rr) * (W + 2) + p - rr * W + 1;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = nt * 8 + 2 * tg;
            *reinterpret_cast<uint32_t*>(sm + Y1 + sw(idx, nt) + 4 * tg) =
                pack_bf16(fmaxf(acc[nt][2 * h] + __ldg(b1 + n), 0.f),
                          fmaxf(acc[nt][2 * h + 1] + __ldg(b1 + n + 1), 0.f));
          }
        }
      }
    }
    __syncthreads();

    // ---- 2. y2 = relu(conv3×3(y1) + b2): 64-pixel tiles, one per warpgroup,
    // 9 taps × 4 k16 steps of wgmma with A in registers: ldmatrix reads each
    // tap's shifted y1 rows, one address per row ----
    const int m2 = nrows * W, tiles = (m2 + MT - 1) / MT;
    for (int t = wg; t < tiles; t += 2) {
      const int q = min(t * MT + wr + arow, m2 - 1);
      const int orow = q / W;
      const int base = orow * (W + 2) + q - orow * W;  // y1 row of tap (0, 0)
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int idx = base + (tap / 3) * (W + 2) + tap % 3;
        const uint32_t arow_addr = su + Y1 + idx * ROW;
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldmatrix_x4(a[ks], arow_addr + (((ks * 2 + (lane >> 4)) ^ (idx & 7)) << 4));
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_n64(acc, a[ks], desc_sw128(su + W2 + tap * CMID * ROW + ks * 32));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = t * MT + wr + g + 8 * h;
        if (p >= m2) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = nt * 8 + 2 * tg;
          *reinterpret_cast<uint32_t*>(sm + Y2 + sw(p, nt) + 4 * tg) =
              pack_bf16(fmaxf(acc[4 * nt + 2 * h] + __ldg(b2 + n), 0.f),
                        fmaxf(acc[4 * nt + 2 * h + 1] + __ldg(b2 + n + 1), 0.f));
        }
      }
    }
    fence_proxy_async();  // y2 is read by phase 3's wgmma
    __syncthreads();

    // ---- 3. out = relu(y2·W3 + b3 + residual): 64-pixel tiles, one per
    // warpgroup, in two halves of 128 output channels; the projection's x
    // tile is staged beside y2 and accumulated into the same wgmma ----
    const bf16* xo = x + ((size_t)img * H + r0) * W * CIN;
    bf16* o = out + ((size_t)img * H + r0) * W * COUT;
    const uint32_t xt = su + Y1 + wg * XT;
    for (int t = wg; t < tiles; t += 2) {
      if constexpr (PROJ) {
        bar_warpgroup(wg);  // the previous tile's wgmma are done with xt
        for (int i = (threadIdx.x & 127); i < MT * 8; i += 128) {
          const int r = i >> 3, c = i & 7;
          cp_async16(xt + sw(r, c), xo + (size_t)min(t * MT + r, m2 - 1) * CIN + c * 8);
        }
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        bar_warpgroup(wg);
      }
#pragma unroll 1
      for (int nh = 0; nh < 2; ++nh) {
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n128(acc, desc_sw128(su + Y2 + t * XT + ks * 32),
                        desc_sw128(su + W3 + nh * 128 * ROW + ks * 32));
        if constexpr (PROJ) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n128(acc, desc_sw128(xt + ks * 32),
                          desc_sw128(su + WPO + nh * 128 * ROW + ks * 32));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = t * MT + wr + g + 8 * h;
          if (p >= m2) continue;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int n = nh * 128 + nt * 8 + 2 * tg;
            float v0 = acc[4 * nt + 2 * h] + __ldg(b3 + n), v1 = acc[4 * nt + 2 * h + 1] + __ldg(b3 + n + 1);
            if constexpr (PROJ) {
              v0 += __ldg(bp + n);
              v1 += __ldg(bp + n + 1);
            } else {
              const unsigned int r = ldg32(xo + (size_t)p * CIN + n);
              const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
              v0 += rf.x;
              v1 += rf.y;
            }
            *reinterpret_cast<uint32_t*>(o + (size_t)p * COUT + n) =
                pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
      }
    }
    __syncthreads();  // y1 and y2 are rewritten by the next band
  }
}

template <int CIN>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* wp,
           const void* bp, void* out, int B, int H, int W,
           cudaStream_t stream) {
  int dev, max_smem, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // 4 rows per band where they fit, else 2, else 1; 1024 bytes for the alignment
  auto bytes = [&](int th) { return weight_bytes(CIN) + y1_bytes(th, W) + y2_bytes(th, W) + 1024; };
  int th = 4;
  while (th > 1 && bytes(th) > max_smem) th /= 2;
  const int smem = bytes(th);
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bottleneck_kernel<CIN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = B * ((H + th - 1) / th);
  bottleneck_kernel<CIN><<<bands < sms ? bands : sms, NTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)b2, (const bf16*)w3, (const float*)b3, (const bf16*)wp,
      (const float*)bp, (bf16*)out, B, H, W, th);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer1 bottleneck block over (B, H, W, cin) bf16 NHWC → (B, H, W, 256).
// cin = 64: block 0, with the projection shortcut (wp, bp); cin = 256: an
// identity block (wp, bp unused). W is at most 128. Returns a cudaError_t.
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
