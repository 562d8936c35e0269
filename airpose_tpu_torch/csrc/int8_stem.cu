// The int8 trunk's whole stem in one launch: the 7×7 convolution at stride 2
// with 3 rows and columns of zero padding, from 3 input channels to 64, in
// bf16 with f32 accumulation; the 3×3 max-pool at stride 2 with one row and
// column of −inf padding; the folded BN's bias added in f32 and rounded to
// bf16 once; the relu:
//
//   y = relu(bf16(f32(maxpool(bf16(conv(bf16(x), w)))) + b))
//
// Replaces the stem of airpose_tpu/ops/int8_trunk.py (:175-184: conv, bias,
// relu, pool), which XLA computed as a bf16 convolution and a reduce_window
// on the TPU. The pool comes before the bias and relu here, as in the port's
// plain version: relu(bf16(f32(h) + b)) is monotone in h, so it commutes
// with the max.
//
// Batch invariance. cuDNN's bf16 convolution picks its algorithm, and with it
// the order in which each output's products are summed, by batch size, and
// the int8 quantization of the next layers carries a flipped bf16 rounding on
// into the features. Here every tile has one shape, whatever the batch: each
// conv output's products go through the same 11 wgmma k-steps in the same
// order, with no split over K and no atomics, whatever N, the crop's place in
// the batch or the block that takes the tile.
//
// Layouts: x (N, H, W, 3) f32 NHWC, rounded to bf16 (to nearest even, as
// x.to(bfloat16)) in shared memory; w (64, 3, 7, 7) bf16 OIHW; b (64) f32;
// out (N, Hp, Wp, 64) bf16 NHWC with Ho = (H − 1) / 2 + 1 and
// Hp = (Ho − 1) / 2 + 1 (224 → 112 → 56).
//
// What bounds it on an H100: at 128 crops of 224², 30.2 GFLOP of products
// (0.031 ms at 989 TFLOP/s bf16) against 128.5 MB to move (77.1 MB of f32
// crops in, 51.4 MB of pooled bf16 out: 0.038 ms at 3.35 TB/s), so bytes.
// The design keeps everything between the crops and the pooled map on chip:
//   * a tile is 7 pooled rows × 8 pooled columns, which need 15 × 17 = 255
//     conv outputs (M = 256, four wgmma m64 tiles, two a warpgroup) from a
//     35 × 39 × 3 input patch; a 224² crop is 8 × 7 = 56 tiles, and the halo
//     recomputes 1.14× the conv outputs on the tensor cores;
//   * K runs over the kernel rows kh, each as 24 taps: its 21 (kw, c) in the
//     patch's own NHWC order and 3 zeros, 7 · 24 = 168 padded to 176 (11 k16
//     steps). A lane's pair of taps then never crosses a kernel row, so its
//     A fragment is one 4-byte shared load at a constant offset from its
//     output pixel: wgmma takes A from registers, gathered from the bf16
//     patch, and the im2col never exists. The zero taps have zero weights
//     and A masked to zero (0 · inf would be NaN);
//   * B, the 176 × 64 weights, sits in shared memory in the 128-byte swizzle,
//     permuted from OIHW once by each persistent block;
//   * persistent blocks, two an SM, walk the tiles; the next tile's f32 patch
//     is in flight (16-byte cp.async, masked at the tensor's ends) while this
//     tile's conversion, wgmma and epilogue run;
//   * the epilogue rounds the accumulators to bf16 into a conv tile in shared
//     memory, takes the 3×3/2 max over it (−inf outside [0, Ho) × [0, Wo)),
//     adds b in f32, rounds, applies the relu and stores 16 bytes a thread.
// Shared memory (bytes): weights 24,576; conv tile 256 × 144 = 36,864 (the
// raw OIHW weights pass through it first); bf16 patch 35 × 240 = 8,400;
// bias 256; two f32 patches 2 × 35 × 496 = 34,720; 1,024 to align the base.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int COUT = 64;
constexpr int KS = 7;
constexpr int TAPS = 3 * KS * KS;      // 147
constexpr int KROW = 24;               // K of one kernel row: 21 taps + 3 zeros
constexpr int KSTEPS = 11;             // k16 steps: 7 · 24 = 168 padded to 176
constexpr int PY = 7, PX = 8;          // pooled rows and columns of a tile
constexpr int CY = 2 * PY + 1;         // 15 conv rows
constexpr int CX = 2 * PX + 1;         // 17 conv columns
constexpr int M = 256;                 // CY · CX = 255 conv outputs, padded
constexpr int IY = 2 * (CY - 1) + KS;  // 35 input rows
constexpr int IXE = 3 * (2 * (CX - 1) + KS);  // 117 input values a row (39 pixels)
constexpr int PITCH = 120;             // bf16 values a patch row (117 + 3 zeros)
constexpr int CHUNKS = 31;             // 16-byte chunks of a staged f32 row
constexpr int STAGE_ROW = CHUNKS * 16;  // bytes
constexpr int STAGE = IY * STAGE_ROW;  // bytes of one f32 patch
constexpr int CT_ROW = 144;            // bytes of a conv tile row: 64 bf16 + 16
constexpr int NTHREADS = 256;

constexpr int SM_W = 0;                          // 3 K blocks × 64 rows × 128 B
constexpr int SM_CT = SM_W + 3 * COUT * 128;     // conv tile
constexpr int SM_PATCH = SM_CT + M * CT_ROW;     // bf16 patch
constexpr int SM_BIAS = SM_PATCH + IY * PITCH * 2;
constexpr int SM_STAGE = SM_BIAS + COUT * 4;     // two f32 patches
constexpr int SM_ALLOC = SM_STAGE + 2 * STAGE + 1024;
static_assert(SM_STAGE % 16 == 0, "cp.async needs 16-byte aligned chunks");
static_assert(COUT * TAPS * 2 <= M * CT_ROW, "the raw weights pass through the conv tile");
static_assert(2 * (CY - 1) + KS - 1 < IY && 6 * (CX - 1) + 16 + 6 + 1 < PITCH,
              "the gather stays inside the patch");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes from global to shared memory; bytes past `src_bytes` are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ uint32_t& word(uint8_t* sm, int byte) {
  return *reinterpret_cast<uint32_t*>(sm + byte);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// Byte offset of 16-byte chunk c of row r in a region of 128-byte rows in
// wgmma's 128-byte swizzle.
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}
// wgmma: bf16 operands, f32 accumulation; B read from shared memory through a
// descriptor: K-major rows of 128 bytes in the 128-byte swizzle, 8-row groups
// 1024 bytes apart, the tile's base 1024-byte aligned; a k16 step adds 32
// bytes.
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
// st.shared writes through the generic proxy; wgmma reads B through the
// async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

struct Geometry {
  int H, W, Ho, Wo, Hp, Wp, tiles_x, tiles_per_crop;
  long long x_floats;  // N · H · W · 3
};

struct Tile {
  int n, py0, px0, iy0, ix0;  // crop, first pooled row and column, first input row and column
};

__device__ __forceinline__ Tile tile_at(const Geometry& g, int t) {
  Tile o;
  o.n = t / g.tiles_per_crop;
  const int r = t - o.n * g.tiles_per_crop;
  o.py0 = (r / g.tiles_x) * PY;
  o.px0 = (r % g.tiles_x) * PX;
  // pooled row p reads conv rows 2p − 1 .. 2p + 1; conv row c input rows 2c − 3 ..
  o.iy0 = 4 * o.py0 - 5;
  o.ix0 = 4 * o.px0 - 5;
  return o;
}

// Float index in x of input row iy's first patch value (negative before x).
__device__ __forceinline__ long long row_start(const Geometry& g, const Tile& t, int iy) {
  return ((long long)t.n * g.H + iy) * g.W * 3 + (long long)t.ix0 * 3;
}

// The tile's 35 input rows as f32, each from the 16-byte chunk that holds
// its first value: rows outside the image are left alone, chunks outside x
// are not read (the conversion masks both).
__device__ __forceinline__ void stage_patch(const Geometry& g, const float* x, uint32_t dst,
                                            const Tile& t) {
  for (int i = threadIdx.x; i < IY * 32; i += NTHREADS) {
    const int row = i >> 5, q = i & 31;
    const int iy = t.iy0 + row;
    if (q >= CHUNKS || iy < 0 || iy >= g.H) continue;
    const long long f = (row_start(g, t, iy) & ~3LL) + 4 * q;
    if (f < 0 || f >= g.x_floats) continue;
    const long long left = g.x_floats - f;
    cp_async16(dst + row * STAGE_ROW + q * 16, x + f, left >= 4 ? 16 : (int)left * 4);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
fused_stem_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ out, Geometry g,
                  int n_tiles) {
  extern __shared__ uint4 smem_raw[];
  // 1024-byte alignment, which the 128-byte swizzle's 8-row atoms need
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem_raw);
  sm += (1024 - (smem_u32(sm) & 1023)) & 1023;
  const uint32_t su = smem_u32(sm);
  const float* bias = reinterpret_cast<const float*>(sm + SM_BIAS);
  const int tid = threadIdx.x;

  // the raw OIHW weights into the conv tile's space, the first tile's patch
  for (int i = tid; i < COUT * TAPS * 2 / 16; i += NTHREADS)
    cp_async16(su + SM_CT + i * 16, reinterpret_cast<const uint8_t*>(w) + i * 16, 16);
  cp_async_commit();
  int tile = blockIdx.x;
  Tile cur = tile_at(g, tile);
  stage_patch(g, x, su + SM_STAGE, cur);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // B = the weights at k = 24·kh + 3·kw + c (zero for 3·kw + c ≥ 21 and
  // k ≥ 168), k-pairs of one output channel a thread, into the swizzle
  {
    const uint16_t* raw = reinterpret_cast<const uint16_t*>(sm + SM_CT);
    for (int i = tid; i < COUT * 96; i += NTHREADS) {
      const int n = i / 96, k = 2 * (i - n * 96);
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kh = (k + e) / KROW, j = (k + e) - kh * KROW;
        if (kh < KS && j < 21)
          v |= (uint32_t)raw[n * TAPS + (j % 3) * KS * KS + kh * KS + j / 3] << (16 * e);
      }
      word(sm, SM_W + (k >> 6) * COUT * 128 + sw(n, (k & 63) >> 3) + (k & 7) * 2) = v;
    }
    if (tid < COUT) reinterpret_cast<float*>(sm + SM_BIAS)[tid] = b[tid];
  }
  fence_proxy_async();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup; the warp's 16 rows of an m64 tile
  const int gr = lane >> 2, tg = lane & 3;  // the lane's rows gr, gr + 8 and taps 2·tg, 2·tg + 1
  // taps 16..23 of a kernel row: tg 0-1 real, tg 2 the 21st and a zero, tg 3 zeros
  const uint32_t mask16 = tg < 2 ? 0xFFFFFFFFu : (tg == 2 ? 0x0000FFFFu : 0u);

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int stage = SM_STAGE + (it & 1) * STAGE;
    const int next = tile + gridDim.x;
    if (next < n_tiles) stage_patch(g, x, su + SM_STAGE + ((it + 1) & 1) * STAGE, tile_at(g, next));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile's patch has arrived; the last tile's pool is done

    // ---- the patch to bf16, zeros outside the image: a row's values
    // [e_lo, e_hi) are its pixels inside the image ----
    const int e_lo = 3 * max(0, -cur.ix0), e_hi = 3 * min(IXE / 3, g.W - cur.ix0);
    for (int i = tid; i < IY * 64; i += NTHREADS) {
      const int row = i >> 6, e = 2 * (i & 63);
      const int iy = cur.iy0 + row;
      if (e >= PITCH) continue;
      float v0 = 0.f, v1 = 0.f;
      if (iy >= 0 && iy < g.H) {
        // the row's first value sits at its float index mod 4 in the staged chunks
        const uint32_t s =
            (((uint32_t)cur.n * g.H + iy) * (uint32_t)g.W + (uint32_t)cur.ix0) * 3u & 3u;
        const float* src = reinterpret_cast<const float*>(sm + stage + row * STAGE_ROW) + s + e;
        if (e >= e_lo && e < e_hi) v0 = src[0];
        if (e + 1 >= e_lo && e + 1 < e_hi) v1 = src[1];
      }
      word(sm, SM_PATCH + (row * PITCH + e) * 2) = pack_bf16(v0, v1);
    }
    __syncthreads();

    // ---- conv: two m64 tiles a warpgroup, 11 k16 steps each ----
#pragma unroll 1
    for (int mt = wg; mt < M / 64; mt += 2) {
      const int m0 = mt * 64 + wq * 16 + gr;
      const int m1 = min(m0 + 8, CY * CX - 1);  // row 255 repeats row 254 (never pooled)
      const int p0 = SM_PATCH + (2 * (m0 / CX) * PITCH + 6 * (m0 % CX) + 2 * tg) * 2;
      const int p1 = SM_PATCH + (2 * (m1 / CX) * PITCH + 6 * (m1 % CX) + 2 * tg) * 2;
      uint32_t a[KSTEPS][4];
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int c = 16 * s + 8 * hk, kh = c / KROW, j = c % KROW;
          uint32_t v0 = 0, v1 = 0;
          if (kh < KS) {
            const int off = (kh * PITCH + j) * 2;
            v0 = word(sm, p0 + off);
            v1 = word(sm, p1 + off);
            if (j == 16) {
              v0 &= mask16;
              v1 &= mask16;
            }
          }
          a[s][2 * hk] = v0;
          a[s][2 * hk + 1] = v1;
        }
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        wgmma_rs_n64(acc, a[s], desc_sw128(su + SM_W + (s >> 2) * COUT * 128 + (s & 3) * 32));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = SM_CT + (mt * 64 + wq * 16 + gr + 8 * h) * CT_ROW + 4 * tg;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          word(sm, row + nt * 16) = pack_bf16(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
      }
    }
    __syncthreads();

    // ---- 3×3/2 max-pool, bias, relu: 8 channels of a pooled pixel a thread ----
    for (int i = tid; i < PY * PX * 8; i += NTHREADS) {
      const int q = i & 7, pix = i >> 3;
      const int ly = pix / PX, lx = pix - ly * PX;
      const int oy = cur.py0 + ly, ox = cur.px0 + lx;
      if (oy >= g.Hp || ox >= g.Wp) continue;
      // the max of bf16 pairs, exact; NaN propagates, as in max_pool2d
      const __nv_bfloat16 ninf = __ushort_as_bfloat16(0xFF80);  // −inf
      __nv_bfloat162 mx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j] = __halves2bfloat162(ninf, ninf);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int cy = 2 * oy - 1 + dy;
        if (cy < 0 || cy >= g.Ho) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int cx = 2 * ox - 1 + dx;
          if (cx < 0 || cx >= g.Wo) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(
              sm + SM_CT + ((2 * ly + dy) * CX + 2 * lx + dx) * CT_ROW + q * 16);
          const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mx[j] = __hmax2_nan(mx[j], *reinterpret_cast<const __nv_bfloat162*>(&u[j]));
        }
      }
      const float4 b0 = *reinterpret_cast<const float4*>(bias + q * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + q * 8 + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float r[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 m = __bfloat1622float2(mx[e >> 1]);
        const float t = __bfloat162float(__float2bfloat16_rn(((e & 1) ? m.y : m.x) + bv[e]));
        r[e] = (t > 0.f || t != t) ? t : 0.f;
      }
      uint4 o;
      o.x = pack_bf16(r[0], r[1]);
      o.y = pack_bf16(r[2], r[3]);
      o.z = pack_bf16(r[4], r[5]);
      o.w = pack_bf16(r[6], r[7]);
      *reinterpret_cast<uint4*>(out + (((long long)cur.n * g.Hp + oy) * g.Wp + ox) * COUT + q * 8) = o;
    }
    if (next < n_tiles) cur = tile_at(g, next);
  }
  cp_async_wait<0>();
}

}  // namespace

// x (N, H, W, 3) f32 NHWC, w (64, 3, 7, 7) bf16 OIHW, b (64) f32 → out
// (N, Hp, Wp, 64) bf16 NHWC, Ho = (H − 1) / 2 + 1, Hp = (Ho − 1) / 2 + 1 (the
// same for W). Requires x, w and out 16-byte aligned. Returns a cudaError_t.
extern "C" int airpose_int8_stem(const void* x, const void* w, const void* b, void* out,
                                 int N, int H, int W, void* stream) {
  if (N < 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Geometry g;
  g.H = H;
  g.W = W;
  g.Ho = (H - 1) / 2 + 1;
  g.Wo = (W - 1) / 2 + 1;
  g.Hp = (g.Ho - 1) / 2 + 1;
  g.Wp = (g.Wo - 1) / 2 + 1;
  g.tiles_x = (g.Wp + PX - 1) / PX;
  g.tiles_per_crop = ((g.Hp + PY - 1) / PY) * g.tiles_x;
  g.x_floats = (long long)N * H * W * 3;
  const long long n_tiles = (long long)N * g.tiles_per_crop;
  if (n_tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;

  // blocks that fit at once, per device (the shared-memory attribute first)
  static int resident[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SM_ALLOC);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stem_kernel, NTHREADS,
                                                          SM_ALLOC);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int grid = n_tiles < resident[dev] ? (int)n_tiles : resident[dev];
  fused_stem_kernel<<<grid, NTHREADS, SM_ALLOC, (cudaStream_t)stream>>>(
      (const float*)x, (const bf16*)w, (const float*)b, (bf16*)out, g, (int)n_tiles);
  return (int)cudaGetLastError();
}
