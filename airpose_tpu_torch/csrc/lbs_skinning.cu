// Linear blend skinning on Hopper: out[b,v] = T[:3,:3]·p + T[:3,3] with
// T = Σ_j W[v,j]·A[b,j], never writing T to memory.
//
// Replaces airpose_tpu/bodymodel/pallas_lbs.py::skinning_pallas (the Pallas
// TPU kernel _skinning_kernel). The TPU version padded the joint axis to 128
// and laid vertices on lanes so that T came out of the MXU; none of that is
// carried over.
//
// What bounds it on an H100: at B = 128 bodies, V = 10475, J = 55 it does
// 885 M f32 FMAs (1.77 GFLOP: 0.0268 ms at 67 TFLOP/s) against ~34 MB of
// compulsory traffic (W once, A once, P in, out: 0.010 ms at 3.35 TB/s), so
// the f32 CUDA-core rate bounds it, and every issue slot that is not an FFMA
// is time lost. The numerics stay f32 throughout: no TF32, no tensor cores.
//
// Design: a small f32 GEMM C[v, (b, k)] = Σ_j W[v, j]·A[b, j, k] over the 12
// entries k of rows 0-2 of each 4×4 (row 3 is never read), with the
// transform fused into its epilogue.
//  * Register tiling. A tile is 128 vertices × 16 bodies. Each of the 8 warps
//    takes 2 bodies, each lane 8 vertices of one of them: 96 accumulators.
//    Per joint a lane reads two float4s of W (its vertices 4l..4l+3 and
//    64+4l..64+4l+3, 2 wavefronts a warp) and three float4s of A that its
//    half-warp shares (broadcasts, 1 wavefront each) for 96 FFMAs, and
//    loads the next joint's operands before the FFMAs of this one.
//  * One block of 8 warps per SM, persistent: the grid is one block per SM
//    and each block takes a contiguous run of tiles, body tiles innermost.
//    At B = 128 the 656 tiles are 4.97 per SM; two co-resident blocks of
//    128 registers a thread would leave 2.48 rounds of 264 tiles, whose last
//    round ran at the speed of a full one.
//  * Staging through a cp.async double buffer that runs across tiles, in
//    chunks of KJ joints (64 for J ≤ 64, one chunk at J = 55; 32 above, so
//    that J up to 256 fits): the next chunk, or the next tile's first one,
//    lands while this one is multiplied. A comes whole (the 4×4s of a body
//    and a chunk are one contiguous run) by coalesced 16-byte copies.
//  * W stays resident for a vertex tile: consecutive tiles of a block share
//    it, so a block loads it once or twice. Its rows are J floats long (not
//    16-byte aligned at J = 55), so it comes by 4-byte copies, coalesced
//    along each row's joints, into a tile [joint][vertex] padded to 132
//    floats a row, whose float4 reads meet no bank conflicts. Two slots when
//    J ≤ 64, so that the next vertex tile's W lands beside the current one.
//  * Epilogue through shared memory: p of each body (3·128 contiguous floats)
//    comes by 16-byte copies of the 16-byte-aligned span around it, issued
//    with the tile's last chunk, so that P may start at any float; each lane
//    turns its accumulators into 24 outputs in place and the warp stores
//    each body's run coalesced.
//  * Host: the dynamic shared-memory opt-in and the SM count are read once
//    per device.
// Measured on the H100 (PERF.md, section 6): the inner loop, not the copies,
// takes most of the time.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int VT = 128;               // vertices per tile
constexpr int BT = 16;                // bodies per tile
constexpr int NT = 256;               // 8 warps × 2 bodies; 16 lanes × 8 vertices a body
constexpr int WS = VT + 4;            // row stride of the resident W tile, floats
constexpr int PS = VT * 3 + 4;        // p / out span of one body, with alignment slack
constexpr int P_FLOATS = BT * PS;
constexpr int MAX_J = 256;

template <int KJ>
struct Layout {
  static constexpr int A_FLOATS = BT * KJ * 16;  // one stage: [body][joint][16]
  __host__ __device__ static constexpr int w_slots(int J) { return J <= 64 ? 2 : 1; }
  __host__ __device__ static constexpr int smem_bytes(int J) {
    return (2 * A_FLOATS + P_FLOATS + w_slots(J) * J * WS) * (int)sizeof(float);
  }
};
static_assert(Layout<64>::smem_bytes(64) <= 232448 && Layout<32>::smem_bytes(MAX_J) <= 232448,
              "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// With valid == false no byte is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[g][i][k] += w of vertex (g, i) × entry k of the body's A rows 0-2
__device__ __forceinline__ void fma_joint(float (&acc)[2][4][12], const float4 (&w)[2],
                                          const float4 (&x)[3]) {
  const float a[12] = {x[0].x, x[0].y, x[0].z, x[0].w, x[1].x, x[1].y,
                       x[1].z, x[1].w, x[2].x, x[2].y, x[2].z, x[2].w};
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const float wv[4] = {w[g].x, w[g].y, w[g].z, w[g].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 12; ++k) acc[g][i][k] = fmaf(wv[i], a[k], acc[g][i][k]);
  }
}

template <int KJ>
__global__ void __launch_bounds__(NT, 1) skinning_kernel(
    const float* __restrict__ W,   // (V, J)
    const float* __restrict__ A,   // (B, J, 4, 4), 16-byte aligned
    const float* __restrict__ P,   // (B, V, 3)
    float* __restrict__ out,       // (B, V, 3)
    int B, int V, int J) {
  using L = Layout<KJ>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // 2 stages of A, p, resident W
  float* ps = smem + 2 * L::A_FLOATS;
  float* wres = ps + P_FLOATS;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int lq = lane >> 4, l16 = lane & 15;  // body of the warp's pair; lane within it
  // Chunk 0 holds joints [0, first), chunk c > 0 [first + (c − 1)·KJ, first + c·KJ).
  const int first = J - (J - 1) / KJ * KJ;   // 1..KJ
  const int n_chunks = (J - first) / KJ + 1;
  const int n_bt = (B + BT - 1) / BT;
  const int n_tiles = (V + VT - 1) / VT * n_bt;
  // this block's tiles [tile0, tile1), tile = vertex tile · n_bt + body tile
  const int tile0 = (int)((long long)n_tiles * blockIdx.x / gridDim.x);
  const int tile1 = (int)((long long)n_tiles * (blockIdx.x + 1) / gridDim.x);
  const int steps = (tile1 - tile0) * n_chunks;
  const int w_slots = L::w_slots(J);
  auto w_slot = [&](int vt) { return wres + (w_slots == 2 ? vt & 1 : 0) * J * WS; };

  // Issue the copies of step s (tile tile0 + s / n_chunks, chunk s % n_chunks).
  auto stage = [&](int s) {
    const int k = s / n_chunks, c = s - k * n_chunks;
    const int tile = tile0 + k, vt = tile / n_bt;
    const int v0 = vt * VT, b0 = (tile - vt * n_bt) * BT;
    const int j0 = c == 0 ? 0 : first + (c - 1) * KJ;
    const int kj = c == 0 ? first : KJ;
    float* as = smem + (s & 1) * L::A_FLOATS;
#pragma unroll
    for (int i = 0; i < L::A_FLOATS / 4 / NT; ++i) {  // 16-byte piece e of [body][joint][16]
      const int e = t + i * NT;
      const int bb = e / (KJ * 4), jj = e / 4 % KJ, r = e % 4;
      const bool ok = jj < kj && b0 + bb < B;
      cp_async16(as + 4 * e, ok ? A + ((size_t)(b0 + bb) * J + j0 + jj) * 16 + 4 * r : A, ok);
    }
    if (k == 0 || (tile - 1) / n_bt != vt) {  // W rows of this chunk, for a new vertex tile
      float* ws = w_slot(vt) + j0 * WS;
#pragma unroll
      for (int i = 0; i < VT * KJ / NT; ++i) {  // a warp copies 32 / KJ rows × KJ joints
        const int r = (t + i * NT) / KJ, jj = t % KJ;
        const bool ok = v0 + r < V;
        if (jj < kj) cp_async4(ws + jj * WS + r, ok ? W + (size_t)(v0 + r) * J + j0 + jj : W, ok);
      }
    }
  };
  // p of this warp's 2 bodies: the 16-byte-aligned span around each body's
  // 3·nv floats; mis[q] is where the body's first float lands in its span.
  auto stage_p = [&](int v0, int b0, int (&mis)[2]) {
    const int nv = min(VT, V - v0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int bb = 2 * warp + q;
      const float* src = P + ((size_t)(b0 + bb) * V + v0) * 3;
      mis[q] = (int)(reinterpret_cast<uintptr_t>(src) >> 2 & 3);
      if (b0 + bb >= B) continue;
      const int n16 = (3 * nv + mis[q] + 3) / 4;
      for (int i = lane; i < n16; i += 32) cp_async16(ps + bb * PS + 4 * i, src - mis[q] + 4 * i, true);
    }
  };

  float acc[2][4][12];
  int mis[2] = {0, 0};
  stage(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int k = s / n_chunks, c = s - k * n_chunks;
    const int tile = tile0 + k, vt = tile / n_bt;
    const int v0 = vt * VT, b0 = (tile - vt * n_bt) * BT;
    cp_async_wait<0>();  // this thread's copies of step s have landed
    __syncthreads();     // everyone's have; step s − 1's buffer is free again
    if (c == max(n_chunks - 2, 0)) {
      stage_p(v0, b0, mis);
      cp_async_commit();
    }
    if (s + 1 < steps) stage(s + 1);
    cp_async_commit();

    if (c == 0) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 12; ++kk) acc[g][i][kk] = 0.f;
    }
    if (b0 + 2 * warp < B) {  // warp-uniform
      const int kj = c == 0 ? first : KJ;
      const int j0 = c == 0 ? 0 : first + (c - 1) * KJ;
      const float4* ws4 = reinterpret_cast<const float4*>(w_slot(vt) + j0 * WS) + l16;
      const float4* as4 =
          reinterpret_cast<const float4*>(smem + (s & 1) * L::A_FLOATS) + (2 * warp + lq) * KJ * 4;
      auto load = [&](int jj, float4 (&w)[2], float4 (&x)[3]) {
        w[0] = ws4[jj * (WS / 4)];
        w[1] = ws4[jj * (WS / 4) + 16];
        x[0] = as4[jj * 4];
        x[1] = as4[jj * 4 + 1];
        x[2] = as4[jj * 4 + 2];
      };
      float4 w0[2], x0[3], w1[2], x1[3];
      load(0, w0, x0);
      int jj = 0;
#pragma unroll 1
      for (; jj + 1 < kj; jj += 2) {
        load(jj + 1, w1, x1);
        fma_joint(acc, w0, x0);
        load(min(jj + 2, kj - 1), w0, x0);
        fma_joint(acc, w1, x1);
      }
      if (jj < kj) fma_joint(acc, w0, x0);
    }

    if (c == n_chunks - 1) {  // the tile's epilogue
      cp_async_wait<1>();     // p: all but the next step's group
      __syncwarp();           // each warp reads only the p its own lanes copied
      const int nv = min(VT, V - v0);
      float* pq = ps + (2 * warp + lq) * PS + mis[lq];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float* pl = pq + g * (VT / 2 * 3) + 12 * l16;  // vertices g·64 + 4·l16 + i
        float p[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) p[i] = pl[i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < 3; ++r)
            pl[3 * i + r] = acc[g][i][4 * r] * p[3 * i] + acc[g][i][4 * r + 1] * p[3 * i + 1] +
                            acc[g][i][4 * r + 2] * p[3 * i + 2] + acc[g][i][4 * r + 3];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int b = b0 + 2 * warp + q;
        if (b >= B) continue;
        const float* src = ps + (2 * warp + q) * PS + mis[q];
        float* dst = out + ((size_t)b * V + v0) * 3;
        for (int i = lane; i < 3 * nv; i += 32) dst[i] = src[i];
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;
std::atomic<int> sm_count[MAX_DEVICES];  // 0: not set up on that device yet

// The SM count of the current device; the first call on a device also opts
// both instantiations in to their shared memory.
cudaError_t set_up(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *n_sm = dev < MAX_DEVICES ? sm_count[dev].load(std::memory_order_acquire) : 0;
  if (*n_sm) return cudaSuccess;
  err = cudaFuncSetAttribute(skinning_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<64>::smem_bytes(64));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(skinning_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<32>::smem_bytes(MAX_J));
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) sm_count[dev].store(*n_sm, std::memory_order_release);
  return err;
}

template <int KJ>
cudaError_t launch(const void* W, const void* A, const void* P, void* out, int B, int V, int J,
                   int n_sm, cudaStream_t stream) {
  const int tiles = (V + VT - 1) / VT * ((B + BT - 1) / BT);
  skinning_kernel<KJ><<<tiles < n_sm ? tiles : n_sm, NT, Layout<KJ>::smem_bytes(J), stream>>>(
      (const float*)W, (const float*)A, (const float*)P, (float*)out, B, V, J);
  return cudaGetLastError();
}

}  // namespace

// All tensors f32, contiguous, on the stream's device; A 16-byte aligned;
// 0 < J <= 256. Returns a cudaError_t.
extern "C" int airpose_lbs_skinning(const void* W, const void* A, const void* P, void* out,
                                    int B, int V, int J, void* stream) {
  int n_sm = 0;
  cudaError_t err = set_up(&n_sm);
  if (err != cudaSuccess) return (int)err;
  return (int)(J <= 64 ? launch<64>(W, A, P, out, B, V, J, n_sm, (cudaStream_t)stream)
                       : launch<32>(W, A, P, out, B, V, J, n_sm, (cudaStream_t)stream));
}

// For J joints on the current device: the kernel's registers a thread, its
// dynamic shared memory a block and its resident blocks an SM. Returns a
// cudaError_t.
extern "C" int airpose_lbs_skinning_resources(int* regs, int* smem_bytes, int* blocks_per_sm,
                                              int J) {
  int n_sm = 0;
  cudaError_t err = set_up(&n_sm);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  *smem_bytes = J <= 64 ? Layout<64>::smem_bytes(J) : Layout<32>::smem_bytes(J);
  err = J <= 64 ? cudaFuncGetAttributes(&attr, skinning_kernel<64>)
                : cudaFuncGetAttributes(&attr, skinning_kernel<32>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  return (int)(J <= 64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks_per_sm, skinning_kernel<64>, NT, *smem_bytes)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             blocks_per_sm, skinning_kernel<32>, NT, *smem_bytes));
}
