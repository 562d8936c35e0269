// Residual add, LayerNorm and cast in one pass over the ViT residual stream
// (models/vit.py: HMR 2.0's ViT-H/16, Multi-HMR's DINOv2 ViT-L/14):
//
//   x ← x + f32(branch)                    (in place; skipped without a branch)
//   x ← x + γ ⊙ f32(branch)                (the same, with a LayerScale γ)
//   y = out_dtype(LayerNorm(x) · weight + bias)
//
// x is the float32 stream (rows × C), branch the block's attention or MLP
// output in bf16 (f32 in an f32 backbone), γ the branch's float32 per-channel
// LayerScale (DINOv2's ls1.gamma / ls2.gamma; a null pointer without one),
// weight and bias the float32 LayerNorm parameters, y the normalised rows in
// bf16 (the blocks' norms) or f32 (``last_norm``). Statistics and the affine
// step are in f32; the add is the same f32 arithmetic PyTorch's
// ``x += branch`` or ``x += gamma * branch`` makes (the product rounded, then
// the sum: no fused multiply-add), so x comes out bit-equal; only the order
// of the LayerNorm's sums differs.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm and the residual
// add to XLA, which fuses them. On the card PyTorch ran them as three
// passes (the mixed-dtype add, LayerNorm with an f32 output, the bf16 cast),
// 755 MB a norm point at 128 crops and ~20 ms a 96-ms call; this kernel
// replaces all three at each of the backbone's 2·depth + 1 norm points.
//
// What bounds it on an H100: bytes. At 128 crops × 192 tokens × 1,280 it
// reads x (f32) and the branch (bf16) and writes x (f32) and y (bf16): 377.5
// MB, 0.1127 ms at 3.35 TB/s, against ~12 flops a value.
//
// Design: one warp a row, the row held in registers (at C = 1,280, 40 f32
// values a lane), so each byte is read once and written once.
//  * Lane l takes the 4-value chunks l, l + 32, l + 64, ... of its row: x and
//    an f32 y move 16 B a lane, a bf16 branch and y 8 B, and each access of
//    a warp is one contiguous run. Every load of the row is issued before the
//    first sum, so a warp has its whole row (7.7 KB at C = 1,280) in flight.
//  * Mean, then the sum of squared deviations from the values in registers,
//    each reduced with warp shuffles: two passes in registers, one read from
//    memory, no shared memory and no barrier.
//  * weight and bias come through the read-only path after the statistics;
//    every row of an SM reads the same C values, which stay in L1.
//  * Blocks of 8 warps (8 rows), as many blocks as rows need: 3,072 at 128
//    crops, several waves over the 132 SMs.
//  * The chunk loop is unrolled to K_MAX chunks a lane with a guard per chunk,
//    so one instantiation serves every width up to 32·4·K_MAX and the ViT's
//    two dtypes give four kernels (branch bf16 or f32, y bf16 or f32; no
//    branch is a null pointer), each with and without γ. The row's code is
//    one template; the kernels without γ (HMR 2.0's) keep their name,
//    signature and code from before γ existed; with it
//    (``add_layernorm_scale_kernel``), each lane reads its chunks of γ (4 KB
//    at C = 1,024, in L1 like weight and bias) once a row, beside the branch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;   // rows a block
constexpr int K_MAX = 12;  // 4-value chunks a lane: widths up to 1,536

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&a);
  t.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename B, typename O, bool SCALE>
__device__ __forceinline__ void add_layernorm_row(float* __restrict__ x,
                                                  const B* __restrict__ branch,
                                                  const float* __restrict__ gamma,
                                                  const float* __restrict__ weight,
                                                  const float* __restrict__ bias,
                                                  O* __restrict__ y, int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int n4 = C >> 2;
  const size_t base = (size_t)row * C;

  float v[K_MAX][4];
#pragma unroll
  for (int k = 0; k < K_MAX; ++k) {
    const int c = lane + 32 * k;
    if (c < n4) load4(x + base + 4 * c, v[k]);
  }
  if (branch != nullptr) {
    float t[K_MAX][4];
#pragma unroll
    for (int k = 0; k < K_MAX; ++k) {
      const int c = lane + 32 * k;
      if (c < n4) load4(branch + base + 4 * c, t[k]);
    }
#pragma unroll
    for (int k = 0; k < K_MAX; ++k) {
      const int c = lane + 32 * k;
      if (c < n4) {
        if constexpr (SCALE) {
          const float4 g4 = __ldg(reinterpret_cast<const float4*>(gamma) + c);
          const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) v[k][i] = __fadd_rn(v[k][i], __fmul_rn(g[i], t[k][i]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[k][i] += t[k][i];
        }
        store4(x + base + 4 * c, v[k]);
      }
    }
  }

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K_MAX; ++k)
    if (lane + 32 * k < n4) s += (v[k][0] + v[k][1]) + (v[k][2] + v[k][3]);
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K_MAX; ++k)
    if (lane + 32 * k < n4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = v[k][i] - mean;
        q = fmaf(d, d, q);
      }
    }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);

#pragma unroll
  for (int k = 0; k < K_MAX; ++k) {
    const int c = lane + 32 * k;
    if (c < n4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(weight) + c);
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + c);
      const float o[4] = {fmaf((v[k][0] - mean) * rstd, w.x, b.x),
                          fmaf((v[k][1] - mean) * rstd, w.y, b.y),
                          fmaf((v[k][2] - mean) * rstd, w.z, b.z),
                          fmaf((v[k][3] - mean) * rstd, w.w, b.w)};
      store4(y + base + 4 * c, o);
    }
  }
}

template <typename B, typename O>
__global__ void __launch_bounds__(WARPS * 32)
    add_layernorm_kernel(float* __restrict__ x, const B* __restrict__ branch,
                         const float* __restrict__ weight, const float* __restrict__ bias,
                         O* __restrict__ y, int rows, int C, float eps) {
  add_layernorm_row<B, O, false>(x, branch, nullptr, weight, bias, y, rows, C, eps);
}

// With γ the compiler keeps γ's chunks live beside the row and the branch:
// 141 registers a thread, one block an SM, 51% of the byte bound at
// Multi-HMR's rows against 87% without γ (H100). Asking for two blocks an SM
// caps it at 128.
template <typename B, typename O>
__global__ void __launch_bounds__(WARPS * 32, 2)
    add_layernorm_scale_kernel(float* __restrict__ x, const B* __restrict__ branch,
                               const float* __restrict__ gamma,
                               const float* __restrict__ weight,
                               const float* __restrict__ bias, O* __restrict__ y, int rows,
                               int C, float eps) {
  add_layernorm_row<B, O, true>(x, branch, gamma, weight, bias, y, rows, C, eps);
}

template <typename B, typename O>
int launch(void* x, const void* branch, const void* gamma, const void* weight, const void* bias,
           void* y, int rows, int C, float eps, cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  if (gamma != nullptr)
    add_layernorm_scale_kernel<B, O><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<float*>(x), static_cast<const B*>(branch), static_cast<const float*>(gamma),
        static_cast<const float*>(weight), static_cast<const float*>(bias), static_cast<O*>(y),
        rows, C, eps);
  else
    add_layernorm_kernel<B, O><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<float*>(x), static_cast<const B*>(branch), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<O*>(y), rows, C, eps);
  return (int)cudaGetLastError();
}

template <typename O>
int launch_out(void* x, const void* branch, const void* gamma, const void* weight,
               const void* bias, void* y, int rows, int C, int branch_kind, float eps,
               cudaStream_t stream) {
  if (branch_kind == 2)
    return launch<float, O>(x, branch, gamma, weight, bias, y, rows, C, eps, stream);
  return launch<__nv_bfloat16, O>(x, branch_kind == 0 ? nullptr : branch,
                                  branch_kind == 0 ? nullptr : gamma, weight, bias, y, rows, C,
                                  eps, stream);
}

}  // namespace

// branch_kind: 0 no branch, 1 bf16, 2 f32; out_kind: 0 bf16, 1 f32; gamma
// null for a plain add (and ignored without a branch). Every pointer 16-byte
// aligned, C a multiple of 8 up to 32·4·K_MAX.
extern "C" int airpose_add_layernorm(void* x, const void* branch, const void* gamma,
                                     const void* weight, const void* bias, void* y, int rows,
                                     int C, int branch_kind, int out_kind, float eps,
                                     void* stream) {
  if (rows < 0 || C < 8 || C % 8 || C > 32 * 4 * K_MAX || branch_kind < 0 || branch_kind > 2 ||
      out_kind < 0 || out_kind > 1 || (branch_kind != 0 && branch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    return launch_out<__nv_bfloat16>(x, branch, gamma, weight, bias, y, rows, C, branch_kind, eps,
                                     s);
  return launch_out<float>(x, branch, gamma, weight, bias, y, rows, C, branch_kind, eps, s);
}
