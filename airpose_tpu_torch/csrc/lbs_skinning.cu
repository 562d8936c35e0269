// Linear blend skinning on Hopper: out[b,v] = T[:3,:3]·p + T[:3,3] with
// T = Σ_j W[v,j]·A[b,j], never writing T to memory.
//
// Replaces airpose_tpu/bodymodel/pallas_lbs.py::skinning_pallas (the
// Pallas TPU kernel _skinning_kernel). The TPU version padded the joint
// axis to 128 and laid vertices on lanes so that T came out of the MXU;
// none of that is carried over.
//
// What bounds it on an H100: at B = 128 bodies, V = 10475, J = 55 it does
// ~1.77 GFLOP of f32 FMA against ~34 MB of compulsory traffic (W once, A
// once, P in, out), so it is bound by the f32 CUDA-core rate, not memory.
// The numerics stay f32 throughout: no TF32, no tensor cores.
//
// Design: one block per (128-vertex tile, 8-body tile), one thread per
// vertex. The block stages its weight tile transposed in shared memory
// (read coalesced, once) and the used 3 rows of A for its 8 bodies
// (55 × 12 floats each). Each thread then reads its weights from shared
// memory and the A rows as broadcast float4s, so every 12 FMAs cost one
// conflict-free scalar load and three broadcast vector loads.

#include <cuda_runtime.h>

namespace {

constexpr int VT = 128;  // vertices per block (one per thread)
constexpr int BT = 8;    // bodies per block

__global__ void __launch_bounds__(VT) skinning_kernel(
    const float* __restrict__ W,   // (V, J)
    const float* __restrict__ A,   // (B, J, 4, 4)
    const float* __restrict__ P,   // (B, V, 3)
    float* __restrict__ out,       // (B, V, 3)
    int B, int V, int J) {
  extern __shared__ float4 smem4[];
  float4* as = smem4;                                 // (BT, J, 3) rows 0..2 of A
  float* ws = reinterpret_cast<float*>(smem4 + BT * J * 3);  // (J, VT)

  const int t = threadIdx.x;
  const int v0 = blockIdx.x * VT;
  const int b0 = blockIdx.y * BT;
  const int nv = min(VT, V - v0);
  const int nb = min(BT, B - b0);

  // W[v0 : v0 + nv] is one contiguous run of nv·J floats.
  const float* wsrc = W + (size_t)v0 * J;
  for (int i = t; i < nv * J; i += VT) {
    const int v = i / J;
    ws[(i - v * J) * VT + v] = wsrc[i];
  }
  const float4* asrc = reinterpret_cast<const float4*>(A) + (size_t)b0 * J * 4;
  for (int i = t; i < nb * J * 3; i += VT) {
    const int bj = i / 3;
    as[i] = asrc[bj * 4 + (i - bj * 3)];
  }
  __syncthreads();
  if (t >= nv) return;

  const int v = v0 + t;
  for (int b = 0; b < nb; ++b) {
    const float4* ab = as + b * J * 3;
    float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0, r2 = r0;
#pragma unroll 5
    for (int j = 0; j < J; ++j) {
      const float w = ws[j * VT + t];
      const float4 a0 = ab[3 * j], a1 = ab[3 * j + 1], a2 = ab[3 * j + 2];
      r0.x = fmaf(w, a0.x, r0.x); r0.y = fmaf(w, a0.y, r0.y);
      r0.z = fmaf(w, a0.z, r0.z); r0.w = fmaf(w, a0.w, r0.w);
      r1.x = fmaf(w, a1.x, r1.x); r1.y = fmaf(w, a1.y, r1.y);
      r1.z = fmaf(w, a1.z, r1.z); r1.w = fmaf(w, a1.w, r1.w);
      r2.x = fmaf(w, a2.x, r2.x); r2.y = fmaf(w, a2.y, r2.y);
      r2.z = fmaf(w, a2.z, r2.z); r2.w = fmaf(w, a2.w, r2.w);
    }
    const size_t o = ((size_t)(b0 + b) * V + v) * 3;
    const float px = P[o], py = P[o + 1], pz = P[o + 2];
    out[o] = r0.x * px + r0.y * py + r0.z * pz + r0.w;
    out[o + 1] = r1.x * px + r1.y * py + r1.z * pz + r1.w;
    out[o + 2] = r2.x * px + r2.y * py + r2.z * pz + r2.w;
  }
}

}  // namespace

// All tensors f32, contiguous, on the stream's device. Returns a cudaError_t.
extern "C" int airpose_lbs_skinning(const void* W, const void* A,
                                    const void* P, void* out, int B, int V,
                                    int J, void* stream) {
  const int smem = (BT * J * 3 * 4 + J * VT) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      skinning_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + VT - 1) / VT, (B + BT - 1) / BT);
  skinning_kernel<<<grid, VT, smem, (cudaStream_t)stream>>>(
      (const float*)W, (const float*)A, (const float*)P, (float*)out, B, V, J);
  return (int)cudaGetLastError();
}
