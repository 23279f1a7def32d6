// Row RMSNorm (optionally residual-add first) for Hopper, bf16 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py
// (`_kernel` and `_kernel_res`, called from `rmsnorm`).
//
//   x [R, D] bf16, scale [D] f32, residual [R, D] bf16 or null
//   out[r] = bf16( v * rsqrt(mean(v^2) + eps) * scale ),  v = x[r] (+ res[r])
//
// Bound: bytes.  Each row is read once from device memory (plus the
// residual), written once, and needs ~3 flops per element, far under
// the card's ~295 flop/byte ridge.  Design: one block per row, 16-byte
// (8 x bf16) vector loads, f32 statistics reduced with warp shuffles and
// a shared-memory pass across warps.  The row is re-read for the scale
// pass; that second read hits L1/L2 (one row is 8 KB at D = 4096).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ res,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int D, float eps) {
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * D;
  const __nv_bfloat16* rr = res ? res + row * D : nullptr;
  __nv_bfloat16* orow = out + row * D;
  const int nvec = D / 8;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[8];
    load8(xr + i * 8, v);
    if (rr) {
      float r[8];
      load8(rr + i * 8, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += r[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) inv_rms = rsqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[8];
    load8(xr + i * 8, v);
    if (rr) {
      float r[8];
      load8(rr + i * 8, r);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += r[j];
    }
    const float4 s0 = *reinterpret_cast<const float4*>(scale + i * 8);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + i * 8 + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j] * inv * s[2 * j],
                                   v[2 * j + 1] * inv * s[2 * j + 1]);
    *reinterpret_cast<uint4*>(orow + i * 8) = packed;
  }
}

}  // namespace

// x, res (nullable), out: [rows, D] bf16 contiguous, 16-byte aligned;
// scale: [D] f32; D % 8 == 0.  Returns cudaGetLastError() after launch.
extern "C" int rmsnorm_bf16(const void* x, const void* res, const void* scale,
                            void* out, int rows, int D, float eps,
                            void* stream) {
  if (rows <= 0) return 0;
  if (D <= 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (const float*)scale, (__nv_bfloat16*)out, D, eps);
  return (int)cudaGetLastError();
}
