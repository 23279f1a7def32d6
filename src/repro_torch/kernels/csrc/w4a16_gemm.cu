// Fused int4-dequant GEMM (W4A16) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/w4a16_gemm.py::w4a16_gemm
// (`_kernel`): out = x @ dequant(w), with the dequant fused into the K loop
// so that only the packed 4-bit weight crosses device memory.
//
//   x        [M, K]   bf16, contiguous
//   w_packed [K/2, N] int8  (low nibble = even k, high = odd k, signed)
//   scales   [K/G, N] bf16  (per-(group, column))
//   out      [M, N]   bf16, contiguous
//
// Arithmetic, in the TPU kernel's order: unpack the signed nibbles
// (int8_t before the arithmetic shift), multiply by the group scale in
// f32, round the weight to bf16 (it then equals QTensor.dequant()),
// accumulate x . w in f32 on the tensor cores (mma.sync m16n8k16 bf16),
// store bf16.
//
// Bound: bytes at decode (M <= 64: the packed weight and its scales are
// read once, 0.53 bytes per weight), operations at a padded chunk step
// (M = 2048: 2*M*N*K flops).  This first design is simple: a 64 x 128
// output tile per block of 8 warps (each 32 x 32), a K step of 64; each
// step's x tile and packed-weight tile are loaded into registers one step
// ahead (so the loads of step k+1 are in flight while step k multiplies),
// then x goes to shared memory as it is and the weight is dequantized on
// its way to shared memory as a bf16 [64, 128] tile; fragments come from
// shared memory with ldmatrix (.trans for the weight).  Rows past M are
// zero-filled and never stored.  wgmma, TMA and split-K for decode are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int kThreads = 256;
constexpr int XS = BK + 8;   // x tile row stride (bf16): 144 B, 16B-aligned
constexpr int WS = BN + 8;   // w tile row stride (bf16): 272 B, 16B-aligned
constexpr int kXVecs = BM * BK / 8 / kThreads;   // uint4 of x per thread: 2

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K step's global operands, held in registers until they are stored.
struct Stage {
  uint4 x[kXVecs];
  uint4 w;       // 16 packed bytes: k-pair row kp, columns nc .. nc+15
  uint4 s[2];    // the 16 columns' bf16 scales of that row's group
};

__device__ __forceinline__ void load_stage(
    Stage& st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, const __nv_bfloat16* __restrict__ scales,
    int M, int N, int K, int group, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXVecs; ++i) {
    const int v = tid + i * kThreads;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    const int gm = m0 + r;
    st.x[i] = gm < M ? *reinterpret_cast<const uint4*>(
                           x + (long long)gm * K + k0 + c)
                     : make_uint4(0, 0, 0, 0);
  }
  const int kp = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;
  const int gn = n0 + nc;
  if (gn < N) {
    st.w = *reinterpret_cast<const uint4*>(
        w + (long long)(k0 / 2 + kp) * N + gn);
    const __nv_bfloat16* sp = scales + (long long)((k0 + 2 * kp) / group) * N + gn;
    st.s[0] = *reinterpret_cast<const uint4*>(sp);
    st.s[1] = *reinterpret_cast<const uint4*>(sp + 8);
  } else {
    st.w = make_uint4(0, 0, 0, 0);
    st.s[0] = st.s[1] = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_stage(const Stage& st,
                                            __nv_bfloat16* xs,
                                            __nv_bfloat16* ws) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kXVecs; ++i) {
    const int v = tid + i * kThreads;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + r * XS + c) = st.x[i];
  }
  const int kp = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;
  const uint32_t wb[4] = {st.w.x, st.w.y, st.w.z, st.w.w};
  const uint32_t sw[8] = {st.s[0].x, st.s[0].y, st.s[0].z, st.s[0].w,
                          st.s[1].x, st.s[1].y, st.s[1].z, st.s[1].w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {        // columns nc + 2p, nc + 2p + 1
    float l[2], h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * p + e;
      const uint32_t byte = (wb[j / 4] >> (8 * (j % 4))) & 0xFFu;
      // cast to int8_t first, then shift arithmetically: signed nibbles
      const int lo4 = (int)(int8_t)(uint8_t)(byte << 4) >> 4;
      const int hi4 = (int)(int8_t)(uint8_t)byte >> 4;
      const float sc = __uint_as_float(
          e ? (sw[p] & 0xFFFF0000u) : (sw[p] << 16));   // bf16 -> f32
      l[e] = (float)lo4 * sc;
      h[e] = (float)hi4 * sc;
    }
    const __nv_bfloat162 lb = __floats2bfloat162_rn(l[0], l[1]);
    const __nv_bfloat162 hb = __floats2bfloat162_rn(h[0], h[1]);
    lo[p] = *reinterpret_cast<const uint32_t*>(&lb);
    hi[p] = *reinterpret_cast<const uint32_t*>(&hb);
  }
  uint4* row0 = reinterpret_cast<uint4*>(ws + (2 * kp) * WS + nc);
  uint4* row1 = reinterpret_cast<uint4*>(ws + (2 * kp + 1) * WS + nc);
  row0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  row0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  row1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  row1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,
             const int8_t* __restrict__ w,
             const __nv_bfloat16* __restrict__ scales,
             __nv_bfloat16* __restrict__ out, int M, int N, int K,
             int group) {
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XS];
  __shared__ __align__(16) __nv_bfloat16 ws[BK * WS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Stage st;
  load_stage(st, x, w, scales, M, N, K, group, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_stage(st, xs, ws);
    __syncthreads();
    if (k0 + BK < K)
      load_stage(st, x, w, scales, M, N, K, group, m0, n0, k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], xs + (wm + i * 16 + (lane & 15)) * XS + kk +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], ws + (kk + (lane & 15)) * WS + wn + j * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2],
                   b[j / 2][(j % 2) * 2 + 1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace

// Supported: K % 64 == 0, N % 16 == 0, group in {16, 32, 64, 128} with
// K % group == 0, 16-byte aligned contiguous operands; any M >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int w4a16_gemm_bf16(const void* x, const void* w_packed,
                               const void* scales, void* out, int M, int N,
                               int K, int group, void* stream) {
  if (M <= 0) return 0;
  if (K % BK || N % 16 || K % group ||
      (group != 16 && group != 32 && group != 64 && group != 128))
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4a16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w_packed,
      (const __nv_bfloat16*)scales, (__nv_bfloat16*)out, M, N, K, group);
  return (int)cudaGetLastError();
}
