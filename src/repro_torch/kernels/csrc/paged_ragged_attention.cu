// Ragged multi-sequence paged attention for Hopper, over bf16 or int8
// pages.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_ragged_attention
// (`_ragged_kernel`), both forms: one launch covers a whole engine step's
// mixed batch of decode rows (C = 1 valid token) and prefill chunks.  The
// decode (`paged_attention`, `_kernel`) and chunked-prefill
// (`paged_prefill_attention`, `_prefill_kernel`) TPU kernels are the same
// computation with C = 1 (starts = contexts - 1) and with B = 1; their
// wrappers launch this kernel with those index tensors.
//
//   q           [B, C, H, D] bf16, read through its strides (stride(-1) = 1)
//   k/v pages   [P, page_size, Kv, D] bf16 or int8 (one layer's pool,
//               contiguous)
//   k/v scales  [P, page_size, Kv] bf16, int8 form only: key/value t of
//               kv-head h is pages[..t, h, :] * scales[..t, h]
//   page_tables [B, pps] int32, contexts [B] int32, starts [B] int32
//   out         [B, C, H, D] bf16, contiguous
//
// Semantics (kept exactly): key t is visible to chunk token c of row b iff
// t < contexts[b] and t <= starts[b] + c; head h reads kv-head h / G; a
// row with contexts[b] == 0 outputs zeros; masked scores take the finite
// NEG_INF = -1e30 and the final divide guards l with max(l, 1e-30).
//
// Bound: bytes for decode rows (each (row, kv-head) streams its K/V pages
// once for at most G query rows), operations for long prefill chunks.
// This first design is plain CUDA-core f32 math: grid (B, Kv, row tiles);
// a block owns 32 query rows r = c*G + g of one (row, kv-head), stages each
// K and V page tile [page_size, D] in shared memory with 16-byte loads, and
// each warp carries 4 query rows' online softmax (m, l, acc[D]) in
// registers, lane i owning D/32 consecutive head-dim elements.  An int8
// page tile is half the bytes of a bf16 one (2 KB at D=128, page 16, 16
// values per 16-byte load); its page_size scales per kv-head are staged
// beside it, and the dequant (value * scale, f32) happens at the
// shared-to-register step, as the TPU kernel rescales its VMEM tile: no
// f32 or bf16 copy of the pool is written anywhere.  The page
// loop stops at ceil(min(contexts[b], last query position + 1) / page_size),
// so it never reads a page-table entry past the live context (unused
// entries are 0, and page 0 is a live page).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr float kNegInf = -1e30f;

template <int E>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// One key/value row's E elements of this lane, in f32.
template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float s,
                                         float* v) {
  load_bf16<E>(p, v);
}

template <int E>
__device__ __forceinline__ void load_row(const int8_t* p, float s, float* v) {
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = (float)p[e] * s;
}

template <typename T, int D, int PS>
__global__ void __launch_bounds__(kWarps * 32)
ragged_kernel(const __nv_bfloat16* __restrict__ q, long long sB, long long sC,
              long long sH, const T* __restrict__ k_pages,
              const T* __restrict__ v_pages,
              const __nv_bfloat16* __restrict__ k_scales,
              const __nv_bfloat16* __restrict__ v_scales,
              const int* __restrict__ page_tables,
              const int* __restrict__ contexts, const int* __restrict__ starts,
              __nv_bfloat16* __restrict__ out, int C, int H, int Kv, int pps,
              float scale) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int E = D / 32;             // head-dim elements per lane
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int TILE_VECS = PS * D / VEC;
  __shared__ __align__(16) T k_s[PS * D];
  __shared__ __align__(16) T v_s[PS * D];
  __shared__ float ks_s[kQuant ? PS : 1], vs_s[kQuant ? PS : 1];

  const int b = blockIdx.x, kv = blockIdx.y;
  const int G = H / Kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctx = contexts[b];
  const int start = starts[b];
  const int n_rows = C * G;
  const int tile0 = blockIdx.z * kTileRows;

  // this warp's rows: tile0 + warp + j * kWarps (round-robin, so a decode
  // row's G heads land on G different warps)
  float qv[kRowsPerWarp][E], acc[kRowsPerWarp][E];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = tile0 + warp + j * kWarps;
    live[j] = r < n_rows;
    const int c = live[j] ? r / G : 0, g = live[j] ? r % G : 0;
    qpos[j] = start + c;
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
    if (live[j]) {
      load_bf16<E>(q + b * sB + c * sC + (long long)(kv * G + g) * sH +
                       lane * E, qv[j]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qv[j][e] = 0.f;
    }
  }

  // keys this tile can see: t < ctx and t <= start + (last chunk token)
  const int last_c = min(C - 1, (min(tile0 + kTileRows, n_rows) - 1) / G);
  const int kv_end = min(ctx, start + last_c + 1);
  const int n_pages = kv_end > 0 ? (kv_end + PS - 1) / PS : 0;
  const int* pt = page_tables + (long long)b * pps;

  for (int pi = 0; pi < n_pages; ++pi) {
    const long long page = pt[pi];
    __syncthreads();                    // previous tile fully consumed
    for (int i = threadIdx.x; i < TILE_VECS; i += kWarps * 32) {
      const int t = i / (D / VEC), dv = i % (D / VEC);
      const long long src = ((page * PS + t) * Kv + kv) * D + dv * VEC;
      reinterpret_cast<uint4*>(k_s)[i] =
          *reinterpret_cast<const uint4*>(k_pages + src);
      reinterpret_cast<uint4*>(v_s)[i] =
          *reinterpret_cast<const uint4*>(v_pages + src);
    }
    if (kQuant && threadIdx.x < PS) {
      const long long si = (page * PS + threadIdx.x) * Kv + kv;
      ks_s[threadIdx.x] = __bfloat162float(k_scales[si]);
      vs_s[threadIdx.x] = __bfloat162float(v_scales[si]);
    }
    __syncthreads();

    float s[kRowsPerWarp][PS];
#pragma unroll
    for (int t = 0; t < PS; ++t) {
      float kt[E];
      load_row<E>(k_s + t * D + lane * E, kQuant ? ks_s[t] : 1.f, kt);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qv[j][e] * kt[e];
        s[j][t] = d;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int t = 0; t < PS; ++t) {
        float d = s[j][t];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        const int tpos = pi * PS + t;
        s[j][t] = (tpos < ctx && tpos <= qpos[j]) ? d * scale : kNegInf;
      }
      float mx = m[j];
#pragma unroll
      for (int t = 0; t < PS; ++t) mx = fmaxf(mx, s[j][t]);
      const float alpha = expf(m[j] - mx);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < PS; ++t) {
        s[j][t] = expf(s[j][t] - mx);
        psum += s[j][t];
      }
      l[j] = alpha * l[j] + psum;
      m[j] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < PS; ++t) {
      float vt[E];
      load_row<E>(v_s + t * D + lane * E, kQuant ? vs_s[t] : 1.f, vt);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] += s[j][t] * vt[e];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    if (!live[j]) continue;
    const int r = tile0 + warp + j * kWarps;
    const int c = r / G, g = r % G;
    const float lj = fmaxf(l[j], 1e-30f);
    __nv_bfloat16* o =
        out + (((long long)b * C + c) * H + kv * G + g) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(o + e) =
          __floats2bfloat162_rn(acc[j][e] / lj, acc[j][e + 1] / lj);
  }
}

template <typename T, int D, int PS>
int launch(const void* q, long long sB, long long sC, long long sH,
           const void* k_pages, const void* v_pages, const void* k_scales,
           const void* v_scales, const int* page_tables, const int* contexts,
           const int* starts, void* out, int B, int C, int H, int Kv, int pps,
           float scale, cudaStream_t stream) {
  const int G = H / Kv;
  dim3 grid(B, Kv, (C * G + kTileRows - 1) / kTileRows);
  ragged_kernel<T, D, PS><<<grid, kWarps * 32, 0, stream>>>(
      (const __nv_bfloat16*)q, sB, sC, sH, (const T*)k_pages,
      (const T*)v_pages, (const __nv_bfloat16*)k_scales,
      (const __nv_bfloat16*)v_scales, page_tables, contexts, starts,
      (__nv_bfloat16*)out, C, H, Kv, pps, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, long long sB, long long sC, long long sH,
             const void* k_pages, const void* v_pages, const void* k_scales,
             const void* v_scales, const void* page_tables,
             const void* contexts, const void* starts, void* out, int B,
             int C, int H, int Kv, int D, int page_size, int pps, float scale,
             void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Kv <= 0 || H % Kv != 0) return (int)cudaErrorInvalidValue;
  const int* pt = (const int*)page_tables;
  const int* cx = (const int*)contexts;
  const int* st = (const int*)starts;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_RAGGED_CASE(DD, PP)                                            \
  if (D == DD && page_size == PP)                                            \
    return launch<T, DD, PP>(q, sB, sC, sH, k_pages, v_pages, k_scales,      \
                             v_scales, pt, cx, st, out, B, C, H, Kv, pps,    \
                             scale, s);
  REPRO_RAGGED_CASE(128, 16)
  REPRO_RAGGED_CASE(128, 8)
  REPRO_RAGGED_CASE(64, 16)
  REPRO_RAGGED_CASE(64, 8)
#undef REPRO_RAGGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Supported: D in {64, 128}, page_size in {8, 16}, H % Kv == 0.
// Strides are in elements.  Each returns cudaGetLastError() after the
// launch.
extern "C" int paged_ragged_attention_bf16(
    const void* q, long long sB, long long sC, long long sH,
    const void* k_pages, const void* v_pages, const void* page_tables,
    const void* contexts, const void* starts, void* out, int B, int C, int H,
    int Kv, int D, int page_size, int pps, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, sB, sC, sH, k_pages, v_pages, nullptr,
                                 nullptr, page_tables, contexts, starts, out,
                                 B, C, H, Kv, D, page_size, pps, scale,
                                 stream);
}

// int8 pages with bf16 per-(token, kv-head) scales [P, page_size, Kv].
extern "C" int paged_ragged_attention_int8(
    const void* q, long long sB, long long sC, long long sH,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* page_tables, const void* contexts,
    const void* starts, void* out, int B, int C, int H, int Kv, int D,
    int page_size, int pps, float scale, void* stream) {
  return dispatch<int8_t>(q, sB, sC, sH, k_pages, v_pages, k_scales,
                          v_scales, page_tables, contexts, starts, out, B, C,
                          H, Kv, D, page_size, pps, scale, stream);
}
