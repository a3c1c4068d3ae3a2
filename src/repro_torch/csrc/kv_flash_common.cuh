// The online-softmax decode body shared by kv_flash_decode.cu (contiguous
// per-slot cache) and kv_flash_paged_decode.cu (page pool + block table).
//
// One block per (b, g), one warp per query row r, S walked in 32-position
// tiles with one position per lane. The two kernels differ only in where
// the codes of logical position t and the per-channel scales of (b, g)
// live, which a Cache policy answers:
//
//   size_t row(int b, int g, int bg, int t)  the code row of position t
//                                            (codes at row * Dh .. + Dh)
//   size_t scale_row(int bg, int g)          the scale row of (b, g)
//
// Everything else -- the tile walk, the dequantization through a 256-entry
// table times the scale, the masking, the order of every sum -- is this
// one body, so on the same logical cache with the same S the paged kernel
// gives the dense kernel's output bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kv_flash {

constexpr int BS = 32;               // cache positions per tile = warp size
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DPL>   // head-dim values per lane: Dh = 32 * DPL
__host__ __device__ constexpr size_t smem_floats(int R) {
  return 256 + 2 * (32 * DPL) + R * (32 * DPL) + BS * (32 * DPL + 1)
         + BS * (32 * DPL) + R * BS;
}

// q (B, G, R, Dh) f32; codes via Cache; scales (.., Dh) f32 rows via
// Cache::scale_row; pos (B,) int32 valid lengths; table the 256 code-byte
// values; out (B, G, R, Dh) f32. S = the logical length every slot spans.
template <int DPL, class Cache>
__global__ void decode_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kc,
    const float* __restrict__ ksc, const uint8_t* __restrict__ vc,
    const float* __restrict__ vsc, const int* __restrict__ pos,
    const float* __restrict__ table, float* __restrict__ out, int G, int R,
    int S, float qk_scale, const Cache cache) {
  constexpr int Dh = 32 * DPL;
  extern __shared__ float smem[];
  float* tab = smem;                        // 256
  float* k_sc = tab + 256;                  // Dh
  float* v_sc = k_sc + Dh;                  // Dh
  float* qs = v_sc + Dh;                    // R * Dh
  float* ks = qs + R * Dh;                  // BS * (Dh + 1)
  float* vs = ks + BS * (Dh + 1);           // BS * Dh
  float* ps = vs + BS * Dh;                 // R * BS
  __shared__ size_t rows[BS];               // code rows of the tile's positions

  const int bg = blockIdx.x;                // b * G + g
  const int b = bg / G, g = bg % G;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r = tid / 32, lane = tid % 32;

  const size_t srow = cache.scale_row(bg, g);
  for (int i = tid; i < 256; i += nthreads) tab[i] = table[i];
  for (int i = tid; i < Dh; i += nthreads) {
    k_sc[i] = ksc[srow * Dh + i];
    v_sc[i] = vsc[srow * Dh + i];
  }
  for (int i = tid; i < R * Dh; i += nthreads) qs[i] = q[(size_t)bg * R * Dh + i];

  const int p = pos[b];
  // pos <= 0 masks everything: the plain version then averages all S rows
  const int s_end = (p <= 0 || p > S) ? S : p;
  // warp 0 resolves the next tile's rows while the others finish this one;
  // the barrier at the top of the tile publishes them
  if (tid < BS && tid < S) rows[tid] = cache.row(b, g, bg, tid);

  float m = NEG, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < s_end; t0 += BS) {
    __syncthreads();
    for (int e = tid; e < BS * Dh; e += nthreads) {
      const int j = e / Dh, d = e % Dh;
      const bool in = t0 + j < S;
      const size_t off = in ? rows[j] * Dh + d : 0;
      ks[j * (Dh + 1) + d] = in ? tab[kc[off]] * k_sc[d] : 0.f;
      vs[j * Dh + d] = in ? tab[vc[off]] * v_sc[d] : 0.f;
    }
    __syncthreads();
    if (tid < BS && t0 + BS + tid < S) rows[tid] = cache.row(b, g, bg, t0 + BS + tid);
    const int idx = t0 + lane;
    float s = 0.f;
    const float* qr = qs + r * Dh;
    const float* kr = ks + lane * (Dh + 1);
#pragma unroll 8
    for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
    s *= qk_scale;
    if (!(idx < p)) s = NEG;
    if (idx >= S) s = -INFINITY;            // beyond the cache: weight 0
    const float m_new = fmaxf(m, warp_max(s));
    const float pj = expf(s - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(pj);
    ps[r * BS + lane] = pj;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      float a = acc[i] * corr;
      for (int j = 0; j < BS; ++j) a = fmaf(ps[r * BS + j], vs[j * Dh + d], a);
      acc[i] = a;
    }
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* o = out + ((size_t)bg * R + r) * Dh;
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = acc[i] * inv;
}

template <int DPL, class Cache>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* pos, const void* table, void* out,
           int B, int G, int R, int S, float qk_scale, const Cache& cache,
           void* stream) {
  const size_t smem = sizeof(float) * smem_floats<DPL>(R);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<DPL, Cache>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<DPL, Cache><<<B * G, R * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)kc, (const float*)ks,
      (const uint8_t*)vc, (const float*)vs, (const int*)pos,
      (const float*)table, (float*)out, G, R, S, qk_scale, cache);
  return (int)cudaGetLastError();
}

// Dh = 32 * DPL for Dh in {32, 64, 128, 256}; anything else is refused.
template <class Cache>
int dispatch(const void* q, const void* kc, const void* ks, const void* vc,
             const void* vs, const void* pos, const void* table, void* out,
             int B, int G, int R, int S, int Dh, float qk_scale,
             const Cache& cache, void* stream) {
  if (R < 1 || R > 32 || B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return launch<1>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, cache, stream);
    case 64: return launch<2>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, cache, stream);
    case 128: return launch<4>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, cache, stream);
    case 256: return launch<8>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, cache, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace kv_flash
