// One-token GQA attention over a byte-wide quantized KV cache, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kv_flash_decode.py::kv_flash_decode (pallas_call at
// :139, body _kernel :59, _dequant_tile :48).
//
//   q (B, G, R, Dh) f32; k/v codes (B, G, S, Dh) int8 (fxp) or uint8
//   (pofx); k/v scales (B, G, 1, Dh) f32; pos (B,) int32 valid lengths
//   -> out (B, G, R, Dh) f32.
//
// Codes dequantize in registers on their way into shared memory through a
// 256-entry float table indexed by the code byte: fxp entries are
// int8(c) * 2^-F, pofx entries pofx_norm_lut[c & (2^(N-1)-1)] * 2^-(M-1),
// both exact in f32, then times the per-channel scale -- the same two
// roundings as the plain version, so the dequantized K/V agree bit for bit.
// Scores are masked with idx < pos[b] to -1e30 as in the reference; the
// online softmax keeps m, l and acc in f32 and writes acc / max(l, 1e-30).
//
// Bound: the code bytes, 2 * S_valid * Dh per (b, g) per layer per step;
// the arithmetic is a few flops per byte. One block per (b, g) walks S in
// 32-position tiles (one position per lane) with one warp per query row r;
// tiles past pos[b] are skipped, which changes nothing (their weights are
// exactly 0). The last partial tile is masked, never padded. At B = 4 slots
// and G = 4 groups this is 16 blocks on 132 SMs: split-S (flash-decoding)
// with a combine pass is the natural later design.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
__global__ void kv_flash_decode_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kc,
    const float* __restrict__ ksc, const uint8_t* __restrict__ vc,
    const float* __restrict__ vsc, const int* __restrict__ pos,
    const float* __restrict__ table, float* __restrict__ out, int G, int R,
    int S, float qk_scale) {
  constexpr int Dh = 32 * DPL;
  extern __shared__ float smem[];
  float* tab = smem;                        // 256
  float* k_sc = tab + 256;                  // Dh
  float* v_sc = k_sc + Dh;                  // Dh
  float* qs = v_sc + Dh;                    // R * Dh
  float* ks = qs + R * Dh;                  // BS * (Dh + 1)
  float* vs = ks + BS * (Dh + 1);           // BS * Dh
  float* ps = vs + BS * Dh;                 // R * BS

  const int bg = blockIdx.x;                // b * G + g
  const int b = bg / G;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r = tid / 32, lane = tid % 32;

  for (int i = tid; i < 256; i += nthreads) tab[i] = table[i];
  for (int i = tid; i < Dh; i += nthreads) {
    k_sc[i] = ksc[(size_t)bg * Dh + i];
    v_sc[i] = vsc[(size_t)bg * Dh + i];
  }
  for (int i = tid; i < R * Dh; i += nthreads) qs[i] = q[(size_t)bg * R * Dh + i];

  const int p = pos[b];
  // pos <= 0 masks everything: the reference then averages all S rows
  const int s_end = (p <= 0 || p > S) ? S : p;
  const uint8_t* kbase = kc + (size_t)bg * S * Dh;
  const uint8_t* vbase = vc + (size_t)bg * S * Dh;

  float m = NEG, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < s_end; t0 += BS) {
    __syncthreads();
    for (int e = tid; e < BS * Dh; e += nthreads) {
      const int j = e / Dh, d = e % Dh;
      const bool in = t0 + j < S;
      const size_t off = (size_t)(t0 + j) * Dh + d;
      ks[j * (Dh + 1) + d] = in ? tab[kbase[off]] * k_sc[d] : 0.f;
      vs[j * Dh + d] = in ? tab[vbase[off]] * v_sc[d] : 0.f;
    }
    __syncthreads();
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

template <int DPL>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* pos, const void* table, void* out,
           int B, int G, int R, int S, float qk_scale, void* stream) {
  constexpr int Dh = 32 * DPL;
  const size_t smem = sizeof(float) *
      (256 + 2 * Dh + R * Dh + BS * (Dh + 1) + BS * Dh + R * BS);
  cudaError_t err = cudaFuncSetAttribute(
      kv_flash_decode_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  kv_flash_decode_kernel<DPL><<<B * G, R * 32, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)kc, (const float*)ks,
      (const uint8_t*)vc, (const float*)vs, (const int*)pos,
      (const float*)table, (float*)out, G, R, S, qk_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kv_flash_decode(const void* q, const void* kc, const void* ks,
                               const void* vc, const void* vs, const void* pos,
                               const void* table, void* out, int B, int G,
                               int R, int S, int Dh, float qk_scale,
                               void* stream) {
  if (R < 1 || R > 32) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return launch<1>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, stream);
    case 64: return launch<2>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, stream);
    case 128: return launch<4>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, stream);
    case 256: return launch<8>(q, kc, ks, vc, vs, pos, table, out, B, G, R, S, qk_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
