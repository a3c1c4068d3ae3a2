// Fused PoFx decode + matmul (the Move&Store datapath) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pofx_matmul.py::pofx_matmul
// (pallas_call at :89, body _kernel :36).
//
//   out[i, j] = (sum_k x[i, k] * lut[codes[k, j]]) * scale[j]
//
// x is (m, k) bf16 or f32, codes (k, n) uint8 normalized-posit codes,
// scale (n,) f32, out (m, n) f32. ``lut`` holds the 2^(N-1) decoded values
// pofx_norm_lut(N, ES, M)[c] / 2^(M-1), exact in f32 (and in bf16: every
// value is k/128 with |k| <= 127), staged once per block in shared memory.
// Codes index it through their low N-1 bits, as the bit-level decode does.
//
// Bound: on the serving path m is 4 (decode, one row per slot) or the
// prompt bucket (prefill), so the product is bound by the bytes of the
// codes (k*n), far below the bf16 ridge point. The design streams each
// code byte once per m-tile, decodes it in shared memory and never writes
// decoded weights to device memory. Each block owns a BM x BN output tile,
// walks k in BK steps and accumulates in f32 registers; the next tile's
// codes and activations are prefetched into registers while the current one
// is consumed. Edges are masked (out-of-range codes and rows read as 0), the
// tensors are never padded. No tensor cores are used: the f32 FMAs keep
// the result within sum-order rounding of the plain f32 product.
//
// For a later speed PR: decoded weights are exact in bf16, so a bf16 wgmma
// path loses nothing on the weight side; split-k would fill the card at
// decode (n = 4096 gives only 64 blocks here).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int MAX_LUT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT>
__global__ void __launch_bounds__(THREADS)
pofx_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                   const float* __restrict__ scale,
                   const float* __restrict__ lut, float* __restrict__ out,
                   int m, int k, int n, int lut_size) {
  __shared__ float lut_s[MAX_LUT];
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;           // output columns tx + 16 * j
  const int ty = tid / 16;           // output row
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int lut_mask = lut_size - 1;

  for (int i = tid; i < lut_size; i += THREADS) lut_s[i] = lut[i];

  // code tile: thread loads 8 consecutive bytes of one row
  const int cr = tid / 8, cc = (tid % 8) * 8;
  // x tile: thread loads 2 elements
  const int xr0 = (tid * 2) / BK, xc0 = (tid * 2) % BK;

  uint8_t cbuf[8];
  float xbuf[2];
  auto fetch = [&](int k0) {
    const int kr = k0 + cr;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = n0 + cc + e;
      cbuf[e] = (kr < k && col < n) ? codes[(size_t)kr * n + col] : 0;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + xr0, kc = k0 + xc0 + e;
      xbuf[e] = (row < m && kc < k) ? to_f32(x[(size_t)row * k + kc]) : 0.f;
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  fetch(0);
  __syncthreads();                   // lut_s ready
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // rows past k decode to 0: masked, not padded
      ws[cr][cc + e] = (k0 + cr < k) ? lut_s[cbuf[e] & lut_mask] : 0.f;
    }
    xs[xr0][xc0] = xbuf[0];
    xs[xr0][xc0 + 1] = xbuf[1];
    __syncthreads();
    if (k0 + BK < k) fetch(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a = xs[ty][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, ws[kk][tx + 16 * j], acc[j]);
    }
    __syncthreads();
  }
  const int row = m0 + ty;
  if (row < m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[(size_t)row * n + col] = acc[j] * scale[col];
    }
  }
}

template <typename XT>
int launch(const void* x, const void* codes, const void* scale, const void* lut,
           void* out, int m, int k, int n, int lut_size, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  pofx_matmul_kernel<XT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const XT*)x, (const uint8_t*)codes, (const float*)scale,
      (const float*)lut, (float*)out, m, k, n, lut_size);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pofx_matmul_f32(const void* x, const void* codes,
                               const void* scale, const void* lut, void* out,
                               int m, int k, int n, int lut_size,
                               void* stream) {
  if (lut_size > MAX_LUT || (lut_size & (lut_size - 1))) return (int)cudaErrorInvalidValue;
  return launch<float>(x, codes, scale, lut, out, m, k, n, lut_size, stream);
}

extern "C" int pofx_matmul_bf16(const void* x, const void* codes,
                                const void* scale, const void* lut, void* out,
                                int m, int k, int n, int lut_size,
                                void* stream) {
  if (lut_size > MAX_LUT || (lut_size & (lut_size - 1))) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(x, codes, scale, lut, out, m, k, n, lut_size,
                               stream);
}
