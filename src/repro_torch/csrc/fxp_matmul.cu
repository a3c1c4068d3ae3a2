// FxP MAC: int8 (m, k) x int8 (k, n) -> int32 (m, n), exact, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fxp_matmul.py::fxp_matmul
// (pallas_call at :51, body _kernel :21): the paper's fixed-point baseline
// MAC with a 32-bit accumulator.
//
// Bound: on the serving path (the fxp rules of mixed policies) m is 4 at
// decode, so the bytes of b (k * n) bound it. Each block owns a 32 x 64
// output tile and walks k in 32-deep steps. Tiles are staged in shared
// memory as packed words of four k-consecutive bytes (b transposed on the
// way in), so one __dp4a does four int8 multiply-adds into an int32. Integer
// sums are exact in any order: the result equals the plain version bit for
// bit. Edges are masked (out-of-range bytes load as 0), never padded.
// s8 wgmma is the later speed path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int KQ = BK / 4;           // packed words per tile row
constexpr int THREADS = 256;

__device__ __forceinline__ int pack4(uint32_t b0, uint32_t b1, uint32_t b2,
                                     uint32_t b3) {
  return (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

__global__ void __launch_bounds__(THREADS)
fxp_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int32_t* __restrict__ out, int m, int k, int n) {
  __shared__ int as4[BM][KQ + 1];
  __shared__ int bs4[BN][KQ + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < k; k0 += BK) {
    {  // a: one packed word per thread
      const int r = tid / KQ, kq = tid % KQ;
      const int row = m0 + r;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + 4 * kq + i;
        v[i] = (row < m && kk < k) ? (uint8_t)a[(size_t)row * k + kk] : 0u;
      }
      as4[r][kq] = pack4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // b: two packed words per thread
      const int p = tid + THREADS * e;
      const int c = p % BN, kq = p / BN;
      const int col = n0 + c;
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = k0 + 4 * kq + i;
        v[i] = (col < n && kk < k) ? (uint8_t)b[(size_t)kk * n + col] : 0u;
      }
      bs4[c][kq] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const int a0 = as4[ty][kq], a1 = as4[ty + 16][kq];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bw = bs4[tx + 16 * j][kq];
        acc[0][j] = __dp4a(a0, bw, acc[0][j]);
        acc[1][j] = __dp4a(a1, bw, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) out[(size_t)row * n + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int fxp_matmul(const void* a, const void* b, void* out, int m,
                          int k, int n, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  fxp_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)out, m, k, n);
  return (int)cudaGetLastError();
}
