// PoFx decode: normalized-posit codes -> FxP(M, M-1) int8 codes, for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pofx_decode.py::pofx_decode
// (pallas_call at :45, body _decode_kernel :30): an elementwise 2-D map that
// runs Algorithm 1 bit by bit on every code (pofx_common.cuh).
//
// Bound: bytes. Each code is read once and each output written once, r*c
// bytes each way; the decode is some 40 integer instructions per byte, which
// the card's integer rate covers a few times over only if the loads are
// wide. So each thread takes 16 codes with one 16-byte load and writes 16
// outputs with one 16-byte store where its span is 16-byte aligned and
// whole, and falls back to bytes otherwise. The TPU wrapper pads to its
// (256, 512) block and slices back; here the ragged edge is masked instead,
// nothing is padded. A contiguous array is walked as one flat row, so every
// span but the last is aligned whatever the shape; a 2-D view with a row
// stride walks its rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pofx_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;

__global__ void __launch_bounds__(THREADS)
pofx_decode_kernel(const uint8_t* __restrict__ in, int8_t* __restrict__ out,
                   long long rows, long long cols, long long ld_in,
                   long long ld_out, long long spans_per_row, int N, int ES,
                   int M) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= rows * spans_per_row) return;
  const long long row = rows == 1 ? 0 : g / spans_per_row;
  const long long col = (g - row * spans_per_row) * VEC;
  const uint8_t* src = in + row * ld_in + col;
  int8_t* dst = out + row * ld_out + col;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (col + VEC <= cols && aligned) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t r = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = pofx::decode_norm_to_fxp((w[i] >> (8 * b)) & 0xFFu, N, ES, M);
        r |= ((uint32_t)d & 0xFFu) << (8 * b);
      }
      o[i] = r;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    const int n = (int)(cols - col < VEC ? cols - col : VEC);
    for (int i = 0; i < n; ++i) {
      dst[i] = (int8_t)pofx::decode_norm_to_fxp(src[i], N, ES, M);
    }
  }
}

}  // namespace

// codes (rows, cols) uint8 with row stride ld_in -> out (rows, cols) int8
// with row stride ld_out, on ``stream``.
extern "C" int pofx_decode(const void* codes, void* out, long long rows,
                           long long cols, long long ld_in, long long ld_out,
                           int N, int ES, int M, void* stream) {
  if (N < 3 || N > 9 || ES < 0 || ES > 4 || M < 1 || M > 8 || rows < 1 ||
      cols < 1 || ld_in < cols || ld_out < cols)
    return (int)cudaErrorInvalidValue;
  const long long spans = (cols + VEC - 1) / VEC;
  const long long blocks = (rows * spans + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  pofx_decode_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (int8_t*)out, rows, cols, ld_in, ld_out, spans, N,
      ES, M);
  return (int)cudaGetLastError();
}
