// PoFx decode: normalized-posit codes -> FxP(M, M-1) int8 codes, for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pofx_decode.py::pofx_decode
// (pallas_call at :45, body _decode_kernel :30): an elementwise 2-D map that
// runs Algorithm 1 bit by bit on every code.
//
// Bound: bytes. Each code is read once and each output written once, r*c
// bytes each way. Algorithm 1 with N, ES and M read at run time costs ~50
// integer instructions a code (pofx_common.cuh), which would make the kernel
// bound by its instruction rate at ~4x its byte bound. But the map has at most
// 2^(N-1) <= 256 distinct inputs, so:
//
// - Each block first builds the decode table in shared memory, one entry a
//   thread, by running pofx::decode_norm_to_fxp on every stored code: Algorithm
//   1 on the card still defines every value, and no table comes from the
//   host. The table holds one byte an entry: 2^(N-1) bytes, so for N <= 8 at
//   most one word a bank (32 lanes with any codes never conflict) and for
//   N = 9 two words a bank.
// - Then a persistent grid (a few blocks a SM) walks the array in 16-byte
//   spans, grid-stride, UNROLL spans a thread in flight: each code is one
//   byte extract and one shared lookup, written back with one 16-byte store.
//   The table is built once per block and serves ~300 codes a thread at the
//   serving shapes.
//
// A contiguous array is walked as one flat row, so every span but the last
// is aligned whatever the shape; a 2-D view with a row stride walks its rows.
// A span that is not whole or not 16-byte aligned takes bytes. The TPU
// wrapper pads to its (256, 512) block and slices back; here the ragged edge
// is masked instead, nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pofx_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;
constexpr int UNROLL = 4;            // spans a thread has in flight
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_LUT = 256;

struct Spans {
  const uint8_t* in;
  int8_t* out;
  long long rows, cols, ld_in, ld_out, per_row;

  // span s: its source, its destination and its length; ``whole`` when it
  // is 16 bytes long and both ends are 16-byte aligned
  __device__ __forceinline__ void at(long long s, const uint8_t*& src, int8_t*& dst, int& len,
                                     bool& whole) const {
    const long long row = rows == 1 ? 0 : s / per_row;
    const long long col = (s - row * per_row) * VEC;
    src = in + row * ld_in + col;
    dst = out + row * ld_out + col;
    len = (int)(cols - col < VEC ? cols - col : VEC);
    whole = len == VEC &&
            ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  }
};

// four codes (the low N-1 bits of each byte of w) through the table
__device__ __forceinline__ uint32_t lookup4(uint32_t w, uint32_t mask4, const uint8_t* tab) {
  w &= mask4;
  const uint32_t d0 = tab[__byte_perm(w, 0, 0x4440)], d1 = tab[__byte_perm(w, 0, 0x4441)];
  const uint32_t d2 = tab[__byte_perm(w, 0, 0x4442)], d3 = tab[__byte_perm(w, 0, 0x4443)];
  return __byte_perm(__byte_perm(d0, d1, 0x0040), __byte_perm(d2, d3, 0x0040), 0x5410);
}

__global__ void __launch_bounds__(THREADS)
pofx_decode_kernel(Spans sp, long long total, int N, int ES, int M) {
  __shared__ uint8_t tab[MAX_LUT];
  const int lut = 1 << (N - 1);
  if (threadIdx.x < lut)
    tab[threadIdx.x] = (uint8_t)pofx::decode_norm_to_fxp(threadIdx.x, N, ES, M);
  __syncthreads();
  const uint32_t mask4 = (uint32_t)(lut - 1) * 0x01010101u;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long s0 = (long long)blockIdx.x * THREADS + threadIdx.x; s0 < total;
       s0 += UNROLL * stride) {
    const uint8_t* src[UNROLL];
    int8_t* dst[UNROLL];
    int len[UNROLL];
    bool whole[UNROLL];
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {     // the loads first, all in flight
      len[u] = 0;
      whole[u] = false;
      if (s0 + u * stride < total) sp.at(s0 + u * stride, src[u], dst[u], len[u], whole[u]);
      if (whole[u]) v[u] = __ldcs(reinterpret_cast<const uint4*>(src[u]));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (whole[u]) {
        __stcs(reinterpret_cast<uint4*>(dst[u]),
               make_uint4(lookup4(v[u].x, mask4, tab), lookup4(v[u].y, mask4, tab),
                          lookup4(v[u].z, mask4, tab), lookup4(v[u].w, mask4, tab)));
      } else {
        for (int i = 0; i < len[u]; ++i) dst[u][i] = (int8_t)tab[src[u][i] & (lut - 1)];
      }
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
  static int sms[64];
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    if (int err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev))
      return err;
    if (dev < 64) sms[dev] = n_sm;
  }
  const long long per_row = (cols + VEC - 1) / VEC, total = rows * per_row;
  const long long need = (total + THREADS - 1) / THREADS;
  const long long cap = (long long)BLOCKS_PER_SM * n_sm, blocks = need < cap ? need : cap;
  const Spans sp{(const uint8_t*)codes, (int8_t*)out, rows, cols, ld_in, ld_out, per_row};
  pofx_decode_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(sp, total, N, ES, M);
  return (int)cudaGetLastError();
}
