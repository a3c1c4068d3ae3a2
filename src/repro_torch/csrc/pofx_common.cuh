// Bit-level Algorithm 1 (the PoFx converter) for one code, on the card.
//
// The device twin of the reference's src/repro/core/pofx.py::_pofx_impl on
// its int32 datapath (jnp: left shifts clamped to 31 - N), applied to a
// normalized posit code as src/repro/kernels/ref.py::decode_norm_to_fxp
// does. The FPGA converter's stages become a handful of integer
// instructions with no data-dependent branch:
//
//   A   norm-expand the stored leading bit, sign, two's complement of the
//       body;
//   B   regime run length: the FPGA's leading-zero detector is one __clz,
//       then the exponent and fraction fields (exponent bits cut off by the
//       regime read as zeros);
//   C   shift = 2^ES * k + e + (F - (N - 1)) with F = M - 1;
//   D   barrel shift (a clamped left shift or a truncating right shift),
//       then saturation to 2^(M-1) - 1;
//   E   sign-magnitude -> two's complement; zero and NaR map to 0.
//
// N is the posit width (the stored code has N - 1 bits, N <= 9 for a byte),
// ES the exponent width, M <= 8 the FxP width. Every kernel that decodes
// PoFx codes in registers includes this header.
#pragma once

#include <stdint.h>

namespace pofx {

__device__ __forceinline__ int decode_norm_to_fxp(uint32_t code, int N, int ES,
                                                  int M) {
  const int mask_n = (1 << N) - 1;
  const int mask_body = (1 << (N - 1)) - 1;
  // A: the stored N-1 bits, leading bit replicated (norm_expand)
  const int stored = (int)code & mask_body;
  const int s = (stored >> (N - 2)) & 1;
  const int c = (s << (N - 1)) | (s << (N - 2)) | (stored & ((1 << (N - 2)) - 1));
  const int body = (s ? (-c) & mask_n : c) & mask_body;
  // B: run of leading bits equal to r0 in the (N-1)-bit body; x == 0 (the
  // whole body is the run) gives __clz 32 and m = N - 1
  const int r0 = (body >> (N - 2)) & 1;
  const int x = r0 ? (~body) & mask_body : body;
  const int m = __clz(x) - (33 - N);
  const int k = r0 ? m - 1 : -m;
  const int aligned = (body << (m + 1)) & mask_body;
  int e = 0, frac = aligned;
  if (ES > 0) {
    e = (N - 1 - ES >= 0) ? aligned >> (N - 1 - ES) : aligned;
    frac = (aligned << ES) & mask_body;
  }
  // C: the implicit one, and the shift onto M - 1 fraction bits
  const int mag_ext = (1 << (N - 1)) | frac;
  const int shift = k * (1 << ES) + e + ((M - 1) - (N - 1));
  // D: mag_ext < 2^N, so a left shift of at most 31 - N never wraps, and
  // any clamped shift still saturates
  const int left = min(max(shift, 0), 31 - N);
  const int right = min(max(-shift, 0), 31);
  int mag = shift >= 0 ? mag_ext << left : mag_ext >> right;
  mag = min(mag, (1 << (M - 1)) - 1);
  // E
  const int out = s ? -mag : mag;
  return (c == 0 || c == (1 << (N - 1))) ? 0 : out;
}

}  // namespace pofx
