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
//
// The body is kv_flash_common.cuh, shared with kv_flash_paged_decode.cu;
// this file supplies where a slot's rows live: contiguous, row b*G*S +
// g*S + t, and one scale row per (b, g).
#include "kv_flash_common.cuh"

namespace {

struct DenseCache {
  int S;
  __device__ size_t row(int, int, int bg, int t) const { return (size_t)bg * S + t; }
  __device__ size_t scale_row(int bg, int) const { return (size_t)bg; }
};

}  // namespace

extern "C" int kv_flash_decode(const void* q, const void* kc, const void* ks,
                               const void* vc, const void* vs, const void* pos,
                               const void* table, void* out, int B, int G,
                               int R, int S, int Dh, float qk_scale,
                               void* stream) {
  return kv_flash::dispatch(q, kc, ks, vc, vs, pos, table, out, B, G, R, S,
                            Dh, qk_scale, DenseCache{S}, stream);
}
