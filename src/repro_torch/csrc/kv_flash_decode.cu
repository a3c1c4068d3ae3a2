// One-token GQA attention over a byte-wide quantized KV cache, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kv_flash_decode.py::kv_flash_decode (pallas_call at
// :139, body _kernel :59, _dequant_tile :48).
//
//   q (B, G, R, Dh) f32 or bf16; k/v codes (B, G, S, Dh) int8 (fxp) or uint8
//   (pofx); k/v scales (B, G, 1, Dh) f32; pos (B,) int32 valid lengths (stride 0:
//   one for all) -> out (B, G, R, Dh) f32, and where lse is not null each
//   row's log-sum-exp of its masked scores (B, G, R) f32, for a caller that
//   combines blocks of a cache's positions held apart.
//
// Design for the H100 (the body is kv_flash_common.cuh, shared with
// kv_flash_paged_decode.cu): split-S flash-decoding. The grid is (B * G,
// n_splits), n_splits chunks of L positions planned on the host from
// (B, G, S) only (kernels/kv_flash_decode.py::plan: ~2 blocks a SM at 4
// slots and G = 4); each block streams its chunk's code bytes with 16-byte
// cp.async into a ring of byte tiles, dequantizes them in registers (fxp as
// int8(c), the 2^-F folded into the scales; pofx through a 256-entry table
// of pofx_norm_lut[c & (2^(N-1)-1)] * 2^-(M-1)), reduces each score over
// the warp with shuffles and keeps the online-softmax m, l and acc in f32;
// the last block of (b, g) combines the chunks' partials in split order.
// The per-channel scales are folded into q once and into the output once
// (the header of kv_flash_common.cuh lists the roundings that moved).
// Scores are masked with idx < pos[b] to -1e30 as in the reference; the
// output is acc / max(l, 1e-30).
//
// Bound: the code bytes, 2 * S_valid * Dh per (b, g) per layer per step;
// the arithmetic is a few flops per byte. Chunks past pos[b] write a neutral
// partial and read nothing; with the lse output a slot with pos[b] <= 0 (a
// grid rank's block wholly past the slot's position) reads nothing at all.
//
// This file supplies where a slot's rows live: contiguous, row b*G*S +
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
                               const void* table, void* out, void* ws,
                               void* counters, void* lse, int B, int G, int R, int S,
                               int Dh, int L, int n_splits, int pos_stride,
                               int q_bf16, float qk_scale, float step,
                               void* stream) {
  const kv_flash::Params P{q, (const uint8_t*)kc, (const float*)ks,
                           (const uint8_t*)vc, (const float*)vs,
                           (const int*)pos, (const float*)table, (float*)out,
                           (float*)ws, (int*)counters, G, R, S, L, n_splits,
                           pos_stride, q_bf16, qk_scale, step, (float*)lse};
  return kv_flash::dispatch(P, B, Dh, DenseCache{S}, stream);
}
