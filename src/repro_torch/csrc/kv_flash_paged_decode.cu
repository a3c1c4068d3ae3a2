// One-token GQA attention over a paged byte-wide quantized KV cache, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kv_flash_paged_decode.py::kv_flash_paged_decode
// (pallas_call at :142, body _kernel :41).
//
//   q (B, G, R, Dh) f32 or bf16; k/v pools (n_pages, G, ps, Dh) int8 (fxp) or
//   uint8 (pofx); k/v scales (G, 1, Dh) f32, global per layer (pages are
//   shared between slots, so every page quantizes under one grid);
//   tables (B, max_pages) int32 physical page ids; pos (B,) int32 valid
//   lengths (stride 0: one for all) -> out (B, G, R, Dh) f32.
//
// For each (b, g) this is the dense kernel's online softmax over the
// logical positions [0, max_pages * ps): position t reads page
// tables[b, t / ps] at offset t % ps. Garbage page 0 (unallocated table
// entries) and a shared page's junk past pos[b] are read and masked
// (idx >= pos -> -1e30), never trimmed, as on the TPU.
//
// Design: the body is kv_flash_common.cuh, the dense kernel's split-S
// flash-decoding, and this file only says where a position lives. Each
// 16-byte cp.async of a tile resolves its row through the block table, so
// a copy never crosses a row and any ps >= 1 works, including page sizes
// that do not divide the 32-position tile. The chunk length L is planned
// from (B, G, S) with S rounded up to a multiple of 256 first, so a dense
// cache of max_len and the paged one of ceil(max_len / ps) * ps get the
// same L whenever ps divides 256 (kernels/kv_flash_decode.py::plan); the
// result depends only on L and the positions below s_end, so on the same
// logical cache the output equals kv_flash_decode's bit for bit. Row
// offsets are size_t: page * G * ps * Dh outgrows int32 at large pools.
//
// Bound: the code bytes of the valid positions, 2 * S_valid * Dh per
// (b, g) per layer and step, plus the block table; chunks past pos[b] read
// nothing.
#include "kv_flash_common.cuh"

namespace {

struct PagedCache {
  const int* tables;   // (B, max_pages)
  int max_pages, ps, G;
  __device__ size_t row(int b, int g, int, int t) const {
    const int page = tables[(size_t)b * max_pages + t / ps];
    return ((size_t)page * G + g) * ps + t % ps;
  }
  __device__ size_t scale_row(int, int g) const { return (size_t)g; }
};

}  // namespace

extern "C" int kv_flash_paged_decode(const void* q, const void* kpool,
                                     const void* ks, const void* vpool,
                                     const void* vs, const void* tables,
                                     const void* pos, const void* table,
                                     void* out, void* ws, void* counters,
                                     int B, int G, int R, int ps,
                                     int max_pages, int Dh, int L,
                                     int n_splits, int pos_stride, int q_bf16,
                                     float qk_scale, float step, void* stream) {
  if (ps < 1 || max_pages < 1) return (int)cudaErrorInvalidValue;
  const PagedCache cache{(const int*)tables, max_pages, ps, G};
  const kv_flash::Params P{q, (const uint8_t*)kpool, (const float*)ks,
                           (const uint8_t*)vpool, (const float*)vs,
                           (const int*)pos, (const float*)table, (float*)out,
                           (float*)ws, (int*)counters, G, R, max_pages * ps, L,
                           n_splits, pos_stride, q_bf16, qk_scale, step,
                           nullptr};  // no lse
  return kv_flash::dispatch(P, B, Dh, cache, stream);
}
