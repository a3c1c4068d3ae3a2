// One-token GQA attention over a paged byte-wide quantized KV cache, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kv_flash_paged_decode.py::kv_flash_paged_decode
// (pallas_call at :142, body _kernel :41).
//
//   q (B, G, R, Dh) f32; k/v pools (n_pages, G, ps, Dh) int8 (fxp) or
//   uint8 (pofx); k/v scales (G, 1, Dh) f32, global per layer (pages are
//   shared between slots, so every page quantizes under one grid);
//   tables (B, max_pages) int32 physical page ids; pos (B,) int32 valid
//   lengths -> out (B, G, R, Dh) f32.
//
// For each (b, g) this is the dense kernel's online softmax over the
// logical positions [0, max_pages * ps): position t reads page
// tables[b, t / ps] at offset t % ps. Garbage page 0 (unallocated table
// entries) and a shared page's junk past pos[b] are read and masked
// (idx >= pos -> -1e30), never trimmed, as on the TPU.
//
// Design: the body is kv_flash_common.cuh, the dense kernel's, and this
// file only says where a position lives. Warp 0 resolves the 32 code rows
// of the next tile through the block table into shared memory while the
// other warps finish the current one, so each lane's load is the dense
// kernel's load at another address; any ps >= 1 works, including page
// sizes that do not divide the 32-position tile. Because the summation
// order is the dense kernel's, the output on the same logical cache and S
// equals kv_flash_decode's bit for bit. Row offsets are size_t: page *
// G * ps * Dh outgrows int32 at large pools.
//
// Bound: the code bytes of the valid positions, 2 * S_valid * Dh per
// (b, g) per layer and step, plus the block table; tiles past pos[b] are
// skipped. Like the dense kernel it runs B * G blocks (16 on 132 SMs at
// 4 slots); split-S, TMA page loads and 16-byte code loads are later work.
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
                                     void* out, int B, int G, int R, int ps,
                                     int max_pages, int Dh, float qk_scale,
                                     void* stream) {
  if (ps < 1 || max_pages < 1) return (int)cudaErrorInvalidValue;
  const PagedCache cache{(const int*)tables, max_pages, ps, G};
  return kv_flash::dispatch(q, kpool, ks, vpool, vs, pos, table, out, B, G,
                            R, max_pages * ps, Dh, qk_scale, cache, stream);
}
