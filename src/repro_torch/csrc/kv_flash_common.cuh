// The split-S (flash-decoding) body shared by kv_flash_decode.cu (contiguous
// per-slot cache) and kv_flash_paged_decode.cu (page pool + block table).
//
// Grid (B * G, n_splits, ceil(R / 8)), 128 threads a block. Block
// (bg, c, z) runs the online softmax of query rows 8z..8z+7 over the chunk
// [c * L, (c + 1) * L) of the S positions, clipped at the slot's s_end, in
// 32-position tiles, and writes a partial (m, l, acc[Dh]) per row to the
// workspace; the last block of (bg, z) to arrive (an atomic counter, reset
// by that block) reads the n_splits partials in split order and writes
// acc / max(l, 1e-30). With one split the block writes the output itself.
// No float atomics: two launches give the same bits. The host plans L and
// n_splits from (B, G, S) only (kernels/kv_flash_decode.py::plan), so
// nothing here depends on a read of pos on the host.
//
// Inside a chunk, per tile:
// - code bytes arrive by 16-byte cp.async (a 128-byte row is 8 copies) in a
//   ring of STAGES tiles of 32 K rows and 32 V rows, three tiles in flight
//   while one is used; the ring holds bytes, dequantized at use in
//   registers (fxp: int8(c) exactly, by a byte permute and one add; pofx:
//   the 256-entry byte table in shared memory);
// - scores: warp w takes positions 8w..8w+7, a half-warp a position, lane
//   l head-dim values [(l % 16) * 2 DPL, + 2 DPL) of all 8 rows (q in
//   registers, so each K value is used 8 times while in a register); the 8
//   partial dots are reduced over the half-warp by a halving exchange (4
//   shuffles for 8 rows);
// - softmax: a half-warp a row, two positions a lane;
// - P V: warp w again takes positions 8w..8w+7, for every row, so each V
//   value is decoded once; the four warps' acc meet in warp order once, at
//   the end of the chunk.
// The combine gives a half-warp to each row.
//
// Scales are folded: q is multiplied once by k_scale * step * Dh^-0.5
// (step = 2^-F for fxp, 1 for the table) and the output once by
// v_scale * step, so the codes' values enter the sums unscaled. Against
// the plain version (dequantize K/V, one-pass softmax) the roundings that
// moved are: q * (k_scale * Dh^-0.5) before the dot instead of
// k_code * k_scale inside it and * Dh^-0.5 after it; (acc / l) * v_scale
// instead of sum p * (v_code * v_scale); the chunks' partial sums meet in
// the combine. All within the stated tolerance (1e-5 + 1e-4 max |out|).
//
// Masking is the plain version's: scores at idx >= pos[b] are -1e30 and
// positions past S weigh 0; pos > S, or pos <= 0 without the lse output
// below, attends over all S rows (s_end = S), else the walk stops at s_end = pos. A chunk that starts at
// or past s_end writes the neutral partial (m = -inf, l = 0, acc = 0),
// which the combine adds exactly. So the result depends on the positions
// below s_end and on L only: dense and paged give the same bits when their
// plans give the same L.
//
// Where P.lse is set, each row's log-sum-exp of its (scaled, masked)
// scores, m + log(l), is written beside the normalized output (f32,
// (B, G, R)): a caller that holds one block of a cache's positions combines
// its rows with the other blocks' (nn.sharding.combine_partials). There a
// row with no valid position (pos <= 0: the block lies wholly past the
// row's position) reads nothing: its blocks write out = 0 and lse = -inf
// at once, a weight of exactly 0 in the combine.
//
// A Cache policy says where position t's code row and a slot's scales are:
//   size_t row(int b, int g, int bg, int t)   codes at row * Dh .. + Dh
//   size_t scale_row(int bg, int g)           scales at scale_row * Dh
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kv_flash {

constexpr int TILE = 32;          // positions per tile
constexpr int NT = 128;           // threads a block
constexpr int NW = NT / 32;       // warps a block
constexpr int RG = 8;             // query rows a block holds (grid z: R / RG)
constexpr int STAGES = 4;         // tiles in the ring
constexpr int SROW = TILE + 1;    // a score row in shared memory (no bank conflicts)
constexpr float NEG = -1e30f;

struct Params {
  const void* q;                  // (B, G, R, Dh) f32 or bf16
  const uint8_t* kc;
  const float* ksc;
  const uint8_t* vc;
  const float* vsc;
  const int* pos;                 // pos[b * pos_stride]
  const float* table;             // 256 byte values (pofx)
  float* out;                     // (B, G, R, Dh) f32
  float* ws;                      // partials: acc (B*G*n*R*Dh), then (m, l) pairs
  int* counters;                  // B * G zeros
  int G, R, S, L, n_splits, pos_stride, q_bf16;
  float qk_scale, step;           // step 0: decode through the table
  float* lse;                     // (B, G, R) f32 m + log(l) per row, or nullptr
};

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

// Sums v[r] over each half-warp for 8 rows: three halving exchanges (8,
// 4, 2), then 1. Every lane returns the sum of row (lane >> 1) & 7 over its
// half.
__device__ __forceinline__ float reduce8(float (&v)[RG], int lane) {
#pragma unroll
  for (int off = 8, half = RG / 2; off >= 2; off >>= 1, half >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// N code bytes at p -> their values: fxp (table == nullptr) as int8,
// exactly, by placing c ^ 0x80 in the mantissa of 2^23 (one PRMT and one
// FADD a value); pofx through the byte table. p is aligned to N for N =
// 1, 2, 4, 8, 16; at Dh = 192 (DPL 6) the scores read N = 12 bytes at
// 4-byte alignment and P V reads N = 6 at 2-byte alignment, so those load
// in 4- and 2-byte words.
template <int N>
__device__ __forceinline__ void dequant(const uint8_t* p, const float* table,
                                        float (&out)[N]) {
  static_assert(N == 1 || (N % 2 == 0 && N <= 16), "dequant loads 1 or an even count <= 16");
  uint32_t w[(N + 3) / 4];
  if constexpr (N == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (N == 1) {
    w[0] = *p;
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) w[i] = 0u;
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      w[i / 2] |= (uint32_t)reinterpret_cast<const uint16_t*>(p)[i] << (16 * (i % 2));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (table) {
      out[i] = table[(w[i / 4] >> (8 * (i % 4))) & 0xffu];
    } else {
      const uint32_t bits = __byte_perm(w[i / 4] ^ 0x80808080u, 0x4b000000u, 0x7440 + i % 4);
      out[i] = __uint_as_float(bits) - 8388736.f;    // 2^23 + 128
    }
  }
}

// N floats at p (aligned to N floats), read through the L2 (other blocks
// wrote them)
template <int N>
__device__ __forceinline__ void ldcg(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + i));
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __ldcg(p + i);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int DPL>   // head-dim values per lane: Dh = 32 * DPL
__host__ __device__ constexpr size_t smem_bytes() {
  // the ring (its first half holds the warps' acc at the end), then floats
  return (size_t)STAGES * 2 * TILE * (32 * DPL)
         + sizeof(float) * (256 + (32 * DPL) + RG * (32 * DPL) + RG * SROW + RG + 2 * RG);
}

template <int DPL, class Cache>
__global__ void __launch_bounds__(NT) decode_kernel(const Params P, const Cache cache) {
  constexpr int Dh = 32 * DPL;
  constexpr int CPR = Dh / 16;                 // 16-byte copies a code row
  constexpr int QL = 2 * DPL;                  // head-dim values a lane scores
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                        // STAGES x (K tile, V tile)
  float* red = reinterpret_cast<float*>(smem); // NW x RG x Dh, once the ring is done
  float* tab = reinterpret_cast<float*>(ring + STAGES * 2 * TILE * Dh);  // 256
  float* vsc = tab + 256;                      // Dh: v_scale * step
  float* qs = vsc + Dh;                        // RG * Dh: q * k_scale * step * Dh^-0.5
  float* ss = qs + RG * Dh;                    // RG * SROW: scores, then weights
  float* cr = ss + RG * SROW;                  // RG: the tile's rescale of acc
  float* mls = cr + RG;                        // RG x (m, l) at the chunk's end
  __shared__ int last;

  const int R = P.R, S = P.S, L = P.L;
  const int bg = blockIdx.x, split = blockIdx.y;
  const int rb = blockIdx.z * RG, nr = min(RG, R - rb);   // this block's rows
  const int b = bg / P.G, g = bg % P.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool fxp = P.step != 0.f;
  const float step = fxp ? P.step : 1.f;
  const float* table = fxp ? nullptr : tab;

  const int p = P.pos[(size_t)b * P.pos_stride];
  // pos <= 0 masks everything: the plain version then averages all S rows;
  // with the lse output the rows are empty, written by split 0 alone (the
  // block's threads all return here, before any barrier or counter)
  if (p <= 0 && P.lse) {
    if (split == 0) {
      for (int e = tid; e < nr * Dh; e += NT) P.out[((size_t)bg * R + rb) * Dh + e] = 0.f;
      if (tid < nr) P.lse[(size_t)bg * R + rb + tid] = -INFINITY;
    }
    return;
  }
  const int s_end = (p <= 0 || p > S) ? S : p;
  const int c0 = split * L;
  const int c1 = min(c0 + L, s_end);
  const int n_tiles = c0 < s_end ? (c1 - c0 + TILE - 1) / TILE : 0;

  auto load_tile = [&](int t) {
    uint8_t* dst = ring + (t % STAGES) * 2 * TILE * Dh;
    const int t0 = c0 + t * TILE;
    for (int i = tid; i < 2 * TILE * CPR; i += NT) {
      const int kv = i / (TILE * CPR), rem = i % (TILE * CPR);
      const int j = rem / CPR, part = rem % CPR;
      const bool in = t0 + j < S;           // past the cache: zero-filled
      const uint8_t* base = kv ? P.vc : P.kc;
      const uint8_t* src = in ? base + cache.row(b, g, bg, t0 + j) * Dh + part * 16 : base;
      cp_async16(dst + kv * TILE * Dh + j * Dh + part * 16, src, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_commit();
  }

  // the block's constants: every load issued before the first store, so
  // their trips to memory overlap
  if (n_tiles > 0) {
    const size_t srow = cache.scale_row(bg, g);
    const float kq = step * P.qk_scale;
    float tv[256 / NT], vv[256 / NT], qv[RG * Dh / NT], kv[RG * Dh / NT];
#pragma unroll
    for (int u = 0; u < 256 / NT; ++u) {
      const int i = tid + u * NT;
      tv[u] = fxp ? 0.f : P.table[i];
      vv[u] = i < Dh ? P.vsc[srow * Dh + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RG * Dh / NT; ++u) {
      const int i = tid + u * NT;              // row i / Dh of the block
      const size_t at = ((size_t)bg * R + rb) * Dh + i;
      const bool in = i < nr * Dh;
      qv[u] = !in ? 0.f
              : P.q_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(P.q)[at])
                         : reinterpret_cast<const float*>(P.q)[at];
      kv[u] = P.ksc[srow * Dh + i % Dh];
    }
#pragma unroll
    for (int u = 0; u < 256 / NT; ++u) {
      const int i = tid + u * NT;
      if (!fxp) tab[i] = tv[u];
      if (i < Dh) vsc[i] = vv[u] * step;
    }
#pragma unroll
    for (int u = 0; u < RG * Dh / NT; ++u) qs[tid + u * NT] = qv[u] * (kv[u] * kq);
  }

  // softmax state: thread (row tid / 16, lanes of a half-warp) for row
  // tid / 16; acc: warp w's share (its 8 positions of every tile) of all
  // RG rows, lane l head-dim values [l * DPL, (l + 1) * DPL)
  const int sr = tid / 16, sq = tid % 16;
  float m = NEG, l = 0.f, acc[RG][DPL];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_commit();
    cp_wait<STAGES - 1>();
    __syncthreads();
    const uint8_t* kt = ring + (t % STAGES) * 2 * TILE * Dh;
    const uint8_t* vt = kt + TILE * Dh;
    const int t0 = c0 + t * TILE;
    const int jn = min(TILE, s_end - t0);      // weights past s_end are 0

    // scores: warp w, positions 8w..8w+7, two at a time (a half-warp
    // each, lane l head-dim values [(l % 16) * QL, + QL)), all RG rows
    {
      const int h = lane >> 4, hl = lane & 15;
      float qr[RG][QL];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int i = 0; i < QL; ++i) qr[r][i] = qs[r * Dh + hl * QL + i];
#pragma unroll 2
      for (int jj = 0; jj < TILE / NW; jj += 2) {
        const int j = warp * (TILE / NW) + jj + h;
        float kv[QL];
        dequant<QL>(kt + j * Dh + hl * QL, table, kv);
        float v[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < QL; ++i) a = fmaf(qr[r][i], kv[i], a);
          v[r] = a;
        }
        float s = reduce8(v, lane);
        const int idx = t0 + j;
        if (!(idx < p)) s = NEG;
        if (idx >= S) s = -INFINITY;             // beyond the cache: weight 0
        if ((lane & 1) == 0) ss[((lane >> 1) & 7) * SROW + j] = s;
      }
    }
    __syncthreads();

    // online softmax: a half-warp a row, two positions a lane
    {
      const bool valid = sr < nr;
      const float s0 = valid ? ss[sr * SROW + 2 * sq] : -INFINITY;
      const float s1 = valid ? ss[sr * SROW + 2 * sq + 1] : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l = l * corr + ps;
      m = m_new;
      ss[sr * SROW + 2 * sq] = p0;
      ss[sr * SROW + 2 * sq + 1] = p1;
      if (sq == 0) cr[sr] = corr;
    }
    __syncthreads();

    // P V: warp w, its 8 positions, every row
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const float c = cr[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= c;
    }
#pragma unroll 4
    for (int jj = 0; jj < TILE / NW; ++jj) {
      const int j = warp * (TILE / NW) + jj;
      if (j >= jn) break;
      float vv[DPL];
      dequant<DPL>(vt + j * Dh + lane * DPL, table, vv);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float pw = ss[r * SROW + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pw, vv[i], acc[r][i]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();

  // the warps' acc meet in warp order; (m, l) of each row to shared memory
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[(warp * RG + r) * Dh + lane * DPL + i] = acc[r][i];
  if (sq == 0) {
    mls[2 * sr] = n_tiles > 0 ? m : -INFINITY;   // neutral: (-inf, 0, 0)
    mls[2 * sr + 1] = l;
  }
  __syncthreads();

  const int n = P.n_splits;
  float* wacc = P.ws;
  float* wml = P.ws + (size_t)gridDim.x * n * R * Dh;
  for (int e = tid; e < nr * Dh; e += NT) {
    const int r = e / Dh, d = e % Dh;
    float a = red[r * Dh + d];
#pragma unroll
    for (int w = 1; w < NW; ++w) a += red[(w * RG + r) * Dh + d];
    if (n == 1) {
      const float inv = 1.f / fmaxf(mls[2 * r + 1], 1e-30f);
      P.out[((size_t)bg * R + rb + r) * Dh + d] = a * inv * vsc[d];
    } else {
      wacc[(((size_t)bg * n + split) * R + rb + r) * Dh + d] = a;
    }
  }
  if (n == 1) {
    if (P.lse && tid < nr) P.lse[(size_t)bg * R + rb + tid] = mls[2 * tid] + logf(mls[2 * tid + 1]);
    return;
  }
  if (tid < 2 * nr) wml[2 * (((size_t)bg * n + split) * R + rb) + tid] = mls[tid];

  __threadfence();
  __syncthreads();
  const int ctr = bg * gridDim.z + blockIdx.z;
  if (tid == 0) {
    last = atomicAdd(P.counters + ctr, 1) == n - 1;
    if (last) P.counters[ctr] = 0;              // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the combine: a half-warp a row, every row at once; the splits' (m, l)
  // 16 at a time across the half's lanes, their max, then l and acc summed
  // in split order (weights broadcast by shuffles), 8 splits' acc in flight
  {
    const size_t srow = cache.scale_row(bg, g);
    const int r = rb + min(sr, nr - 1);          // the rows past nr: a copy, not written
    const size_t row0 = (size_t)bg * n * R + r;  // the partial row of split c: row0 + c * R
    float mx = -INFINITY;
    for (int c = sq; c < n; c += 16) mx = fmaxf(mx, __ldcg(wml + 2 * (row0 + (size_t)c * R)));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f, a[QL];
#pragma unroll
    for (int i = 0; i < QL; ++i) a[i] = 0.f;
    for (int cb = 0; cb < n; cb += 16) {
      float w = 0.f, lc = 0.f;
      if (cb + sq < n) {
        const size_t row = row0 + (size_t)(cb + sq) * R;
        w = expf(__ldcg(wml + 2 * row) - mx);
        lc = __ldcg(wml + 2 * row + 1);
      }
      const int cn = min(16, n - cb);
#pragma unroll 8
      for (int cc = 0; cc < cn; ++cc) {
        const float wc = __shfl_sync(0xffffffffu, w, cc, 16);
        lsum = fmaf(__shfl_sync(0xffffffffu, lc, cc, 16), wc, lsum);
        float part[QL];
        ldcg<QL>(wacc + (row0 + (size_t)(cb + cc) * R) * Dh + sq * QL, part);
#pragma unroll
        for (int i = 0; i < QL; ++i) a[i] = fmaf(part[i], wc, a[i]);
      }
    }
    if (sr < nr) {
      if (P.lse && sq == 0) P.lse[(size_t)bg * R + r] = mx + logf(lsum);
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      float* o = P.out + ((size_t)bg * R + r) * Dh + sq * QL;
#pragma unroll
      for (int i = 0; i < QL; ++i)
        o[i] = a[i] * inv * (P.vsc[srow * Dh + sq * QL + i] * step);
    }
  }
}

template <int DPL, class Cache>
int launch(const Params& P, int B, const Cache& cache, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<DPL, Cache>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<DPL>());
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(B * P.G, P.n_splits, (P.R + RG - 1) / RG);
  decode_kernel<DPL, Cache><<<grid, NT, smem_bytes<DPL>(), (cudaStream_t)stream>>>(P, cache);
  return (int)cudaGetLastError();
}

// Dh = 32 * DPL for Dh in {32, 64, 128, 192, 256}; anything else is
// refused, as is a plan whose chunks are not whole tiles or do not cover S.
// At DPL 6 a code row is 12 16-byte copies (rows stay 16-byte aligned) and
// the ring and its floats take 58240 bytes of shared memory.
template <class Cache>
int dispatch(const Params& P, int B, int Dh, const Cache& cache, void* stream) {
  if (P.R < 1 || P.R > 32 || B < 1 || P.G < 1 || P.S < 1 || P.L < TILE || P.L % TILE
      || P.n_splits < 1 || (long long)P.n_splits * P.L < P.S)
    return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return launch<1>(P, B, cache, stream);
    case 64: return launch<2>(P, B, cache, stream);
    case 128: return launch<4>(P, B, cache, stream);
    case 192: return launch<6>(P, B, cache, stream);
    case 256: return launch<8>(P, B, cache, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace kv_flash
