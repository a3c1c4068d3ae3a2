// Fused PoFx decode + matmul (the Move&Store datapath) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pofx_matmul.py::pofx_matmul
// (pallas_call at :89, body _kernel :36).
//
//   out[i, j] = (sum_k x[i, k] * lut[codes[k, j]]) * scale[j]
//
// x is (m, k) bf16 or f32, codes (k, n) uint8 normalized-posit codes,
// scale (n,) f32, out (m, n) f32. ``lut`` holds the 2^(N-1) decoded values
// pofx_norm_lut(N, ES, M)[c] / 2^(M-1); each is j/128 with |j| <= 127, exact
// in f32 and in bf16. Codes index it through their low N-1 bits, as the
// bit-level decode does.
//
// What bounds it. At decode (m = the slots, 4) the product sits far below the
// ridge point (~295 bf16 operations a byte): the k*n code bytes bound it, and
// the design's job is to stream them at the memory rate from every SM. The
// decode itself costs one shared-memory load a code, so shared-memory
// bandwidth is the next limit. At prefill (m = the prompt bucket, 64) the
// bytes still bound it on paper, but every column block also streams the x
// tile (half its code bytes at 256 columns a block), and the 64 f32
// accumulators a thread holds leave room for only two blocks a SM: moving
// the tiles takes most of the time there. Above m ~300 the tensor cores
// would bound it. The design:
//
// - Split k. A block owns 128 columns per warpgroup, an m-tile and one slice
//   of k. The wrapper's plan picks the slices from (k, n) and the block
//   shape, enough (at most 32) to put ~2 blocks on each SM at decode. Each
//   slice leaves its partial sums in a workspace the wrapper allocates,
//   written through shared memory in 16-byte pieces. At m <= 16 and on the
//   f32 path the last block of a tile to arrive adds them; at m > 16 a second
//   pass does, launched as the first one's programmatic dependent so that its
//   launch overlaps it. Either way the partials are added in slice order and
//   then scaled, and no float atomics are used: two launches give the same
//   bits. The f32 split depends on (k, n) only and every output's sum order
//   on the split alone, so the f32 path gives a row the same bits at any m.
//   The bf16 path does not promise it: its block, and with it the split,
//   follows m.
// - Stream the codes. Each thread issues 16-byte cp.async copies, neighbours
//   on neighbouring bytes, into a ring of tiles (BK rows of k) in shared
//   memory, two or three tiles in flight while one is decoded. Codes whose
//   rows are not 16-byte aligned (n % 16 != 0, or a misaligned base) take a
//   byte-wise load path inside the kernel; so does x.
// - Decode through a table the banks can serve. The 2^(N-1) values are kept
//   32 times over in shared memory, entry c of lane l at word 32 c + l, so 32
//   lanes with any codes hit 32 distinct banks; a decode is one PRMT and one
//   shared load. Decoded weights never reach device memory. (The bit-level
//   decode of pofx_common.cuh costs ~50 instructions a code, more than the
//   byte bound allows.)
// - bf16 x: tensor cores through wgmma, the swapped product out^T = W^T x^T.
//   Decoded weights go straight into the register A fragments of
//   wgmma.m64nNk16 (64 columns of n per instruction, two per k16 step), x^T
//   is the B operand in shared memory (no swizzle), m padded to N = 8..64 by
//   zero rows in shared memory only. The columns a thread owns in its
//   fragments are mapped to 4 neighbouring columns of n, so one 32-bit
//   shared load gives a thread its codes of one k row. bf16 x bf16 products
//   are exact in f32 and the sums stay f32.
// - f32 x: exact f32 on CUDA cores (no TF32, no bf16 splitting), one fmaf
//   chain per output in ascending k, with the same split, ring and table.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;           // columns of n per warpgroup
constexpr int BK = 64;            // rows of k per ring tile
constexpr int STAGES = 4;         // tiles in the ring (the bf16 kernel: ST)
constexpr int WG_THREADS = 128;   // one warpgroup
// code tile of a block of WG warpgroups: BK rows of 128 WG bytes, rows padded
// by 16 bytes so that the four k rows a warp reads at once fall in
// different banks
template <int WG> __host__ __device__ constexpr int crow() { return BN * WG + 16; }
template <int WG> __host__ __device__ constexpr int ctile() { return BK * crow<WG>(); }
constexpr int MT32 = 4;           // x rows per block on the f32 path
constexpr int MAX_LUT = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copies; src_bytes = 0 zero-fills the destination. Codes are
// read once and bypass L1 (.cg); x tiles are read by every column block of a
// slice, so they go through L1 (.ca), where the SM's other blocks find them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage rows [kt, kt + BK) of the block's 128 WG code columns; rows past
// kend and columns past n read as code 0 (the tensors are never padded).
template <int WG>
__device__ __forceinline__ void load_codes(uint8_t* dst, const uint8_t* __restrict__ codes,
                                           int kt, int kend, int n0, int n, bool vec) {
  constexpr int W = BN * WG, T = WG_THREADS * WG;
  const int tid = threadIdx.x;
  if (vec) {                      // n % 16 == 0 and a 16-byte aligned base
#pragma unroll
    for (int i = 0; i < BK * W / 16 / T; ++i) {
      const int q = tid + i * T, row = q / (W / 16), c = (q % (W / 16)) * 16;
      const int kr = kt + row, col = n0 + c;
      const bool in = kr < kend && col < n;
      cp_async16(dst + row * crow<WG>() + c, in ? codes + (size_t)kr * n + col : codes,
                 in ? 16 : 0);
    }
  } else {
    for (int q = tid; q < BK * W; q += T) {
      const int row = q / W, c = q % W, kr = kt + row, col = n0 + c;
      dst[row * crow<WG>() + c] = (kr < kend && col < n) ? codes[(size_t)kr * n + col] : 0;
    }
  }
}

// The table, 32 copies: entry c of lane l at word 32 c + l. Each warp reads
// 32 entries with one load and hands them out by shuffles, so a block's fill
// is one global load a thread and conflict-free stores.
__device__ __forceinline__ void fill_table(uint32_t* tab, const float* __restrict__ lut,
                                           int lut_size) {
  const int lane = threadIdx.x % 32;
  for (int base = (threadIdx.x / 32) * 32; base < lut_size; base += blockDim.x) {
    const uint32_t v = base + lane < lut_size ? __float_as_uint(lut[base + lane]) : 0u;
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      const uint32_t ve = __shfl_sync(0xffffffffu, v, e);
      if (base + e < lut_size) tab[(base + e) * 32 + lane] = ve;
    }
  }
}

__device__ __forceinline__ void add4(float4& v, const float4& p) {
  v.x += p.x;
  v.y += p.y;
  v.z += p.z;
  v.w += p.w;
}

// The epilogue of a split. The block's partial tile (``red``, ROWS x W floats
// in shared memory, one word after it free) goes to the workspace
// ws[slice][row][col] in whole 16-byte pieces (a thread's fragments are
// scattered; through shared memory they leave coalesced). With LAST, the
// last of the tile's S blocks to arrive (a counter per tile, which that
// block sets back to 0) adds the S partials in slice order, applies the
// scale and writes out: which block comes last changes nothing in the sums.
// That saves a launch where the tiles are small (decode); where they are
// large (m > 16) one block would add too much alone, and the second pass
// (reduce_slices_kernel) spreads the same sums over the card.
template <int ROWS, int W, bool LAST>
__device__ __forceinline__ void split_epilogue(float* red, const float* __restrict__ scale,
                                               float* __restrict__ out, float* __restrict__ ws,
                                               unsigned* __restrict__ counters, int m0, int m,
                                               int n0, int n) {
  volatile unsigned* last = reinterpret_cast<volatile unsigned*>(red + ROWS * W);
  __syncthreads();
  const int S = gridDim.y;
  const size_t mn = (size_t)m * n;
  for (int i = threadIdx.x; i < ROWS * W / 4; i += blockDim.x) {
    const int row = m0 + i / (W / 4), col = n0 + (i % (W / 4)) * 4;
    if (row >= m || col >= n) continue;
    const float4 v = reinterpret_cast<const float4*>(red)[i];
    float* dst = ws + blockIdx.y * mn + (size_t)row * n + col;
    if (n % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && col + e < n; ++e) dst[e] = vs[e];
    }
  }
  if (!LAST) return;
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1u) == (unsigned)S - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = threadIdx.x; i < ROWS * W / 4; i += blockDim.x) {
    const int row = m0 + i / (W / 4), col = n0 + (i % (W / 4)) * 4;
    if (row >= m || col >= n) continue;
    const float* src = ws + (size_t)row * n + col;
    if (n % 4 == 0) {
      // eight slices' loads in flight at a time, added in slice order
      auto part = [&](int s) { return __ldcg(reinterpret_cast<const float4*>(src + s * mn)); };
      float4 v = part(0);
      int s = 1;
      for (; s + 8 <= S; s += 8) {
        float4 p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) p[u] = part(s + u);
#pragma unroll
        for (int u = 0; u < 8; ++u) add4(v, p[u]);
      }
      for (; s < S; ++s) add4(v, part(s));
      *reinterpret_cast<float4*>(out + (size_t)row * n + col) =
          make_float4(v.x * scale[col], v.y * scale[col + 1], v.z * scale[col + 2],
                      v.w * scale[col + 3]);
    } else {
      for (int e = 0; e < 4 && col + e < n; ++e) {
        float v = __ldcg(src + e);
        for (int s = 1; s < S; ++s) v += __ldcg(src + s * mn + e);
        out[(size_t)row * n + col + e] = v * scale[col + e];
      }
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// bf16 path: wgmma.m64nNk16, A (decoded W^T) from registers, B (x^T) from
// shared memory in the no-swizzle K-major layout: for k16 step j, x row r and
// k half h the 16 bytes of x[r, 16 j + 8 h .. + 8] sit at
//   j * (NT * 32) + (r / 8) * 256 + h * 128 + (r % 8) * 16,
// i.e. 8x8 core matrices of 128 bytes, 128 bytes apart along k (leading
// byte offset) and 256 bytes apart along the rows (stride byte offset).

__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

template <int NT> struct Wgmma;

template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// x rows [m0, m0 + NT) by k [kt, kt + BK) into the B layout above; rows past
// m and k past kend read as 0.
template <int NT>
__device__ __forceinline__ void load_x_bf16(uint8_t* dst, const __nv_bfloat16* __restrict__ x,
                                            int m0, int m, int k, int kt, int kend, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {                      // k % 8 == 0 and a 16-byte aligned base
    for (int q = tid; q < NT * (BK / 8); q += blockDim.x) {
      const int r = q % NT, c8 = q / NT, j = c8 / 2, h = c8 % 2;
      const int row = m0 + r, kc = kt + c8 * 8;
      const bool in = row < m && kc < kend;
      cp_async16_l1(dst + j * (NT * 32) + (r / 8) * 256 + h * 128 + (r % 8) * 16,
                    in ? x + (size_t)row * k + kc : x, in ? 16 : 0);
    }
  } else {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
    for (int q = tid; q < NT * BK; q += blockDim.x) {
      const int r = q / BK, kk = q % BK, j = kk / 16, h = (kk / 8) % 2;
      const int row = m0 + r, kc = kt + kk;
      d[(j * (NT * 32) + (r / 8) * 256 + h * 128 + (r % 8) * 16) / 2 + kk % 8] =
          (row < m && kc < kend) ? x[(size_t)row * k + kc] : __float2bfloat16(0.f);
    }
  }
}

// byte b of a word of (masked) codes, zero-extended: one PRMT
__device__ __forceinline__ uint32_t code(uint32_t w, int b) {
  return __byte_perm(w, 0, 0x4440 + b);
}

// a pair of table words (f32 values exact in bf16) -> bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

template <int NT, int WG, int ST>
__global__ void __launch_bounds__(WG_THREADS * WG)
pofx_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                        const float* __restrict__ scale, const float* __restrict__ lut,
                        float* __restrict__ out, float* __restrict__ ws,
                        unsigned* __restrict__ counters, int m, int k, int n,
                        int lut_size, int slice_len, bool vec_codes, bool vec_x) {
  constexpr int XTILE = NT * BK * 2, CTILE = ctile<WG>(), CROW = crow<WG>();
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xs = smem;                                   // ST x XTILE
  uint8_t* cs = smem + ST * XTILE;                  // ST x CTILE
  uint32_t* tab = reinterpret_cast<uint32_t*>(cs + ST * CTILE);

  const int tid = threadIdx.x, lane = tid % 32, w = (tid / 32) % 4, wg = tid / WG_THREADS;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN * WG, slice = blockIdx.y, m0 = blockIdx.z * NT;
  const int kbeg = slice * slice_len, kend = min(k, kbeg + slice_len);
  const int nsteps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const uint32_t lut_mask4 = (lut_size - 1) * 0x01010101u;   // the low N-1 bits of 4 codes

  // prologue: ST - 1 tiles in flight, then the table while they land
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nsteps) {
      load_codes<WG>(cs + s * CTILE, codes, kbeg + s * BK, kend, n0, n, vec_codes);
      load_x_bf16<NT>(xs + s * XTILE, x, m0, m, k, kbeg + s * BK, kend, vec_x);
    }
    cp_async_commit();
  }
  if (NT > 16) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  fill_table(tab, lut, lut_size);
  const uint32_t* tab_l = tab + lane;

  float acc[2][NT / 2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[j][i] = 0.f;

  // a thread's codes: 4 neighbouring columns of one k row per 32-bit load
  const int ccol = wg * BN + (w * 8 + g) * 4;
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<ST - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    {
      const int s = it + ST - 1;
      if (s < nsteps) {
        load_codes<WG>(cs + (s % ST) * CTILE, codes, kbeg + s * BK, kend, n0, n, vec_codes);
        load_x_bf16<NT>(xs + (s % ST) * XTILE, x, m0, m, k, kbeg + s * BK, kend, vec_x);
      }
      cp_async_commit();
    }
    const uint8_t* ct = cs + (it % ST) * CTILE;
    const uint8_t* xt = xs + (it % ST) * XTILE;
    uint32_t a[BK / 16][2][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // k rows 16 j + 2 t + {0, 1, 8, 9}: the A fragment's k columns
      uint32_t cw[4], f[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = 16 * j + 2 * t + (r & 1) + 8 * (r >> 1);
        cw[r] = *reinterpret_cast<const uint32_t*>(ct + kr * CROW + ccol) & lut_mask4;
#pragma unroll
        for (int b = 0; b < 4; ++b) f[r][b] = tab_l[code(cw[r], b) * 32];
      }
      // wgmma q covers columns ccol + 2 q + {0 (rows g), 1 (rows g + 8)}
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[j][q][0] = pack_bf16(f[0][2 * q], f[1][2 * q]);
        a[j][q][1] = pack_bf16(f[0][2 * q + 1], f[1][2 * q + 1]);
        a[j][q][2] = pack_bf16(f[2][2 * q], f[3][2 * q]);
        a[j][q][3] = pack_bf16(f[2][2 * q + 1], f[3][2 * q + 1]);
      }
      wgmma_fence();
      const uint64_t desc = b_desc(xt + j * (NT * 32));
#pragma unroll
      for (int q = 0; q < 2; ++q) Wgmma<NT>::mma(acc[q], a[j][q], desc);
      wgmma_commit();
    }
    wgmma_wait_all();
  }
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // acc[q][4 i + e]: column n0 + ccol + 2 q + (e >> 1), x row m0 + 8 i + 2 t + (e & 1)
  if (gridDim.y == 1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int col = n0 + ccol + 2 * q + e2;
        if (col >= n) continue;
        const float sc = scale[col];
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int row = m0 + 8 * i + 2 * t + e1;
            if (row < m) out[(size_t)row * n + col] = acc[q][4 * i + 2 * e2 + e1] * sc;
          }
        }
      }
    }
    return;
  }
  // a split: the partial tile through the (drained) ring to the workspace
  static_assert(NT * BN * WG * 4 + 4 <= ST * (XTILE + CTILE), "partial tile fits the ring");
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * i + 2 * t + (e & 1)) * (BN * WG) + ccol + 2 * q + (e >> 1)] = acc[q][4 * i + e];
  split_epilogue<NT, BN * WG, (NT <= 16)>(red, scale, out, ws, counters, m0, m, n0, n);
}

// ---------------------------------------------------------------------------
// f32 path: thread (c = lane, r = warp) owns columns n0 + 4 c .. + 3 of x row
// m0 + r and walks its slice of k in ascending order, one fmaf per product.

__device__ __forceinline__ void load_x_f32(float* dst, const float* __restrict__ x, int m0,
                                           int m, int k, int kt, int kend, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {                      // k % 4 == 0 and a 16-byte aligned base
    if (tid < MT32 * BK / 4) {
      const int r = tid / (BK / 4), c = (tid % (BK / 4)) * 4;
      const int row = m0 + r, kc = kt + c;
      const bool in = row < m && kc < kend;
      cp_async16_l1(dst + r * BK + c, in ? x + (size_t)row * k + kc : x, in ? 16 : 0);
    }
  } else {
    for (int q = tid; q < MT32 * BK; q += WG_THREADS) {
      const int r = q / BK, kk = q % BK, row = m0 + r, kc = kt + kk;
      dst[q] = (row < m && kc < kend) ? x[(size_t)row * k + kc] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS)
pofx_matmul_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                       const float* __restrict__ scale, const float* __restrict__ lut,
                       float* __restrict__ out, float* __restrict__ ws,
                       unsigned* __restrict__ counters, int m, int k, int n,
                       int lut_size, int slice_len, bool vec_codes, bool vec_x) {
  constexpr int XTILE = MT32 * BK * 4, CTILE = ctile<1>(), CROW = crow<1>();
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xs = smem;
  uint8_t* cs = smem + STAGES * XTILE;
  float* tab = reinterpret_cast<float*>(cs + STAGES * CTILE);

  const int tid = threadIdx.x, lane = tid % 32, r = tid / 32;
  const int n0 = blockIdx.x * BN, slice = blockIdx.y, m0 = blockIdx.z * MT32;
  const int kbeg = slice * slice_len, kend = min(k, kbeg + slice_len);
  const int nsteps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const uint32_t lut_mask4 = (lut_size - 1) * 0x01010101u;   // the low N-1 bits of 4 codes

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) {
      load_codes<1>(cs + s * CTILE, codes, kbeg + s * BK, kend, n0, n, vec_codes);
      load_x_f32(reinterpret_cast<float*>(xs + s * XTILE), x, m0, m, k, kbeg + s * BK, kend,
                 vec_x);
    }
    cp_async_commit();
  }
  fill_table(reinterpret_cast<uint32_t*>(tab), lut, lut_size);
  const float* tab_l = tab + lane;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int s = it + STAGES - 1;
      if (s < nsteps) {
        load_codes<1>(cs + (s % STAGES) * CTILE, codes, kbeg + s * BK, kend, n0, n, vec_codes);
        load_x_f32(reinterpret_cast<float*>(xs + (s % STAGES) * XTILE), x, m0, m, k,
                   kbeg + s * BK, kend, vec_x);
      }
      cp_async_commit();
    }
    const uint8_t* ct = cs + (it % STAGES) * CTILE + 4 * lane;
    const float* xt = reinterpret_cast<const float*>(xs + (it % STAGES) * XTILE) + r * BK;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const uint32_t cw = *reinterpret_cast<const uint32_t*>(ct + kk * CROW) & lut_mask4;
      const float xv = xt[kk];
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[b] = fmaf(xv, tab_l[code(cw, b) * 32], acc[b]);
    }
  }

  if (gridDim.y == 1) {
    const int row = m0 + r;
    if (row >= m) return;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = n0 + 4 * lane + b;
      if (col < n) out[(size_t)row * n + col] = acc[b] * scale[col];
    }
    return;
  }
  static_assert(MT32 * BN * 4 + 4 <= STAGES * (XTILE + CTILE), "partial tile fits the ring");
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  *reinterpret_cast<float4*>(red + r * BN + 4 * lane) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  split_epilogue<MT32, BN, true>(red, scale, out, ws, counters, m0, m, n0, n);
}

// The second pass at m > 16: out = (sum of the slices' partials, in slice
// order) * scale, the same sums the last-arriving block takes. Launched as a
// programmatic dependent of the main kernel, so that its launch overlaps
// it; it waits for the main grid before it reads.
__global__ void __launch_bounds__(256)
reduce_slices_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                     float* __restrict__ out, int m, int n, int S) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t mn = (size_t)m * n;
  if (n % 4 == 0) {               // whole 16-byte pieces, four slices in flight
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn / 4;
         i += (size_t)gridDim.x * blockDim.x) {
      float4 v = w4[i];
      int s = 1;
      for (; s + 4 <= S; s += 4) {
        const float4 p0 = w4[s * mn / 4 + i], p1 = w4[(s + 1) * mn / 4 + i],
                     p2 = w4[(s + 2) * mn / 4 + i], p3 = w4[(s + 3) * mn / 4 + i];
        add4(v, p0);
        add4(v, p1);
        add4(v, p2);
        add4(v, p3);
      }
      for (; s < S; ++s) add4(v, w4[s * mn / 4 + i]);
      const float* sc = scale + (4 * i) % n;
      reinterpret_cast<float4*>(out)[i] =
          make_float4(v.x * sc[0], v.y * sc[1], v.z * sc[2], v.w * sc[3]);
    }
    return;
  }
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < S; ++s) v += ws[s * mn + i];
    out[i] = v * scale[i % n];
  }
}

int launch_reduce(const void* ws, const void* scale, void* out, int m, int n, int S,
                  cudaStream_t st) {
  const size_t mn = (size_t)m * n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((mn + 255) / 256 < 2048 ? (mn + 255) / 256 : 2048));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, reduce_slices_kernel, (const float*)ws,
                                          (const float*)scale, (float*)out, m, n, S);
  return err ? err : (int)cudaGetLastError();
}

template <int WG, int ST>
constexpr size_t smem_bytes(int xtile, int lut_size) {
  return (size_t)ST * (xtile + ctile<WG>()) + (size_t)lut_size * 32 * 4;
}

// Shared memory above 48 KB has to be asked for, once per kernel and device;
// ``done`` is the kernel's own flag per device.
template <typename Kernel>
int prepare(Kernel kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || (dev < 64 && done[dev])) return err;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes);
  if (!err && dev < 64) done[dev] = true;
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int slices(int k, int lut_size, int slice_len) {
  if (lut_size > MAX_LUT || (lut_size & (lut_size - 1)) || slice_len <= 0 || slice_len % BK)
    return -1;
  return k > 0 ? (k + slice_len - 1) / slice_len : 1;
}

template <int NT, int WG, int ST>
int launch_bf16(const void* x, const void* codes, const void* scale, const void* lut,
                void* out, void* ws, void* counters, int m, int k, int n, int lut_size, int S,
                int slice_len, cudaStream_t st) {
  static bool done[64];
  auto kernel = pofx_matmul_bf16_kernel<NT, WG, ST>;
  if (int err = prepare(kernel, smem_bytes<WG, ST>(NT * BK * 2, MAX_LUT), done)) return err;
  dim3 grid((n + BN * WG - 1) / (BN * WG), S, (m + NT - 1) / NT);
  kernel<<<grid, WG_THREADS * WG, smem_bytes<WG, ST>(NT * BK * 2, lut_size), st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale, (const float*)lut,
      (float*)out, (float*)ws, (unsigned*)counters, m, k, n, lut_size, slice_len,
      n % 16 == 0 && aligned16(codes), k % 8 == 0 && aligned16(x));
  const int err = (int)cudaGetLastError();
  if (err || NT <= 16 || S == 1) return err;
  return launch_reduce(ws, scale, out, m, n, S, st);
}

}  // namespace

// slice_len (a multiple of BK), the workspace ws of S * m * n floats (S =
// ceil(k / slice_len)) and counters, one zeroed unsigned per output tile (the
// kernel leaves them zeroed), come from the wrapper; neither is touched when
// S = 1. Calls that share counters must run one after another (one stream).
extern "C" int pofx_matmul_f32(const void* x, const void* codes, const void* scale,
                               const void* lut, void* out, void* ws, void* counters, int m,
                               int k, int n, int lut_size, int slice_len, void* stream) {
  const int S = slices(k, lut_size, slice_len);
  if (S < 0) return (int)cudaErrorInvalidValue;
  static bool done[64];
  if (int err = prepare(pofx_matmul_f32_kernel, smem_bytes<1, STAGES>(MT32 * BK * 4, MAX_LUT),
                        done))
    return err;
  dim3 grid((n + BN - 1) / BN, S, (m + MT32 - 1) / MT32);
  pofx_matmul_f32_kernel<<<grid, WG_THREADS, smem_bytes<1, STAGES>(MT32 * BK * 4, lut_size),
                           (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)codes, (const float*)scale, (const float*)lut,
      (float*)out, (float*)ws, (unsigned*)counters, m, k, n, lut_size, slice_len,
      n % 16 == 0 && aligned16(codes), k % 4 == 0 && aligned16(x));
  return (int)cudaGetLastError();
}

// The bf16 block by m (the wrapper's ``bf16_tile`` mirrors it): x rows NT
// (the wgmma's N), warpgroups WG, ring tiles ST. Wider blocks at larger m
// keep the x tile a block re-reads at half its code tile or less; at m > 32
// two blocks of two warpgroups share an SM, so that one block's barrier and
// wgmma drain overlap the other's decode.
extern "C" int pofx_matmul_bf16(const void* x, const void* codes, const void* scale,
                                const void* lut, void* out, void* ws, void* counters, int m,
                                int k, int n, int lut_size, int slice_len, void* stream) {
  const int S = slices(k, lut_size, slice_len);
  if (S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 8)
    return launch_bf16<8, 1, 4>(x, codes, scale, lut, out, ws, counters, m, k, n, lut_size, S,
                                slice_len, st);
  if (m <= 16)
    return launch_bf16<16, 1, 4>(x, codes, scale, lut, out, ws, counters, m, k, n, lut_size, S,
                                 slice_len, st);
  if (m <= 32)
    return launch_bf16<32, 2, 4>(x, codes, scale, lut, out, ws, counters, m, k, n, lut_size, S,
                                 slice_len, st);
  return launch_bf16<64, 2, 3>(x, codes, scale, lut, out, ws, counters, m, k, n, lut_size, S,
                               slice_len, st);
}
