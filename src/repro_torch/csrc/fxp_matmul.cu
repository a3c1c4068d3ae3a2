// FxP MAC: int8 (m, k) x int8 (k, n) -> int32 (m, n), exact, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fxp_matmul.py::fxp_matmul
// (pallas_call at :51, body _kernel :21): the paper's fixed-point baseline
// MAC with a 32-bit accumulator.
//
// What bounds it. On the serving path (the fxp rules of mixed policies) m is
// the slots at decode (4) and the prompt bucket at prefill (64); at either the
// k*n bytes of b bound it (int8 tensor cores need ~590 operations a byte before
// they are the limit). So the design streams b at the memory rate from every
// SM and keeps the arithmetic out of the way:
//
// - Split k. A block owns 128 columns of n per warpgroup, a tile of m and one
//   slice of k; the wrapper's plan (kernels/fxp_matmul.py::plan) picks the
//   slices so that the blocks come near two a SM at decode. Each slice leaves
//   its int32 partial tile in a workspace the wrapper keeps (through shared
//   memory, in 16-byte pieces), and the last block of a tile to arrive (a
//   counter per tile, set back to 0 by that block) adds the slices and writes
//   out. Integer sums are exact in any order, so the result equals the plain
//   version bit for bit at every split, and two launches give the same bits.
//   No float, no memset launch.
// - Stream b. 16-byte cp.async copies, neighbours on neighbouring bytes, into
//   a ring of BK-row tiles, three in flight while one is consumed. Rows that
//   are not 16-byte aligned (n % 16 != 0 or a misaligned base) take a byte
//   path inside the kernel; rows past the slice and columns past n are
//   zero-filled in shared memory. Nothing is padded in device memory.
// - s8 tensor cores through wgmma, the swapped product out^T = b^T a^T:
//   wgmma.m64nNk32.s32.s8.s8 with N = m rounded up to 8, 16, 32 or 64 (a grid
//   axis over 64-row tiles of m above). a (m, k) row-major is already K-major,
//   so it is the B operand in shared memory (no swizzle), padded with zero
//   rows there only. For 8-bit types wgmma takes both operands K-major only,
//   and b (k, n) has n contiguous, so b^T is fed from registers: the s8 A
//   fragment of m64k32 holds, per thread, fragment rows g and g + 8, each as
//   words of 4 consecutive k. A thread reads 4 neighbouring columns of n from
//   4 consecutive k rows with four 32-bit shared loads and transposes the 4x4
//   bytes with 8 PRMT; the four words are its fragment rows of the two
//   wgmmas of its 128 columns (columns ccol + 2q + {0, 1} are rows g and
//   g + 8 of wgmma q), and the output store undoes that map. The b tile is
//   stored with its 16-byte chunks XOR-swizzled by k row, so the four k rows
//   a warp reads at once fall in four different groups of 8 banks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;           // columns of n per warpgroup
constexpr int BK = 64;            // rows of k per ring tile: two k32 steps
constexpr int ST = 4;             // tiles in the ring
constexpr int WG_THREADS = 128;   // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copies; src_bytes = 0 zero-fills the destination. b is read
// once and bypasses L1 (.cg); a is read by every column block of a slice, so
// it goes through L1 (.ca), where the SM's other blocks find it.
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

// Byte offset of b[row][col] in a tile of W columns: 16-byte chunk c of k row
// r sits at chunk c ^ (2 * ((r / 4) % 4)). The 32-bit loads of one warp read
// k rows 4t + j (t = 0..3) at 32 bytes of columns: with the swizzle, lane
// (g, t) of warp w hits bank 8 (w ^ t) + g, 32 distinct banks.
template <int W>
__device__ __forceinline__ int b_off(int row, int col) {
  return row * W + ((((col >> 4) ^ ((row >> 1) & 6))) << 4) + (col & 15);
}

// Stage rows [kt, kt + BK) of the block's W columns of b; rows past kend and
// columns past n read as 0.
template <int W, int T>
__device__ __forceinline__ void load_b(uint8_t* dst, const int8_t* __restrict__ b, int kt,
                                       int kend, int n0, int n, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {                      // n % 16 == 0 and a 16-byte aligned base
#pragma unroll
    for (int i = 0; i < BK * W / 16 / T; ++i) {
      const int q = tid + i * T, row = q / (W / 16), c = (q % (W / 16)) * 16;
      const int kr = kt + row, col = n0 + c;
      const bool in = kr < kend && col < n;
      cp_async16(dst + b_off<W>(row, c), in ? b + (size_t)kr * n + col : b, in ? 16 : 0);
    }
  } else {
    for (int q = tid; q < BK * W; q += T) {
      const int row = q / W, c = q % W, kr = kt + row, col = n0 + c;
      dst[b_off<W>(row, c)] = (kr < kend && col < n) ? (uint8_t)b[(size_t)kr * n + col] : 0;
    }
  }
}

// a rows [m0, m0 + NT) by k [kt, kt + BK) as wgmma's B operand, K-major
// without swizzle: for k32 step j, row r and k half h the 16 bytes of
// a[r, 32 j + 16 h .. + 16] sit at j * (NT * 32) + (r / 8) * 256 + h * 128 +
// (r % 8) * 16, i.e. 8x16-byte core matrices, 128 bytes apart along k
// (leading byte offset) and 256 bytes apart along the rows (stride byte
// offset). Rows past m and k past kend read as 0.
template <int NT>
__device__ __forceinline__ void load_a(uint8_t* dst, const int8_t* __restrict__ a, int m0,
                                       int m, int k, int kt, int kend, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {                      // k % 16 == 0 and a 16-byte aligned base
    for (int q = tid; q < NT * (BK / 16); q += blockDim.x) {
      const int r = q % NT, c16 = q / NT, j = c16 / 2, h = c16 % 2;
      const int row = m0 + r, kc = kt + c16 * 16;
      const bool in = row < m && kc < kend;
      cp_async16_l1(dst + j * (NT * 32) + (r / 8) * 256 + h * 128 + (r % 8) * 16,
                    in ? a + (size_t)row * k + kc : a, in ? 16 : 0);
    }
  } else {
    for (int q = tid; q < NT * BK; q += blockDim.x) {
      const int r = q / BK, kk = q % BK, j = kk / 32, h = (kk / 16) % 2;
      const int row = m0 + r, kc = kt + kk;
      dst[j * (NT * 32) + (r / 8) * 256 + h * 128 + (r % 8) * 16 + kk % 16] =
          (row < m && kc < kend) ? (uint8_t)a[(size_t)row * k + kc] : 0;
    }
  }
}

__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// wgmma.m64nNk32.s32.s8.s8, A from registers, B by descriptor, D += A B
template <int NT> struct Wgmma;

template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
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
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// w[j] holds bytes (c0, c1, c2, c3) of k row j; o[c] gets (k0, k1, k2, k3)
// of column c: the 4x4 byte transpose, 8 PRMT.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void add4(int4& v, const int4& p) {
  v.x += p.x;
  v.y += p.y;
  v.z += p.z;
  v.w += p.w;
}

// The epilogue of a split. The block's partial tile (``red``, ROWS x W int32
// in shared memory, one word after it free) goes to the workspace
// ws[slice][row][col] in whole 16-byte pieces; the last of the tile's S
// blocks to arrive adds the S partials and writes out.
template <int ROWS, int W>
__device__ __forceinline__ void split_epilogue(int* red, int* __restrict__ out,
                                               int* __restrict__ ws,
                                               unsigned* __restrict__ counters, int m0, int m,
                                               int n0, int n) {
  volatile unsigned* last = reinterpret_cast<volatile unsigned*>(red + ROWS * W);
  __syncthreads();
  const int S = gridDim.y;
  const size_t mn = (size_t)m * n;
  for (int i = threadIdx.x; i < ROWS * W / 4; i += blockDim.x) {
    const int row = m0 + i / (W / 4), col = n0 + (i % (W / 4)) * 4;
    if (row >= m || col >= n) continue;
    const int4 v = reinterpret_cast<const int4*>(red)[i];
    int* dst = ws + blockIdx.y * mn + (size_t)row * n + col;
    if (n % 4 == 0) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      const int vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && col + e < n; ++e) dst[e] = vs[e];
    }
  }
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
    const int* src = ws + (size_t)row * n + col;
    if (n % 4 == 0) {
      // eight slices' loads in flight at a time
      auto part = [&](int s) { return __ldcg(reinterpret_cast<const int4*>(src + s * mn)); };
      int4 v = part(0);
      int s = 1;
      for (; s + 8 <= S; s += 8) {
        int4 p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) p[u] = part(s + u);
#pragma unroll
        for (int u = 0; u < 8; ++u) add4(v, p[u]);
      }
      for (; s < S; ++s) add4(v, part(s));
      *reinterpret_cast<int4*>(out + (size_t)row * n + col) = v;
    } else {
      for (int e = 0; e < 4 && col + e < n; ++e) {
        int v = __ldcg(src + e);
        for (int s = 1; s < S; ++s) v += __ldcg(src + s * mn + e);
        out[(size_t)row * n + col + e] = v;
      }
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <int NT, int WG>
__global__ void __launch_bounds__(WG_THREADS * WG)
fxp_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int* __restrict__ out, int* __restrict__ ws, unsigned* __restrict__ counters,
                  int m, int k, int n, int slice_len, bool vec_b, bool vec_a) {
  constexpr int W = BN * WG, T = WG_THREADS * WG, ATILE = NT * BK, BTILE = BK * W;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* as = smem;                 // ST x ATILE
  uint8_t* bs = smem + ST * ATILE;    // ST x BTILE

  const int tid = threadIdx.x, lane = tid % 32, w = (tid / 32) % 4, wg = tid / WG_THREADS;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * W, slice = blockIdx.y, m0 = blockIdx.z * NT;
  const int kbeg = slice * slice_len, kend = min(k, kbeg + slice_len);
  const int nsteps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nsteps) {
      load_b<W, T>(bs + s * BTILE, b, kbeg + s * BK, kend, n0, n, vec_b);
      load_a<NT>(as + s * ATILE, a, m0, m, k, kbeg + s * BK, kend, vec_a);
    }
    cp_async_commit();
  }

  int acc[2][NT / 2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[q][i] = 0;

  // a thread's 4 neighbouring columns of n
  const int ccol = wg * BN + (w * 8 + g) * 4;
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<ST - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    {
      const int s = it + ST - 1;
      if (s < nsteps) {
        load_b<W, T>(bs + (s % ST) * BTILE, b, kbeg + s * BK, kend, n0, n, vec_b);
        load_a<NT>(as + (s % ST) * ATILE, a, m0, m, k, kbeg + s * BK, kend, vec_a);
      }
      cp_async_commit();
    }
    const uint8_t* bt = bs + (it % ST) * BTILE;
    const uint8_t* at = as + (it % ST) * ATILE;
    uint32_t frag[BK / 32][2][4];
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      // k rows 32 j + 16 h + 4 t + r: the A fragment's k columns 4 t .. 4 t + 3
      // (registers 0, 1) and 16 + 4 t .. (registers 2, 3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t rw[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kr = 32 * j + 16 * h + 4 * t + r;
          rw[r] = *reinterpret_cast<const uint32_t*>(bt + b_off<W>(kr, ccol));
        }
        transpose4(rw, frag[j][h]);
      }
      // wgmma q: fragment row g is column ccol + 2 q, row g + 8 column ccol + 2 q + 1
      uint32_t fa[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        fa[q][0] = frag[j][0][2 * q];
        fa[q][1] = frag[j][0][2 * q + 1];
        fa[q][2] = frag[j][1][2 * q];
        fa[q][3] = frag[j][1][2 * q + 1];
      }
      wgmma_fence();
      const uint64_t desc = b_desc(at + j * (NT * 32));
#pragma unroll
      for (int q = 0; q < 2; ++q) Wgmma<NT>::mma(acc[q], fa[q], desc);
      wgmma_commit();
    }
    wgmma_wait_all();
  }
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // acc[q][4 i + e]: column n0 + ccol + 2 q + (e >> 1), a row m0 + 8 i + 2 t + (e & 1)
  if (gridDim.y == 1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int col = n0 + ccol + 2 * q + e2;
        if (col >= n) continue;
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int row = m0 + 8 * i + 2 * t + e1;
            if (row < m) out[(size_t)row * n + col] = acc[q][4 * i + 2 * e2 + e1];
          }
        }
      }
    }
    return;
  }
  // a split: the partial tile through the (drained) ring to the workspace
  static_assert(NT * W * 4 + 4 <= ST * (ATILE + BTILE), "partial tile fits the ring");
  cp_async_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * i + 2 * t + (e & 1)) * W + ccol + 2 * q + (e >> 1)] = acc[q][4 * i + e];
  split_epilogue<NT, W>(red, out, ws, counters, m0, m, n0, n);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int NT, int WG>
int launch(const void* a, const void* b, void* out, void* ws, void* counters, int m, int k,
           int n, int S, int slice_len, cudaStream_t st) {
  // shared memory above 48 KB has to be asked for, once per device
  static bool done[64];
  constexpr size_t bytes = (size_t)ST * (NT * BK + BK * BN * WG);
  auto kernel = fxp_matmul_kernel<NT, WG>;
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (dev >= 64 || !done[dev]) {
    if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)bytes))
      return err;
    if (dev < 64) done[dev] = true;
  }
  dim3 grid((n + BN * WG - 1) / (BN * WG), S, (m + NT - 1) / NT);
  kernel<<<grid, WG_THREADS * WG, bytes, st>>>(
      (const int8_t*)a, (const int8_t*)b, (int*)out, (int*)ws, (unsigned*)counters, m, k, n,
      slice_len, n % 16 == 0 && aligned16(b), k % 16 == 0 && aligned16(a));
  return (int)cudaGetLastError();
}

}  // namespace

// slice_len (a multiple of BK), the workspace ws of S * m * n int32 (S =
// ceil(k / slice_len)) and counters, one zeroed unsigned per output tile (the
// kernel leaves them zeroed), come from the wrapper; neither is touched when
// S = 1. Calls that share counters must run one after another (one stream).
// The block by m (the wrapper's ``tile`` mirrors it): a rows NT (the wgmma's
// N) and warpgroups WG; above 64 rows, a grid axis over 64-row tiles.
extern "C" int fxp_matmul(const void* a, const void* b, void* out, void* ws, void* counters,
                          int m, int k, int n, int slice_len, void* stream) {
  if (m < 1 || n < 1 || k < 0 || slice_len <= 0 || slice_len % BK)
    return (int)cudaErrorInvalidValue;
  const int S = k > 0 ? (k + slice_len - 1) / slice_len : 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 8) return launch<8, 1>(a, b, out, ws, counters, m, k, n, S, slice_len, st);
  if (m <= 16) return launch<16, 1>(a, b, out, ws, counters, m, k, n, S, slice_len, st);
  if (m <= 32) return launch<32, 2>(a, b, out, ws, counters, m, k, n, S, slice_len, st);
  return launch<64, 2>(a, b, out, ws, counters, m, k, n, S, slice_len, st);
}
