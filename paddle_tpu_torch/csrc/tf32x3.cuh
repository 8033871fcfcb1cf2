// Shared pieces of the port's 3xTF32 flash-attention kernels (sm_90a):
// flash_attention_fwd_tf32.cu (O and lse) and flash_attention_bwd_tf32.cu
// (dK/dV and dQ), f32 attention on the tensor cores through
// mma.sync.m16n8k8.tf32 with every product split in three.
//
// Conventions every user keeps (the design notes of flash_attention_bwd_tf32.cu
// say why):
//   - one block of THREADS threads per ROWS-row tile of one (batch, head) that
//     stays resident, four warps of 16 of those rows each (the mma's M); the
//     other side streams in BN-row tiles through an NST-stage ring;
//   - every tile is written by TMA with the 128-byte swizzle, as DP/32
//     sub-tiles of (its rows) x 32 f32 on a 1024-byte boundary
//     (sm90_common.cuh), so the fragment reads below hit 32 distinct banks;
//   - an operand is split where it is loaded (`split`), and a·b is
//     small·big + big·small + big·big (`mma3`), summed in f32;
//   - an m16n8 accumulator feeds the next product as its A operand unchanged
//     (`acc_a`), with the reduction index permuted on the B side
//     (`load_b_mn`).
#pragma once

#include "sm90_common.cuh"

namespace tf32x3 {

using sm90::Strides;
using sm90::TileMap;

constexpr int ROWS = 64;      // rows of a resident tile
constexpr int BN = 32;        // rows of a streamed tile
constexpr int NST = 2;        // stages of the ring
constexpr int THREADS = 128;  // four warps of 16 resident rows each
constexpr float NEG_INF = -1e30f;

// x = big + small for the tensor cores, which read an f32 register as TF32
// by dropping its 13 low mantissa bits: big is x itself (read as x truncated
// to TF32), small is the exact remainder x − trunc(x) (read truncated too).
// Two instructions. Rounding both halves with cvt.rna.tf32.f32 instead
// (several SASS instructions on sm_90) made the kernels much slower on the
// H100 and their errors no smaller in a way that mattered.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// A 16x8 A fragment or an 8x8 B fragment, split: big and small halves
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32: the two small terms first, then big·big
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// Per-thread float offsets into a swizzled tile. With the 128-byte swizzle,
// 16-byte chunk j of row r of a sub-tile lies at chunk j ^ (r % 8).
//   kmaj[j]: the thread's element of a K-major fragment read, (row g, column
//     4j + t) of an 8-row, 32-column block: A's a0/a2 and B's b0/b1.
//   mn0[c], mn1[c]: an MN-major B read, (row 2t, column 8c + g) and
//     (row 2t + 1, column 8c + g) of such a block.
struct Offsets {
  int kmaj[8], mn0[4], mn1[4];
  __device__ __forceinline__ Offsets(int g, int t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) kmaj[j] = g * 32 + ((j ^ g) << 2) + t;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int chunk = 2 * c + (g >> 2);
      mn0[c] = (2 * t) * 32 + ((chunk ^ (2 * t)) << 2) + (g & 3);
      mn1[c] = (2 * t + 1) * 32 + ((chunk ^ (2 * t + 1)) << 2) + (g & 3);
    }
  }
};

// Float offset of the 8-row block at row r8 (a multiple of 8), columns
// [8kk, 8kk + 8), of a tile of R rows: its sub-tile, then its rows.
template <int R>
__device__ __forceinline__ int block_off(int r8, int kk) {
  return (kk / 4) * (R * 32) + r8 * 32;
}

// The A fragment of rows [m0, m0 + 16) x columns [8kk, 8kk + 8) of a
// K-major (row-major) tile of R rows.
template <int R>
__device__ __forceinline__ Frag<4> load_a(const float* tile, int m0, int kk, const Offsets& o) {
  const float* p = tile + block_off<R>(m0, kk);
  Frag<4> a;
  split(p[o.kmaj[(2 * kk) & 7]], a.big[0], a.small[0]);
  split(p[8 * 32 + o.kmaj[(2 * kk) & 7]], a.big[1], a.small[1]);
  split(p[o.kmaj[(2 * kk + 1) & 7]], a.big[2], a.small[2]);
  split(p[8 * 32 + o.kmaj[(2 * kk + 1) & 7]], a.big[3], a.small[3]);
  return a;
}

// The A fragment of k-step j from accumulator block c (16 rows x 8 columns,
// the columns being the reduction index): the thread's columns 2t and 2t+1
// stand for k = t and t + 4, so B must be read with load_b_mn.
__device__ __forceinline__ Frag<4> acc_a(const float (&c)[4]) {
  Frag<4> a;
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
  return a;
}

// B[k][n] = tile[8j + n][8kk + k]: a K-major B fragment (n-block j, k-step
// kk) of a tile of R rows.
template <int R>
__device__ __forceinline__ Frag<2> load_b_k(const float* tile, int j, int kk, const Offsets& o) {
  const float* p = tile + block_off<R>(8 * j, kk);
  Frag<2> b;
  split(p[o.kmaj[(2 * kk) & 7]], b.big[0], b.small[0]);
  split(p[o.kmaj[(2 * kk + 1) & 7]], b.big[1], b.small[1]);
  return b;
}

// B[k][n] = tile[8j + k][8jn + n] with k = t read from row 2t and k = t + 4
// from row 2t + 1: the MN-major B fragment (k-step j, n-block jn) of a tile of
// R rows, matching an A fragment from acc_a.
template <int R>
__device__ __forceinline__ Frag<2> load_b_mn(const float* tile, int j, int jn, const Offsets& o) {
  const float* p = tile + block_off<R>(8 * j, jn);
  Frag<2> b;
  split(p[o.mn0[jn & 3]], b.big[0], b.small[0]);
  split(p[o.mn1[jn & 3]], b.big[1], b.small[1]);
  return b;
}

// acc[j] = A·Bᵀ for the 16 rows at m0 of resident `a_tile` against the BN
// rows of streamed `b_tile`, over DP columns: acc[j] is n-block j (rows 8j ...
// 8j + 7 of b_tile).
template <int DP>
__device__ __forceinline__ void rows_by_rows(float (&acc)[BN / 8][4], const float* a_tile,
                                             int m0, const float* b_tile, const Offsets& o) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const Frag<4> a = load_a<ROWS>(a_tile, m0, kk, o);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) mma3(acc[j], a, load_b_k<BN>(b_tile, j, kk, o));
  }
}

// out[jn] += X·tile for X the 16 x BN accumulator x (columns = the BN rows of
// streamed `tile`), over the DP columns of tile: out[jn] is n-block jn.
template <int DP>
__device__ __forceinline__ void acc_by_tile(float (&out)[DP / 8][4], const float (&x)[BN / 8][4],
                                            const float* tile, const Offsets& o) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const Frag<4> a = acc_a(x[j]);
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn) mma3(out[jn], a, load_b_mn<BN>(tile, j, jn, o));
  }
}

// Writes a 16 x DP accumulator, rows [row0, row0 + 16) of (b, h), columns < D.
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const Strides& os, int b,
                                           int h, int row0, int S, int D, int g, int t,
                                           const float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= S) continue;
    float* row = out + b * os.b + r * os.s + h * os.h;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn) {
      const int col = 8 * jn + 2 * t;
      if (col < D) {  // D is a multiple of 8: col + 1 < D too
        row[col * os.d] = acc[jn][2 * half];
        row[(col + 1) * os.d] = acc[jn][2 * half + 1];
      }
    }
  }
}

// Loads two tiles of R rows at row s0 (D/32 sub-tiles each, the second
// right after the first) into dst, completing on bar. One thread calls it.
template <int DP, int R>
__device__ __forceinline__ void load_pair(const TileMap* ta, const TileMap* tb, uint64_t* bar,
                                          float* dst, int b, int s0, int h) {
  sm90::mbar_expect_tx(bar, 2 * R * DP * 4);
  for (int s = 0; s < DP / 32; ++s) {
    sm90::tma_load_tile(ta, bar, dst + s * R * 32, 32 * s, b, s0, h);
    sm90::tma_load_tile(tb, bar, dst + R * DP + s * R * 32, 32 * s, b, s0, h);
  }
}

// The shared-memory attribute is set at an instantiation's first launch only,
// so a launch inside CUDA-graph capture makes no call but the launch itself.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem, bool* configured) {
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

// TMA maps of the N tensors at ptrs (q, k, v and, in the backward, dO), for
// tiles of rows[i] rows; 0 or the error of the first refused one.
template <int N>
int make_maps(TileMap (&maps)[N], const void* const (&ptrs)[N], const Strides (&st)[N],
              const int (&rows)[N], int B, int S, int H, int D) {
  for (int i = 0; i < N; ++i) {
    const int err = sm90::make_tile_map_f32(&maps[i], ptrs[i], B, S, H, D, st[i], rows[i]);
    if (err) return err;
  }
  return 0;
}

// Whether the kernels take these inputs: f32, D a multiple of 8 in [8, 128],
// head-dim strides 1.
template <int N>
bool accepted(int dtype, int D, const Strides (&st)[N]) {
  if (dtype != 0 || D % 8 != 0 || D < 8 || D > 128) return false;
  for (const Strides& s : st)
    if (s.d != 1) return false;
  return true;
}

}  // namespace tf32x3
