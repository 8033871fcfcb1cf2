// f32 flash-attention forward, 3xTF32 on Hopper's tensor cores (sm_90a), CUDA C++ with a C entry.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel for f32
// inputs whose strides TMA can read (the route `tf32x3_eligible` picks in
// ops/kernels/flash_attention.py; flash_attention_fwd.cu's SIMT kernel takes
// the other f32 inputs). It computes what that kernel computes:
// O = softmax(Q·Kᵀ·scale [causal])·V and the row logsumexp, with the running
// max m, the denominator l and the accumulator in f32; key tiles wholly above
// the diagonal skipped and the diagonal masked to -1e30; l == 0 guarded; O
// written in f32 through its strides and lse as [B, H, S] f32. There are no
// atomics and the key tiles are summed in a fixed order, so a second forward
// on the same input is bitwise equal.
//
// What bounds it on this card: 4·D FLOP per attended (query, key) pair
// against 16·D bytes of Q, K, V and O per row, far above the ridge point, so
// it is bound by arithmetic. One TF32 product per product misses the f32
// forward tolerance (2e-5) by about 100x, so every product is split in three
// TF32 products (3xTF32, see tf32x3.cuh and flash_attention_bwd_tf32.cu):
// 3·8.6 GFLOP at the GPT-2 345M forward shape (4, 1024, 16, 64) causal,
// 0.052 ms at the TF32 peak; 0.128 ms at the CUDA cores' f32 peak, which no
// SIMT kernel can beat. The splits, the shared-memory loads and the softmax
// run beside the MMAs, so instruction slots bound it too.
//
// This design is the backward's dQ kernel with the online softmax in place of
// dS: one block per 64-row query tile of one (batch, head), four warps of 16
// query rows each.
//   - Q is loaded once by TMA and stays; K and V stream in 32-row tiles
//     through a two-stage ring on mbarriers, which warp 0 refills once every
//     warp has released a stage. Causal key tiles past the block's last row
//     are never loaded; a warp skips the tiles wholly above its rows.
//   - Q's fragments are read and split per key tile, as dQ reads its resident
//     tiles. Splitting them once into registers (2·D per thread) took ptxas to
//     its 168-register cap at D = 64 with three blocks per SM and spilled; on
//     the H100 that was no faster than this kernel at 126 registers and four
//     blocks per SM (16 warps), which shared memory (50 KB a block) allows.
//   - per key tile, in a warp's registers: S = Q·Kᵀ (mma3), scaled; keys at or
//     past S masked (TMA reads them as zeros, which are not -1e30) and on the
//     diagonal the causal region; the row max over the four threads of a
//     quad (two shuffles); alpha = exp(m_prev − m_new), p = exp(s − m_new);
//     acc rescaled by alpha; O += P·V with P fed from the S accumulator as
//     the A operand and V read MN-major with the k-permuted B reads. Each
//     thread keeps its own part of l, reduced over the quad once at the end.
//   - scores are kept in log2 units (scale·log2 e folded into the one scale
//     multiply), so each exp is one ex2.approx (MUFU.EX2) after one subtract,
//     as in the sm90 kernels, where expf is about seven instructions; its
//     relative error (~2^-22) is far under the 2e-5 tolerance. O = acc / l
//     and lse = m·ln 2 + log(l), rows past S not written.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of a block: the resident Q tile of ROWS rows, NST stages of
// K and V tiles of BN rows, barriers: 50 KB at D = 64, so four blocks share
// an SM (ptxas then caps the kernel at 128 registers); 99 KB at D = 128, two.
template <int DP>
struct FwdSmem {
  static constexpr int Q_FLOATS = ROWS * DP;
  static constexpr int STREAM_FLOATS = BN * DP;
  static constexpr int RING_OFF = Q_FLOATS * 4;  // stage st at + 2·st·STREAM_FLOATS·4: K, then V
  static constexpr int BAR_OFF = RING_OFF + NST * 2 * STREAM_FLOATS * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NST) + 1024;  // + alignment slack
  static constexpr int BLOCKS = DP <= 64 ? 4 : 2;  // per SM
};

template <int DP>
__global__ void __launch_bounds__(THREADS, FwdSmem<DP>::BLOCKS)
fwd_tf32_kernel(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                const __grid_constant__ TileMap tv, float* __restrict__ o,
                float* __restrict__ lse, int H, int S, int D, Strides os, float scale,
                int causal, int n_qt) {
  using L = FwdSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + L::RING_OFF);  // stage st: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_q = bars;
  uint64_t* bar_full = bars + 1;
  uint64_t* bar_empty = bars + 1 + NST;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * ROWS;  // heaviest causal tiles first
  const int b = bh / H;
  const int h = bh % H;
  int n_kt = (S + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + ROWS, S) + BN - 1) / BN);

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int st = 0; st < NST; ++st) {
      sm90::mbar_init(bar_full + st, 1);
      sm90::mbar_init(bar_empty + st, THREADS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {  // Q, then the first stages of K and V
    sm90::mbar_expect_tx(bar_q, L::Q_FLOATS * 4);
    for (int s = 0; s < DP / 32; ++s)
      sm90::tma_load_tile(&tq, bar_q, sQ + s * ROWS * 32, 32 * s, b, q0, h);
    for (int it = 0; it < NST && it < n_kt; ++it)
      load_pair<DP, BN>(&tk, &tv, bar_full + it, ring + it * 2 * L::STREAM_FLOATS, b, it * BN,
                        h);
  }

  // warp w owns queries q0 + 16w ... + 15
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * warp;
  const Offsets off(g, t);
  const int row[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  const float scale_log2 = scale * LOG2E;  // exp(s·scale − m) = 2^(s·scale·log2 e − m·log2 e)

  float o_acc[DP / 8][4];
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[jn][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // in log2 units
  float l[2] = {0.f, 0.f};  // this thread's columns only until the end

  sm90::mbar_wait(bar_q, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % NST;
    const int k0 = it * BN;
    const float* sK = ring + st * 2 * L::STREAM_FLOATS;
    const float* sV = sK + L::STREAM_FLOATS;
    sm90::mbar_wait(bar_full + st, (it / NST) & 1);
    if (!causal || k0 <= q0 + m0 + 15) {  // a tile wholly above this warp's rows adds nothing
      // S = Q·Kᵀ; element e of block j is row row[e >> 1], key k0 + 8j + 2t + (e & 1)
      float s[BN / 8][4];
      rows_by_rows<DP>(s, sQ, m0, sK, off);
      const bool masked = (causal && k0 + BN - 1 > q0 + m0) || k0 + BN > S;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (masked) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            if (kj >= S || (causal && kj > row[e >> 1])) x = NEG_INF;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row lives in the four threads of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = sm90::ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = sm90::ex2(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[jn][e] *= alpha[e >> 1];
      acc_by_tile<DP>(o_acc, s, sV, off);  // O += P·V
    }
    sm90::mbar_arrive(bar_empty + st);
    if (tid == 0 && it + NST < n_kt) {  // refill the stage once every warp is done with it
      sm90::mbar_wait(bar_empty + st, (it / NST) & 1);
      load_pair<DP, BN>(&tk, &tv, bar_full + st, ring + st * 2 * L::STREAM_FLOATS, b,
                        (it + NST) * BN, h);
    }
  }

  // O = acc / l and lse = m·ln 2 + log(l), l summed over the quad and l == 0 guarded
  float safe_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    safe_l[r] = l[r] == 0.f ? 1.f : l[r];
  }
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[jn][e] /= safe_l[e >> 1];
  store_rows<DP>(o, os, b, h, q0 + m0, S, D, g, t, o_acc);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < S) lse[(long long)bh * S + row[r]] = fmaf(m[r], LN2, logf(safe_l[r]));
  }
}

template <int DP>
cudaError_t launch_fwd(const TileMap (&maps)[3], float* o, float* lse, int B, int H, int S,
                       int D, Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = FwdSmem<DP>::BYTES;
  static bool configured = false;
  cudaError_t err = configure(fwd_tf32_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (S + ROWS - 1) / ROWS;
  fwd_tf32_kernel<DP><<<(unsigned)(n_qt * B * H), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], o, lse, H, S, D, os, scale, causal, n_qt);
  return cudaGetLastError();
}

}  // namespace

// The signature of paddle_flash_attention_fwd (flash_attention_fwd.cu).
// dtype: 0 float32, the only one taken. D a multiple of 8 in [8, 128];
// strides in elements, in the order batch, seq, head, head-dim, for q, k, v
// and o: the input head-dim strides 1, the others multiples of 4, base
// pointers 16-byte aligned (TMA's rules, checked by the caller); o is f32,
// written through its strides. lse is [B, H, S] float32, contiguous. Returns
// 0, a cudaError_t, or sm90::ENCODE_ERROR_BASE + the CUresult of a refused
// tensor map. Does not synchronise.
extern "C" int paddle_flash_attention_fwd_tf32(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B,
    int H, int S, int D, long long qsb, long long qss, long long qsh, long long qsd,
    long long ksb, long long kss, long long ksh, long long ksd, long long vsb,
    long long vss, long long vsh, long long vsd, long long osb, long long oss,
    long long osh, long long osd, float scale, int causal, void* stream) {
  const Strides st[3] = {{qsb, qss, qsh, qsd}, {ksb, kss, ksh, ksd}, {vsb, vss, vsh, vsd}};
  const Strides os{osb, oss, osh, osd};
  if (!accepted(dtype, D, st)) return (int)cudaErrorInvalidValue;
  TileMap maps[3];
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {ROWS, BN, BN};  // Q stays, K and V stream
  const int err = make_maps(maps, ptrs, st, rows, B, S, H, D);
  if (err) return err;
  float* o_f = static_cast<float*>(o);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return (int)launch_fwd<32>(maps, o_f, lse_f, B, H, S, D, os, scale, causal, s);
  if (D <= 64) return (int)launch_fwd<64>(maps, o_f, lse_f, B, H, S, D, os, scale, causal, s);
  return (int)launch_fwd<128>(maps, o_f, lse_f, B, H, S, D, os, scale, causal, s);
}
