// Flash-attention forward on Hopper's tensor cores (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel for bf16 and
// fp16 inputs whose strides TMA can read (the route `sm90_eligible` picks in
// ops/kernels/flash_attention.py; flash_attention_fwd.cu takes the rest). It
// computes what that kernel computes: S = Q·Kᵀ in f32, scaled; the diagonal
// masked to -1e30 and key tiles wholly above it skipped; the running max m,
// the denominator l and the accumulator in f32; p rounded to the input type
// before P·V; l == 0 guarded; O in the input type and the row logsumexp in f32.
//
// What bounds it on this card: at the GPT-2 345M shape (S = 1024, D = 64) the
// function does 4·D FLOP per attended (query, key) pair against 8·D bytes of
// Q, K, V and O per row, far above the H100's ridge point, so it is bound by
// the tensor cores (989 TFLOP/s in bf16), and in practice by how much of the
// softmax's CUDA-core work hides behind them.
//
// This design, per block of 288 threads: two consumer warpgroups each own 64
// rows of a 128-row query tile, and one producer warp feeds them by TMA.
//   - Q (128 x D) is loaded once. K and V tiles of BN = 64 keys stream
//     through a two-stage ring of shared memory: the producer waits for a
//     stage to be released (mbarrier `empty`), then issues its K and V loads,
//     each completing on its own mbarrier so S can start before V lands.
//   - S = Q·Kᵀ is an SS wgmma (m64n64k16, D/16 steps) into 32 f32 registers
//     per thread. The online softmax runs in the accumulator's layout: a row
//     lives in one quad of four threads, so its max and sum reduce with two
//     shuffles.
//   - P is rounded to bf16/fp16 in registers, where the accumulator layout is
//     already the A-fragment layout, and O += P·V is an RS wgmma with V as
//     an MN-major B operand straight from the TMA tile.
//   - Within a warpgroup, S, softmax and P·V run in turn; the two warpgroups
//     interleave, so one's softmax runs under the other's wgmmas.
//   - Causal key tiles above the diagonal are never loaded; the heaviest query
//     tiles are launched first. A ragged S reads zeros past the end (TMA) and
//     masks keys >= S; a head dim under 64 (or between 64 and 128) reads as
//     zeros up to 64 (128), so D may be any multiple of 16 up to 128.
//   - O is written from registers with 4-byte stores, lse in f32.
// Measured on the H100 (chip_smoke.py's timing, PERF.md): BN = 64 beat 128
// (finer causal tiles; 92 registers at D = 64 instead of 128, no spills), and
// overlapping the next tile's S and this tile's P·V with the softmax inside
// one warpgroup (FA3's order, 111 registers) was slower than this plain
// order. setmaxnreg and a persistent grid are later work.

#include "sm90_common.cuh"

namespace {

using sm90::Strides;
using sm90::TileMap;

constexpr int BM = 128;       // query rows per block: two warpgroups of 64
constexpr int BN = 64;        // keys per streamed tile
constexpr int NST = 2;        // stages of the K/V ring
constexpr int THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Smem {
  static constexpr int SUB = DP / 64;               // 64-column sub-tiles
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;     // K stage st at K_OFF + st·KV_BYTES
  static constexpr int V_OFF = K_OFF + NST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * NST) + 1024;  // + alignment slack
};

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
fwd_sm90_kernel(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                const __grid_constant__ TileMap tv, T* __restrict__ o, float* __restrict__ lse,
                int H, int S, int D, Strides os, float scale, int causal, int n_qt) {
  using L = Smem<DP>;
  constexpr int SUB = L::SUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem + L::Q_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_q = bars;
  uint64_t* bar_k = bars + 1;
  uint64_t* bar_v = bars + 1 + NST;
  uint64_t* bar_empty = bars + 1 + 2 * NST;

  const int tid = threadIdx.x;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int q_tile = n_qt - 1 - blockIdx.x / BH;  // heaviest causal tiles first
  const int q0 = q_tile * BM;
  const int b = bh / H;
  const int h = bh % H;
  int n_kt = (S + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + BM, S) + BN - 1) / BN);

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int st = 0; st < NST; ++st) {
      sm90::mbar_init(bar_k + st, 1);
      sm90::mbar_init(bar_v + st, 1);
      sm90::mbar_init(bar_empty + st, 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one lane issues every load
    if (tid == 256) {
      sm90::mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int s = 0; s < SUB; ++s)
        sm90::tma_load_tile(&tq, bar_q, sQ + s * BM * 128, 64 * s, b, q0, h);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % NST;
        if (it >= NST) sm90::mbar_wait(bar_empty + st, ((it / NST) - 1) & 1);
        uint8_t* sK = smem + L::K_OFF + st * L::KV_BYTES;
        uint8_t* sV = smem + L::V_OFF + st * L::KV_BYTES;
        sm90::mbar_expect_tx(bar_k + st, L::KV_BYTES);
        for (int s = 0; s < SUB; ++s)
          sm90::tma_load_tile(&tk, bar_k + st, sK + s * BN * 128, 64 * s, b, it * BN, h);
        sm90::mbar_expect_tx(bar_v + st, L::KV_BYTES);
        for (int s = 0; s < SUB; ++s)
          sm90::tma_load_tile(&tv, bar_v + st, sV + s * BN * 128, 64 * s, b, it * BN, h);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64·wg ... + 63
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int wg_row0 = q0 + 64 * wg;
  const int row[2] = {wg_row0 + 16 * warp + (lane >> 2), wg_row0 + 16 * warp + (lane >> 2) + 8};

  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  sm90::mbar_wait(bar_q, 0);
  const uint8_t* sQw = sQ + 64 * wg * 128;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % NST;
    const uint32_t parity = (it / NST) & 1;
    const int k0 = it * BN;
    const uint8_t* sK = smem + L::K_OFF + st * L::KV_BYTES;
    const uint8_t* sV = smem + L::V_OFF + st * L::KV_BYTES;
    // a tile wholly above this warpgroup's rows contributes nothing
    const bool active = !causal || k0 <= wg_row0 + 63;

    sm90::mbar_wait(bar_k + st, parity);
    uint32_t pf[BN / 16][4];
    if (active) {
      float s_acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s_acc[i] = 0.f;
      sm90::fence_operand(s_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const int sub = ks / 4, off = 32 * (ks % 4);
        sm90::wgmma_ss_n64<T, 0>(s_acc, sm90::make_desc(sQw + sub * BM * 128 + off, 0),
                                 sm90::make_desc(sK + sub * BN * 128 + off, 0), ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(s_acc);

      // scale, mask, online softmax; element i is row row[(i >> 1) & 1],
      // key k0 + 8·(i / 4) + 2·quad + (i & 1)
      const bool masked = (causal && k0 + BN - 1 > wg_row0) || k0 + BN > S;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s_acc[i] * scale;
        if (masked) {
          const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
          if (kj >= S || (causal && kj > row[(i >> 1) & 1])) x = NEG_INF;
        }
        s_acc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2], m_scaled[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_scaled[r] = m_new * LOG2E;
        alpha[r] = sm90::ex2(fmaf(m[r], LOG2E, -m_scaled[r]));
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = sm90::ex2(fmaf(s_acc[i], LOG2E, -m_scaled[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += p;
        s_acc[i] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = alpha[r] * l[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
      sm90::acc_to_a<T, BN / 16>(s_acc, pf);
    }

    sm90::mbar_wait(bar_v + st, parity);
    if (active) {
      sm90::fence_operand(o_acc);
      sm90::fence_operand(pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        sm90::wgmma_rs<T, DP, 1>(o_acc, pf[kk], sm90::make_desc(sV + kk * 2048, BN * 128), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(o_acc);
      sm90::fence_operand(pf);
    }
    sm90::mbar_arrive(bar_empty + st);
  }

  // O = acc / l in the input type; lse = m + log(l), l == 0 guarded
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row[r];
    if (qi >= S) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (col < D) {  // the output is contiguous: stride 1 along the head dim
        const uint32_t v = sm90::pack2<T>(o_acc[4 * j + 2 * r] / safe_l,
                                          o_acc[4 * j + 2 * r + 1] / safe_l);
        *reinterpret_cast<uint32_t*>(orow + col) = v;
      }
    }
    if (quad == 0) lse[(long long)bh * S + qi] = m[r] + logf(safe_l);
  }
}

template <typename T, int DP>
cudaError_t launch(const TileMap& tq, const TileMap& tk, const TileMap& tv, void* o, float* lse,
                   int B, int H, int S, int D, Strides os, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Smem<DP>::BYTES;
  // set at the instantiation's first launch only, so a launch inside CUDA-graph
  // capture makes no call but the launch itself
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fwd_sm90_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_qt = (S + BM - 1) / BM;
  dim3 grid((unsigned)(n_qt * B * H));
  fwd_sm90_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, H, S, D, os, scale, causal, n_qt);
  return cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int S, int D, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  TileMap tq, tk, tv;
  int err = sm90::make_tile_map(&tq, q, f16, B, S, H, D, qs, BM);
  if (!err) err = sm90::make_tile_map(&tk, k, f16, B, S, H, D, ks, BN);
  if (!err) err = sm90::make_tile_map(&tv, v, f16, B, S, H, D, vs, BN);
  if (err) return err;
  if (D <= 64)
    return (int)launch<T, 64>(tq, tk, tv, o, lse, B, H, S, D, os, scale, causal, stream);
  return (int)launch<T, 128>(tq, tk, tv, o, lse, B, H, S, D, os, scale, causal, stream);
}

}  // namespace

// dtype: 1 bfloat16, 2 float16. D a multiple of 16 in [16, 128]; strides in
// elements, in the order batch, seq, head, head-dim: the head-dim stride 1,
// the others multiples of 8, base pointers 16-byte aligned (TMA's rules,
// checked by the caller); the output o contiguous. lse is [B, H, S] float32,
// contiguous. Returns 0, a cudaError_t, or sm90::ENCODE_ERROR_BASE + the
// CUresult of a refused tensor map. Does not synchronise.
extern "C" int paddle_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B, int H,
    int S, int D, long long qsb, long long qss, long long qsh, long long qsd, long long ksb,
    long long kss, long long ksh, long long ksd, long long vsb, long long vss, long long vsh,
    long long vsd, long long osb, long long oss, long long osh, long long osd, float scale,
    int causal, void* stream) {
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd};
  const Strides vs{vsb, vss, vsh, vsd}, os{osb, oss, osh, osd};
  if (D % 16 != 0 || D < 16 || D > 128 || qsd != 1 || ksd != 1 || vsd != 1 || osd != 1)
    return (int)cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_dtype<__nv_bfloat16>(q, k, v, o, lse_f, B, H, S, D, qs, ks, vs, os, scale,
                                         causal, st);
    case 2:
      return launch_dtype<__half>(q, k, v, o, lse_f, B, H, S, D, qs, ks, vs, os, scale, causal,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
