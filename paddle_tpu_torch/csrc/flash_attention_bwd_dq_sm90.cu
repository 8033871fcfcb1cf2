// Flash-attention dQ backward on Hopper's tensor cores (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel for bf16
// and fp16 inputs whose strides TMA can read (the route `sm90_eligible` picks
// in ops/kernels/flash_attention.py; flash_attention_bwd.cu's dq_kernel takes
// the rest). It computes what that kernel computes, from the forward's lse and
// delta = rowsum(dO∘O): S = Q·Kᵀ in f32, scaled, the diagonal masked to -1e30;
// p = exp(S − lse); dP = dO·Vᵀ; dS = p∘(dP − delta)·scale, rounded to K's type
// before dQ += dS·K; every sum in f32. There are no atomics: the dQ of a query
// tile is summed in one block's registers over the key tiles in a fixed order,
// so a second backward on the same input is bitwise equal.
//
// What bounds it on this card: 6·D FLOP per attended (query, key) pair (Q·Kᵀ,
// dO·Vᵀ, dS·K) against a few bytes per row, so it is bound by the tensor cores
// (989 TFLOP/s in bf16); at the GPT-2 345M training shape (8, 1024, 16, 64)
// causal that is 25.8 GFLOP, 0.026 ms.
//
// This design is the forward's (flash_attention_fwd_sm90.cu) with one more
// product: queries are the wgmma's M rows, so dQ accumulates where it is
// stored, and lse and delta belong to a thread's own two rows.
//   - one block per 128-row query tile of one (batch, head): NWG = 2 consumer
//     warpgroups of 64 rows each and one producer warp. Q and dO (128 x D) are
//     loaded once by TMA and stay resident; each thread reads the lse and
//     delta of its two rows once, into registers.
//   - K and V tiles of BN = 64 keys stream by TMA through a two-stage ring,
//     both completing on one mbarrier per stage; the consumers release a
//     stage through an `empty` mbarrier.
//   - per key tile: S = Q·Kᵀ and dP = dO·Vᵀ are SS wgmmas (m64n64k16, both
//     operands K-major), committed as two groups; P = exp(S·scale − lse) runs
//     in S's registers while dP is still in flight (the same expression as the
//     dK/dV kernel, so both see the same P); dS = P∘(dP − delta)·scale is
//     rounded in registers into the A fragment of dQ += dS·K, an RS wgmma with
//     K as the MN-major B operand from the same TMA tile that fed S as a
//     K-major one.
//   - causal key tiles past the block's last row are never loaded, a
//     warpgroup skips the tiles wholly above its rows, and the heaviest query
//     tiles are launched first. A ragged S reads zeros past the end (TMA),
//     masks keys >= S and reads lse = delta = 0 for rows >= S, which are not
//     written; the head dim reads as zeros up to 64 (128), so D may be any
//     multiple of 16 up to 128.
//   - registers per thread: S, dP and dQ accumulators (32 + 32 + DP/2) and
//     the 16 of the dS fragment; dQ is written once, from registers, in the
//     input type.
// Tried on the H100 and not kept: a K barrier apart from V's, so that S is
// issued before V lands and dP after, made ptxas serialize the wgmmas
// (C7520, a warpgroup arrive on a divergent path) and was slower than
// waiting for both first; a third stage of the ring changed nothing.

#include "sm90_common.cuh"

namespace {

using sm90::Strides;
using sm90::TileMap;

constexpr int BN = 64;   // keys per streamed tile
constexpr int NST = 2;   // stages of the K/V ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, int NWG>
struct Smem {
  static constexpr int BM = 64 * NWG;           // query rows per block
  static constexpr int SUB = DP / 64;           // 64-column sub-tiles
  static constexpr int Q_BYTES = BM * DP * 2;   // Q, and dO, resident
  static constexpr int KV_BYTES = BN * DP * 2;  // one stage of K, and of V
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + Q_BYTES;
  static constexpr int K_OFF = DO_OFF + Q_BYTES;  // K stage st at K_OFF + st·KV_BYTES
  static constexpr int V_OFF = K_OFF + NST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NST) + 1024;  // + alignment slack
};

template <typename T, int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
dq_sm90_kernel(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
               const __grid_constant__ TileMap tv, const __grid_constant__ TileMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int H, int S, int D, Strides dqs, float scale, int causal,
               int n_qt) {
  using L = Smem<DP, NWG>;
  constexpr int BM = L::BM;
  constexpr int SUB = L::SUB;
  constexpr int CONSUMERS = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem + L::Q_OFF;
  uint8_t* sdO = smem + L::DO_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_qdo = bars;
  uint64_t* bar_kv = bars + 1;  // TMA of K and V, per stage
  uint64_t* bar_empty = bars + 1 + NST;

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
    sm90::mbar_init(bar_qdo, 1);
    for (int st = 0; st < NST; ++st) {
      sm90::mbar_init(bar_kv + st, 1);
      sm90::mbar_init(bar_empty + st, CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every load
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(bar_qdo, 2 * L::Q_BYTES);
      for (int s = 0; s < SUB; ++s) {
        sm90::tma_load_tile(&tq, bar_qdo, sQ + s * BM * 128, 64 * s, b, q0, h);
        sm90::tma_load_tile(&tdo, bar_qdo, sdO + s * BM * 128, 64 * s, b, q0, h);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % NST;
        if (it >= NST) sm90::mbar_wait(bar_empty + st, ((it / NST) - 1) & 1);
        uint8_t* sK = smem + L::K_OFF + st * L::KV_BYTES;
        uint8_t* sV = smem + L::V_OFF + st * L::KV_BYTES;
        sm90::mbar_expect_tx(bar_kv + st, 2 * L::KV_BYTES);
        for (int s = 0; s < SUB; ++s) {
          sm90::tma_load_tile(&tk, bar_kv + st, sK + s * BN * 128, 64 * s, b, it * BN, h);
          sm90::tma_load_tile(&tv, bar_kv + st, sV + s * BN * 128, 64 * s, b, it * BN, h);
        }
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
  float lse_l2[2], drow[2];  // lse·log2(e) and delta of this thread's rows; 0 past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < S;
    lse_l2[r] = in ? lse[(long long)bh * S + row[r]] * LOG2E : 0.f;
    drow[r] = in ? delta[(long long)bh * S + row[r]] : 0.f;
  }
  const uint8_t* sQw = sQ + 64 * wg * 128;
  const uint8_t* sdOw = sdO + 64 * wg * 128;

  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  sm90::mbar_wait(bar_qdo, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int st = it % NST;
    const uint32_t parity = (it / NST) & 1;
    const int k0 = it * BN;
    const uint8_t* sK = smem + L::K_OFF + st * L::KV_BYTES;
    const uint8_t* sV = smem + L::V_OFF + st * L::KV_BYTES;
    // a tile wholly above this warpgroup's rows contributes nothing
    const bool active = !causal || k0 <= wg_row0 + 63;

    sm90::mbar_wait(bar_kv + st, parity);
    if (active) {
      float s_acc[BN / 2], dp_acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
      sm90::fence_operand(s_acc);
      sm90::fence_operand(dp_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {  // S = Q·Kᵀ
        const int sub = ks / 4, off = 32 * (ks % 4);
        sm90::wgmma_ss_n64<T, 0>(s_acc, sm90::make_desc(sQw + sub * BM * 128 + off, 0),
                                 sm90::make_desc(sK + sub * BN * 128 + off, 0), ks > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {  // dP = dO·Vᵀ
        const int sub = ks / 4, off = 32 * (ks % 4);
        sm90::wgmma_ss_n64<T, 0>(dp_acc, sm90::make_desc(sdOw + sub * BM * 128 + off, 0),
                                 sm90::make_desc(sV + sub * BN * 128 + off, 0), ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S has landed; dP may still be in flight
      sm90::fence_operand(s_acc);

      // P = exp(S·scale − lse); element i is row row[(i >> 1) & 1], key
      // k0 + 8·(i / 4) + 2·quad + (i & 1)
      const bool masked = (causal && k0 + BN - 1 > wg_row0) || k0 + BN > S;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x = s_acc[i] * scale;
        if (masked) {
          const int kj = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
          if (kj >= S || (causal && kj > row[r])) x = NEG_INF;
        }
        s_acc[i] = sm90::ex2(fmaf(x, LOG2E, -lse_l2[r]));
      }
      sm90::wgmma_wait<0>();  // dP has landed
      sm90::fence_operand(dp_acc);

      // dS = P∘(dP − delta)·scale, rounded to the input type
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        dp_acc[i] = s_acc[i] * (dp_acc[i] - drow[(i >> 1) & 1]) * scale;
      uint32_t dsf[BN / 16][4];
      sm90::acc_to_a<T, BN / 16>(dp_acc, dsf);
      sm90::fence_operand(dq_acc);
      sm90::fence_operand(dsf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {  // dQ += dS·K
        sm90::wgmma_rs<T, DP, 1>(dq_acc, dsf[kk], sm90::make_desc(sK + kk * 2048, BN * 128), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(dq_acc);
      sm90::fence_operand(dsf);
    }
    sm90::mbar_arrive(bar_empty + st);
  }

  // the single write of dQ, in the input type
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row[r];
    if (qi >= S) continue;
    T* dqrow = dq + b * dqs.b + qi * dqs.s + h * dqs.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      if (col < D) {  // the output is contiguous: stride 1 along the head dim
        *reinterpret_cast<uint32_t*>(dqrow + col) =
            sm90::pack2<T>(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <typename T, int DP, int NWG>
cudaError_t launch(const TileMap& tq, const TileMap& tk, const TileMap& tv, const TileMap& tdo,
                   const float* lse, const float* delta, void* dq, int B, int H, int S, int D,
                   Strides dqs, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<DP, NWG>::BYTES;
  // set at the instantiation's first launch only, so a launch inside CUDA-graph
  // capture makes no call but the launch itself
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_sm90_kernel<T, DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_qt = (S + 64 * NWG - 1) / (64 * NWG);
  dim3 grid((unsigned)(n_qt * B * H));
  dq_sm90_kernel<T, DP, NWG><<<grid, 128 * NWG + 32, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), H, S, D, dqs, scale, causal, n_qt);
  return cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                 const float* delta, void* dq, int B, int H, int S, int D, Strides qs,
                 Strides ks, Strides vs, Strides dos, Strides dqs, float scale, int causal,
                 cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  constexpr int NWG = 2;
  TileMap tq, tk, tv, tdo;
  int err = sm90::make_tile_map(&tq, q, f16, B, S, H, D, qs, 64 * NWG);
  if (!err) err = sm90::make_tile_map(&tk, k, f16, B, S, H, D, ks, BN);
  if (!err) err = sm90::make_tile_map(&tv, v, f16, B, S, H, D, vs, BN);
  if (!err) err = sm90::make_tile_map(&tdo, dO, f16, B, S, H, D, dos, 64 * NWG);
  if (err) return err;
  if (D <= 64)
    return (int)launch<T, 64, NWG>(tq, tk, tv, tdo, lse, delta, dq, B, H, S, D, dqs, scale,
                                   causal, stream);
  return (int)launch<T, 128, NWG>(tq, tk, tv, tdo, lse, delta, dq, B, H, S, D, dqs, scale,
                                  causal, stream);
}

}  // namespace

// dtype: 1 bfloat16, 2 float16. D a multiple of 16 in [16, 128]; strides in
// elements, in the order batch, seq, head, head-dim, for q, k, v, dO and dq:
// the head-dim stride 1, the others multiples of 8, base pointers 16-byte
// aligned (TMA's rules, checked by the caller); dq contiguous. lse and delta
// are [B, H, S] float32, contiguous. Returns 0, a cudaError_t, or
// sm90::ENCODE_ERROR_BASE + the CUresult of a refused tensor map. Does not
// synchronise.
extern "C" int paddle_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dq, int dtype, int B, int H, int S, int D, long long qsb,
    long long qss, long long qsh, long long qsd, long long ksb, long long kss, long long ksh,
    long long ksd, long long vsb, long long vss, long long vsh, long long vsd, long long dosb,
    long long doss, long long dosh, long long dosd, long long dqsb, long long dqss,
    long long dqsh, long long dqsd, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd}, vs{vsb, vss, vsh, vsd};
  const Strides dos{dosb, doss, dosh, dosd}, dqs{dqsb, dqss, dqsh, dqsd};
  if (D % 16 != 0 || D < 16 || D > 128 || qsd != 1 || ksd != 1 || vsd != 1 || dosd != 1 ||
      dqsd != 1)
    return (int)cudaErrorInvalidValue;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_dtype<__nv_bfloat16>(q, k, v, dO, lse_f, delta_f, dq, B, H, S, D, qs, ks,
                                         vs, dos, dqs, scale, causal, st);
    case 2:
      return launch_dtype<__half>(q, k, v, dO, lse_f, delta_f, dq, B, H, S, D, qs, ks, vs, dos,
                                  dqs, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
