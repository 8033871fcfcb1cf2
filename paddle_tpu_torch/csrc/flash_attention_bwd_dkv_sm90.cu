// Flash-attention dK/dV backward on Hopper's tensor cores (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel for bf16
// and fp16 inputs whose strides TMA can read (the route `sm90_eligible` picks
// in ops/kernels/flash_attention.py; flash_attention_bwd.cu's dkv_kernel takes
// the rest). It computes what that kernel computes, from the forward's lse and
// delta = rowsum(dO∘O): S = Q·Kᵀ in f32, scaled, the diagonal masked to -1e30;
// p = exp(S − lse); dV += pᵀ·dO with p rounded to dO's type; dP = dO·Vᵀ;
// dS = p∘(dP − delta)·scale; dK += dSᵀ·Q with dS rounded to the input type;
// every sum in f32. There are no atomics: dK and dV of a key tile are summed
// in one block's registers over the query tiles in a fixed order, so a second
// backward on the same input is bitwise equal.
//
// What bounds it on this card: 8·D FLOP per attended (query, key) pair (Q·Kᵀ,
// dO·Vᵀ, pᵀ·dO, dSᵀ·Q) against a few bytes per row, so it is bound by the
// tensor cores (989 TFLOP/s in bf16); at the GPT-2 345M training shape
// (8, 1024, 16, 64) causal that is 34.4 GFLOP, 0.035 ms.
//
// This design computes the transposed products, so keys are the wgmma's 64
// M rows and the gradients accumulate where they are stored:
//   - one block per key tile of 64·NWG keys: NWG consumer warpgroups (two for
//     D <= 64, one for D = 128, to leave room for the accumulators), each
//     owning 64 keys, plus one producer warp. K and V stay resident in shared
//     memory, loaded once by TMA.
//   - query tiles of 64 rows stream by TMA through a three-stage ring, from the
//     first one that reaches the diagonal: Q and dO by TMA, lse and delta
//     (f32, indexed by column) copied to shared memory by the producer warp's
//     lanes, each stage released by the consumers through an `empty` mbarrier.
//   - per query tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS wgmmas (m64n64k16);
//     Pᵀ = exp(Sᵀ·scale − lse) runs in Sᵀ's registers while dPᵀ is still in
//     flight; Pᵀ rounded to the input type is the A fragment of dV += Pᵀ·dO,
//     and dSᵀ = Pᵀ∘(dPᵀ − delta)·scale rounded the A fragment of dK += dSᵀ·Q,
//     both RS wgmmas with dO and Q as MN-major B operands from the same TMA
//     tiles that fed Sᵀ and dPᵀ as K-major ones.
//   - registers per thread at D = 64: dK, dV, Sᵀ and dPᵀ are four 64x64 f32
//     accumulators, 32 each, 128 in all, plus 32 for the two A fragments
//     (ptxas: 164 at D = 64, 235 at D = 128 with one warpgroup, no spills).
//   - dK and dV stay in f32 registers until the single write in the input
//     type. Queries past S are masked (p = 0); keys past S are computed on
//     zero rows and not written.

#include "sm90_common.cuh"

namespace {

using sm90::Strides;
using sm90::TileMap;

constexpr int BQ = 64;   // queries per streamed tile
constexpr int NST = 3;   // stages of the Q/dO ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, int NWG>
struct Smem {
  static constexpr int BKEY = 64 * NWG;            // keys per block
  static constexpr int KV_BYTES = BKEY * DP * 2;  // K, and V, resident
  static constexpr int Q_BYTES = BQ * DP * 2;     // one stage of Q, and of dO
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int Q_OFF = V_OFF + KV_BYTES;      // stage st at Q_OFF + st·Q_BYTES
  static constexpr int DO_OFF = Q_OFF + NST * Q_BYTES;
  static constexpr int LSE_OFF = DO_OFF + NST * Q_BYTES;  // [NST][BQ] f32
  static constexpr int DELTA_OFF = LSE_OFF + NST * BQ * 4;
  static constexpr int BAR_OFF = DELTA_OFF + NST * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * NST) + 1024;  // + alignment slack
};

template <typename T, int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
dkv_sm90_kernel(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                const __grid_constant__ TileMap tv, const __grid_constant__ TileMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int H, int S, int D, Strides dks,
                Strides dvs, float scale, int causal, int n_kt) {
  using L = Smem<DP, NWG>;
  constexpr int SUB = DP / 64;
  constexpr int BKEY = L::BKEY;
  constexpr int CONSUMERS = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem + L::K_OFF;
  uint8_t* sV = smem + L::V_OFF;
  float* sL = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* sD = reinterpret_cast<float*>(smem + L::DELTA_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_kv = bars;
  uint64_t* bar_qdo = bars + 1;          // TMA of Q and dO, per stage
  uint64_t* bar_rows = bars + 1 + NST;   // lse and delta, per stage
  uint64_t* bar_empty = bars + 1 + 2 * NST;

  const int tid = threadIdx.x;
  const int BH = gridDim.x / n_kt;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * BKEY;  // early key tiles see the most queries: first
  const int b = bh / H;
  const int h = bh % H;
  const int n_qt = (S + BQ - 1) / BQ;
  const int j0 = causal ? k0 / BQ : 0;  // the first query tile that reaches the diagonal

  if (tid == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int st = 0; st < NST; ++st) {
      sm90::mbar_init(bar_qdo + st, 1);
      sm90::mbar_init(bar_rows + st, 32);
      sm90::mbar_init(bar_empty + st, CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp
    const int lane = tid - CONSUMERS;
    const long long row_base = (long long)bh * S;
    if (lane == 0) {
      sm90::mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
      for (int s = 0; s < SUB; ++s) {
        sm90::tma_load_tile(&tk, bar_kv, sK + s * BKEY * 128, 64 * s, b, k0, h);
        sm90::tma_load_tile(&tv, bar_kv, sV + s * BKEY * 128, 64 * s, b, k0, h);
      }
    }
    for (int j = j0; j < n_qt; ++j) {
      const int it = j - j0;
      const int st = it % NST;
      if (it >= NST) sm90::mbar_wait(bar_empty + st, ((it / NST) - 1) & 1);
      for (int r = lane; r < BQ; r += 32) {
        const int qi = j * BQ + r;
        sL[st * BQ + r] = qi < S ? lse[row_base + qi] : 0.f;
        sD[st * BQ + r] = qi < S ? delta[row_base + qi] : 0.f;
      }
      sm90::mbar_arrive(bar_rows + st);
      if (lane == 0) {
        uint8_t* sQ = smem + L::Q_OFF + st * L::Q_BYTES;
        uint8_t* sdO = smem + L::DO_OFF + st * L::Q_BYTES;
        sm90::mbar_expect_tx(bar_qdo + st, 2 * L::Q_BYTES);
        for (int s = 0; s < SUB; ++s) {
          sm90::tma_load_tile(&tq, bar_qdo + st, sQ + s * BQ * 128, 64 * s, b, j * BQ, h);
          sm90::tma_load_tile(&tdo, bar_qdo + st, sdO + s * BQ * 128, 64 * s, b, j * BQ, h);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64·wg ... + 63
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int wg_key0 = k0 + 64 * wg;
  const int key[2] = {wg_key0 + 16 * warp + (lane >> 2), wg_key0 + 16 * warp + (lane >> 2) + 8};
  const uint8_t* sKw = sK + 64 * wg * 128;
  const uint8_t* sVw = sV + 64 * wg * 128;

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  sm90::mbar_wait(bar_kv, 0);

  for (int j = j0; j < n_qt; ++j) {
    const int it = j - j0;
    const int st = it % NST;
    const uint32_t parity = (it / NST) & 1;
    const int q0 = j * BQ;
    const uint8_t* sQ = smem + L::Q_OFF + st * L::Q_BYTES;
    const uint8_t* sdO = smem + L::DO_OFF + st * L::Q_BYTES;
    // a query tile wholly above this warpgroup's keys contributes nothing
    const bool active = !causal || q0 + BQ - 1 >= wg_key0;

    sm90::mbar_wait(bar_qdo + st, parity);
    sm90::mbar_wait(bar_rows + st, parity);
    if (active) {
      float s_acc[BQ / 2], dp_acc[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
      sm90::fence_operand(s_acc);
      sm90::fence_operand(dp_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {  // Sᵀ = K·Qᵀ
        const int sub = ks / 4, off = 32 * (ks % 4);
        sm90::wgmma_ss_n64<T, 0>(s_acc, sm90::make_desc(sKw + sub * BKEY * 128 + off, 0),
                                 sm90::make_desc(sQ + sub * BQ * 128 + off, 0), ks > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {  // dPᵀ = V·dOᵀ
        const int sub = ks / 4, off = 32 * (ks % 4);
        sm90::wgmma_ss_n64<T, 0>(dp_acc, sm90::make_desc(sVw + sub * BKEY * 128 + off, 0),
                                 sm90::make_desc(sdO + sub * BQ * 128 + off, 0), ks > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // Sᵀ has landed; dPᵀ may still be in flight
      sm90::fence_operand(s_acc);

      // Pᵀ = exp(Sᵀ·scale − lse); element i is key key[(i >> 1) & 1], query
      // q0 + 8·(i / 4) + 2·quad + (i & 1)
      const bool masked = (causal && q0 < wg_key0 + 63) || q0 + BQ > S;
      const float* lrow = sL + st * BQ;
      const float* drow = sD + st * BQ;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * quad + (i & 1);
        float x = s_acc[i] * scale;
        if (masked) {
          const int qi = q0 + c;
          if (qi >= S || (causal && qi < key[(i >> 1) & 1])) x = NEG_INF;
        }
        s_acc[i] = sm90::ex2(fmaf(x, LOG2E, -lrow[c] * LOG2E));
      }
      uint32_t pf[BQ / 16][4];
      sm90::acc_to_a<T, BQ / 16>(s_acc, pf);
      sm90::fence_operand(dv_acc);
      sm90::fence_operand(pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {  // dV += Pᵀ·dO
        sm90::wgmma_rs<T, DP, 1>(dv_acc, pf[kk], sm90::make_desc(sdO + kk * 2048, BQ * 128), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // dPᵀ has landed; dV may still be in flight
      sm90::fence_operand(dp_acc);

      // dSᵀ = Pᵀ∘(dPᵀ − delta)·scale
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * quad + (i & 1);
        dp_acc[i] = s_acc[i] * (dp_acc[i] - drow[c]) * scale;
      }
      uint32_t dsf[BQ / 16][4];
      sm90::acc_to_a<T, BQ / 16>(dp_acc, dsf);
      sm90::fence_operand(dk_acc);
      sm90::fence_operand(dsf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {  // dK += dSᵀ·Q
        sm90::wgmma_rs<T, DP, 1>(dk_acc, dsf[kk], sm90::make_desc(sQ + kk * 2048, BQ * 128), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(dv_acc);
      sm90::fence_operand(dk_acc);
      sm90::fence_operand(pf);
      sm90::fence_operand(dsf);
    }
    sm90::mbar_arrive(bar_empty + st);
  }

  // the single write of dK and dV, in the input type
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key[r];
    if (kj >= S) continue;
    T* dkrow = dk + b * dks.b + kj * dks.s + h * dks.h;
    T* dvrow = dv + b * dvs.b + kj * dvs.s + h * dvs.h;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int col = 8 * jj + 2 * quad;
      if (col < D) {  // the outputs are contiguous: stride 1 along the head dim
        *reinterpret_cast<uint32_t*>(dkrow + col) =
            sm90::pack2<T>(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + col) =
            sm90::pack2<T>(dv_acc[4 * jj + 2 * r], dv_acc[4 * jj + 2 * r + 1]);
      }
    }
  }
}

template <typename T, int DP, int NWG>
cudaError_t launch(const TileMap& tq, const TileMap& tk, const TileMap& tv, const TileMap& tdo,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                   int S, int D, Strides dks, Strides dvs, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Smem<DP, NWG>::BYTES;
  // set at the instantiation's first launch only, so a launch inside CUDA-graph
  // capture makes no call but the launch itself
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkv_sm90_kernel<T, DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_kt = (S + 64 * NWG - 1) / (64 * NWG);
  dim3 grid((unsigned)(n_kt * B * H));
  dkv_sm90_kernel<T, DP, NWG><<<grid, 128 * NWG + 32, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, S, D, dks, dvs,
      scale, causal, n_kt);
  return cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                 const float* delta, void* dk, void* dv, int B, int H, int S, int D, Strides qs,
                 Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, float scale,
                 int causal, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int nwg = D <= 64 ? 2 : 1;
  TileMap tq, tk, tv, tdo;
  int err = sm90::make_tile_map(&tq, q, f16, B, S, H, D, qs, BQ);
  if (!err) err = sm90::make_tile_map(&tk, k, f16, B, S, H, D, ks, 64 * nwg);
  if (!err) err = sm90::make_tile_map(&tv, v, f16, B, S, H, D, vs, 64 * nwg);
  if (!err) err = sm90::make_tile_map(&tdo, dO, f16, B, S, H, D, dos, BQ);
  if (err) return err;
  if (D <= 64)
    return (int)launch<T, 64, 2>(tq, tk, tv, tdo, lse, delta, dk, dv, B, H, S, D, dks, dvs,
                                 scale, causal, stream);
  return (int)launch<T, 128, 1>(tq, tk, tv, tdo, lse, delta, dk, dv, B, H, S, D, dks, dvs, scale,
                                causal, stream);
}

}  // namespace

// dtype: 1 bfloat16, 2 float16. D a multiple of 16 in [16, 128]; strides in
// elements, in the order batch, seq, head, head-dim: the head-dim stride 1,
// the others multiples of 8, base pointers 16-byte aligned (TMA's rules,
// checked by the caller); dk and dv contiguous. lse and delta are [B, H, S]
// float32, contiguous. Returns 0, a cudaError_t, or sm90::ENCODE_ERROR_BASE +
// the CUresult of a refused tensor map. Does not synchronise.
extern "C" int paddle_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dk, void* dv, int dtype, int B, int H, int S, int D, long long qsb,
    long long qss, long long qsh, long long qsd, long long ksb, long long kss, long long ksh,
    long long ksd, long long vsb, long long vss, long long vsh, long long vsd, long long dosb,
    long long doss, long long dosh, long long dosd, long long dksb, long long dkss,
    long long dksh, long long dksd, long long dvsb, long long dvss, long long dvsh,
    long long dvsd, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd}, vs{vsb, vss, vsh, vsd};
  const Strides dos{dosb, doss, dosh, dosd}, dks{dksb, dkss, dksh, dksd};
  const Strides dvs{dvsb, dvss, dvsh, dvsd};
  if (D % 16 != 0 || D < 16 || D > 128 || qsd != 1 || ksd != 1 || vsd != 1 || dosd != 1 ||
      dksd != 1 || dvsd != 1)
    return (int)cudaErrorInvalidValue;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_dtype<__nv_bfloat16>(q, k, v, dO, lse_f, delta_f, dk, dv, B, H, S, D, qs,
                                         ks, vs, dos, dks, dvs, scale, causal, st);
    case 2:
      return launch_dtype<__half>(q, k, v, dO, lse_f, delta_f, dk, dv, B, H, S, D, qs, ks, vs,
                                  dos, dks, dvs, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
