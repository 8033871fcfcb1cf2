// f32 flash-attention backward, 3xTF32 on Hopper's tensor cores (sm_90a), CUDA C++ with C entries.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel (dK, dV)
// and ::_bwd_dq_kernel (dQ) for f32 inputs whose strides TMA can read (the
// route `tf32x3_eligible` picks in ops/kernels/flash_attention.py;
// flash_attention_bwd.cu's SIMT kernels take the other f32 inputs). They
// compute what those kernels compute, from the forward's lse and
// delta = rowsum(dO∘O): S = Q·Kᵀ, scaled, the diagonal tile masked to -1e30;
// p = exp(S − lse); dV += pᵀ·dO; dP = dO·Vᵀ; dS = p∘(dP − delta)·scale;
// dK += dSᵀ·Q and dQ += dS·K; every value and every sum in f32. There are no
// atomics: dK and dV of a key tile are summed in one block over the query
// tiles, dQ of a query tile in one block over the key tiles, each in a fixed
// order, so a second backward on the same input is bitwise equal.
//
// What bounds it on this card: 8·D (dkv) and 6·D (dq) FLOP per attended
// (query, key) pair against a few bytes per row, so both are bound by
// arithmetic. The CUDA cores give 67 TFLOP/s in f32; the tensor cores give
// 495 TFLOP/s in TF32 (mma.sync reaches only part of it), but one TF32
// product (10-bit mantissa) misses the f32 gradient tolerance (2e-3) at four
// heads. So every product is split in three TF32 products (3xTF32):
// x = big + small, and a·b = small_a·big_b + big_a·small_b + big_a·big_b
// (small·small, ~2^-20 relative, is dropped), each accumulated in f32 by
// mma.sync.m16n8k8.tf32. That is about as accurate as an f32 product and
// costs three TF32 products: 3·34.4 and 3·25.8 GFLOP at the GPT-2 345M
// training shape (8, 1024, 16, 64) causal, 0.208 and 0.156 ms at the TF32
// peak. The splits (two instructions per loaded element, see `split`) and the
// shared-memory loads run beside the MMAs, so instruction slots bound it too.
//
// Why mma.sync and not wgmma: wgmma reads tf32 operands from shared memory
// K-major only, and B only from shared memory, so every MN-major B (dO and Q
// in dK/dV, K in dQ) would need a transposed copy, and the big and small
// halves of each B a copy each. mma.sync takes its fragments from registers,
// loaded by plain per-thread addresses, so a K-major and an MN-major read cost
// the same and the split happens in registers, once per loaded element.
//
// This design, both kernels: one block per 64-row tile of one (batch, head)
// that stays resident (keys for dkv, queries for dq), and four warps of 16 of
// those rows each (the mma's M).
//   - the resident tiles (K and V; Q and dO) are loaded once by TMA; the
//     other side (Q and dO with lse and delta; K and V) streams in 32-row
//     tiles through a two-stage ring on mbarriers: TMA with the 128-byte
//     swizzle, so a tile is D/32 sub-tiles of 32 f32 per row, and each warp's
//     fragment reads, K-major or MN-major, hit 32 distinct banks. Warp 0
//     refills a stage once every warp has released it (an `empty` mbarrier);
//     there is no producer warp, whose registers would lower every thread's
//     cap. Up to D = 64 a block takes under 75 KB, so three share an SM.
//   - dkv: Sᵀ = K·Qᵀ, then Pᵀ = exp(Sᵀ·scale − lse) in its registers, then
//     dV += Pᵀ·dO; dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − delta)·scale in its registers,
//     then dK += dSᵀ·Q. lse and delta of the query tile are staged in shared
//     memory by warp 0's lanes (+inf and 0 for rows past S, so p = 0 there).
//   - dq: S = Q·Kᵀ, P; dP = dO·Vᵀ, dS; dQ += dS·K, with lse and delta of a
//     thread's two rows in registers. Keys past S are masked; causal key tiles
//     past the block's last row are never loaded, and a warp skips the tiles
//     wholly above its rows.
//   - P and dS never touch shared memory: an m16n8 accumulator gives thread
//     (g = lane/4, t = lane%4) columns 2t and 2t+1, and the m16n8k8 A fragment
//     wants k = t and t+4. So the accumulator is fed to the next product as
//     it is, and the reduction index is permuted on the B side instead: B's
//     b0 is read from k-row 2t and b1 from k-row 2t+1, not t and t+4.
//   - the heaviest causal tiles are launched first; dK, dV and dQ are written
//     once, in f32, through their strides. Rows past S read as zeros (TMA)
//     and are not written; head-dim columns past D read as zeros, so D may be
//     any multiple of 8 up to 128 (tiles are 32, 64 or 128 wide).
//
// The fragment loads, splits, products and stores shared with the forward
// (flash_attention_fwd_tf32.cu) are in tf32x3.cuh.

#include <math_constants.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

// Shared memory of a block: two resident tiles of ROWS rows, NST stages of
// two streamed tiles of BN rows, lse and delta per stage (dkv), barriers. A
// tile is DP/32 swizzled sub-tiles of (its rows) x 32 f32. Up to D = 64 that
// is under 75 KB, so three blocks share an SM (12 warps; ptxas then caps dK/dV
// at 168 registers, without spills); on the H100 that was faster than two
// blocks streaming 64-row tiles.
template <int DP>
struct Smem {
  static constexpr int RES_FLOATS = ROWS * DP;
  static constexpr int STREAM_FLOATS = BN * DP;
  static constexpr int RES_OFF = 0;
  static constexpr int RING_OFF = 2 * RES_FLOATS * 4;  // stage st at + 2·st·STREAM_FLOATS·4
  static constexpr int STATS_OFF = RING_OFF + NST * 2 * STREAM_FLOATS * 4;  // [NST][2][BN]
  static constexpr int BAR_OFF = STATS_OFF + NST * 2 * BN * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NST) + 1024;  // + alignment slack
  static constexpr int BLOCKS = BYTES <= 75 * 1024 ? 3 : BYTES <= 113 * 1024 ? 2 : 1;  // per SM
};

template <int DP>
__global__ void __launch_bounds__(THREADS, Smem<DP>::BLOCKS)
dkv_tf32_kernel(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
                const __grid_constant__ TileMap tv, const __grid_constant__ TileMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int H, int S, int D,
                Strides dks, Strides dvs, float scale, int causal, int n_kt) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* sK = reinterpret_cast<float*>(smem + L::RES_OFF);
  float* sV = sK + L::RES_FLOATS;
  float* ring = reinterpret_cast<float*>(smem + L::RING_OFF);  // stage st: Q, then dO
  float* stats = reinterpret_cast<float*>(smem + L::STATS_OFF);  // stage st: lse, then delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_kv = bars;
  uint64_t* bar_full = bars + 1;
  uint64_t* bar_empty = bars + 1 + NST;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int BH = gridDim.x / n_kt;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * ROWS;  // causal: the low key tiles see the most queries
  const int b = bh / H;
  const int h = bh % H;
  const int n_qt = (S + BN - 1) / BN;
  const int qt_begin = causal ? k0 / BN : 0;  // query tiles wholly above the diagonal see none
  const int n_it = n_qt - qt_begin;

  // warp 0 fills stage it % NST for query tile qt_begin + it: lse and delta
  // by its lanes (each lane's arrival), Q and dO by TMA (lane 0's arrival)
  auto fill = [&](int it) {
    const int st = it % NST;
    const int q0 = (qt_begin + it) * BN;
    float* st_lse = stats + st * 2 * BN;
    for (int r = lane; r < BN; r += 32) {  // +inf and 0 past S: p = 0 on those rows
      const bool in = q0 + r < S;
      st_lse[r] = in ? lse[(long long)bh * S + q0 + r] : CUDART_INF_F;
      st_lse[BN + r] = in ? delta[(long long)bh * S + q0 + r] : 0.f;
    }
    if (lane == 0)
      load_pair<DP, BN>(&tq, &tdo, bar_full + st, ring + st * 2 * L::STREAM_FLOATS, b, q0, h);
    else
      sm90::mbar_arrive(bar_full + st);
  };

  if (tid == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int st = 0; st < NST; ++st) {
      sm90::mbar_init(bar_full + st, 32);  // warp 0's lanes, one with the TMA bytes
      sm90::mbar_init(bar_empty + st, THREADS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_expect_tx(bar_kv, 2 * L::RES_FLOATS * 4);
      for (int s = 0; s < DP / 32; ++s) {
        sm90::tma_load_tile(&tk, bar_kv, sK + s * ROWS * 32, 32 * s, b, k0, h);
        sm90::tma_load_tile(&tv, bar_kv, sV + s * ROWS * 32, 32 * s, b, k0, h);
      }
    }
    for (int it = 0; it < NST && it < n_it; ++it) fill(it);
  }

  // warp w owns keys k0 + 16w ... + 15
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * warp;
  const Offsets o(g, t);
  const int key[2] = {k0 + m0 + g, k0 + m0 + g + 8};

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[jn][e] = dv_acc[jn][e] = 0.f;

  sm90::mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % NST;
    const int q0 = (qt_begin + it) * BN;
    const float* sQ = ring + st * 2 * L::STREAM_FLOATS;
    const float* sdO = sQ + L::STREAM_FLOATS;
    const float* st_lse = stats + st * 2 * BN;
    const float* st_delta = st_lse + BN;
    sm90::mbar_wait(bar_full + st, (it / NST) & 1);

    // Pᵀ = exp(Sᵀ·scale − lse); element e of block j is key key[e >> 1],
    // query q0 + 8j + 2t + (e & 1)
    float p[BN / 8][4];
    rows_by_rows<DP>(p, sK, m0, sQ, o);
    const bool diagonal = causal && q0 < k0 + ROWS;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = p[j][e] * scale;
        if (diagonal && q0 + c < key[e >> 1]) x = NEG_INF;
        p[j][e] = expf(x - st_lse[c]);
      }
    acc_by_tile<DP>(dv_acc, p, sdO, o);  // dV += Pᵀ·dO

    // dSᵀ = Pᵀ∘(dPᵀ − delta)·scale, in dPᵀ's registers
    float ds[BN / 8][4];
    rows_by_rows<DP>(ds, sV, m0, sdO, o);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - st_delta[8 * j + 2 * t + (e & 1)]) * scale;
    acc_by_tile<DP>(dk_acc, ds, sQ, o);  // dK += dSᵀ·Q

    sm90::mbar_arrive(bar_empty + st);
    if (warp == 0 && it + NST < n_it) {  // refill the stage once every warp is done with it
      sm90::mbar_wait(bar_empty + st, (it / NST) & 1);
      fill(it + NST);
    }
  }

  store_rows<DP>(dk, dks, b, h, k0 + m0, S, D, g, t, dk_acc);
  store_rows<DP>(dv, dvs, b, h, k0 + m0, S, D, g, t, dv_acc);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, Smem<DP>::BLOCKS)
dq_tf32_kernel(const __grid_constant__ TileMap tq, const __grid_constant__ TileMap tk,
               const __grid_constant__ TileMap tv, const __grid_constant__ TileMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int H, int S, int D, Strides dqs, float scale, int causal,
               int n_qt) {
  using L = Smem<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem + L::RES_OFF);
  float* sdO = sQ + L::RES_FLOATS;
  float* ring = reinterpret_cast<float*>(smem + L::RING_OFF);  // stage st: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* bar_qdo = bars;
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
    sm90::mbar_init(bar_qdo, 1);
    for (int st = 0; st < NST; ++st) {
      sm90::mbar_init(bar_full + st, 1);
      sm90::mbar_init(bar_empty + st, THREADS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {  // Q and dO, then the first stages of K and V
    load_pair<DP, ROWS>(&tq, &tdo, bar_qdo, sQ, b, q0, h);
    for (int it = 0; it < NST && it < n_kt; ++it)
      load_pair<DP, BN>(&tk, &tv, bar_full + it, ring + it * 2 * L::STREAM_FLOATS, b, it * BN,
                        h);
  }

  // warp w owns queries q0 + 16w ... + 15
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * warp;
  const Offsets o(g, t);
  const int row[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  float lse_r[2], delta_r[2];  // +inf and 0 past S: p = 0 on those rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < S;
    lse_r[r] = in ? lse[(long long)bh * S + row[r]] : CUDART_INF_F;
    delta_r[r] = in ? delta[(long long)bh * S + row[r]] : 0.f;
  }

  float dq_acc[DP / 8][4];
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[jn][e] = 0.f;

  sm90::mbar_wait(bar_qdo, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % NST;
    const int k0 = it * BN;
    const float* sK = ring + st * 2 * L::STREAM_FLOATS;
    const float* sV = sK + L::STREAM_FLOATS;
    sm90::mbar_wait(bar_full + st, (it / NST) & 1);
    if (!causal || k0 <= q0 + m0 + 15) {  // a tile wholly above this warp's rows adds nothing
      // P = exp(S·scale − lse); element e of block j is row row[e >> 1], key
      // k0 + 8j + 2t + (e & 1)
      float p[BN / 8][4];
      rows_by_rows<DP>(p, sQ, m0, sK, o);
      const bool masked = (causal && k0 + BN - 1 > q0 + m0) || k0 + BN > S;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = p[j][e] * scale;
          if (masked) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            if (kj >= S || (causal && kj > row[e >> 1])) x = NEG_INF;
          }
          p[j][e] = expf(x - lse_r[e >> 1]);
        }
      // dS = P∘(dP − delta)·scale, in dP's registers
      float ds[BN / 8][4];
      rows_by_rows<DP>(ds, sdO, m0, sV, o);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]) * scale;
      acc_by_tile<DP>(dq_acc, ds, sK, o);  // dQ += dS·K
    }
    sm90::mbar_arrive(bar_empty + st);
    if (tid == 0 && it + NST < n_kt) {  // refill the stage once every warp is done with it
      sm90::mbar_wait(bar_empty + st, (it / NST) & 1);
      load_pair<DP, BN>(&tk, &tv, bar_full + st, ring + st * 2 * L::STREAM_FLOATS, b,
                        (it + NST) * BN, h);
    }
  }

  store_rows<DP>(dq, dqs, b, h, q0 + m0, S, D, g, t, dq_acc);
}

template <int DP>
cudaError_t launch_dkv(const TileMap (&maps)[4], const float* lse, const float* delta, float* dk,
                       float* dv, int B, int H, int S, int D, Strides dks, Strides dvs,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Smem<DP>::BYTES;
  static bool configured = false;
  cudaError_t err = configure(dkv_tf32_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int n_kt = (S + ROWS - 1) / ROWS;
  dkv_tf32_kernel<DP><<<(unsigned)(n_kt * B * H), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dk, dv, H, S, D, dks, dvs, scale, causal,
      n_kt);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const TileMap (&maps)[4], const float* lse, const float* delta, float* dq,
                      int B, int H, int S, int D, Strides dqs, float scale, int causal,
                      cudaStream_t stream) {
  constexpr int smem = Smem<DP>::BYTES;
  static bool configured = false;
  cudaError_t err = configure(dq_tf32_kernel<DP>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (S + ROWS - 1) / ROWS;
  dq_tf32_kernel<DP><<<(unsigned)(n_qt * B * H), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dq, H, S, D, dqs, scale, causal, n_qt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, the only one taken. D a multiple of 8 in [8, 128];
// strides in elements, in the order batch, seq, head, head-dim, for q, k, v,
// dO, dK and dV: the input head-dim strides 1, the others multiples of 4,
// base pointers 16-byte aligned (TMA's rules, checked by the caller). lse and
// delta are [B, H, S] float32, contiguous. Returns 0, a cudaError_t, or
// sm90::ENCODE_ERROR_BASE + the CUresult of a refused tensor map. Does not
// synchronise.
extern "C" int paddle_flash_attention_bwd_dkv_tf32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int dtype, int B, int H, int S, int D,
    long long qsb, long long qss, long long qsh, long long qsd, long long ksb, long long kss,
    long long ksh, long long ksd, long long vsb, long long vss, long long vsh, long long vsd,
    long long osb, long long oss, long long osh, long long osd, long long dksb,
    long long dkss, long long dksh, long long dksd, long long dvsb, long long dvss,
    long long dvsh, long long dvsd, float scale, int causal, void* stream) {
  const Strides st[4] = {{qsb, qss, qsh, qsd}, {ksb, kss, ksh, ksd}, {vsb, vss, vsh, vsd},
                         {osb, oss, osh, osd}};
  const Strides dks{dksb, dkss, dksh, dksd}, dvs{dvsb, dvss, dvsh, dvsd};
  if (!accepted(dtype, D, st)) return (int)cudaErrorInvalidValue;
  TileMap maps[4];
  const void* const ptrs[4] = {q, k, v, dout};
  const int rows[4] = {BN, ROWS, ROWS, BN};  // Q and dO stream, K and V stay
  const int err = make_maps(maps, ptrs, st, rows, B, S, H, D);
  if (err) return err;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dk_f = static_cast<float*>(dk);
  float* dv_f = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return (int)launch_dkv<32>(maps, lse_f, delta_f, dk_f, dv_f, B, H, S, D, dks, dvs, scale,
                               causal, s);
  if (D <= 64)
    return (int)launch_dkv<64>(maps, lse_f, delta_f, dk_f, dv_f, B, H, S, D, dks, dvs, scale,
                               causal, s);
  return (int)launch_dkv<128>(maps, lse_f, delta_f, dk_f, dv_f, B, H, S, D, dks, dvs, scale,
                              causal, s);
}

// As paddle_flash_attention_bwd_dkv_tf32, with dQ as the one output.
extern "C" int paddle_flash_attention_bwd_dq_tf32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int dtype, int B, int H, int S, int D, long long qsb,
    long long qss, long long qsh, long long qsd, long long ksb, long long kss, long long ksh,
    long long ksd, long long vsb, long long vss, long long vsh, long long vsd, long long osb,
    long long oss, long long osh, long long osd, long long dqsb, long long dqss,
    long long dqsh, long long dqsd, float scale, int causal, void* stream) {
  const Strides st[4] = {{qsb, qss, qsh, qsd}, {ksb, kss, ksh, ksd}, {vsb, vss, vsh, vsd},
                         {osb, oss, osh, osd}};
  const Strides dqs{dqsb, dqss, dqsh, dqsd};
  if (!accepted(dtype, D, st)) return (int)cudaErrorInvalidValue;
  TileMap maps[4];
  const void* const ptrs[4] = {q, k, v, dout};
  const int rows[4] = {ROWS, BN, BN, ROWS};  // K and V stream, Q and dO stay
  const int err = make_maps(maps, ptrs, st, rows, B, S, H, D);
  if (err) return err;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dq_f = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return (int)launch_dq<32>(maps, lse_f, delta_f, dq_f, B, H, S, D, dqs, scale, causal, s);
  if (D <= 64)
    return (int)launch_dq<64>(maps, lse_f, delta_f, dq_f, B, H, S, D, dqs, scale, causal, s);
  return (int)launch_dq<128>(maps, lse_f, delta_f, dq_f, B, H, S, D, dqs, scale, causal, s);
}
