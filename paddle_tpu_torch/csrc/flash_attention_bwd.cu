// Flash-attention backward for Hopper (sm_90a): two kernels, CUDA C++ with plain C entries.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel (dK, dV) and
// ::_bwd_dq_kernel (dQ), the Pallas TPU kernels that `_bwd` launches for the
// gradient of the GPT full-sequence attention. They compute what those kernels
// compute, from the forward's saved lse and delta = rowsum(dO∘O) (computed by the
// caller in f32): S = Q·Kᵀ in f32, scaled, the diagonal tile masked to -1e30;
// p = exp(S − lse); dV += pᵀ·dO with p rounded to dO's type; dP = dO·Vᵀ;
// dS = p∘(dP − delta)·scale; dK += dSᵀ·Q and dQ += dS·K with dS rounded to the
// input type; every sum in f32. There are no atomics: dK and dV are summed per
// key tile inside one block looping over query tiles, dQ per query tile inside
// one block looping over key tiles, so two backward passes on one input give
// bitwise-equal gradients.
//
// What bounds it on this card: causal attention at S = 1024 attends S(S+1)/2
// (query, key) pairs per head. The dkv kernel does 8·D FLOP per pair (Q·Kᵀ,
// dO·Vᵀ, pᵀ·dO, dSᵀ·Q) and the dq kernel 6·D (Q·Kᵀ, dO·Vᵀ, dS·K), against a
// few bytes per row of Q, K, V, dO and the outputs, so both are bound by
// arithmetic, not by HBM. At the GPT-2 345M shape (8, 1024, 16, 64) that is
// 34.4 and 25.8 GFLOP: 0.035 and 0.026 ms on the tensor cores in bf16, 0.51
// and 0.39 ms on the CUDA cores in f32. This first design uses f32 FMAs on the
// CUDA cores for every type, so it is bound by the CUDA cores' FMA rate and by
// the shared-memory reads that feed them; wgmma, TMA and a pipeline are later work.
//
// This design: 256 threads per block, 64-row query tiles and 64-row key tiles.
// Each block recomputes S and dP for a (query tile, key tile) pair over the
// full head dim, staging Q, K, dO and V in 32-wide chunks in shared memory as
// f32 (each thread a 4x4 register tile of both, 32 FMAs per 16 shared loads),
// writes p and dS to shared memory, and then accumulates its 128-wide (or
// narrower) slice of the output head dim in a 4x(16·NJ) register tile:
//   dkv: one block per (key tile, batch·head, head-dim slice); query tiles
//        stream from the first one that reaches the diagonal; dK and dV are
//        two register accumulators.
//   dq:  one block per (query tile, batch·head, head-dim slice); key tiles
//        stream up to the diagonal.
// A head dim over 128 is cut into slices across gridDim.y; each slice's block
// recomputes S and dP over the whole head dim and writes only its slice.
// Q, K, V and dO are read through their [B, S, H, D] strides (the strided views
// of the fused qkv projection, no copies), a ragged tail of S or D is masked on
// load and store, and the heaviest causal tiles are launched first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int DC = 32;        // head-dim chunk staged for Q·Kᵀ and dO·Vᵀ
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr float NEG_INF = -1e30f;
constexpr int CHUNK_FLOATS = (BQ + BK + BQ + BK) * (DC + 1);  // sQc, sKc, sdOc, sVc
constexpr int TILE_FLOATS = BQ * (BK + 1);                   // one [BQ][BK] tile of p or dS

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// x rounded to T and back, as the Pallas body's astype before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Element strides of a [B, S, H, D] tensor.
struct Strides {
  long long b, s, h, d;
};

// S = Q·Kᵀ and dP = dO·Vᵀ for the query tile at q0 and the key tile at k0, over
// the whole head dim. Thread (ty, tx) gets rows q0 + ty + 16i, columns
// k0 + tx + 16j. Rows and columns past S, and head-dim entries past D, load as 0.
// Ends on a barrier, so the chunk buffers are free when it returns.
template <typename T>
__device__ __forceinline__ void scores_and_dp(
    const T* __restrict__ qb, const T* __restrict__ kb, const T* __restrict__ dob,
    const T* __restrict__ vb, const Strides& qs, const Strides& ks, const Strides& dos,
    const Strides& vs, int q0, int k0, int S, int D, float* sQc, float* sKc, float* sdOc,
    float* sVc, float (&s)[4][4], float (&dp)[4][4], int tid, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  for (int d0 = 0; d0 < D; d0 += DC) {
    for (int idx = tid; idx < BQ * DC; idx += THREADS) {
      const int r = idx / DC;
      const int c = idx % DC;
      const int di = d0 + c;
      const int qi = q0 + r;
      const int kj = k0 + r;
      const bool q_ok = qi < S && di < D;
      const bool k_ok = kj < S && di < D;
      sQc[r * (DC + 1) + c] = q_ok ? to_f32(qb[qi * qs.s + di * qs.d]) : 0.f;
      sdOc[r * (DC + 1) + c] = q_ok ? to_f32(dob[qi * dos.s + di * dos.d]) : 0.f;
      sKc[r * (DC + 1) + c] = k_ok ? to_f32(kb[kj * ks.s + di * ks.d]) : 0.f;
      sVc[r * (DC + 1) + c] = k_ok ? to_f32(vb[kj * vs.s + di * vs.d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < DC; ++c) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQc[(ty + 16 * i) * (DC + 1) + c];
        g[i] = sdOc[(ty + 16 * i) * (DC + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sKc[(tx + 16 * j) * (DC + 1) + c];
        bv[j] = sVc[(tx + 16 * j) * (DC + 1) + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }
    __syncthreads();
  }
}

// p and dS of one (query tile, key tile) pair from S and dP, as the Pallas body
// computes them; p is 0 on masked entries and on rows past S. Writes p rounded
// to T into sP (when given) and dS rounded to T into sdS, both [BQ][BK + 1].
template <typename T>
__device__ __forceinline__ void p_and_ds(const float (&s)[4][4], const float (&dp)[4][4],
                                         const float* __restrict__ lse_bh,
                                         const float* __restrict__ delta_bh, int q0, int k0,
                                         int S, float scale, int causal, float* sP, float* sdS,
                                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    const bool row_ok = qi < S;
    const float lse_i = row_ok ? lse_bh[qi] : 0.f;
    const float delta_i = row_ok ? delta_bh[qi] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      float x = s[i][j] * scale;
      if (kj >= S || (causal && kj > qi)) x = NEG_INF;
      const float p = row_ok ? expf(x - lse_i) : 0.f;
      const float ds = p * (dp[i][j] - delta_i) * scale;
      if (sP != nullptr) sP[r * (BK + 1) + c] = round_to<T>(p);
      sdS[r * (BK + 1) + c] = round_to<T>(ds);
    }
  }
}

// Stage rows [r0, r0 + 64) of x's head-dim slice [d_out0, d_out0 + DO) as f32
// into dst[64][DO]; out-of-range entries are 0.
template <typename T, int DO>
__device__ __forceinline__ void stage_slice(const T* __restrict__ xb, const Strides& xs,
                                            int r0, int d_out0, int S, int D, float* dst,
                                            int tid) {
  for (int idx = tid; idx < 64 * DO; idx += THREADS) {
    const int r = idx / DO;
    const int c = idx % DO;
    const int ri = r0 + r;
    const int di = d_out0 + c;
    dst[r * DO + c] = (ri < S && di < D) ? to_f32(xb[ri * xs.s + di * xs.d]) : 0.f;
  }
}

template <int NJ>
constexpr int dkv_smem_floats() {
  // the chunk buffers share their space with the two [BQ][16·NJ] slices of Q
  // and dO; the p and dS tiles follow. +1 columns keep rows off one bank.
  return (CHUNK_FLOATS > 2 * BQ * 16 * NJ ? CHUNK_FLOATS : 2 * BQ * 16 * NJ) + 2 * TILE_FLOATS;
}

template <int NJ>
constexpr int dq_smem_floats() {
  // the chunk buffers share their space with the [BK][16·NJ] slice of K
  return (CHUNK_FLOATS > BK * 16 * NJ ? CHUNK_FLOATS : BK * 16 * NJ) + TILE_FLOATS;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int BH,
           int H, int S, int D, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
           Strides dvs, float scale, int causal) {
  constexpr int DO = 16 * NJ;  // output columns of this block
  constexpr int SLICE_FLOATS = 2 * BQ * DO;
  extern __shared__ float smem[];
  float* sQc = smem;
  float* sKc = sQc + BQ * (DC + 1);
  float* sdOc = sKc + BK * (DC + 1);
  float* sVc = sdOc + BQ * (DC + 1);
  float* sQs = smem;  // [BQ][DO], over the chunk buffers
  float* sdOs = smem + BQ * DO;
  float* sP = smem + (CHUNK_FLOATS > SLICE_FLOATS ? CHUNK_FLOATS : SLICE_FLOATS);
  float* sdS = sP + TILE_FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x % BH;
  const int k_tile = blockIdx.x / BH;  // causal: the low key tiles see the most queries
  const int k0 = k_tile * BK;
  const int b = bh / H;
  const int h = bh % H;
  const int d_out0 = blockIdx.y * DO;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;

  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  const int n_qt = (S + BQ - 1) / BQ;
  // causal: query tiles wholly above the diagonal see none of these keys
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    float s[4][4], dp[4][4];
    scores_and_dp<T>(qb, kb, dob, vb, qs, ks, dos, vs, q0, k0, S, D, sQc, sKc, sdOc, sVc, s,
                     dp, tid, tx, ty);
    p_and_ds<T>(s, dp, lse_bh, delta_bh, q0, k0, S, scale, causal, sP, sdS, tx, ty);
    stage_slice<T, DO>(qb, qs, q0, d_out0, S, D, sQs, tid);
    stage_slice<T, DO>(dob, dos, q0, d_out0, S, D, sdOs, tid);
    __syncthreads();
    // dV[kr][c] += Σ_q p[q][kr]·dO[q][c];  dK[kr][c] += Σ_q dS[q][kr]·Q[q][c]
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pk[4], dsk[4], gv[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = sP[qq * (BK + 1) + ty + 16 * i];
        dsk[i] = sdS[qq * (BK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        gv[j] = sdOs[qq * DO + tx + 16 * j];
        qv[j] = sQs[qq * DO + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(pk[i], gv[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsk[i], qv[j], acc_k[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    T* dkrow = dk + b * dks.b + kj * dks.s + h * dks.h;
    T* dvrow = dv + b * dvs.b + kj * dvs.s + h * dvs.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int di = d_out0 + tx + 16 * j;
      if (di < D) {
        dkrow[di * dks.d] = from_f32<T>(acc_k[i][j]);
        dvrow[di * dvs.d] = from_f32<T>(acc_v[i][j]);
      }
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int BH, int H, int S, int D,
          Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
          int causal) {
  constexpr int DO = 16 * NJ;
  extern __shared__ float smem[];
  float* sQc = smem;
  float* sKc = sQc + BQ * (DC + 1);
  float* sdOc = sKc + BK * (DC + 1);
  float* sVc = sdOc + BQ * (DC + 1);
  float* sKs = smem;  // [BK][DO], over the chunk buffers
  float* sdS = smem + (CHUNK_FLOATS > BK * DO ? CHUNK_FLOATS : BK * DO);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int q_tile = n_qt - 1 - blockIdx.x / BH;  // heaviest causal tiles first
  const int q0 = q_tile * BQ;
  const int b = bh / H;
  const int h = bh % H;
  const int d_out0 = blockIdx.y * DO;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[4][4], dp[4][4];
    scores_and_dp<T>(qb, kb, dob, vb, qs, ks, dos, vs, q0, k0, S, D, sQc, sKc, sdOc, sVc, s,
                     dp, tid, tx, ty);
    p_and_ds<T>(s, dp, lse_bh, delta_bh, q0, k0, S, scale, causal, nullptr, sdS, tx, ty);
    stage_slice<T, DO>(kb, ks, k0, d_out0, S, D, sKs, tid);
    __syncthreads();
    // dQ[qr][c] += Σ_k dS[qr][k]·K[k][c]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sdS[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bk[j] = sKs[kk * DO + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    T* row = dq + b * dqs.b + qi * dqs.s + h * dqs.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int di = d_out0 + tx + 16 * j;
      if (di < D) row[di * dqs.d] = from_f32<T>(acc[i][j]);
    }
  }
}

// The shared-memory attribute is set at an instantiation's first launch only,
// so a launch inside CUDA-graph capture makes no call but the launch itself.
template <typename T, int NJ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                       int S, int D, Strides qs, Strides ks, Strides vs, Strides dos,
                       Strides dks, Strides dvs, float scale, int causal, cudaStream_t stream) {
  constexpr int DO = 16 * NJ;
  const int smem = dkv_smem_floats<NJ>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkv_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int BH = B * H;
  const long long n_kt = (S + BK - 1) / BK;
  dim3 grid((unsigned)(n_kt * BH), (unsigned)((D + DO - 1) / DO));
  dkv_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), BH,
      H, S, D, qs, ks, vs, dos, dks, dvs, scale, causal);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int H, int S,
                      int D, Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                      float scale, int causal, cudaStream_t stream) {
  constexpr int DO = 16 * NJ;
  const int smem = dq_smem_floats<NJ>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int BH = B * H;
  const long long n_qt = (S + BQ - 1) / BQ;
  dim3 grid((unsigned)(n_qt * BH), (unsigned)((D + DO - 1) / DO));
  dq_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), BH, H, S, D, qs, ks, vs,
      dos, dqs, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_dtype(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                      int S, int D, Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dks, Strides dvs, float scale, int causal, cudaStream_t st) {
  if (D <= 32)
    return launch_dkv<T, 2>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, qs, ks, vs, dos,
                            dks, dvs, scale, causal, st);
  if (D <= 64)
    return launch_dkv<T, 4>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, qs, ks, vs, dos,
                            dks, dvs, scale, causal, st);
  return launch_dkv<T, 8>(q, k, v, dout, lse, delta, dk, dv, B, H, S, D, qs, ks, vs, dos, dks,
                          dvs, scale, causal, st);
}

template <typename T>
cudaError_t dq_dtype(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int B, int H, int S, int D,
                     Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
                     int causal, cudaStream_t st) {
  if (D <= 32)
    return launch_dq<T, 2>(q, k, v, dout, lse, delta, dq, B, H, S, D, qs, ks, vs, dos, dqs,
                           scale, causal, st);
  if (D <= 64)
    return launch_dq<T, 4>(q, k, v, dout, lse, delta, dq, B, H, S, D, qs, ks, vs, dos, dqs,
                           scale, causal, st);
  return launch_dq<T, 8>(q, k, v, dout, lse, delta, dq, B, H, S, D, qs, ks, vs, dos, dqs,
                         scale, causal, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, shared by q, k, v, dO and the
// gradients. Strides are in elements, in the order batch, seq, head, head-dim,
// for q, k, v, dO, dK and dV. lse and delta are [B, H, S] float32, contiguous.
// Returns the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int dtype, int B, int H, int S, int D,
    long long qsb, long long qss, long long qsh, long long qsd, long long ksb, long long kss,
    long long ksh, long long ksd, long long vsb, long long vss, long long vsh, long long vsd,
    long long osb, long long oss, long long osh, long long osd, long long dksb,
    long long dkss, long long dksh, long long dksd, long long dvsb, long long dvss,
    long long dvsh, long long dvsd, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd}, vs{vsb, vss, vsh, vsd};
  const Strides dos{osb, oss, osh, osd}, dks{dksb, dkss, dksh, dksd};
  const Strides dvs{dvsb, dvss, dvsh, dvsd};
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = dkv_dtype<float>(q, k, v, dout, lse_f, delta_f, dk, dv, B, H, S, D, qs, ks, vs,
                             dos, dks, dvs, scale, causal, st);
      break;
    case 1:
      err = dkv_dtype<__nv_bfloat16>(q, k, v, dout, lse_f, delta_f, dk, dv, B, H, S, D, qs, ks,
                                     vs, dos, dks, dvs, scale, causal, st);
      break;
    case 2:
      err = dkv_dtype<__half>(q, k, v, dout, lse_f, delta_f, dk, dv, B, H, S, D, qs, ks, vs,
                              dos, dks, dvs, scale, causal, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int dtype, int B, int H, int S, int D, long long qsb,
    long long qss, long long qsh, long long qsd, long long ksb, long long kss, long long ksh,
    long long ksd, long long vsb, long long vss, long long vsh, long long vsd, long long osb,
    long long oss, long long osh, long long osd, long long dqsb, long long dqss,
    long long dqsh, long long dqsd, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd}, vs{vsb, vss, vsh, vsd};
  const Strides dos{osb, oss, osh, osd}, dqs{dqsb, dqss, dqsh, dqsd};
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = dq_dtype<float>(q, k, v, dout, lse_f, delta_f, dq, B, H, S, D, qs, ks, vs, dos, dqs,
                            scale, causal, st);
      break;
    case 1:
      err = dq_dtype<__nv_bfloat16>(q, k, v, dout, lse_f, delta_f, dq, B, H, S, D, qs, ks, vs,
                                    dos, dqs, scale, causal, st);
      break;
    case 2:
      err = dq_dtype<__half>(q, k, v, dout, lse_f, delta_f, dq, B, H, S, D, qs, ks, vs, dos,
                             dqs, scale, causal, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
