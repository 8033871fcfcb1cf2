// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel, the Pallas
// TPU kernel behind the GPT full-sequence forward. It computes what that kernel
// computes: O = softmax(Q·Kᵀ·scale [causal]) · V and the row logsumexp, with the
// running max m, the denominator l and the accumulator kept in f32; key tiles
// wholly above the diagonal are skipped, the diagonal tile is masked to -1e30,
// p is rounded to the input type before P·V, and l == 0 is guarded.
//
// What bounds it on this card: at the GPT-2 345M shape (S = 1024, D = 64) the
// work is 4·D FLOP per (query, key) pair against 4·D·elem bytes of Q, K, V and O
// per row, so with S = 1024 the function sits far above the H100's ridge point:
// it is bound by arithmetic, not by HBM. The tensor cores (wgmma) would give that
// arithmetic at 989 TFLOP/s in bf16; this first design uses f32 FMAs on the
// CUDA cores (67 TFLOP/s peak), so it is bound by the CUDA cores' FMA rate and
// by the shared-memory reads that feed them.
//
// This design: one block of 256 threads per (64-row query tile, batch·head,
// 128-wide slice of the head dim). The block streams 64-key tiles; for each it
// stages Q and K in 32-wide head-dim chunks in shared memory as f32, each thread
// accumulates a 4x4 register tile of S, the row max/sum reduce across the 16
// threads that share a row with warp shuffles, P goes to shared memory, and V
// is staged over the Q/K buffer for the P·V product into a 4x(16·NJ) register
// accumulator. Each thread does 16 FMAs for every 8 shared-memory loads. Q, K
// and V are read through their [B, S, H, D] strides (no transpose copies), a
// ragged tail of S or D is masked on load and store, and the heaviest causal
// query tiles are launched first so the tail of the grid is short. wgmma, TMA
// and a producer/consumer pipeline are for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int DC = 32;        // head-dim chunk staged for Q·Kᵀ
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr float NEG_INF = -1e30f;

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

// Element strides of a [B, S, H, D] tensor.
struct Strides {
  long long b, s, h, d;
};

template <int NJ>
constexpr int smem_floats() {
  // sQ [BQ][DC+1] and sK [BK][DC+1] share their space with sV [BK][16·NJ];
  // sP [BQ][BK+1] follows. The +1 columns keep neighbouring rows off one bank.
  return ((BQ + BK) * (DC + 1) > BK * 16 * NJ ? (BQ + BK) * (DC + 1) : BK * 16 * NJ) +
         BQ * (BK + 1);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int BH, int H, int S, int D,
           Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int DO = 16 * NJ;  // output columns of this block
  constexpr int QK_FLOATS = (BQ + BK) * (DC + 1);
  constexpr int V_FLOATS = BK * DO;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = smem + BQ * (DC + 1);
  float* sV = smem;
  float* sP = smem + (QK_FLOATS > V_FLOATS ? QK_FLOATS : V_FLOATS);

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

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;

    // S = Q · Kᵀ over the head dim, one staged chunk at a time
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
#pragma unroll
      for (int idx = tid; idx < BQ * DC; idx += THREADS) {
        const int r = idx / DC;
        const int c = idx % DC;
        const int di = d0 + c;
        const int qi = q0 + r;
        const int kj = k0 + r;
        sQ[r * (DC + 1) + c] = (qi < S && di < D) ? to_f32(qb[qi * qs.s + di * qs.d]) : 0.f;
        sK[r * (DC + 1) + c] = (kj < S && di < D) ? to_f32(kb[kj * ks.s + di * ks.d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * (DC + 1) + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * (DC + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
      __syncthreads();
    }

    // scale, mask, online softmax; the 16 lanes tx = 0..15 share each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    // stage V over the Q/K buffer: every thread has passed the barrier that
    // closed the last Q·Kᵀ chunk
#pragma unroll
    for (int idx = tid; idx < BK * DO; idx += THREADS) {
      const int r = idx / DO;
      const int c = idx % DO;
      const int kj = k0 + r;
      const int di = d_out0 + c;
      sV[r * DO + c] = (kj < S && di < D) ? to_f32(vb[kj * vs.s + di * vs.d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * DO + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int di = d_out0 + tx + 16 * j;
      if (di < D) orow[di * os.d] = from_f32<T>(acc[i][j] / safe_l);
    }
    if (blockIdx.y == 0 && tx == 0) lse[(long long)bh * S + qi] = m[i] + logf(safe_l);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int S, int D, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr int DO = 16 * NJ;
  const int smem = smem_floats<NJ>() * (int)sizeof(float);
  // set at the instantiation's first launch only, so a launch inside CUDA-graph
  // capture makes no call but the launch itself
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int BH = B * H;
  const long long n_qt = (S + BQ - 1) / BQ;
  dim3 grid((unsigned)(n_qt * BH), (unsigned)((D + DO - 1) / DO));
  fwd_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, BH, H, S, D, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int H, int S, int D, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, int causal, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 2>(q, k, v, o, lse, B, H, S, D, qs, ks, vs, os, scale, causal, stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, lse, B, H, S, D, qs, ks, vs, os, scale, causal, stream);
  return launch<T, 8>(q, k, v, o, lse, B, H, S, D, qs, ks, vs, os, scale, causal, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Strides are in elements, in the
// order batch, seq, head, head-dim. lse is [B, H, S] float32, contiguous.
// Returns the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B,
    int H, int S, int D, long long qsb, long long qss, long long qsh, long long qsd,
    long long ksb, long long kss, long long ksh, long long ksd, long long vsb,
    long long vss, long long vsh, long long vsd, long long osb, long long oss,
    long long osh, long long osd, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd};
  const Strides vs{vsb, vss, vsh, vsd}, os{osb, oss, osh, osd};
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_dtype<float>(q, k, v, o, lse_f, B, H, S, D, qs, ks, vs, os, scale, causal, st);
      break;
    case 1:
      err = launch_dtype<__nv_bfloat16>(q, k, v, o, lse_f, B, H, S, D, qs, ks, vs, os, scale,
                                        causal, st);
      break;
    case 2:
      err = launch_dtype<__half>(q, k, v, o, lse_f, B, H, S, D, qs, ks, vs, os, scale, causal,
                                 st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
