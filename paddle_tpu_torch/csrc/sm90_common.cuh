// Shared pieces of the port's Hopper (sm_90a) kernels: TMA tensor maps and
// loads, mbarriers, wgmma with 128-byte-swizzled shared-memory descriptors.
//
// Used by flash_attention_fwd_sm90.cu, flash_attention_bwd_dkv_sm90.cu,
// flash_attention_bwd_dq_sm90.cu and, through tf32x3.cuh,
// flash_attention_fwd_tf32.cu and flash_attention_bwd_tf32.cu.
// Conventions every user keeps:
//   - A tile in shared memory is one or more sub-tiles 128 bytes wide (64
//     16-bit or 32 f32 elements), each `rows` rows of 128 bytes, written by
//     TMA with CU_TENSOR_MAP_SWIZZLE_128B and starting on a 1024-byte
//     boundary, so the descriptors below need no base offset.
//   - wgmma operands come from TMA-written shared memory or from registers.
//     No thread writes shared memory that wgmma reads; where one does,
//     fence_proxy_async() must come between the write and the wgmma.
//   - Accumulators stay in registers between wgmma_commit() and wgmma_wait();
//     fence_operand() on them (and on register A fragments) before the first
//     wgmma and after the wait keeps the compiler from moving their reads or
//     writes across the asynchronous product.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver entry is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

// Element strides of a [B, S, H, D] tensor.
struct Strides {
  long long b, s, h, d;
};

// ----------------------------------------------------------------------------
// Host: tensor maps
// ----------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (at the first, eager,
// launch), so the build needs no -lcuda and a CUDA-graph capture makes no
// runtime call but the launch.
inline cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// Error code a C entry returns when cuTensorMapEncodeTiled refuses a map:
// ENCODE_ERROR_BASE + the CUresult, above every cudaError_t.
constexpr int ENCODE_ERROR_BASE = 100000;

// A TMA map of one [B, S, H, D] tensor, for tiles of `rows` sequence
// positions x 128 bytes of head dim (64 16-bit or 32 f32 elements) of one
// (batch, head). The map's dims are the head dim first, then H, S and B
// ordered by stride (a size-1 dim gets a stride past the others: its
// coordinate is always 0); `slot_*` say where each coordinate goes. Columns
// past D and rows past S read as zeros.
struct TileMap {
  CUtensorMap map;
  int slot_h, slot_s, slot_b;
};

inline int make_map(TileMap* tm, const void* base, CUtensorMapDataType type, int elem_bytes,
                    int B, int S, int H, int D, Strides st, int rows) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return (int)err;
  long long size[3] = {H, S, B};
  long long stride[3] = {st.h, st.s, st.b};
  long long reach = D;  // elements spanned by the dims of size > 1
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1 && stride[i] * size[i] > reach) reach = stride[i] * size[i];
  reach = (reach + 7) / 8 * 8;
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = reach * (i + 1);
  int order[3] = {0, 1, 2};  // insertion sort of H, S, B by stride
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides_bytes[3];
  cuuint32_t box[4] = {(cuuint32_t)(128 / elem_bytes), 1, 1, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  int* slot[3] = {&tm->slot_h, &tm->slot_s, &tm->slot_b};
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];
    dims[i + 1] = (cuuint64_t)size[which];
    strides_bytes[i] = (cuuint64_t)(stride[which] * elem_bytes);
    *slot[which] = i + 1;
    if (which == 1) box[i + 1] = (cuuint32_t)rows;
  }
  CUresult res = encode(&tm->map, type, 4, const_cast<void*>(base), dims, strides_bytes, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR_BASE + (int)res;
}

// The map of a bf16 (fp16 if `f16`) tensor: 64-element sub-tiles.
inline int make_tile_map(TileMap* tm, const void* base, bool f16, int B, int S, int H, int D,
                         Strides st, int rows) {
  const CUtensorMapDataType type =
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return make_map(tm, base, type, 2, B, S, H, D, st, rows);
}

// The map of an f32 tensor: 32-element sub-tiles.
inline int make_tile_map_f32(TileMap* tm, const void* base, int B, int S, int H, int D,
                             Strides st, int rows) {
  return make_map(tm, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, S, H, D, st, rows);
}

// ----------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); a
// __syncthreads() after it makes them visible to the other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A phase that never
// completes (a lost TMA transaction, a miscounted arrival) traps after ~2^24
// polls, seconds, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA tile load of `tm` at head-dim column d0, sequence row s0 of (b, h),
// into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_tile(const TileMap* tm, uint64_t* bar, void* dst, int d0,
                                              int b, int s0, int h) {
  int c1 = tm->slot_h == 1 ? h : tm->slot_s == 1 ? s0 : b;
  int c2 = tm->slot_h == 2 ? h : tm->slot_s == 2 ? s0 : b;
  int c3 = tm->slot_h == 3 ? h : tm->slot_s == 3 ? s0 : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&tm->map)), "r"(d0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// ----------------------------------------------------------------------------
// Device: wgmma
// ----------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1, bits
// 62-63). Start address and offsets are in 16-byte units.
//   K-major operand (the reduction dim contiguous; Q, K, V, dO as A, or as B
//   of a product over the head dim): 8-row groups of 128-byte rows, SBO =
//   1024 B between groups; LBO unused. Stepping 16 elements along the
//   reduction dim adds 32 bytes to the start, within the 128-byte row.
//   MN-major operand (the output dim contiguous; V, dO, Q as B of a product
//   over the sequence): SBO = 1024 B between groups of 8 reduction rows,
//   LBO = the bytes between 64-column sub-tiles. Stepping 16 rows along the
//   reduction dim adds 2048 bytes.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo_bytes) {
  uint64_t desc = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  desc |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  desc |= (uint64_t)(1024 >> 4) << 32;
  desc |= (uint64_t)1 << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two f32 values rounded to T and packed, the lower column in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// A fragments of a 64 x (16·KS) A operand from a 64-row f32 accumulator of
// the same shape (m64n(16·KS)): column block kk of the accumulator, rounded
// to T, is the register A of the kk-th k16 step. The accumulator's layout
// (thread t of warp w holds rows 16w + t/4 and +8, columns 8j + 2(t%4) and
// +1) is the A fragment's, so no data moves between threads.
template <typename T, int KS>
__device__ __forceinline__ void acc_to_a(const float (&d)[KS * 8], uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack2<T>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define PADDLE_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B))
// D[64 x 64] = A[64 x 16]·B[16 x 64] (+ D if scale_d); A and B by descriptor.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    PADDLE_WGMMA_SS_N64("f16");
  } else {
    PADDLE_WGMMA_SS_N64("bf16");
  }
}
#undef PADDLE_WGMMA_SS_N64

#define PADDLE_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B))
// D[64 x 64] = A[64 x 16]·B[16 x 64] (+ D if scale_d); A from registers (four
// 16-bit pairs, the accumulator fragment layout), B by descriptor.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    PADDLE_WGMMA_RS_N64("f16");
  } else {
    PADDLE_WGMMA_RS_N64("bf16");
  }
}
#undef PADDLE_WGMMA_RS_N64

#define PADDLE_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B))
// D[64 x 128] = A[64 x 16]·B[16 x 128] (+ D if scale_d); A from registers (four
// 16-bit pairs, the accumulator fragment layout), B by descriptor.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    PADDLE_WGMMA_RS_N128("f16");
  } else {
    PADDLE_WGMMA_RS_N128("bf16");
  }
}
#undef PADDLE_WGMMA_RS_N128

// wgmma_rs over the two widths the kernels use, N = the padded head dim, 64 or 128.
template <typename T, int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_rs_n64<T, TRANS_B>(d, a, desc_b, scale_d);
  else
    wgmma_rs_n128<T, TRANS_B>(d, a, desc_b, scale_d);
}

}  // namespace sm90
