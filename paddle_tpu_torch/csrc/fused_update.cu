// Fused optimizer updates for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces: paddle_tpu/ops/pallas/fused_update.py::_sgd_kernel, ::_momentum_kernel
// and ::_adam_kernel, the Pallas TPU kernels behind FLAGS_pallas_fused_update. Each
// runs one parameter's whole elementwise update chain in one pass over its
// buffers, in the stock rule's formulas and operand order:
//
//   SGD       p' = p - lr * (g + wd*p)
//   Momentum  g  = g + wd*p;  v' = mu*v + g;  p' = p - lr * (v' or g + mu*v')
//   Adam      g  = g + wd*p;  m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g
//             p' = p - lr_t*m' / (sqrt(v') + eps)
//
// (the decay term only when wd != 0). The step's non-finite sentinel gates the
// update in the kernel: when it is set, no thread writes, so p and the state
// keep their values, as the Pallas kernel's where(bad, old, new) keeps them.
//
// Numbers: the kernels must equal the rule's PyTorch ops on the card bit for
// bit. PyTorch rounds after every op; nvcc at -O3 contracts a*b + c into one
// fused multiply-add, which rounds once. So every operation is written with
// the round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn), which the compiler never contracts. The hyper-parameters arrive
// as floats that the caller rounded once from doubles, with (1 - b1) and
// (1 - b2) computed on the host in double, as PyTorch rounds a Python scalar.
// lr (lr_t for Adam) and the sentinel are read through device pointers, so a
// step never reads them back to the host and a CUDA graph can capture it.
//
// What bounds it on this card: bytes. Per element Adam reads p, g, m, v and
// writes p, m, v (28 bytes) for ~12 flops, Momentum moves 20 bytes and SGD 12,
// far below the H100's ridge point, so the bound is HBM at 3.35 TB/s. This
// design: a grid-stride loop with 64-bit indices, 16-byte float4 loads and
// stores when every buffer is 16-byte aligned (a scalar tail covers n % 4),
// scalar accesses otherwise; the outputs are written in place over p, m and v,
// so each buffer is read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

struct SgdOp {
  float wd;
  int decay;
  __device__ __forceinline__ void operator()(float lr, float& p, float g, float&, float&) const {
    if (decay) g = __fadd_rn(g, __fmul_rn(wd, p));
    p = __fsub_rn(p, __fmul_rn(lr, g));
  }
};

struct MomentumOp {
  float mu, wd;
  int nesterov, decay;
  __device__ __forceinline__ void operator()(float lr, float& p, float g, float& v,
                                             float&) const {
    if (decay) g = __fadd_rn(g, __fmul_rn(wd, p));
    v = __fadd_rn(__fmul_rn(mu, v), g);
    const float step = nesterov ? __fadd_rn(g, __fmul_rn(mu, v)) : v;
    p = __fsub_rn(p, __fmul_rn(lr, step));
  }
};

struct AdamOp {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int decay;
  __device__ __forceinline__ void operator()(float lr_t, float& p, float g, float& m,
                                             float& v) const {
    if (decay) g = __fadd_rn(g, __fmul_rn(wd, p));
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(one_minus_b1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(one_minus_b2, __fmul_rn(g, g)));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, m), __fadd_rn(__fsqrt_rn(v), eps)));
  }
};

// NS state buffers (0, 1 or 2) beside p and g; s0 and s1 are unused past NS.
template <int NS, class Op>
__global__ void __launch_bounds__(THREADS)
update_kernel(Op op, float* __restrict__ p, const float* __restrict__ g,
              float* __restrict__ s0, float* __restrict__ s1, long long n,
              const float* __restrict__ lr_ptr, const unsigned char* __restrict__ bad,
              int vec) {
  if (bad != nullptr && *bad != 0) return;  // rescued step: write nothing
  const float lr = *lr_ptr;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* a4 = reinterpret_cast<float4*>(s0);
    float4* b4 = reinterpret_cast<float4*>(s1);
    for (long long i = first; i < n4; i += stride) {
      float4 pv = p4[i];
      const float4 gv = g4[i];
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
      if (NS > 0) av = a4[i];
      if (NS > 1) bv = b4[i];
      op(lr, pv.x, gv.x, av.x, bv.x);
      op(lr, pv.y, gv.y, av.y, bv.y);
      op(lr, pv.z, gv.z, av.z, bv.z);
      op(lr, pv.w, gv.w, av.w, bv.w);
      p4[i] = pv;
      if (NS > 0) a4[i] = av;
      if (NS > 1) b4[i] = bv;
    }
    tail = n4 << 2;
  }
  for (long long i = tail + first; i < n; i += stride) {
    float pv = p[i], av = 0.f, bv = 0.f;
    if (NS > 0) av = s0[i];
    if (NS > 1) bv = s1[i];
    op(lr, pv, g[i], av, bv);
    p[i] = pv;
    if (NS > 0) s0[i] = av;
    if (NS > 1) s1[i] = bv;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <int NS, class Op>
int launch(const Op& op, float* p, const float* g, float* s0, float* s1, long long n,
           const float* lr, const unsigned char* bad, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(p) && aligned16(g) && (NS < 1 || aligned16(s0)) &&
                  (NS < 2 || aligned16(s1));
  const long long work = vec ? (n + 3) / 4 : n;
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  long long blocks = (work + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  update_kernel<NS, Op><<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      op, p, g, s0, s1, n, lr, bad, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns the cudaError_t of the launch.
// `lr` points at one f32 on the device (lr_t for Adam); `bad` at one bool, or
// is null when the update is not gated.

extern "C" int paddle_fused_sgd(float* p, const float* g, long long n, const float* lr,
                                const unsigned char* bad, float wd, int decay, void* stream) {
  return launch<0>(SgdOp{wd, decay}, p, g, nullptr, nullptr, n, lr, bad, stream);
}

extern "C" int paddle_fused_momentum(float* p, const float* g, float* v, long long n,
                                     const float* lr, const unsigned char* bad, float mu,
                                     int nesterov, float wd, int decay, void* stream) {
  return launch<1>(MomentumOp{mu, wd, nesterov, decay}, p, g, v, nullptr, n, lr, bad, stream);
}

extern "C" int paddle_fused_adam(float* p, const float* g, float* m, float* v, long long n,
                                 const float* lr_t, const unsigned char* bad, float b1,
                                 float one_minus_b1, float b2, float one_minus_b2, float eps,
                                 float wd, int decay, void* stream) {
  return launch<2>(AdamOp{b1, one_minus_b1, b2, one_minus_b2, eps, wd, decay}, p, g, m, v, n,
                   lr_t, bad, stream);
}
