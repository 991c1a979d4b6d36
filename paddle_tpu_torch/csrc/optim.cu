// The optimizer's multi-tensor passes: the Adam/AdamW update and the
// gradient unscale of `GradScaler` (paddle_tpu_torch/ops/optim.py).
//
// They replace XLA fusions, not Pallas kernels: the reference runs its
// per-parameter Adam math (paddle_tpu/optimizer/__init__.py:376-394) and
// its unscale (paddle_tpu/amp/__init__.py:228) inside its compiled step,
// where XLA fuses each tensor's chain into one pass.  The port's eager
// step ran ~15 torch ops per parameter instead.
//
// Design.  One launch covers every tensor of the step.  The host uploads,
// in one pinned copy, a table of per-tensor entries (pointers, numel,
// dtype, decay) and a chunk table: block i takes chunk chunks[i].index of
// tensor chunks[i].tensor (`CHUNK` elements, ops/optim.py), in vector steps of 8
// elements (two 16-byte loads of each float32 array, one of each 16-bit
// array) where every pointer of the tensor is 16-byte aligned, else
// element by element.
//
// Bound: bytes.  Adam reads the parameter (or its float32 master), m, v
// and the gradient and writes them back: 28 bytes per element for a
// float32 parameter or a bf16 one with a master; a few flops per element,
// far under the card's rate.
//
// Numerics: the reference's math in float32, one rounding per operation in
// its order.  The intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn)
// are never contracted into FMAs, so the kernel rounds where the plain
// version (`adam_multi_plain`) does.
//
// Beta powers: every block of a tensor reads the old beta1/beta2 powers
// and forms p * beta itself; a follow-up launch of one thread per tensor
// (`adam_pows_kernel`) then writes p * beta, so no block of the main launch
// reads a power another block has already advanced.
//
// found_inf: an optional device int.  When it is set, neither launch
// writes anything: the step is skipped on the device, with no host sync.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// One tensor of a launch; the layout of ops/optim.py's ENTRY_DTYPE.
struct TensorEntry {
  unsigned long long param;   // the parameter (the unscale reads only grad)
  unsigned long long master;  // float32 master weight, or 0
  unsigned long long m;       // float32 first moment
  unsigned long long v;       // float32 second moment
  unsigned long long grad;    // the gradient, in the parameter's dtype
  unsigned long long pow1;    // float32 beta1 power
  unsigned long long pow2;    // float32 beta2 power
  long long numel;
  float wd;                   // decay coefficient (0: none)
  int flags;
};
static_assert(sizeof(TensorEntry) == 72, "TensorEntry layout");

struct Chunk {
  int tensor;
  int index;
};

constexpr int kDtypeMask = 3;  // flags bits 0-1: 0 float32, 1 bf16, 2 fp16
constexpr int kL1 = 4;         // the decay term is coeff * sign(w)
constexpr int kDecoupled = 8;  // added to the update (AdamW), else to g
constexpr int kThreads = 256;
constexpr int kVec = 8;

struct AdamArgs {
  float b1, b2, omb1, omb2, eps;  // omb = 1 - beta, rounded on the host
};

__device__ __forceinline__ float to_f32(const void* p, long long i, int dt) {
  if (dt == 0) return static_cast<const float*>(p)[i];
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ float round_to(float x, int dt) {
  if (dt == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (dt == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ void store(void* p, long long i, int dt, float x) {
  if (dt == 0)
    static_cast<float*>(p)[i] = x;
  else if (dt == 1)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<__half*>(p)[i] = __float2half_rn(x);
}

// Eight consecutive elements from i (16-byte aligned).
__device__ __forceinline__ void load8(const void* p, long long i, int dt,
                                      float (&x)[kVec]) {
  if (dt == 0) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = q[0], b = q[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    return;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(
      static_cast<const unsigned short*>(p) + i);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (dt == 1)
      x[k] = __bfloat162float(__ushort_as_bfloat16(h[k]));
    else
      x[k] = __half2float(__ushort_as_half(h[k]));
  }
}

__device__ __forceinline__ void store8(void* p, long long i, int dt,
                                       const float (&x)[kVec]) {
  if (dt == 0) {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(p) + i);
    q[0] = make_float4(x[0], x[1], x[2], x[3]);
    q[1] = make_float4(x[4], x[5], x[6], x[7]);
    return;
  }
  uint4 raw;
  unsigned short* h = reinterpret_cast<unsigned short*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    h[k] = dt == 1 ? __bfloat16_as_ushort(__float2bfloat16_rn(x[k]))
                   : __half_as_ushort(__float2half_rn(x[k]));
  *reinterpret_cast<uint4*>(static_cast<unsigned short*>(p) + i) = raw;
}

__device__ __forceinline__ bool aligned16(unsigned long long p) {
  return (p & 15ull) == 0;
}

__device__ __forceinline__ float sign_of(float w) {
  return (float)((w > 0.f) - (w < 0.f));
}

// One element of the reference's update (optimizer/__init__.py:376-394).
__device__ __forceinline__ void adam_elem(float& w, float g, float& m, float& v,
                                          const AdamArgs& a, float wd, int flags,
                                          float bc1, float bc2, float lr) {
  const float dw = (flags & kL1) ? sign_of(w) : w;
  if (wd != 0.f && !(flags & kDecoupled)) g = __fadd_rn(g, __fmul_rn(wd, dw));
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(a.omb2, g), g));
  float upd = __fdiv_rn(__fdiv_rn(m, bc1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
  if (wd != 0.f && (flags & kDecoupled)) upd = __fadd_rn(upd, __fmul_rn(wd, dw));
  w = __fsub_rn(w, __fmul_rn(lr, upd));
}

__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const TensorEntry* __restrict__ tensors,
                  const Chunk* __restrict__ chunks, int chunk_size, AdamArgs a,
                  const float* __restrict__ lr_ptr, const int* __restrict__ found) {
  if (found != nullptr && *found) return;
  const Chunk c = chunks[blockIdx.x];
  const TensorEntry t = tensors[c.tensor];
  const long long start = (long long)c.index * chunk_size;
  const long long end = min(start + (long long)chunk_size, t.numel);
  const int dt = t.flags & kDtypeMask;
  const float lr = *lr_ptr;
  const float bc1 = __fsub_rn(1.f, __fmul_rn(*reinterpret_cast<const float*>(t.pow1), a.b1));
  const float bc2 = __fsub_rn(1.f, __fmul_rn(*reinterpret_cast<const float*>(t.pow2), a.b2));
  void* param = reinterpret_cast<void*>(t.param);
  float* master = reinterpret_cast<float*>(t.master);
  float* m = reinterpret_cast<float*>(t.m);
  float* v = reinterpret_cast<float*>(t.v);
  const void* grad = reinterpret_cast<const void*>(t.grad);

  long long scalar_from = start;
  if (aligned16(t.param) && aligned16(t.master) && aligned16(t.m) &&
      aligned16(t.v) && aligned16(t.grad)) {
    const long long vec_end = start + (end - start) / kVec * kVec;
    for (long long i = start + threadIdx.x * kVec; i < vec_end;
         i += kThreads * kVec) {
      float w[kVec], g[kVec], mm[kVec], vv[kVec];
      if (master != nullptr)
        load8(master, i, 0, w);
      else
        load8(param, i, dt, w);
      load8(grad, i, dt, g);
      load8(m, i, 0, mm);
      load8(v, i, 0, vv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        adam_elem(w[k], g[k], mm[k], vv[k], a, t.wd, t.flags, bc1, bc2, lr);
      store8(m, i, 0, mm);
      store8(v, i, 0, vv);
      if (master != nullptr) store8(master, i, 0, w);
      store8(param, i, dt, w);
    }
    scalar_from = vec_end;
  }
  for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    float w = master != nullptr ? master[i] : to_f32(param, i, dt);
    float mm = m[i], vv = v[i];
    adam_elem(w, to_f32(grad, i, dt), mm, vv, a, t.wd, t.flags, bc1, bc2, lr);
    m[i] = mm;
    v[i] = vv;
    if (master != nullptr) master[i] = w;
    store(param, i, dt, w);
  }
}

// The beta powers' step, after every block of the update has read them.
__global__ void adam_pows_kernel(const TensorEntry* __restrict__ tensors, int n,
                                 float b1, float b2, const int* __restrict__ found) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || (found != nullptr && *found)) return;
  float* p1 = reinterpret_cast<float*>(tensors[i].pow1);
  float* p2 = reinterpret_cast<float*>(tensors[i].pow2);
  *p1 = __fmul_rn(*p1, b1);
  *p2 = __fmul_rn(*p2, b2);
}

// grad *= 1 / scale in the grad's dtype (the reference multiplies by the
// inverse cast to that dtype: the product of two bf16 or fp16 values is
// exact in float32, so one rounding gives the dtype's product), then ORs
// "some element is not finite" into *found.
__global__ void __launch_bounds__(kThreads)
unscale_multi_kernel(const TensorEntry* __restrict__ tensors,
                     const Chunk* __restrict__ chunks, int chunk_size,
                     const float* __restrict__ scale, int* __restrict__ found) {
  const Chunk c = chunks[blockIdx.x];
  const TensorEntry t = tensors[c.tensor];
  const long long start = (long long)c.index * chunk_size;
  const long long end = min(start + (long long)chunk_size, t.numel);
  const int dt = t.flags & kDtypeMask;
  const float inv = round_to(__fdiv_rn(1.f, *scale), dt);
  void* grad = reinterpret_cast<void*>(t.grad);
  int bad = 0;
  long long scalar_from = start;
  if (aligned16(t.grad)) {
    const long long vec_end = start + (end - start) / kVec * kVec;
    for (long long i = start + threadIdx.x * kVec; i < vec_end;
         i += kThreads * kVec) {
      float g[kVec];
      load8(grad, i, dt, g);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        g[k] = round_to(__fmul_rn(g[k], inv), dt);
        bad |= !isfinite(g[k]);
      }
      store8(grad, i, dt, g);
    }
    scalar_from = vec_end;
  }
  for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    const float g = round_to(__fmul_rn(to_f32(grad, i, dt), inv), dt);
    bad |= !isfinite(g);
    store(grad, i, dt, g);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found = 1;
}

}  // namespace

// Adam/AdamW over every tensor of a table (`adam_multi` in ops/optim.py):
// `tensors` [n_tensors] TensorEntry and `chunks` [n_chunks] Chunk on the
// device, `lr` a float32 device scalar, `found_inf` an int32 device flag
// or null.  Returns a CUDA error code (0: launched).
extern "C" int ptt_adam_multi(const void* tensors, const void* chunks,
                              int n_tensors, int n_chunks, int chunk_size,
                              const void* lr, float b1, float b2, float omb1,
                              float omb2, float eps, const void* found_inf,
                              void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 || chunk_size <= 0 ||
      chunk_size % kVec != 0 || lr == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TensorEntry* t = static_cast<const TensorEntry*>(tensors);
  const int* found = static_cast<const int*>(found_inf);
  adam_multi_kernel<<<n_chunks, kThreads, 0, st>>>(
      t, static_cast<const Chunk*>(chunks), chunk_size,
      AdamArgs{b1, b2, omb1, omb2, eps}, static_cast<const float*>(lr), found);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adam_pows_kernel<<<(n_tensors + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      t, n_tensors, b1, b2, found);
  return (int)cudaGetLastError();
}

// GradScaler.unscale_ over every gradient of a table (`unscale_multi`):
// the entries' `grad`, `numel` and dtype are read; `scale` a float32
// device scalar, `found_inf` an int32 device flag the launch may set.
extern "C" int ptt_unscale_multi(const void* tensors, const void* chunks,
                                 int n_chunks, int chunk_size, const void* scale,
                                 void* found_inf, void* stream) {
  if (n_chunks <= 0 || chunk_size <= 0 || chunk_size % kVec != 0 ||
      scale == nullptr || found_inf == nullptr)
    return (int)cudaErrorInvalidValue;
  unscale_multi_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorEntry*>(tensors), static_cast<const Chunk*>(chunks),
      chunk_size, static_cast<const float*>(scale), static_cast<int*>(found_inf));
  return (int)cudaGetLastError();
}
