// Helpers shared by the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace ptt {

// One kernel's dynamic shared-memory limit per device, raised only when a
// launch needs more than every earlier one, so cudaFuncSetAttribute runs
// once per (kernel, size) and not on every launch.  Keep one static
// instance per kernel instantiation.
struct SmemLimit {
  static constexpr int kMaxDevices = 64;
  std::atomic<size_t> allowed[kMaxDevices];
  std::mutex mu;

  template <typename Kernel>
  cudaError_t reserve(Kernel kernel, size_t bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices)
      return cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (allowed[dev].load(std::memory_order_acquire) >= bytes)
      return cudaSuccess;
    std::lock_guard<std::mutex> lock(mu);  // the limit only grows
    if (allowed[dev].load(std::memory_order_relaxed) >= bytes)
      return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) allowed[dev].store(bytes, std::memory_order_release);
    return err;
  }
};

// The reference kernels mask with a large finite negative, not -inf, so a
// row whose tile is fully masked stays NaN-free (flash_attention.py:36).
// Such a tile gives p = 1 on each of its keys until a live key rescales
// them away (alpha = 0); a row with no live key at all (a key-padding bias
// of -1e30 on every key) keeps them, so its output is the mean of V and
// its lse kNegInf, as in the reference.  Keys past the sequence are not
// keys: they score -INFINITY (p = 0 exactly) in the forward and are
// skipped in the backward.
constexpr float kNegInf = -1e30f;
// kNegInf in the base-2 domain of the Hopper kernels: kNegInf * log2(e)
// rounded to float32.  A key bias of -1e30 times log2(e) is this value, and
// the round trip through lse (x ln 2 to store, x log2(e) to read back) is
// exact, so a row with no live key gets p = 1 in the backward as the
// reference's p = exp(-1e30 - lse) does.
constexpr float kNegInf2 = -1.442695e30f;

// Segment ids and per-key bias of K1 and K3 (the reference's `segments=`
// and `kbias=`), both optional and shared by every head: seg [b, s] int32,
// kbias [b, s] float32.  A query attends only to keys of its own id; kbias
// adds one value to every score of its key, after the scale and before the
// mask.
struct Masking {
  const int* seg;
  const float* kbias;

  // Whether there is anything to mask: the kernels take a template flag
  // from this, so a launch with neither runs the unmasked instructions.
  bool on() const { return seg != nullptr || kbias != nullptr; }
};

// The segment id of row i of batch b (0 without segments), through the
// read-only path.
__device__ __forceinline__ int seg_of(const Masking& mk, int b, int s, int i) {
  return mk.seg != nullptr ? __ldg(mk.seg + (size_t)b * s + i) : 0;
}

// The key bias of key j of batch b (0 without one).
__device__ __forceinline__ float bias_of(const Masking& mk, int b, int s,
                                         int j) {
  return mk.kbias != nullptr ? __ldg(mk.kbias + (size_t)b * s + j) : 0.f;
}

// The ring-attention operands of K1 and K3 (the reference's `q_offset=`,
// `carry=` and `out_dtype=`), read only by the kernels' kRing
// instantiations, so a launch without them runs the instructions it ran
// before they existed.
//  - q_off [s / bq] int32: the absolute position of the first row of each
//    bq-row block of q (bq a multiple of 128, so no kernel tile straddles
//    two blocks); null: row i sits at position i.  Key j sits at j.
//  - c_out [b, s, h, d] f32 and c_lse [b, h, s] f32 (K1): a partial
//    (out, lse) the launch merges its keys onto; null: none.
//  - out32 (K1): write the output in f32 here, not in the input dtype.
struct Ring {
  const int* q_off;
  int bq;
  const float* c_out;
  const float* c_lse;
  float* out32;

  bool on() const {
    return q_off != nullptr || c_out != nullptr || out32 != nullptr;
  }
};

// Which instantiation of a kernel a launch takes: 0 the plain one, 1 the
// masked one, 2 the ring one (the two flags never combine).
inline int variant(const Masking& mk, const Ring& rg) {
  return rg.on() ? 2 : mk.on() ? 1 : 0;
}

// The shift that puts row qi of the tile starting at row q0 at key
// position qpos + qi: the tile's block start less its first row.
__device__ __forceinline__ int ring_qpos(const Ring& rg, int q0) {
  return rg.q_off != nullptr ? __ldg(rg.q_off + q0 / rg.bq) + q0 % rg.bq - q0
                             : 0;
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The reference feeds the probabilities to the P.V product in the value
// dtype (`p.astype(v.dtype)`), while the softmax denominator sums them in
// f32.  Rounding through T here keeps the kernels on the same numbers.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (bf16 `mma.sync` m16n8k16, f32 accumulation).
// ---------------------------------------------------------------------------

// Threads of a tensor-core block: 4 warps, each owning 16 rows of a 64-row
// tile.
constexpr int kMmaThreads = 128;

// d[16x8] += a[16x16] . b[16x8], bf16 inputs, f32 accumulators.  Fragment
// layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1]}; each 32-bit register holds two bf16, the lower index low.
// So the accumulators of two neighbouring 8-column score tiles, packed to
// bf16, are the A fragment of one 16-deep step of the next product.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of head `hh` of x ([b, s, nh, d]) into dst
// ([64][D + 8] bf16, the padding keeps fragment loads conflict-free), zero
// past s and past d; the block's kMmaThreads share the copy.  `vec`:
// 16-byte loads.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ x,
                                          int b, int row0, int s, int nh,
                                          int hh, int d, bool vec) {
  constexpr int ST = D + 8;
  if (vec) {
    constexpr int NV = D / 8;
    for (int e = threadIdx.x; e < 64 * NV; e += kMmaThreads) {
      const int r = e / NV, c = (e % NV) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < s && c < d)
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t)(b * s + row0 + r) * nh + hh) * d + c);
      *reinterpret_cast<uint4*>(dst + r * ST + c) = val;
    }
    return;
  }
  for (int e = threadIdx.x; e < 64 * D; e += kMmaThreads) {
    const int r = e / D, c = e % D;
    dst[r * ST + c] = (row0 + r < s && c < d)
                          ? x[((size_t)(b * s + row0 + r) * nh + hh) * d + c]
                          : __float2bfloat16(0.f);
  }
}

// The B fragment of an m16n8k16 step whose 16 B rows are rows
// [r0, r0 + 16) of a row-major bf16 tile x ([rows][ST], read as 16-bit
// words) and whose column is c: b0 = {x[r0 + 2t][c], x[r0 + 2t + 1][c]},
// b1 = the same 8 rows further.
template <int ST>
__device__ __forceinline__ void b_rows(const unsigned short* x, int r0, int c,
                                       int t, uint32_t& b0, uint32_t& b1) {
  const unsigned short* p = x + (r0 + 2 * t) * ST + c;
  b0 = p[0] | ((uint32_t)p[ST] << 16);
  b1 = p[8 * ST] | ((uint32_t)p[9 * ST] << 16);
}

}  // namespace ptt
