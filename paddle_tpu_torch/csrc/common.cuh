// Helpers shared by the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr float kNegInf = -1e30f;

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

}  // namespace ptt
