// K2 `paged_decode_fused`: paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fused_paged_decode_forward`
// (paddle_tpu/ops/flash_attention.py:813, inline kernel :856).  Reads the
// K/V page arena THROUGH the per-slot page tables inside the kernel, so the
// dense per-sequence copy that the gather path writes (`paged_gather_kv`)
// never exists.
//
// Bound on an H100: decode attention does 4*R*d FLOPs per key row against
// 2*d*2 bytes of K and V (bf16) -- about R FLOP per byte, far below the
// card's ~295 FLOP/byte balance point -- so it is bound by the bytes of the
// pages it must read: each slot's live K/V rows of every kv head, once.  The
// design answers that bound:
//  - one block per (slot, kv head, split) holds the whole GQA group x window
//    (R = rep * sq query rows), so each K/V page tile is read from device
//    memory once per group, never once per q head;
//  - pages past the newest visible position (pos + sq - 1) are skipped, so
//    only the live rows are read, not max_len rows per slot;
//  - a slot's page walk is split across `splits` blocks of ceil(P / splits)
//    pages each (the caller picks splits so a block walks about 512 keys;
//    the TPU walks pages in one sequential grid, and here one block per long
//    sequence would leave the card idle), each keeping its online softmax
//    (m, l, acc) in shared memory; a combine kernel merges the splits'
//    partials -- the same merge the reference's context-parallel decode
//    does across shards (cp_softmax_combine, :1386);
//  - K/V tiles load 16 bytes per thread.
// The dot products are plain f32 FMAs; a cp.async/TMA pipeline is the next
// step.
//
// Masks are the reference's (:869-898): row r = group member r / sq at
// window offset w = r % sq sees key jid iff jid <= pos + w and
// jid < max_len.  Right for sq > 1 and rep > 1 (chunk prefill, verify).

#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::round_to;
using ptt::to_f32;

constexpr int kThreads = 128;
constexpr int kTK = 32;          // page rows per chunk (one score per lane)
constexpr int kMaxRows = 64;     // R = rep * sq

// Shared-memory layout, in floats:
//   q_s [R][d], acc_s [R][d], k_s [kTK][dp], v_s [kTK][d], s_s [R][kTK],
//   m_s [R], l_s [R], a_s [R]
// with dp = d + G, where G threads share one score's dot product (chosen
// so that G groups of a warp hit distinct banks when d % 32 == 0).
size_t smem_floats(int R, int d, int G) {
  return 2 * (size_t)R * d + (size_t)kTK * (d + G) + (size_t)kTK * d +
         (size_t)R * kTK + 3 * (size_t)R;
}

// Rows [c0, c0 + rows) of `page` for kv head g into k_s / v_s as f32; rows
// past `rows` are zero.  `vec`: 16-byte loads (d * sizeof(T) % 16 == 0 and
// aligned arenas).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ ak,
                                          const T* __restrict__ av,
                                          float* k_s, float* v_s, size_t page,
                                          int ps, int c0, int rows, int hk,
                                          int g, int d, int dp, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if (vec) {
    const int nv = d / VEC;
    for (int e = tid; e < kTK * nv; e += kThreads) {
      const int t = e / nv, c = (e % nv) * VEC;
      if (t < rows) {
        const size_t off = ((page * ps + c0 + t) * hk + g) * d + c;
        const uint4 kraw = *reinterpret_cast<const uint4*>(ak + off);
        const uint4 vraw = *reinterpret_cast<const uint4*>(av + off);
        const T* kk = reinterpret_cast<const T*>(&kraw);
        const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          k_s[t * dp + c + i] = to_f32(kk[i]);
          v_s[t * d + c + i] = to_f32(vv[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          k_s[t * dp + c + i] = 0.f;
          v_s[t * d + c + i] = 0.f;
        }
      }
    }
    return;
  }
  for (int e = tid; e < kTK * d; e += kThreads) {
    const int t = e / d, c = e % d;
    float kv = 0.f, vv = 0.f;
    if (t < rows) {
      const size_t off = ((page * ps + c0 + t) * hk + g) * d + c;
      kv = to_f32(ak[off]);
      vv = to_f32(av[off]);
    }
    k_s[t * dp + c] = kv;
    v_s[t * d + c] = vv;
  }
}

// Grid (slot, kv head, split).  With one split the block normalises and
// writes `out`; otherwise it writes its unnormalised partials
// (acc [R][d], m [R], l [R]) to the workspace for `combine_kernel`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                    const T* __restrict__ av, const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ ws, int sq, int h, int hk, int d,
                    int ps, int P, int max_len, float scale, int G, bool vec) {
  extern __shared__ float smem[];
  const int slot = blockIdx.x;
  const int g = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int rep = h / hk;
  const int R = rep * sq;
  const int dp = d + G;
  float* q_s = smem;
  float* acc_s = q_s + R * d;
  float* k_s = acc_s + R * d;
  float* v_s = k_s + kTK * dp;
  float* s_s = v_s + kTK * d;
  float* m_s = s_s + R * kTK;
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int p0 = pos[slot];
  const int last = p0 + sq - 1;  // newest visible position of the window
  const int pps = (P + nsplit - 1) / nsplit;  // pages per split
  const int j0 = split * pps;
  const int j1 = min(P, j0 + pps);

  // row r = group member r / sq (q head g*rep + r/sq) at window offset r % sq
  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int head = g * rep + r / sq;
    q_s[e] = to_f32(q[((size_t)(slot * sq + r % sq) * h + head) * d + c]);
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int pairs = R * kTK;  // (row, key) scores per chunk
  const int stride = kThreads / G;
  const int gl = tid % G;

  for (int j = j0; j < j1; ++j) {
    // pages entirely beyond the newest visible position contribute nothing
    if (j * ps > last) break;
    const size_t page = (size_t)tables[(size_t)slot * P + j];
    for (int c0 = 0; c0 < ps; c0 += kTK) {
      const int base = j * ps + c0;
      if (base > last) break;
      const int rows = min(kTK, ps - c0);
      __syncthreads();  // the previous chunk's readers are done
      load_tile(ak, av, k_s, v_s, page, ps, c0, rows, hk, g, d, dp, vec);
      __syncthreads();

      // scores: G threads per (row, key) pair, xor-shuffle reduction
      for (int pb = 0; pb < pairs; pb += stride) {
        const int pidx = pb + tid / G;
        const bool valid = pidx < pairs;
        const int r = valid ? pidx / kTK : 0;
        const int t = valid ? pidx % kTK : 0;
        float dot = 0.f;
        if (valid)
          for (int c = gl; c < d; c += G)
            dot = fmaf(q_s[r * d + c], k_s[t * dp + c], dot);
        for (int off = G / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (valid && gl == 0) {
          const int jid = base + t;
          const bool ok = t < rows && jid <= p0 + r % sq && jid < max_len;
          s_s[r * kTK + t] = ok ? dot * scale : kNegInf;
        }
      }
      __syncthreads();

      // online softmax, one warp per row, one key per lane
      for (int r = warp; r < R; r += kThreads / 32) {
        const float x = s_s[r * kTK + lane];
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p = expf(x - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        s_s[r * kTK + lane] = round_to<T>(p);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[r] = alpha;
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      for (int e = tid; e < R * d; e += kThreads) {
        const int r = e / d, c = e % d;
        float a = acc_s[e] * a_s[r];
#pragma unroll 8
        for (int t = 0; t < kTK; ++t)
          a = fmaf(s_s[r * kTK + t], v_s[t * d + c], a);
        acc_s[e] = a;
      }
    }
  }
  __syncthreads();

  if (nsplit == 1) {
    for (int e = tid; e < R * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const int head = g * rep + r / sq;
      const float l_safe = fmaxf(l_s[r], 1e-30f);  // masked rows give 0
      out[((size_t)(slot * sq + r % sq) * h + head) * d + c] =
          from_f32<T>(acc_s[e] / l_safe);
    }
    return;
  }
  // partials of this split; a split past `last` leaves m = -1e30, l = 0
  float* ws_acc = ws + (((size_t)slot * hk + g) * nsplit + split) * R * d;
  float* ws_ml = ws + (size_t)gridDim.x * hk * nsplit * R * d +
                 (((size_t)slot * hk + g) * nsplit + split) * R * 2;
  for (int e = tid; e < R * d; e += kThreads) ws_acc[e] = acc_s[e];
  for (int r = tid; r < R; r += kThreads) {
    ws_ml[2 * r] = m_s[r];
    ws_ml[2 * r + 1] = l_s[r];
  }
}

// Merge the splits' (acc, m, l) per row: M = max m, L = sum l e^(m - M),
// out = sum acc e^(m - M) / max(L, 1e-30).  Grid (slot, kv head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int nsplit,
               int sq, int h, int hk, int d) {
  const int slot = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = h / hk;
  const int R = rep * sq;
  const float* acc = ws + ((size_t)slot * hk + g) * nsplit * R * d;
  const float* ml = ws + (size_t)gridDim.x * hk * nsplit * R * d +
                    ((size_t)slot * hk + g) * nsplit * R * 2;
  for (int e = threadIdx.x; e < R * d; e += kThreads) {
    const int r = e / d, c = e % d;
    float M = kNegInf;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[(s * R + r) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[(s * R + r) * 2] - M);
      L += w * ml[(s * R + r) * 2 + 1];
      A += w * acc[(size_t)(s * R + r) * d + c];
    }
    const int head = g * rep + r / sq;
    out[((size_t)(slot * sq + r % sq) * h + head) * d + c] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* ak, const void* av,
                   const void* tables, const void* pos, void* out, void* ws,
                   int nsplit, int b, int sq, int h, int hk, int d, int ps,
                   int P, int max_len, float scale, cudaStream_t stream) {
  const int R = (h / hk) * sq;
  int G = 32;  // largest power of two with G * pairs <= threads (>= 1)
  while (G > 1 && G * R * kTK > kThreads) G >>= 1;
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ak) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(av) % 16 == 0;
  if (nsplit > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(R, d, G);
  auto kernel = paged_decode_kernel<T>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, hk, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ak),
      static_cast<const T*>(av), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<T*>(out),
      static_cast<float*>(ws), sq, h, hk, d, ps, P, max_len, scale, G, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_kernel<T><<<dim3(b, hk), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), nsplit, sq, h, hk,
      d);
  return cudaGetLastError();
}

}  // namespace

// q: [b, sq, h, d]; arenas: [pages, ps, hk, d]; tables: [b, P] int32;
// pos: [b] int32; out: [b, sq, h, d].  Each slot's page walk splits into
// `splits` blocks (1 <= splits <= P); with more than one, ws is a float32
// workspace of b * hk * splits * rep * sq * (d + 2) elements, else it may
// be null.  All contiguous.
extern "C" int ptt_paged_decode(const void* q, const void* ak, const void* av,
                                const void* tables, const void* pos, void* out,
                                void* ws, int splits, int b, int sq, int h,
                                int hk, int d, int ps, int P, int max_len,
                                float scale, int dtype, void* stream) {
  if (b < 1 || sq < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256 ||
      ps < 1 || P < 1 || splits < 1 || splits > P || (h / hk) * sq > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16>(q, ak, av, tables, pos, out, ws, splits,
                                      b, sq, h, hk, d, ps, P, max_len, scale,
                                      st);
  if (dtype == ptt::kFloat32)
    return (int)launch<float>(q, ak, av, tables, pos, out, ws, splits, b, sq,
                              h, hk, d, ps, P, max_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
