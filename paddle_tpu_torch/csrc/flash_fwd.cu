// K1 `flash_fwd`: flash-attention forward for Hopper (sm_90a), and K6
// `dense_decode`, the same kernels run against a dense static KV cache.
//
// K1 replaces the Pallas kernel `_flash_fwd_kernel`, launched by
// `_pallas_flash_forward` (paddle_tpu/ops/flash_attention.py:65, :186).
// Computes softmax(scale * q k^T + causal mask) v with an online softmax over
// K/V tiles, f32 accumulators, and writes `out` [b, s, h, d] plus the f32
// log-sum-exp `lse` [b, h, s] that a backward pass needs.
//
// K6 replaces `_decode_kernel`, launched by `_pallas_decode_forward`
// (flash_attention.py:592, :649): q rows [b, sq, h, d] against cache
// buffers [b, L, hk, d], row i attending cache slots j <= pos + i, where
// `pos` is one int32 the kernel reads from device memory (no host sync, so
// the lock-step prefill needs no .item()).  It is K1's computation with a
// query offset (`q_off`, K1: none, i.e. 0) and a key length `lk` apart from
// the query length (K1: lk == s): every q tile stops at the last key tile
// its last real row sees, rows past `pos + sq` (unwritten cache rows) are
// never read, GQA indexes the cache's kv head in place, ragged sq is masked
// in-kernel (the reference pads q rows to 8 or 128 and loops over the GQA
// groups; here one launch covers every head), and no lse is written.  The
// `rep` q heads of a group are separate blocks reading the same K/V tiles,
// which L2 serves after the first; one block per group is `wgmma` work.
//
// Bound on an H100: at the prefill shapes of the serving path (s <= 512,
// d = 128) the work is 4*s*s*d*h/2 causal FLOPs against (3 + 1)*s*h*d*2
// bytes, i.e. ~s/4 FLOP per byte: compute-bound for long prompts, byte-bound
// below ~100 tokens.  The design answers both:
//  - each block holds one 64-row q tile for the whole K/V sweep, so q is
//    read once and K/V once per q tile (not once per row);
//  - the causal sweep stops at the diagonal tile, halving the work;
//  - GQA reads kv head `h / rep` in place, never a repeated copy of K/V;
//  - the ragged edge (k >= s) is masked in-kernel, so no padding to 128
//    and no segment ids are needed;
//  - bf16 with d = 64 or 128 and at least 128 query rows runs the Hopper
//    kernel (`flash_fwd_wgmma_kernel`): a 128-row q tile per block held by
//    two consumer warpgroups of 64 rows, and one producer warp that loads
//    Q once and K/V tiles of 128 keys by TMA into a two-stage ring, each
//    stage guarded by a full and an empty mbarrier, so the next tile's copy
//    overlaps this tile's products.  S = Q.K^T is a `wgmma` m64n128k16 with
//    Q and K read from 128-byte-swizzled shared memory; the online softmax
//    runs in registers (base 2); P, rounded to bf16, is the register A
//    operand of the P.V `wgmma`, whose B operand V is read MN-major (the
//    transposed form for 16-bit types).  The tensor maps are encoded on the
//    host per call; their bounds zero-fill the ragged edge, which is then
//    masked in registers; GQA reads kv head h / rep through the map's head
//    coordinate; K6's query offset is read in-kernel.
//  - other bf16 shapes with d <= 128 (fewer than 128 rows, d not 64 or
//    128) run `mma.sync` m16n8k16 with f32 accumulation: each warp owns 16
//    q rows, keeps Q and P as register fragments and the output
//    accumulator in registers.  float32 inputs and d > 128 run a plain
//    f32-FMA kernel (the first version).  The host picks the kernel
//    (`flash_path` in ops/flash_attention.py) and passes it in.
//
// Segment ids, per-key bias and the ring `carry` are not supported yet:
// their callers (varlen/BERT, ring attention) are not ported.

#include <cuda.h>  // CUtensorMap and its enums (no driver link)
#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::ld_u32;
using ptt::mma_bf16;
using ptt::pack_bf16;
using ptt::round_to;
using ptt::to_f32;

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: each thread owns 4 rows x (4 keys | NJ dims)

// Thread (ty, tx) owns q rows ty*4 + i (i < 4).  For the scores it owns
// keys tx + 16*j (j < 4); for the output it owns dims tx + 16*jj
// (jj < NJ, NJ = ceil(d / 16)).  The 16 threads of a row sit in one
// half-warp, so row reductions are 4 xor-shuffles.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ q_off, int s,
                 int lk, int h, int hk, int d, int causal, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;  // padded row: conflict-free column reads
  const int pp = kBK + 1;
  float* q_s = smem;            // [kBQ][dp]
  float* k_s = q_s + kBQ * dp;  // [kBK][dp]
  float* v_s = k_s + kBK * dp;  // [kBK][d]
  float* p_s = v_s + kBK * d;   // [kBQ][pp]

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int qpos = q_off != nullptr ? *q_off : 0;  // key position of q row 0

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int qi = q0 + r;
    q_s[r * dp + c] =
        qi < s ? to_f32(q[((size_t)(b * s + qi) * h + head) * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // causal: keys past the tile's last real row contribute nothing
  const int k_end = causal ? min(lk, qpos + min(s, q0 + kBQ)) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < lk) {
        const size_t off = ((size_t)(b * lk + kj) * hk + kvh) * d + c;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[r * dp + c] = kv;
      v_s[r * d + c] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < lk && (!causal || kj <= qpos + qi);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rsum += p;
        p_s[(ty * 4 + i) * pp + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * pp + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        if (col < d) {
          const float vv = v_s[c * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s) continue;
    // fully masked rows give 0, not NaN (flash_attention.py:139-141)
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < d) orow[col] = from_f32<T>(acc[i][jj] / l_safe);
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * h + head) * s + qi] = m[i] + logf(l_safe);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const int* q_off, int b, int s, int lk, int h,
                   int hk, int d, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                       (size_t)kBK * d + (size_t)kBQ * (kBK + 1));
  auto kernel = flash_fwd_kernel<T, NJ>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), q_off, s, lk, h, hk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       void* lse, const int* q_off, int b, int s, int lk,
                       int h, int hk, int d, int causal, float scale,
                       cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 4>(q, k, v, out, lse, q_off, b, s, lk, h, hk, d, causal,
                        scale, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, out, lse, q_off, b, s, lk, h, hk, d, causal,
                        scale, stream);
  return launch<T, 16>(q, k, v, out, lse, q_off, b, s, lk, h, hk, d, causal,
                       scale, stream);
}


// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, d <= D (D = 64 or 128).
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // q rows per block, 16 per warp
constexpr int kMmaKeys = 64;     // keys per tile
using ptt::kMmaThreads;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     const int* __restrict__ q_off, int s, int lk, int h,
                     int hk, int d, int causal, float scale, bool vec) {
  constexpr int ST = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kMmaRows * ST;
  __nv_bfloat16* v_s = k_s + kMmaKeys * ST;
  const unsigned short* v_u16 = reinterpret_cast<const unsigned short*>(v_s);

  const int q0 = blockIdx.x * kMmaRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the tile
  const int row_a = q0 + wr + g, row_b = row_a + 8;
  const int qpos = q_off != nullptr ? *q_off : 0;  // key position of q row 0

  ptt::load_rows<D>(q_s, q, b, q0, s, h, head, d, vec);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = q_s + (wr + g) * ST + kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(p);
    qf[kk][1] = ld_u32(p + 8 * ST);
    qf[kk][2] = ld_u32(p + 8);
    qf[kk][3] = ld_u32(p + 8 * ST + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // causal: keys past the tile's last real row contribute nothing
  const int k_end = causal ? min(lk, qpos + min(s, q0 + kMmaRows)) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile's readers are done
    ptt::load_rows<D>(k_s, k, b, k0, lk, hk, kvh, d, vec);
    ptt::load_rows<D>(v_s, v, b, k0, lk, hk, kvh, d, vec);
    __syncthreads();
    // causal: a tile wholly above this warp's rows contributes nothing
    if (causal && k0 > qpos + q0 + wr + 15) continue;

    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* p = k_s + (nt * 8 + g) * ST + kk * 16 + 2 * t;
        mma_bf16(sc[nt], qf[kk], ld_u32(p), ld_u32(p + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * t + (e & 1);
        const int qi = e < 2 ? row_a : row_b;
        const bool ok = kj < lk && (!causal || kj <= qpos + qi);
        sc[nt][e] = ok ? sc[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    // P in bf16 as the A fragments of P.V: key columns of score tiles 2kk
    // and 2kk+1 are the k columns of P.V step kk
    uint32_t pf[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(sc[nt][0] - m[0]), p1 = expf(sc[nt][1] - m[0]);
      const float p2 = expf(sc[nt][2] - m[1]), p3 = expf(sc[nt][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // per-thread part
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        ptt::b_rows<ST>(v_u16, kk * 16, dt * 8 + g, t, b0, b1);
        mma_bf16(o[dt], pf[kk], b0, b1);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r ? row_b : row_a;
    if (qi >= s) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);  // fully masked rows give 0
    __nv_bfloat16* orow = out + ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < d) orow[col] = __float2bfloat16(o[dt][2 * r] / l_safe);
      if (col + 1 < d) orow[col + 1] = __float2bfloat16(o[dt][2 * r + 1] / l_safe);
    }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * h + head) * s + qi] = m[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, const int* q_off, int b, int s, int lk,
                       int h, int hk, int d, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kMmaRows + 2 * kMmaKeys) *
                      (D + 8);
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kernel = flash_fwd_mma_kernel<D>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kMmaRows - 1) / kMmaRows, h, b);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), q_off, s, lk, h, hk, d, causal, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper kernel: bf16, d = D in {64, 128}, TMA loads and wgmma products.
// ---------------------------------------------------------------------------

namespace hop {

constexpr int kBQ = 128;                   // q rows per block
constexpr int kBN = 128;                   // keys per tile
constexpr int kStages = 2;                 // K/V ring
constexpr int kConsumers = 256;            // two warpgroups of 64 q rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile (rows of 64
// bf16, 8-row atoms of 1024 bytes): start address, leading and stride
// byte offsets, swizzle mode 1 (128 bytes).  K-major operands (Q, K) step
// along K by 32 bytes inside the atom and ignore `lbo`; the MN-major V
// steps along K by whole atoms and reaches its next 64 columns at `lbo`.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t desc = (smem_u32(p) & 0x3FFFF) >> 4;
  desc |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  desc |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  desc |= 1ull << 62;
  return desc;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers in program order around the asynchronous
// products, so no read or write of them moves across a fence or a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[0..64) += A (smem, K-major) . B (smem, K-major), m64n128k16;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..64) += A (registers, bf16 pairs) . B (smem, MN-major), m64n128k16.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..32) += A (registers, bf16 pairs) . B (smem, MN-major), m64n64k16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Shared memory, in bytes from a 1024-byte-aligned base: Q as D / 64
// column halves of [kBQ][64], then the K and V rings (kStages tiles of
// D / 64 halves of [kBN][64] each), then the barriers.
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  static constexpr size_t kQ = (size_t)kBQ * D * 2;
  static constexpr size_t kKV = (size_t)kBN * D * 2;  // one K or V tile
  static constexpr size_t q = 0;
  static constexpr size_t k = q + kQ;
  static constexpr size_t v = k + kStages * kKV;
  static constexpr size_t bar = v + kStages * kKV;
  static constexpr size_t bytes = bar + (2 * kStages + 1) * 8;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, const int* __restrict__ q_off,
                       int s, int lk, int h, int hk, int causal,
                       float scale_log2) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int qpos = q_off != nullptr ? *q_off : 0;  // key position of q row 0
  // causal: keys past the tile's last real row contribute nothing
  const int k_end = causal ? min(lk, qpos + min(s, q0 + kBQ)) : lk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kConsumers / 32) {
    // the producer: Q once, then K and V tiles into the ring; rows past s
    // or lk arrive as zeros (the tensor maps' bounds)
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(qbar, (uint32_t)L::kQ);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load_4d(q_s + hf * kBQ * 64, &tm_q, qbar, hf * 64, head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], (uint32_t)(2 * L::kKV));
        for (int hf = 0; hf < L::kHalves; ++hf) {
          const size_t off = (size_t)st * kBN * D + (size_t)hf * kBN * 64;
          tma_load_4d(k_s + off, &tm_k, &full[st], hf * 64, kvh, i * kBN, b);
          tma_load_4d(v_s + off, &tm_v, &full[st], hf * 64, kvh, i * kBN, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: q rows [64 wg, 64 wg + 64) of the tile; warp wq
  // of it rows 16 wq.., this thread rows g and g + 8 of those.  Score and
  // output accumulators: element 4j + e at row g + 8 (e / 2), column
  // 8j + 2t + (e % 2).
  const int wg = warp / 4, wq = warp % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + wq * 16 + g, row_b = row_a + 8;
  const unsigned char* q_wg =
      reinterpret_cast<const unsigned char*>(q_s) + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const unsigned char* kt =
        reinterpret_cast<const unsigned char*>(k_s + (size_t)st * kBN * D);
    const unsigned char* vt =
        reinterpret_cast<const unsigned char*>(v_s + (size_t)st * kBN * D);

    float sc[kBN / 2];
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // column half kk / 4, 32 bytes per 16-deep step inside it
      const size_t off = (size_t)(kk / 4) * (kBQ * 128) + (kk % 4) * 32;
      const size_t koff = (size_t)(kk / 4) * (kBN * 128) + (kk % 4) * 32;
      wgmma_ss_n128(sc, make_desc(q_wg + off, 16, 1024),
                    make_desc(kt + koff, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    const int k0 = i * kBN;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        const int qi = e < 2 ? row_a : row_b;
        const bool ok = kj < lk && (!causal || kj <= qpos + qi);
        const float x = ok ? sc[4 * j + e] * scale_log2 : kNegInf;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // P in bf16 (K1's rounding point) as the register A operand of P.V:
    // key columns 16kk.. of the scores are the k columns of step kk
    uint32_t pf[kBN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - m[0]);
      const float p1 = exp2f(sc[4 * j + 1] - m[0]);
      const float p2 = exp2f(sc[4 * j + 2] - m[1]);
      const float p3 = exp2f(sc[4 * j + 3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // per-thread part
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      // 16 keys = two 1024-byte atoms per step; the next 64 columns of V
      // lie one column half (kBN rows of 128 bytes) further
      const uint64_t db = make_desc(vt + kk * 2048, kBN * 128, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128(o, pf[kk], db);
      else
        wgmma_rs_n64(o, pf[kk], db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(o);
    mbar_arrive(&empty[st]);  // this thread is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = r ? row_b : row_a;
    if (qi >= s) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);  // fully masked rows give 0
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = out + ((size_t)(b * s + qi) * h + head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[((size_t)b * h + head) * s + qi] = (m[r] + log2f(l_safe)) * kLn2;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor map of x [b, n, nh, D] bf16 whose box is 64 columns x 1 head x
// `rows` rows x 1 batch, 128-byte swizzled; out-of-bounds rows read zero.
bool make_map(CUtensorMap* map, const void* x, int b, int n, int nh, int D,
              int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)nh, (cuuint64_t)n,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)nh * D * 2,
                                 (cuuint64_t)n * nh * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const int* q_off, int b, int s, int lk, int h,
                   int hk, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b, s, h, D, kBQ) || !make_map(&mk, k, b, lk, hk, D, kBN) ||
      !make_map(&mv, v, b, lk, hk, D, kBN))
    return cudaErrorNotSupported;
  const size_t smem = Smem<D>::bytes + 1024;  // + the 1024-byte alignment
  auto kernel = flash_fwd_wgmma_kernel<D>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      q_off, s, lk, h, hk, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace hop

// Kernel choices, picked by the host (`flash_path`).
constexpr int kPathFma = 0;    // f32 FMA, any dtype and d
constexpr int kPathMma = 1;    // mma.sync, bf16 d <= 128
constexpr int kPathWgmma = 2;  // wgmma + TMA, bf16 d = 64 or 128

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Run the kernel `path` names; a path the shape does not fit is
// cudaErrorInvalidValue, never another kernel.  q_off == nullptr: no query
// offset (K1).
cudaError_t attend(int path, const void* q, const void* k, const void* v,
                   void* out, void* lse, const int* q_off, int b, int s,
                   int lk, int h, int hk, int d, int causal, float scale,
                   int dtype, cudaStream_t st) {
  if (b < 1 || s < 1 || lk < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 ||
      d > 256 || h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  if (path == kPathWgmma) {
    if (dtype != ptt::kBFloat16 || (d != 64 && d != 128) || !aligned16(q) ||
        !aligned16(k) || !aligned16(v))
      return cudaErrorInvalidValue;
    if (d == 64)
      return hop::launch<64>(q, k, v, out, lse, q_off, b, s, lk, h, hk,
                             causal, scale, st);
    return hop::launch<128>(q, k, v, out, lse, q_off, b, s, lk, h, hk, causal,
                            scale, st);
  }
  if (path == kPathMma && (dtype != ptt::kBFloat16 || d > 128))
    return cudaErrorInvalidValue;
  if (path != kPathMma && path != kPathFma) return cudaErrorInvalidValue;
  if (path == kPathMma && d <= 64)
    return launch_mma<64>(q, k, v, out, lse, q_off, b, s, lk, h, hk, d, causal,
                          scale, st);
  if (path == kPathMma)
    return launch_mma<128>(q, k, v, out, lse, q_off, b, s, lk, h, hk, d,
                           causal, scale, st);
  if (dtype == ptt::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, q_off, b, s, lk, h, hk,
                                     d, causal, scale, st);
  if (dtype == ptt::kFloat32)
    return dispatch_d<float>(q, k, v, out, lse, q_off, b, s, lk, h, hk, d,
                             causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [b, s, h | hk, d] contiguous; out: [b, s, h, d]; lse: [b, h, s]
// f32.  path: 0 the FMA kernel, 1 mma.sync, 2 wgmma + TMA.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int s, int h, int hk,
                             int d, int causal, float scale, int dtype,
                             int path, void* stream) {
  return (int)attend(path, q, k, v, out, lse, nullptr, b, s, s, h, hk, d,
                     causal, scale, dtype, static_cast<cudaStream_t>(stream));
}

// K6.  q: [b, sq, h, d]; k, v: [b, L, hk, d] cache buffers, all contiguous;
// pos: one int32 in device memory, the cache position of q row 0; out:
// [b, sq, h, d].  Row i attends cache rows j <= pos + i (j < L).  path as
// for ptt_flash_fwd.
extern "C" int ptt_dense_decode(const void* q, const void* k, const void* v,
                                void* out, const void* pos, int b, int sq,
                                int h, int hk, int d, int L, float scale,
                                int dtype, int path, void* stream) {
  if (pos == nullptr) return (int)cudaErrorInvalidValue;
  return (int)attend(path, q, k, v, out, nullptr, static_cast<const int*>(pos),
                     b, sq, L, h, hk, d, 1, scale, dtype,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
