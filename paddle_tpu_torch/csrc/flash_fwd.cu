// K1 `flash_fwd`: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_fwd_kernel`, launched by
// `_pallas_flash_forward` (paddle_tpu/ops/flash_attention.py:65, :186).
// Computes softmax(scale * q k^T + causal mask) v with an online softmax over
// K/V tiles, f32 accumulators, and writes `out` [b, s, h, d] plus the f32
// log-sum-exp `lse` [b, h, s] that a backward pass needs.
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
//  - bf16 with d <= 128 runs on the tensor cores (`mma.sync` m16n8k16 with
//    f32 accumulation): each warp owns 16 q rows, keeps Q and P as register
//    fragments and the output accumulator in registers.  float32 inputs and
//    d > 128 run a plain f32-FMA kernel (the first version).
// Not yet: wgmma, TMA and a load pipeline overlapping the next K/V tile.
//
// Segment ids, per-key bias, the ring `carry` and `q_offset` are not
// supported yet: their callers (varlen/BERT, ring attention) are not ported.

#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
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
                 float* __restrict__ lse, int s, int h, int hk, int d,
                 int causal, float scale) {
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

  // causal: tiles strictly above the diagonal contribute nothing
  const int k_end = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < s) {
        const size_t off = ((size_t)(b * s + kj) * hk + kvh) * d + c;
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
        const bool ok = kj < s && (!causal || kj <= qi);
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
    if (tx == 0) lse[((size_t)b * h + head) * s + qi] = m[i] + logf(l_safe);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int b, int s, int h, int hk, int d, int causal,
                   float scale, cudaStream_t stream) {
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
      static_cast<float*>(lse), s, h, hk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       void* lse, int b, int s, int h, int hk, int d,
                       int causal, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 4>(q, k, v, out, lse, b, s, h, hk, d, causal, scale, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, out, lse, b, s, h, hk, d, causal, scale, stream);
  return launch<T, 16>(q, k, v, out, lse, b, s, h, hk, d, causal, scale, stream);
}


// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, d <= D (D = 64 or 128).
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // q rows per block, 16 per warp
constexpr int kMmaKeys = 64;     // keys per tile
constexpr int kMmaThreads = 128;

// d[16x8] += a[16x16] . b[16x8], bf16 inputs, f32 accumulators.  Fragment
// layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1]}; each 32-bit register holds two bf16, the lower index low.
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
// ([64][D + 8] bf16), zero past s and past d.  `vec`: 16-byte loads.
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int s, int h, int hk, int d, int causal, float scale,
                     bool vec) {
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

  load_rows<D>(q_s, q, b, q0, s, h, head, d, vec);
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

  const int k_end = causal ? min(s, q0 + kMmaRows) : s;
  for (int k0 = 0; k0 < k_end; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(k_s, k, b, k0, s, hk, kvh, d, vec);
    load_rows<D>(v_s, v, b, k0, s, hk, kvh, d, vec);
    __syncthreads();
    // causal: a tile wholly above this warp's rows contributes nothing
    if (causal && k0 > q0 + wr + 15) continue;

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
        const bool ok = kj < s && (!causal || kj <= qi);
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
        const unsigned short* p = v_u16 + (kk * 16 + 2 * t) * ST + dt * 8 + g;
        const uint32_t b0 = p[0] | ((uint32_t)p[ST] << 16);
        const uint32_t b1 = p[8 * ST] | ((uint32_t)p[9 * ST] << 16);
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
    if (t == 0) lse[((size_t)b * h + head) * s + qi] = m[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, int b, int s, int h, int hk, int d,
                       int causal, float scale, cudaStream_t stream) {
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
      static_cast<float*>(lse), s, h, hk, d, causal, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [b, s, h | hk, d] contiguous; out: [b, s, h, d]; lse: [b, h, s] f32.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int s, int h, int hk,
                             int d, int causal, float scale, int dtype,
                             void* stream) {
  if (b < 1 || s < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16 && d <= 64)
    return (int)launch_mma<64>(q, k, v, out, lse, b, s, h, hk, d, causal,
                               scale, st);
  if (dtype == ptt::kBFloat16 && d <= 128)
    return (int)launch_mma<128>(q, k, v, out, lse, b, s, h, hk, d, causal,
                                scale, st);
  if (dtype == ptt::kBFloat16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, lse, b, s, h, hk, d,
                                          causal, scale, st);
  if (dtype == ptt::kFloat32)
    return (int)dispatch_d<float>(q, k, v, out, lse, b, s, h, hk, d, causal,
                                  scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
