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
// K1 also takes the reference's segment ids and per-key bias (`segments=`,
// `kbias=`: packed sequences, BERT's padding, a lowered key-padding mask),
// on every path, at the masking site of each: a key of another segment is
// masked like a causal one, and the bias is added to the scaled score
// before the mask (in the base-2 kernel as bias * log2(e)).  Each q row's
// id is read once; the keys' ids and biases through the read-only path.
// In the Hopper kernel the producer warp stages each key tile's ids and
// biases in shared memory beside the tile.  Key tiles whose segments cannot
// match are still walked.  K6 passes none.
// K1 also takes the reference's ring operands (ring attention's hops and
// its gathered form, `ptt_flash_fwd_ring`), on every path:
//  - `q_offset`: each bq-row block of q starts at its own absolute
//    position (the zig-zag shard's two chunks jump); a tile reads its
//    block's start once, masks `key <= position` with it and ends its
//    causal key sweep at its last row's position;
//  - rectangular keys: lk keys against s query rows;
//  - `carry=(out_prev, lse_prev)`: a hop merges its keys onto the running
//    result, which enters as a pseudo-block (m = lse_prev, l = 1, acc =
//    out_prev) and leaves normalised, as the reference's does;
//  - `out_dtype=float32`: the partials between hops stay in float32.
// They take a compile-time flag (kRing) as masking does, so a launch
// without them runs the instructions it ran before.  Masking and the ring
// operands are never combined.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::kNegInf2;
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
// half-warp, so row reductions are 4 xor-shuffles.  kMask: segment ids or
// a key bias (`mk`) take part; without, the kernel is the unmasked one.
// kRing: the ring operands (`rg`) take part (never with kMask).
template <typename T, int NJ, bool kMask, bool kRing>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ q_off,
                 ptt::Masking mk, ptt::Ring rg, int s, int lk, int h, int hk,
                 int d, int causal, float scale) {
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
  // key position of q row 0 (kRing: of the tile's block, less q0)
  const int qpos = kRing ? ptt::ring_qpos(rg, q0) : q_off != nullptr ? *q_off : 0;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int qi = q0 + r;
    q_s[r * dp + c] =
        qi < s ? to_f32(q[((size_t)(b * s + qi) * h + head) * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
    const int qi = q0 + ty * 4 + i;
    qseg[i] = kMask && qi < s ? ptt::seg_of(mk, b, s, qi) : 0;
    if constexpr (kRing) {
      // the carry is a pseudo-block with m = lse_prev, l = 1, acc = out_prev
      // (the reference's `_init`, flash_attention.py:89-96)
      if (rg.c_out != nullptr && qi < s) {
        m[i] = rg.c_lse[((size_t)b * h + head) * s + qi];
        l[i] = 1.f;
        const float* crow = rg.c_out + ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int col = tx + 16 * jj;
          if (col < d) acc[i][jj] = crow[col];
        }
      }
    }
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

    int kseg[4] = {0, 0, 0, 0};
    float kb[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kMask) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        kseg[j] = kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
        kb[j] = kj < lk ? ptt::bias_of(mk, b, lk, kj) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if constexpr (kMask) {
          const bool live = (!causal || kj <= qpos + qi) && kseg[j] == qseg[i];
          sc[i][j] = kj >= lk ? -INFINITY
                     : live   ? fmaf(sc[i][j], scale, kb[j])
                              : kNegInf;
        } else {
          const bool ok = kj < lk && (!causal || kj <= qpos + qi);
          sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        }
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
    // l >= 1 on every row (see kNegInf); the guard is the reference's
    // (flash_attention.py:139-141)
    const float l_safe = fmaxf(l[i], 1e-30f);
    const size_t orow = ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col >= d) continue;
      if (kRing && rg.out32 != nullptr)
        rg.out32[orow + col] = acc[i][jj] / l_safe;
      else
        out[orow + col] = from_f32<T>(acc[i][jj] / l_safe);
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * h + head) * s + qi] = m[i] + logf(l_safe);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const int* q_off, ptt::Masking mk, ptt::Ring rg,
                   int b, int s, int lk, int h, int hk, int d, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                       (size_t)kBK * d + (size_t)kBQ * (kBK + 1));
  const int var = ptt::variant(mk, rg);
  auto kernel = var == 2   ? flash_fwd_kernel<T, NJ, false, true>
                : var == 1 ? flash_fwd_kernel<T, NJ, true, false>
                           : flash_fwd_kernel<T, NJ, false, false>;
  static ptt::SmemLimit limit[3];  // one per instantiation
  cudaError_t err = limit[var].reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), q_off, mk, rg, s, lk, h, hk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       void* lse, const int* q_off, ptt::Masking mk,
                       ptt::Ring rg, int b, int s, int lk, int h, int hk,
                       int d, int causal, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 4>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h, hk, d,
                        causal, scale, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h, hk, d,
                        causal, scale, stream);
  return launch<T, 16>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h, hk, d,
                       causal, scale, stream);
}


// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, d <= D (D = 64 or 128).
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // q rows per block, 16 per warp
constexpr int kMmaKeys = 64;     // keys per tile
using ptt::kMmaThreads;

template <int D, bool kMask, bool kRing>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     const int* __restrict__ q_off, ptt::Masking mk,
                     ptt::Ring rg, int s, int lk, int h, int hk, int d,
                     int causal, float scale, bool vec) {
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
  // key position of q row 0 (kRing: of the tile's block, less q0)
  const int qpos = kRing ? ptt::ring_qpos(rg, q0) : q_off != nullptr ? *q_off : 0;
  const int qseg[2] = {kMask && row_a < s ? ptt::seg_of(mk, b, s, row_a) : 0,
                       kMask && row_b < s ? ptt::seg_of(mk, b, s, row_b) : 0};

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
  if constexpr (kRing) {
    // the carry as a pseudo-block: m = lse_prev, acc = out_prev, and l = 1
    // on the first thread of the quad (l holds per-thread parts)
    if (rg.c_out != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r ? row_b : row_a;
        if (qi >= s) continue;
        m[r] = rg.c_lse[((size_t)b * h + head) * s + qi];
        l[r] = t == 0 ? 1.f : 0.f;
        const float* crow = rg.c_out + ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (dt * 8 + 2 * t + c < d) o[dt][2 * r + c] = crow[dt * 8 + 2 * t + c];
      }
    }
  }

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
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + nt * 8 + 2 * t + c;
        const int kseg = kMask && kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
        const float kb = kMask && kj < lk ? ptt::bias_of(mk, b, lk, kj) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const int qi = r ? row_b : row_a;
          if constexpr (kMask) {
            const bool live = (!causal || kj <= qpos + qi) && kseg == qseg[r];
            sc[nt][e] = kj >= lk ? -INFINITY
                        : live   ? fmaf(sc[nt][e], scale, kb)
                                 : kNegInf;
          } else {
            const bool ok = kj < lk && (!causal || kj <= qpos + qi);
            sc[nt][e] = ok ? sc[nt][e] * scale : kNegInf;
          }
          mx[r] = fmaxf(mx[r], sc[nt][e]);
        }
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
    const float l_safe = fmaxf(l[r], 1e-30f);  // l >= 1 (see kNegInf)
    const size_t orow = ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (kRing && rg.out32 != nullptr) {
        if (col < d) rg.out32[orow + col] = o[dt][2 * r] / l_safe;
        if (col + 1 < d) rg.out32[orow + col + 1] = o[dt][2 * r + 1] / l_safe;
        continue;
      }
      if (col < d) out[orow + col] = __float2bfloat16(o[dt][2 * r] / l_safe);
      if (col + 1 < d)
        out[orow + col + 1] = __float2bfloat16(o[dt][2 * r + 1] / l_safe);
    }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * h + head) * s + qi] = m[r] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, const int* q_off, ptt::Masking mk,
                       ptt::Ring rg, int b, int s, int lk, int h, int hk,
                       int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kMmaRows + 2 * kMmaKeys) *
                      (D + 8);
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int var = ptt::variant(mk, rg);
  auto kernel = var == 2   ? flash_fwd_mma_kernel<D, false, true>
                : var == 1 ? flash_fwd_mma_kernel<D, true, false>
                           : flash_fwd_mma_kernel<D, false, false>;
  static ptt::SmemLimit limit[3];  // one per instantiation
  cudaError_t err = limit[var].reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kMmaRows - 1) / kMmaRows, h, b);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), q_off, mk, rg, s, lk, h, hk, d, causal, scale,
      vec);
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

using namespace ptt::hop;  // barriers, TMA, descriptors, wgmma (hopper.cuh)

// Shared memory, in bytes from a 1024-byte-aligned base: Q as D / 64
// column halves of [kBQ][64], then the K and V rings (kStages tiles of
// D / 64 halves of [kBN][64] each), each stage's key ids [kBN] int32 and
// key biases x log2(e) [kBN] f32 (masked launches), then the barriers.
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  static constexpr size_t kQ = (size_t)kBQ * D * 2;
  static constexpr size_t kKV = (size_t)kBN * D * 2;  // one K or V tile
  static constexpr size_t q = 0;
  static constexpr size_t k = q + kQ;
  static constexpr size_t v = k + kStages * kKV;
  static constexpr size_t mask = v + kStages * kKV;
  static constexpr size_t bar = mask + kStages * kBN * 8;
  static constexpr size_t bytes = bar + (2 * kStages + 1) * 8;
};

template <int D, bool kMask, bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, const int* __restrict__ q_off,
                       ptt::Masking mk, ptt::Ring rg, int s, int lk, int h,
                       int hk, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  int* kseg_s = reinterpret_cast<int*>(smem + L::mask);  // [kStages][kBN]
  float* kb_s = reinterpret_cast<float*>(kseg_s + kStages * kBN);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  // key position of q row 0 (kRing: of the tile's block, less q0)
  const int qpos = kRing ? ptt::ring_qpos(rg, q0) : q_off != nullptr ? *q_off : 0;
  // causal: keys past the tile's last real row contribute nothing
  const int k_end = causal ? min(lk, qpos + min(s, q0 + kBQ)) : lk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kMask ? 32 : 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kConsumers / 32 && kMask) {
    // the producer of a masked launch: as below, and all 32 lanes stage
    // each key tile's ids and biases (x log2 e) beside it; every lane
    // arrives on the stage's full barrier (lane 0 with the TMA bytes), which
    // releases their stores to the consumers
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(qbar, (uint32_t)L::kQ);
      for (int hf = 0; hf < L::kHalves; ++hf)
        tma_load_4d(q_s + hf * kBQ * 64, &tm_q, qbar, hf * 64, head, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      for (int r = lane; r < kBN; r += 32) {
        const int kj = i * kBN + r;
        kseg_s[st * kBN + r] = kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
        kb_s[st * kBN + r] = kj < lk ? ptt::bias_of(mk, b, lk, kj) * kLog2e : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], (uint32_t)(2 * L::kKV));
        for (int hf = 0; hf < L::kHalves; ++hf) {
          const size_t off = (size_t)st * kBN * D + (size_t)hf * kBN * 64;
          tma_load_4d(k_s + off, &tm_k, &full[st], hf * 64, kvh, i * kBN, b);
          tma_load_4d(v_s + off, &tm_v, &full[st], hf * 64, kvh, i * kBN, b);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
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
  // the masked score (see kNegInf2; unmasked rows always see a live key)
  constexpr float kMasked = kMask ? kNegInf2 : kNegInf;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int qseg[2] = {kMask && row_a < s ? ptt::seg_of(mk, b, s, row_a) : 0,
                       kMask && row_b < s ? ptt::seg_of(mk, b, s, row_b) : 0};
  if constexpr (kRing) {
    // the carry as a pseudo-block: m = lse_prev (base 2), acc = out_prev,
    // l = 1 on the first thread of the quad (l holds per-thread parts)
    if (rg.c_out != nullptr) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r ? row_b : row_a;
        if (qi >= s) continue;
        m[r] = rg.c_lse[((size_t)b * h + head) * s + qi] * kLog2e;
        l[r] = t == 0 ? 1.f : 0.f;
        const float* crow = rg.c_out + ((size_t)(b * s + qi) * h + head) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 c2 = *reinterpret_cast<const float2*>(crow + 8 * j + 2 * t);
          o[4 * j + 2 * r] = c2.x;
          o[4 * j + 2 * r + 1] = c2.y;
        }
      }
    }
  }

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
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + 8 * j + 2 * t + c;
        // the key's id and bias, staged by the producer
        const int kseg = kMask ? kseg_s[st * kBN + 8 * j + 2 * t + c] : 0;
        const float kb2 = kMask ? kb_s[st * kBN + 8 * j + 2 * t + c] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const int qi = r ? row_b : row_a;
          float x;
          if constexpr (kMask) {
            const bool live = (!causal || kj <= qpos + qi) && kseg == qseg[r];
            x = kj >= lk ? -INFINITY
                : live   ? fmaf(sc[4 * j + e], scale_log2, kb2)
                         : kNegInf2;
          } else {
            const bool ok = kj < lk && (!causal || kj <= qpos + qi);
            x = ok ? sc[4 * j + e] * scale_log2 : kNegInf;
          }
          sc[4 * j + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
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
    const float l_safe = fmaxf(l[r], 1e-30f);  // l >= 1 (see kNegInf)
    const float inv = 1.f / l_safe;
    const size_t orow = ((size_t)(b * s + qi) * h + head) * D;
    if (kRing && rg.out32 != nullptr) {  // float32 partials between hops
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(rg.out32 + orow + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + orow + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * h + head) * s + qi] = (m[r] + log2f(l_safe)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const int* q_off, ptt::Masking mk, ptt::Ring rg,
                   int b, int s, int lk, int h, int hk, int causal,
                   float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, b, s, h, D, kBQ) || !make_map(&tk, k, b, lk, hk, D, kBN) ||
      !make_map(&tv, v, b, lk, hk, D, kBN))
    return cudaErrorNotSupported;
  const size_t smem = Smem<D>::bytes + 1024;  // + the 1024-byte alignment
  const int var = ptt::variant(mk, rg);
  auto kernel = var == 2   ? flash_fwd_wgmma_kernel<D, false, true>
                : var == 1 ? flash_fwd_wgmma_kernel<D, true, false>
                           : flash_fwd_wgmma_kernel<D, false, false>;
  static ptt::SmemLimit limit[3];  // one per instantiation
  cudaError_t err = limit[var].reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      q_off, mk, rg, s, lk, h, hk, causal, scale * kLog2e);
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
                   void* out, void* lse, const int* q_off, ptt::Masking mk,
                   ptt::Ring rg, int b, int s, int lk, int h, int hk, int d,
                   int causal, float scale, int dtype, cudaStream_t st) {
  if (b < 1 || s < 1 || lk < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 ||
      d > 256 || h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  // the ring operands: never with masking; q blocks of whole 128-row tiles
  if (rg.on() && (mk.on() || q_off != nullptr ||
                  (rg.q_off != nullptr && (rg.bq < 128 || rg.bq % 128 != 0 ||
                                           s % rg.bq != 0)) ||
                  (rg.c_out == nullptr) != (rg.c_lse == nullptr)))
    return cudaErrorInvalidValue;
  if (path == kPathWgmma) {
    if (dtype != ptt::kBFloat16 || (d != 64 && d != 128) || !aligned16(q) ||
        !aligned16(k) || !aligned16(v))
      return cudaErrorInvalidValue;
    if (d == 64)
      return hop::launch<64>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h,
                             hk, causal, scale, st);
    return hop::launch<128>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h,
                            hk, causal, scale, st);
  }
  if (path == kPathMma && (dtype != ptt::kBFloat16 || d > 128))
    return cudaErrorInvalidValue;
  if (path != kPathMma && path != kPathFma) return cudaErrorInvalidValue;
  if (path == kPathMma && d <= 64)
    return launch_mma<64>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h, hk,
                          d, causal, scale, st);
  if (path == kPathMma)
    return launch_mma<128>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h, hk,
                           d, causal, scale, st);
  if (dtype == ptt::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, q_off, mk, rg, b, s,
                                     lk, h, hk, d, causal, scale, st);
  if (dtype == ptt::kFloat32)
    return dispatch_d<float>(q, k, v, out, lse, q_off, mk, rg, b, s, lk, h, hk,
                             d, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [b, s, h | hk, d] contiguous; out: [b, s, h, d]; lse: [b, h, s]
// f32.  path: 0 the FMA kernel, 1 mma.sync, 2 wgmma + TMA.  segments: [b, s]
// int32 segment ids, kbias: [b, s] f32 key bias, each contiguous or null.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int s, int h, int hk,
                             int d, int causal, float scale, int dtype,
                             int path, const void* segments, const void* kbias,
                             void* stream) {
  const ptt::Masking mk{static_cast<const int*>(segments),
                        static_cast<const float*>(kbias)};
  return (int)attend(path, q, k, v, out, lse, nullptr, mk, ptt::Ring{}, b, s,
                     s, h, hk, d, causal, scale, dtype,
                     static_cast<cudaStream_t>(stream));
}

// K1 with the ring operands (ring attention's hops and gathered form).
// q: [b, s, h, d]; k, v: [b, lk, hk, d] (lk may differ from s); out: [b, s,
// h, d] in q's dtype, or f32 when out_f32; lse: [b, h, s] f32.  q_offset:
// [s / bq] int32, each bq-row block's absolute start (bq a multiple of 128
// dividing s), or null (row i at position i); key j sits at position j and
// a causal row sees keys up to its own position.  carry_out [b, s, h, d]
// f32 and carry_lse [b, h, s] f32, both or neither: the partial result the
// launch merges its keys onto.  Contiguous, no segment ids or key bias.
// With none of the three, the launch is K1's plain kernel over lk keys.
extern "C" int ptt_flash_fwd_ring(const void* q, const void* k, const void* v,
                                  void* out, void* lse, const void* q_offset,
                                  const void* carry_out, const void* carry_lse,
                                  int b, int s, int lk, int h, int hk, int d,
                                  int bq, int causal, float scale, int dtype,
                                  int path, int out_f32, void* stream) {
  const ptt::Ring rg{static_cast<const int*>(q_offset), bq,
                     static_cast<const float*>(carry_out),
                     static_cast<const float*>(carry_lse),
                     out_f32 ? static_cast<float*>(out) : nullptr};
  return (int)attend(path, q, k, v, out, lse, nullptr,
                     ptt::Masking{nullptr, nullptr}, rg, b, s, lk, h, hk, d,
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
                     ptt::Masking{nullptr, nullptr}, ptt::Ring{}, b, sq, L, h,
                     hk, d, 1, scale, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
