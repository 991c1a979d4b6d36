// K3 `flash_bwd`: flash-attention backward (FA-2) for Hopper (sm_90a).
//
// Replaces the Pallas kernels `_flash_bwd_dkdv_kernel` and
// `_flash_bwd_dq_kernel`, launched by `_pallas_flash_backward`
// (paddle_tpu/ops/flash_attention.py:303, :362, :415).  From K1's `out` and
// `lse` and the output gradient `g` it computes, per (batch, head):
//   delta = rowsum(g * out)                          (f32, a pre-pass here)
//   p     = exp(scale * q k^T - lse)                 (recomputed, never stored)
//   dv   += p^T g        with p rounded to the value dtype first
//   ds    = p * (g v^T - delta) * scale, rounded to the input dtype
//   dk   += ds^T q,  dq += ds k                      (f32 sums, written in T)
// on the port's [b, s, h, d] layout, with the reference's rounding points.
//
// Bound on an H100: at the training shape (b 4, s 2048, h 32, d 128,
// causal) the five products are ~3.4e11 FLOP (0.35 ms at 989 TFLOP/s bf16)
// against ~0.54 GB of inputs and outputs (0.16 ms at 3.35 TB/s): compute-
// bound.  What the design does about the TPU kernel's assumptions:
//  - no sequential grid: the dk/dv kernel gives each block one
//    (batch, kv head, key tile) and loops over the q tiles itself, from the
//    diagonal when causal; the dq kernel gives each block one
//    (batch, q head, q tile) and loops over key tiles up to the diagonal.
//    Every sum stays in one block's registers: no atomics, so dq/dk/dv are
//    the same from run to run;
//  - GQA in-kernel: the dk/dv block also loops over the `rep` q heads of
//    its kv head and writes dk/dv at `hk` heads (the group's sum), instead
//    of the reference's repeated K/V and autograd's sum over the copies;
//  - the ragged edge is masked in-kernel (`q < s`, `k < s`) as in K1: no
//    padding, no segment ids; key rows past `s` are never written;
//  - bf16 or fp16 with d = 64 or 128 and at least 128 rows (every
//    training step) runs the Hopper kernels (`hop::`): per block one producer warp and two
//    consumer warpgroups.  The producer keeps a two-stage ring of TMA tiles
//    (128-byte swizzled, the tensor maps encoded per call through the
//    driver entry point, so the build needs no -lcuda) full behind
//    full/empty mbarriers.  The dk/dv kernel holds 128 keys (64 per
//    warpgroup) and streams 64-row Q/dO tiles with their lse and delta;
//    the dq kernel holds 128 q rows and streams 64-key K/V tiles.  S, dP
//    and their transposes are `wgmma` products of K-major tiles; P^T.dO,
//    dS^T.Q and dS.K read their B operand MN-major (the transposed form, as
//    K1 reads V), with P^T and dS as the register A operand, rounded to
//    the input dtype where the reference rounds them (`g.dtype` for P,
//    `q.dtype` for dS: one dtype here).  In fp16 a dS beyond 65504 (the
//    loss scale of a dynamic GradScaler can carry it there) rounds to inf
//    as the reference's cast does; the scaler finds it and skips the step;
//  - other bf16 or fp16 shapes with d <= 128 run the five products on `mma.sync`
//    m16n8k16 (f32 accumulation); float32 and d > 128 run a plain f32-FMA
//    kernel from shared memory.  The host picks the kernel (`flash_path`).
// The dq kernel recomputes S and dP (seven products where the math needs
// five): the price of a deterministic dq without float atomics.
// Segment ids and the per-key bias (`segments=`, `kbias=`) mask the
// recomputed scores exactly as K1 masked them, on every path: a masked
// pair scores kNegInf (p = exp(kNegInf - lse): 0, or 1 on a row with no
// live key, as in the reference), a key past s is skipped.  Each block
// reads the ids and biases of its own rows or keys once; the streamed
// tiles' ids (and, for key tiles, biases) ride in shared memory beside
// them, staged by the producer (the Hopper kernels) or read through the
// read-only path (the others).
// K3 also takes the reference's ring operands (`ptt_flash_bwd_ring`), on
// every path, under a compile-time flag (kRing) so a launch without them
// runs the instructions it ran before:
//  - rectangular keys: dk and dv come out at lk rows;
//  - `q_offset`: each bq-row block of q starts at its own absolute
//    position.  A zig-zag shard's two chunks jump, so "the q tiles from
//    the diagonal on" is no longer a contiguous range: the dk/dv kernels
//    test every q tile's absolute rows against their key tile (skip it,
//    take it whole, or mask it), and the dq kernels end their key sweep at
//    their tile's absolute diagonal;
//  - `delta=`: the ring computes rowsum(g * out) once for all its hops;
//    given, the pre-pass is skipped and `out` is not read.
// The ring's `g` is the cotangent of its final cast to the input dtype
// (ring_attention.py:199, :372), so its values are exact in that dtype: K3
// takes g in q's dtype and needs no float32-g path.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using ptt::from_f32;
using ptt::round_to;
using ptt::to_f32;

constexpr int kThreads = 256;  // FMA kernels: 16 x 16 threads

using ptt::kNegInf;
using ptt::kNegInf2;
using ptt::Masking;
using ptt::Ring;

// p = exp(score - lse) of one in-bounds (row, key) pair under segment ids
// or a key bias, the score masked as K1 masked it: `dot` is q.k, `kb` the
// key's bias (`bias` says whether there is one), `live` whether the causal
// fence and the segments let the pair through.  One exponential a pair:
// the argument is chosen first.
__device__ __forceinline__ float masked_p(float dot, float scale, float kb,
                                          bool bias, bool live, float lse) {
  const float x = !live ? kNegInf - lse
                  : bias ? fmaf(dot, scale, kb) - lse
                         : fmaf(dot, scale, -lse);
  return expf(x);
}

// The same in the base-2 domain of the Hopper kernels: `sl2` = scale x
// log2(e), `kb2` = kbias x log2(e), `lse2` = lse x log2(e).
__device__ __forceinline__ float masked_p2(float dot, float sl2, float kb2,
                                           bool bias, bool live, float lse2) {
  const float x = !live ? kNegInf2 - lse2
                  : bias ? fmaf(dot, sl2, kb2) - lse2
                         : fmaf(dot, sl2, -lse2);
  return exp2f(x);
}

// delta[b, h, i] = sum_c g[b, i, h, c] * out[b, i, h, c] in f32; one warp
// per (b, i, h) row, rows taken in memory order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ g, const T* __restrict__ out,
             float* __restrict__ delta, int b, int s, int h, int d) {
  const long row = ((long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)b * s * h) return;  // uniform across the warp
  const T* gr = g + (size_t)row * d;
  const T* orow = out + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f32(gr[c]) * to_f32(orow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hh = (int)(row % h);
    const int i = (int)((row / h) % s);
    const int bb = (int)(row / ((long)h * s));
    delta[((size_t)bb * h + hh) * s + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// FMA kernels: float32 at any d <= 256, bf16 and fp16 at 128 < d <= 256.  Tiles of
// BT = 64 rows for d <= 128, 32 above, so the four f32 tiles fit in shared
// memory.
// ---------------------------------------------------------------------------

// Rows [row0, row0 + BT) of head hh of x ([b, s, nh, d]) into dst
// ([BT][dp] f32), zero past s.
template <typename T, int BT>
__device__ __forceinline__ void load_tile(float* dst, int dp,
                                          const T* __restrict__ x, int b,
                                          int row0, int s, int nh, int hh,
                                          int d) {
  for (int e = threadIdx.x; e < BT * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int i = row0 + r;
    dst[r * dp + c] =
        i < s ? to_f32(x[((size_t)(b * s + i) * nh + hh) * d + c]) : 0.f;
  }
}

// lse and delta of rows [row0, row0 + BT) of one (b, head), 0 past s;
// with `seg_s`, the rows' segment ids too.
template <int BT>
__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              size_t base, int row0, int s,
                                              int* seg_s = nullptr,
                                              const Masking* mk = nullptr,
                                              int b = 0) {
  for (int e = threadIdx.x; e < BT; e += kThreads) {
    const int i = row0 + e;
    lse_s[e] = i < s ? lse[base + i] : 0.f;
    delta_s[e] = i < s ? delta[base + i] : 0.f;
    if (seg_s != nullptr) seg_s[e] = i < s ? ptt::seg_of(*mk, b, s, i) : 0;
  }
}

// One block per (key tile of BT, kv head, batch).  Thread (ty, tx) owns
// keys ty*R + i (i < R = BT / 16); for the score tile it owns q rows
// tx + 16*j, for dk/dv dims tx + 16*jj (jj < NJ).  kMask: segment ids or a
// key bias take part; kRing: the q blocks' absolute starts (`rg.q_off`)
// do (every kernel here takes both flags, never both set).  Keys: lk rows.
template <typename T, int BT, int NJ, bool kMask, bool kRing>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Masking mk, Ring rg, int s, int lk,
                      int h, int hk, int d, int causal, float scale) {
  constexpr int R = BT / 16;
  constexpr int pp = BT + 1;
  extern __shared__ float smem[];
  const int dp = d + 1;  // padded rows: conflict-free column reads
  float* k_s = smem;
  float* v_s = k_s + BT * dp;
  float* q_s = v_s + BT * dp;
  float* g_s = q_s + BT * dp;
  float* p_s = g_s + BT * dp;    // [key][q]: p^T, rounded to T
  float* ds_s = p_s + BT * pp;   // [key][q]: ds^T, rounded to T
  float* lse_s = ds_s + BT * pp;
  float* delta_s = lse_s + BT;
  int* seg_s = reinterpret_cast<int*>(delta_s + BT);  // the q rows' ids

  const int k0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = h / hk;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool bias = mk.kbias != nullptr;

  load_tile<T, BT>(k_s, dp, k, b, k0, lk, hk, kvh, d);
  load_tile<T, BT>(v_s, dp, v, b, k0, lk, hk, kvh, d);
  int kseg[R];  // this thread's keys: ids and biases, read once
  float kb[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    kseg[i] = kMask && kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
    kb[i] = kMask && kj < lk ? ptt::bias_of(mk, b, lk, kj) : 0.f;
  }

  float dk_acc[R][NJ], dv_acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.f;

  // causal: q tiles wholly above the diagonal see none of these keys
  // (kRing: each q tile is tested by its absolute rows, which jump)
  const int q_begin = causal && !kRing ? k0 : 0;
  for (int r = 0; r < rep; ++r) {
    const int head = kvh * rep + r;
    const size_t stats = ((size_t)b * h + head) * s;
    for (int q0 = q_begin; q0 < s; q0 += BT) {
      const int qp = kRing ? ptt::ring_qpos(rg, q0) : 0;  // row i at qp + i
      if (kRing && causal && qp + q0 + BT - 1 < k0) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, BT>(q_s, dp, q, b, q0, s, h, head, d);
      load_tile<T, BT>(g_s, dp, g, b, q0, s, h, head, d);
      load_rowstats<BT>(lse_s, delta_s, lse, delta, stats, q0, s,
                        kMask ? seg_s : nullptr, &mk, b);
      __syncthreads();

      float st[R][R], dpt[R][R];  // scores and g v^T, transposed
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float kv[R], vv[R], qv[R], gv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = k_s[(ty * R + i) * dp + c];
          vv[i] = v_s[(ty * R + i) * dp + c];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qv[j] = q_s[(tx + 16 * j) * dp + c];
          gv[j] = g_s[(tx + 16 * j) * dp + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kj = k0 + ty * R + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qr = tx + 16 * j;
          const int qi = q0 + qr;
          // pairs past s are exactly 0: they add nothing to any sum
          float p = 0.f;
          if constexpr (kMask) {
            const bool live = (!causal || kj <= qi) && kseg[i] == seg_s[qr];
            if (kj < lk && qi < s)
              p = masked_p(st[i][j], scale, kb[i], bias, live, lse_s[qr]);
          } else if (kj < lk && qi < s && (!causal || kj <= qp + qi)) {
            p = expf(st[i][j] * scale - lse_s[qr]);
          }
          const float ds = p * (dpt[i][j] - delta_s[qr]) * scale;
          p_s[(ty * R + i) * pp + qr] = round_to<T>(p);
          ds_s[(ty * R + i) * pp + qr] = round_to<T>(ds);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BT; ++qq) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = p_s[(ty * R + i) * pp + qq];
          dsv[i] = ds_s[(ty * R + i) * pp + qq];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int col = tx + 16 * jj;
          if (col < d) {
            const float gv = g_s[qq * dp + col];
            const float qv = q_s[qq * dp + col];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              dv_acc[i][jj] = fmaf(pv[i], gv, dv_acc[i][jj]);
              dk_acc[i][jj] = fmaf(dsv[i], qv, dk_acc[i][jj]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    if (kj >= lk) continue;
    const size_t row = ((size_t)(b * lk + kj) * hk + kvh) * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < d) {
        dk[row + col] = from_f32<T>(dk_acc[i][jj]);
        dv[row + col] = from_f32<T>(dv_acc[i][jj]);
      }
    }
  }
}

// One block per (q tile of BT, q head, batch).  Thread (ty, tx) owns q rows
// ty*R + i; for the score tile it owns keys tx + 16*j, for dq dims
// tx + 16*jj.
template <typename T, int BT, int NJ, bool kMask, bool kRing>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Masking mk, Ring rg, int s, int lk, int h, int hk, int d,
                    int causal, float scale) {
  constexpr int R = BT / 16;
  constexpr int pp = BT + 1;
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* q_s = smem;
  float* g_s = q_s + BT * dp;
  float* k_s = g_s + BT * dp;
  float* v_s = k_s + BT * dp;
  float* ds_s = v_s + BT * dp;  // [q][key], rounded to T
  float* lse_s = ds_s + BT * pp;
  float* delta_s = lse_s + BT;

  const int q0 = blockIdx.x * BT;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, BT>(q_s, dp, q, b, q0, s, h, head, d);
  load_tile<T, BT>(g_s, dp, g, b, q0, s, h, head, d);
  load_rowstats<BT>(lse_s, delta_s, lse, delta, ((size_t)b * h + head) * s,
                    q0, s);
  const bool bias = mk.kbias != nullptr;
  int qseg[R];  // this thread's rows' ids, read once
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    qseg[i] = kMask && qi < s ? ptt::seg_of(mk, b, s, qi) : 0;
  }

  float dq_acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) dq_acc[i][jj] = 0.f;

  const int qp = kRing ? ptt::ring_qpos(rg, q0) : 0;  // row i at qp + i
  // causal: key tiles wholly past the diagonal contribute nothing
  const int k_end = causal ? min(lk, qp + min(s, q0 + BT)) : lk;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BT>(k_s, dp, k, b, k0, lk, hk, kvh, d);
    load_tile<T, BT>(v_s, dp, v, b, k0, lk, hk, kvh, d);
    __syncthreads();

    float sc[R][R], dpv[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sc[i][j] = dpv[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = q_s[(ty * R + i) * dp + c];
        gv[i] = g_s[(ty * R + i) * dp + c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = k_s[(tx + 16 * j) * dp + c];
        vv[j] = v_s[(tx + 16 * j) * dp + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dpv[i][j] = fmaf(gv[i], vv[j], dpv[i][j]);
        }
    }
    int kseg[R];
    float kb[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int kj = k0 + tx + 16 * j;
      kseg[j] = kMask && kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
      kb[j] = kMask && kj < lk ? ptt::bias_of(mk, b, lk, kj) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = ty * R + i;
      const int qi = q0 + qr;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = 0.f;
        if constexpr (kMask) {
          const bool live = (!causal || kj <= qi) && kseg[j] == qseg[i];
          if (kj < lk && qi < s)
            p = masked_p(sc[i][j], scale, kb[j], bias, live, lse_s[qr]);
        } else if (kj < lk && qi < s && (!causal || kj <= qp + qi)) {
          p = expf(sc[i][j] * scale - lse_s[qr]);
        }
        ds_s[qr * pp + tx + 16 * j] =
            round_to<T>(p * (dpv[i][j] - delta_s[qr]) * scale);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BT; ++kk) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds_s[(ty * R + i) * pp + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        if (col < d) {
          const float kv = k_s[kk * dp + col];
#pragma unroll
          for (int i = 0; i < R; ++i) dq_acc[i][jj] = fmaf(dsv[i], kv, dq_acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= s) continue;
    const size_t row = ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < d) dq[row + col] = from_f32<T>(dq_acc[i][jj]);
    }
  }
}

template <typename T>
cudaError_t launch_delta(const void* g, const void* out, void* delta, int b,
                         int s, int h, int d, cudaStream_t stream) {
  const long rows = (long)b * s * h;
  const long blocks = (rows * 32 + kThreads - 1) / kThreads;
  delta_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(out),
      static_cast<float*>(delta), b, s, h, d);
  return cudaGetLastError();
}

template <typename T, int BT, int NJ>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, Masking mk, Ring rg,
                       int b, int s, int lk, int h, int hk, int d, int causal,
                       float scale, cudaStream_t stream) {
  const size_t tile = (size_t)BT * (d + 1);
  // the tiles, p^T and ds^T, the q rows' lse, delta and segment ids
  const size_t smem_dkdv =
      sizeof(float) * (4 * tile + 2 * (size_t)BT * (BT + 1) + 3 * BT);
  const size_t smem_dq = sizeof(float) * (4 * tile + (size_t)BT * (BT + 1) + 2 * BT);
  const int var = ptt::variant(mk, rg);
  auto dkdv = var == 2   ? flash_bwd_dkdv_kernel<T, BT, NJ, false, true>
              : var == 1 ? flash_bwd_dkdv_kernel<T, BT, NJ, true, false>
                         : flash_bwd_dkdv_kernel<T, BT, NJ, false, false>;
  auto dqk = var == 2   ? flash_bwd_dq_kernel<T, BT, NJ, false, true>
             : var == 1 ? flash_bwd_dq_kernel<T, BT, NJ, true, false>
                        : flash_bwd_dq_kernel<T, BT, NJ, false, false>;
  static ptt::SmemLimit limit_dkdv[3], limit_dq[3];  // one per instantiation
  cudaError_t err = limit_dkdv[var].reserve(dkdv, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = limit_dq[var].reserve(dqk, smem_dq);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((lk + BT - 1) / BT, hk, b), kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), mk, rg, s, lk, h, hk, d,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((s + BT - 1) / BT, h, b), kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), mk, rg, s, lk, h, hk, d, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fma_f32(const void* q, const void* k, const void* v,
                             const void* g, const void* lse, const void* delta,
                             void* dq, void* dk, void* dv, Masking mk, Ring rg,
                             int b, int s, int lk, int h, int hk, int d,
                             int causal, float scale, cudaStream_t st) {
  if (d <= 64)
    return launch_fma<float, 64, 4>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg,
                                    b, s, lk, h, hk, d, causal, scale, st);
  if (d <= 128)
    return launch_fma<float, 64, 8>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg,
                                    b, s, lk, h, hk, d, causal, scale, st);
  return launch_fma<float, 32, 16>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg,
                                   b, s, lk, h, hk, d, causal, scale, st);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: T = bf16 or fp16, d <= D (D = 64 or 128).
// ---------------------------------------------------------------------------

constexpr int kMmaTile = 64;  // rows of the block's own tile, 16 per warp
constexpr int kPass = 32;     // columns of the streamed tile per pass

using ptt::b_rows;
using ptt::kMmaThreads;
using ptt::ld_u32;
using ptt::mma;
using ptt::pack;

// The A fragment of one 16-deep step kk of a product whose 16 A rows are
// rows [r0, r0 + 16) of the row-major tile x ([rows][ST]).
template <int ST, typename T>
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const T* x, int r0,
                                       int kk, int g, int t) {
  const T* p = x + (r0 + g) * ST + kk * 16 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ST);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ST + 8);
}

// One block per (64-key tile, kv head, batch); warp w owns keys 16w..16w+15
// of the tile and keeps their dk/dv rows in f32 registers.  For each q tile
// of each q head of the group, it computes s^T = K Q^T and dp^T = V G^T
// 32 q columns at a time; the accumulators, turned into p^T and ds^T and
// packed to T, are the A fragments of dv += p^T G and dk += ds^T Q.
template <typename T, int D, bool kMask, bool kRing>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, Masking mk, Ring rg, int s,
                          int lk, int h, int hk, int d, int causal, float scale,
                          bool vec) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kMmaTile * ST;
  T* q_s = v_s + kMmaTile * ST;
  T* g_s = q_s + kMmaTile * ST;
  float* lse_s = reinterpret_cast<float*>(g_s + kMmaTile * ST);
  float* delta_s = lse_s + kMmaTile;
  int* seg_s = reinterpret_cast<int*>(delta_s + kMmaTile);  // the q rows' ids
  const unsigned short* q_u16 = reinterpret_cast<const unsigned short*>(q_s);
  const unsigned short* g_u16 = reinterpret_cast<const unsigned short*>(g_s);

  const int k0 = blockIdx.x * kMmaTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = h / hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int key_a = k0 + wr + gr, key_b = key_a + 8;
  const bool bias = mk.kbias != nullptr;
  // this thread's two keys: ids and biases, read once
  const int kseg[2] = {kMask && key_a < lk ? ptt::seg_of(mk, b, lk, key_a) : 0,
                       kMask && key_b < lk ? ptt::seg_of(mk, b, lk, key_b) : 0};
  const float kb[2] = {kMask && key_a < lk ? ptt::bias_of(mk, b, lk, key_a) : 0.f,
                       kMask && key_b < lk ? ptt::bias_of(mk, b, lk, key_b) : 0.f};

  ptt::load_rows<D>(k_s, k, b, k0, lk, hk, kvh, d, vec);
  ptt::load_rows<D>(v_s, v, b, k0, lk, hk, kvh, d, vec);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  // causal: q tiles wholly above the diagonal see none of these keys
  // (kRing: each q tile is tested by its absolute rows, which jump)
  const int q_begin = causal && !kRing ? k0 : 0;
  for (int r = 0; r < rep; ++r) {
    const int head = kvh * rep + r;
    const size_t stats = ((size_t)b * h + head) * s;
    for (int q0 = q_begin; q0 < s; q0 += kMmaTile) {
      const int qp = kRing ? ptt::ring_qpos(rg, q0) : 0;  // row i at qp + i
      if (kRing && causal && qp + q0 + kMmaTile - 1 < k0) continue;
      __syncthreads();  // the previous tile's readers are done
      ptt::load_rows<D>(q_s, q, b, q0, s, h, head, d, vec);
      ptt::load_rows<D>(g_s, g, b, q0, s, h, head, d, vec);
      for (int e = threadIdx.x; e < kMmaTile; e += kMmaThreads) {
        const int i = q0 + e;
        lse_s[e] = i < s ? lse[stats + i] : 0.f;
        delta_s[e] = i < s ? delta[stats + i] : 0.f;
        if constexpr (kMask) seg_s[e] = i < s ? ptt::seg_of(mk, b, s, i) : 0;
      }
      __syncthreads();
#pragma unroll
      for (int c0 = 0; c0 < kMmaTile; c0 += kPass) {
        // causal: every q row of this pass precedes this warp's keys
        if (causal && qp + q0 + c0 + kPass - 1 < k0 + wr) continue;
        float st[kPass / 8][4], dpt[kPass / 8][4];
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], va[4];
          a_rows<ST>(ka, k_s, wr, kk, gr, t);
          a_rows<ST>(va, v_s, wr, kk, gr, t);
#pragma unroll
          for (int nt = 0; nt < kPass / 8; ++nt) {
            const T* pq = q_s + (c0 + nt * 8 + gr) * ST + kk * 16 + 2 * t;
            const T* pg = g_s + (c0 + nt * 8 + gr) * ST + kk * 16 + 2 * t;
            mma<T>(st[nt], ka, ld_u32(pq), ld_u32(pq + 8));
            mma<T>(dpt[nt], va, ld_u32(pg), ld_u32(pg + 8));
          }
        }
        // p^T and ds^T, packed: score tiles 2kk and 2kk+1 are step kk's A
        uint32_t pf[kPass / 16][4], dsf[kPass / 16][4];
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt) {
          float pv[4], dsv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = e < 2 ? key_a : key_b;
            const int qc = c0 + nt * 8 + 2 * t + (e & 1);
            const int qi = q0 + qc;
            pv[e] = 0.f;
            if constexpr (kMask) {
              const bool live =
                  (!causal || kj <= qi) && kseg[e >> 1] == seg_s[qc];
              if (kj < lk && qi < s)
                pv[e] = masked_p(st[nt][e], scale, kb[e >> 1], bias, live,
                                 lse_s[qc]);
            } else if (kj < lk && qi < s && (!causal || kj <= qp + qi)) {
              pv[e] = expf(st[nt][e] * scale - lse_s[qc]);
            }
            dsv[e] = pv[e] * (dpt[nt][e] - delta_s[qc]) * scale;
          }
          pf[nt / 2][(nt % 2) * 2] = pack<T>(pv[0], pv[1]);
          pf[nt / 2][(nt % 2) * 2 + 1] = pack<T>(pv[2], pv[3]);
          dsf[nt / 2][(nt % 2) * 2] = pack<T>(dsv[0], dsv[1]);
          dsf[nt / 2][(nt % 2) * 2 + 1] = pack<T>(dsv[2], dsv[3]);
        }
#pragma unroll
        for (int kk = 0; kk < kPass / 16; ++kk)
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            uint32_t b0, b1;
            b_rows<ST>(g_u16, c0 + kk * 16, dt * 8 + gr, t, b0, b1);
            mma<T>(dv_acc[dt], pf[kk], b0, b1);
            b_rows<ST>(q_u16, c0 + kk * 16, dt * 8 + gr, t, b0, b1);
            mma<T>(dk_acc[dt], dsf[kk], b0, b1);
          }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? key_b : key_a;
    if (kj >= lk) continue;
    const size_t row = ((size_t)(b * lk + kj) * hk + kvh) * d;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < d) {
        dk[row + col] = from_f32<T>(dk_acc[dt][2 * half]);
        dv[row + col] = from_f32<T>(dv_acc[dt][2 * half]);
      }
      if (col + 1 < d) {
        dk[row + col + 1] = from_f32<T>(dk_acc[dt][2 * half + 1]);
        dv[row + col + 1] = from_f32<T>(dv_acc[dt][2 * half + 1]);
      }
    }
  }
}

// One block per (64-row q tile, q head, batch); warp w owns q rows
// 16w..16w+15 with Q and G as register fragments and dq in f32 registers.
// Per key tile it computes s = Q K^T and dp = G V^T 32 keys at a time; ds,
// packed to T, is the A fragment of dq += ds K.
template <typename T, int D, bool kMask, bool kRing>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Masking mk, Ring rg, int s, int lk, int h, int hk,
                        int d, int causal, float scale, bool vec) {
  constexpr int ST = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = q_s + kMmaTile * ST;
  T* k_s = g_s + kMmaTile * ST;
  T* v_s = k_s + kMmaTile * ST;
  const unsigned short* k_u16 = reinterpret_cast<const unsigned short*>(k_s);

  const int q0 = blockIdx.x * kMmaTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row_a = q0 + wr + gr, row_b = row_a + 8;

  ptt::load_rows<D>(q_s, q, b, q0, s, h, head, d, vec);
  ptt::load_rows<D>(g_s, g, b, q0, s, h, head, d, vec);
  const size_t stats = ((size_t)b * h + head) * s;
  const bool bias = mk.kbias != nullptr;
  float lse_r[2], delta_r[2];
  int qseg[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? row_b : row_a;
    lse_r[half] = qi < s ? lse[stats + qi] : 0.f;
    delta_r[half] = qi < s ? delta[stats + qi] : 0.f;
    qseg[half] = kMask && qi < s ? ptt::seg_of(mk, b, s, qi) : 0;
  }
  __syncthreads();
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a_rows<ST>(qf[kk], q_s, wr, kk, gr, t);
    a_rows<ST>(gf[kk], g_s, wr, kk, gr, t);
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dt][e] = 0.f;

  const int qp = kRing ? ptt::ring_qpos(rg, q0) : 0;  // row i at qp + i
  // causal: key tiles wholly past the diagonal contribute nothing
  const int k_end = causal ? min(lk, qp + min(s, q0 + kMmaTile)) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kMmaTile) {
    __syncthreads();  // the previous tile's readers are done
    ptt::load_rows<D>(k_s, k, b, k0, lk, hk, kvh, d, vec);
    ptt::load_rows<D>(v_s, v, b, k0, lk, hk, kvh, d, vec);
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < kMmaTile; c0 += kPass) {
      // causal: every key of this pass follows this warp's rows
      if (causal && k0 + c0 > qp + q0 + wr + 15) continue;
      float sc[kPass / 8][4], dp[kPass / 8][4];
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt) {
          const T* pk = k_s + (c0 + nt * 8 + gr) * ST + kk * 16 + 2 * t;
          const T* pv = v_s + (c0 + nt * 8 + gr) * ST + kk * 16 + 2 * t;
          mma<T>(sc[nt], qf[kk], ld_u32(pk), ld_u32(pk + 8));
          mma<T>(dp[nt], gf[kk], ld_u32(pv), ld_u32(pv + 8));
        }
      uint32_t dsf[kPass / 16][4];
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
        float dsv[4];
        int kseg[2];
        float kb[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + c0 + nt * 8 + 2 * t + c;
          kseg[c] = kMask && kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
          kb[c] = kMask && kj < lk ? ptt::bias_of(mk, b, lk, kj) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = e < 2 ? row_a : row_b;
          const int kj = k0 + c0 + nt * 8 + 2 * t + (e & 1);
          float p = 0.f;
          if constexpr (kMask) {
            const bool live =
                (!causal || kj <= qi) && kseg[e & 1] == qseg[e >> 1];
            if (kj < lk && qi < s)
              p = masked_p(sc[nt][e], scale, kb[e & 1], bias, live,
                           lse_r[e >> 1]);
          } else if (kj < lk && qi < s && (!causal || kj <= qp + qi)) {
            p = expf(sc[nt][e] * scale - lse_r[e >> 1]);
          }
          dsv[e] = p * (dp[nt][e] - delta_r[e >> 1]) * scale;
        }
        dsf[nt / 2][(nt % 2) * 2] = pack<T>(dsv[0], dsv[1]);
        dsf[nt / 2][(nt % 2) * 2 + 1] = pack<T>(dsv[2], dsv[3]);
      }
#pragma unroll
      for (int kk = 0; kk < kPass / 16; ++kk)
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t b0, b1;
          b_rows<ST>(k_u16, c0 + kk * 16, dt * 8 + gr, t, b0, b1);
          mma<T>(dq_acc[dt], dsf[kk], b0, b1);
        }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? row_b : row_a;
    if (qi >= s) continue;
    T* row = dq + ((size_t)(b * s + qi) * h + head) * d;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < d) row[col] = from_f32<T>(dq_acc[dt][2 * half]);
      if (col + 1 < d) row[col + 1] = from_f32<T>(dq_acc[dt][2 * half + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, Masking mk, Ring rg,
                       int b, int s, int lk, int h, int hk, int d, int causal,
                       float scale, cudaStream_t stream) {
  const size_t tiles_bytes = sizeof(T) * 4 * (size_t)kMmaTile * (D + 8);
  // and the q rows' lse, delta and segment ids
  const size_t smem_dkdv = tiles_bytes + sizeof(float) * 3 * kMmaTile;
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int var = ptt::variant(mk, rg);
  auto dkdv = var == 2   ? flash_bwd_dkdv_mma_kernel<T, D, false, true>
              : var == 1 ? flash_bwd_dkdv_mma_kernel<T, D, true, false>
                         : flash_bwd_dkdv_mma_kernel<T, D, false, false>;
  auto dqk = var == 2   ? flash_bwd_dq_mma_kernel<T, D, false, true>
             : var == 1 ? flash_bwd_dq_mma_kernel<T, D, true, false>
                        : flash_bwd_dq_mma_kernel<T, D, false, false>;
  static ptt::SmemLimit limit_dkdv[3], limit_dq[3];  // one per instantiation
  cudaError_t err = limit_dkdv[var].reserve(dkdv, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = limit_dq[var].reserve(dqk, tiles_bytes);
  if (err != cudaSuccess) return err;
  const T* qb = static_cast<const T*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  const T* gb = static_cast<const T*>(g);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  dkdv<<<dim3((lk + kMmaTile - 1) / kMmaTile, hk, b), kMmaThreads, smem_dkdv,
         stream>>>(qb, kb, vb, gb, lse_f, delta_f, static_cast<T*>(dk),
                   static_cast<T*>(dv), mk, rg, s, lk, h, hk, d, causal,
                   scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((s + kMmaTile - 1) / kMmaTile, h, b), kMmaThreads, tiles_bytes,
        stream>>>(qb, kb, vb, gb, lse_f, delta_f, static_cast<T*>(dq), mk,
                  rg, s, lk, h, hk, d, causal, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper kernels: T = bf16 or fp16, d = D in {64, 128}, TMA loads and
// wgmma products.
// ---------------------------------------------------------------------------

namespace hop {

using namespace ptt::hop;  // barriers, TMA, descriptors, wgmma (hopper.cuh)

constexpr int kStages = 2;                 // the streamed tiles' ring
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
// the dk/dv kernel: a whole producer warpgroup, so `setmaxnreg` can move
// its registers to the consumers
constexpr int kThreadsDkdv = kConsumers + 128;
constexpr int kKeys = 128;   // dk/dv kernel: keys per block, 64 per warpgroup
constexpr int kQStep = 64;   // dk/dv kernel: q rows per streamed tile
constexpr int kRows = 128;   // dq kernel: q rows per block, 64 per warpgroup
constexpr int kKStep = 64;   // dq kernel: keys per streamed tile

// A tile of R rows x D columns is D / 64 column halves of [R][64] 16-bit
// values (R x 128 bytes each), 128-byte swizzled: TMA's box of 64 columns.
template <int R, typename T>
__device__ __forceinline__ void tma_tile(T* dst, const CUtensorMap* map,
                                          uint64_t* bar, int halves, int head,
                                          int row0, int b) {
  for (int hf = 0; hf < halves; ++hf)
    tma_load_4d(dst + hf * R * 64, map, bar, hf * 64, head, row0, b);
}

// dk/dv kernel shared memory, in bytes from a 1024-byte-aligned base: K and
// V of the block's keys, the Q and dO rings, each stage's lse, delta and
// segment ids [3][kQStep] (f32, f32, int32), then the barriers.
template <int D>
struct DkdvSmem {
  static constexpr size_t kKV = (size_t)kKeys * D * 2;  // K or V
  static constexpr size_t kT = (size_t)kQStep * D * 2;  // one Q or dO tile
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kKV;
  static constexpr size_t q = v + kKV;
  static constexpr size_t g = q + kStages * kT;
  static constexpr size_t stats = g + kStages * kT;
  static constexpr size_t bar = stats + kStages * 3 * kQStep * 4;
  static constexpr size_t bytes = bar + (2 * kStages + 1) * 8;
};

// One block per (128-key tile, kv head, batch).  The producer warp loads K
// and V once, then, for each q head of the group and each 64-row q tile
// from the diagonal (causal) on, Q and dO by TMA and the rows' lse, delta
// and segment ids into a two-stage ring; all 32 of its lanes arrive on the
// stage's full barrier (lane 0 with the TMA bytes), so their plain stores
// are released with it.  Consumer warpgroup w owns keys 64w..64w+63:
//   S^T = K.Q^T, dP^T = V.dO^T       (wgmma, both operands K-major)
//   P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta) scale
//   dV += P^T.dO, dK += dS^T.Q       (P^T, dS^T rounded to T as the
//                                     register operand; dO, Q MN-major)
// with dK and dV in f32 registers for the whole walk, written once.
// kRing (the q blocks' absolute starts): every q tile of every head is
// tested by its absolute rows, and producer and consumers skip the same
// tiles (those wholly before the block's keys); `it` counts the tiles
// that go through the ring.
template <typename T, int D, bool kMask, bool kRing>
__global__ void __launch_bounds__(kThreadsDkdv, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv,
                            Masking mk, Ring rg, int s, int lk, int h, int hk,
                            int causal, float scale) {
  using L = DkdvSmem<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* g_s = reinterpret_cast<T*>(smem + L::g);
  float* st_s = reinterpret_cast<float*>(smem + L::stats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = h / hk;
  // causal: q tiles wholly above the diagonal see none of these keys (k0 is
  // a multiple of kQStep)
  const int q_begin = causal && !kRing ? k0 : 0;
  const int n_q = (s - q_begin + kQStep - 1) / kQStep;
  const int n_iter = rep * n_q;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // the producer warpgroup hands its registers to the consumers (dK
    // and dV stay in registers for the whole walk); its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumers / 32) {
      // the producer; rows past s arrive as zeros (the tensor maps' bounds)
      if (lane == 0) {
        mbar_expect_tx(kvbar, (uint32_t)(2 * L::kKV));
        tma_tile<kKeys>(k_s, &tm_k, kvbar, kHalves, kvh, k0, b);
        tma_tile<kKeys>(v_s, &tm_v, kvbar, kHalves, kvh, k0, b);
      }
      int it = 0;
      for (int i = 0; i < n_iter; ++i) {
        const int head = kvh * rep + i / n_q;
        const int q0 = q_begin + (i % n_q) * kQStep;
        if (kRing && causal && ptt::ring_qpos(rg, q0) + q0 + kQStep - 1 < k0)
          continue;
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        ++it;
        const size_t base = ((size_t)b * h + head) * s;
        float* stg = st_s + st * 3 * kQStep;
        int* sgg = reinterpret_cast<int*>(stg + 2 * kQStep);
        for (int r = lane; r < kQStep; r += 32) {
          const int qi = q0 + r;
          stg[r] = qi < s ? lse[base + qi] * kLog2e : 0.f;
          stg[kQStep + r] = qi < s ? delta[base + qi] : 0.f;
          if constexpr (kMask) sgg[r] = qi < s ? ptt::seg_of(mk, b, s, qi) : 0;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[st], (uint32_t)(2 * L::kT));
          tma_tile<kQStep>(q_s + (size_t)st * kQStep * D, &tm_q, &full[st],
                           kHalves, head, q0, b);
          tma_tile<kQStep>(g_s + (size_t)st * kQStep * D, &tm_g, &full[st],
                           kHalves, head, q0, b);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // a consumer warpgroup: keys [k0 + 64 wg, +64); warp wq of it keys
    // 16 wq.., this thread keys g and g + 8 of those.  S^T and dP^T
    // accumulators: element 4j + e at key row g + 8 (e / 2), q column
    // 8j + 2t + (e % 2); dK and dV likewise with d columns.
    const int wg = warp / 4, wq = warp % 4;
    const int g = lane >> 2, t = lane & 3;
    const int wg_key0 = k0 + wg * 64;
    const int key_a = wg_key0 + wq * 16 + g, key_b = key_a + 8;
    const unsigned char* k_wg =
        reinterpret_cast<const unsigned char*>(k_s) + wg * 64 * 128;
    const unsigned char* v_wg =
        reinterpret_cast<const unsigned char*>(v_s) + wg * 64 * 128;
    const float sl2 = scale * kLog2e;
    const bool bias = mk.kbias != nullptr;
    // this thread's two keys: ids and biases (x log2 e), read once
    const int kseg[2] = {kMask && key_a < lk ? ptt::seg_of(mk, b, lk, key_a) : 0,
                         kMask && key_b < lk ? ptt::seg_of(mk, b, lk, key_b) : 0};
    const float kb2[2] = {
        kMask && key_a < lk ? ptt::bias_of(mk, b, lk, key_a) * kLog2e : 0.f,
        kMask && key_b < lk ? ptt::bias_of(mk, b, lk, key_b) * kLog2e : 0.f};

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(kvbar, 0);
    int it = 0;
    for (int i = 0; i < n_iter; ++i) {
      const int q0 = q_begin + (i % n_q) * kQStep;
      const int qp = kRing ? ptt::ring_qpos(rg, q0) : 0;  // row i at qp + i
      if (kRing && causal && qp + q0 + kQStep - 1 < k0) continue;  // not loaded
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      ++it;
      // causal: every q row of the tile precedes this warpgroup's keys
      if (causal && qp + q0 + kQStep - 1 < wg_key0) {
        mbar_arrive(&empty[st]);
        continue;
      }
      const unsigned char* qt =
          reinterpret_cast<const unsigned char*>(q_s + (size_t)st * kQStep * D);
      const unsigned char* gt =
          reinterpret_cast<const unsigned char*>(g_s + (size_t)st * kQStep * D);
      const float* lse2 = st_s + st * 3 * kQStep;  // lse * log2(e)
      const float* dl = lse2 + kQStep;
      const int* qsg = reinterpret_cast<const int*>(dl + kQStep);

      float sc[kQStep / 2], dp[kQStep / 2];
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // column half kk / 4, 32 bytes per 16-deep step inside it
        const size_t aoff = (size_t)(kk / 4) * (kKeys * 128) + (kk % 4) * 32;
        const size_t boff = (size_t)(kk / 4) * (kQStep * 128) + (kk % 4) * 32;
        wgmma_ss_n64<T>(sc, make_desc(k_wg + aoff, 16, 1024),
                     make_desc(qt + boff, 16, 1024), kk > 0);
        wgmma_ss_n64<T>(dp, make_desc(v_wg + aoff, 16, 1024),
                     make_desc(gt + boff, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T in T as the register A operand: q columns 16kk.. of
      // the scores are the k columns of step kk
      uint32_t pf[kQStep / 16][4], dsf[kQStep / 16][4];
#pragma unroll
      for (int j = 0; j < kQStep / 8; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int qi = q0 + c;
          const int kj = e < 2 ? key_a : key_b;
          // pairs past s are exactly 0: they add nothing to any sum
          pv[e] = 0.f;
          if constexpr (kMask) {
            const bool live = (!causal || kj <= qi) && kseg[e >> 1] == qsg[c];
            if (kj < lk && qi < s)
              pv[e] = masked_p2(sc[4 * j + e], sl2, kb2[e >> 1], bias, live,
                                lse2[c]);
          } else if (kj < lk && qi < s && (!causal || kj <= qp + qi)) {
            pv[e] = exp2f(sc[4 * j + e] * sl2 - lse2[c]);
          }
          dsv[e] = pv[e] * (dp[4 * j + e] - dl[c]) * scale;
        }
        pf[j / 2][(j % 2) * 2] = pack<T>(pv[0], pv[1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack<T>(pv[2], pv[3]);
        dsf[j / 2][(j % 2) * 2] = pack<T>(dsv[0], dsv[1]);
        dsf[j / 2][(j % 2) * 2 + 1] = pack<T>(dsv[2], dsv[3]);
      }
      fence_regs(dva);
      fence_regs(dka);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kQStep / 16; ++kk) {
        // 16 q rows = two 1024-byte atoms per step; the next 64 d columns
        // lie one column half (kQStep rows of 128 bytes) further
        const uint64_t dg = make_desc(gt + kk * 2048, kQStep * 128, 1024);
        const uint64_t dqd = make_desc(qt + kk * 2048, kQStep * 128, 1024);
        if constexpr (D == 128) {
          wgmma_rs_n128<T>(dva, pf[kk], dg);
          wgmma_rs_n128<T>(dka, dsf[kk], dqd);
        } else {
          wgmma_rs_n64<T>(dva, pf[kk], dg);
          wgmma_rs_n64<T>(dka, dsf[kk], dqd);
        }
      }
      wg_commit();
      wg_wait0();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[st]);  // this thread is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = r ? key_b : key_a;
      if (kj >= lk) continue;
      const size_t row = ((size_t)(b * lk + kj) * hk + kvh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * j + 2 * t) =
            pack<T>(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * j + 2 * t) =
            pack<T>(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dq kernel shared memory: Q and dO of the block's rows, the K and V rings,
// each stage's key ids [kKStep] int32 and key biases x log2(e) [kKStep]
// f32 (masked launches), then the barriers.
template <int D>
struct DqSmem {
  static constexpr size_t kT = (size_t)kRows * D * 2;    // Q or dO
  static constexpr size_t kKV = (size_t)kKStep * D * 2;  // one K or V tile
  static constexpr size_t q = 0;
  static constexpr size_t g = q + kT;
  static constexpr size_t k = g + kT;
  static constexpr size_t v = k + kStages * kKV;
  static constexpr size_t mask = v + kStages * kKV;
  static constexpr size_t bar = mask + kStages * kKStep * 8;
  static constexpr size_t bytes = bar + (2 * kStages + 1) * 8;
};

// One block per (128-row q tile, q head, batch), longest causal tiles
// first.  The producer loads Q and dO once, then K and V tiles of 64 keys
// up to the diagonal into a two-stage ring.  Consumer warpgroup w owns q
// rows 64w..64w+63:
//   S = Q.K^T, dP = dO.V^T           (wgmma, both operands K-major)
//   dS = exp(scale S - lse) (dP - delta) scale, rounded to T
//   dQ += dS.K                       (K MN-major)
// dQ in f32 registers, written once: no atomics, so dq is deterministic.
template <typename T, int D, bool kMask, bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, Masking mk, Ring rg, int s,
                          int lk, int h, int hk, int causal, float scale) {
  using L = DqSmem<D>;
  constexpr int kHalves = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* q_s = reinterpret_cast<T*>(smem + L::q);
  T* g_s = reinterpret_cast<T*>(smem + L::g);
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  int* kseg_s = reinterpret_cast<int*>(smem + L::mask);  // [kStages][kKStep]
  float* kb_s = reinterpret_cast<float*>(kseg_s + kStages * kKStep);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hk);
  const int qp = kRing ? ptt::ring_qpos(rg, q0) : 0;  // row i at qp + i
  // causal: key tiles wholly past the tile's last row contribute nothing
  const int k_end = causal ? min(lk, qp + min(s, q0 + kRows)) : lk;
  const int n_tiles = (k_end + kKStep - 1) / kKStep;

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
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32 && kMask) {
    // the producer of a masked launch: as below, and all 32 lanes stage
    // each key tile's ids and biases (x log2 e) beside it, arriving on the
    // stage's full barrier (lane 0 with the TMA bytes) to release them
    if (lane == 0) {
      mbar_expect_tx(qbar, (uint32_t)(2 * L::kT));
      tma_tile<kRows>(q_s, &tm_q, qbar, kHalves, head, q0, b);
      tma_tile<kRows>(g_s, &tm_g, qbar, kHalves, head, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      for (int r = lane; r < kKStep; r += 32) {
        const int kj = i * kKStep + r;
        kseg_s[st * kKStep + r] = kj < lk ? ptt::seg_of(mk, b, lk, kj) : 0;
        kb_s[st * kKStep + r] = kj < lk ? ptt::bias_of(mk, b, lk, kj) * kLog2e : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[st], (uint32_t)(2 * L::kKV));
        tma_tile<kKStep>(k_s + (size_t)st * kKStep * D, &tm_k, &full[st],
                          kHalves, kvh, i * kKStep, b);
        tma_tile<kKStep>(v_s + (size_t)st * kKStep * D, &tm_v, &full[st],
                          kHalves, kvh, i * kKStep, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }
  if (warp == kConsumers / 32) {
    if (lane == 0) {
      mbar_expect_tx(qbar, (uint32_t)(2 * L::kT));
      tma_tile<kRows>(q_s, &tm_q, qbar, kHalves, head, q0, b);
      tma_tile<kRows>(g_s, &tm_g, qbar, kHalves, head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], (uint32_t)(2 * L::kKV));
        tma_tile<kKStep>(k_s + (size_t)st * kKStep * D, &tm_k, &full[st],
                          kHalves, kvh, i * kKStep, b);
        tma_tile<kKStep>(v_s + (size_t)st * kKStep * D, &tm_v, &full[st],
                          kHalves, kvh, i * kKStep, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows [q0 + 64 wg, +64); this thread rows g and
  // g + 8 of warp wq's 16
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + wq * 16 + g, row_b = row_a + 8;
  const int wg_last = q0 + wg * 64 + 63;
  const unsigned char* q_wg =
      reinterpret_cast<const unsigned char*>(q_s) + wg * 64 * 128;
  const unsigned char* g_wg =
      reinterpret_cast<const unsigned char*>(g_s) + wg * 64 * 128;
  const float sl2 = scale * kLog2e;
  const size_t stats = ((size_t)b * h + head) * s;
  const bool bias = mk.kbias != nullptr;
  float lse2[2], dl[2];
  int qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row_b : row_a;
    lse2[r] = qi < s ? lse[stats + qi] * kLog2e : 0.f;
    dl[r] = qi < s ? delta[stats + qi] : 0.f;
    qseg[r] = kMask && qi < s ? ptt::seg_of(mk, b, s, qi) : 0;
  }

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int kb = i * kKStep;
    mbar_wait(&full[st], (i / kStages) & 1);
    // causal: every key of the tile follows this warpgroup's rows
    if (causal && kb > qp + wg_last) {
      mbar_arrive(&empty[st]);
      continue;
    }
    const unsigned char* kt =
        reinterpret_cast<const unsigned char*>(k_s + (size_t)st * kKStep * D);
    const unsigned char* vt =
        reinterpret_cast<const unsigned char*>(v_s + (size_t)st * kKStep * D);

    float sc[kKStep / 2], dp[kKStep / 2];
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const size_t aoff = (size_t)(kk / 4) * (kRows * 128) + (kk % 4) * 32;
      const size_t boff = (size_t)(kk / 4) * (kKStep * 128) + (kk % 4) * 32;
      wgmma_ss_n64<T>(sc, make_desc(q_wg + aoff, 16, 1024),
                   make_desc(kt + boff, 16, 1024), kk > 0);
      wgmma_ss_n64<T>(dp, make_desc(g_wg + aoff, 16, 1024),
                   make_desc(vt + boff, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    fence_regs(dp);

    uint32_t dsf[kKStep / 16][4];
#pragma unroll
    for (int j = 0; j < kKStep / 8; ++j) {
      float dsv[4];
      int kseg[2];
      float kb2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // staged by the producer
        kseg[c] = kMask ? kseg_s[st * kKStep + 8 * j + 2 * t + c] : 0;
        kb2[c] = kMask ? kb_s[st * kKStep + 8 * j + 2 * t + c] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? row_a : row_b;
        const int kj = kb + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if constexpr (kMask) {
          const bool live =
              (!causal || kj <= qi) && kseg[e & 1] == qseg[e >> 1];
          if (kj < lk && qi < s)
            p = masked_p2(sc[4 * j + e], sl2, kb2[e & 1], bias, live,
                          lse2[e >> 1]);
        } else if (kj < lk && qi < s && (!causal || kj <= qp + qi)) {
          p = exp2f(sc[4 * j + e] * sl2 - lse2[e >> 1]);
        }
        dsv[e] = p * (dp[4 * j + e] - dl[e >> 1]) * scale;
      }
      dsf[j / 2][(j % 2) * 2] = pack<T>(dsv[0], dsv[1]);
      dsf[j / 2][(j % 2) * 2 + 1] = pack<T>(dsv[2], dsv[3]);
    }
    fence_regs(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk) {
      // 16 keys = two atoms per step; the next 64 d columns one half further
      const uint64_t db = make_desc(kt + kk * 2048, kKStep * 128, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128<T>(dqa, dsf[kk], db);
      else
        wgmma_rs_n64<T>(dqa, dsf[kk], db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(dqa);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row_b : row_a;
    if (qi >= s) continue;
    T* row = dq + ((size_t)(b * s + qi) * h + head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
          pack<T>(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, Masking mk, Ring rg, int b, int s, int lk, int h,
                   int hk, int causal, float scale, cudaStream_t stream) {
  // the dk/dv kernel streams 64-row Q/dO tiles against 128 keys; the dq
  // kernel 64-key K/V tiles against 128 rows
  CUtensorMap q64, g64, k128, v128, q128, g128, k64, v64;
  if (!make_map<T>(&q64, q, b, s, h, D, kQStep) ||
      !make_map<T>(&g64, g, b, s, h, D, kQStep) ||
      !make_map<T>(&k128, k, b, lk, hk, D, kKeys) ||
      !make_map<T>(&v128, v, b, lk, hk, D, kKeys) ||
      !make_map<T>(&q128, q, b, s, h, D, kRows) ||
      !make_map<T>(&g128, g, b, s, h, D, kRows) ||
      !make_map<T>(&k64, k, b, lk, hk, D, kKStep) ||
      !make_map<T>(&v64, v, b, lk, hk, D, kKStep))
    return cudaErrorNotSupported;
  const size_t smem_dkdv = DkdvSmem<D>::bytes + 1024;  // + the alignment
  const size_t smem_dq = DqSmem<D>::bytes + 1024;
  const int var = ptt::variant(mk, rg);
  auto dkdv = var == 2   ? flash_bwd_dkdv_wgmma_kernel<T, D, false, true>
              : var == 1 ? flash_bwd_dkdv_wgmma_kernel<T, D, true, false>
                         : flash_bwd_dkdv_wgmma_kernel<T, D, false, false>;
  auto dqk = var == 2   ? flash_bwd_dq_wgmma_kernel<T, D, false, true>
             : var == 1 ? flash_bwd_dq_wgmma_kernel<T, D, true, false>
                        : flash_bwd_dq_wgmma_kernel<T, D, false, false>;
  static ptt::SmemLimit limit_dkdv[3], limit_dq[3];  // one per instantiation
  cudaError_t err = limit_dkdv[var].reserve(dkdv, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = limit_dq[var].reserve(dqk, smem_dq);
  if (err != cudaSuccess) return err;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  dkdv<<<dim3((lk + kKeys - 1) / kKeys, hk, b), kThreadsDkdv, smem_dkdv,
         stream>>>(
      q64, k128, v128, g64, lse_f, delta_f, static_cast<T*>(dk),
      static_cast<T*>(dv), mk, rg, s, lk, h, hk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((s + kRows - 1) / kRows, h, b), kThreads, smem_dq, stream>>>(
      q128, k64, v64, g128, lse_f, delta_f, static_cast<T*>(dq), mk, rg, s,
      lk, h, hk, causal, scale);
  return cudaGetLastError();
}

}  // namespace hop

// Kernel choices, picked by the host (`flash_path`, as for K1).
constexpr int kPathFma = 0;    // f32 FMA, any dtype and d
constexpr int kPathMma = 1;    // mma.sync, bf16 or fp16 d <= 128
constexpr int kPathWgmma = 2;  // wgmma + TMA, bf16 or fp16 d = 64 or 128

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The products of the kernel `path` names in element type T (bf16 or
// fp16), after the delta pre-pass; a path the shape does not fit is
// cudaErrorInvalidValue, never another kernel.
template <typename T>
cudaError_t backward16(int path, const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, Masking mk, Ring rg,
                       int b, int s, int lk, int h, int hk, int d, int causal,
                       float scale, cudaStream_t st) {
  if (path == kPathWgmma) {
    if ((d != 64 && d != 128) || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(g))
      return cudaErrorInvalidValue;
    if (d == 64)
      return hop::launch<T, 64>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg, b,
                                s, lk, h, hk, causal, scale, st);
    return hop::launch<T, 128>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg, b,
                               s, lk, h, hk, causal, scale, st);
  }
  if (path == kPathMma) {
    if (d > 128) return cudaErrorInvalidValue;
    if (d <= 64)
      return launch_mma<T, 64>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg, b,
                               s, lk, h, hk, d, causal, scale, st);
    return launch_mma<T, 128>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg, b, s,
                              lk, h, hk, d, causal, scale, st);
  }
  if (path != kPathFma) return cudaErrorInvalidValue;
  return launch_fma<T, 32, 16>(q, k, v, g, lse, delta, dq, dk, dv, mk, rg, b,
                               s, lk, h, hk, d, causal, scale, st);
}

// The products of the kernel `path` names, after the delta pre-pass; bf16
// and fp16 take the same paths.
cudaError_t backward(int path, const void* q, const void* k, const void* v,
                     const void* g, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, Masking mk, Ring rg, int b,
                     int s, int lk, int h, int hk, int d, int causal,
                     float scale, int dtype, cudaStream_t st) {
  if (dtype == ptt::kBFloat16)
    return backward16<__nv_bfloat16>(path, q, k, v, g, lse, delta, dq, dk, dv,
                                     mk, rg, b, s, lk, h, hk, d, causal,
                                     scale, st);
  if (dtype == ptt::kFloat16)
    return backward16<__half>(path, q, k, v, g, lse, delta, dq, dk, dv, mk, rg,
                              b, s, lk, h, hk, d, causal, scale, st);
  if (path != kPathFma) return cudaErrorInvalidValue;
  return dispatch_fma_f32(q, k, v, g, lse, delta, dq, dk, dv, mk, rg, b, s, lk,
                          h, hk, d, causal, scale, st);
}

// The delta pre-pass in the inputs' dtype.
cudaError_t delta_pass(int dtype, const void* g, const void* out, void* delta,
                       int b, int s, int h, int d, cudaStream_t st) {
  if (dtype == ptt::kBFloat16)
    return launch_delta<__nv_bfloat16>(g, out, delta, b, s, h, d, st);
  if (dtype == ptt::kFloat16)
    return launch_delta<__half>(g, out, delta, b, s, h, d, st);
  return launch_delta<float>(g, out, delta, b, s, h, d, st);
}

bool known_dtype(int dtype) {
  return dtype == ptt::kBFloat16 || dtype == ptt::kFloat16 ||
         dtype == ptt::kFloat32;
}

}  // namespace

// q, out, g, dq: [b, s, h, d]; k, v, dk, dv: [b, s, hk, d], all contiguous
// and of one dtype; lse: [b, h, s] f32 from K1; delta: [b, h, s] f32
// scratch, written here.  path: 0 the FMA kernels, 1 mma.sync, 2 wgmma +
// TMA.  segments ([b, s] int32) and kbias ([b, s] f32), each contiguous or
// null, as K1 got them.
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* lse, const void* g,
                             void* dq, void* dk, void* dv, void* delta, int b,
                             int s, int h, int hk, int d, int causal,
                             float scale, int dtype, int path,
                             const void* segments, const void* kbias,
                             void* stream) {
  if (b < 1 || s < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256 ||
      h > 65535 || b > 65535 || !known_dtype(dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = delta_pass(dtype, g, out, delta, b, s, h, d, st);
  if (err != cudaSuccess) return (int)err;
  const Masking mk{static_cast<const int*>(segments),
                   static_cast<const float*>(kbias)};
  return (int)backward(path, q, k, v, g, lse, delta, dq, dk, dv, mk, Ring{},
                       b, s, s, h, hk, d, causal, scale, dtype, st);
}

// K3 with the ring operands (ring attention's hops and gathered form).
// q, g, dq: [b, s, h, d]; k, v, dk, dv: [b, lk, hk, d] (lk may differ from
// s), of one dtype; lse: [b, h, s] f32 from K1.  q_offset: [s / bq] int32
// absolute block starts as for ptt_flash_fwd_ring, or null.  delta: [b, h,
// s] f32; delta_given: read it as it is (rowsum(g * out), computed once by
// the ring for every hop) and never read `out`; else the pre-pass writes
// it from g and out ([b, s, h, d] in q's dtype).  Contiguous; no segment
// ids or key bias.
extern "C" int ptt_flash_bwd_ring(const void* q, const void* k, const void* v,
                                  const void* out, const void* lse,
                                  const void* g, void* dq, void* dk, void* dv,
                                  void* delta, const void* q_offset, int b,
                                  int s, int lk, int h, int hk, int d, int bq,
                                  int causal, float scale, int dtype, int path,
                                  int delta_given, void* stream) {
  if (b < 1 || s < 1 || lk < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 ||
      d > 256 || h > 65535 || b > 65535 || !known_dtype(dtype) ||
      (q_offset != nullptr && (bq < 128 || bq % 128 != 0 || s % bq != 0)) ||
      (!delta_given && out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!delta_given) {
    const cudaError_t err = delta_pass(dtype, g, out, delta, b, s, h, d, st);
    if (err != cudaSuccess) return (int)err;
  }
  const Ring rg{static_cast<const int*>(q_offset), bq, nullptr, nullptr,
                nullptr};
  return (int)backward(path, q, k, v, g, lse, delta, dq, dk, dv,
                       Masking{nullptr, nullptr}, rg, b, s, lk, h, hk, d,
                       causal, scale, dtype, st);
}
