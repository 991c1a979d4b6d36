// K2 `paged_decode_fused`, K4 `paged_decode_fused_q8` and K5
// `paged_decode_partials` (+ its int8 variant): paged attention for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels `_fused_paged_decode_forward`
// (paddle_tpu/ops/flash_attention.py:813, inline kernel :856),
// `_fused_paged_decode_quant_forward` (:961, call :1063) and
// `_fused_paged_decode_partials_forward` (:1172, call :1310).  All read the
// K/V page arena THROUGH the per-slot page tables inside the kernel, so the
// dense per-sequence copy that the gather path writes (`paged_gather_kv`)
// never exists.  K4 is the same kernel over an int8 arena: each stored row
// carries a float32 scale per kv head in a parallel `[pages, ps, hk, 1]`
// arena, and the tile loader writes `float(int8) * scale` into the same
// float32 shared-memory tiles K2 fills from bf16.
//
// Bound on an H100: decode attention does 4*R*d FLOPs per key row against
// 2*d*2 bytes of K and V (bf16; 2*(d + 4) bytes under int8) -- about R
// FLOP per byte, far below the card's ~295 FLOP/byte balance point -- so
// it is bound by the bytes of the pages it must read: each slot's live K/V
// rows of every kv head, once.  The design answers that bound:
//  - one block per (slot, kv head, row tile, split) holds up to 64 rows of
//    the GQA group x window (R = rep * sq rows, row r = group member r / sq
//    at window offset r % sq), so a decode step's page tile is read from
//    device memory once per group, never once per q head.  A chunk prefill
//    (sq up to the largest prefill bucket) splits its rows over more tiles;
//  - pages past the newest position a tile's rows can see are skipped, so
//    only the live rows are read, not max_len rows per slot;
//  - a slot's page walk is split across `splits` blocks of ceil(P / splits)
//    pages each (the caller picks splits so a block walks about 512 keys per
//    row it holds, at least one page; the TPU walks pages in one sequential
//    grid, and here one block per long sequence, or per 64-row tile of a
//    chunk, would leave the card idle), each keeping its online softmax
//    (m, l, acc) in shared memory; a combine kernel merges the splits'
//    partials -- the same merge the reference's context-parallel decode
//    does across shards (cp_softmax_combine, :1386);
//  - K/V tiles load 16 bytes per thread (8 bf16 or 16 int8 values).
// The dot products are plain f32 FMAs; a cp.async/TMA pipeline and the
// tensor cores for wide chunk tiles are the next steps.
//
// K5 is the same page walk for context-parallel decode: each cp shard runs
// it over its own slice of the arena with a local table whose columns are
// not consecutive sequence pages, so `page_base[j]` gives column j's first
// token position (j * ps when null, which is K2/K4), and in "partials" mode
// a block writes its un-normalised online-softmax state (acc, m, l) in
// place of acc / l.  The split combine then has a partials mode too
// (M = max m, L = sum l e^(m - M), acc* = sum acc e^(m - M), no divide), so
// each launch returns one (acc, m, l) per shard for the cross-shard merge.
// A shard's launch reads only that shard's live pages, so the cp shards of
// one step together move K2's bytes: the same byte bound, plus the
// partials' round trip through device memory for the merge.
//
// Masks are the reference's (:869-898, K5 :1250-1258): row r at window
// offset w = r % sq sees key jid iff jid <= pos + w and jid < max_len, with
// jid = page_base[j] + row-in-page.  Scratch page 0 (zero values, scale 0
// until masked writes land there) is fenced by the same test before any
// softmax.  K2 rounds p to bf16 before P.V as the reference
// does (`p.astype(v.dtype)`); K4 does not, because the reference's V is the
// float32 dequantized tile there.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::kNegInf;
using ptt::round_to;
using ptt::to_f32;

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

constexpr int kThreads = 128;
constexpr int kTK = 32;         // page rows per chunk (one score per lane)
constexpr int kRowTile = 64;    // rows a block holds (PAGED_ROW_TILE)

// p as the P.V product reads it: rounded to the stored dtype for K2, float32
// for K4 (its V tile is the float32 dequantized page).
template <typename TS>
__device__ __forceinline__ float round_p(float p) {
  return round_to<TS>(p);
}
template <>
__device__ __forceinline__ float round_p<int8_t>(float p) {
  return p;
}

// Shared-memory layout, in floats:
//   q_s [Rt][d], acc_s [Rt][d], k_s [kTK][dp], v_s [kTK][d], s_s [Rt][kTK],
//   m_s [Rt], l_s [Rt], a_s [Rt]
// with Rt <= kRowTile rows and dp = d + G, where G threads share one
// score's dot product (chosen so that G groups of a warp hit distinct banks
// when d % 32 == 0).
size_t smem_floats(int Rt, int d, int G) {
  return 2 * (size_t)Rt * d + (size_t)kTK * (d + G) + (size_t)kTK * d +
         (size_t)Rt * kTK + 3 * (size_t)Rt;
}

// Rows [c0, c0 + rows) of `page` for kv head g into k_s / v_s as f32 (times
// the row's scale for an int8 arena); rows past `rows` are zero.  `vec`:
// 16-byte loads (d * sizeof(TS) % 16 == 0 and aligned arenas).
template <typename TS>
__device__ __forceinline__ void load_tile(
    const TS* __restrict__ ak, const TS* __restrict__ av,
    const float* __restrict__ ks, const float* __restrict__ vs, float* k_s,
    float* v_s, size_t page, int ps, int c0, int rows, int hk, int g, int d,
    int dp, bool vec) {
  constexpr bool kQuant = std::is_same<TS, int8_t>::value;
  constexpr int VEC = 16 / sizeof(TS);
  const int tid = threadIdx.x;
  if (vec) {
    const int nv = d / VEC;
    for (int e = tid; e < kTK * nv; e += kThreads) {
      const int t = e / nv, c = (e % nv) * VEC;
      if (t < rows) {
        const size_t row = (page * ps + c0 + t) * hk + g;
        const uint4 kraw = *reinterpret_cast<const uint4*>(ak + row * d + c);
        const uint4 vraw = *reinterpret_cast<const uint4*>(av + row * d + c);
        const TS* kk = reinterpret_cast<const TS*>(&kraw);
        const TS* vv = reinterpret_cast<const TS*>(&vraw);
        float ksc = 1.f, vsc = 1.f;
        if constexpr (kQuant) {
          ksc = ks[row];
          vsc = vs[row];
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if constexpr (kQuant) {
            k_s[t * dp + c + i] = to_f32(kk[i]) * ksc;
            v_s[t * d + c + i] = to_f32(vv[i]) * vsc;
          } else {
            k_s[t * dp + c + i] = to_f32(kk[i]);
            v_s[t * d + c + i] = to_f32(vv[i]);
          }
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
      const size_t row = (page * ps + c0 + t) * hk + g;
      kv = to_f32(ak[row * d + c]);
      vv = to_f32(av[row * d + c]);
      if constexpr (kQuant) {
        kv *= ks[row];
        vv *= vs[row];
      }
    }
    k_s[t * dp + c] = kv;
    v_s[t * d + c] = vv;
  }
}

// Where finished rows go in partials mode: acc [b, hk, R, d], m and l
// [b, hk, R], float32, un-normalised (null acc: normalised rows of `out`).
struct Partials {
  float* acc;
  float* m;
  float* l;
};

// Grid (slot, kv head x row tile, split).  With one split the block writes
// its rows to `out` (normalised) or to `part`; otherwise it writes its
// unnormalised partials (acc [Rt][d], m [Rt], l [Rt]) to the workspace for
// `combine_kernel`.  T: q and out; TS: the stored K/V element.  Column j's
// first token position is page_base[j], or j * ps when page_base is null.
template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const TS* __restrict__ ak,
                    const TS* __restrict__ av, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ page_base,
                    const int* __restrict__ pos, T* __restrict__ out,
                    Partials part, float* __restrict__ ws, int sq, int h,
                    int hk, int d, int ps, int P, int max_len, float scale,
                    int G, int ntiles, bool vec) {
  extern __shared__ float smem[];
  const int slot = blockIdx.x;
  const int g = blockIdx.y / ntiles;
  const int r0 = (blockIdx.y % ntiles) * kRowTile;  // rows [r0, r0 + Rt)
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int rep = h / hk;
  const int R = rep * sq;
  const int Rt = min(kRowTile, R - r0);
  const int dp = d + G;
  float* q_s = smem;
  float* acc_s = q_s + Rt * d;
  float* k_s = acc_s + Rt * d;
  float* v_s = k_s + kTK * dp;
  float* s_s = v_s + kTK * d;
  float* m_s = s_s + Rt * kTK;
  float* l_s = m_s + Rt;
  float* a_s = l_s + Rt;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int p0 = pos[slot];
  // newest position any row of the tile sees: within one group member the
  // rows are consecutive window offsets; a tile spanning two members holds
  // the first one's last offset, sq - 1
  const int r1 = r0 + Rt - 1;
  const int last = p0 + (r0 / sq == r1 / sq ? r1 % sq : sq - 1);
  const int pps = (P + nsplit - 1) / nsplit;  // pages per split
  const int j0 = split * pps;
  const int j1 = min(P, j0 + pps);

  for (int e = tid; e < Rt * d; e += kThreads) {
    const int r = r0 + e / d, c = e % d;
    const int head = g * rep + r / sq;
    q_s[e] = to_f32(q[((size_t)(slot * sq + r % sq) * h + head) * d + c]);
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < Rt; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int pairs = Rt * kTK;  // (row, key) scores per chunk
  const int stride = kThreads / G;
  const int gl = tid % G;

  for (int j = j0; j < j1; ++j) {
    // pages entirely beyond the newest visible position contribute nothing
    const int pb = page_base != nullptr ? page_base[j] : j * ps;
    if (pb > last) continue;
    const size_t page = (size_t)tables[(size_t)slot * P + j];
    for (int c0 = 0; c0 < ps; c0 += kTK) {
      const int base = pb + c0;
      if (base > last) break;
      const int rows = min(kTK, ps - c0);
      __syncthreads();  // the previous chunk's readers are done
      load_tile(ak, av, ks, vs, k_s, v_s, page, ps, c0, rows, hk, g, d, dp,
                vec);
      __syncthreads();

      // scores: G threads per (row, key) pair, xor-shuffle reduction
      for (int pb = 0; pb < pairs; pb += stride) {
        const int pidx = pb + tid / G;
        const bool valid = pidx < pairs;
        const int rr = valid ? pidx / kTK : 0;
        const int t = valid ? pidx % kTK : 0;
        float dot = 0.f;
        if (valid)
          for (int c = gl; c < d; c += G)
            dot = fmaf(q_s[rr * d + c], k_s[t * dp + c], dot);
        for (int off = G / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (valid && gl == 0) {
          const int jid = base + t;
          const bool ok =
              t < rows && jid <= p0 + (r0 + rr) % sq && jid < max_len;
          s_s[rr * kTK + t] = ok ? dot * scale : kNegInf;
        }
      }
      __syncthreads();

      // online softmax, one warp per row, one key per lane
      for (int rr = warp; rr < Rt; rr += kThreads / 32) {
        const float x = s_s[rr * kTK + lane];
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[rr];
        const float m_new = fmaxf(m_old, mx);
        const float p = expf(x - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        s_s[rr * kTK + lane] = round_p<TS>(p);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[rr] = alpha;
          l_s[rr] = alpha * l_s[rr] + sum;
          m_s[rr] = m_new;
        }
      }
      __syncthreads();

      for (int e = tid; e < Rt * d; e += kThreads) {
        const int rr = e / d, c = e % d;
        float a = acc_s[e] * a_s[rr];
#pragma unroll 8
        for (int t = 0; t < kTK; ++t)
          a = fmaf(s_s[rr * kTK + t], v_s[t * d + c], a);
        acc_s[e] = a;
      }
    }
  }
  __syncthreads();

  if (nsplit == 1 && part.acc != nullptr) {
    // rows with no visible key keep m = -1e30 and whatever l and acc the
    // masked scores gave (as the reference's K5): the cross-shard merge's
    // e^(m - m*) = 0 removes them
    const size_t row0 = ((size_t)slot * hk + g) * R + r0;
    for (int e = tid; e < Rt * d; e += kThreads)
      part.acc[row0 * d + e] = acc_s[e];
    for (int rr = tid; rr < Rt; rr += kThreads) {
      part.m[row0 + rr] = m_s[rr];
      part.l[row0 + rr] = l_s[rr];
    }
    return;
  }
  if (nsplit == 1) {
    for (int e = tid; e < Rt * d; e += kThreads) {
      const int rr = e / d, r = r0 + rr, c = e % d;
      const int head = g * rep + r / sq;
      const float l_safe = fmaxf(l_s[rr], 1e-30f);  // masked rows give 0
      out[((size_t)(slot * sq + r % sq) * h + head) * d + c] =
          from_f32<T>(acc_s[e] / l_safe);
    }
    return;
  }
  // partials of this split at rows [r0, r0 + Rt) of the (slot, g, split)
  // region; a split past `last` leaves m = -1e30, l = 0
  const size_t region = ((size_t)slot * hk + g) * nsplit + split;
  float* ws_acc = ws + (region * R + r0) * d;
  float* ws_ml = ws + (size_t)gridDim.x * hk * nsplit * R * d +
                 (region * R + r0) * 2;
  for (int e = tid; e < Rt * d; e += kThreads) ws_acc[e] = acc_s[e];
  for (int rr = tid; rr < Rt; rr += kThreads) {
    ws_ml[2 * rr] = m_s[rr];
    ws_ml[2 * rr + 1] = l_s[rr];
  }
}

// Merge the splits' (acc, m, l) per row: M = max m, L = sum l e^(m - M),
// out = sum acc e^(m - M) / max(L, 1e-30); in partials mode (part.acc
// non-null) write (sum acc e^(m - M), M, L) undivided.  Grid (slot, kv head
// x row tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
               Partials part, int nsplit, int sq, int h, int hk, int d,
               int ntiles) {
  const int slot = blockIdx.x;
  const int g = blockIdx.y / ntiles;
  const int r0 = (blockIdx.y % ntiles) * kRowTile;
  const int rep = h / hk;
  const int R = rep * sq;
  const int Rt = min(kRowTile, R - r0);
  const float* acc = ws + ((size_t)slot * hk + g) * nsplit * R * d;
  const float* ml = ws + (size_t)gridDim.x * hk * nsplit * R * d +
                    ((size_t)slot * hk + g) * nsplit * R * 2;
  for (int e = threadIdx.x; e < Rt * d; e += kThreads) {
    const int r = r0 + e / d, c = e % d;
    float M = kNegInf;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[((size_t)s * R + r) * 2]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[((size_t)s * R + r) * 2] - M);
      L += w * ml[((size_t)s * R + r) * 2 + 1];
      A += w * acc[((size_t)s * R + r) * d + c];
    }
    if (part.acc != nullptr) {
      const size_t row = ((size_t)slot * hk + g) * R + r;
      part.acc[row * d + c] = A;
      if (c == 0) {
        part.m[row] = M;
        part.l[row] = L;
      }
      continue;
    }
    const int head = g * rep + r / sq;
    out[((size_t)(slot * sq + r % sq) * h + head) * d + c] =
        from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

constexpr Partials kNoPartials{nullptr, nullptr, nullptr};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename TS>
cudaError_t launch(const void* q, const void* ak, const void* av,
                   const void* ks, const void* vs, const void* tables,
                   const void* page_base, const void* pos, void* out,
                   Partials part, void* ws, int nsplit, int b, int sq, int h,
                   int hk, int d, int ps, int P, int max_len, float scale,
                   cudaStream_t stream) {
  const int R = (h / hk) * sq;
  const int Rt = min(R, kRowTile);
  const int ntiles = (R + kRowTile - 1) / kRowTile;
  if ((long long)hk * ntiles > 65535) return cudaErrorInvalidValue;
  int G = 32;  // largest power of two with G * pairs <= threads (>= 1)
  while (G > 1 && G * Rt * kTK > kThreads) G >>= 1;
  const bool vec =
      (d * sizeof(TS)) % 16 == 0 && aligned16(ak) && aligned16(av);
  if (nsplit > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (part.acc != nullptr ? (part.m == nullptr || part.l == nullptr)
                          : out == nullptr)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Rt, d, G);
  auto kernel = paged_decode_kernel<T, TS>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, hk * ntiles, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TS*>(ak),
      static_cast<const TS*>(av), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(page_base), static_cast<const int*>(pos),
      static_cast<T*>(out), part, static_cast<float*>(ws), sq, h, hk, d, ps,
      P, max_len, scale, G, ntiles, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  combine_kernel<T><<<dim3(b, hk * ntiles), kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), part, nsplit, sq,
      h, hk, d, ntiles);
  return cudaGetLastError();
}

bool bad_shape(int b, int sq, int h, int hk, int d, int ps, int P,
               int splits) {
  return b < 1 || sq < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 ||
         d > 256 || ps < 1 || P < 1 || splits < 1 || splits > P;
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
  if (bad_shape(b, sq, h, hk, d, ps, P, splits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, ak, av, nullptr, nullptr, tables, nullptr, pos, out, kNoPartials,
        ws, splits, b, sq, h, hk, d, ps, P, max_len, scale, st);
  if (dtype == ptt::kFloat32)
    return (int)launch<float, float>(q, ak, av, nullptr, nullptr, tables,
                                     nullptr, pos, out, kNoPartials, ws,
                                     splits, b, sq, h, hk, d, ps, P, max_len,
                                     scale, st);
  return (int)cudaErrorInvalidValue;
}

// The same over int8 arenas [pages, ps, hk, d] with float32 scales
// [pages, ps, hk, 1] (ks, vs); q and out in `dtype`.
extern "C" int ptt_paged_decode_q8(const void* q, const void* ak,
                                   const void* av, const void* ks,
                                   const void* vs, const void* tables,
                                   const void* pos, void* out, void* ws,
                                   int splits, int b, int sq, int h, int hk,
                                   int d, int ps, int P, int max_len,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits) || ks == nullptr ||
      vs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16, int8_t>(
        q, ak, av, ks, vs, tables, nullptr, pos, out, kNoPartials, ws, splits,
        b, sq, h, hk, d, ps, P, max_len, scale, st);
  if (dtype == ptt::kFloat32)
    return (int)launch<float, int8_t>(q, ak, av, ks, vs, tables, nullptr, pos,
                                      out, kNoPartials, ws, splits, b, sq, h,
                                      hk, d, ps, P, max_len, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K5: the page walk of one cp shard.  q: [b, sq, h, d]; arenas: the shard's
// [per_shard, ps, hk, d] pages; tables: [b, P] LOCAL page ids (row 0 = the
// shard's scratch page); page_base: [P] int32, column j's first token
// position; pos: [b] int32.  Writes the un-normalised float32 partials
// acc [b, hk, rep * sq, d], m and l [b, hk, rep * sq] (row r = group member
// r / sq at window offset r % sq).  ws as for ptt_paged_decode.
extern "C" int ptt_paged_decode_partials(
    const void* q, const void* ak, const void* av, const void* tables,
    const void* page_base, const void* pos, void* acc, void* m, void* l,
    void* ws, int splits, int b, int sq, int h, int hk, int d, int ps, int P,
    int max_len, float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits) || page_base == nullptr ||
      acc == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Partials part{static_cast<float*>(acc), static_cast<float*>(m),
                      static_cast<float*>(l)};
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, ak, av, nullptr, nullptr, tables, page_base, pos, nullptr, part, ws,
        splits, b, sq, h, hk, d, ps, P, max_len, scale, st);
  if (dtype == ptt::kFloat32)
    return (int)launch<float, float>(q, ak, av, nullptr, nullptr, tables,
                                     page_base, pos, nullptr, part, ws, splits,
                                     b, sq, h, hk, d, ps, P, max_len, scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}

// K5 over an int8 shard arena with its float32 scales [per_shard, ps, hk,
// 1] (ks, vs); q in `dtype`.
extern "C" int ptt_paged_decode_partials_q8(
    const void* q, const void* ak, const void* av, const void* ks,
    const void* vs, const void* tables, const void* page_base,
    const void* pos, void* acc, void* m, void* l, void* ws, int splits, int b,
    int sq, int h, int hk, int d, int ps, int P, int max_len, float scale,
    int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits) || page_base == nullptr ||
      acc == nullptr || ks == nullptr || vs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Partials part{static_cast<float*>(acc), static_cast<float*>(m),
                      static_cast<float*>(l)};
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16, int8_t>(
        q, ak, av, ks, vs, tables, page_base, pos, nullptr, part, ws, splits,
        b, sq, h, hk, d, ps, P, max_len, scale, st);
  if (dtype == ptt::kFloat32)
    return (int)launch<float, int8_t>(q, ak, av, ks, vs, tables, page_base,
                                      pos, nullptr, part, ws, splits, b, sq, h,
                                      hk, d, ps, P, max_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
