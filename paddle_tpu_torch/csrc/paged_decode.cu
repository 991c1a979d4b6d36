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
// float32 shared-memory tiles K2 fills from bf16 or fp16.
//
// Bound on an H100: decode attention does 4*R*d FLOPs per key row against
// 2*d*2 bytes of K and V (bf16 or fp16; 2*(d + 4) bytes under int8) -- about R
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
// Over float32 arenas and at d other than 64 or 128 the dot products are
// plain f32 FMAs from f32 shared-memory tiles (`paged_decode_kernel`, the
// FMA page walk); a bf16 or fp16 q at d 64 or 128 takes the decode walk
// under 16 rows and the chunk window from 16.
//
// The decode walk (`paged_walk_kernel`): under 16 rows -- every decode
// step (R = 1 for Llama-2-7B's MHA) and verify window (R = 3) -- the walk
// is pure streaming at about R FLOP per byte, so latency and the bytes in
// flight bound it.  Each block (128 threads) streams its share of the live
// keys through a ring of kWalkStages = 3 stages of 8 KB of K and 8 KB of V
// in the stored dtype (32 16-bit or 64 int8 key rows at d 128; no f32
// staging), 16-byte `cp.async` copies, keys in table order so a stage may
// span pages, the split's table columns staged in shared memory first.
// Bytes in flight: two stages ahead = 32 KB a block; four blocks of ~49 KB
// fit an SM at R = 1, so ~128 KB are in flight per SM, above the ~24 KB
// that 3.35 TB/s x ~1 us of latency / 132 SMs asks for.  The dot products
// run in registers: a key row belongs to one group of d / 8 lanes (a
// half-warp at d 128, a quarter-warp at d 64), each lane holding 16 bytes
// (8 columns) of every q row and reading the same 8 columns of the K and V
// rows; a dot product is 8 FMAs and a shuffle reduction inside the group.
// Each group keeps its online softmax (m, l) and its 8 columns of acc per
// row in registers over the keys it takes; the groups merge once, through
// shared memory, at block end.  Rows come in tiles of 1, 4 or 8 (9-15 rows
// take two blocks), so the registers follow R.
//
// The chunk window (`paged_chunk_mma_kernel`): a tile of 16 rows or more,
// bf16 or fp16 q and d = 64 or 128 -- every chunk prefill of a prefix-cache
// hit and of the cp engine -- is operation-bound at its real width (a 256-row
// chunk does 256 x 4d FLOP per key against 4d bytes), so it runs on the
// tensor cores.  One block of 4 warps holds a 64-row tile, 16 rows per
// warp, as K1's `flash_fwd_mma_kernel` does: Q fragments in registers,
// S = Q.K^T on `mma.sync` m16n8k16 with f32 accumulation, the online
// softmax in registers, P rounded to q's dtype T, bf16 or fp16 (K2's
// rounding point), as the A fragments of P.V, O in registers.  K/V stay in
// T in shared memory, in
// padded 64-key tiles loaded 16 bytes a thread with `cp.async` into a
// two-stage buffer, so the next tile's copy overlaps this tile's
// products; V's B fragments come from `ldmatrix.trans`.  Keys run in table
// order (column j, row-in-page), so any page size works; the split count
// is chosen by the host to fill the card, and each block divides the LIVE
// key range (columns whose first position the tile can see) among the
// splits itself, so no split walks dead pages.  int8 pages: an int8 value
// is exact in bf16 and in fp16, so each staged int8 tile converts
// losslessly to T; the K scale multiplies S's column after the product
// (s = scale * ks_t * q.k8_t) and the V scale folds into P (p'_t = p_t *
// vs_t, rounded to T -- bf16 under a bf16 q, fp16 under an fp16 q --
// before P'.V8).  That rounding point is new: K4's FMA kernel and the
// reference keep p * vs in float32 there (flash_attention.py:1267); the
// kernels phase holds it to the working dtype's tolerance.
//
// K5 is the same page walks for context-parallel decode: a cp shard walks
// its own slice of the arena with a local table whose columns are not
// consecutive sequence pages, so `page_base[j]` gives column j's first
// token position (j * ps when null, which is K2/K4).  On one card every
// shard runs in ONE launch (`ptt_paged_decode_cp`): the grid's third axis
// is shard x split, block (slot, kv head, shard s x split) walks shard s's
// arena slice (offset s * per_shard pages), its stacked local table and
// page_base, and writes its partials; the split combine merges all cp x
// splits partials of a row (the same merge as cp_softmax_combine, :1386)
// and writes the finished output in q's dtype.  A shard walks only its
// live pages, so the shards of one step together move K2's bytes.  Per
// shard (`ptt_paged_decode_partials`, the across-card form) a block writes
// its un-normalised state (acc, m, l) in place of acc / l, and the combine
// has a partials mode (M = max m, L = sum l e^(m - M), acc* = sum acc
// e^(m - M), no divide) for the cross-shard merge outside.
//
// Masks are the reference's (:869-898, K5 :1250-1258): row r at window
// offset w = r % sq sees key jid iff jid <= pos + w and jid < max_len, with
// jid = page_base[j] + row-in-page.  Scratch page 0 (zero values, scale 0
// until masked writes land there) is fenced by the same test before any
// softmax.  K2 rounds p to the page dtype before P.V as the reference
// does (`p.astype(v.dtype)`); K4 does not, because the reference's V is the
// float32 dequantized tile there.

#include <limits.h>
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
constexpr int kMmaMinRows = 16; // the chunk window's rows (PAGED_MMA_MIN_ROWS)

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
                    int G, int ntiles, bool vec, int nsplit,
                    size_t shard_rows) {
  extern __shared__ float smem[];
  const int slot = blockIdx.x;
  const int g = blockIdx.y / ntiles;
  const int r0 = (blockIdx.y % ntiles) * kRowTile;  // rows [r0, r0 + Rt)
  // z = shard * nsplit + split; nz = cp * nsplit partials per row
  const int z = blockIdx.z, nz = gridDim.z;
  const int shard = z / nsplit, split = z % nsplit;
  ak += shard * shard_rows * d;
  av += shard * shard_rows * d;
  if (ks != nullptr) {
    ks += shard * shard_rows;
    vs += shard * shard_rows;
  }
  tables += (size_t)shard * gridDim.x * P;
  if (page_base != nullptr) page_base += (size_t)shard * P;
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

  if (nz == 1 && part.acc != nullptr) {
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
  if (nz == 1) {
    for (int e = tid; e < Rt * d; e += kThreads) {
      const int rr = e / d, r = r0 + rr, c = e % d;
      const int head = g * rep + r / sq;
      const float l_safe = fmaxf(l_s[rr], 1e-30f);  // masked rows give 0
      out[((size_t)(slot * sq + r % sq) * h + head) * d + c] =
          from_f32<T>(acc_s[e] / l_safe);
    }
    return;
  }
  // partials of this split at rows [r0, r0 + Rt) of the (slot, g, z)
  // region; a split past `last` leaves m = -1e30, l = 0
  const size_t region = ((size_t)slot * hk + g) * nz + z;
  float* ws_acc = ws + (region * R + r0) * d;
  float* ws_ml = ws + (size_t)gridDim.x * hk * nz * R * d +
                 (region * R + r0) * 2;
  for (int e = tid; e < Rt * d; e += kThreads) ws_acc[e] = acc_s[e];
  for (int rr = tid; rr < Rt; rr += kThreads) {
    ws_ml[2 * rr] = m_s[rr];
    ws_ml[2 * rr + 1] = l_s[rr];
  }
}

// Merge the splits' (acc, m, l) per row: M = max m, L = sum l e^(m - M),
// out = sum acc e^(m - M) / max(L, 1e-30); in partials mode (part.acc
// non-null) write (sum acc e^(m - M), M, L) undivided.  One warp per row
// (slot, kv head, row r) of the `rows` = b * hk * rep * sq, its lanes over
// d (<= 256, 8 per lane): the weights are computed once per row and split,
// and each split's acc row is read in coalesced 128-byte lines.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
               Partials part, int nsplit, int b, int sq, int h, int hk, int d) {
  const int rep = h / hk;
  const int R = rep * sq;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= (long long)b * hk * R) return;
  const int lane = threadIdx.x % 32;
  const int r = (int)(row % R);
  const long long sg = row / R;  // slot * hk + kv head
  const float* acc = ws + sg * nsplit * R * d;
  const float* ml = ws + (size_t)b * hk * nsplit * R * d + sg * nsplit * R * 2;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[((size_t)s * R + r) * 2]);
  float L = 0.f, A[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) A[i] = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(ml[((size_t)s * R + r) * 2] - M);
    L += w * ml[((size_t)s * R + r) * 2 + 1];
    const float* src = acc + ((size_t)s * R + r) * d;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < d) A[i] += w * src[lane + 32 * i];
  }
  if (part.acc != nullptr) {
    const size_t prow = (size_t)sg * R + r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < d) part.acc[prow * d + lane + 32 * i] = A[i];
    if (lane == 0) {
      part.m[prow] = M;
      part.l[prow] = L;
    }
    return;
  }
  const int slot = (int)(sg / hk), g = (int)(sg % hk);
  T* orow = out + ((size_t)(slot * sq + r % sq) * h + g * rep + r / sq) * d;
  const float Ls = fmaxf(L, 1e-30f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane + 32 * i < d) orow[lane + 32 * i] = from_f32<T>(A[i] / Ls);
}

// Launch the split combine over every row of the launch.
template <typename T>
cudaError_t combine(const void* ws, void* out, Partials part, int nsplit,
                    int b, int sq, int h, int hk, int d, cudaStream_t stream) {
  const long long rows = (long long)b * hk * (h / hk) * sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  combine_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), part, nsplit, b,
      sq, h, hk, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The chunk window on the tensor cores (T = bf16 or fp16 q, d = D in {64,
// 128}, 16 rows or more per tile).
// ---------------------------------------------------------------------------

constexpr int kChunkKeys = 64;  // keys per tile, in table order
constexpr int kStages = 2;      // cp.async buffers

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The B fragments of two neighbouring 8-key steps of S = Q.K^T from a
// row-major [keys][ST] 16-bit tile: matrices (keys n0..+7, cols c0..+7),
// (n0.., c0+8..), (n0+8.., c0..), (n0+8.., c0+8..), so r[0], r[1] are b0,
// b1 of keys n0.. and r[2], r[3] of keys n0+8..
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The B fragments of two neighbouring 8-column steps of P.V from a
// row-major [keys][ST] 16-bit tile: matrices (keys k0..+7, cols c0..+7),
// (keys k0+8.., c0..), (k0.., c0+8..), (k0+8.., c0+8..), transposed on the
// way, so r[0], r[1] are b0, b1 of columns c0.. and r[2], r[3] of c0+8..
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Shared memory of the chunk kernel, in bytes from the start: the T K
// and V tiles the products read ([kTiles][64][ST] each), each stage's key
// positions [kStages][64] int32, and for int8 pages the staged int8 tiles
// [kStages][64][D] and their scales [kStages][64] f32.  q [64][ST] of T
// borrows a tile the first key tile leaves free until the q fragments are
// in registers (V's second stage, or under int8 the T K tile that the
// first conversion fills), so three blocks fit an SM (~70 KB each at d 128).
template <int D, bool kQuant>
struct ChunkSmem {
  static constexpr int ST = D + 8;  // padded row: conflict-free fragments
  static constexpr int kTiles = kQuant ? 1 : kStages;
  static constexpr size_t kTile = (size_t)kChunkKeys * ST * 2;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kTiles * kTile;
  static constexpr size_t q = kQuant ? k : v + kTile;
  static constexpr size_t jid = v + kTiles * kTile;
  static constexpr size_t k8 = jid + kStages * kChunkKeys * 4;
  static constexpr size_t v8 = k8 + (kQuant ? kStages * kChunkKeys * D : 0);
  static constexpr size_t ksc = v8 + (kQuant ? kStages * kChunkKeys * D : 0);
  static constexpr size_t vsc = ksc + (kQuant ? kStages * kChunkKeys * 4 : 0);
  static constexpr size_t bytes = vsc + (kQuant ? kStages * kChunkKeys * 4 : 0);
};

// Grid, outputs and workspace as `paged_decode_kernel`; the split's key
// tiles are its share of the live range (see the header).  TS: the stored
// K/V element (T, or int8 with the scale arenas ks / vs).  Three blocks
// per SM (at most 170 registers a thread; left alone ptxas takes ~180 and
// fits two), the grid the host sizes (`paged_splits`).
template <typename T, int D, typename TS>
__global__ void __launch_bounds__(kThreads, 3)
paged_chunk_mma_kernel(const T* __restrict__ q,
                       const TS* __restrict__ ak, const TS* __restrict__ av,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ page_base,
                       const int* __restrict__ pos,
                       T* __restrict__ out, Partials part,
                       float* __restrict__ ws, int sq, int h, int hk, int ps,
                       int P, int max_len, float scale, int ntiles,
                       int nsplit, size_t shard_rows) {
  constexpr bool kQuant = std::is_same<TS, int8_t>::value;
  using L = ChunkSmem<D, kQuant>;
  constexpr int ST = L::ST;
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  T* q_s = reinterpret_cast<T*>(chunk_smem + L::q);
  T* k_s = reinterpret_cast<T*>(chunk_smem + L::k);
  T* v_s = reinterpret_cast<T*>(chunk_smem + L::v);
  int* jid_s = reinterpret_cast<int*>(chunk_smem + L::jid);
  int8_t* k8_s = reinterpret_cast<int8_t*>(chunk_smem + L::k8);
  int8_t* v8_s = reinterpret_cast<int8_t*>(chunk_smem + L::v8);
  float* ksc_s = reinterpret_cast<float*>(chunk_smem + L::ksc);
  float* vsc_s = reinterpret_cast<float*>(chunk_smem + L::vsc);

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y / ntiles;
  const int r0 = (blockIdx.y % ntiles) * kRowTile;  // rows [r0, r0 + Rt)
  // z = shard * nsplit + split; nz = cp * nsplit partials per row
  const int z = blockIdx.z, nz = gridDim.z;
  const int shard = z / nsplit, split = z % nsplit;
  ak += shard * shard_rows * D;
  av += shard * shard_rows * D;
  if constexpr (kQuant) {
    ks += shard * shard_rows;
    vs += shard * shard_rows;
  }
  tables += (size_t)shard * gridDim.x * P;
  if (page_base != nullptr) page_base += (size_t)shard * P;
  const int rep = h / hk;
  const int R = rep * sq;
  const int Rt = min(kRowTile, R - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the tile
  const int p0 = pos[slot];
  const int r1 = r0 + Rt - 1;
  const int last = p0 + (r0 / sq == r1 / sq ? r1 % sq : sq - 1);
  // rows a and b of this thread see keys jid <= lim (window offset r % sq)
  const int lim_a = p0 + (r0 + wr + g) % sq;
  const int lim_b = p0 + (r0 + wr + g + 8) % sq;

  // the live columns: page_base rises with j (j * ps, or cp_local_tables'
  // (s + cp * j) * ps), so they are the prefix whose first position is at
  // most `last`
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const int pb = page_base != nullptr ? page_base[mid] : mid * ps;
    if (pb <= last) lo = mid + 1; else hi = mid;
  }
  const int key_end = lo * ps;
  const int n_tiles = (key_end + kChunkKeys - 1) / kChunkKeys;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int tile0 = split * per;
  const int tile1 = min(n_tiles, tile0 + per);
  const int* trow = tables + (size_t)slot * P;

  // issue the copies of key tile `tile` into stage `st`
  auto issue = [&](int tile, int st) {
    constexpr int EPC = 16 / sizeof(TS);  // elements per 16-byte copy
    constexpr int CPR = D / EPC;          // copies per key row
    for (int e = tid; e < kChunkKeys * CPR; e += kThreads) {
      const int kk = e / CPR, c = (e % CPR) * EPC;
      const int key = tile * kChunkKeys + kk;
      TS* kd;
      TS* vd;
      if constexpr (kQuant) {
        kd = reinterpret_cast<TS*>(k8_s + ((size_t)st * kChunkKeys + kk) * D + c);
        vd = reinterpret_cast<TS*>(v8_s + ((size_t)st * kChunkKeys + kk) * D + c);
      } else {
        kd = reinterpret_cast<TS*>(k_s + ((size_t)st * kChunkKeys + kk) * ST + c);
        vd = reinterpret_cast<TS*>(v_s + ((size_t)st * kChunkKeys + kk) * ST + c);
      }
      if (key < key_end) {
        const int j = key / ps, rip = key - j * ps;
        const size_t row = ((size_t)trow[j] * ps + rip) * hk + kvh;
        cp_async16(kd, ak + row * D + c);
        cp_async16(vd, av + row * D + c);
        if (c == 0) {
          jid_s[st * kChunkKeys + kk] =
              (page_base != nullptr ? page_base[j] : j * ps) + rip;
          if constexpr (kQuant) {
            cp_async4(ksc_s + st * kChunkKeys + kk, ks + row);
            cp_async4(vsc_s + st * kChunkKeys + kk, vs + row);
          }
        }
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
        if (c == 0) {
          jid_s[st * kChunkKeys + kk] = INT_MAX;  // fails every mask
          if constexpr (kQuant) {
            ksc_s[st * kChunkKeys + kk] = 0.f;
            vsc_s[st * kChunkKeys + kk] = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  if (tile0 < tile1) issue(tile0, 0);
  // the tile's q rows (row r: group member r / sq at window offset r % sq),
  // zero past R
  for (int e = tid; e < kRowTile * (D / 8); e += kThreads) {
    const int rr = e / (D / 8), c = (e % (D / 8)) * 8;
    const int r = r0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < Rt)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)(slot * sq + r % sq) * h + kvh * rep + r / sq) * D + c);
    *reinterpret_cast<uint4*>(q_s + rr * ST + c) = val;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const T* p = q_s + (wr + g) * ST + kk * 16 + 2 * t;
    qf[kk][0] = ptt::ld_u32(p);
    qf[kk][1] = ptt::ld_u32(p + 8 * ST);
    qf[kk][2] = ptt::ld_u32(p + 8);
    qf[kk][3] = ptt::ld_u32(p + 8 * ST + 8);
  }
  __syncthreads();  // q's tile is free for the key tiles from here on
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = tile0; tile < tile1; ++tile) {
    const int st = (tile - tile0) & 1;
    if (tile + 1 < tile1) {
      issue(tile + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copies (and zero rows) are visible
    const T* kt = k_s;
    const T* vt = v_s;
    if constexpr (kQuant) {
      // int8 -> T is exact (|x| <= 127 in bf16 or fp16)
      for (int e = tid; e < kChunkKeys * (D / 16); e += kThreads) {
        const int kk = e / (D / 16), c = (e % (D / 16)) * 16;
        const size_t src = ((size_t)st * kChunkKeys + kk) * D + c;
        const uint4 kr = *reinterpret_cast<const uint4*>(k8_s + src);
        const uint4 vr = *reinterpret_cast<const uint4*>(v8_s + src);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vr);
        uint32_t kw[8], vw[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          kw[i] = ptt::pack<T>((float)kb[2 * i], (float)kb[2 * i + 1]);
          vw[i] = ptt::pack<T>((float)vb[2 * i], (float)vb[2 * i + 1]);
        }
        uint4* kd = reinterpret_cast<uint4*>(k_s + kk * ST + c);
        uint4* vd = reinterpret_cast<uint4*>(v_s + kk * ST + c);
        kd[0] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
        kd[1] = make_uint4(kw[4], kw[5], kw[6], kw[7]);
        vd[0] = make_uint4(vw[0], vw[1], vw[2], vw[3]);
        vd[1] = make_uint4(vw[4], vw[5], vw[6], vw[7]);
      }
      __syncthreads();
    } else {
      kt = k_s + (size_t)st * kChunkKeys * ST;
      vt = v_s + (size_t)st * kChunkKeys * ST;
    }
    const int* jid = jid_s + st * kChunkKeys;

    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np)  // score tiles 2np and 2np + 1
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, kt + ((2 * np + (mi >> 1)) * 8 + mr) * ST + kk * 16 +
                       (mi & 1) * 8);
        ptt::mma<T>(sc[2 * np], qf[kk], b[0], b[1]);
        ptt::mma<T>(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = nt * 8 + 2 * t + (e & 1);
        const int j = jid[kk];
        const bool ok = j <= (e < 2 ? lim_a : lim_b) && j < max_len;
        float s = sc[nt][e] * scale;
        if constexpr (kQuant) s *= ksc_s[st * kChunkKeys + kk];
        sc[nt][e] = ok ? s : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    // P (p' = p * vs under int8) in T as the A fragments of P.V: key
    // columns of score tiles 2kk and 2kk+1 are the k columns of step kk
    uint32_t pf[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p0v = __expf(sc[nt][0] - m[0]), p1v = __expf(sc[nt][1] - m[0]);
      float p2v = __expf(sc[nt][2] - m[1]), p3v = __expf(sc[nt][3] - m[1]);
      rs[0] += p0v + p1v;
      rs[1] += p2v + p3v;
      if constexpr (kQuant) {
        const float v0 = vsc_s[st * kChunkKeys + nt * 8 + 2 * t];
        const float v1 = vsc_s[st * kChunkKeys + nt * 8 + 2 * t + 1];
        p0v *= v0;
        p1v *= v1;
        p2v *= v0;
        p3v *= v1;
      }
      pf[nt / 2][(nt % 2) * 2] = ptt::pack<T>(p0v, p1v);
      pf[nt / 2][(nt % 2) * 2 + 1] = ptt::pack<T>(p2v, p3v);
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
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + (kk * 16 + (mi & 1) * 8 + mr) * ST + dp * 16 +
                             (mi >> 1) * 8);
        ptt::mma<T>(o[2 * dp], pf[kk], b[0], b[1]);
        ptt::mma<T>(o[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    __syncthreads();  // every warp is done with this stage
  }

  // rows a (r = r0 + wr + g) and b (r + 8) of this thread
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int rr = wr + g + 8 * r;  // row in the tile
    if (rr >= Rt) continue;
    const int row = r0 + rr;
    if (nz == 1 && part.acc != nullptr) {
      const size_t prow = ((size_t)slot * hk + kvh) * R + row;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(part.acc + prow * D + dt * 8 + 2 * t) =
            make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
      if (t == 0) {
        part.m[prow] = m[r];
        part.l[prow] = l[r];
      }
    } else if (nz == 1) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);  // masked rows give 0
      T* orow =
          out + ((size_t)(slot * sq + row % sq) * h + kvh * rep + row / sq) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            ptt::pack<T>(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    } else {
      // this split's partials at row `row` of the (slot, kvh, split) region
      const size_t region = ((size_t)slot * hk + kvh) * nz + z;
      float* ws_acc = ws + (region * R + row) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(ws_acc + dt * 8 + 2 * t) =
            make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
      if (t == 0) {
        float* ws_ml = ws + (size_t)gridDim.x * hk * nz * R * D +
                       (region * R + row) * 2;
        ws_ml[0] = m[r];
        ws_ml[1] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The decode walk: fewer than 16 rows (a decode step, a verify window),
// T = bf16 or fp16 q, d = D in {64, 128}, pages of T or int8.
// ---------------------------------------------------------------------------

constexpr int kWalkStages = 3;          // cp.async ring
constexpr int kWalkStageBytes = 8192;   // K bytes (and again V) per stage

// Shared memory of the walk, in bytes: the K and V rings ([kWalkStages]
// [keys][D] in the stored dtype, no f32 staging), each stage's key
// positions, and under int8 the rows' K and V scales.  At block end the
// ring holds the key groups' (acc, m, l) for the merge.
template <int D, typename TS>
struct WalkSmem {
  static constexpr bool kQuant = std::is_same<TS, int8_t>::value;
  static constexpr int kKeys = kWalkStageBytes / (D * (int)sizeof(TS));
  static constexpr size_t k = 0;
  static constexpr size_t v = k + (size_t)kWalkStages * kWalkStageBytes;
  static constexpr size_t jid = v + (size_t)kWalkStages * kWalkStageBytes;
  static constexpr size_t ksc = jid + (size_t)kWalkStages * kKeys * 4;
  static constexpr size_t vsc = ksc + (kQuant ? (size_t)kWalkStages * kKeys * 4 : 0);
  static constexpr size_t bytes = vsc + (kQuant ? (size_t)kWalkStages * kKeys * 4 : 0);
};

// 8 stored values at p as f32: 16 bytes of bf16 or fp16, or 8 bytes of
// int8.
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const __half* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (float)b[i];
}

// Grid (slot, kv head x row tile, shard x split), outputs and workspace as
// `paged_decode_kernel`; RT rows per tile (1, 4 or 8), each of the rows'
// split takes its share of the LIVE key tiles (found on the card, as the
// chunk window does).  A key row is read by one group of D / 8 lanes (a
// half-warp at d 128, a quarter-warp at d 64), each lane holding 8
// columns: 16 bytes of each q row in registers, and of each K and V row in
// shared memory.  A dot product is 8 FMAs and a shuffle reduction inside
// the group; each group keeps an online softmax (m, l) and acc of its 8
// columns per row in registers over the keys it takes (keys grp, grp + NG,
// ... of each stage), and the groups merge once at block end.
template <typename T, int D, typename TS, int RT>
__global__ void __launch_bounds__(kThreads, RT >= 8 ? 2 : 3)
paged_walk_kernel(const T* __restrict__ q,
                  const TS* __restrict__ ak, const TS* __restrict__ av,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ page_base,
                  const int* __restrict__ pos, T* __restrict__ out,
                  Partials part, float* __restrict__ ws, int sq, int h,
                  int hk, int ps, int P, int max_len, float scale, int ntiles,
                  int nsplit, size_t shard_rows) {
  constexpr bool kQuant = std::is_same<TS, int8_t>::value;
  using L = WalkSmem<D, TS>;
  constexpr int CK = L::kKeys;                 // keys per stage
  constexpr int LPK = D / 8;                   // lanes per key row
  constexpr int NG = (kThreads / 32) * (32 / LPK);  // key groups per block
  constexpr int KPG = CK / NG;                 // keys per group per stage
  constexpr int KB = RT >= 8 ? 2 : 4;          // keys per softmax update
  static_assert(KPG % KB == 0, "a group's keys split into whole batches");
  static_assert((size_t)NG * RT * (D + 2) * 4 <= L::jid,
                "the groups' partials fit the ring they take over");
  extern __shared__ __align__(16) unsigned char walk_smem[];
  TS* k_s = reinterpret_cast<TS*>(walk_smem + L::k);
  TS* v_s = reinterpret_cast<TS*>(walk_smem + L::v);
  int* jid_s = reinterpret_cast<int*>(walk_smem + L::jid);
  float* ksc_s = reinterpret_cast<float*>(walk_smem + L::ksc);
  float* vsc_s = reinterpret_cast<float*>(walk_smem + L::vsc);

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y / ntiles;
  const int r0 = (blockIdx.y % ntiles) * RT;  // rows [r0, r0 + Rt)
  // z = shard * nsplit + split; nz = cp * nsplit partials per row
  const int z = blockIdx.z, nz = gridDim.z;
  const int shard = z / nsplit, split = z % nsplit;
  ak += shard * shard_rows * D;
  av += shard * shard_rows * D;
  if constexpr (kQuant) {
    ks += shard * shard_rows;
    vs += shard * shard_rows;
  }
  const int* trow = tables + ((size_t)shard * gridDim.x + slot) * P;
  const int* pbase = page_base != nullptr ? page_base + (size_t)shard * P : nullptr;
  const int rep = h / hk;
  const int R = rep * sq;
  const int Rt = min(RT, R - r0);
  const int p0 = pos[slot];
  const int r1 = r0 + Rt - 1;
  const int last = p0 + (r0 / sq == r1 / sq ? r1 % sq : sq - 1);

  // the live columns: the prefix whose first position is at most `last`
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const int pb = pbase != nullptr ? pbase[mid] : mid * ps;
    if (pb <= last) lo = mid + 1; else hi = mid;
  }
  const int key_end = lo * ps;
  const int n_tiles = (key_end + CK - 1) / CK;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int tile0 = split * per;
  const int nt = min(n_tiles, tile0 + per) - tile0;  // may be <= 0

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int grp = (tid / 32) * (32 / LPK) + lane / LPK;  // this key group
  const int gl = lane % LPK;  // columns 8 gl .. 8 gl + 7

  // the split's table columns (page id, first position) into shared
  // memory once, so no copy waits on a table read in the loop
  int* tab_s = reinterpret_cast<int*>(walk_smem + L::bytes);  // [P]
  int* pb_s = tab_s + P;                                      // [P]
  const int col0 = nt > 0 ? tile0 * CK / ps : 0;
  const int col1 = nt > 0 ? min(lo, ((tile0 + nt) * CK + ps - 1) / ps) : 0;
  for (int j = col0 + tid; j < col1; j += kThreads) {
    tab_s[j] = trow[j];
    pb_s[j] = pbase != nullptr ? pbase[j] : j * ps;
  }
  __syncthreads();

  // issue the copies of key tile `tile` into stage `st`: 16 bytes a copy,
  // keys in table order (column j, row in page), zero rows past key_end
  auto issue = [&](int tile, int st) {
    constexpr int EPC = 16 / sizeof(TS);  // elements per copy
    constexpr int CPR = D / EPC;          // copies per key row
    for (int e = tid; e < CK * CPR; e += kThreads) {
      const int kk = e / CPR, c = (e % CPR) * EPC;
      const int key = tile * CK + kk;
      TS* kd = k_s + ((size_t)st * CK + kk) * D + c;
      TS* vd = v_s + ((size_t)st * CK + kk) * D + c;
      if (key < key_end) {
        const int j = key / ps, rip = key - j * ps;
        const size_t row = ((size_t)tab_s[j] * ps + rip) * hk + kvh;
        cp_async16(kd, ak + row * D + c);
        cp_async16(vd, av + row * D + c);
        if (c == 0) {
          jid_s[st * CK + kk] = pb_s[j] + rip;
          if constexpr (kQuant) {
            cp_async4(ksc_s + st * CK + kk, ks + row);
            cp_async4(vsc_s + st * CK + kk, vs + row);
          }
        }
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
        if (c == 0) {
          jid_s[st * CK + kk] = INT_MAX;  // fails every mask
          if constexpr (kQuant) {
            ksc_s[st * CK + kk] = 0.f;
            vsc_s[st * CK + kk] = 0.f;
          }
        }
      }
    }
  };

  for (int i = 0; i < kWalkStages - 1; ++i) {
    if (i < nt) issue(tile0 + i, i);
    cp_async_commit();
  }

  // this lane's 8 columns of each q row (row r: group member r / sq at
  // window offset r % sq), and the newest key position each row sees;
  // rows past Rt see none
  float qr[RT][8], acc[RT][8], m[RT], l[RT];
  int lim[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    if (r < Rt) {
      load8(qr[r], q + ((size_t)(slot * sq + row % sq) * h + kvh * rep +
                        row / sq) * D + 8 * gl);
      lim[r] = p0 + row % sq;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) qr[r][c] = 0.f;
      lim[r] = -1;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kWalkStages - 2>();
    __syncthreads();  // tile i has landed; every thread is done with i - 1
    {
      // refill the stage that held tile i - 1, kWalkStages - 1 ahead
      const int nx = i + kWalkStages - 1;
      if (nx < nt) issue(tile0 + nx, nx % kWalkStages);
      cp_async_commit();
    }
    const int st = i % kWalkStages;
    const TS* kt = k_s + (size_t)st * CK * D;
    const TS* vt = v_s + (size_t)st * CK * D;
    const int* jd = jid_s + st * CK;
#pragma unroll
    for (int u0 = 0; u0 < KPG; u0 += KB) {
      float sc[KB][RT];
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        float kf[8];
        load8(kf, kt + (size_t)(grp + NG * (u0 + u)) * D + 8 * gl);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) dot = fmaf(qr[r][c], kf[c], dot);
          sc[u][r] = dot;
        }
      }
      // the group's lanes hold the 8-column parts of each dot product
#pragma unroll
      for (int u = 0; u < KB; ++u)
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], off);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        bool ok[KB];
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const int kk = grp + NG * (u0 + u);
          const int j = jd[kk];
          ok[u] = j <= lim[r] && j < max_len;
          float x = sc[u][r] * scale;
          if constexpr (kQuant) x *= ksc_s[st * CK + kk];
          sc[u][r] = x;
          if (ok[u]) mx = fmaxf(mx, x);
        }
        const float alpha = __expf(m[r] - mx);
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          // masked keys add exactly nothing
          const float p = ok[u] ? __expf(sc[u][r] - mx) : 0.f;
          l[r] += p;
          sc[u][r] = p;
        }
      }
      // P.V: p rounded to the page dtype for bf16 or fp16 pages (K2),
      // float32 times the V row's scale for int8 pages (K4's dequantized V)
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const int kk = grp + NG * (u0 + u);
        float vf[8];
        load8(vf, vt + (size_t)kk * D + 8 * gl);
        float vsc = 1.f;
        if constexpr (kQuant) vsc = vsc_s[st * CK + kk];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float pv = kQuant ? sc[u][r] * vsc : round_p<TS>(sc[u][r]);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(pv, vf[c], acc[r][c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the groups' partials now

  float* g_acc = reinterpret_cast<float*>(walk_smem);  // [NG][RT][D]
  float* g_m = g_acc + NG * RT * D;                    // [NG][RT]
  float* g_l = g_m + NG * RT;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float4* dst = reinterpret_cast<float4*>(g_acc + (grp * RT + r) * D + 8 * gl);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    if (gl == 0) {
      g_m[grp * RT + r] = m[r];
      g_l[grp * RT + r] = l[r];
    }
  }
  __syncthreads();

  // merge the groups per (row, column): M = max m, L = sum l e^(m - M),
  // A = sum acc e^(m - M); a group that saw no key has m = -1e30, l = 0
  const size_t region = ((size_t)slot * hk + kvh) * nz + z;
  for (int e = tid; e < Rt * D; e += kThreads) {
    const int r = e / D, c = e % D, row = r0 + r;
    float M = kNegInf;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) M = fmaxf(M, g_m[gi * RT + r]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const float w = __expf(g_m[gi * RT + r] - M);
      Ls += w * g_l[gi * RT + r];
      A += w * g_acc[(gi * RT + r) * D + c];
    }
    if (nz == 1 && part.acc != nullptr) {
      const size_t prow = ((size_t)slot * hk + kvh) * R + row;
      part.acc[prow * D + c] = A;
      if (c == 0) {
        part.m[prow] = M;
        part.l[prow] = Ls;
      }
    } else if (nz == 1) {
      out[((size_t)(slot * sq + row % sq) * h + kvh * rep + row / sq) * D + c] =
          from_f32<T>(A / fmaxf(Ls, 1e-30f));  // masked rows give 0
    } else {
      ws[(region * R + row) * D + c] = A;
      if (c == 0) {
        float* ws_ml = ws + (size_t)gridDim.x * hk * nz * R * D +
                       (region * R + row) * 2;
        ws_ml[0] = M;
        ws_ml[1] = Ls;
      }
    }
  }
}

constexpr Partials kNoPartials{nullptr, nullptr, nullptr};

// Kernel choices, picked by the host (`paged_path`).
constexpr int kPathFma = 0;    // the f32-FMA page walk: any dtype and d
constexpr int kPathMma = 1;    // the tensor-core chunk window: 16+ rows
constexpr int kPathWalk = 2;   // the decode walk: under 16 rows

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One launch's geometry: `cp` shards of `shard_rows` arena rows (pages x
// page size x kv heads) each, `nsplit` splits per shard's walk; the
// workspace takes cp * nsplit partials per row when that is above 1.
struct Walk {
  int cp;
  size_t shard_rows;
  int nsplit;
  int nz() const { return cp * nsplit; }
};

bool bad_outputs(const void* out, Partials part, const void* ws,
                 const Walk& w) {
  if (w.nz() > 1 && ws == nullptr) return true;
  if (part.acc != nullptr && w.nz() > 1 && w.cp > 1) return true;
  return part.acc != nullptr ? (part.m == nullptr || part.l == nullptr)
                             : out == nullptr;
}

template <typename T, typename TS>
cudaError_t launch(const void* q, const void* ak, const void* av,
                   const void* ks, const void* vs, const void* tables,
                   const void* page_base, const void* pos, void* out,
                   Partials part, void* ws, Walk w, int b, int sq, int h,
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
  if (bad_outputs(out, part, ws, w)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Rt, d, G);
  auto kernel = paged_decode_kernel<T, TS>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, hk * ntiles, w.nz()), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TS*>(ak),
      static_cast<const TS*>(av), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(page_base), static_cast<const int*>(pos),
      static_cast<T*>(out), part, static_cast<float*>(ws), sq, h, hk, d, ps,
      P, max_len, scale, G, ntiles, vec, w.nsplit, w.shard_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.nz() == 1) return err;
  return combine<T>(ws, out, part, w.nz(), b, sq, h, hk, d, stream);
}

template <typename T, int D, typename TS>
cudaError_t launch_chunk(const void* q, const void* ak, const void* av,
                         const void* ks, const void* vs, const void* tables,
                         const void* page_base, const void* pos, void* out,
                         Partials part, void* ws, Walk w, int b, int sq, int h,
                         int hk, int ps, int P, int max_len, float scale,
                         cudaStream_t stream) {
  const int R = (h / hk) * sq;
  const int ntiles = (R + kRowTile - 1) / kRowTile;
  if ((long long)hk * ntiles > 65535) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(ak) || !aligned16(av))
    return cudaErrorInvalidValue;  // 16-byte copies only
  if (bad_outputs(out, part, ws, w)) return cudaErrorInvalidValue;
  constexpr size_t smem = ChunkSmem<D, std::is_same<TS, int8_t>::value>::bytes;
  auto kernel = paged_chunk_mma_kernel<T, D, TS>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, hk * ntiles, w.nz()), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TS*>(ak),
      static_cast<const TS*>(av), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(page_base), static_cast<const int*>(pos),
      static_cast<T*>(out), part, static_cast<float*>(ws), sq, h,
      hk, ps, P, max_len, scale, ntiles, w.nsplit, w.shard_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.nz() == 1) return err;
  return combine<T>(ws, out, part, w.nz(), b, sq, h, hk, D, stream);
}

template <typename T, int D, typename TS, int RT>
cudaError_t launch_walk_rt(const void* q, const void* ak, const void* av,
                           const void* ks, const void* vs, const void* tables,
                           const void* page_base, const void* pos, void* out,
                           Partials part, void* ws, Walk w, int b, int sq,
                           int h, int hk, int ps, int P, int max_len,
                           float scale, cudaStream_t stream) {
  const int R = (h / hk) * sq;
  const int ntiles = (R + RT - 1) / RT;
  if ((long long)hk * ntiles > 65535) return cudaErrorInvalidValue;
  // the ring, then the table's page ids and first positions [2][P]
  const size_t smem = WalkSmem<D, TS>::bytes + (size_t)2 * P * sizeof(int);
  auto kernel = paged_walk_kernel<T, D, TS, RT>;
  static ptt::SmemLimit limit;
  cudaError_t err = limit.reserve(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, hk * ntiles, w.nz()), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TS*>(ak),
      static_cast<const TS*>(av), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(page_base), static_cast<const int*>(pos),
      static_cast<T*>(out), part, static_cast<float*>(ws), sq, h,
      hk, ps, P, max_len, scale, ntiles, w.nsplit, w.shard_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.nz() == 1) return err;
  return combine<T>(ws, out, part, w.nz(), b, sq, h, hk, D, stream);
}

// The walk's row tile: 1 row (a decode step of one q head per kv head), 4
// (a verify window, small GQA groups) or 8 (the rest, up to 15 rows in two
// tiles), so the q and acc registers follow the rows a block holds.
template <typename T, int D, typename TS>
cudaError_t launch_walk(const void* q, const void* ak, const void* av,
                        const void* ks, const void* vs, const void* tables,
                        const void* page_base, const void* pos, void* out,
                        Partials part, void* ws, Walk w, int b, int sq, int h,
                        int hk, int ps, int P, int max_len, float scale,
                        cudaStream_t stream) {
  const int R = (h / hk) * sq;
  if (R >= kMmaMinRows) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(ak) || !aligned16(av))
    return cudaErrorInvalidValue;  // 16-byte copies only
  if (bad_outputs(out, part, ws, w)) return cudaErrorInvalidValue;
  if (R == 1)
    return launch_walk_rt<T, D, TS, 1>(q, ak, av, ks, vs, tables, page_base, pos,
                                    out, part, ws, w, b, sq, h, hk, ps, P,
                                    max_len, scale, stream);
  if (R <= 4)
    return launch_walk_rt<T, D, TS, 4>(q, ak, av, ks, vs, tables, page_base, pos,
                                    out, part, ws, w, b, sq, h, hk, ps, P,
                                    max_len, scale, stream);
  return launch_walk_rt<T, D, TS, 8>(q, ak, av, ks, vs, tables, page_base, pos,
                                  out, part, ws, w, b, sq, h, hk, ps, P,
                                  max_len, scale, stream);
}

// The tensor-core chunk window or the decode walk with q in T (bf16 or
// fp16) over pages of TS (T, or int8 with scales), d = 64 or 128.
template <typename T, typename TS>
cudaError_t route_tc(int path, const void* q, const void* ak, const void* av,
                     const void* ks, const void* vs, const void* tables,
                     const void* page_base, const void* pos, void* out,
                     Partials part, void* ws, Walk w, int b, int sq, int h,
                     int hk, int d, int ps, int P, int max_len, float scale,
                     cudaStream_t st) {
  if (path == kPathMma) {
    if (d == 64)
      return launch_chunk<T, 64, TS>(q, ak, av, ks, vs, tables, page_base, pos,
                                     out, part, ws, w, b, sq, h, hk, ps, P,
                                     max_len, scale, st);
    return launch_chunk<T, 128, TS>(q, ak, av, ks, vs, tables, page_base, pos,
                                    out, part, ws, w, b, sq, h, hk, ps, P,
                                    max_len, scale, st);
  }
  if (d == 64)
    return launch_walk<T, 64, TS>(q, ak, av, ks, vs, tables, page_base, pos,
                                  out, part, ws, w, b, sq, h, hk, ps, P,
                                  max_len, scale, st);
  return launch_walk<T, 128, TS>(q, ak, av, ks, vs, tables, page_base, pos,
                                 out, part, ws, w, b, sq, h, hk, ps, P,
                                 max_len, scale, st);
}

// One paged launch on the kernel `path` names (the host's choice,
// `paged_path` in ops/flash_attention.py); a shape the path does not take
// is cudaErrorInvalidValue, never another kernel.  The chunk window and the
// walk need a bf16 or fp16 q and d = 64 or 128; the FMA walk takes a
// `dtype` q.  kQuant: int8 pages with scales, else pages in q's dtype.
template <bool kQuant>
cudaError_t route(int path, int dtype, const void* q, const void* ak,
                  const void* av, const void* ks, const void* vs,
                  const void* tables, const void* page_base, const void* pos,
                  void* out, Partials part, void* ws, Walk w, int b, int sq,
                  int h, int hk, int d, int ps, int P, int max_len,
                  float scale, cudaStream_t st) {
  using TB = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  using TH = typename std::conditional<kQuant, int8_t, __half>::type;
  using TF = typename std::conditional<kQuant, int8_t, float>::type;
  if (path == kPathMma || path == kPathWalk) {
    if (d != 64 && d != 128) return cudaErrorInvalidValue;
    if (dtype == ptt::kBFloat16)
      return route_tc<__nv_bfloat16, TB>(path, q, ak, av, ks, vs, tables,
                                         page_base, pos, out, part, ws, w, b,
                                         sq, h, hk, d, ps, P, max_len, scale,
                                         st);
    if (dtype == ptt::kFloat16)
      return route_tc<__half, TH>(path, q, ak, av, ks, vs, tables, page_base,
                                  pos, out, part, ws, w, b, sq, h, hk, d, ps,
                                  P, max_len, scale, st);
    return cudaErrorInvalidValue;
  }
  if (path != kPathFma) return cudaErrorInvalidValue;
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16, TB>(q, ak, av, ks, vs, tables, page_base,
                                     pos, out, part, ws, w, b, sq, h, hk, d,
                                     ps, P, max_len, scale, st);
  if (dtype == ptt::kFloat16)
    return launch<__half, TH>(q, ak, av, ks, vs, tables, page_base, pos, out,
                              part, ws, w, b, sq, h, hk, d, ps, P, max_len,
                              scale, st);
  if (dtype == ptt::kFloat32)
    return launch<float, TF>(q, ak, av, ks, vs, tables, page_base, pos, out,
                             part, ws, w, b, sq, h, hk, d, ps, P, max_len,
                             scale, st);
  return cudaErrorInvalidValue;
}

// The chunk kernel divides the live 64-key tiles among the splits, so it
// takes up to one split per tile of the table; the walk one per tile of
// its stage's keys; the FMA kernel one per page.
bool bad_shape(int b, int sq, int h, int hk, int d, int ps, int P,
               int splits, int path) {
  if (b < 1 || sq < 1 || h < 1 || hk < 1 || h % hk != 0 || d < 1 || d > 256 ||
      ps < 1 || P < 1 || splits < 1 || splits > 65535)
    return true;
  const long long keys = (long long)P * ps;
  if (path == kPathMma) return splits > (keys + kChunkKeys - 1) / kChunkKeys;
  if (path == kPathWalk) return splits > keys;
  if (path == kPathFma) return splits > P;
  return true;
}

}  // namespace

// q: [b, sq, h, d]; arenas: [pages, ps, hk, d]; tables: [b, P] int32;
// pos: [b] int32; out: [b, sq, h, d].  Each slot's page walk splits into
// `splits` blocks (at most P for the FMA kernel, the table's 64-key tiles
// for the chunk kernel); with more than one, ws is a float32 workspace of
// b * hk * splits * rep * sq * (d + 2) elements, else it may be null.
// `path`: 0 the FMA walk, 1 the tensor-core chunk window (bf16 or fp16, d
// 64 or 128, 16+ rows), 2 the decode walk (bf16 or fp16, d 64 or 128,
// under 16 rows).
// All contiguous.
extern "C" int ptt_paged_decode(const void* q, const void* ak, const void* av,
                                const void* tables, const void* pos, void* out,
                                void* ws, int splits, int path, int b, int sq,
                                int h, int hk, int d, int ps, int P,
                                int max_len, float scale, int dtype,
                                void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits, path))
    return (int)cudaErrorInvalidValue;
  return (int)route<false>(
      path, dtype, q, ak, av, nullptr, nullptr, tables, nullptr, pos, out,
      kNoPartials, ws, Walk{1, 0, splits}, b, sq, h, hk, d, ps, P, max_len,
      scale, static_cast<cudaStream_t>(stream));
}

// The same over int8 arenas [pages, ps, hk, d] with float32 scales
// [pages, ps, hk, 1] (ks, vs); q and out in `dtype`.
extern "C" int ptt_paged_decode_q8(const void* q, const void* ak,
                                   const void* av, const void* ks,
                                   const void* vs, const void* tables,
                                   const void* pos, void* out, void* ws,
                                   int splits, int path, int b, int sq, int h,
                                   int hk, int d, int ps, int P, int max_len,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits, path) || ks == nullptr ||
      vs == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)route<true>(path, dtype, q, ak, av, ks, vs, tables, nullptr,
                            pos, out, kNoPartials, ws, Walk{1, 0, splits}, b,
                            sq, h, hk, d, ps, P, max_len, scale,
                            static_cast<cudaStream_t>(stream));
}

// K5: the page walk of one cp shard.  q: [b, sq, h, d]; arenas: the shard's
// [per_shard, ps, hk, d] pages; tables: [b, P] LOCAL page ids (row 0 = the
// shard's scratch page); page_base: [P] int32, column j's first token
// position (rising with j); pos: [b] int32.  Writes the un-normalised
// float32 partials acc [b, hk, rep * sq, d], m and l [b, hk, rep * sq] (row
// r = group member r / sq at window offset r % sq).  ws and path as for
// ptt_paged_decode.
extern "C" int ptt_paged_decode_partials(
    const void* q, const void* ak, const void* av, const void* tables,
    const void* page_base, const void* pos, void* acc, void* m, void* l,
    void* ws, int splits, int path, int b, int sq, int h, int hk, int d,
    int ps, int P, int max_len, float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits, path) || page_base == nullptr ||
      acc == nullptr)
    return (int)cudaErrorInvalidValue;
  const Partials part{static_cast<float*>(acc), static_cast<float*>(m),
                      static_cast<float*>(l)};
  return (int)route<false>(
      path, dtype, q, ak, av, nullptr, nullptr, tables, page_base, pos,
      nullptr, part, ws, Walk{1, 0, splits}, b, sq, h, hk, d, ps, P, max_len,
      scale, static_cast<cudaStream_t>(stream));
}

// K5 over an int8 shard arena with its float32 scales [per_shard, ps, hk,
// 1] (ks, vs); q in `dtype`.
extern "C" int ptt_paged_decode_partials_q8(
    const void* q, const void* ak, const void* av, const void* ks,
    const void* vs, const void* tables, const void* page_base,
    const void* pos, void* acc, void* m, void* l, void* ws, int splits,
    int path, int b, int sq, int h, int hk, int d, int ps, int P, int max_len,
    float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits, path) || page_base == nullptr ||
      acc == nullptr || ks == nullptr || vs == nullptr)
    return (int)cudaErrorInvalidValue;
  const Partials part{static_cast<float*>(acc), static_cast<float*>(m),
                      static_cast<float*>(l)};
  return (int)route<true>(path, dtype, q, ak, av, ks, vs, tables, page_base,
                            pos, nullptr, part, ws, Walk{1, 0, splits}, b, sq,
                            h, hk, d, ps, P, max_len, scale,
                            static_cast<cudaStream_t>(stream));
}

// K5 on one card, every shard in one launch: the global arenas [cp *
// per_shard, ps, hk, d] (int8 with ks, vs [cp * per_shard, ps, hk, 1] for
// the _q8 entry), shard s owning pages [s * per_shard, (s + 1) * per_shard);
// tables: [cp, b, P] LOCAL page ids (cp_local_tables stacked, P = the
// shard's columns); page_base: [cp, P] int32; pos: [b] int32.  The grid's
// third axis is shard x split; the split combine merges all cp * splits
// partials of a row and writes the finished out [b, sq, h, d] in q's dtype.
// ws: float32 [b * hk * cp * splits * rep * sq * (d + 2)], never null.
// path as for ptt_paged_decode.
extern "C" int ptt_paged_decode_cp(const void* q, const void* ak,
                                   const void* av, const void* tables,
                                   const void* page_base, const void* pos,
                                   void* out, void* ws, int cp, int per_shard,
                                   int splits, int path, int b, int sq, int h,
                                   int hk, int d, int ps, int P, int max_len,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits, path) || page_base == nullptr ||
      cp < 2 || per_shard < 1 || (long long)cp * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const Walk w{cp, (size_t)per_shard * ps * hk, splits};
  return (int)route<false>(
      path, dtype, q, ak, av, nullptr, nullptr, tables, page_base, pos, out,
      kNoPartials, ws, w, b, sq, h, hk, d, ps, P, max_len, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_paged_decode_cp_q8(const void* q, const void* ak,
                                      const void* av, const void* ks,
                                      const void* vs, const void* tables,
                                      const void* page_base, const void* pos,
                                      void* out, void* ws, int cp,
                                      int per_shard, int splits, int path,
                                      int b, int sq, int h, int hk, int d,
                                      int ps, int P, int max_len, float scale,
                                      int dtype, void* stream) {
  if (bad_shape(b, sq, h, hk, d, ps, P, splits, path) || page_base == nullptr ||
      ks == nullptr || vs == nullptr || cp < 2 || per_shard < 1 ||
      (long long)cp * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const Walk w{cp, (size_t)per_shard * ps * hk, splits};
  return (int)route<true>(path, dtype, q, ak, av, ks, vs, tables, page_base,
                            pos, out, kNoPartials, ws, w, b, sq, h, hk, d, ps,
                            P, max_len, scale,
                            static_cast<cudaStream_t>(stream));
}
