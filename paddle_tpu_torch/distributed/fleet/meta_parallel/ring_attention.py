"""Ring (context-parallel) and Ulysses attention for the PyTorch/CUDA port:
the counterpart of `paddle_tpu/distributed/fleet/meta_parallel/
ring_attention.py`.

The sequence is split over the `sep` mesh axis.  In the reference each of
the R ranks is a device inside `shard_map`, and K/V blocks rotate around
the ring with `ppermute` while each hop's keys merge into the rank's
running (out, lse).  Here the R ranks run in one process on one device
(`distributed.mesh`), one after another: rank `my` is a host integer, the
block it holds at hop h is the tensor of rank (my - h) mod R, and the
transport is indexing.  So the reference's device-side selects become host
branches: a hop whose keys lie in the rank's future is skipped, not
computed and then discarded, and the zig-zag form's half-select is an `if`.
The math of every hop is the reference's.

Four forms, picked as `ring_attention_array` picks them (the reference's
:472-541):

- the gathered zig-zag form (causal, K/V of at most
  `_GATHERED_KV_MAX_BYTES`): q in the zig-zag layout (rank i holds chunks i
  and 2R-1-i of 2R), K/V whole; one K1 and one K3 per rank, each with the
  q blocks' absolute starts (`q_offset`), and dk/dv summed over the ranks
  (the reference's reduce-scatter);
- the rotating zig-zag form (causal, larger K/V): the K/V pair rotates;
  per rank 2R + 1 K1 launches merging through the (out, lse) carry with
  float32 partials, and 2R + 1 K3 launches reading a delta computed once;
- the Pallas-hop ring (not causal, or causal shapes the zig-zag cannot
  split): one K1 per hop with the carry, one K3 per hop with delta;
- the plain ring (`_ring_attention_local`, shards not a multiple of 128
  rows or head_dim > 256): torch ops under autograd, no kernel.

The custom VJPs are `torch.autograd.Function`s whose backward loops over
the ranks and hops as the reference's does; dk and dv partials are summed
at their home block in float32 (the reference's accumulators that travel
home), then cast once.  Ulysses (`ulysses_attention_array`) swaps the
sequence split for a head split: on one device rank r's all-to-all is the
slice of heads it would receive, and its attention is `sdpa`.

`form_counts` counts the forms taken since `reset_form_counts()`.
"""

from __future__ import annotations

import math

import torch

from ....ops import flash_attention as fa
from ... import mesh as _mesh

NEG_INF = fa.NEG_INF

# per-rank budget for the gathered-KV causal form, in bytes (K and V of the
# whole sequence, batch included); beyond it the K/V pairs rotate hop by
# hop (the reference's, :28)
_GATHERED_KV_MAX_BYTES = 256 * 1024 * 1024

FORMS = ("gathered", "rotating", "hops", "plain", "ulysses")
form_counts = dict.fromkeys(FORMS, 0)


def reset_form_counts():
    for name in form_counts:
        form_counts[name] = 0


# ---------------------------------------------------------------------------
# the plain ring: torch ops, differentiated by autograd
# ---------------------------------------------------------------------------


def _block_attn(q, k, v, scale, mask):
    """One block (the reference's :32): (unnormalised acc, row max m, row
    sum l) of q [b, h, sq, d] against k, v [b, h, sk, d]; `mask` [sq, sk]
    bool (True: attend) or None.  Products in float32 of the input values;
    p rounded to v's dtype before p.v."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def _merge(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, a1 * l1 + a2 * l2


def _ring_attention_local(q, ks, vs, my, causal, scale):
    """Rank `my`'s plain ring (the reference's :59): its q shard [b, sq, h,
    d] against every rank's K/V shard (`ks`, `vs`), merged in the
    reference's order (the diagonal first, then ranks my-1, my-2, ...).  A
    causal hop whose block lies in the future is skipped: its keys are
    all masked, so the reference's merge gives it weight exp(NEG_INF - m)
    = 0."""
    R = len(ks)
    qh = q.transpose(1, 2)  # [b, h, sq, d]
    b, h, sq, d = qh.shape
    acc = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, sq, dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)
    for step in range(R):
        kv_idx = (my - step) % R
        if causal and kv_idx > my:
            continue
        mask = None
        if causal:
            mask = (my * sq + rows)[:, None] >= (kv_idx * sq + rows)[None, :]
        acc2, m2, l2 = _block_attn(qh, ks[kv_idx].transpose(1, 2),
                                   vs[kv_idx].transpose(1, 2), scale, mask)
        acc, m, l = _merge(acc, m, l, acc2, m2, l2)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)


# ---------------------------------------------------------------------------
# kernel forms
# ---------------------------------------------------------------------------


def _shards(x, R):
    """The R rank shards of x [b, S, ...] along the sequence, contiguous
    (views when b == 1)."""
    return [t.contiguous() for t in x.chunk(R, dim=1)]


def _halves(x):
    """The two chunks of a zig-zag rank shard [b, 2c, ...], contiguous."""
    c = x.shape[1] // 2
    return x[:, :c].contiguous(), x[:, c:].contiguous()


def _cols(x, i, n):
    """Columns [i n, (i + 1) n) of x [b, h, S] (an lse or a delta),
    contiguous."""
    return x[:, :, i * n:(i + 1) * n].contiguous()


def _delta(g, out):
    """rowsum(g * out) in float32, [b, h, s]: hop-invariant, computed once
    for all of a rank's hops (the reference's :149)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _RingHops(torch.autograd.Function):
    """The Pallas-hop ring (the reference's `_ring_attention_pallas_local`,
    :97-199) over every rank: per hop one K1 launch merging onto the
    rank's float32 (out, lse) carry; the backward computes delta once, then
    one K3 launch per hop reading it, with probabilities recomputed from
    the final lse.  Future hops of a causal ring are skipped in both
    directions.  Returns the float32 output."""

    @staticmethod
    def forward(ctx, q, k, v, R, causal, scale):
        qs, ks, vs = _shards(q, R), _shards(k, R), _shards(v, R)
        outs, lses = [], []
        for my in range(R):
            out = lse = None
            for hop in range(R):
                j = (my - hop) % R
                if causal and hop > 0 and j > my:
                    continue  # keys in this rank's future
                out, lse = fa.flash_forward(
                    qs[my], ks[j], vs[j], causal and hop == 0, scale,
                    carry=None if out is None else (out, lse),
                    out_dtype=torch.float32)
            outs.append(out)
            lses.append(lse)
        out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (R, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        R, causal, scale = ctx.ring
        # g is the cotangent of the final cast to q's dtype: exact there
        g = g.to(q.dtype)
        delta = _delta(g, out)
        qs, ks, vs, gs = (_shards(x, R) for x in (q, k, v, g))
        dq = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        sk = k.shape[1] // R
        for my in range(R):
            lse_my, delta_my = _cols(lse, my, sk), _cols(delta, my, sk)
            dq_my = torch.zeros(qs[my].shape, dtype=torch.float32, device=q.device)
            for hop in range(R):
                j = (my - hop) % R
                if causal and hop > 0 and j > my:
                    continue
                dq_h, dk_h, dv_h = fa.flash_backward(
                    qs[my], ks[j], vs[j], None, lse_my, gs[my],
                    causal and hop == 0, scale, delta=delta_my)
                dq_my.add_(dq_h)  # summed in float32
                dk[:, j * sk:(j + 1) * sk].add_(dk_h)
                dv[:, j * sk:(j + 1) * sk].add_(dv_h)
            dq.append(dq_my)
        return (torch.cat(dq, 1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def _zigzag_ring_fwd(qz, kz, vz, my, scale):
    """Rank `my`'s forward of the rotating zig-zag form (the reference's
    `_fwd`, :233-294): its q halves (chunks my and 2R-1-my) against each
    rank's K/V pair.  Hop 0 (its own pair): lo x lo causal, hi x lo full,
    hi x hi causal; hop h > 0 (peer j = my - h): hi x lo(j) full, then lo x
    lo(j) when j < my, else hi x hi(j): 2R + 1 K1 launches, float32
    partials merged through the carry.  `qz`, `kz`, `vz`: every rank's
    shard.  Returns (out f32, lse)."""
    R = len(kz)
    q_lo, q_hi = _halves(qz[my])
    lo = hi = None

    def merge(state, qb, kb, vb, causal):
        return fa.flash_forward(qb, kb, vb, causal, scale, carry=state,
                                out_dtype=torch.float32)

    for hop in range(R):
        j = (my - hop) % R
        k_lo, k_hi = _halves(kz[j])
        v_lo, v_hi = _halves(vz[j])
        if hop == 0:
            lo = merge(None, q_lo, k_lo, v_lo, True)    # diagonal
            hi = merge(None, q_hi, k_lo, v_lo, False)   # hi sees lo fully
            hi = merge(hi, q_hi, k_hi, v_hi, True)      # diagonal
        else:
            hi = merge(hi, q_hi, k_lo, v_lo, False)     # always valid
            if hop <= my:  # j < my: q_lo sees kv_lo fully, kv_hi is future
                lo = merge(lo, q_lo, k_lo, v_lo, False)
            else:          # j > my: q_hi sees kv_hi fully, q_lo sees none
                hi = merge(hi, q_hi, k_hi, v_hi, False)
    return torch.cat([lo[0], hi[0]], 1), torch.cat([lo[1], hi[1]], 2)


class _ZigzagRing(torch.autograd.Function):
    """The rotating zig-zag form (the reference's
    `_ring_attention_zigzag_local`, :202-372) over every rank, on q, k, v
    already in the zig-zag layout.  Returns the float32 output."""

    @staticmethod
    def forward(ctx, q, k, v, R, scale):
        qz, kz, vz = _shards(q, R), _shards(k, R), _shards(v, R)
        parts = [_zigzag_ring_fwd(qz, kz, vz, my, scale) for my in range(R)]
        out = torch.cat([p[0] for p in parts], 1)
        lse = torch.cat([p[1] for p in parts], 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (R, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        R, scale = ctx.ring
        g = g.to(q.dtype)  # exact: the cotangent of the final cast
        delta = _delta(g, out)
        c = q.shape[1] // (2 * R)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        rows = lambda i: slice(i * c, (i + 1) * c)  # chunk i of the layout

        def block(qc, kc, causal):
            """K3 of q chunk `qc` against k/v chunk `kc` (chunks of the
            zig-zag layout); dq, dk, dv added at their rows."""
            kb, vb = k[:, rows(kc)].contiguous(), v[:, rows(kc)].contiguous()
            d_q, d_k, d_v = fa.flash_backward(
                q[:, rows(qc)].contiguous(), kb, vb, None, _cols(lse, qc, c),
                g[:, rows(qc)].contiguous(), causal, scale,
                delta=_cols(delta, qc, c))
            dq[:, rows(qc)].add_(d_q)  # summed in float32
            dk[:, rows(kc)].add_(d_k)
            dv[:, rows(kc)].add_(d_v)

        for my in range(R):
            lo, hi = 2 * my, 2 * my + 1  # rank my's chunks in the layout
            for hop in range(R):
                j = (my - hop) % R
                j_lo, j_hi = 2 * j, 2 * j + 1
                if hop == 0:
                    block(lo, j_lo, True)
                    block(hi, j_lo, False)
                    block(hi, j_hi, True)
                else:
                    block(hi, j_lo, False)
                    if hop <= my:
                        block(lo, j_lo, False)
                    else:
                        block(hi, j_hi, False)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


_starts_cache = {}


def _zigzag_starts(S, R, my, device):
    """Rank `my`'s q-block starts in the gathered form (chunks my and
    2R-1-my of c = S / 2R rows, blocks of `_pick_block(c, 1024)` rows),
    built once per (S, R, rank, device) and kept on the device, so a call
    makes no host-to-device copy."""
    key = (S, R, my, str(device))
    if key not in _starts_cache:
        c = S // (2 * R)
        _starts_cache[key] = fa.q_block_starts(
            [(my * c, c), ((2 * R - 1 - my) * c, c)], _pick_block(c, 1024), device)
    return _starts_cache[key]


def _pick_block(seq_len, pref):
    """The reference's `_pick_block` (flash_attention.py:157): the largest
    multiple-of-128 divisor of seq_len that is <= pref."""
    best = 128
    b = 128
    while b <= min(seq_len, pref):
        if seq_len % b == 0:
            best = b
        b += 128
    return best


class _GatheredZigzag(torch.autograd.Function):
    """The gathered zig-zag form (the reference's
    `_gathered_zigzag_cp_local`, :375-447) over every rank: q in the
    zig-zag layout, K/V whole (the all-gather of contiguous shards is the
    global order).  Per rank one K1 and one K3 over all keys with the q
    blocks' absolute starts; the backward's dk/dv of every rank are summed
    (the reduce-scatter) in float32.  Returns q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, R, scale):
        S = q.shape[1]
        outs, lses = [], []
        for my, qz in enumerate(_shards(q, R)):
            starts = _zigzag_starts(S, R, my, q.device)
            out, lse = fa.flash_forward(qz, k, v, True, scale, q_offset=starts)
            outs.append(out)
            lses.append(lse)
        out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (R, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        R, scale = ctx.ring
        S = q.shape[1]
        g = g.contiguous()
        qs, gs, outs = _shards(q, R), _shards(g, R), _shards(out, R)
        dq = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for my in range(R):
            starts = _zigzag_starts(S, R, my, q.device)
            d_q, d_k, d_v = fa.flash_backward(
                qs[my], k, v, outs[my], _cols(lse, my, S // R), gs[my], True,
                scale, q_offset=starts)
            dq.append(d_q)
            dk.add_(d_k)  # summed in float32: the reduce-scatter
            dv.add_(d_v)
        return torch.cat(dq, 1), dk.to(k.dtype), dv.to(v.dtype), None, None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


_perm_cache = {}


def _zigzag_perm(S, R, device=None):
    """Chunk permutation (the reference's :450): contiguous layout ->
    zig-zag (rank i gets chunks i and 2R-1-i) and its inverse, as int64
    index tensors over axis 1 on `device`, built once per (S, R, device)."""
    key = (S, R, str(device))
    if key not in _perm_cache:
        c = S // (2 * R)
        order = []
        for i in range(R):
            order += [i, 2 * R - 1 - i]
        fwd = torch.cat([torch.arange(c) + ch * c for ch in order])
        inv = torch.empty_like(fwd)
        inv[fwd] = torch.arange(S)
        _perm_cache[key] = (fwd.to(device), inv.to(device))
    return _perm_cache[key]


def _pallas_hops_viable(q, R):
    """The reference's shape rule (:463): each rank's shard a multiple of
    128 rows and head_dim <= 256.  Its device part (on a TPU, or Pallas
    interpreted) always holds here: every kernel has a plain version on the
    CPU."""
    b, S, h, d = q.shape
    sq = S // R
    return sq % 128 == 0 and d <= fa.MAX_HEAD_DIM


def _ring_mesh(q, k, v, axis_name, mesh):
    """The sep axis's degree, or None when there is no such axis (or it is
    1); checks the tensors against the mesh."""
    mesh = mesh or _mesh.get_mesh()
    if mesh is None or axis_name not in mesh.axis_names or mesh.shape[axis_name] == 1:
        return None
    R = mesh.shape[axis_name]
    for t in (q, k, v):
        if t.device != mesh.device:
            raise ValueError(f"ring attention: a tensor on {t.device}, the "
                             f"mesh's ranks on {mesh.device}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring attention: q, k, v must share [b, S, h, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} "
                         "(repeat GQA kv heads first)")
    if q.shape[1] % R != 0:
        raise ValueError(f"ring attention: sequence {q.shape[1]} not divisible "
                         f"by the {axis_name} axis ({R})")
    return R


def ring_attention_array(q, k, v, axis_name="sep", causal=True, scale=None,
                         mesh=None):
    """Array-level entry (the reference's :472): q, k, v [b, S, h, d] split
    over `axis_name` of the mesh into R rank shards; returns [b, S, h, d] in
    q's dtype.  Without the axis (or at degree 1) it is `sdpa`."""
    R = _ring_mesh(q, k, v, axis_name, mesh)
    if R is None:
        return fa.sdpa(q, k, v, None, causal, scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, S, h, d = q.shape
    c = S // (2 * R)
    if causal and _pallas_hops_viable(q, R) and S % (2 * R) == 0 and c % 128 == 0:
        # balanced causal CP in the zig-zag layout; K/V that fit a rank
        # (<= _GATHERED_KV_MAX_BYTES, batch included) take the gathered form
        fwd_idx, inv_idx = _zigzag_perm(S, R, q.device)
        kv_bytes = b * S * h * d * 2 * q.element_size()
        if kv_bytes <= _GATHERED_KV_MAX_BYTES:
            form_counts["gathered"] += 1
            qz = q.index_select(1, fwd_idx)
            return _GatheredZigzag.apply(qz, k, v, R, scale).index_select(1, inv_idx)
        form_counts["rotating"] += 1
        qz, kz, vz = (x.index_select(1, fwd_idx) for x in (q, k, v))
        out = _ZigzagRing.apply(qz, kz, vz, R, scale).to(q.dtype)
        return out.index_select(1, inv_idx)
    if _pallas_hops_viable(q, R):
        form_counts["hops"] += 1
        return _RingHops.apply(q, k, v, R, causal, scale).to(q.dtype)
    form_counts["plain"] += 1
    ks, vs = k.chunk(R, dim=1), v.chunk(R, dim=1)
    return torch.cat([_ring_attention_local(qm, ks, vs, my, causal, scale)
                      for my, qm in enumerate(q.chunk(R, dim=1))], 1)


class RingFlashAttention:
    """Layer-ish API mirroring PaddleNLP's RingFlashAttention (the
    reference's :543)."""

    @staticmethod
    def apply(query, key, value, causal=True, axis_name="sep"):
        return ring_attention_array(query, key, value, axis_name, causal)


def ring_flash_attention(query, key, value, causal=True, axis_name="sep"):
    return RingFlashAttention.apply(query, key, value, causal, axis_name)


# ---------------------------------------------------------------------------
# Ulysses: the sequence split swapped for a head split (the reference's
# :565-641)
# ---------------------------------------------------------------------------


def ulysses_attention_array(q, k, v, axis_name="sep", causal=True, scale=None,
                            mesh=None):
    """q, k, v [b, S, h, d] split over `axis_name`: the all-to-all gives
    rank r every position of heads [r h/R, (r+1) h/R), `sdpa` attends them,
    and the inverse all-to-all restores the sequence split.  On one device
    rank r's share is that slice of heads.  h must divide by R."""
    R = _ring_mesh(q, k, v, axis_name, mesh)
    if R is None:
        return fa.sdpa(q, k, v, None, causal, scale)
    h = q.shape[2]
    if h % R != 0:
        raise ValueError(f"ulysses attention: {h} heads not divisible by the "
                         f"{axis_name} axis ({R})")
    form_counts["ulysses"] += 1
    hr = h // R
    outs = []
    for r in range(R):
        heads = slice(r * hr, (r + 1) * hr)
        outs.append(fa.sdpa(q[:, :, heads].contiguous(), k[:, :, heads].contiguous(),
                            v[:, :, heads].contiguous(), None, causal, scale))
    return torch.cat(outs, 2)


def ulysses_attention(query, key, value, causal=True, axis_name="sep"):
    return ulysses_attention_array(query, key, value, axis_name, causal)
