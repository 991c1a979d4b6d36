"""Mixture of experts for the PyTorch/CUDA port (counterpart of
`paddle_tpu/incubate/moe.py`): GShard top-k gating with capacity and the
load-balancing loss, expert choice, the stacked expert FFN and the dense
one-hot dispatch and combine.

The routing functions (:36-126) are plain functions on tensors with the
reference's contract and its tie and drop rules:

- the k experts of a token are its k largest gate probabilities, ties to
  the lower expert index (`lax.top_k`); expert choice picks each expert's
  tokens the same way.  A stable descending sort gives that order, where
  `torch.topk`'s order among equal values is unspecified (under O2 the gate's
  logits are bf16, so equal probabilities are ordinary);
- capacity slots are claimed in token order, round 0 before round 1, in
  int32 arithmetic;
- an assignment past capacity gets an all-zero slot row: the slot one-hot is
  a comparison with `arange(capacity)`, where `torch.nn.functional.one_hot`
  would raise on the CPU and trip a device-side assert on the card.

`MoELayer` runs the dense path of the reference (:200-250): `einsum
("td,tec->ecd")` over the dispatch tensor cast to the activations' dtype,
the experts as batched products, and the combine over the combine tensor
cast to the experts' output dtype (under O2 the gate weights round to
bf16, as in the reference).  The expert-parallel path over an `ep` (or
`mp`) mesh axis with its all-to-all exchange (:252-333) raises
NotImplementedError: it is ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..distributed import mesh as _mesh

_EP = ("is not ported yet (ROADMAP.md Queue 1, item 17: the expert-parallel "
       "all_to_all dispatch goes with the cross-card collectives)")


def _one_hot(idx, n, dtype):
    """one_hot(idx, n) as `jax.nn.one_hot` computes it: an index outside
    [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(x, k):
    """(values, indices) of the k largest entries along the last dim, in
    descending order with ties to the lower index (`lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gate_dispatch_tensors(lg, k, capacity, valid=None):
    """From router logits [T, E] build (dispatch [T, E, C], combine [T, E,
    C], aux_loss, (dropped, used)) (reference: moe.py:36-91).  The softmax
    runs in float32; aux is E * sum(me * ce) with me the mean probability
    and ce the share of tokens whose first choice is each expert.  Each of
    the k rounds gives every token its r-th expert's next free slot, in
    token order; a slot past `capacity` is a dropped assignment (its row
    of both tensors stays zero).  The combine weights are the top-k
    probabilities of the assignments kept, divided by their sum.

    valid: optional [T] bool; invalid rows claim no slot and stay out of
    aux and the drop count.  Returns float32 tensors, the drop count a
    float32 scalar and `used` int32 [E] (slots taken per expert)."""
    tokens, e = lg.shape
    probs = torch.softmax(lg.float(), dim=-1)
    first = _one_hot(probs.argmax(-1), e, torch.float32)
    if valid is not None:
        v32 = valid.float()
        n_valid = v32.sum().clamp(min=1.0)
        me = (probs * v32[:, None]).sum(0) / n_valid
        ce = (first * v32[:, None]).sum(0) / n_valid
    else:
        me = probs.mean(0)
        ce = first.mean(0)
    aux = (me * ce).sum() * e

    topv, topi = _top_k(probs, k)  # [T, k]
    sel = _one_hot(topi, e, torch.int32)  # [T, k, E]
    if valid is not None:
        sel = sel * valid.to(torch.int32)[:, None, None]
    dev = lg.device
    disp = torch.zeros((tokens, e, capacity), dtype=torch.float32, device=dev)
    comb = torch.zeros((tokens, e, capacity), dtype=torch.float32, device=dev)
    used = torch.zeros((e,), dtype=torch.int32, device=dev)
    gates_accum = torch.zeros((tokens,), dtype=torch.float32, device=dev)
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(k):
        s = sel[:, r]  # [T, E]
        pos = torch.cumsum(s, 0, dtype=torch.int32) * s - s + used[None, :] * s
        slot = (pos * s).sum(-1, dtype=torch.int32)  # [T]
        fits = slot < capacity
        onehot_slot = _one_hot(slot, capacity, torch.float32)
        contrib = (s.float()[:, :, None] * onehot_slot[:, None, :]
                   * fits.float()[:, None, None])
        disp = disp + contrib
        comb = comb + contrib * topv[:, r][:, None, None]
        used = used + (s * fits[:, None].to(torch.int32)).sum(0, dtype=torch.int32)
        gates_accum = gates_accum + topv[:, r] * fits.float()
        dropped = dropped + (1.0 - fits.float()).sum()
    comb = comb / gates_accum.clamp(min=1e-9)[:, None, None]
    return disp, comb, aux, (dropped, used)


def expert_choice_tensors(lg, capacity, valid=None):
    """Expert-choice routing (reference: moe.py:94-118): each expert picks
    its `capacity` highest-scoring tokens (scores: the softmax over tokens,
    per expert), capacity clamped to the number of tokens.  Load is
    balanced by construction, so aux is 0 and `used` is `capacity` for
    every expert; a token no expert picks is dropped (the residual carries
    it).  The same (disp, comb, aux, (dropped, used)) contract as
    `gate_dispatch_tensors`."""
    tokens, e = lg.shape
    capacity = min(capacity, tokens)
    lg = lg.float()
    if valid is not None:
        lg = torch.where(valid[:, None], lg, float("-inf"))
    scores = torch.softmax(lg, dim=0)
    g, i = _top_k(scores.t(), capacity)  # [E, C]: expert -> its tokens
    disp = _one_hot(i, tokens, torch.float32).permute(2, 0, 1)  # [T, E, C]
    comb = disp * g[None]
    covered = disp.sum((1, 2)).clamp(0.0, 1.0)
    if valid is not None:
        dropped = (valid.float() * (1.0 - covered)).sum()
    else:
        dropped = (1.0 - covered).sum()
    used = torch.full((e,), capacity, dtype=torch.int32, device=lg.device)
    return disp, comb, torch.zeros((), dtype=torch.float32, device=lg.device), (
        dropped, used)


def route_tokens(lg, k, capacity, expert_choice, valid=None):
    """The routing entry of the gate (reference: moe.py:121-126)."""
    if expert_choice:
        return expert_choice_tensors(lg, capacity, valid=valid)
    return gate_dispatch_tensors(lg, k, capacity, valid=valid)


class TopKGate(nn.Module):
    """Top-1 ("switch"), top-k ("gshard") or expert-choice gate (reference:
    moe.py:129-157): `wg` a Linear without bias from d_model to the experts,
    capacity max(int(capacity_factor * tokens * top_k / E), 1) per expert,
    a host int from the static token count."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.25,
                 gate_type="gshard", device=None, dtype=None):
        super().__init__()
        if gate_type not in ("gshard", "switch", "expert_choice"):
            raise ValueError(f"unknown gate_type {gate_type!r}")
        self.num_experts = num_experts
        self.gate_type = gate_type
        self.top_k = 1 if gate_type == "switch" else top_k
        self.capacity_factor = capacity_factor
        self.wg = nn.Linear(d_model, num_experts, bias=False, device=device,
                            dtype=dtype)

    def capacity(self, tokens):
        return max(int(self.capacity_factor * tokens * self.top_k
                       / self.num_experts), 1)

    def forward(self, x):
        """x: [tokens, d_model].  Returns (dispatch [T, E, C], combine [T,
        E, C], aux_loss, dropped, expert_used)."""
        cap = self.capacity(int(x.shape[0]))
        disp, comb, aux, (dropped, used) = route_tokens(
            self.wg(x), self.top_k, cap, self.gate_type == "expert_choice")
        return disp, comb, aux, dropped, used


def expert_ffn(a, w1, b1, w2, b2, activation="gelu"):
    """The E experts' FFN on their slots (reference: `_expert_ffn_arrays`,
    moe.py:187-189): a [E, C, d] -> act(a @ w1 + b1) @ w2 + b2, the products
    batched over experts.  "gelu" is the tanh approximation
    (`jax.nn.gelu`'s default), else relu."""
    h = torch.bmm(a, w1) + b1
    h = F.gelu(h, approximate="tanh") if activation == "gelu" else F.relu(h)
    return torch.bmm(h, w2) + b2


class ExpertFFN(nn.Module):
    """E experts' FFN weights as stacked parameters (reference: moe.py:
    160-183): w1 [E, d, h], b1 [E, 1, h], w2 [E, h, d], b2 [E, 1, d]."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 device=None, dtype=None):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise ValueError(f"expert activation must be gelu or relu, got "
                             f"{activation!r}")
        kw = dict(device=device, dtype=dtype)
        self.w1 = nn.Parameter(torch.empty(num_experts, d_model, d_hidden, **kw))
        self.b1 = nn.Parameter(torch.zeros(num_experts, 1, d_hidden, **kw))
        self.w2 = nn.Parameter(torch.empty(num_experts, d_hidden, d_model, **kw))
        self.b2 = nn.Parameter(torch.zeros(num_experts, 1, d_model, **kw))
        self.activation = activation
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier-normal expert matrices (std sqrt(2 / (d + h)) for each),
        zero biases."""
        std = math.sqrt(2.0 / (self.w1.shape[1] + self.w1.shape[2]))
        for w in (self.w1, self.w2):
            w.normal_(0.0, std, generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x):
        """x: [E, C, d_model] -> [E, C, d_model]."""
        return expert_ffn(x, self.w1, self.b1, self.w2, self.b2, self.activation)


def _check_dense_mesh():
    for axis in ("ep", "mp"):
        n = _mesh.axis_size(axis)
        if n > 1:
            raise NotImplementedError(
                f"MoELayer over an {axis} axis of {n} {_EP}")


class MoELayer(nn.Module):
    """The reference's MoE layer (moe.py:200-250): a gate and a stack of E
    expert FFNs in place of a dense FFN.  Input [B, S, D] -> output [B, S,
    D].  Each forward sets `aux_loss` (the gate's load-balancing loss, a
    float32 scalar) and `drop_stats`: "dropped_tokens" (assignments past
    capacity), "dropped_fraction" (that over tokens * top_k, or over tokens
    for expert choice) and "expert_used" ([E] int32).  All are tensors on
    the layer's device that the forward creates: a captured step returns
    them without a host read."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, gate="gshard", activation="gelu",
                 device=None, dtype=None):
        super().__init__()
        self.num_experts = num_experts
        self.gate = TopKGate(d_model, num_experts, top_k, capacity_factor, gate,
                             device=device, dtype=dtype)
        self.experts = ExpertFFN(num_experts, d_model, d_hidden, activation,
                                 device=device, dtype=dtype)
        self.aux_loss = None
        self.drop_stats = None

    def _set_stats(self, dropped, used, tokens):
        k = self.gate.top_k if self.gate.gate_type != "expert_choice" else 1
        self.drop_stats = {
            "dropped_tokens": dropped,
            "dropped_fraction": dropped / float(max(tokens * k, 1)),
            "expert_used": used,
        }

    def forward(self, x):
        _check_dense_mesh()
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        disp, comb, aux, dropped, used = self.gate(flat)
        self.aux_loss = aux
        self._set_stats(dropped, used, b * s)
        expert_in = torch.einsum("td,tec->ecd", flat, disp.to(flat.dtype))
        expert_out = self.experts(expert_in)
        out = torch.einsum("ecd,tec->td", expert_out, comb.to(expert_out.dtype))
        return out.reshape(b, s, d)
