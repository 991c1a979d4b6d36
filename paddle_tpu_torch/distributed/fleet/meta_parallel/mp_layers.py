"""Tensor-parallel layers of the PyTorch/CUDA port (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py`:
ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
ParallelCrossEntropy).

The reference's layers carry NamedShardings on the 'mp' mesh axis and let
GSPMD insert the identity / all-reduce pairs.  Here each layer keeps its
whole logical weight (the same name and shape as the reference's, so
`models.convert.load_reference_state` loads it unchanged) and, once
`shard(mesh)` binds it to an 'mp' mesh, runs one `torch.matmul` per rank on
that rank's shard.  A rank's shard is a view of the weight, cut at each
call (a view costs no copy and follows `load_state_dict` as it replaces
the weight): column shards are row blocks of torch's `[out, in]` weight,
row shards its column blocks.  Unbound, a layer is one rank and computes
what `torch.nn.Linear` / `Embedding` compute.

Where the reference's tensors are sharded, the port's are lists of the
ranks' tensors: a column-parallel output with `gather_output=False` is the
list of the ranks' column blocks, and a row-parallel input with
`input_is_parallel=True` is such a list.  The row-parallel partial products
meet in the mesh's `reduce` (a float32 sum, rounded once), the vocabulary
shards of an embedding lookup in the same sum (one rank holds each id, the
others add exact zeros), a gathered output in its `all_gather`.

Training at tp > 1 (gradients through the reduce and the gather) waits for
ROADMAP Queue 1 item 17; the forwards are held against the reference's on
the CPU.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ... import mesh as _mesh


def rank_bounds(n, ranks):
    """[(start, stop)] of rank r's block of an axis of n elements split over
    `ranks` ranks in contiguous blocks (equal when ranks divides n)."""
    return [(r * n // ranks, (r + 1) * n // ranks) for r in range(ranks)]


class _Sharded:
    """The mesh binding shared by the parallel layers: `mesh` is the 'mp'
    mesh the layer runs on (None: one rank)."""

    mesh = None

    def shard(self, mesh):
        """Bind the layer to `mesh`'s 'mp' axis (None or mp 1: one rank)."""
        self.mesh = mesh if mesh is not None and mesh.mp > 1 else None
        return self

    @property
    def ranks(self):
        return 1 if self.mesh is None else self.mesh.mp

    @property
    def world_size(self):
        return self.ranks

    def _bind_installed(self):
        self.shard(_mesh.get_mesh() if _mesh.axis_size("mp") > 1 else None)


class ColumnParallelLinear(_Sharded, nn.Linear):
    """Weight `[out, in]` (torch's layout) split over the ranks on `out`;
    rank r computes its block of the output columns from the whole input.
    `gather_output` joins the blocks into one tensor, else the layer
    returns the ranks' list (reference: mp_layers.py:27-57)."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=None,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None,
                 name=None, device=None, dtype=None):
        nn.Linear.__init__(self, in_features, out_features,
                           bias=has_bias is None or bool(has_bias), device=device,
                           dtype=dtype)
        self.gather_output = gather_output
        self._bind_installed()

    def rank_output(self, x, r):
        """Rank r's output block [..., out / ranks] of the input x."""
        a, b = rank_bounds(self.out_features, self.ranks)[r]
        bias = None if self.bias is None else self.bias[a:b]
        return F.linear(x, self.weight[a:b], bias)

    def gather(self, parts):
        """The ranks' output blocks joined into one tensor [..., out]."""
        return parts[0] if self.mesh is None else self.mesh.all_gather(parts)

    def forward(self, x):
        parts = [self.rank_output(x, r) for r in range(self.ranks)]
        return self.gather(parts) if self.gather_output else parts


class RowParallelLinear(_Sharded, nn.Linear):
    """Weight `[out, in]` split over the ranks on `in`: rank r multiplies
    its block of the input by its block of the weight, and the partial
    products meet in the mesh's reduce; the bias is added after the reduce
    (reference: mp_layers.py:60-89).  With `input_is_parallel` the input is
    the ranks' list (a column-parallel layer's output), else one tensor the
    layer splits."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None,
                 name=None, device=None, dtype=None):
        nn.Linear.__init__(self, in_features, out_features, bias=bool(has_bias),
                           device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel
        self._bind_installed()

    def split_input(self, x):
        """The ranks' blocks of a whole input x [..., in]."""
        return [x[..., a:b] for a, b in rank_bounds(self.in_features, self.ranks)]

    def partial(self, x, r):
        """Rank r's partial product of its input block x [..., in / ranks]."""
        a, b = rank_bounds(self.in_features, self.ranks)[r]
        return F.linear(x, self.weight[:, a:b])

    def reduce(self, parts):
        """The ranks' partial products summed (the all-reduce), plus the
        bias."""
        out = parts[0] if self.mesh is None else self.mesh.reduce(parts)
        return out if self.bias is None else out + self.bias

    def forward(self, x):
        if not isinstance(x, (list, tuple)):
            x = self.split_input(x)
        return self.reduce([self.partial(xr, r) for r, xr in enumerate(x)])


class VocabParallelEmbedding(_Sharded, nn.Embedding):
    """Embedding table `[vocab, dim]` split over the ranks on the vocabulary
    (reference: mp_layers.py:92-111): rank r looks up the ids in its block
    and writes zeros for the others; the ranks' rows meet in the reduce,
    where exactly one rank holds each id, so the sum is exact."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        nn.Embedding.__init__(self, num_embeddings, embedding_dim, device=device,
                              dtype=dtype)
        self._bind_installed()

    def forward(self, ids):
        if self.mesh is None:
            return F.embedding(ids, self.weight)
        parts = []
        for a, b in rank_bounds(self.num_embeddings, self.ranks):
            inside = (ids >= a) & (ids < b)
            rows = F.embedding(torch.where(inside, ids - a, 0), self.weight[a:b])
            parts.append(torch.where(inside[..., None], rows, 0))
        return self.mesh.reduce(parts)


class ParallelCrossEntropy(nn.Module):
    """Cross-entropy over vocabulary-sharded logits (reference:
    mp_layers.py:114-156, the forward): per-shard max and sum of
    exponentials in float32 merged into the log-sum-exp, the label's logit
    picked from the shard that holds it, each token's loss clamped at 0 and
    zero where the label is `ignore_index`.  `input` is the ranks' list of
    logit blocks [..., vocab / ranks] (a column-parallel lm_head's output),
    or one tensor (one rank).  Returns the per-token loss [..., 1]."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        parts = list(input) if isinstance(input, (list, tuple)) else [input]
        l32 = [p.float() for p in parts]
        lab = label
        if lab.dim() == l32[0].dim() and lab.shape[-1] == 1:
            lab = lab[..., 0]
        idx = lab.long()
        valid = idx != self.ignore_index
        safe = torch.where(valid, idx, 0)
        m = torch.stack([x.amax(dim=-1) for x in l32]).amax(dim=0)
        total = sum(torch.exp(x - m[..., None]).sum(dim=-1) for x in l32)
        lse = m + torch.log(total)
        picked = torch.zeros_like(m)
        start = 0
        for x in l32:
            stop = start + x.shape[-1]
            inside = (safe >= start) & (safe < stop)
            local = torch.where(inside, safe - start, 0)
            got = x.gather(-1, local[..., None])[..., 0]
            picked = picked + torch.where(inside, got, 0.0)
            start = stop
        loss = (lse - picked).clamp(min=0.0) * valid.float()
        return loss[..., None]


class ParallelColumnLinear(ColumnParallelLinear):
    """The reference's alias (mp_layers.py:158)."""
