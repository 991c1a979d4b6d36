"""Loss plumbing shared by the port's models (counterpart of
`paddle_tpu/models/_utils.py`)."""

from __future__ import annotations

import torch


def sequence_ce(logits, labels, ignore_index=-100):
    """Mean cross-entropy over the labels that are not `ignore_index`, with
    the reference's numerics (`sequence_ce`, models/_utils.py:13-25, through
    `nn.functional.cross_entropy`): float32 log-softmax, each token's loss
    clamped at 0, the sum divided by max(valid count, 1) -- so an all-ignored
    batch gives 0, not NaN.  No label shift: the loss at position i scores
    label i.  logits: [..., vocab] (cast to float32 here); labels: [...]
    integer ids (cast to int64, which torch's gather requires).  Returns a
    float32 scalar."""
    vocab = logits.shape[-1]
    lg = logits.reshape(-1, vocab).float()
    lab = labels.reshape(-1).long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = lg.gather(1, safe[:, None])[:, 0]
    loss = (torch.logsumexp(lg, dim=-1) - picked).clamp(min=0.0)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().clamp(min=1).float()
