"""Load the JAX package's model weights (Llama, BERT) into the port's
models."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_reference_state(model, state):
    """Copy a reference `state_dict()` -- a dict of numpy arrays named like
    `llama.layers.0.self_attn.q_proj.weight` or
    `bert.encoder.0.attn.q_proj.weight` -- into `model` (a port Llama or
    BERT model with the same names) in place, casting to each parameter's
    dtype and device.

    Every Linear weight is transposed: the reference stores `[in, out]`
    (paddle_tpu/nn/common.py:16), `torch.nn.Linear` stores `[out, in]`.
    Embedding tables, norm weights and biases are copied as they are.
    Raises on a missing or unexpected name or a shape mismatch.  Returns
    the model."""
    linear = {
        f"{name}.weight" for name, mod in model.named_modules()
        if isinstance(mod, nn.Linear)
    }
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"reference state does not match the model: missing {missing}, "
            f"unexpected {unexpected}"
        )
    with torch.no_grad():
        for name, arr in state.items():
            arr = np.asarray(arr)
            if name in linear:
                arr = arr.T
            param = own[name]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: reference shape {arr.shape} (after the Linear "
                    f"transpose) != port shape {tuple(param.shape)}"
                )
            param.copy_(torch.tensor(arr, dtype=torch.float32))
    return model
