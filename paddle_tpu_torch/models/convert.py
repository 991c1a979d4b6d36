"""Load the JAX package's model weights (Llama, GPT with its MoE layers,
BERT, LeNet, ResNet, VGG) and optimizer state into the port's models and
optimizers."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_reference_state(model, state):
    """Copy a reference `state_dict()` -- a dict of numpy arrays named like
    `llama.layers.0.self_attn.q_proj.weight`, `gpt.h.1.mlp.experts.w1`,
    `bert.encoder.0.attn.q_proj.weight` or `layer1.0.downsample.1._mean` --
    into `model` (a port model with the same names) in place, casting to
    each tensor's dtype and device: its parameters and its persistable
    buffers (the batch norms' running `_mean` and `_variance`).

    Every Linear weight is transposed (GPT's fused `qkv_proj`, `out_proj`,
    `fc1` / `fc2`, an MoE gate's `wg`, `lm_head`): the reference stores
    `[in, out]` (paddle_tpu/nn/common.py:16), `torch.nn.Linear` stores
    `[out, in]`.  Conv weights, embedding tables, norm weights, biases,
    the MoE expert stacks (`experts.w1` [E, d, h], `b1`, `w2`, `b2`, the
    same layout in both packages) and buffers are copied as they are.  Raises on a missing or unexpected name, buffers
    included, or a shape mismatch.  Returns the model."""
    linear = {
        f"{name}.weight" for name, mod in model.named_modules()
        if isinstance(mod, nn.Linear)
    }
    own = dict(model.named_parameters())
    for prefix, mod in model.named_modules():
        for name, buf in mod.named_buffers(recurse=False):
            if name not in mod._non_persistent_buffers_set:
                own[f"{prefix}.{name}" if prefix else name] = buf
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


def _as_array(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _load_scheduler(sched, state):
    """A reference scheduler's `state_dict()` into the port's `sched`: plain
    values are copied, a nested scheduler (LinearWarmup's) recursively."""
    for key, value in state.items():
        inner = getattr(sched, key, None)
        if hasattr(inner, "set_state_dict") and hasattr(value, "state_dict"):
            _load_scheduler(inner, value.state_dict())
        else:
            setattr(sched, key, value)


def load_reference_optimizer_state(opt, ref_state, ref_model):
    """Copy a reference optimizer's `state_dict()` into the port optimizer
    `opt` in place, so a run resumed in the port takes the reference's next
    step.  The reference keys its accumulators `<param.name>_<acc>`
    (`moment1`, `beta1_pow`, `velocity`, ...), its masters under
    "master_weights" and its scheduler under "LR_Scheduler"
    (optimizer/__init__.py:216-234); `ref_model.named_parameters()` maps
    each `param.name` to the structured name under which `opt` knows the
    port's parameter (build `opt` from `model.named_parameters()`).  The
    moments and masters of Linear weights are transposed, as
    `load_reference_state` transposes the weights; every state tensor is
    float32 on its parameter's device.  Raises KeyError on an entry that
    matches no parameter."""
    from ..optimizer.lr import LRScheduler

    by_key = {p.name: name for name, p in ref_model.named_parameters()}
    linear = {f"{name}.weight" for name, sub in ref_model.named_sublayers()
              if type(sub).__name__.endswith("Linear")}
    port = {name: p for p, name in opt._names.items()}
    missing = sorted(set(by_key.values()) - set(port))
    if missing:
        raise KeyError(f"the optimizer does not know the parameters {missing[:5]} "
                       "by name: build it from model.named_parameters()")

    def put(name, acc, value):
        arr = _as_array(value).astype(np.float32)
        if name in linear and arr.ndim == 2:
            arr = arr.T
        p = port[name]
        opt.state[p][acc] = torch.tensor(np.ascontiguousarray(arr), device=p.device)

    unmatched = []
    for pkey, value in ref_state.get("master_weights", {}).items():
        if pkey in by_key:
            put(by_key[pkey], "master_weight", value)
        else:
            unmatched.append(f"master_weights/{pkey}")
    for key, value in ref_state.items():
        if key in ("_step_count", "LR_Scheduler", "master_weights"):
            continue
        # '<param name>_<acc>': the longest param-name prefix, as the reference
        pos, pkey = len(key), None
        while (pos := key.rfind("_", 0, pos)) > 0:
            if key[:pos] in by_key:
                pkey = key[:pos]
                break
        if pkey is None:
            unmatched.append(key)
            continue
        put(by_key[pkey], key[len(pkey) + 1:], value)
    if unmatched:
        raise KeyError(f"reference optimizer state entries match no parameter: "
                       f"{unmatched[:10]}")
    sched = ref_state.get("LR_Scheduler")
    if sched is not None and isinstance(opt._learning_rate, LRScheduler):
        _load_scheduler(opt._learning_rate, sched)
    opt._lr_synced = None  # the device learning rate refreshes at the next step
    return opt
