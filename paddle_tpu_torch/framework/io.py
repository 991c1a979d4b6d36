"""`paddle.save` / `paddle.load` of the port (counterpart of
`paddle_tpu/framework/io.py`).

The file format is the reference's: a pickled object in which every tensor
is a numpy array, and a bfloat16 tensor (numpy has no such type) is the
dict ``{"__bf16__": <float32 array>}``.  A `.pdparams` or `.pdopt` file
written by either package therefore unpickles in the other.  What the
names and layouts inside mean is the caller's: a reference Linear weight
is ``[in, out]`` and the port's ``[out, in]``, so reference weights go
into a port model through `models.convert.load_reference_state`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_BF16 = "__bf16__"


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16: t.float().numpy()}
        return t.numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_serializable(obj, device):
    if isinstance(obj, dict):
        if set(obj) == {_BF16}:
            return torch.from_numpy(np.asarray(obj[_BF16], np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return {k: _from_serializable(v, device) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, device) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` (a state dict, possibly nested) to `path`, every tensor
    as a host numpy array (bf16 as ``{"__bf16__": float32}``).  Creates the
    parent directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path, device="cpu", **configs):
    """The object `save` wrote (or the reference's `paddle.save`), every
    array as a torch tensor on `device` (the CPU unless given)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _from_serializable(data, torch.device(device))
