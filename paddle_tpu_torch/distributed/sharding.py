"""Layout checks of the PyTorch/CUDA port (counterpart of
`paddle_tpu/distributed/sharding.py`): the typed `ShardingError` and
`validate_tp`, the construction-time check of tensor-parallel serving.

The rest of the reference's module is group-sharded (ZeRO) training over
the 'sharding' mesh axis; its functions raise NotImplementedError naming
ROADMAP Queue 1 item 17 (`distributed/`).
"""

from __future__ import annotations


class ShardingError(ValueError):
    """A requested parallel layout cannot be realized on this model or mesh.
    Raised at construction (engine or mesh build) with the offending axis
    and degrees in the message, never deep inside the first step."""


def visible_devices():
    """The CUDA devices this process sees, each once (none without CUDA):
    what a mesh built without an explicit device list spans."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def validate_tp(config, tp, devices=None):
    """Check that `config` can run tensor-parallel at degree `tp`
    (reference: sharding.py:45-77): every sharded head axis must divide
    evenly (a ragged head split would change the attention math), and the
    'mp' axis needs one device per rank.  Divisibility is checked first, so
    a bad model/tp pair fails the same way on a laptop and on a card.
    `devices` is the list of the ranks' devices; None counts the visible
    CUDA devices, so tp=4 on a one-card machine raises unless the caller
    names that card for several ranks."""
    tp = int(tp)
    if tp < 1:
        raise ShardingError(f"tensor-parallel degree must be >= 1, got {tp}")
    if tp == 1:
        return
    heads = int(config.num_attention_heads)
    kv_heads = int(config.num_key_value_heads)
    if heads % tp != 0:
        raise ShardingError(
            f"num_attention_heads ({heads}) is not divisible by the "
            f"tensor-parallel degree ({tp}): the q_proj output axis cannot "
            "split evenly over the 'mp' mesh axis"
        )
    if kv_heads % tp != 0:
        raise ShardingError(
            f"num_key_value_heads ({kv_heads}) is not divisible by the "
            f"tensor-parallel degree ({tp}): the KV arena kv_heads axis "
            "cannot split evenly over the 'mp' mesh axis"
        )
    n = len(list(devices) if devices is not None else visible_devices())
    if n < tp:
        raise ShardingError(
            f"tensor-parallel degree {tp} needs {tp} devices on the 'mp' "
            f"mesh axis but only {n} are present (name one device per rank, "
            "e.g. devices=['cuda:0'] * tp to stack the ranks on one card)"
        )


def _zero(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (group-sharded ZeRO training) is not ported to "
            "paddle_tpu_torch yet (ROADMAP Queue 1: item 17, distributed/)"
        )

    refuse.__name__ = name
    refuse.__doc__ = (f"The reference's `{name}` (sharding.py); raises "
                      "NotImplementedError naming ROADMAP Queue 1 item 17.")
    return refuse


shard_optimizer_state = _zero("shard_optimizer_state")
group_sharded_parallel = _zero("group_sharded_parallel")
save_group_sharded_model = _zero("save_group_sharded_model")
