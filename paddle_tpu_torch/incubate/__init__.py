"""paddle.incubate for the PyTorch/CUDA port (counterpart of
`paddle_tpu/incubate/__init__.py`): the mixture-of-experts layer (`moe`)
and activation recompute (`recompute`).

The fused functional ops and layers (`incubate.nn`, reference :9-175,
:207-306) and `fp8` are ROADMAP.md Queue 1 item 8.
`distributed.models.moe.MoELayer` is the reference's placeholder
(:193-205), which raises as it does.
"""

from . import moe  # noqa: F401
from . import recompute as _recompute_mod  # noqa: F401
from .recompute import recompute  # noqa: F401


class distributed:
    class models:
        class moe:
            class MoELayer(moe.nn.Module):
                """The reference's placeholder: the layer lives in
                `incubate.moe`."""

                def __init__(self, *a, **k):
                    raise NotImplementedError("use paddle_tpu.incubate.moe.MoELayer")


__all__ = ["distributed", "moe", "recompute"]
