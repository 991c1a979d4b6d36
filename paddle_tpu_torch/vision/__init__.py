"""The vision package of the port (counterpart of `paddle_tpu/vision/`):
`models` (LeNet, ResNet, VGG), `transforms` and `datasets`.  The
reference's `vision/ops.py` (nms, roi_align, ...) is ROADMAP.md Queue 1,
position 8."""

from . import datasets, models, transforms
from .models import LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152


def set_image_backend(backend):
    pass


def get_image_backend():
    return "numpy"


__all__ = ["LeNet", "ResNet", "datasets", "get_image_backend", "models", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "set_image_backend",
           "transforms"]
