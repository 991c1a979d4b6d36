"""The vision models of the port (counterpart of
`paddle_tpu/vision/models/`): LeNet, the ResNet family and VGG."""

from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
                     resnet101, resnet152, resnext50_32x4d, wide_resnet50_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["BasicBlock", "BottleneckBlock", "LeNet", "ResNet", "VGG", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "vgg11", "vgg13", "vgg16", "vgg19", "wide_resnet50_2"]
