"""The ResNet family (counterpart of `paddle_tpu/vision/models/resnet.py`,
the reference's config 2): `BasicBlock`, `BottleneckBlock`, `ResNet`,
`resnet18/34/50/101/152`, `wide_resnet50_2`, `resnext50_32x4d`.

`data_format` "NCHW" (paddle's default) or "NHWC": every layer takes the
logical channels-last tensor, with OIHW conv weights in both, so one
`state_dict()` fits either layout; the names equal the reference's
(`layer1.0.downsample.1._mean`)."""

from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ._build import init_weights, on_device


def _df_kwargs(data_format):
    """Pass `data_format` only when it is not the default, so a
    `norm_layer` callable without that keyword keeps working."""
    return {} if data_format == "NCHW" else dict(data_format=data_format)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        df = _df_kwargs(data_format)
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                                bias_attr=False, **df)
        self.bn1 = norm_layer(planes, **df)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1, bias_attr=False, **df)
        self.bn2 = norm_layer(planes, **df)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        df = _df_kwargs(data_format)
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False, **df)
        self.bn1 = norm_layer(width, **df)
        self.conv2 = pnn.Conv2D(width, width, 3, stride=stride, padding=dilation,
                                groups=groups, dilation=dilation, bias_attr=False, **df)
        self.bn2 = norm_layer(width, **df)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1, bias_attr=False, **df)
        self.bn3 = norm_layer(planes * self.expansion, **df)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
           152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    """ResNet of `depth` over `block` (reference :84-147): a 7x7 stem,
    four stages, global average pool and a Linear to `num_classes` (0:
    none; `with_pool` False: no pool).  Built on `device` (None: the CUDA
    card) with weights drawn from `seed`."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True,
                 groups=1, data_format="NCHW", device=None, seed=0):
        super().__init__()
        self.data_format = data_format
        layers = _LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        df = _df_kwargs(data_format)
        with on_device(device):
            self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                    bias_attr=False, **df)
            self.bn1 = pnn.BatchNorm2D(self.inplanes, **df)
            self.relu = pnn.ReLU()
            self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1, **df)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = pnn.AdaptiveAvgPool2D((1, 1), **df)
            if num_classes > 0:
                self.fc = nn.Linear(512 * block.expansion, num_classes)
        init_weights(self, seed)

    def _make_layer(self, block, planes, blocks, stride=1):
        df = _df_kwargs(self.data_format)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                           bias_attr=False, **df),
                pnn.BatchNorm2D(planes * block.expansion, **df),
            )
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, **df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return ResNet(BottleneckBlock, 50, **kwargs)
