"""Layers of the port."""

from . import clip, functional
from .activation import ReLU
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import Dropout
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .loss import CrossEntropyLoss, MSELoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
                   InstanceNorm1D, InstanceNorm2D, LayerNorm, LocalResponseNorm,
                   RMSNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D,
                      MaxPool2D, MaxPool3D)
from .transformer import MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool2D", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "CrossEntropyLoss",
           "Dropout", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "LayerNorm",
           "LocalResponseNorm", "MSELoss", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "RMSNorm", "ReLU", "SpectralNorm", "SyncBatchNorm",
           "TransformerEncoder", "TransformerEncoderLayer", "clip", "functional"]
