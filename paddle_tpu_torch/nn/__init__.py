"""Layers of the port."""

from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import Dropout
from .loss import CrossEntropyLoss, MSELoss
from .norm import LayerNorm, RMSNorm
from .transformer import MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "CrossEntropyLoss",
           "Dropout", "LayerNorm", "MSELoss", "MultiHeadAttention",
           "RMSNorm", "TransformerEncoder", "TransformerEncoderLayer", "clip",
           "functional"]
