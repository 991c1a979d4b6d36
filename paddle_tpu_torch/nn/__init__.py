"""Layers of the port."""

from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import Dropout
from .norm import LayerNorm, RMSNorm
from .transformer import MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "Dropout", "LayerNorm", "MultiHeadAttention",
           "RMSNorm", "TransformerEncoder", "TransformerEncoderLayer", "clip",
           "functional"]
