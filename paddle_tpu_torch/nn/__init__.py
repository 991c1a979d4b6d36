"""Layers of the port."""

from . import clip, functional
from .clip import ClipGradByGlobalNorm
from .common import Dropout
from .norm import LayerNorm, RMSNorm
from .transformer import MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer

__all__ = ["ClipGradByGlobalNorm", "Dropout", "LayerNorm", "MultiHeadAttention",
           "RMSNorm", "TransformerEncoder", "TransformerEncoderLayer", "clip",
           "functional"]
