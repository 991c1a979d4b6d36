"""Layers of the port."""

from . import clip
from .clip import ClipGradByGlobalNorm
from .norm import RMSNorm

__all__ = ["ClipGradByGlobalNorm", "RMSNorm", "clip"]
