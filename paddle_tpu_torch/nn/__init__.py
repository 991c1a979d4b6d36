"""Layers of the port."""

from .norm import RMSNorm

__all__ = ["RMSNorm"]
