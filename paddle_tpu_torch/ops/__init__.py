"""Attention ops and the kernel build."""
