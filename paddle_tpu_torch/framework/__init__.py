"""Flags, dtypes and devices."""
