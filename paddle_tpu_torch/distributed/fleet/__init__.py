"""Counterpart of `paddle_tpu/distributed/fleet/`: ring attention only."""
