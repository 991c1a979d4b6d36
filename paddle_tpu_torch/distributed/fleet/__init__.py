"""Counterpart of `paddle_tpu/distributed/fleet/`: ring attention and the
tensor-parallel layers."""
