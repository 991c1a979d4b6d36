"""Counterpart of `paddle_tpu/distributed/fleet/meta_parallel/`: ring
(context-parallel) and Ulysses attention, and the tensor-parallel layers
(`mp_layers`)."""
