"""Distributed pieces of the PyTorch/CUDA port (counterpart of
`paddle_tpu/distributed/`): the `sep` mesh axis and ring attention, with
the axis's ranks in one process on one device."""
