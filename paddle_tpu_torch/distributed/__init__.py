"""Distributed pieces of the PyTorch/CUDA port (counterpart of
`paddle_tpu/distributed/`): the `sep` mesh axis and ring attention, the
`mp` axis with the tensor-parallel layers and `validate_tp`; each axis's
ranks in one process."""
