"""Serving fleet pieces of the PyTorch/CUDA port (counterpart of
`paddle_tpu/serving/`), cut to the idempotency cache that `serve()` keys
`X-Idempotency-Key` retries on (`journal.IdempotencyCache`)."""
