"""The serving fleet of the PyTorch/CUDA port (counterpart of
`paddle_tpu/serving/`): a front-door `Router` over N `serve()` replicas
(health-checked failover, deadline propagation, breakers, brownout,
hedging, rolling restarts, disaggregated prefill/decode pairs, session
pins, adapter-aware picks), the durable `Journal` and `RouterStandby`
behind its crash-proof front door, the `IdempotencyCache` that `serve()`
also keys `X-Idempotency-Key` retries on, `ReplicaProcess` workers, the
`Autoscaler` and the soak `Workload`.  See router.py for the routing
contract and replica.py for the replica handle and worker.

The pieces load lazily: importing `paddle_tpu_torch.serving` does not pull
the model stack.
"""

from __future__ import annotations

__all__ = [
    "Router",
    "RouterError",
    "RouterCrashed",
    "RouterStandby",
    "NoReadyReplica",
    "RouterOverloaded",
    "NoDecodeCapacity",
    "DeadlineExhausted",
    "serve_router",
    "Journal",
    "JournalCorruption",
    "IdempotencyCache",
    "Replica",
    "ReplicaProcess",
    "ReplicaTransportError",
    "Autoscaler",
    "Workload",
    "SoakReport",
    "run_soak",
]


def __getattr__(name):
    if name in (
        "Router", "RouterError", "RouterCrashed", "RouterStandby",
        "NoReadyReplica", "RouterOverloaded", "NoDecodeCapacity",
        "DeadlineExhausted", "serve_router",
    ):
        from . import router as _router

        return getattr(_router, name)
    if name in ("Journal", "JournalCorruption", "IdempotencyCache"):
        from . import journal as _journal

        return getattr(_journal, name)
    if name in ("Replica", "ReplicaProcess", "ReplicaTransportError"):
        from . import replica as _replica

        return getattr(_replica, name)
    if name == "Autoscaler":
        from . import autoscaler as _autoscaler

        return _autoscaler.Autoscaler
    if name in ("Workload", "SoakReport", "run_soak"):
        from . import workload as _workload

        return getattr(_workload, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
