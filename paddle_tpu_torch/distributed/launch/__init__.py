"""The launch controller's process model (counterpart of
`paddle_tpu/distributed/launch/`), cut to `main.Container`: one spawned
worker process with the launcher's env contract and `workerlog.N`
capture, the part the serving fleet's `ReplicaProcess` runs on.  The
controller and the `python -m ... launch` CLI are not ported yet (ROADMAP
Queue 1, item 17)."""
