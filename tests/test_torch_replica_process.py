"""The port's managed replica workers (`serving.replica.ReplicaProcess`
over `distributed.launch.main.Container`), on the CPU.

- One real worker (`--device cpu`): the router's probes see it go from
  down to ready, it answers one request through the router with the
  tokens of an in-process engine on the same seed's weights, its output
  lands in `workerlog.<rank>` with the launcher's env contract, and
  `terminate()` reaps it.
- `Container` fires `launch.spawn` before a spawn and `kill9` reaps the
  process it kills.
- The kill -9 drill (slow, as the reference's): two workers under load,
  one SIGKILLed through `router.replica.kill`; every request resolves
  once, every 200 with the in-process tokens, and a rolling restart
  respawns the dead worker through the Container.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed.launch.main import Container
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import Replica, ReplicaProcess, Router
from torch_fleet_fakes import reset_counters

WORKER = ("--device", "cpu")
SEED = 1234  # the worker's default --seed


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module")
def local():
    """An in-process engine over the worker's weights (the same seed)."""
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu", seed=SEED)
    eng = ContinuousBatchingEngine(model, device="cpu", slots=2, max_len=64,
                                   prefill_buckets=[8, 16], queue_depth=32, seed=0)
    return lambda p, n: eng.generate(p, max_new_tokens=n).tolist()


def _wait_ready(router, reps, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        router.probe_once()
        if all(r.state == "ready" for r in reps):
            return True
        time.sleep(0.2)
    return False


def test_a_worker_becomes_ready_answers_and_is_reaped(tmp_path, local):
    proc = ReplicaProcess(0, _free_port(), log_dir=str(tmp_path), extra_args=WORKER)
    rep = Replica("w0", proc.url, process=proc)
    router = Router([rep], probe_interval=3600, retry_backoff=0.05)
    router.probe_once()
    assert rep.state == "down"  # nothing listens before the spawn
    try:
        proc.start()
        assert proc.alive()
        assert _wait_ready(router, [rep]), (tmp_path / "workerlog.1").read_text()
        p = _prompt(7, seed=3)
        status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                  "max_new_tokens": 5})
        assert status == 200 and body["tokens"] == local(p, 5)
        assert rep.snapshot()["role"] == "colocated"
    finally:
        proc.terminate()
        router.stop()
    assert not proc.alive() and proc.container.proc.returncode is not None
    assert proc.container.log_file is None  # the log was closed
    assert (tmp_path / "workerlog.1").exists()


def test_the_container_fires_launch_spawn_and_reaps_what_it_kills(tmp_path):
    script = tmp_path / "sleeper.py"
    script.write_text("import os, time\n"
                      "print(os.environ['PADDLE_TRAINER_ID'], "
                      "os.environ['PADDLE_TRAINERS_NUM'], flush=True)\n"
                      "time.sleep(60)\n")
    c = Container(rank=2, world_size=3, endpoints=[], script=str(script),
                  script_args=[], log_dir=str(tmp_path / "logs"))
    tinj.arm("launch.spawn:1")
    with pytest.raises(tinj.InjectedFault):
        c.start()
    assert c.proc is None
    c.start()
    try:
        deadline = time.monotonic() + 30
        log = tmp_path / "logs" / "workerlog.2"
        while time.monotonic() < deadline and "2 3" not in log.read_text():
            time.sleep(0.05)
        assert log.read_text().split() == ["2", "3"]
        c.kill9()
        assert c.poll() == -9  # killed and reaped: no zombie stays
    finally:
        c.terminate()


@pytest.mark.slow
def test_kill9_drill_resolves_every_request_once(tmp_path, local):
    procs = [ReplicaProcess(i, _free_port(), log_dir=str(tmp_path), extra_args=WORKER)
             for i in range(2)]
    reps = [Replica(f"r{i}", p.url, process=p) for i, p in enumerate(procs)]
    router = Router(reps, probe_interval=0.1, retry_backoff=0.02)
    try:
        for p in procs:
            p.start()
        assert _wait_ready(router, reps), "workers never became ready"
        router.start()
        results, mu = [], threading.Lock()
        rng = np.random.RandomState(7)

        def load():
            for i in range(12):
                time.sleep(float(rng.exponential(0.05)))
                p = _prompt(6, seed=1000 + i)
                status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                          "max_new_tokens": 4})
                with mu:
                    results.append((p, status, body))

        threads = [threading.Thread(target=load, daemon=True) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        tinj.arm("router.replica.kill:1")
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 24  # one resolution per request
        ok = 0
        for p, status, body in results:
            if status == 200:
                ok += 1
                assert body["tokens"] == local(p, 4)
            else:
                assert body.get("type"), body  # failed typed, never silent
        assert ok >= len(results) - 4
        assert sum(not p.alive() for p in procs) == 1
        router.stop()
        report = router.rolling_restart(grace=10.0, ready_timeout=120.0)
        assert all(r["ready"] for r in report), report
        assert all(p.alive() for p in procs)
    finally:
        router.stop()
        for p in procs:
            p.terminate()
    assert not any(p.alive() for p in procs)
    assert all(os.path.exists(tmp_path / f"workerlog.{i + 1}") for i in range(2))
