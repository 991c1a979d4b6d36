"""The port's training fault domain, the counterparts of
`tests/test_fault_tolerance.py` (TestHardenedCheckpoint :130-232,
TestSupervisor :235-320, the diverged fit and the chaos resume cycle
:322-383, the SIGTERM case :385-427, the heartbeat cases :575-640) and of
the deferred-loss cases of `tests/test_async_pipeline.py`, through the
same fault points (`checkpoint.save`, `checkpoint.commit`,
`checkpoint.load`, `supervisor.step`) in the port's registry.  Held
against the reference's behaviour: the same steps committed, skipped and
resumed, the same exit code (75), the same exceptions.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import fault
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.fault import heartbeat as hb
from paddle_tpu_torch.fault import watchdog as wd
from paddle_tpu_torch.framework import core as tcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _neutral():
    state = torch.get_rng_state()
    yield
    torch.set_rng_state(state)
    fault.disarm()
    hb.reset()
    tcore.set_flags({"FLAGS_collective_timeout_sec": 0.0,
                     "FLAGS_max_inflight_steps": 2})


def _state(val=1.0):
    return {"w": torch.full((4,), val), "b": torch.arange(3, dtype=torch.float32)}


def test_training_fault_points_registered():
    pts = fault.fault_points()
    for name in ("dataloader.next", "dataloader.hang", "supervisor.step",
                 "checkpoint.save", "checkpoint.commit", "checkpoint.load"):
        assert name in pts, name


# -------------------------------------------------------------- checkpoints


class TestHardenedCheckpoint:
    def test_atomic_commit_and_roundtrip(self, tmp_path):
        sd = _state(3.0)
        sd["bf"] = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
        sd["nested"] = {"state": {0: {"m": torch.ones(2, 2)}}, "lr": 0.1, "ids": [0, 1]}
        path = ckpt.save_checkpoint(sd, str(tmp_path), step=1)
        assert os.path.basename(path) == "step_1"
        assert os.path.exists(os.path.join(path, ckpt.COMMIT_FILE))
        man = ckpt.read_commit_manifest(path)
        assert man["step"] == 1 and man["format_version"] == ckpt.MANIFEST_VERSION
        assert man["arrays"]["bf"]["dtype"] == "torch.bfloat16"
        assert "nested/state/0/m" in man["arrays"]
        dst = {"w": torch.zeros(4), "b": torch.zeros(3), "nested": {"state": {}}}
        w = dst["w"]
        assert ckpt.load_latest(dst, str(tmp_path)) == 1
        assert dst["w"] is w and torch.equal(w, torch.full((4,), 3.0))
        assert dst["bf"].dtype == torch.bfloat16 and torch.equal(dst["bf"], sd["bf"])
        assert torch.equal(dst["nested"]["state"][0]["m"], torch.ones(2, 2))
        assert dst["nested"]["lr"] == 0.1 and dst["nested"]["ids"] == [0, 1]

    def test_save_failure_retries_then_succeeds(self, tmp_path):
        fault.arm("checkpoint.save:2")
        path = ckpt.save_checkpoint(_state(), str(tmp_path), step=5, retries=3,
                                    backoff=0.01)
        assert fault.hits("checkpoint.save") == 3
        assert ckpt.find_latest_valid(str(tmp_path)) == (5, path)

    def test_save_retries_exhausted_raises(self, tmp_path):
        fault.arm("checkpoint.save:*")
        with pytest.raises(RuntimeError, match="failed after"):
            ckpt.save_checkpoint(_state(), str(tmp_path), step=5, retries=2, backoff=0.01)
        fault.disarm()
        assert ckpt.find_latest_valid(str(tmp_path)) is None
        assert not [d for d in os.listdir(tmp_path) if ckpt._STEP_RE.match(d)]

    def test_torn_checkpoint_skipped_on_resume(self, tmp_path):
        root = str(tmp_path)
        ckpt.save_checkpoint(_state(1.0), root, step=1)
        fault.arm("checkpoint.commit")
        with pytest.raises(fault.InjectedFault):
            ckpt.save_checkpoint(_state(2.0), root, step=2, retries=0)
        fault.disarm()
        assert os.path.isdir(os.path.join(root, "step_2.tmp"))
        assert ckpt.find_latest_valid(root)[0] == 1
        dst = _state(0.0)
        assert ckpt.load_latest(dst, root) == 1
        assert torch.equal(dst["w"], torch.full((4,), 1.0))
        ckpt.save_checkpoint(_state(2.0), root, step=2)  # over its debris
        assert ckpt.find_latest_valid(root)[0] == 2

    def test_corrupt_payload_falls_back_to_older(self, tmp_path):
        root = str(tmp_path)
        ckpt.save_checkpoint(_state(1.0), root, step=1)
        p2 = ckpt.save_checkpoint(_state(2.0), root, step=2)
        payload = os.path.join(p2, ckpt.PAYLOAD_FILE)
        with open(payload, "r+b") as f:
            f.seek(-8, os.SEEK_END)
            f.write(b"\xde\xad\xbe\xef" * 2)
        dst = _state(0.0)
        assert ckpt.load_latest(dst, root) == 1
        assert torch.equal(dst["w"], torch.full((4,), 1.0))
        assert torch.equal(dst["b"], torch.arange(3, dtype=torch.float32))

    def test_retention_keeps_last_n_and_prunes_tmp(self, tmp_path):
        root = str(tmp_path)
        for s in range(1, 5):
            ckpt.save_checkpoint(_state(float(s)), root, step=s, keep_last_n=2)
        assert sorted(s for s, _ in ckpt._committed_steps(root)) == [3, 4]
        os.makedirs(os.path.join(root, "step_1.tmp"), exist_ok=True)
        ckpt.save_checkpoint(_state(5.0), root, step=5, keep_last_n=2)
        assert not os.path.exists(os.path.join(root, "step_1.tmp"))

    def test_load_latest_env_root(self, tmp_path, monkeypatch):
        ckpt.save_checkpoint(_state(7.0), str(tmp_path), step=3)
        monkeypatch.setenv("PADDLE_CKPT_DIR", str(tmp_path))
        dst = _state(0.0)
        assert ckpt.load_latest(dst) == 3
        assert torch.equal(dst["w"], torch.full((4,), 7.0))

    def test_load_latest_empty_root_returns_none(self, tmp_path):
        assert ckpt.load_latest(_state(), str(tmp_path)) is None

    def test_verify_checkpoint_detects_mismatch(self, tmp_path):
        path = ckpt.save_checkpoint(_state(1.0), str(tmp_path), step=1)
        good = _state(0.0)
        ckpt.load_state_dict(good, path)
        ckpt.verify_checkpoint(good, path)
        bad = {"w": torch.full((4,), 9.0), "b": good["b"]}
        with pytest.raises(ckpt.CheckpointCorruption):
            ckpt.verify_checkpoint(bad, path)

    def test_load_fault_point_falls_back(self, tmp_path):
        root = str(tmp_path)
        ckpt.save_checkpoint(_state(1.0), root, step=1)
        ckpt.save_checkpoint(_state(2.0), root, step=2)
        fault.arm("checkpoint.load:1")  # the newest read fails once
        dst = _state(0.0)
        assert ckpt.load_latest(dst, root) == 1
        assert fault.hits("checkpoint.load") == 2

    def test_process_groups_wait_for_item_17(self, tmp_path):
        with pytest.raises(NotImplementedError, match="item 17"):
            ckpt.save_state_dict(_state(), str(tmp_path), process_group=object())
        with pytest.raises(NotImplementedError, match="item 17"):
            ckpt.load_state_dict(_state(), str(tmp_path), process_group=object())


# --------------------------------------------------------------- supervisor


class TestSupervisor:
    def test_nan_watchdog_aborts_with_diagnostic(self):
        with fault.Supervisor(max_bad_steps=3, handle_signals=False) as sup:
            sup.after_step(1.0)
            sup.after_step(float("nan"))
            sup.after_step(float("inf"))
            with pytest.raises(fault.NonFiniteLossError, match="3 consecutive"):
                sup.after_step(float("nan"))

    def test_finite_step_resets_consecutive_count(self):
        with fault.Supervisor(max_bad_steps=2, handle_signals=False) as sup:
            for _ in range(5):
                sup.after_step(float("nan"))
                sup.after_step(0.5)
            assert sup.total_bad_steps == 5 and sup.bad_steps == 0

    def test_deferred_losses_checked_at_the_drain(self):
        sup = fault.Supervisor(max_bad_steps=3, handle_signals=False)
        for _ in range(2):
            sup.after_step(torch.tensor(1.0))
        for _ in range(2):
            assert sup.after_step(torch.tensor(float("nan")))  # not read yet
        assert sup.bad_steps == 0 and len(sup._pending) == 4
        sup.after_step(torch.tensor(float("nan")))
        with pytest.raises(fault.NonFiniteLossError):
            sup.drain()

    def test_pending_ring_bounds_detection_latency(self):
        sup = fault.Supervisor(max_bad_steps=2, handle_signals=False)
        sup.pending_limit = 4
        sup.after_step(torch.tensor(float("nan")))
        sup.after_step(torch.tensor(float("nan")))
        sup.after_step(torch.tensor(1.0))
        with pytest.raises(fault.NonFiniteLossError):
            sup.after_step(torch.tensor(1.0))  # the 4th entry drains the ring

    def test_context_exit_drains(self):
        with pytest.raises(fault.NonFiniteLossError):
            with fault.Supervisor(max_bad_steps=1, handle_signals=False) as sup:
                sup.after_step(torch.tensor(float("inf")))

    def test_drain_takes_the_callers_values(self):
        sup = fault.Supervisor(max_bad_steps=1, handle_signals=False)
        sup.after_step(torch.tensor(1.0))
        sup.after_step(torch.tensor(2.0))
        with pytest.raises(fault.NonFiniteLossError):
            sup.drain(values=np.array([1.0, np.nan], np.float32))

    @pytest.mark.parametrize("deferred", [False, True])
    def test_scaler_skip_steps_count_as_bad(self, deferred):
        """The scaler's found-inf flag (its skip) is a bad step even with a
        finite loss; deferred, the flag stays on the device until the drain."""
        scaler = pt.amp.GradScaler(init_loss_scaling=2.0)
        w = torch.ones(2, requires_grad=True)
        opt = pt.optimizer.SGD(learning_rate=0.1, parameters=[w])
        with fault.Supervisor(max_bad_steps=2, handle_signals=False) as sup:
            sup.attach_scaler(scaler)
            for i in range(2):
                loss = (w * torch.tensor([float("inf"), 1.0])).sum()
                scaler.scale(loss).backward()
                scaler.step(opt)
                scaler.update()
                assert scaler.last_found_inf
                opt.clear_grad()
                reported = torch.tensor(1.0) if deferred else 1.0
                if deferred:
                    sup.after_step(reported)
                elif i < 1:
                    sup.after_step(reported)
                else:
                    with pytest.raises(fault.NonFiniteLossError):
                        sup.after_step(reported)
            if deferred:
                assert torch.equal(w.detach(), torch.ones(2))  # both steps skipped
                with pytest.raises(fault.NonFiniteLossError):
                    sup.drain()
                sup._pending.clear()

    def test_guard_checkpoints_on_crash(self):
        saved = []
        sup = fault.Supervisor(save_fn=lambda: saved.append(sup.step), handle_signals=False)
        with pytest.raises(ZeroDivisionError):
            with sup.guard():
                1 / 0
        assert saved == [0]

    def test_save_fn_failure_never_masks_the_crash(self):
        def bad_save():
            raise OSError("disk full")

        sup = fault.Supervisor(save_fn=bad_save, handle_signals=False)
        with pytest.raises(ZeroDivisionError):
            with sup.guard():
                1 / 0

    def test_request_stop_checkpoints_and_exits_75(self):
        saved = []
        sup = fault.Supervisor(save_fn=lambda: saved.append(True), handle_signals=False)
        sup.after_step(1.0)
        sup.request_stop(signal.SIGTERM)
        with pytest.raises(fault.RestartRequested) as ei:
            sup.after_step(1.0)
        assert ei.value.code == fault.RESTART_EXIT_CODE == 75
        assert saved == [True]

    def test_run_supervised(self):
        with pytest.raises(fault.NonFiniteLossError):
            fault.run_supervised(lambda i: float("nan"), steps=10, max_bad_steps=2)
        assert fault.run_supervised(lambda i: float(i), steps=4, start_step=1) == [1.0, 2.0, 3.0]

    def test_injected_step_fault_triggers_guard_save(self):
        saved = []
        sup = fault.Supervisor(save_fn=lambda: saved.append(True), handle_signals=False)
        fault.arm("supervisor.step")
        with pytest.raises(fault.InjectedFault):
            with sup.guard():
                sup.after_step(1.0)
        assert saved == [True]

    def test_signal_handlers_installed_and_restored(self):
        before = signal.getsignal(signal.SIGTERM)
        with fault.Supervisor(handle_signals=True) as sup:
            assert signal.getsignal(signal.SIGTERM) == sup._on_signal
        assert signal.getsignal(signal.SIGTERM) == before


# ------------------------------------------------------ fit and end to end


def _linear_model(lr):
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 2)
    model = pt.Model(net)
    model.prepare(pt.optimizer.SGD(learning_rate=lr, parameters=net.parameters()),
                  pt.nn.MSELoss())
    return model


class TestTrainingIntegration:
    @pytest.mark.parametrize("log_freq", [1, 2])
    def test_fit_aborts_on_diverged_training(self, log_freq):
        """Raised within max_bad_steps + log_freq steps of the first
        non-finite loss (the window is checked at its fetch)."""
        model = _linear_model(1e30)
        rng = np.random.RandomState(0)
        data = [(rng.rand(4).astype(np.float32) * 1e6, np.zeros((2,), np.float32))
                for _ in range(32)]
        seen = []

        class Steps(pt.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                seen.append(float(logs["loss"]))

        with pytest.raises(fault.NonFiniteLossError, match="diverged"):
            model.fit(data, batch_size=4, epochs=4, verbose=0, max_bad_steps=3,
                      log_freq=log_freq, shuffle=False, callbacks=[Steps()])
        first_bad = next(i for i, v in enumerate(seen) if not np.isfinite(v))
        assert len(seen) - first_bad <= 3 + log_freq

    def test_chaos_resume_cycle(self, tmp_path):
        root = str(tmp_path)
        torch.manual_seed(0)
        net = torch.nn.Linear(4, 2)
        opt = pt.optimizer.Adam(learning_rate=0.1, parameters=net.parameters())
        x = torch.from_numpy(np.random.RandomState(0).rand(8, 4).astype(np.float32))

        def step():
            loss = (net(x) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.item()

        sd = {"net": net.state_dict(), "opt": opt.state_dict()}
        step()
        sd["opt"] = opt.state_dict()
        ckpt.save_checkpoint(sd, root, step=1)
        fault.arm("checkpoint.save:1")  # a storage blip, retried through
        step()
        sd["opt"] = opt.state_dict()
        ckpt.save_checkpoint(sd, root, step=2, backoff=0.01)
        w_step2 = net.weight.detach().clone()
        next_loss = step()
        fault.arm("checkpoint.commit")  # a crash between payload and COMMIT
        with pytest.raises(fault.InjectedFault):
            ckpt.save_checkpoint(sd, root, step=3, retries=0)
        fault.disarm()

        torch.manual_seed(123)  # another init: the resume must overwrite it
        net2 = torch.nn.Linear(4, 2)
        opt2 = pt.optimizer.Adam(learning_rate=0.1, parameters=net2.parameters())
        sd2 = {"net": net2.state_dict(), "opt": opt2.state_dict()}
        assert ckpt.load_latest(sd2, root) == 2
        opt2.load_state_dict(sd2["opt"])
        assert torch.equal(net2.weight.detach(), w_step2)
        loss = (net2(x) ** 2).mean()
        loss.backward()
        opt2.step()
        assert loss.item() == next_loss  # the moments came back exactly

    def test_sigterm_mid_step_graceful_checkpoint_exit75(self, tmp_path):
        root = tmp_path / "ckpt"
        ready = tmp_path / "ready"
        script = tmp_path / "train.py"
        script.write_text(
            "import sys, time\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import torch\n"
            "from paddle_tpu_torch import fault\n"
            "from paddle_tpu_torch.distributed import checkpoint as ckpt\n"
            "assert 'jax' not in sys.modules and 'paddle_tpu' not in sys.modules\n"
            f"root = {str(root)!r}\n"
            "w = torch.ones(4, device='cpu')\n"
            "sup = fault.Supervisor(max_bad_steps=0)\n"
            "sup.save_fn = lambda: ckpt.save_checkpoint({'w': w}, root, sup.step)\n"
            f"open({str(ready)!r}, 'w').write('1')\n"
            "for _ in range(100000):\n"
            "    time.sleep(0.02)\n"
            "    w += 1\n"
            "    sup.after_step(0.5)\n")
        env = {k: v for k, v in os.environ.items() if k != hb.ENV_DIR}
        proc = subprocess.Popen([sys.executable, str(script)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        deadline = time.time() + 120
        while not ready.exists():
            assert time.time() < deadline, "trainer never came up"
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.05)
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        out = proc.stdout.read()
        assert rc == fault.RESTART_EXIT_CODE, (rc, out)
        step, path = ckpt.find_latest_valid(str(root))
        dst = {"w": torch.zeros(4)}
        assert ckpt.load_latest(dst, str(root)) == step
        assert torch.equal(dst["w"], torch.full((4,), 1.0 + step))


# ---------------------------------------------------------------- heartbeat


class TestHeartbeat:
    def test_beat_advances_seq_and_carries_step(self, tmp_path):
        w = hb.HeartbeatWriter(tmp_path, rank=0, interval=0)
        w.beat(step=7)
        got = hb.scan_heartbeats(str(tmp_path))
        assert got[0]["seq"] == 2 and got[0]["step"] == 7
        assert got[0]["status"] == hb.STATUS_RUNNING and got[0]["pid"] == os.getpid()

    def test_atomic_writes_leave_no_partial_files(self, tmp_path):
        w = hb.HeartbeatWriter(tmp_path, rank=1, interval=0)
        for _ in range(20):
            w.beat()
        assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]

    def test_abort_marker_and_peer_check(self, tmp_path):
        w = hb.HeartbeatWriter(tmp_path, rank=1, interval=0)
        w.abort("synthetic crash")
        assert hb.scan_aborts(str(tmp_path))[1]["reason"] == "synthetic crash"
        hb.check_peer_abort(str(tmp_path), self_rank=1)  # its own: no raise
        with pytest.raises(hb.PeerAbort) as ei:
            hb.check_peer_abort(str(tmp_path), self_rank=0)
        assert ei.value.code == fault.RESTART_EXIT_CODE and ei.value.rank == 1

    def test_clear_resets_the_directory(self, tmp_path):
        hb.HeartbeatWriter(tmp_path, rank=0, interval=0).abort("x")
        hb.clear(str(tmp_path))
        assert hb.scan_heartbeats(str(tmp_path)) == {} and hb.scan_aborts(str(tmp_path)) == {}

    def test_maybe_start_env_contract(self, tmp_path, monkeypatch):
        monkeypatch.setenv(hb.ENV_DIR, str(tmp_path))
        monkeypatch.setenv(hb.ENV_RANK, "3")
        monkeypatch.setenv(hb.ENV_INTERVAL, "0")
        w = hb.maybe_start()
        assert w is not None and w.rank == 3 and hb.maybe_start() is w
        assert 3 in hb.scan_heartbeats(str(tmp_path))

    def test_maybe_start_noop_standalone(self, monkeypatch):
        monkeypatch.delenv(hb.ENV_DIR, raising=False)
        assert hb.maybe_start() is None
        assert hb.write_abort("nothing to write to") is False

    def test_supervisor_step_checks_peers(self, tmp_path, monkeypatch):
        monkeypatch.setenv(hb.ENV_DIR, str(tmp_path))
        monkeypatch.setenv(hb.ENV_RANK, "0")
        monkeypatch.setenv(hb.ENV_INTERVAL, "0")
        sup = fault.Supervisor(handle_signals=False)
        sup.after_step(1.0)
        assert hb.scan_heartbeats(str(tmp_path))[0]["step"] == 1
        hb.write_abort("peer crash", rank=1, root=str(tmp_path))
        with pytest.raises(hb.PeerAbort):
            sup.after_step(1.0)

    def test_crash_in_guard_drops_the_abort_marker(self, tmp_path, monkeypatch):
        monkeypatch.setenv(hb.ENV_DIR, str(tmp_path))
        monkeypatch.setenv(hb.ENV_RANK, "2")
        monkeypatch.setenv(hb.ENV_INTERVAL, "0")
        sup = fault.Supervisor(handle_signals=False)
        with pytest.raises(ValueError):
            with sup.guard():
                raise ValueError("boom")
        assert "boom" in hb.scan_aborts(str(tmp_path))[2]["reason"]


# ----------------------------------------------------------------- watchdog


class TestDefaultWatchdog:
    def test_disarmed_is_passthrough(self):
        tcore.set_flags({"FLAGS_collective_timeout_sec": 0.0})
        with wd.arm("test.region"):
            pass
        assert not wd._regions

    def test_raise_and_callable_actions(self):
        fired = []
        w = fault.Watchdog(action=lambda region, t: fired.append(region), timeout=0.1)
        with w.arm("test.slow"):
            time.sleep(0.4)
        assert wd.wait_for_monitor(5) and fired == ["test.slow"]
        with pytest.raises(fault.WatchdogTimeout, match="test.late"):
            with fault.Watchdog(action="raise").arm("test.late", timeout=0.1):
                time.sleep(0.4)

    def test_exit_action_drops_abort_and_exits_75(self, tmp_path):
        script = (
            "import sys, time\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from paddle_tpu_torch.fault import watchdog\n"
            "from paddle_tpu_torch.framework import core\n"
            "core.set_flags({'FLAGS_collective_timeout_sec': 0.2})\n"
            "with watchdog.arm('fit.train_batch', context='step 3'):\n"
            "    time.sleep(30)\n")
        env = dict(os.environ, **{hb.ENV_DIR: str(tmp_path), hb.ENV_RANK: "0"})
        r = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == fault.RESTART_EXIT_CODE, r.stderr
        assert "fit.train_batch" in hb.scan_aborts(str(tmp_path))[0]["reason"]
        assert "region 'fit.train_batch' exceeded" in r.stderr
