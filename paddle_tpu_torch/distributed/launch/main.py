"""`Container`, one launched worker process (counterpart of `Container` in
`paddle_tpu/distributed/launch/main.py:142-233`).

A container execs `python -u <script> <args>` through `subprocess.Popen`
(never a fork of this process: a forked child would inherit the parent's
torch and CUDA threads) with the launcher's env contract
(`PADDLE_TRAINER_ID`, `PADDLE_TRAINERS_NUM`, `PADDLE_TRAINER_ENDPOINTS`,
`PADDLE_CURRENT_ENDPOINT`, `PADDLE_LOCAL_RANK`, `PADDLE_RANK_IN_NODE`).
A rank above 0 writes its output to `<log_dir>/workerlog.<rank>`; rank 0
keeps the parent's console.  The `launch.spawn` fault point fires before
every spawn.
"""

from __future__ import annotations

import os
import subprocess
import sys

from ...fault import injection as _inj


class Container:
    """One worker process: start, poll, SIGTERM, SIGKILL, restart."""

    def __init__(self, rank, world_size, endpoints, script, script_args, log_dir):
        self.rank = rank
        self.world_size = world_size
        self.endpoints = endpoints
        self.script = script
        self.script_args = script_args
        self.log_dir = log_dir
        self.proc = None
        self.log_file = None

    def start(self):
        # chaos point: a worker that dies at spawn (a bad image, an OOM)
        _inj.inject("launch.spawn", context=f"rank {self.rank}")
        env = dict(os.environ)
        env.update(
            PADDLE_TRAINER_ID=str(self.rank),
            PADDLE_TRAINERS_NUM=str(self.world_size),
            PADDLE_TRAINER_ENDPOINTS=",".join(self.endpoints),
            PADDLE_CURRENT_ENDPOINT=(self.endpoints[self.rank]
                                     if self.rank < len(self.endpoints) else ""),
            PADDLE_LOCAL_RANK=str(self.rank),
            PADDLE_RANK_IN_NODE=str(self.rank),
        )
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_file = open(os.path.join(self.log_dir, f"workerlog.{self.rank}"), "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", self.script] + list(self.script_args),
            env=env,
            stdout=self.log_file if self.rank != 0 else None,
            stderr=subprocess.STDOUT if self.rank != 0 else None,
        )
        return self.proc

    def poll(self):
        return self.proc.poll() if self.proc else None

    def signal_stop(self):
        """SIGTERM (the worker drains); the caller escalates to SIGKILL."""
        if self.proc and self.proc.poll() is None:
            try:
                self.proc.terminate()
            except OSError:
                pass

    def close_log(self):
        if self.log_file:
            self.log_file.close()
            self.log_file = None

    def terminate(self):
        """SIGTERM, up to 10 s for the worker to exit, then SIGKILL; the
        process is reaped either way."""
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        self.close_log()

    def kill9(self):
        """SIGKILL with no grace: the process vanishes mid-request, as an
        OOM kill or a lost node does.  It is reaped, so no zombie stays."""
        if self.proc and self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                pass

    def restart(self, grace=10.0):
        """SIGTERM, up to `grace` seconds for a clean drain, SIGKILL, then a
        respawn with the same env contract and a fresh log.  Returns the new
        Popen; the caller gates readmission on /healthz."""
        self.signal_stop()
        if self.proc is not None:
            try:
                self.proc.wait(grace)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        self.close_log()
        return self.start()
