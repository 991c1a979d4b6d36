"""`paddle.Model`'s fit / evaluate / predict and the callbacks (counterpart
of `paddle_tpu/hapi/__init__.py`).

`Model.fit` keeps the reference's asynchronous step pipeline, in
PyTorch's terms:

- a step's loss stays on the card; losses collect in a window, and the
  host fetches the window in ONE stacked copy at each `log_freq`
  boundary (steps 0, log_freq, 2 log_freq, ...) and at the epoch's end,
  the points whose callbacks read floats.  `Model.fetches` counts those
  copies;
- ``FLAGS_max_inflight_steps`` (2) bounds how far the host runs ahead:
  past it, the host waits on the CUDA event recorded after the oldest
  step in the ring (a completion wait, no value transfer).  1 is the
  strict per-step loop with the same numerics;
- the loop runs under a `fault.Supervisor`, which checks the same fetched
  values for non-finite losses (``max_bad_steps`` consecutive ones raise
  NonFiniteLossError) and turns SIGTERM into a best-effort save to
  ``save_dir/preempt`` and exit 75;
- ``fit.step`` spans (host time around one step's dispatch) under
  ``fit.window`` spans (one per fetch) are recorded when FLAGS_trace is
  on, `profiler.record_step` once per step (the ``paddle_train_*``
  names of /metrics), and each step runs in the default watchdog's
  ``fit.train_batch`` region.

Batches move to the network's device (its first parameter's).  The
reference also runs each steady-state step in its sanitizer's
``fit.inflight_ring`` region; that region comes with the sanitizer
(ROADMAP Queue 1, slice 6).
"""

from __future__ import annotations

import collections
import logging
import os
import time

import torch

from .. import profiler as _prof
from ..fault import Supervisor
from ..fault import watchdog as _wd
from ..framework import core as _core
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader
from ..obs import trace as _obs

logger = logging.getLogger("paddle_tpu_torch")

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping", "Model"]


class Callback:
    """Hook points into fit() (reference: paddle.callbacks.Callback)."""

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class ProgBarLogger(Callback):
    """Prints the float logs every `log_freq` steps."""

    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and logs and step % self.log_freq == 0:
            items = " ".join(f"{k}: {v:.5f}" for k, v in logs.items()
                             if isinstance(v, float))
            print(f"step {step}: {items}")


class ModelCheckpoint(Callback):
    """Saves the model as `save_dir/<epoch>` every `save_freq` epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class EarlyStopping(Callback):
    """Stops fit() when the evaluated `monitor` stops improving for more
    than `patience` evaluations."""

    def __init__(self, monitor="loss", mode="min", patience=0, min_delta=0,
                 baseline=None, save_best_model=False):
        if save_best_model:
            raise NotImplementedError(
                "EarlyStopping(save_best_model=True) is not implemented; use "
                "callbacks.ModelCheckpoint alongside EarlyStopping")
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.sign = -1 if mode == "min" else 1
        self.baseline = None if baseline is None else self.sign * baseline
        self.best = self.baseline
        self.wait = 0
        self.stop_training = False

    def on_eval_end(self, logs=None):
        if not logs or self.monitor not in logs:
            return
        cur = self.sign * logs[self.monitor]
        if self.best is None or cur > self.best + self.min_delta:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True


class _CallbackList:
    def __init__(self, callbacks, model):
        self.cbs = list(callbacks or [])
        for c in self.cbs:
            c.set_model(model)

    def call(self, hook, *args, **kwargs):
        for c in self.cbs:
            getattr(c, hook)(*args, **kwargs)

    @property
    def stop_training(self):
        return any(getattr(c, "stop_training", False) for c in self.cbs)


def _move(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    return obj


class _StepRing:
    """The in-flight steps: a CUDA event recorded after each step's
    dispatch; past `depth`, the host waits on the oldest one."""

    def __init__(self, depth):
        self.depth = depth
        self.events = collections.deque()

    def push(self, device):
        ev = None
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
        self.events.append(ev)
        if len(self.events) <= self.depth:
            return 0.0
        t0 = time.perf_counter()
        old = self.events.popleft()
        if old is not None:
            old.synchronize()
        return time.perf_counter() - t0

    def clear(self):
        self.events.clear()

    def __len__(self):
        return len(self.events)


class Model:
    """A network with its optimizer, loss and metrics, trained by `fit`."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.fetches = 0  # stacked device-to-host copies of losses

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = (metrics if isinstance(metrics, (list, tuple))
                         else ([metrics] if metrics else []))

    def _device(self):
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _fetch(self, losses):
        """One stacked copy of a window of 0-d losses: float32 numpy."""
        self.fetches += 1
        return torch.stack([l.reshape(()).float() for l in losses]).cpu().numpy()

    def _metrics_update(self, out, label):
        """Feed each metric one batch without reading it: on the device
        where the metric can (`update_on_device`), else its host
        compute/update."""
        for m in self._metrics:
            if m.update_on_device(out, label):
                continue
            r = m.compute(out, label)
            if isinstance(r, (tuple, list)):
                m.update(*r)
            else:
                m.update(r)

    def _collect_metrics(self):
        """Every metric as Python floats (the metrics' only fetch)."""
        vals = {}
        for m in self._metrics:
            acc, names = m.accumulate(), m.name()
            if isinstance(acc, (tuple, list)):
                if not isinstance(names, (tuple, list)):
                    names = [f"{names}_top{k}"
                             for k in getattr(m, "topk", range(1, len(acc) + 1))]
                for n, v in zip(names, acc):
                    vals[n] = float(v)
            else:
                vals[names if not isinstance(names, (tuple, list)) else names[0]] = float(acc)
        return vals

    def _split(self, inputs, labels):
        device = self._device()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        label = labels[0] if isinstance(labels, (list, tuple)) else labels
        return _move(list(inputs), device), _move(label, device)

    def train_batch(self, inputs, labels=None):
        """One optimizer step.  The returned loss stays on the device: read
        it (float(), .item()) only where the value is needed."""
        self.network.train()
        inputs, label = self._split(inputs, labels)
        out = self.network(*inputs)
        loss = self._loss(out, label)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        self._metrics_update(out, label)
        return [loss.detach()]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """Forward and loss, without gradients; the loss stays on the
        device."""
        self.network.eval()
        inputs, label = self._split(inputs, labels)
        out = self.network(*inputs)
        loss = self._loss(out, label)
        self._metrics_update(out, label)
        return [loss]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self.network(*_move(list(inputs), self._device()))

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            max_bad_steps=10):
        """Train (reference: paddle.Model.fit) under a fault.Supervisor; see
        the module docstring for the step pipeline.  `train_data` a
        DataLoader or a Dataset (then batched here).  Returns the epochs'
        mean losses."""
        loader = train_data if isinstance(train_data, DataLoader) else DataLoader(
            train_data, batch_size=batch_size, shuffle=shuffle,
            drop_last=drop_last, num_workers=num_workers)
        cbs = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.append(ProgBarLogger(log_freq, verbose))
        if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbs):
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        cblist = _CallbackList(cbs, self)

        save_fn = None
        if save_dir:
            def save_fn():
                os.makedirs(save_dir, exist_ok=True)
                self.save(os.path.join(save_dir, "preempt"))

        inflight = max(1, int(_core.flag("FLAGS_max_inflight_steps")))
        sync_mode = inflight <= 1
        device = self._device()
        cblist.call("on_train_begin")
        # one trace per fit(): step spans parent on their fetch window
        fit_tid = _obs.new_trace_id()
        history = []
        with Supervisor(save_fn=save_fn, max_bad_steps=max_bad_steps) as sup:
            for epoch in range(epochs):
                cblist.call("on_epoch_begin", epoch)
                for m in self._metrics:
                    m.reset()
                epoch_sum, epoch_n = 0.0, 0
                window = []  # device losses since the last fetch
                ring = _StepRing(inflight)
                win = {"sid": _obs.new_span_id(), "t0": time.perf_counter(), "steps": 0}

                def materialize():
                    """One fetch for the window; the supervisor checks the
                    same values."""
                    nonlocal epoch_sum, epoch_n, window, win
                    n_win = len(window)
                    vals = self._fetch(window)
                    window = []
                    ring.clear()  # everything up to here has finished
                    sup.drain(values=vals)
                    for v in vals:  # float64 adds: window-size invariant
                        epoch_sum += float(v)
                    epoch_n += len(vals)
                    t_now = time.perf_counter()
                    _obs.record("fit.window", fit_tid, t0=win["t0"], t1=t_now,
                                span_id=win["sid"], epoch=epoch,
                                steps=win["steps"], losses=n_win)
                    win = {"sid": _obs.new_span_id(), "t0": t_now, "steps": 0}
                    return vals

                last_end = time.perf_counter()
                batches = iter(loader)
                try:
                    for step, batch in enumerate(batches):
                        cblist.call("on_train_batch_begin", step)
                        x, y = batch[0], batch[1]
                        t0 = time.perf_counter()
                        with sup.guard(), _wd.arm("fit.train_batch",
                                                  context=f"step {step}"):
                            loss_t = self.train_batch(x, y)[0]
                        t1 = time.perf_counter()
                        _obs.record("fit.step", fit_tid, t0=t0, t1=t1,
                                    parent_id=win["sid"], step=step, epoch=epoch)
                        win["steps"] += 1
                        window.append(loss_t)
                        sup.after_step(loss_t)  # checked at the next fetch
                        host_block = 0.0 if sync_mode else ring.push(device)
                        if sync_mode or step % log_freq == 0:
                            tb = time.perf_counter()
                            vals = materialize()  # may raise NonFiniteLossError
                            host_block += time.perf_counter() - tb
                            logs = {"loss": float(vals[-1]), **self._collect_metrics()}
                        else:
                            # a callback that reads this tensor opts into a fetch
                            logs = {"loss": loss_t}
                        cblist.call("on_train_batch_end", step, logs)
                        now = time.perf_counter()
                        _prof.record_step(dispatch_s=t1 - t0, host_blocked_s=host_block,
                                          inflight=len(ring), wall_s=now - last_end)
                        last_end = now
                finally:
                    batches.close()  # stops the loader's workers on any exit
                if window:
                    materialize()  # the epoch's end: mean loss and NaN check
                epoch_logs = {"loss": epoch_sum / max(epoch_n, 1),
                              **self._collect_metrics()}
                history.append(epoch_logs["loss"])
                cblist.call("on_epoch_end", epoch, epoch_logs)
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    cblist.call("on_eval_begin")
                    result = self.evaluate(eval_data, batch_size=batch_size,
                                           verbose=verbose)
                    cblist.call("on_eval_end", result)
                if cblist.stop_training:
                    break
        cblist.call("on_train_end")
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        """The mean loss (and metrics) over `eval_data` without gradients;
        the losses stay on the device and come back in one fetch at the
        end."""
        loader = eval_data if isinstance(eval_data, DataLoader) else DataLoader(
            eval_data, batch_size=batch_size, num_workers=num_workers)
        cblist = _CallbackList(callbacks, self)
        cblist.call("on_eval_begin")
        for m in self._metrics:
            m.reset()
        ring = _StepRing(max(1, int(_core.flag("FLAGS_max_inflight_steps"))))
        device = self._device()
        losses = []
        for batch in loader:
            losses.append(self.eval_batch(batch[0], batch[1])[0])
            ring.push(device)
        mean = float(self._fetch(losses).mean()) if losses else float("nan")
        result = {"loss": mean, **self._collect_metrics()}
        cblist.call("on_eval_end", result)
        if verbose:
            print(f"eval: {result}")
        return result

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else DataLoader(
            test_data, batch_size=batch_size, num_workers=num_workers)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(x))
        return outs

    def parameters(self):
        return self.network.parameters()

    def save(self, path, training=True):
        """`path.pdparams` (the network's state dict) and, with `training`
        and an optimizer, `path.pdopt`, in `framework.io`'s format."""
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Weights from `path.pdparams`; with a prepared optimizer, its state
        from `path.pdopt` when that exists.  `reset_optimizer=True` instead
        starts the optimizer afresh (no moments, step count 0).  Either
        way every master weight is refreshed from the loaded weights first.
        `skip_mismatch`: weights whose name or shape the network lacks, and
        an optimizer state that does not fit, are skipped with a warning
        instead of raising."""
        sd = _load(path + ".pdparams", device=self._device())
        if skip_mismatch:
            own = self.network.state_dict()
            bad = [k for k, v in sd.items()
                   if k not in own or tuple(own[k].shape) != tuple(v.shape)]
            for k in bad:
                logger.warning("Model.load: skipping %r (no such weight or a "
                               "different shape)", k)
                sd.pop(k)
        self.network.load_state_dict(sd, strict=not skip_mismatch)
        opt = self._optimizer
        if opt is None:
            return
        with torch.no_grad():
            masters = {}
            for p, st in opt.state.items():
                if "master_weight" in st:
                    masters[p] = st["master_weight"].copy_(p.float())
        if reset_optimizer:
            opt.state.clear()
            for p, m in masters.items():
                opt.state[p]["master_weight"] = m
            return
        opt_path = path + ".pdopt"
        if os.path.exists(opt_path):
            try:
                opt.load_state_dict(_load(opt_path))
            except (KeyError, ValueError) as e:
                if not skip_mismatch:
                    raise
                logger.warning("Model.load: optimizer state skipped (%s)", e)

    def summary(self, input_size=None, dtype=None):
        total = sum(p.numel() for p in self.network.parameters())
        print(f"Total params: {total}")
        return {"total_params": total}
