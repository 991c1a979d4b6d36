"""Optimizers of the port (counterpart of `paddle_tpu/optimizer/__init__.py`).

`Optimizer` is a `torch.optim.Optimizer` with the reference's contract:

- `learning_rate` a float or an `lr.LRScheduler`; the rate the update
  reads is a float32 device scalar, refreshed only when its value changes
  (the reference's `_sync_lr`), so a constant rate costs no copy a step;
  `get_lr()`, `set_lr()` (RuntimeError under a scheduler), and the
  scheduler's state under "LR_Scheduler" in `state_dict()`;
- `parameters` tensors, `(name, tensor)` pairs (`model.named_parameters()`:
  the names `apply_decay_param_fun` receives; plain tensors are named
  `param_<i>`), or parameter-group dicts, whose keys other than "params"
  are ignored as the reference ignores them;
- `weight_decay` a float or a `regularizer.L1Decay` / `L2Decay`;
- `grad_clip` a callable over (param, grad) pairs (`nn.clip`);
- multi-precision: with `multi_precision` (or after `amp.decorate(level=
  "O2")`) a float32 master copy of every bf16 or fp16 parameter, updated
  in float32 and written back rounded; `step()`, `minimize()`,
  `clear_grad()` / `clear_gradients()`, torch's `state_dict()`.

`Adam` and `AdamW` update every parameter that has a gradient in one
launch of the hand-written `adam_fused` kernel on the card
(`ops.optim.adam_multi`), in the reference's exact math
(optimizer/__init__.py:376-394) with per-parameter beta powers; on the CPU
its plain version.  Given `found_inf` (`amp.GradScaler`), the kernel skips
the step on the device.  `SGD`, `Momentum`, `Adagrad`, `RMSProp`, `Adamax`
and `Lamb` are the reference's formulas (:312-562) as per-parameter torch
ops; under a `found_inf` they read the flag on the host and skip, as the
reference's eager `GradScaler.step` does.
"""

from __future__ import annotations

import numbers

import torch

from ..ops import optim as _optim
from ..regularizer import L1Decay, L2Decay
from . import lr
from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _never_applied(what, lines):
    return NotImplementedError(
        f"{what} is not accepted: the reference optimizer takes it but never "
        f"applies it (paddle_tpu/optimizer/__init__.py:{lines}, where "
        "_update_param ignores it), so accepting it would silently do "
        "something other than what was asked")


class Optimizer(torch.optim.Optimizer):
    """Base optimizer: parameter groups, learning rate (a float or an
    LRScheduler), weight decay, gradient clipping, master weights."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters())")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an LRScheduler, "
                            f"got {type(learning_rate).__name__}")
        if weight_decay is not None and not isinstance(
                weight_decay, (numbers.Real, L1Decay, L2Decay)):
            raise TypeError(f"weight_decay must be a float, L1Decay or L2Decay, "
                            f"got {type(weight_decay).__name__}")
        groups, self._names = [], {}
        items = list(parameters)
        for g in items if items and isinstance(items[0], dict) else [{"params": items}]:
            params = []
            for item in g["params"]:
                name, p = (item if isinstance(item, tuple)
                           else (f"param_{len(self._names)}", item))
                params.append(p)
                self._names[p] = name
            groups.append({"params": params})
        self._learning_rate = learning_rate
        value = self._lr_value()
        super().__init__(groups, dict(lr=value))
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        first = next(self._all_params())
        self._lr_t = torch.full((), value, dtype=torch.float32, device=first.device)
        self._lr_synced = value
        if multi_precision:
            self._create_master_weights()

    def _all_params(self):
        for group in self.param_groups:
            yield from group["params"]

    def _create_master_weights(self):
        """A float32 master copy of every low-precision parameter that has
        none yet (reference: decorate, amp/__init__.py:72-82)."""
        for p in self._all_params():
            st = self.state[p]
            if p.dtype in _LOW_PRECISION and "master_weight" not in st:
                st["master_weight"] = p.detach().float().clone()

    # -- learning rate ------------------------------------------------------
    def _lr_value(self):
        rate = self._learning_rate
        return float(rate() if isinstance(rate, LRScheduler) else rate)

    def get_lr(self):
        return self._lr_value()

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr cannot be used with an LRScheduler")
        self._learning_rate = float(value)

    def _sync_lr(self):
        """Refresh the device scalar the update reads, only on a change."""
        value = self._lr_value()
        if value != self._lr_synced:
            self._lr_t.fill_(value)
            self._lr_synced = value
            for group in self.param_groups:
                group["lr"] = value

    # -- decay --------------------------------------------------------------
    def _wd_terms(self):
        """(coefficient, is L1) of a float-or-regularizer weight_decay."""
        wd = self._weight_decay
        if not wd:
            return 0.0, False
        return float(wd), isinstance(wd, L1Decay)

    def _regularized(self, w, g):
        """The gradient with the regularizer's term (reference
        `_apply_wd_l2`): g + coeff * w, or g + coeff * sign(w) under L1Decay."""
        coeff, l1 = self._wd_terms()
        if not coeff:
            return g
        return g + coeff * (torch.sign(w) if l1 else w)

    # -- step -----------------------------------------------------------------
    def _params_grads(self):
        return [(p, p.grad) for p in self._all_params()
                if p.requires_grad and p.grad is not None]

    def clear_grad(self, set_to_zero=True):
        """Drop every gradient (the reference sets them to None too)."""
        self.zero_grad(set_to_none=True)

    clear_gradients = clear_grad

    @torch.no_grad()
    def step(self, found_inf=None):
        """Clip, then update every parameter that has a gradient.
        `found_inf` (an int32 device flag, from `amp.GradScaler`): when it
        is set, nothing changes."""
        pgs = self._params_grads()
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        self._sync_lr()
        self._apply(pgs, found_inf)

    def _apply(self, pgs, found_inf):
        if found_inf is not None and bool(found_inf):
            return  # the reference's eager skip: a host read of the flag
        for p, g in pgs:
            self._update_param(p, g, self._lr_t)

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def _acc(self, name, p, init=0.0, shape=None):
        """The float32 accumulator `name` of p (p's shape, or `shape`: () for
        a beta power), made at its initial value on first use (reference
        `_acc`)."""
        st = self.state[p]
        if name not in st:
            st[name] = torch.full(p.shape if shape is None else shape, float(init),
                                  dtype=torch.float32, device=p.device)
        return st[name]

    def _source(self, p):
        """The value the update starts from: the master, else the parameter."""
        master = self.state[p].get("master_weight")
        return master if master is not None else p

    def _write_back(self, p, new):
        """Store the updated value in the master (if any) and in the
        parameter, rounded to its dtype."""
        master = self.state[p].get("master_weight")
        if master is not None:
            master.copy_(new)
        p.copy_(new)

    # -- state --------------------------------------------------------------
    def state_dict(self):
        sd = super().state_dict()
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def load_state_dict(self, state_dict):
        """torch's load, then every saved state tensor back in its own dtype
        (torch casts floating state to the parameter's, which would round a
        bf16 parameter's float32 master and moments), and the scheduler's
        state."""
        sd = dict(state_dict)
        sched = sd.pop("LR_Scheduler", None)
        super().load_state_dict(sd)
        params = list(self._all_params())
        for i, st in sd["state"].items():
            p = params[i]
            for k, v in st.items():
                if torch.is_tensor(v):
                    self.state[p][k] = v.detach().to(p.device, copy=True)
        if sched is not None and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(sched)
        self._lr_synced = None  # refresh the device scalar at the next step


class SGD(Optimizer):
    """w - lr * (g + decay), in the dtype of the master or the parameter
    (reference :312)."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update_param(self, p, g, lr):
        w = self._source(p)
        grad = self._regularized(w, g.to(w.dtype))
        self._write_back(p, w - lr.to(w.dtype) * grad)


class Momentum(Optimizer):
    """v = mu v + g; w - lr v, or with Nesterov w - lr (g + mu v)
    (reference :330)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update_param(self, p, g, lr):
        mu = self._momentum
        vel = self._acc("velocity", p)
        w32 = self._source(p).float()
        grad = self._regularized(w32, g.float())
        v_new = mu * vel + grad
        upd = grad + mu * v_new if self._nesterov else v_new
        vel.copy_(v_new)
        self._write_back(p, w32 - lr * upd)


class Adam(Optimizer):
    """Adam; `weight_decay` adds `wd * w` (or `wd * sign(w)` under L1Decay)
    to the gradient.  Every step is one `adam_fused` launch on the card."""

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, amsgrad=False):
        if amsgrad:
            raise _never_applied("Adam amsgrad=True", "360-365")
        # lazy_mode updates only the rows a sparse gradient touches; every
        # gradient here is dense, so it changes nothing, in either package
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._table = _optim.MultiTensorTable()

    def _decay(self, p):
        """(coefficient, `ops.optim.DECAY_MODES` key) of p's decay."""
        coeff, l1 = self._wd_terms()
        mode = "decoupled" if self._decoupled_wd else "l2"
        if l1:
            mode = "decoupled_l1" if self._decoupled_wd else "l1"
        return coeff, mode

    def _apply(self, pgs, found_inf):
        if not pgs:
            return
        params = [p for p, _ in pgs]
        states = [self.state[p] for p in params]
        for p, st in zip(params, states):
            if "moment1" not in st:
                self._acc("moment1", p)
                self._acc("moment2", p)
                self._acc("beta1_pow", p, 1.0, ())
                self._acc("beta2_pow", p, 1.0, ())
        _optim.adam_multi(
            params, [g for _, g in pgs], [st.get("master_weight") for st in states],
            [st["moment1"] for st in states], [st["moment2"] for st in states],
            [st["beta1_pow"] for st in states], [st["beta2_pow"] for st in states],
            [self._decay(p) for p in params], self._lr_t, self._beta1, self._beta2,
            self._epsilon, found_inf=found_inf, table=self._table)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01), skipped for the
    parameters whose name `apply_decay_param_fun` rejects."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        if lr_ratio is not None:
            raise _never_applied("AdamW lr_ratio", "411-412")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, p):
        coeff, mode = super()._decay(p)
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names[p]):
            return 0.0, mode
        return coeff, mode


class Adagrad(Optimizer):
    """a += g^2; w - lr g / (sqrt(a) + eps) (reference :420).  The
    accumulator starts at `initial_accumulator_value`."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr):
        acc = self._acc("moment", p, self._init_acc)
        w32 = self._source(p).float()
        grad = self._regularized(w32, g.float())
        a_new = acc + grad * grad
        acc.copy_(a_new)
        self._write_back(p, w32 - lr * grad / (a_new.sqrt() + self._epsilon))


class RMSProp(Optimizer):
    """ms = rho ms + (1 - rho) g^2 (centered: minus the mean gradient
    squared); mom = mu mom + lr g / sqrt(. + eps); w - mom (reference :449)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_param(self, p, g, lr):
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        ms, mg, mom = (self._acc(n, p) for n in ("mean_square", "mean_grad", "momentum"))
        w32 = self._source(p).float()
        grad = self._regularized(w32, g.float())
        ms_new = rho * ms + (1 - rho) * grad * grad
        if self._centered:
            mg_new = rho * mg + (1 - rho) * grad
            denom = (ms_new - mg_new * mg_new + eps).sqrt()
            mg.copy_(mg_new)
        else:
            denom = (ms_new + eps).sqrt()
        mom_new = mu * mom + lr * grad / denom
        ms.copy_(ms_new)
        mom.copy_(mom_new)
        self._write_back(p, w32 - mom_new)


class Adamax(Optimizer):
    """Adam with the infinity norm: u = max(b2 u, |g|); w - lr / (1 - b1^t)
    m / (u + eps) (reference :491)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        mom, inf_norm = self._acc("moment", p), self._acc("inf_norm", p)
        p1 = self._acc("beta1_pow", p, 1.0, ())
        w32 = self._source(p).float()
        grad = self._regularized(w32, g.float())
        p1.mul_(b1)
        mom.copy_(b1 * mom + (1 - b1) * grad)
        inf_norm.copy_(torch.maximum(b2 * inf_norm, grad.abs()))
        self._write_back(p, w32 - lr / (1 - p1) * mom / (inf_norm + eps))


class Lamb(Optimizer):
    """Adam's direction plus the decay, scaled by the trust ratio
    ||w|| / ||r|| (reference :520); `exclude_from_weight_decay_fn(param)`
    True drops a parameter's decay.  Per-tensor norms: plain torch ops."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd, l1 = self._wd_terms()
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        m, v = self._acc("moment1", p), self._acc("moment2", p)
        p1, p2 = (self._acc(n, p, 1.0, ()) for n in ("beta1_pow", "beta2_pow"))
        w32 = self._source(p).float()
        grad = g.float()
        p1.mul_(b1)
        p2.mul_(b2)
        m.copy_(b1 * m + (1 - b1) * grad)
        v.copy_(b2 * v + (1 - b2) * grad * grad)
        r = (m / (1 - p1)) / ((v / (1 - p2)).sqrt() + eps) \
            + wd * (torch.sign(w32) if l1 else w32)
        w_norm = (w32 * w32).sum().sqrt()
        r_norm = (r * r).sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        self._write_back(p, w32 - lr * trust * r)


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adamax", "Lamb", "lr"]
