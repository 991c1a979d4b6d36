"""Optimizers of the port (counterpart of `paddle_tpu/optimizer/__init__.py`).

`Optimizer` is a `torch.optim.Optimizer` with the reference's
multi-precision contract: with `multi_precision` (or after
`amp.decorate(level="O2")`) it owns a float32 master copy of every bf16 or
fp16 parameter, updates the master in float32, and writes
`master.to(param.dtype)` back into the parameter.  `torch.optim.AdamW`
keeps no master weights, so the port has its own classes.

`Adam` and `AdamW` follow the reference's update exactly (optimizer
:380-394, :406-424): float32 math, per-parameter `beta1_pow`/`beta2_pow`,
`m_hat / (sqrt(v_hat) + eps)`, and for AdamW the decoupled `+ wd * w`
inside the step, which the learning rate scales.  The update is plain
torch ops: the reference has no Pallas kernel for it.

Parameter names, which `apply_decay_param_fun` receives, come from
`model.named_parameters()` when that is passed as `parameters`; plain
tensors are named `param_<i>` in order.
"""

from __future__ import annotations

import numbers

import torch

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1, {item})")


class Optimizer(torch.optim.Optimizer):
    """Base optimizer: parameter groups, gradient clipping (`grad_clip`, a
    callable over (param, grad) pairs such as `nn.clip.ClipGradByGlobalNorm`),
    master weights, `step()`, `clear_grad()` and torch's `state_dict()`."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass model.parameters())")
        if not isinstance(learning_rate, numbers.Real):
            raise _not_ported("an LRScheduler as learning_rate", "item 12a: LR schedulers")
        if weight_decay is not None and not isinstance(weight_decay, numbers.Real):
            raise _not_ported("a regularizer object as weight_decay",
                              "item 12c: the other optimizers and regularizers")
        params, self._names = [], {}
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else (f"param_{i}", item)
            params.append(p)
            self._names[p] = name
        super().__init__(params, dict(lr=float(learning_rate)))
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
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

    def get_lr(self):
        return self.param_groups[0]["lr"]

    def clear_grad(self, set_to_zero=True):
        """Drop every gradient (the reference sets them to None too)."""
        self.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        pgs = [(p, p.grad) for p in self._all_params() if p.grad is not None]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        lr = self.get_lr()
        for p, g in pgs:
            self._update_param(p, g, lr)

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def _write_back(self, p, new):
        """Store the updated float32 value in the master (if any) and in
        the parameter, rounded to its dtype."""
        master = self.state[p].get("master_weight")
        if master is not None:
            master.copy_(new)
        p.copy_(new)


class Adam(Optimizer):
    """Adam; `weight_decay` adds `wd * w` to the gradient (L2)."""

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, amsgrad=False):
        if lazy_mode:
            raise _not_ported("Adam lazy_mode", "item 12c: the other optimizers")
        if amsgrad:
            raise _not_ported("Adam amsgrad", "item 12c: the other optimizers")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _decay(self, p):
        return self._weight_decay

    def _update_param(self, p, g, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = self._decay(p)
        st = self.state[p]
        w32 = st.get("master_weight", p).float()  # a copy only for bf16 w/o master
        if "moment1" not in st:
            st["moment1"] = torch.zeros_like(w32)
            st["moment2"] = torch.zeros_like(w32)
            st["beta1_pow"] = torch.ones((), dtype=torch.float32, device=p.device)
            st["beta2_pow"] = torch.ones((), dtype=torch.float32, device=p.device)
        m, v = st["moment1"], st["moment2"]
        p1, p2 = st["beta1_pow"], st["beta2_pow"]
        grad = g.float()
        if wd and not self._decoupled_wd:
            grad = grad + wd * w32
        p1.mul_(b1)
        p2.mul_(b2)
        m.mul_(b1).add_((1 - b1) * grad)
        v.mul_(b2).add_((1 - b2) * grad * grad)
        upd = (m / (1 - p1)) / ((v / (1 - p2)).sqrt() + eps)
        if wd and self._decoupled_wd:
            upd = upd + wd * w32
        self._write_back(p, w32 - lr * upd)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01), skipped for the
    parameters whose name `apply_decay_param_fun` rejects."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        if lr_ratio is not None:
            raise _not_ported("AdamW lr_ratio", "item 12c: the other optimizers")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay(self, p):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._names[p]):
            return 0.0
        return self._weight_decay


__all__ = ["Optimizer", "Adam", "AdamW"]
