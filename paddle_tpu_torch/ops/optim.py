"""The optimizer's multi-tensor kernels (csrc/optim.cu) and their plain
versions.

- `adam_multi` (`ptt_adam_multi`, replaces the XLA fusion of the
  reference's Adam math, `paddle_tpu/optimizer/__init__.py:376-394`): one
  Adam/AdamW step over every tensor that has a gradient, in one launch
  (and a one-thread-per-tensor launch for the beta powers).
- `unscale_multi` (`ptt_unscale_multi`, replaces the reference's
  `GradScaler.unscale_`, `paddle_tpu/amp/__init__.py:228`): every gradient
  times 1 / scale in place, ORing "not finite" into a device flag.

A wrapper runs the plain version (`adam_multi_plain`, `unscale_multi_plain`)
only when every tensor lies on the CPU; on CUDA tensors it launches the
kernel or raises.  `launch_counts` counts the launches (`adam_fused`,
`unscale_fused`).

Per tensor the kernels take a float32 parameter without a master, a bf16 or
fp16 parameter with a float32 master, or a bf16 / fp16 parameter without
one (computed in float32 and written back rounded); gradients come in the
parameter's dtype.  Every tensor is contiguous and on one CUDA device.

On the card the host packs one entry per tensor (pointers, numel, dtype,
decay) and a chunk table (block i takes chunk `index` of tensor `tensor`,
`CHUNK` elements) and uploads both in one pinned, non-blocking copy
(`MultiTensorTable`).  Every entry is packed again on every call from the
tensors' current `data_ptr`s: `clear_grad` drops the gradients each step,
`amp.decorate` swaps `p.data`, and a swapped master or moment must not
leave the kernel writing through a stale pointer.

The kernel rounds once per operation in the reference's order (no FMA
contraction), so on the card it equals the plain version bit for bit:
`chip_smoke.py` holds parameters, masters, moments and beta powers with
`torch.equal`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .flash_attention import _on_cuda, _stream

launch_counts = {"adam_fused": 0, "unscale_fused": 0}

# elements of one tensor one block takes (a multiple of the kernels' 8-wide
# vector step)
CHUNK = 65536

# one entry of the kernels' tensor table (`TensorEntry` in csrc/optim.cu)
ENTRY_DTYPE = np.dtype([
    ("param", "<u8"), ("master", "<u8"), ("m", "<u8"), ("v", "<u8"),
    ("grad", "<u8"), ("pow1", "<u8"), ("pow2", "<u8"), ("numel", "<i8"),
    ("wd", "<f4"), ("flags", "<i4"),
])
assert ENTRY_DTYPE.itemsize == 72
CHUNK_DTYPE = np.dtype([("tensor", "<i4"), ("index", "<i4")])

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_L1, _DECOUPLED = 4, 8
# how a decay coefficient enters the step: added to the update (AdamW),
# or to the gradient (Adam's L2); "l1" uses sign(w) in place of w
DECAY_MODES = {"l2": 0, "l1": _L1, "decoupled": _DECOUPLED,
               "decoupled_l1": _DECOUPLED | _L1}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _dtype_code(t, what):
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32, "
                        "bfloat16 or float16)") from None


def adam_entries(params, grads, masters, moments1, moments2, beta1_pows,
                 beta2_pows, decays):
    """One table entry per tensor (`ENTRY_DTYPE`), packed from the tensors'
    current pointers, each tensor checked as the kernel takes it: the
    parameter float32, bf16 or fp16 and contiguous; its gradient of the
    same dtype and shape, contiguous; master (or None) and moments float32
    of its size, contiguous; one float32 per beta power."""
    n = len(params)
    if not all(len(x) == n for x in (grads, masters, moments1, moments2,
                                      beta1_pows, beta2_pows, decays)):
        raise ValueError("adam_multi: one grad, master (or None), m, v, powers "
                         "and decay per parameter")
    f32 = torch.float32
    rows = []
    for i, (p, g, w, m, v, p1, p2, (wd, mode)) in enumerate(zip(
            params, grads, masters, moments1, moments2, beta1_pows, beta2_pows,
            decays)):
        code = _dtype_code(p, "adam_multi")
        if g.dtype != p.dtype or g.shape != p.shape or not g.is_contiguous():
            raise ValueError(f"adam_multi: tensor {i}: grad {g.dtype} "
                             f"{tuple(g.shape)} (contiguous {g.is_contiguous()}) "
                             f"does not match param {p.dtype} {tuple(p.shape)}")
        numel = p.numel()
        if (m.dtype != f32 or v.dtype != f32 or m.numel() != numel
                or v.numel() != numel or w is not None
                and (w.dtype != f32 or w.numel() != numel)):
            raise ValueError(f"adam_multi: tensor {i}: master and moments must be "
                             f"float32 of the parameter's size")
        if p1.dtype != f32 or p2.dtype != f32 or p1.numel() != 1 or p2.numel() != 1:
            raise ValueError(f"adam_multi: tensor {i}: beta powers must be one "
                             "float32 each")
        if mode not in DECAY_MODES:
            raise ValueError(f"adam_multi: decay mode {mode!r} not in {sorted(DECAY_MODES)}")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()
                and (w is None or w.is_contiguous())):
            raise ValueError(f"adam_multi: tensor {i} is not contiguous")
        rows.append((p.data_ptr(), 0 if w is None else w.data_ptr(), m.data_ptr(),
                     v.data_ptr(), g.data_ptr(), p1.data_ptr(), p2.data_ptr(),
                     numel, float(wd), code | DECAY_MODES[mode]))
    return np.array(rows, ENTRY_DTYPE)


def adam_multi_plain(params, grads, masters, moments1, moments2, beta1_pows,
                     beta2_pows, decays, lr, beta1, beta2, epsilon, found_inf=None):
    """The reference's Adam/AdamW step (optimizer/__init__.py:376-394) as
    per-parameter torch ops, in place: float32 math from the master (or the
    parameter), `m_hat / (sqrt(v_hat) + eps)`, the decay `coeff * w` (or
    `coeff * sign(w)`) added to the gradient or, decoupled, to the update;
    the new value to the master and, rounded, to the parameter; each beta
    power times its beta.  With `found_inf` set (read on the host), nothing
    changes."""
    if found_inf is not None and bool(found_inf):
        return
    b1, b2, eps = beta1, beta2, epsilon
    for p, g, master, m, v, p1, p2, (wd, mode) in zip(
            params, grads, masters, moments1, moments2, beta1_pows, beta2_pows,
            decays):
        w32 = (master if master is not None else p).float()  # a copy only w/o master
        decoupled = mode.startswith("decoupled")
        dw = torch.sign(w32) if mode.endswith("l1") else w32
        grad = g.float()
        if wd and not decoupled:
            grad = grad + wd * dw
        p1.mul_(b1)
        p2.mul_(b2)
        m.mul_(b1).add_((1 - b1) * grad)
        v.mul_(b2).add_((1 - b2) * grad * grad)
        upd = (m / (1 - p1)) / ((v / (1 - p2)).sqrt() + eps)
        if wd and decoupled:
            upd = upd + wd * dw
        new = w32 - lr * upd
        if master is not None:
            master.copy_(new)
        p.copy_(new)


def unscale_multi_plain(grads, scale, found_inf):
    """Every gradient times 1 / scale (the inverse rounded to the gradient's
    dtype, as the reference multiplies), in place; sets `found_inf` when
    one of the results is not finite."""
    inv = 1.0 / scale
    for g in grads:
        g.mul_(inv.to(g.dtype))
        if not bool(torch.isfinite(g).all()):
            found_inf.fill_(1)


class MultiTensorTable:
    """The device tables of one optimizer's launches: `upload` copies
    entries (`adam_entries`, `grad_entries`) and their chunk table to the
    device in one pinned, non-blocking copy.  The chunk table is rebuilt
    when the tensors' sizes change."""

    def __init__(self):
        self._numels = None
        self._chunks = None
        self._host = []  # two pinned buffers, filled in turn
        self._copied = [None, None]  # the event of each one's last copy
        self._turn = 0
        self._dev = None

    @staticmethod
    def grad_entries(grads):
        """Entries of an unscale: each gradient's pointer, numel and dtype."""
        for i, g in enumerate(grads):
            _dtype_code(g, "unscale_multi")
            if not g.is_contiguous():
                raise ValueError(f"unscale_multi: gradient {i} is not contiguous")
        e = np.zeros(len(grads), ENTRY_DTYPE)
        e["grad"] = [g.data_ptr() for g in grads]
        e["numel"] = [g.numel() for g in grads]
        e["flags"] = [_DTYPE_CODES[g.dtype] for g in grads]
        return e

    def _chunk_table(self, numels):
        if self._numels is None or not np.array_equal(numels, self._numels):
            per = (numels + CHUNK - 1) // CHUNK
            c = np.zeros(int(per.sum()), CHUNK_DTYPE)
            c["tensor"] = np.repeat(np.arange(len(numels), dtype=np.int32), per)
            starts = np.cumsum(per) - per
            c["index"] = np.arange(len(c), dtype=np.int64) - np.repeat(starts, per)
            self._numels, self._chunks = numels.copy(), c
        return self._chunks

    def upload(self, entries, device):
        """Copy `entries` and their chunk table to `device`, through the
        pinned buffer the copy before last used (so the host waits, if at
        all, for that copy, not the last one).  Returns (entries pointer,
        chunks pointer, n tensors, n chunks)."""
        chunks = self._chunk_table(entries["numel"])
        ne, nc = entries.nbytes, chunks.nbytes
        if not self._host or self._host[0].numel() < ne + nc \
                or self._dev.device != device:
            size = max(ne + nc, 2 * (self._host[0].numel() if self._host else 0))
            self._host = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                          for _ in range(2)]
            self._copied = [None, None]
            self._dev = torch.empty(size, dtype=torch.uint8, device=device)
        turn, self._turn = self._turn, 1 - self._turn
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()  # that copy has read this buffer
        buf = self._host[turn]
        host = buf.numpy()
        host[:ne] = entries.view(np.uint8)
        host[ne:ne + nc] = chunks.view(np.uint8)
        # stream-ordered after the last launch that read the device table
        self._dev[:ne + nc].copy_(buf[:ne + nc], non_blocking=True)
        self._copied[turn] = torch.cuda.Event()
        self._copied[turn].record()
        base = self._dev.data_ptr()
        return base, base + ne, len(entries), len(chunks)


def adam_multi(params, grads, masters, moments1, moments2, beta1_pows, beta2_pows,
               decays, lr, beta1, beta2, epsilon, found_inf=None, table=None):
    """One Adam/AdamW step over every tensor, in place (the plain version's
    contract).  params, grads, moments1, moments2, beta1_pows, beta2_pows:
    one per tensor; masters: a float32 master or None per tensor; decays:
    (coefficient, mode) per tensor, mode one of DECAY_MODES; lr: a float32
    device scalar; found_inf: an int32 flag (nothing changes when it is
    set) or None; table: a `MultiTensorTable` to reuse across steps."""
    if not params:
        return
    state = [x for x in masters if x is not None]
    tensors = [*params, *grads, *state, *moments1, *moments2, *beta1_pows,
               *beta2_pows, lr] + ([found_inf] if found_inf is not None else [])
    on_card = _on_cuda(tensors, "adam_multi")
    entries = adam_entries(params, grads, masters, moments1, moments2, beta1_pows,
                           beta2_pows, decays)
    if not on_card:
        adam_multi_plain(params, grads, masters, moments1, moments2, beta1_pows,
                         beta2_pows, decays, lr, beta1, beta2, epsilon, found_inf)
        return
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError("adam_multi: lr must be one float32 on the device")
    if found_inf is not None and (found_inf.dtype != torch.int32 or found_inf.numel() != 1):
        raise ValueError("adam_multi: found_inf must be one int32")
    table = table if table is not None else MultiTensorTable()
    t_ptr, c_ptr, n, nc = table.upload(entries, params[0].device)
    _build.check(_build.lib().ptt_adam_multi(
        t_ptr, c_ptr, n, nc, CHUNK, lr.data_ptr(), float(beta1), float(beta2),
        float(1 - beta1), float(1 - beta2), float(epsilon),
        found_inf.data_ptr() if found_inf is not None else None, _stream(params[0])),
        "adam_multi")
    launch_counts["adam_fused"] += 1


def unscale_multi(grads, scale, found_inf, table=None):
    """Every gradient times 1 / scale, in place, and `found_inf` (one int32)
    set when a result is not finite.  scale: a float32 scalar on the
    gradients' device."""
    if not grads:
        return
    if not _on_cuda([*grads, scale, found_inf], "unscale_multi"):
        for g in grads:
            _dtype_code(g, "unscale_multi")
        unscale_multi_plain(grads, scale, found_inf)
        return
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("unscale_multi: scale must be one float32 on the device")
    if found_inf.dtype != torch.int32 or found_inf.numel() != 1:
        raise ValueError("unscale_multi: found_inf must be one int32")
    table = table if table is not None else MultiTensorTable()
    t_ptr, c_ptr, _, nc = table.upload(MultiTensorTable.grad_entries(grads),
                                       grads[0].device)
    _build.check(_build.lib().ptt_unscale_multi(
        t_ptr, c_ptr, nc, CHUNK, scale.data_ptr(), found_inf.data_ptr(),
        _stream(grads[0])), "unscale_multi")
    launch_counts["unscale_fused"] += 1


__all__ = ["launch_counts", "reset_launch_counts", "adam_multi", "adam_multi_plain",
           "unscale_multi", "unscale_multi_plain", "MultiTensorTable", "CHUNK",
           "DECAY_MODES"]
