"""Ring attention's forms against the JAX package's, form for form, on the CPU.

The reference's `ring_attention_array` runs inside `shard_map` over the
conftest's 8 CPU devices on a mesh of `sep=2`, with `_FORCE_INTERPRET` so
its kernel forms run their Pallas kernels in interpret mode (both are
restored at teardown); the port's runs its two ranks in one process on the
CPU, where the kernels take their plain versions.  Each form is picked by
the shape, as the reference picks it:

- S = 512 causal: the zig-zag layout (c = 128), gathered (K/V under the
  budget), and rotating (`_GATHERED_KV_MAX_BYTES = 0`);
- S = 512 not causal: the Pallas-hop ring (one K1/K3 per hop);
- the plain ring and Ulysses: `test_torch_ring_plain.py`, which shares
  this file's helpers.

Output, loss = sum(out^2), and dq/dk/dv through `jax.value_and_grad` and
torch autograd.  Tolerances: outputs within 1e-4, gradients within 1e-3
(float32; the ring merges its hops in another order than the reference's
interpret-mode blocks, and the gradient of sum(out^2) doubles the output's
error).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.distributed.fleet.meta_parallel import ring_attention as ra
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as tra
from paddle_tpu_torch.ops import flash_attention as pfa

OUT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture
def sep2():
    """Both packages on a sep axis of 2; the reference interprets its
    Pallas kernels.  Everything is restored at teardown."""
    saved = (fa._FORCE_INTERPRET, pmesh.get_mesh(), tmesh.get_mesh(),
             ra._GATHERED_KV_MAX_BYTES, tra._GATHERED_KV_MAX_BYTES)
    fa._FORCE_INTERPRET = True
    pmesh.build_mesh(sep=2)
    tmesh.build_mesh(sep=2, device="cpu")
    tra.reset_form_counts()
    pfa.reset_launch_counts()
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved[0]
        pmesh.set_mesh(saved[1])
        tmesh.set_mesh(saved[2])
        ra._GATHERED_KV_MAX_BYTES, tra._GATHERED_KV_MAX_BYTES = saved[3:]


@contextlib.contextmanager
def _budget(n):
    """Both packages' gathered-KV budget set to `n` bytes."""
    saved = ra._GATHERED_KV_MAX_BYTES, tra._GATHERED_KV_MAX_BYTES
    ra._GATHERED_KV_MAX_BYTES = tra._GATHERED_KV_MAX_BYTES = n
    try:
        yield
    finally:
        ra._GATHERED_KV_MAX_BYTES, tra._GATHERED_KV_MAX_BYTES = saved


def _inputs(S, seed, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, h, d)).astype(np.float32) for _ in range(3)]


def _reference(fn, q, k, v):
    def loss(q, k, v):
        out = fn(q, k, v)
        return (out.astype(jnp.float32) ** 2).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(fn, q, k, v):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(ref, got):
    np.testing.assert_allclose(got[0], ref[0], **OUT_TOL)
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(g, r, **GRAD_TOL)


@pytest.mark.parametrize("form, S, causal, budget", [
    ("gathered", 512, True, None),
    ("rotating", 512, True, 0),
    ("hops", 512, False, None),
])
def test_ring_form_matches_reference(sep2, form, S, causal, budget):
    q, k, v = _inputs(S, seed=S + int(causal))
    ctx = _budget(budget) if budget is not None else contextlib.nullcontext()
    with ctx:
        ref = _reference(lambda *x: ra.ring_attention_array(*x, "sep", causal), q, k, v)
        got = _port(lambda *x: tra.ring_attention_array(*x, "sep", causal), q, k, v)
    _check(ref, got)
    assert tra.form_counts == dict(dict.fromkeys(tra.FORMS, 0), **{form: 1})
