"""Whole training steps under the port's `jit.to_static` against the
reference's compiled steps, on the CPU.

- A tiny Llama (`model(ids, labels=ids)` -> backward -> AdamW, as
  `bench_llama` writes it) and a tiny BERT QA head over a padded batch
  (`bench_bert`'s step, the padding mask riding as segment ids) take five
  steps under each package's `to_static` from the same weights and
  batches.  Tolerances, as `tests/test_torch_train.py` and
  `tests/test_torch_bert.py` set them for the eager steps: each loss within
  1e-5 relative, every parameter after five steps within 1e-4 (two layers
  of matmuls summed in another order, carried through five updates).
  BERT's parameters whose gradient is 0 in exact arithmetic (the key
  biases, which the softmax cancels, and the biases just below the span
  classifier; `tests/test_torch_bert.py` says why) get round-off for a
  gradient, which Adam turns into steps of about lr of random sign: they
  are held within 2 lr a step of the reference's.  The port's captured
  steps equal its eager steps exactly, one trace for all.
- `tests/test_bucketing.py`'s retrace contract on the port's
  `BucketSampler` and `padded_collate`: a step over the bucketed loader
  traces at most once per bucket, in both packages.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator,
    torch's layers from torch's; restore both so later modules see the
    streams as if this one never ran."""
    state, torch_state = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(state)
    torch.set_rng_state(torch_state)


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _port_weights(model):
    out = {}
    linear = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    for name, p in model.named_parameters():
        w = p.detach().numpy()
        out[name] = w.T if name.rsplit(".", 1)[0] in linear and name.endswith(
            "weight") else w
    return out


def _run(jstep, tstep, eager, batches):
    """Five steps of each: (reference losses, captured losses, eager losses)."""
    jl, tl, el = [], [], []
    for b in batches:
        jl.append(float(jstep(*[paddle.to_tensor(x) for x in b]).numpy()))
        tl.append(tstep(*[torch.from_numpy(x) for x in b]).item())
        el.append(eager(*[torch.from_numpy(x) for x in b]).item())
    return np.array(jl), np.array(tl), np.array(el)


def _check(jm, tm, em, jl, tl, el, tstep, noise=(), lr=1e-3):
    assert tstep.trace_count == 1
    np.testing.assert_array_equal(tl, el)
    for a, b in zip(tm.parameters(), em.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    want, got = _state(jm), _port_weights(tm)
    for name, w in got.items():
        tol = 2 * lr * STEPS if name in noise else 1e-4
        np.testing.assert_allclose(w, want[name], atol=tol, rtol=1e-4, err_msg=name)


def _steps(model, opt, call):
    def step(*batch):
        loss = call(model, *batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def test_tiny_llama_to_static_matches_reference():
    paddle.seed(21)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    ref = _state(jm)
    tms = []
    for _ in range(2):
        tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
        load_reference_state(tm, ref)
        tms.append(tm.train())
    jm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topts = [optimizer.AdamW(learning_rate=1e-3, parameters=m.named_parameters())
             for m in tms]
    llama = lambda m, ids: m(ids, labels=ids)[0]  # noqa: E731
    jstep = paddle.jit.to_static(_steps(jm, jopt, llama))
    tstep = jit.to_static(_steps(tms[0], topts[0], llama))
    eager = _steps(tms[1], topts[1], llama)
    rng = np.random.default_rng(8)
    batches = [(rng.integers(1, 250, size=(2, 16)).astype(np.int32),)
               for _ in range(STEPS)]
    _check(jm, tms[0], tms[1], *_run(jstep, tstep, eager, batches), tstep)


def test_tiny_bert_padded_to_static_matches_reference():
    no_dropout = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(5)
    jm = jbert.BertForQuestionAnswering(jbert.BertConfig.tiny(**no_dropout))
    ref = _state(jm)
    tms = []
    for _ in range(2):
        tm = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny(**no_dropout),
                                            device="cpu")
        load_reference_state(tm, ref)
        tms.append(tm.train())
    jm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topts = [optimizer.AdamW(learning_rate=1e-3, parameters=m.named_parameters())
             for m in tms]

    def qa(m, ids, mask, starts, ends):
        return m(ids, attention_mask=mask, start_positions=starts,
                 end_positions=ends)[0]

    jstep = paddle.jit.to_static(_steps(jm, jopt, qa))
    tstep = jit.to_static(_steps(tms[0], topts[0], qa))
    eager = _steps(tms[1], topts[1], qa)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(STEPS):  # bench_bert's batch: padded lengths, spans inside
        lens = rng.integers(8, 17, size=2)
        mask = (np.arange(16)[None, :] < lens[:, None]).astype(np.int64)
        batches.append((rng.integers(0, 256, (2, 16)).astype(np.int32), mask,
                        rng.integers(0, 8, 2).astype(np.int64),
                        rng.integers(0, 8, 2).astype(np.int64)))
    noise = {f"bert.encoder.{i}.attn.k_proj.bias" for i in range(2)}
    noise |= {"bert.encoder.1.norm2.bias", "classifier.bias"}
    _check(jm, tms[0], tms[1], *_run(jstep, tstep, eager, batches), tstep, noise)


LENGTHS = [5, 9, 13, 17, 21, 25, 29, 31, 8, 16, 24, 32, 7, 15, 23, 31, 3, 11]
BOUNDS = (8, 16, 32)


def _ragged_rows(seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (n,)).astype(np.int32), np.int64(i % 3))
            for i, n in enumerate(LENGTHS)]


def test_ragged_training_traces_at_most_once_per_bucket():
    """The retrace contract: a step over the bucketed loader traces at most
    len(BOUNDS) times; both packages see the same batches in the same
    order, and their losses agree within 1e-5."""
    rows = _ragged_rows()

    class JDS(jio.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]

    class TDS(tio.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]

    jbs = jio.BucketSampler(JDS(), bucket_boundaries=BOUNDS, batch_size=4)
    tbs = tio.BucketSampler(TDS(), bucket_boundaries=BOUNDS, batch_size=4)
    jdl = jio.DataLoader(JDS(), batch_sampler=jbs, collate_fn=jio.padded_collate(BOUNDS))
    tdl = tio.DataLoader(TDS(), batch_sampler=tbs, collate_fn=tio.padded_collate(BOUNDS),
                         device="cpu")

    paddle.seed(0)
    jemb, jhead = jnn.Embedding(50, 16), jnn.Linear(16, 3)
    temb, thead = torch.nn.Embedding(50, 16), torch.nn.Linear(16, 3)
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(np.array(jemb.weight.numpy())))
        thead.weight.copy_(torch.from_numpy(np.array(jhead.weight.numpy()).T))
        thead.bias.copy_(torch.from_numpy(np.array(jhead.bias.numpy())))
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jopt = paddle.optimizer.SGD(
        learning_rate=0.01, parameters=list(jemb.parameters()) + list(jhead.parameters()))
    topt = optimizer.SGD(
        learning_rate=0.01, parameters=list(temb.parameters()) + list(thead.parameters()))

    @paddle.jit.to_static
    def jstep(toks, label, lens):
        x = jemb(toks)
        mask = (paddle.arange(0, toks.shape[1]).unsqueeze(0)
                < lens.unsqueeze(1)).astype("float32")
        pooled = (x * mask.unsqueeze(-1)).sum(axis=1) / mask.sum(axis=1, keepdim=True)
        loss = jce(jhead(pooled), label)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    @jit.to_static
    def tstep(toks, label, lens):
        x = temb(toks.long())
        mask = (torch.arange(toks.shape[1])[None, :] < lens[:, None]).float()
        pooled = (x * mask[..., None]).sum(1) / mask.sum(1, keepdim=True)
        loss = tce(thead(pooled), label)
        loss.backward()
        topt.step()
        topt.clear_grad()
        return loss

    jl, tl = [], []
    for epoch in range(2):
        jbs.set_epoch(epoch)
        tbs.set_epoch(epoch)
        for jb, tb in zip(jdl, tdl):
            assert tuple(tb[0].shape) == tuple(jb[0].shape)
            jl.append(float(jstep(*jb).numpy()))
            tl.append(tstep(*tb).item())
    assert len(tl) == 2 * sum(1 for _ in tbs)
    assert tstep.trace_count <= len(BOUNDS)
    assert tstep.trace_count == jstep.trace_count
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all()


def test_bert_dropout_and_stepped_schedule_replay_eager_bit_for_bit():
    """BERT's dropout draws from its model's generator, found in the trace
    and threaded through every call; a StepDecay rate stepped between calls
    is read by each one.  From the reference's weights, three captured
    steps equal three eager steps of a twin on the same seed exactly (the
    reference draws other masks from its own keys, so it sets up the
    weights only)."""
    from paddle_tpu_torch.optimizer import lr as tlr

    paddle.seed(7)
    ref = _state(jbert.BertForQuestionAnswering(jbert.BertConfig.tiny()))
    runs = []
    for static in (False, True):
        tm = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny(), device="cpu",
                                            seed=3)
        load_reference_state(tm, ref)
        tm.train()
        sched = tlr.StepDecay(1e-3, step_size=1, gamma=0.5)
        opt = optimizer.AdamW(learning_rate=sched, parameters=tm.named_parameters())
        step = _steps(tm, opt, lambda m, ids, mask: m(
            ids, attention_mask=mask, start_positions=torch.tensor([1, 2]),
            end_positions=torch.tensor([3, 4]))[0])
        fn = jit.to_static(step) if static else step
        rng = np.random.default_rng(2)
        losses = []
        for _ in range(3):
            ids = torch.from_numpy(rng.integers(0, 256, (2, 16)).astype(np.int32))
            mask = torch.ones(2, 16, dtype=torch.int64)
            mask[1, 11:] = 0
            losses.append(fn(ids, mask))
            sched.step()
        runs.append((torch.stack(losses), tm, fn))
    (el, em, _), (tl, tm, tfn) = runs
    assert torch.equal(el, tl) and tfn.trace_count == 1
    assert len(set(tl.tolist())) == 3
    for a, b in zip(em.parameters(), tm.parameters()):
        assert torch.equal(a, b)
