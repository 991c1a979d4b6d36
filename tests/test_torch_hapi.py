"""The port's `Model` (`hapi`), callbacks, `metric` and `save` / `load`
against the reference's on the CPU, with weights carried across by
`models.convert.load_reference_state`.

Tolerances, with their reasons:
- the MLP of `tests/test_hapi_fleet.py` in float32 (Adam, cross-entropy):
  per-epoch mean losses within 1e-5 relative, accuracy equal.  Measured:
  within 3e-8 (float32 matmuls summed in another order);
- a 2-layer tiny Llama in float32 through `fit` (AdamW, `sequence_ce`
  over shifted labels, shuffle=False): each step's loss within 1e-5
  relative, as `tests/test_torch_train.py` holds the same model's steps;
- metrics on the same numpy inputs: equal (host math on both sides; the
  device Accuracy sums 0/1 hits exactly in float32).
"""

import math
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models import _utils as jutils
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models._utils import sequence_ce
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import trace as ttrace


@pytest.fixture(autouse=True)
def _neutral():
    jstate, tstate = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(jstate)
    torch.set_rng_state(tstate)
    for set_flags in (paddle.set_flags, tcore.set_flags):
        set_flags({"FLAGS_max_inflight_steps": 2, "FLAGS_trace": False})
    pt.fault.disarm()


class _Data:
    """`tests/test_hapi_fleet.py`'s data: 8 features, 4 classes."""

    def __init__(self, n=32, seed=0):
        r = np.random.RandomState(seed)
        self.x = r.rand(n, 8).astype(np.float32)
        self.y = r.randint(0, 4, (n,)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _mlp_pair(lr=1e-2, opt="Adam", metrics=True):
    """The reference's MLP and the port's, on the reference's weights."""
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))
    load_reference_state(tnet, state)
    jm, tm = paddle.Model(jnet), pt.Model(tnet)
    jm.prepare(getattr(paddle.optimizer, opt)(learning_rate=lr, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), paddle.metric.Accuracy() if metrics else None)
    tm.prepare(getattr(pt.optimizer, opt)(learning_rate=lr, parameters=tnet.parameters()),
               pt.nn.CrossEntropyLoss(), pt.metric.Accuracy() if metrics else None)
    return jm, tm


def _spy(base):
    events = []

    class Spy(base):
        def on_train_begin(self, logs=None):
            events.append(("train_begin",))

        def on_epoch_begin(self, epoch, logs=None):
            events.append(("epoch_begin", epoch))

        def on_train_batch_end(self, step, logs=None):
            events.append(("batch_end", step, {k: float(v) for k, v in logs.items()}))

        def on_epoch_end(self, epoch, logs=None):
            events.append(("epoch_end", epoch, dict(logs)))

        def on_eval_end(self, logs=None):
            events.append(("eval_end", dict(logs)))

        def on_train_end(self, logs=None):
            events.append(("train_end",))

    return Spy(), events


def _same_events(got, want):
    assert [e[:2] for e in got] == [e[:2] for e in want]
    for g, w in zip(got, want):
        if len(g) == 3 or g[0] == "eval_end":
            gd, wd = g[-1], w[-1]
            assert set(gd) == set(wd)
            for k in gd:
                np.testing.assert_allclose(gd[k], wd[k], rtol=1e-5, err_msg=str(g[:2]))


# -------------------------------------------------------------------- fit


def test_fit_matches_reference_on_the_mlp(tmp_path):
    jm, tm = _mlp_pair()
    jspy, jev = _spy(paddle.callbacks.Callback)
    tspy, tev = _spy(pt.callbacks.Callback)
    kw = dict(batch_size=8, epochs=2, verbose=0, shuffle=False, log_freq=2)
    jh = jm.fit(_Data(), eval_data=_Data(16, seed=1), callbacks=[jspy], **kw)
    th = tm.fit(_Data(), eval_data=_Data(16, seed=1),
                callbacks=[tspy, pt.callbacks.ModelCheckpoint(save_dir=str(tmp_path))], **kw)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _same_events(tev, jev)
    assert "acc" in tev[-2][1] and len(th) == 2
    for epoch in (0, 1):  # ModelCheckpoint: weights and optimizer per epoch
        assert (tmp_path / f"{epoch}.pdparams").exists()
        assert (tmp_path / f"{epoch}.pdopt").exists()


def test_early_stopping_stops_as_the_reference():
    hist = []
    for pkg, (model, _) in ((paddle, _mlp_pair(lr=0.0, opt="SGD", metrics=False)),
                            (pt, _mlp_pair(lr=0.0, opt="SGD", metrics=False)[::-1])):
        es = pkg.callbacks.EarlyStopping(monitor="loss", patience=0)
        hist.append(model.fit(_Data(), eval_data=_Data(), batch_size=8, epochs=5,
                              verbose=0, callbacks=[es], shuffle=False))
        assert es.stop_training
    assert len(hist[0]) == len(hist[1]) <= 3
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-5)


@pytest.mark.parametrize("log_freq", [1, 4])
def test_inflight_one_and_two_give_identical_training(log_freq):
    def run(depth):
        tcore.set_flags({"FLAGS_max_inflight_steps": depth})
        _, tm = _mlp_pair()
        hist = tm.fit(_Data(32), batch_size=4, epochs=2, verbose=0, shuffle=False,
                      log_freq=log_freq)
        return hist, [p.detach().clone() for p in tm.parameters()]

    (h1, w1), (h2, w2) = run(1), run(2)
    assert h1 == h2
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))


@pytest.mark.parametrize("depth,log_freq,want", [(2, 4, (2 + 1) * 2), (2, 100, 2 * 2),
                                                 (1, 4, 8 * 2)])
def test_host_fetches_per_window_not_per_step(depth, log_freq, want):
    """8 steps an epoch, 2 epochs: a fetch at steps 0, log_freq, ... and at
    the epoch's end; with depth 1, one per step.  Accuracy is read at the
    same points and adds no fetch of its own between them."""
    tcore.set_flags({"FLAGS_max_inflight_steps": depth})
    _, tm = _mlp_pair()
    tm.fit(_Data(64), batch_size=8, epochs=2, verbose=0, shuffle=False, log_freq=log_freq)
    assert tm.fetches == want


def test_fit_spans_and_train_metrics():
    tcore.set_flags({"FLAGS_trace": True})
    tprof.reset()
    ttrace.reset()
    _, tm = _mlp_pair()
    tm.fit(_Data(32), batch_size=4, epochs=1, verbose=0, shuffle=False, log_freq=4)
    spans = ttrace.spans()
    steps = [s for s in spans if s["name"] == "fit.step"]
    windows = {s["span_id"]: s for s in spans if s["name"] == "fit.window"}
    assert len(steps) == 8 and len(windows) == 3  # steps 0 | 1-4 | 5-7
    assert {s["parent_id"] for s in steps} == set(windows)
    assert sorted(w["attrs"]["steps"] for w in windows.values()) == [1, 3, 4]
    assert len({s["trace_id"] for s in spans}) == 1
    text = tmetrics.render()
    values = {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
              if line.startswith("paddle_train_")}
    assert values["paddle_train_steps_total"] == 8
    assert 0 < values["paddle_train_inflight_max"] <= 2
    assert values["paddle_train_wall_seconds_total"] > 0
    assert values["paddle_train_dispatch_seconds_total"] > 0


def test_train_batch_keeps_the_loss_on_the_device_and_eval_has_no_graph():
    _, tm = _mlp_pair(metrics=False)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 8).astype(np.float32))
    y = torch.arange(4) % 4
    loss = tm.train_batch(x, y)[0]
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0 and not loss.requires_grad
    ev = tm.eval_batch(x, y)[0]
    assert not ev.requires_grad and math.isfinite(ev.item())
    out = tm.predict(_Data(8), batch_size=4)
    assert len(out) == 2 and out[0].shape == (4, 4)


def test_evaluate_and_predict_match_reference():
    jm, tm = _mlp_pair()
    jr = jm.evaluate(_Data(20), batch_size=8, verbose=0)
    tr = tm.evaluate(_Data(20), batch_size=8, verbose=0)
    assert set(tr) == set(jr)
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5)
    jp = jm.predict(_Data(8), batch_size=4)
    tp = tm.predict(_Data(8), batch_size=4)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_fit_with_a_dataloader_and_workers():
    _, tm = _mlp_pair()
    loader = pt.io.DataLoader(_Data(32), batch_size=8, num_workers=2)
    hist = tm.fit(loader, epochs=2, verbose=0)
    _, ref = _mlp_pair()
    want = ref.fit(_Data(32), batch_size=8, epochs=2, verbose=0, shuffle=False)
    assert hist == want


# ------------------------------------------------------------- save / load


def _weights(model):
    return {k: v.detach().clone() for k, v in model.network.state_dict().items()}


def test_save_load_round_trip_continues_identically(tmp_path):
    _, a = _mlp_pair()
    a.fit(_Data(), batch_size=8, epochs=1, verbose=0, shuffle=False)
    a.save(str(tmp_path / "ck"))
    _, b = _mlp_pair()
    b.load(str(tmp_path / "ck"))
    assert all(torch.equal(x, y) for x, y in zip(_weights(a).values(), _weights(b).values()))
    ha = a.fit(_Data(seed=3), batch_size=8, epochs=1, verbose=0, shuffle=False)
    hb = b.fit(_Data(seed=3), batch_size=8, epochs=1, verbose=0, shuffle=False)
    assert ha == hb  # the moments came back too


def test_load_reset_optimizer_starts_the_optimizer_afresh(tmp_path):
    _, a = _mlp_pair()
    a.fit(_Data(), batch_size=8, epochs=1, verbose=0, shuffle=False)
    a.save(str(tmp_path / "ck"))
    _, b = _mlp_pair()
    b.fit(_Data(seed=5), batch_size=8, epochs=1, verbose=0, shuffle=False)
    assert b._optimizer.state
    b.load(str(tmp_path / "ck"), reset_optimizer=True)
    assert not b._optimizer.state
    _, c = _mlp_pair()  # loaded weights, a fresh optimizer
    c.load(str(tmp_path / "ck"), reset_optimizer=True)
    hb = b.fit(_Data(seed=3), batch_size=8, epochs=1, verbose=0, shuffle=False)
    hc = c.fit(_Data(seed=3), batch_size=8, epochs=1, verbose=0, shuffle=False)
    assert hb == hc


def test_load_skip_mismatch_skips_what_does_not_fit(tmp_path):
    _, a = _mlp_pair()
    pt.save({"0.weight": torch.zeros(3, 3), "2.bias": torch.ones(4)},
            str(tmp_path / "odd.pdparams"))
    with pytest.raises(Exception):
        a.load(str(tmp_path / "odd"))
    before = _weights(a)
    a.load(str(tmp_path / "odd"), skip_mismatch=True)
    after = _weights(a)
    assert torch.equal(after["0.weight"], before["0.weight"])
    assert torch.equal(after["2.bias"], torch.ones(4))


def test_pdparams_cross_between_the_packages(tmp_path):
    jm, tm = _mlp_pair()
    linear = {"0.weight", "2.weight"}
    # reference -> port
    jm.save(str(tmp_path / "ref"))
    loaded = pt.load(str(tmp_path / "ref.pdparams"))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in loaded.values())
    _, fresh = _mlp_pair(lr=0.5)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    load_reference_state(fresh.network, {k: v.numpy() for k, v in loaded.items()})
    x = torch.from_numpy(_Data(4).x)
    np.testing.assert_allclose(fresh.network(x).detach().numpy(),
                               jm.network(paddle.to_tensor(_Data(4).x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    # port -> reference
    tm.save(str(tmp_path / "port"))
    back = paddle.load(str(tmp_path / "port.pdparams"))
    for k, v in tm.network.state_dict().items():
        got = back[k].numpy()  # the port's layout: Linear weights [out, in]
        np.testing.assert_array_equal(got, v.numpy())
        assert (got.T if k in linear else got).shape == \
            tuple(jm.network.state_dict()[k].shape)
    # bf16 crosses as {"__bf16__": float32} both ways
    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    pt.save({"w": torch.from_numpy(vals).bfloat16()}, str(tmp_path / "b.pdparams"))
    with open(tmp_path / "b.pdparams", "rb") as f:
        assert set(pickle.load(f)["w"]) == {"__bf16__"}
    jb = paddle.load(str(tmp_path / "b.pdparams"))["w"]
    assert str(jb.dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jb.numpy(), np.float32), vals)
    paddle.save({"w": jb}, str(tmp_path / "b2.pdparams"))
    tb = pt.load(str(tmp_path / "b2.pdparams"))["w"]
    assert tb.dtype == torch.bfloat16 and torch.equal(tb.float(), torch.from_numpy(vals))


# -------------------------------------------------------------------- metric


@pytest.mark.parametrize("device_path", [True, False])
def test_accuracy_matches_reference(device_path):
    rng = np.random.RandomState(0)
    jm, tm = paddle.metric.Accuracy(topk=(1, 3)), pt.metric.Accuracy(topk=(1, 3))
    for _ in range(3):
        pred = rng.rand(10, 6).astype(np.float32)
        label = rng.randint(0, 6, (10, 1)).astype(np.int64)
        jm.update(jm.compute(paddle.to_tensor(pred), paddle.to_tensor(label)))
        if device_path:
            assert tm.update_on_device(torch.from_numpy(pred), torch.from_numpy(label))
            assert tm.total == [0.0, 0.0]  # nothing read back yet
        else:
            tm.update(tm.compute(torch.from_numpy(pred), torch.from_numpy(label)))
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name() == "acc"


def test_precision_recall_auc_and_accuracy_match_reference():
    rng = np.random.RandomState(1)
    preds = rng.rand(64).astype(np.float32)
    labels = (rng.rand(64) > 0.4).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        j, t = getattr(paddle.metric, cls)(), getattr(pt.metric, cls)()
        for lo in (0, 32):
            j.update(paddle.to_tensor(preds[lo:lo + 32]), paddle.to_tensor(labels[lo:lo + 32]))
            t.update(torch.from_numpy(preds[lo:lo + 32]), torch.from_numpy(labels[lo:lo + 32]))
        assert t.accumulate() == pytest.approx(j.accumulate(), rel=1e-12), cls
        t.reset()
        assert t.accumulate() == 0.0
    scores = rng.rand(16, 5).astype(np.float32)
    lab = rng.randint(0, 5, (16, 1)).astype(np.int64)
    for k in (1, 2):
        got = pt.metric.accuracy(torch.from_numpy(scores), torch.from_numpy(lab), k=k)
        want = paddle.metric.accuracy(paddle.to_tensor(scores), paddle.to_tensor(lab), k=k)
        assert got.dtype == torch.float32 and got.item() == float(want.numpy())


# --------------------------------------------------------------- tiny Llama


class _Seqs:
    """Token rows and their next-token labels (the last one ignored)."""

    def __init__(self, n, seq, vocab, seed):
        self.ids = np.random.RandomState(seed).randint(1, vocab, (n, seq)).astype(np.int32)
        self.labels = np.concatenate(
            [self.ids[:, 1:], np.full((n, 1), -100, np.int32)], axis=1)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


def test_tiny_llama_fit_matches_reference():
    paddle.seed(31)
    cfg = dict(num_key_value_heads=2, num_hidden_layers=2)
    jmodel = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    tmodel = load_reference_state(
        tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu"), state)
    jm, tm = paddle.Model(jmodel), pt.Model(tmodel)
    jm.prepare(paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jmodel.parameters()),
               lambda logits, labels: jutils.sequence_ce(jmodel, logits, labels))
    tm.prepare(pt.optimizer.AdamW(learning_rate=1e-3, parameters=tmodel.named_parameters()),
               sequence_ce)
    vocab = tllama.LlamaConfig.tiny().vocab_size
    jspy, jev = _spy(paddle.callbacks.Callback)
    tspy, tev = _spy(pt.callbacks.Callback)
    data = _Seqs(8, 16, vocab, seed=4)
    jh = jm.fit(data, batch_size=2, epochs=1, log_freq=1, verbose=0, shuffle=False,
                callbacks=[jspy])
    th = tm.fit(data, batch_size=2, epochs=1, log_freq=1, verbose=0, shuffle=False,
                callbacks=[tspy])
    _same_events(tev, jev)
    losses = [e[2]["loss"] for e in tev if e[0] == "batch_end"]
    assert len(losses) == 4 and losses[-1] < losses[0]
    np.testing.assert_allclose(th, jh, rtol=1e-5)
