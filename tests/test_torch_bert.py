"""The port's BERT and transformer layers against the JAX package on the CPU.

Tiny configurations; every port model takes the reference model's weights
through `load_reference_state` (Linear weights transposed), and both run
the same numpy inputs in float32.  Tolerance atol/rtol 1e-4, as the
reference's own BERT tests (tests/test_models.py:344-351): a few layers of
matmuls summed in different orders.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=1e-4, rtol=1e-4)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _pair(head="qa", seed=3, **cfg):
    """(reference model, port model) of one head on the same weights, both
    in eval mode."""
    cfg = {**NO_DROPOUT, **cfg}
    jcls, tcls = {"qa": (jbert.BertForQuestionAnswering, tbert.BertForQuestionAnswering),
                  "cls": (jbert.BertForSequenceClassification,
                          tbert.BertForSequenceClassification),
                  "mlm": (jbert.BertForMaskedLM, tbert.BertForMaskedLM)}[head]
    paddle.seed(seed)
    jm = jcls(jbert.BertConfig.tiny(**cfg))
    tm = tcls(tbert.BertConfig.tiny(**cfg), device="cpu")
    load_reference_state(tm, _state(jm))
    jm.eval()
    return jm, tm


def _batch(seed, b=2, s=16, pad=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, s)).astype(np.int32)
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int64)
    if pad:
        mask[0, 10:] = 0
        mask[1, 13:] = 0
    return ids, types, mask


def _j(x):
    return paddle.to_tensor(x)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x.numpy()


@pytest.mark.parametrize("masked", [True, False])
def test_bert_outputs_match_reference(masked):
    jm, tm = _pair()
    ids, types, mask = _batch(1)
    m = mask if masked else None
    jseq, jpool = jm.bert(_j(ids), _j(types), None if m is None else _j(m))
    tseq, tpool = tm.bert(torch.from_numpy(ids), torch.from_numpy(types),
                          None if m is None else torch.from_numpy(m))
    live = mask > 0 if masked else np.ones_like(mask, bool)
    np.testing.assert_allclose(_np(tseq)[live], _np(jseq)[live], **TOL)
    np.testing.assert_allclose(_np(tpool), _np(jpool), **TOL)
    starts = np.array([3, 1], np.int64)
    ends = np.array([7, 12], np.int64)
    kw = lambda f: dict(token_type_ids=f(types),
                        attention_mask=None if m is None else f(m),
                        start_positions=f(starts), end_positions=f(ends))
    jl, js, je = jm(_j(ids), **kw(_j))
    tl, ts, te = tm(torch.from_numpy(ids), **kw(torch.from_numpy))
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    np.testing.assert_allclose(_np(te), _np(je), **TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tl.dtype == torch.float32


@pytest.mark.parametrize("head", ["cls", "mlm"])
def test_other_heads_match_reference(head):
    jm, tm = _pair(head, seed=4)
    ids, types, mask = _batch(2)
    if head == "cls":
        labels = np.array([1, 0], np.int64)
    else:
        labels = np.where(np.random.default_rng(3).random(ids.shape) < 0.3,
                          ids, -100).astype(np.int64)
    jl, jlog = jm(_j(ids), _j(types), _j(mask), labels=_j(labels))
    tl, tlog = tm(torch.from_numpy(ids), torch.from_numpy(types),
                  torch.from_numpy(mask), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_one_adamw_step_matches_reference():
    """One QA training step (train mode, dropout 0, AdamW) in both
    packages: every gradient, then every parameter after the update,
    within the tolerance.  A parameter whose gradient is 0 in exact
    arithmetic is held by its gradient alone: a key projection's bias adds
    the same q.b to all of a query's scores, which the softmax cancels, and
    the biases just below the span classifier get the sum over positions of
    p - onehot, which is 0; their gradients are round-off, and Adam turns
    round-off into a step of about lr whose sign is the noise's."""
    jm, tm = _pair(seed=5)
    jm.train()
    tm.train()
    ids, types, mask = _batch(6)
    starts, ends = np.array([2, 4], np.int64), np.array([5, 9], np.int64)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topt = optimizer.AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    jl, _, _ = jm(_j(ids), _j(types), _j(mask), _j(starts), _j(ends))
    jl.backward()
    jgrads = {n: None if p.grad is None else _np(p.grad)
              for n, p in jm.named_parameters()}
    jopt.step()
    t = torch.from_numpy
    tl, _, _ = tm(t(ids), t(types), t(mask), t(starts), t(ends))
    tl.backward()
    tgrads = {n: None if p.grad is None else _np(p.grad)
              for n, p in tm.named_parameters()}
    topt.step()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), **TOL)
    linear = {n for n, mod in tm.named_modules() if isinstance(mod, torch.nn.Linear)}
    want = _state(jm)
    zero_grad = []
    for name, p in tm.named_parameters():
        is_weight = name.rsplit(".", 1)[0] in linear and name.endswith("weight")
        flip = (lambda a: a.T) if is_weight else (lambda a: a)
        assert (tgrads[name] is None) == (jgrads[name] is None), name
        if tgrads[name] is None:  # the pooler: QA does not read it
            continue
        np.testing.assert_allclose(flip(tgrads[name]), jgrads[name], err_msg=name,
                                   **TOL)
        if np.abs(jgrads[name]).max() < 1e-6:
            zero_grad.append(name)
            continue
        np.testing.assert_allclose(flip(_np(p)), want[name], err_msg=name, **TOL)
    assert sorted(zero_grad) == sorted(
        [f"bert.encoder.{i}.attn.k_proj.bias" for i in range(2)]
        + ["bert.encoder.1.norm2.bias", "classifier.bias"])


def test_masked_equals_truncated_on_valid_rows():
    _, tm = _pair(seed=7)
    ids, types, mask = _batch(8)
    seq_m, _ = tm.bert(torch.from_numpy(ids), torch.from_numpy(types),
                       torch.from_numpy(mask))
    seq_t, _ = tm.bert(torch.from_numpy(ids[:1, :10]), torch.from_numpy(types[:1, :10]))
    np.testing.assert_allclose(_np(seq_m)[0, :10], _np(seq_t)[0], **TOL)


def test_o2_keeps_layer_norms_float32():
    tm = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny(), device="cpu")
    opt = optimizer.AdamW(learning_rate=3e-5, parameters=tm.named_parameters())
    amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    norms = {id(p) for mod in tm.modules() if isinstance(mod, tnn.LayerNorm)
             for p in mod.parameters()}
    assert len(norms) == 2 * (1 + 2 * tm.config.num_hidden_layers)
    for name, p in tm.named_parameters():
        want = torch.float32 if id(p) in norms else torch.bfloat16
        assert p.dtype == want, name
        assert ("master_weight" in opt.state[p]) == (want == torch.bfloat16), name
    ids, types, mask = _batch(9)
    t = torch.from_numpy
    loss, start, _ = tm(t(ids), t(types), t(mask), t(np.array([1, 2])),
                        t(np.array([3, 4])))
    assert start.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert torch.isfinite(loss)


def test_dropout_zero_is_identity_and_seeded_runs_repeat():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert TF.dropout(x, 0.0, training=True) is x
    assert TF.dropout(x, 0.3, training=False) is x
    gen = torch.Generator()
    first = TF.dropout(x, 0.3, generator=gen.manual_seed(1))
    again = TF.dropout(x, 0.3, generator=gen.manual_seed(1))
    assert torch.equal(first, again)
    kept = first != 0
    torch.testing.assert_close(first[kept], x[kept] / 0.7)
    # a whole model in training mode with dropout on: reseeding its
    # generator repeats the run, another seed does not
    tm = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny(), device="cpu").train()
    ids, types, mask = (torch.from_numpy(a) for a in _batch(10))
    runs = []
    for seed in (5, 5, 6):
        tm.dropout_generator.manual_seed(seed)
        runs.append(tm(ids, types, mask)[0])
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # p 0 in training: the eval-mode output
    tm0 = tbert.BertForQuestionAnswering(tbert.BertConfig.tiny(**NO_DROPOUT),
                                         device="cpu")
    ev = tm0(ids, types, mask)[0]
    assert torch.equal(tm0.train()(ids, types, mask)[0], ev)


def _encoder_pair(seed, layers=2, **kw):
    paddle.seed(seed)
    jl = jnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, **kw)
    jenc = jnn.TransformerEncoder(jl, layers)
    tl = tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, device="cpu", **kw)
    tenc = tnn.TransformerEncoder(tl, layers)
    load_reference_state(tenc, _state(jenc))
    jenc.eval()
    return jenc, tenc.eval()


@pytest.mark.parametrize("mask_kind", ["key_padding", "general", "none"])
@pytest.mark.parametrize("normalize_before,activation",
                         [(False, "relu"), (True, "gelu")])
def test_transformer_encoder_matches_reference(mask_kind, normalize_before,
                                               activation):
    """`src_mask` a key-padding mask (the kernels' key bias), a general
    [b, 1, s, s] mask (the plain path) or none."""
    jenc, tenc = _encoder_pair(12, normalize_before=normalize_before,
                               activation=activation)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mask = None
    if mask_kind == "key_padding":
        mask = np.zeros((2, 1, 1, 12), np.float32)
        mask[0, ..., 8:] = -1e30
    elif mask_kind == "general":
        mask = np.where(rng.random((2, 1, 12, 12)) < 0.7, 0.0, -1e30).astype(np.float32)
        mask[..., np.arange(12), np.arange(12)] = 0.0
    pfa.reset_launch_counts()
    want = jenc(_j(x), None if mask is None else _j(mask))
    got = tenc(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    general = 2 if mask_kind == "general" else 0
    assert pfa.fallback_counts["attn_mask not key-padding"] == general


def test_key_padding_mask_equals_segment_ids_on_valid_rows():
    """A BertEncoderLayer with a key-padding attn_mask (the kernels' key
    bias) gives the segment-id forward on the valid rows."""
    _, tm = _pair(seed=14)
    layer = tm.bert.encoder[0]
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 16, 64)).astype(np.float32))
    _, _, mask = _batch(16)
    t_mask = torch.from_numpy(mask)
    bias = torch.where(t_mask > 0, 0.0, -1e30)[:, None, None, :]
    by_bias = layer(x, attn_mask=bias)
    by_segs = layer(x, segment_ids=tbert.to_segs(t_mask))
    live = mask > 0
    np.testing.assert_allclose(_np(by_bias)[live], _np(by_segs)[live], **TOL)


def test_attention_caches_raise_naming_the_roadmap_item():
    mha = tnn.MultiHeadAttention(16, 2, device="cpu")
    x = torch.zeros(1, 4, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mha(x, cache=mha.Cache(x, x))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mha.gen_cache(x)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(17)
    logits = (3 * rng.standard_normal((6, 9))).astype(np.float32)
    labels = np.array([0, 3, -100, 8, 2, -100], np.int64)
    for reduction in ("mean", "sum", "none"):
        want = jnn.functional.cross_entropy(_j(logits), _j(labels),
                                            reduction=reduction)
        got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               reduction=reduction)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         label_smoothing=0.1)
