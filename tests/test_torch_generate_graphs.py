"""Lock-step `generate` of the port as captured steps, against the JAX
package's `compiled_generate` on the CPU.

Every strategy keeps one `StepGraph` in `model._gen_fns` under the
reference's key, and traces the prefill shape and the decode shape once:
`trace_count` equals the reference's `StaticFunction.trace_count` (2) after
the same calls and stays there on a repeat call.  A tiny float32 Llama (GQA,
2 kv heads) is built by the JAX package; its state goes through numpy into
the port.  Greedy, greedy with eos and beam tokens are identical to the JAX
package's, on the first call and on the repeat.  Sampled paths are held by
seeded repeats, differing seeds and top_k=1 equalling greedy (JAX keys and
torch generators draw different numbers).  On the CPU a StepGraph runs its
body eagerly on the same static buffers, so these tests hold the step
bodies, the in-place loop state and the keys; the card's graphs are
`chip_smoke.py`'s generate phase.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import GenerationPredictor
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(1, 250, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(43)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


def _jax(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _port(tm, ids, **kw):
    return tm.generate(torch.from_numpy(ids), **kw).numpy()


def _eos_of(tm, ids, at, **kw):
    """A token the plain run emits at generated column `at` of row 0."""
    return int(_port(tm, ids, **kw)[0, ids.shape[1] + at])


def _cases(tm):
    """(name, prompt, generate kwargs, the reference's _gen_fns key)."""
    ids20, ids70, ids9 = _ids(2, 20, 20), _ids(2, 70, 70), _ids(2, 9, 5)
    eos = _eos_of(tm, _ids(2, 6, 11), 2, max_new_tokens=8)
    beam_eos = _eos_of(tm, ids9, 1, max_new_tokens=8, num_beams=2)
    return [
        ("greedy-20", ids20, dict(max_new_tokens=6), "greedy"),
        ("greedy-70", ids70, dict(max_new_tokens=6), "greedy"),
        ("greedy-eos", _ids(2, 6, 11), dict(max_new_tokens=8, eos_token_id=eos),
         ("greedy", eos)),
        ("beam-eos-lp", ids9, dict(max_new_tokens=8, num_beams=2,
                                   eos_token_id=beam_eos, length_penalty=1.0),
         ("beam", 2, beam_eos)),
    ]


@pytest.mark.parametrize("case", range(4),
                         ids=["greedy-20", "greedy-70", "greedy-eos", "beam-eos-lp"])
def test_tokens_and_trace_counts_match_the_reference(models, case):
    """Tokens identical to the JAX package's on the first call and the
    repeat; each side's graph of the strategy traced twice (prefill shape,
    decode shape), and not again on the repeat.  Each case starts both
    models on a fresh geometry, so the counts are this case's alone."""
    jm, tm = models
    name, ids, kw, key = _cases(tm)[case]
    for m in (jm, tm):
        m._gen_cache_key = None  # a fresh registry on the next call
    first = _port(tm, ids, **kw)
    ref = _jax(jm, ids, **kw)
    np.testing.assert_array_equal(first, ref)
    assert tm._gen_fns[key].trace_count == jm._gen_fns[key].trace_count == 2
    again = _port(tm, ids, **kw)
    np.testing.assert_array_equal(again, ref)
    np.testing.assert_array_equal(_jax(jm, ids, **kw), ref)
    assert tm._gen_fns[key].trace_count == jm._gen_fns[key].trace_count == 2
    assert tm._gen_fns[key].replay_count > 0


@pytest.mark.parametrize("eos", [False, True], ids=["sample", "sample-eos"])
def test_sampling_keys_trace_twice_and_repeat_when_reseeded(models, eos):
    jm, tm = models
    ids = _ids(2, 8, 3)
    kw = dict(max_new_tokens=5, temperature=0.7, top_k=5, top_p=0.9, seed=11)
    if eos:
        kw["eos_token_id"] = int(_port(tm, ids, **kw)[0, 8 + 3])
    key = ("sample", 5, 0.9) + ((kw["eos_token_id"],) if eos else ())
    for m in (jm, tm):
        m._gen_cache_key = None
    a = _port(tm, ids, **kw)
    _jax(jm, ids, **kw)
    assert tm._gen_fns[key].trace_count == jm._gen_fns[key].trace_count == 2
    np.testing.assert_array_equal(_port(tm, ids, **kw), a)  # a replay repeats
    _jax(jm, ids, **kw)
    assert tm._gen_fns[key].trace_count == jm._gen_fns[key].trace_count == 2


def test_two_seeds_differ_and_top_k_1_is_greedy(models):
    _, tm = models
    ids = _ids(1, 8, 4)
    kw = dict(max_new_tokens=8, temperature=1.5)
    assert not np.array_equal(_port(tm, ids, seed=1, **kw),
                              _port(tm, ids, seed=2, **kw))
    greedy = _port(tm, ids, max_new_tokens=6)
    np.testing.assert_array_equal(
        _port(tm, ids, max_new_tokens=6, temperature=1.0, top_k=1, seed=7), greedy)


def test_geometry_change_drops_the_graphs_and_keeps_the_tokens(models):
    """A new batch or cache length rebuilds the caches and drops every
    captured step with them (the reference's `_ensure_gen_state`); the new
    geometry traces afresh and still gives the reference's tokens, and so
    does the old one after it."""
    jm, tm = models
    small, wide = _ids(1, 10, 8), _ids(3, 10, 9)
    ref_small = _jax(jm, small, max_new_tokens=5)
    np.testing.assert_array_equal(_port(tm, small, max_new_tokens=5), ref_small)
    fns, caches = tm._gen_fns, tm._gen_caches
    np.testing.assert_array_equal(_port(tm, wide, max_new_tokens=5),
                                  _jax(jm, wide, max_new_tokens=5))
    assert tm._gen_fns is not fns and tm._gen_caches is not caches
    assert list(tm._gen_fns) == ["greedy"] and tm._gen_fns["greedy"].trace_count == 2
    # a longer cache (200 tokens -> 256 rows) is another geometry too
    np.testing.assert_array_equal(_port(tm, small, max_new_tokens=200)[:, :15],
                                  ref_small)
    assert tm._gen_caches[0].k.shape[1] == 256
    np.testing.assert_array_equal(_port(tm, small, max_new_tokens=5), ref_small)


def test_predictor_warmup_captures_its_geometry(models):
    """`GenerationPredictor.warmup` traces the geometry it warms, so a
    request of that geometry traces nothing (the reference's promise)."""
    jm, tm = models
    tm._gen_cache_key = None
    pred = GenerationPredictor(tm, max_new_tokens=6).warmup(prompt_len=12)
    graph = tm._gen_fns["greedy"]
    assert graph.trace_count == 2
    p = _ids(1, 12, 13)[0]
    out = pred.generate(p)
    assert graph.trace_count == 2 and tm._gen_fns["greedy"] is graph
    np.testing.assert_array_equal(out, _jax(jm, p[None], max_new_tokens=6))


def test_decode_step_replay_equals_eager(models):
    """`StepGraph.compare_eager` on the decode keys: one replay beside one
    eager run of the body on the same static inputs gives the same bits
    (beam search's cache reorder restored between them)."""
    _, tm = models
    tm._gen_cache_key = None
    _port(tm, _ids(2, 9, 17), max_new_tokens=5)
    replayed, eager = tm._gen_fns["greedy"].compare_eager((2, 1))
    assert all(torch.equal(a, b) for a, b in zip(replayed, eager))
    _port(tm, _ids(1, 9, 18), max_new_tokens=5, num_beams=3)
    graph = tm._gen_fns[("beam", 3, None)]
    key = ((3, 1), 5)
    graph.inputs(key)["ti"].fill_(4)  # the last step's column again
    caches = [t for c in tm._gen_caches for t in (c.k, c.v)]
    kept = [t.clone() for t in caches]
    replayed, eager = graph.compare_eager(key, caches)
    assert all(torch.equal(a, b) for a, b in zip(replayed, eager))
    assert all(torch.equal(t, k) for t, k in zip(caches, kept))  # restored
