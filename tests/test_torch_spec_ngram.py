"""`FLAGS_serve_spec_ngram` in the port against the JAX package on the CPU.

The reference reads the flag once at engine construction and builds every
slot's prompt-lookup drafter with it (paddle_tpu/inference/engine.py:658,
:2410, :2513).  Engines on shared weights (tiny Llama, float32, greedy,
spec_k 2) under n = 1, 2 and 4: the port's tokens, verify steps, drafts
proposed and accepted, and tokens emitted equal the reference's.  The
flag is set in both packages and put back after each case.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import profiler as jprofiler
from paddle_tpu.framework import core as jcore
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8, spec_k=2)
FLAG = "FLAGS_serve_spec_ngram"


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    """Tiny Llama from numpy seed 1234 and the port's model on its weights."""
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture
def ngram():
    """Sets the flag in both packages; puts the defaults back after."""
    before = (jcore.flag(FLAG), tcore.flag(FLAG))

    def set_n(n):
        jcore.set_flags({FLAG: n})
        tcore.set_flags({FLAG: n})

    yield set_n
    jcore.set_flags({FLAG: before[0]})
    tcore.set_flags({FLAG: before[1]})


def _traffic():
    """Three random greedy prompts whose generated streams repeat n-grams
    of several orders with different continuations: on this model a
    1-gram drafter accepts other drafts than a 2-gram one (prompts 3, 5
    and 6), and a 2-gram one other than a 3-gram one (prompt 6), so the
    flag's value shows in the counters."""
    prompts = [np.random.RandomState(s).randint(1, 250, size=10).astype(np.int32)
               for s in (3, 5, 6)]
    return prompts, [44, 44, 44]


def _serve(eng, prompts, news):
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    return [r.wait(1).tolist() for r in reqs]


def test_the_flag_defaults_to_the_reference_value():
    assert tcore.flag(FLAG) == jcore.flag(FLAG) == 3


@pytest.mark.parametrize("n", [1, 2, 4])
def test_spec_ngram_matches_reference_engine(models, ngram, n):
    jm, tm = models
    ngram(n)
    prompts, news = _traffic()
    jprofiler.reset_speculation()
    ref = _serve(JaxEngine(jm, **ENGINE), prompts, news)
    ref_spec = jprofiler.speculation_summary()
    profiler.reset_speculation()
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    assert eng._spec_ngram == n
    got = _serve(eng, prompts, news)
    spec = profiler.speculation_summary()
    assert got == ref
    for key in ("steps", "proposed", "accepted", "emitted"):
        assert spec[key] == ref_spec[key], key
    assert spec["accepted"] > 0


def test_the_flag_is_read_once_at_construction(models, ngram):
    _, tm = models
    ngram(1)
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    ngram(4)
    assert eng._spec_ngram == 1
    eng.submit(_traffic()[0][0], max_new_tokens=4)
    eng.step()
    assert all(d is None or d.max_ngram == 1 for d in eng._drafters)
    assert any(d is not None for d in eng._drafters)
