"""The port's speculative decoding against the JAX package on the CPU.

- `NgramDrafter` and `spec_write_pages` give the reference's answers on the
  same call sequences.
- Engines on shared weights (tiny Llama, float32, page_size 8): the spec
  engine's greedy tokens at spec_k 2 and 4 identical to the port's plain
  engine's and to the JAX spec engine's, with the same drafts proposed,
  accepted and tokens emitted (`speculation_summary()`), and under int8
  pages identical to the JAX int8 spec engine's.
- The engine contract of the reference's tests/test_spec_decode.py: spec_k
  0 is the plain engine, a per-request opt-out and mixed spec, plain and
  sampled slots keep the greedy tokens, an eos inside an accepted run
  right-trims, the length bound is never overshot, and the page audit holds
  under speculation.

Launch counts read 0 here: CPU tensors run the kernels' plain versions.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import profiler as jprofiler
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference import spec as jspec
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference import spec as tspec
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _cycle_prompt(n=20, period=6, seed=7):
    """A repetitive prompt: the traffic prompt-lookup drafting gains on."""
    pat = _prompt(period, seed=seed)
    return np.tile(pat, -(-n // period))[:n].astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    """The reference's spec-test model (tests/test_spec_decode.py: tiny
    Llama from numpy seed 1234) and the port's model on its weights."""
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


def _engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw})


def _traffic():
    """Ragged greedy prompts served together, the repetitive one first."""
    prompts = [_cycle_prompt(), _prompt(9, seed=3), _cycle_prompt(14, 4, seed=5),
               _prompt(13, seed=6)]
    return prompts, [24, 10, 16, 12]


def _serve(eng, prompts, news, **kw):
    reqs = [eng.submit(p, max_new_tokens=n, **kw) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    return [r.wait(1).tolist() for r in reqs]


@pytest.fixture(scope="module")
def reference(models):
    """Per engine kind: the JAX engine's tokens and speculation counters on
    the traffic above."""
    jm, _ = models
    prompts, news = _traffic()
    out = {}
    for key, kw in (("k2", dict(spec_k=2)), ("k4", dict(spec_k=4)),
                    ("int8_k2", dict(spec_k=2, kv_quant="int8"))):
        jprofiler.reset_speculation()
        eng = JaxEngine(jm, **ENGINE, **kw)
        out[key] = (_serve(eng, prompts, news), jprofiler.speculation_summary())
    return out


# ---------------------------------------------------------------------------
# host halves: the drafter and the window's page split
# ---------------------------------------------------------------------------


def _drafter_script(mod, rng):
    """Resets, extends and proposals on one drafter; returns every
    proposal and the final length."""
    d = mod.NgramDrafter(3)
    got = [d.propose(3)]
    d.reset(rng.integers(1, 6, size=7).tolist())
    for _ in range(40):
        got.append(d.propose(int(rng.integers(0, 6))))
        d.extend(int(rng.integers(1, 6)))
    d.reset([7])
    got += [d.propose(3)]
    d.extend(7)
    got += [d.propose(3), d.propose(0)]
    return got, len(d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_drafter_matches_reference(seed):
    ref = _drafter_script(jspec, np.random.default_rng(seed))
    got = _drafter_script(tspec, np.random.default_rng(seed))
    assert got == ref
    assert any(len(p) > 1 for p in got[0])  # long drafts were made
    d = tspec.NgramDrafter(3).reset([1, 2, 3, 1, 2])
    assert d.propose(4) == [3, 1, 2, 3]  # the match's cycle, extrapolated


def test_spec_write_pages_matches_reference():
    for pos in range(0, 40, 3):
        for width in range(0, 6):
            for mapped in range(0, 7):
                args = (pos, width, 8, mapped)
                assert (tpaging.spec_write_pages(*args)
                        == jpaging.spec_write_pages(*args)), args


# ---------------------------------------------------------------------------
# engines on shared weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_spec_tokens_and_counters_equal_plain_and_jax_engines(models, reference, k):
    _, tm = models
    prompts, news = _traffic()
    plain = _serve(_engine(tm), prompts, news)
    profiler.reset_speculation()
    eng = _engine(tm, spec_k=k)
    eng.warmup()
    outs = _serve(eng, prompts, news)
    ref_outs, ref_spec = reference[f"k{k}"]
    assert outs == plain
    assert outs == ref_outs
    got = profiler.speculation_summary()
    for key in ("steps", "proposed", "accepted", "emitted"):
        assert got[key] == ref_spec[key], key
    assert got["accepted"] > 0 and got["tokens_per_step"] > 1.0
    assert got["emitted"] == sum(news) - len(news)  # every token after the first


def test_int8_spec_tokens_equal_jax_int8_spec_engine(models, reference):
    _, tm = models
    prompts, news = _traffic()
    profiler.reset_speculation()
    outs = _serve(_engine(tm, spec_k=2, kv_quant="int8"), prompts, news)
    ref_outs, ref_spec = reference["int8_k2"]
    assert outs == ref_outs
    assert profiler.speculation_summary()["accepted"] == ref_spec["accepted"]


def test_spec_k0_is_the_plain_engine(models):
    _, tm = models
    p = _prompt(10, seed=11)
    k0 = _engine(tm, spec_k=0)
    assert not k0._spec_on
    profiler.reset_speculation()
    assert k0.generate(p, max_new_tokens=8).tolist() == \
        _engine(tm).generate(p, max_new_tokens=8).tolist()
    assert profiler.speculation_summary() == {}  # no verify step ran
    # the flag's default is off, and the dense pool keeps speculation off
    assert tcore.flag("FLAGS_serve_spec_k") == 0
    assert _engine(tm, spec_k=3, paged=False).spec_k == 0


def test_per_request_opt_out_rides_verify_unchanged(models):
    _, tm = models
    p = _cycle_prompt(n=14)
    out = _engine(tm).generate(p, max_new_tokens=10).tolist()
    eng = _engine(tm, spec_k=3)
    profiler.reset_speculation()
    r = eng.submit(p, max_new_tokens=10, spec_k=0)
    eng.run_until_idle()
    assert r.wait(1).tolist() == out
    assert eng._drafters == [None] * eng.slots  # it never drafted
    assert profiler.speculation_summary()["proposed"] == 0
    with pytest.raises(ValueError, match="spec_k"):
        eng.submit(p, spec_k=-1)


def test_mixed_spec_plain_and_sampled_slots_keep_greedy_tokens(models):
    _, tm = models
    pg, po, ps_ = _cycle_prompt(), _prompt(9, seed=3), _prompt(7, seed=4)
    outs = {}
    for tag, eng in (("plain", _engine(tm)), ("spec", _engine(tm, spec_k=3))):
        r_g = eng.submit(pg, max_new_tokens=14)
        r_o = eng.submit(po, max_new_tokens=10, spec_k=0)
        r_s = eng.submit(ps_, max_new_tokens=8, temperature=0.8)
        eng.run_until_idle()
        outs[tag] = (r_g.wait(1).tolist(), r_o.wait(1).tolist())
        assert len(r_s.wait(1)) == ps_.size + 8  # the sampled slot completes
    assert outs["spec"] == outs["plain"]


def test_eos_inside_accepted_run_right_trims(models):
    """Find a token whose first occurrence lands inside a multi-token
    accepted run, rerun with it as eos: the request ends at it exactly."""
    _, tm = models
    p = _cycle_prompt()
    eng = _engine(tm, spec_k=3)
    r = eng.submit(p, max_new_tokens=24)
    runs = []
    while eng.has_work():
        before = len(r.tokens)
        eng.step()
        runs.append(list(r.tokens[before:]))
    full, seen, eos = list(r.tokens), set(), None
    for run in runs:
        for j, t in enumerate(run):
            if t not in seen and j < len(run) - 1:
                eos = t
                break
            seen.add(t)
        if eos is not None:
            break
    assert eos is not None, "no multi-token accepted run on this model"
    eng2 = _engine(tm, spec_k=3)
    r2 = eng2.submit(p, max_new_tokens=24, eos_token_id=int(eos))
    eng2.run_until_idle()
    assert r2.wait(1).tolist() == p.tolist() + full[:full.index(eos) + 1]
    assert r2.finish_reason == "eos"


def test_length_bound_never_overshoots(models):
    _, tm = models
    p = _cycle_prompt()
    eng = _engine(tm, spec_k=3)
    for want in (1, 2, 3, 5):
        r = eng.submit(p, max_new_tokens=want)
        eng.run_until_idle()
        assert len(r.wait(1)) == p.size + want
        assert r.finish_reason == "length"


def test_page_audit_holds_under_speculation(models, monkeypatch):
    _, tm = models
    monkeypatch.setitem(tcore._flags, "FLAGS_serve_debug_invariants", True)
    eng = _engine(tm, slots=2, spec_k=3, pool_pages=12)
    for i in range(4):
        eng.generate(_cycle_prompt(n=10 + i), max_new_tokens=8)
    with eng._mu:
        eng._check_page_invariants_locked()
    eng._prefix.clear(eng._pool)
    assert eng._pool.free_count() == eng._pool.usable_pages
    # the audit sees drift: a page held once more than its holders say
    r = eng.submit(_cycle_prompt(n=10), max_new_tokens=8)
    eng.step()
    with eng._mu:
        page = eng._slot_pages[eng._slot_req.index(r)][0]
        eng._pool.refs[page] += 1
        with pytest.raises(AssertionError, match="refcount drift"):
            eng._check_page_invariants_locked()
        eng._pool.refs[page] -= 1
    eng.run_until_idle()
    assert len(r.wait(1)) == 18
