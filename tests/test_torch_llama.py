"""The port's Llama against the JAX package's, on shared weights, on the CPU.

The JAX model is built after `paddle.seed`, its `state_dict()` goes through
numpy into the port with `load_reference_state` (which transposes the
Linear weights).  Layer-level functions compare at atol/rtol 1e-5 (float32,
different summation order); model logits at 1e-4, because two layers of
matmuls sum in a different order on each side.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.nn import RMSNorm

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(tm, state)
    return jm, tm


def _ids(rng, *shape):
    return rng.integers(1, 250, size=shape).astype(np.int32)


def test_load_reference_state_transposes_linears(models):
    jm, tm = models
    assert len(jm.state_dict()) == 21
    w = np.asarray(jm.state_dict()["llama.layers.0.self_attn.k_proj.weight"].numpy())
    assert w.shape == (64, 32)  # paddle [in, out]
    np.testing.assert_array_equal(
        tm.llama.layers[0].self_attn.k_proj.weight.detach().numpy(), w.T
    )
    bad = {"llama.embed_tokens.weight": np.zeros((256, 64), np.float32)}
    with pytest.raises(KeyError, match="missing"):
        load_reference_state(tm, bad)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = JF.rms_norm(to_tensor(x), to_tensor(w), 1e-5).numpy()
    norm = RMSNorm(64, 1e-5, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        out = norm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_reference(per_row):
    cfg = tllama.LlamaConfig.tiny()
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    cos, sin = jllama._rope_cache(jllama.LlamaConfig.tiny())
    tcos, tsin = tllama.rope_cache(cfg, "cpu")
    np.testing.assert_array_equal(tcos.numpy(), cos.numpy())
    # per-row offsets include one past the table end: both sides clamp
    off = np.array([0, 7, 254], np.int32) if per_row else 5
    jq, jk = jllama.apply_rotary_pos_emb(
        to_tensor(q), to_tensor(k), cos, sin,
        to_tensor(off) if per_row else off,
    )
    tq, tk = tllama.apply_rotary_pos_emb(
        torch.from_numpy(q), torch.from_numpy(k), tcos, tsin,
        torch.from_numpy(off) if per_row else off,
    )
    np.testing.assert_allclose(tq.numpy(), jq.numpy(), **TOL)
    np.testing.assert_allclose(tk.numpy(), jk.numpy(), **TOL)


def test_full_sequence_logits_match_reference(models):
    jm, tm = models
    ids = _ids(np.random.default_rng(2), 2, 13)
    ref = jm(to_tensor(ids)).numpy()
    with torch.no_grad():
        out = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)


@pytest.mark.parametrize("kernel", ["fused", "gather"])
def test_paged_prefill_then_decode_logits_match_reference(models, kernel):
    """Two prompts prefilled into their pages (bucket-padded), then three
    decode steps over three slots -- slot 2 inactive at pos 0 over an
    all-zero table row (scratch page 0).  Logits compared at every step
    against the JAX model's paged views (its gather oracle)."""
    jm, tm = models
    cfg = tm.config
    hd = cfg.head_dim
    ps, P, max_len, pages = 8, 5, 40, 11
    j_arenas = [jllama.PagedKVCache(pages, ps, 2, hd) for _ in range(cfg.num_hidden_layers)]
    t_arenas = [tllama.PagedKVCache(pages, ps, 2, hd, device="cpu")
                for _ in range(cfg.num_hidden_layers)]
    tables = np.zeros((3, P), np.int32)
    tables[0, :3] = [3, 9, 1]
    tables[1, :2] = [6, 2]
    rng = np.random.default_rng(3)
    lens = [11, 5]
    nxt = []
    for s, (L, bucket) in enumerate(zip(lens, [16, 8])):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = _ids(rng, L)
        jv = [jllama.PagedPrefillView(a, to_tensor(tables[s]), to_tensor(np.int32(L)),
                                      max_len) for a in j_arenas]
        jh, _ = jm.llama(to_tensor(toks), caches=jv)
        ref = jm.lm_head(jh).numpy()[0, L - 1]
        tv = [tllama.PagedPrefillView(a, torch.from_numpy(tables[s]), L)
              for a in t_arenas]
        with torch.no_grad():
            out = tm.lm_head(tm.llama(torch.from_numpy(toks), caches=tv))[0, L - 1]
        np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)
        nxt.append(int(np.argmax(ref)))
    for a, b in zip(j_arenas, t_arenas):  # the scatters wrote the same rows
        np.testing.assert_allclose(b.k.numpy(), a.k.numpy(), **LOGIT_TOL)
    pos = np.array(lens + [0], np.int32)
    active = np.array([True, True, False])
    toks = np.array([[nxt[0]], [nxt[1]], [0]], np.int32)
    for _ in range(3):
        pos_eff = np.where(active, pos, 0).astype(np.int32)
        jv = [jllama.PagedDecodeView(a, to_tensor(tables), max_len, kernel="gather")
              for a in j_arenas]
        jh, _ = jm.llama(to_tensor(toks), caches=jv, pos=to_tensor(pos_eff))
        ref = jm.lm_head(jh).numpy()[:, -1]
        tv = [tllama.PagedDecodeView(a, torch.from_numpy(tables), max_len, kernel=kernel)
              for a in t_arenas]
        with torch.no_grad():
            out = tm.lm_head(tm.llama(torch.from_numpy(toks), caches=tv,
                                      pos=torch.from_numpy(pos_eff)))[:, -1]
        np.testing.assert_allclose(out.numpy()[:2], ref[:2], **LOGIT_TOL)
        toks = np.argmax(ref, axis=-1).astype(np.int32)[:, None]
        pos = np.where(active, pos + 1, pos).astype(np.int32)


def test_paged_decode_write_sends_redirects_to_scratch():
    """sq > 1 rows whose page entry overruns the table land on page 0;
    sq == 1 writes at pos // page_size."""
    arena = torch.zeros(4, 2, 1, 1)
    tables = torch.tensor([[1, 2], [3, 1]], dtype=torch.int32)
    new = torch.arange(1, 7, dtype=torch.float32).view(2, 3, 1, 1)
    tllama._page_decode_write(arena, new, tables, torch.tensor([2, 0], dtype=torch.int32))
    assert arena[2, :, 0, 0].tolist() == [1.0, 2.0]  # slot 0 rows pos 2, 3
    assert arena[0, 0, 0, 0].item() == 3.0  # pos 4 overruns P=2 -> scratch
    assert arena[3, :, 0, 0].tolist() == [4.0, 5.0]
    assert arena[1, 0, 0, 0].item() == 6.0
    one = torch.full((2, 1, 1, 1), 9.0)
    tllama._page_decode_write(arena, one, tables, torch.tensor([1, 2], dtype=torch.int32))
    # slot 0: pos 1 -> page 1 row 1; slot 1: pos 2 -> entry 1 = page 1 row 0
    assert arena[1, :, 0, 0].tolist() == [9.0, 9.0]
    assert arena[0, 0, 0, 0].item() == 3.0
