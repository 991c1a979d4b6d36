"""Loss plumbing and the lock-step generation loop shared by the port's
causal LMs, Llama and GPT (counterpart of `paddle_tpu/models/_utils.py`)."""

from __future__ import annotations

import logging

import numpy as np
import torch


def sequence_ce(logits, labels, ignore_index=-100):
    """Mean cross-entropy over the labels that are not `ignore_index`, with
    the reference's numerics (`sequence_ce`, models/_utils.py:13-25, through
    `nn.functional.cross_entropy`): float32 log-softmax, each token's loss
    clamped at 0, the sum divided by max(valid count, 1) -- so an all-ignored
    batch gives 0, not NaN.  No label shift: the loss at position i scores
    label i.  logits: [..., vocab] (cast to float32 here); labels: [...]
    integer ids (cast to int64, which torch's gather requires).  Returns a
    float32 scalar."""
    vocab = logits.shape[-1]
    lg = logits.reshape(-1, vocab).float()
    lab = labels.reshape(-1).long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = lg.gather(1, safe[:, None])[:, 0]
    loss = (torch.logsumexp(lg, dim=-1) - picked).clamp(min=0.0)
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().clamp(min=1).float()


# ---------------------------------------------------------------------------
# lock-step generation (greedy, sampling, beam search) over static KV caches
# ---------------------------------------------------------------------------

_MASKED = -1e30  # the reference's filtered-logit value


def _filter_logits(lg, top_k, top_p):
    """Top-k / nucleus filtering of [b, V] logits (reference:
    `_filter_logits_array`, models/_utils.py:28): logits below the k-th
    largest, then those past the first whose cumulative probability reaches
    `top_p` (in descending order, ties in the reference's order: a stable
    ascending sort, reversed), become -1e30."""
    out = lg
    if top_k and top_k > 0:
        kth = torch.sort(out, dim=-1).values[:, -int(top_k)][:, None]
        out = torch.where(out < kth, _MASKED, out)
    if top_p is not None and top_p < 1.0:
        sort_idx = torch.argsort(out, dim=-1, stable=True).flip(-1)
        sorted_lg = out.gather(-1, sort_idx)
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability exceeds top_p
        keep_sorted = cum - probs < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
        out = torch.where(keep, out, _MASKED)
    return out


def _draw(probs, gen):
    """One draw per row of probs [b, n] (rows summing to 1) with the
    torch.Generator `gen`: the exponential race argmax(p / E), E ~ Exp(1),
    which is the draw `torch.multinomial` makes for one sample, without its
    host-side check of the input (which a CUDA graph capture refuses).
    Returns [b, 1] int64 column ids."""
    e = torch.empty_like(probs).exponential_(generator=gen)
    return (probs / e).argmax(dim=-1, keepdim=True)


def _sample_from_logits(logits, gen, temp, top_k, top_p):
    """Filter and draw one token per row from softmax(logits / temp) with
    the torch.Generator `gen` (reference: models/_utils.py:64); `temp` is a
    0-d float32 tensor, data of the step.  A top_k below the vocabulary
    draws among the k largest (nucleus-filtered within them), as the
    reference's fast path does.  Returns [b, 1] int64 ids."""
    lg = logits.float() / temp
    if top_k and 0 < top_k < lg.shape[-1]:
        vals, idx = torch.topk(lg, int(top_k), dim=-1)  # descending
        if top_p is not None and top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            vals = torch.where(cum - probs < top_p, vals, _MASKED)
        return idx.gather(-1, _draw(torch.softmax(vals, dim=-1), gen))
    lg = _filter_logits(lg, 0, top_p)
    return _draw(torch.softmax(lg, dim=-1), gen)


def _mask_eos(nxt, done, eos):
    """Rows already done keep emitting eos; done absorbs rows that just hit
    it (reference: models/_utils.py:100).  nxt: [b, 1]; done: [b] bool."""
    nxt = torch.where(done[:, None], torch.full_like(nxt, eos), nxt)
    return nxt, done | (nxt[:, 0] == eos)


def _trim_eos(out, s0, eos):
    """Right-trim generated columns past the last row's first eos (rows done
    sooner are eos-padded up to it).  out: numpy [b, s0 + n] (reference:
    models/_utils.py:117)."""
    gen = out[:, s0:]
    if gen.shape[1] == 0:
        return out
    is_eos = gen == eos
    lens = np.where(is_eos.any(1), is_eos.argmax(1) + 1, gen.shape[1])
    return out[:, :s0 + int(lens.max())]


def _gather_rows(t, rows):
    """t[rows] along dim 0, written back into t's own storage (the beam
    reorder of a preallocated cache buffer)."""
    t.copy_(t.index_select(0, rows))


def _ensure_gen_state(model, b, cache_len, kv_heads):
    """The per-layer StaticKVCaches of a generation geometry and the
    registry of its captured steps, kept on the model and rebuilt together
    when batch, cache length, dtype or device changes (reference:
    models/_utils.py:141-157): a step captured over the old caches would
    replay into freed memory.  The caches live on the model's device in the
    lm_head dtype (bf16 serving stays bf16); under tensor parallelism a
    layer's entry is the list of the ranks' caches, each over its kv heads.
    Returns (caches, fns)."""
    from ..inference.graphs import new_pool
    from .llama import StaticKVCache

    cfg = model.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads  # Llama's and GPT's
    ranks = getattr(model, "tp_ranks", 1)
    key = (b, cache_len, model.lm_head.weight.dtype, model.device, ranks)
    if getattr(model, "_gen_cache_key", None) != key:
        # free the old graphs, then the buffers they read, before allocating
        model._gen_fns = model._gen_caches = model._gen_pool = None

        def cache(heads):
            return StaticKVCache(b, cache_len, heads, head_dim,
                                 model.lm_head.weight.dtype, model.device)

        model._gen_caches = [
            cache(kv_heads) if ranks == 1
            else [cache(kv_heads // ranks) for _ in range(ranks)]
            for _ in range(cfg.num_hidden_layers)
        ]
        model._gen_fns = {}
        model._gen_pool = new_pool(model.device)
        model._gen_cache_key = key
    return model._gen_caches, model._gen_fns


def _generator(model):
    """The model's sampling generator on its device: one, registered with
    every sampling step it captures and re-seeded at each call."""
    gen = getattr(model, "_gen_generator", None)
    if gen is None or gen.device != model.device:
        gen = model._gen_generator = torch.Generator(device=model.device)
    return gen


def _as_ids(input_ids, device, vocab):
    """[b, s0] integer ids as a tensor on `device`, range-checked: on the
    card an id outside [0, vocab) is a device-side assert that poisons the
    CUDA context, where the reference's JAX gather clamps."""
    ids = torch.as_tensor(input_ids)
    if ids.dim() != 2 or ids.is_floating_point() or ids.dtype == torch.bool:
        raise ValueError(f"input_ids must be [batch, seq] integer ids, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    ids = ids.to(device)
    bad = (ids < 0) | (ids >= vocab)
    if bool(bad.any()):
        raise ValueError(
            f"token id {int(ids[bad][0])} outside the vocabulary [0, {vocab})")
    return ids


def _token_body(forward_step, caches, pick, eos):
    """The step of greedy and sampled generation (reference:
    `_greedy_step`, `_greedy_eos_step`, `_sample_step`, `_sample_eos_step`,
    models/_utils.py:230-309): forward the tokens toks [b, s] at position
    pos (0-d int32), pick the next [b, 1] (`pick(logits, temp)`; temp a 0-d
    float32 tensor or None), mask it with eos and update done [b] when eos
    is set.  It advances pos (and done) in place, and at the decode shape
    (s == 1) writes the token into toks itself, so each later decode step
    is a replay with no input to copy.  Returns (next tokens, pos[,
    done])."""

    def body(toks, pos, done=None, temp=None):
        nxt = pick(forward_step(toks, caches, pos), temp).to(toks.dtype)
        if eos is not None:
            nxt, new_done = _mask_eos(nxt, done, eos)
            done.copy_(new_done)
        pos.add_(toks.shape[1])
        if toks.shape[1] == 1:
            toks.copy_(nxt)
            nxt = toks
        return (nxt, pos) if eos is None else (nxt, pos, done)

    return body


def lockstep_generate(model, input_ids, max_new_tokens, temperature,
                      forward_step, kv_heads, top_k=0, top_p=1.0,
                      decode_strategy=None, num_beams=1, seed=None,
                      eos_token_id=None, length_penalty=0.0):
    """The generation loop shared by the port's causal LMs: the counterpart
    of the reference's `compiled_generate` (models/_utils.py:160).

    forward_step(toks, caches, pos) -> last-row logits [b, V].  The prompt
    [b, s0] is prefilled at position 0 into per-layer StaticKVCaches of
    length min(max_position_embeddings, ceil128(s0 + max_new_tokens)); then
    every strategy -- greedy, sampling (the model's generator, re-seeded
    with `seed`), beam search -- feeds back one token per step at the
    device-side position.  Every step is an `inference/graphs.StepGraph`
    kept in `model._gen_fns` under the reference's keys ("greedy",
    ("greedy", eos), ("sample", top_k, top_p), ("sample", top_k, top_p,
    eos), ("beam", num_beams, eos)), one executable per input shape: a
    call traces the prefill shape and the decode shape once (`trace_count`
    2), and a repeat call of the same geometry replays them (on the card,
    CUDA graphs).  Only the eos checks wait for the device, once a token.
    Returns prompt + generated ids [b, s0 + n] (the input itself when
    nothing can be generated)."""
    from ..inference.graphs import StepGraph

    cfg = model.config
    if decode_strategy is None:
        decode_strategy = (
            "beam_search" if num_beams > 1
            else ("sampling" if temperature > 0 else "greedy_search")
        )
    if decode_strategy not in ("greedy_search", "sampling", "beam_search"):
        raise ValueError(
            f"decode_strategy must be one of 'greedy_search', 'sampling', "
            f"'beam_search'; got {decode_strategy!r}"
        )
    if decode_strategy == "beam_search" and num_beams <= 1:
        raise ValueError("beam_search requires num_beams > 1")
    if decode_strategy == "sampling" and temperature <= 0:
        raise ValueError(
            "decode_strategy='sampling' requires temperature > 0 "
            "(use greedy_search for deterministic decoding)"
        )
    b, s0 = input_ids.shape[0], input_ids.shape[1]
    # round the cache up to a multiple of 128, as the reference does, so
    # nearby lengths reuse one pair of captured steps (it also decides
    # whether the prefill takes dense_decode)
    want = min(cfg.max_position_embeddings, s0 + max_new_tokens)
    cache_len = min(cfg.max_position_embeddings, -(-want // 128) * 128)
    if s0 + max_new_tokens > cache_len:
        logging.getLogger("paddle_tpu_torch").warning(
            "generate: prompt %d + max_new_tokens %d exceeds "
            "max_position_embeddings %d; output truncated to %d new tokens",
            s0, max_new_tokens, cfg.max_position_embeddings, max(cache_len - s0, 0),
        )
    max_new_tokens = min(max_new_tokens, cache_len - s0)
    if max_new_tokens <= 0:
        return input_ids  # over-long prompt (or none asked): nothing to add
    was_training = model.training
    model.eval()  # generation is inference: no dropout, no recompute
    try:
        ids = _as_ids(input_ids, model.device, cfg.vocab_size)
        nb = num_beams if decode_strategy == "beam_search" else 1
        caches, fns = _ensure_gen_state(model, b * nb, cache_len, kv_heads)
        pos0 = torch.zeros((), dtype=torch.int32, device=model.device)
        eos = None if eos_token_id is None else int(eos_token_id)

        def graph(key, body, generators=()):
            if key not in fns:
                fns[key] = StepGraph(f"generate {key}", body, model.device,
                                     model._gen_pool, generators)
            return fns[key]

        if decode_strategy == "beam_search":
            return _beam_search(model, ids, max_new_tokens, forward_step,
                                caches, graph, nb, eos, length_penalty, pos0)
        data = {}
        if decode_strategy == "sampling":
            if seed is None:
                seed = int(np.random.randint(0, 2**31 - 1))
            gen = _generator(model)
            gen.manual_seed(int(seed))
            data["temp"] = torch.tensor(float(temperature), device=model.device)
            key, gens = ("sample", top_k, top_p), (gen,)

            def pick(logits, temp):
                return _sample_from_logits(logits, gen, temp, top_k, top_p)
        else:
            key, gens = "greedy", ()

            def pick(logits, temp):
                return logits.argmax(dim=-1, keepdim=True)

        if eos is not None:
            key = (*key, eos) if isinstance(key, tuple) else (key, eos)
            data["done"] = torch.zeros(b, dtype=torch.bool, device=model.device)
        step = graph(key, _token_body(forward_step, caches, pick, eos), gens)
        outs = step(tuple(ids.shape), toks=ids, pos=pos0, **data)
        pieces = [ids, outs[0].clone()]
        # the decode executable starts from the prefill's outputs; later
        # steps advance its static inputs themselves
        first = {**data, **dict(zip(("toks", "pos", "done"), outs))}
        for i in range(1, max_new_tokens):
            # the all-done check syncs once per token: the price of stopping
            # early; rows that finished sooner ride along emitting eos
            if eos is not None and bool(outs[2].all()):
                break
            outs = step((b, 1), **(first if i == 1 else {}))
            pieces.append(outs[0].clone())  # the output is the step's own buffer
        out = torch.cat(pieces, dim=1)
        if eos is None:
            return out
        return torch.from_numpy(_trim_eos(out.cpu().numpy(), s0, eos)).to(out.device)
    finally:
        if was_training:
            model.train()


def _beam_body(forward_step, caches, b, nb, V, eos):
    """The whole beam step (reference: `_beam_step`, models/_utils.py:
    336-373): forward toks [B, s] at pos, take the top nb of every batch
    row's nb * V continuations (finished beams continue only with eos at
    no added score), reorder the caches' rows and the sequence buffer seqs
    [B, T] to the chosen parents, and write the tokens into column ti of
    seqs.  The step index ti (0-d int32) is data, so one executable serves
    every step.  scores [b, nb], done [b, nb], seqs, ti and pos advance in
    place; at the decode shape the tokens land in toks too.  Returns
    (tokens [B, 1], pos, ti, scores, done, seqs)."""
    B = b * nb

    def body(toks, pos, ti, scores, done, seqs):
        s = toks.shape[1]
        logits = forward_step(toks, caches, pos)  # [B, V]
        logp = torch.log_softmax(logits.float(), dim=-1)
        if eos is not None:
            vocab = torch.arange(V, device=logp.device)
            eos_row = torch.where(vocab == eos, 0.0, float("-inf"))
            logp = torch.where(done.reshape(B, 1), eos_row, logp)
        total = scores.reshape(B, 1) + logp
        top_v, top_i = torch.topk(total.reshape(b, nb * V), nb, dim=-1)
        parent = top_i // V  # [b, nb], beam index within the batch row
        token = (top_i % V).to(torch.int32)
        rows = (torch.arange(b, device=toks.device)[:, None] * nb
                + parent).reshape(-1)  # [B]
        new_seqs = seqs.index_select(0, rows)
        new_seqs.index_copy_(1, ti.long().reshape(1), token.reshape(B, 1))
        new_done = done.gather(1, parent)
        if eos is not None:
            new_done = new_done | (token == eos)
        for c in (x for layer in caches
                  for x in (layer if isinstance(layer, list) else [layer])):
            _gather_rows(c.k, rows)
            _gather_rows(c.v, rows)
        seqs.copy_(new_seqs)
        scores.copy_(top_v)
        done.copy_(new_done)
        ti.add_(1)
        pos.add_(s)
        tok = token.reshape(B, 1).to(toks.dtype)
        if s == 1:
            toks.copy_(tok)
            tok = toks
        return tok, pos, ti, scores, done, seqs

    return body


def _beam_search(model, ids, max_new_tokens, forward_step, caches, graph, nb,
                 eos, length_penalty, pos0):
    """Length-normalised beam search (reference: models/_utils.py:317, after
    PaddleNLP's BeamSearchScorer): each step is one executable of
    `_beam_body`, under the key ("beam", nb, eos).  On the host at the end:
    scores / length**length_penalty pick each row's best beam."""
    b, s0 = ids.shape
    B = b * nb
    T = max_new_tokens
    dev = ids.device
    step = graph(("beam", nb, eos),
                 _beam_body(forward_step, caches, b, nb, model.config.vocab_size, eos))
    state = dict(
        toks=ids.repeat_interleave(nb, dim=0),  # [B, s0]
        pos=pos0,
        ti=torch.zeros((), dtype=torch.int32, device=dev),
        scores=torch.tensor([0.0] + [-1e9] * (nb - 1), device=dev).repeat(b, 1),
        done=torch.zeros(b, nb, dtype=torch.bool, device=dev),
        seqs=torch.zeros(B, T, dtype=torch.int32, device=dev),
    )
    outs = step(((B, s0), T), **state)
    first = dict(zip(state, outs))
    steps = 1
    for _ in range(1, T):
        if eos is not None and bool(outs[4].all()):
            break
        outs = step(((B, 1), T), **(first if steps == 1 else {}))
        steps += 1

    seqs_np = outs[5].cpu().numpy().reshape(b, nb, T)[:, :, :steps]
    scores_np = outs[3].cpu().numpy()  # [b, nb]
    if eos is not None:
        is_eos = seqs_np == eos
        lengths = np.where(is_eos.any(-1), is_eos.argmax(-1) + 1,
                           steps).astype(np.float32)
    else:
        lengths = np.full((b, nb), float(steps), np.float32)
    norm = scores_np / np.maximum(lengths, 1.0) ** length_penalty
    best = norm.argmax(-1)  # [b]
    ids_np = ids.cpu().numpy()
    out = np.concatenate([ids_np, seqs_np[np.arange(b), best]], axis=1)
    return torch.from_numpy(out.astype(ids_np.dtype)).to(dev)
