"""GPT for the PyTorch/CUDA port (counterpart of `paddle_tpu/models/gpt.py`,
BASELINE's GPT-3 13B): the configuration, the pre-norm decoder with the
GShard mixture of experts on every other layer (`moe_num_experts` > 1),
the causal LM with its loss and lock-step `generate`.

Attention takes the port's kernels: the full-sequence forward runs the
`flash_fwd` kernel (K1) and, in training, `flash_bwd` (K3); against a
`StaticKVCache` (lock-step `generate`), a prefill of 64+ rows runs
`dense_decode` (K6) and shorter chunks and decode steps
`paged_decode_fused` (K2) over the cache's page view
(`ops.flash_attention.decode_attention`), as Llama's do.  The MoE layers
are `incubate.moe.MoELayer` (dense one-hot dispatch).

Linear layers are `torch.nn.Linear` (`[out, in]`); the reference stores
`[in, out]`, so `models.convert.load_reference_state` transposes them.
The multi-card classes (tensor-parallel layers, `GPTStackedDecoder`,
`GPTForCausalLMSpmdPipe`, `GPTForCausalLMPipe`; reference :78-80,
:269-551) raise NotImplementedError: they are ROADMAP Queue 1 item 17.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..framework.core import INDEX_DTYPE, resolve_device, to_torch_dtype
from ..incubate.moe import ExpertFFN, MoELayer
from ..incubate.recompute import recompute
from ..nn import functional as F
from ..nn.common import Dropout
from ..nn.norm import LayerNorm
from ..ops.flash_attention import decode_attention
from ._utils import lockstep_generate, sequence_ce
from .llama import StaticKVCache, _cache_write

_MULTI_CARD = ("is not ported yet (ROADMAP.md Queue 1, item 17: tensor and "
               "pipeline parallelism go with the cross-card collectives)")


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 5120
    num_hidden_layers: int = 40
    num_attention_heads: int = 40
    intermediate_size: int = 20480
    max_position_embeddings: int = 2048
    layer_norm_epsilon: float = 1e-5
    attention_probs_dropout_prob: float = 0.0
    hidden_dropout_prob: float = 0.0
    tensor_parallel_degree: int = 1
    use_recompute: bool = False
    # MoE (reference :53-58): > 1 turns the MLP of every odd layer into a
    # mixture of this many experts
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_coeff: float = 0.01

    @staticmethod
    def gpt3_13b(**overrides):
        return GPTConfig(**overrides)

    @staticmethod
    def tiny(**overrides):
        base = dict(
            vocab_size=256,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=256,
            max_position_embeddings=128,
        )
        base.update(overrides)
        return GPTConfig(**base)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


class GPTAttention(nn.Module):
    """Self-attention with one fused qkv projection (reference :82-113):
    `Linear(h, 3h)` viewed as [b, s, 3, heads, head_dim], so a converted
    reference weight packs the same way."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.dropout = config.attention_probs_dropout_prob
        self.generator = generator
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = nn.Linear(h, 3 * h, **kw)
        self.out_proj = nn.Linear(h, h, **kw)

    def forward(self, x, cache=None, pos=None):
        """`cache`: None (causal self-attention over x) or a StaticKVCache
        written at `pos` (a 0-d int32 tensor or an int) and attended
        through (row i sees j <= pos + i)."""
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = (t.contiguous() for t in qkv.unbind(2))
        if isinstance(cache, StaticKVCache):
            _cache_write(cache.k, k, pos)
            _cache_write(cache.v, v, pos)
            out = decode_attention(q, cache.k, cache.v, pos, table=cache.table)
        elif cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.dropout, is_causal=True,
                training=self.training, generator=self.generator)
        else:
            raise TypeError(f"unsupported cache view {type(cache).__name__}")
        return self.out_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class GPTMLP(nn.Module):
    """fc1, tanh-approximated gelu, fc2 (reference :116-128)."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.fc1 = nn.Linear(h, i, device=device, dtype=dtype)
        self.fc2 = nn.Linear(i, h, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block (reference :131-163): x + attn(ln_1(x)), then + mlp(
    ln_2(x)), each through the hidden dropout; `use_moe` puts an MoELayer
    (top-k, capacity factor and experts from the config) in the MLP's
    place.  In training with `use_recompute`, the block runs under
    `incubate.recompute`."""

    def __init__(self, config, use_moe=False, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.config = config
        eps = config.layer_norm_epsilon
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, eps, **kw)
        self.attn = GPTAttention(config, generator=generator, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **kw)
        if use_moe:
            self.mlp = MoELayer(
                config.hidden_size, config.intermediate_size,
                num_experts=config.moe_num_experts, top_k=config.moe_top_k,
                capacity_factor=config.moe_capacity_factor, **kw)
        else:
            self.mlp = GPTMLP(config, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob, generator=generator)

    def _block(self, x, cache=None, pos=None):
        x = x + self.dropout(self.attn(self.ln_1(x), cache=cache, pos=pos))
        return x + self.dropout(self.mlp(self.ln_2(x)))

    def forward(self, x, cache=None, pos=None):
        if cache is None and self.config.use_recompute and self.training:
            return recompute(self._block, x)
        return self._block(x, cache, pos)


class GPTEmbeddings(nn.Module):
    """Word plus learned position embeddings, then the hidden dropout
    (reference :166-185); positions are int32 arange(s) + pos."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                                config.hidden_size, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, pos=None):
        positions = torch.arange(input_ids.shape[1], dtype=INDEX_DTYPE,
                                 device=input_ids.device)
        if pos is not None:
            positions = positions + pos
        x = self.word_embeddings(input_ids) + self.position_embeddings(positions)
        return self.dropout(x)


class GPTModel(nn.Module):
    """Embeddings, the decoder layers (MoE on the odd ones when
    `moe_num_experts` > 1) and the final LayerNorm (reference :187-211)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embeddings = GPTEmbeddings(config, **kw)
        moe = config.moe_num_experts > 1
        self.h = nn.ModuleList(
            [GPTDecoderLayer(config, use_moe=moe and i % 2 == 1, **kw)
             for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=device, dtype=dtype)

    def forward(self, input_ids, caches=None, pos=None):
        """input_ids: [b, s] int32; `caches`: None or one StaticKVCache per
        layer, written and attended at `pos`.  Returns the final hidden
        states [b, s, hidden]."""
        x = self.embeddings(input_ids, pos=None if caches is None else pos)
        for i, layer in enumerate(self.h):
            x = layer(x, None if caches is None else caches[i], pos)
        return self.ln_f(x)


def _refuse_multi_card(config):
    if config.tensor_parallel_degree > 1:
        raise NotImplementedError(
            f"GPT with tensor_parallel_degree={config.tensor_parallel_degree} "
            f"{_MULTI_CARD}")


class GPTForCausalLM(nn.Module):
    """GPT causal LM (reference :214-266).  `device=None` means the CUDA
    card (raises when CUDA is absent; pass device="cpu" for the plain
    PyTorch path); the model is built there in `dtype` (GPT-3 13B in bf16
    is 26.2 GB and never exists in float32 on the host).  Weights are
    random, drawn from a torch.Generator seeded with `seed` on the model's
    device (Xavier-normal Linears and expert stacks, zero biases, normal
    embeddings, LayerNorm 1 and 0); load reference weights with
    `models.convert`.  A second generator, `dropout_generator`, draws every
    dropout mask."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        _refuse_multi_card(config)
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.dropout_generator = torch.Generator(device=device).manual_seed(int(seed))
        self.gpt = GPTModel(config, device, dtype, self.dropout_generator)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False,
                                 device=device, dtype=dtype)
        self.init_weights(seed)
        self.eval()

    @property
    def device(self):
        return self.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                   generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=gen)
            elif isinstance(mod, ExpertFFN):
                mod.reset_parameters(gen)

    def moe_layers(self):
        """The MoE layers of the decoder, in order."""
        return [layer.mlp for layer in self.gpt.h if isinstance(layer.mlp, MoELayer)]

    def forward(self, input_ids, labels=None):
        """Full-sequence causal forward: logits [b, s, vocab].  With
        `labels` ([b, s] ids, -100 ignored) returns (loss, logits): the mean
        cross-entropy of `sequence_ce` at the same positions (no shift)
        plus `moe_aux_coeff` times the sum of the MoE layers' aux losses
        (reference :231-242)."""
        logits = self.lm_head(self.gpt(input_ids))
        if labels is None:
            return logits
        loss = sequence_ce(logits, labels)
        aux = [m.aux_loss for m in self.moe_layers() if m.aux_loss is not None]
        if aux:
            total = aux[0]
            for a in aux[1:]:
                total = total + a
            loss = loss + self.config.moe_aux_coeff * total
        return loss, logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16, temperature=0.0, top_k=0,
                 top_p=1.0, decode_strategy=None, num_beams=1, seed=None,
                 eos_token_id=None, length_penalty=0.0):
        """Greedy, sampling or beam search over per-layer static KV caches
        (reference :247-264, through `_utils.lockstep_generate`, every
        step a captured `StepGraph`): the prompt [b, s0] is prefilled at
        position 0 in one step (`dense_decode` for s0 >= 64), then one
        decode step per token.  Returns prompt + generated ids [b, s0 + n]
        on the model's device."""

        def forward_step(toks, caches, pos):
            hidden = self.gpt(toks, caches=caches, pos=pos)
            return self.lm_head(hidden[:, -1])

        return lockstep_generate(
            self, input_ids, max_new_tokens, temperature, forward_step,
            kv_heads=self.config.num_attention_heads, top_k=top_k, top_p=top_p,
            decode_strategy=decode_strategy, num_beams=num_beams, seed=seed,
            eos_token_id=eos_token_id, length_penalty=length_penalty,
        )


GPTForPretraining = GPTForCausalLM


class GPTStackedDecoder(nn.Module):
    """The reference's stacked-parameter decoder for SPMD pipelines
    (reference :324-461): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"GPTStackedDecoder {_MULTI_CARD}")


class GPTForCausalLMSpmdPipe(nn.Module):
    """The reference's SPMD pipeline GPT (reference :462-521): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"GPTForCausalLMSpmdPipe {_MULTI_CARD}")


class GPTForCausalLMPipe(nn.Module):
    """The reference's PipelineLayer GPT (reference :530-551): not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"GPTForCausalLMPipe {_MULTI_CARD}")
