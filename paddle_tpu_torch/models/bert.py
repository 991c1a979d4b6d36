"""BERT for the PyTorch/CUDA port (counterpart of
`paddle_tpu/models/bert.py`): the configuration, embeddings, encoder and
the question-answering (SQuAD), sequence-classification and masked-LM
heads.

A `[b, s]` padding `attention_mask` becomes segment ids (`to_segs`): valid
tokens share id 0, pad position i gets i + 1 and so sees only itself.
Every layer's attention then runs the `flash_fwd` kernel and, in training,
`flash_bwd`, with those ids (`nn.MultiHeadAttention` ->
`ops.flash_attention.sdpa`).  Pad rows carry hidden states nobody reads;
the QA head masks their span logits.

Linear layers are `torch.nn.Linear` (`[out, in]`); the reference stores
`[in, out]`, so `models.convert.load_reference_state` transposes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..framework.core import INDEX_DTYPE, resolve_device, to_torch_dtype
from ..nn import functional as F
from ..nn.common import Dropout
from ..nn.norm import LayerNorm
from ..nn.transformer import MultiHeadAttention


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def bert_base(**overrides):
        return BertConfig(**overrides)

    @staticmethod
    def tiny(**overrides):
        base = dict(
            vocab_size=256,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )
        base.update(overrides)
        return BertConfig(**base)


def to_segs(attention_mask):
    """A [b, s] padding mask (nonzero: a token) -> [b, s] int32 segment ids
    (reference: bert.py:107-110): valid tokens 0, pad position i gets i + 1,
    so a pad row attends only to itself and no valid row sees it."""
    valid = attention_mask.to(torch.int32) > 0
    pos = torch.arange(attention_mask.shape[-1], dtype=INDEX_DTYPE,
                       device=attention_mask.device)
    return torch.where(valid, 0, pos + 1).to(INDEX_DTYPE)


class BertEmbeddings(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h, **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob, generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], dtype=INDEX_DTYPE,
                           device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertEncoderLayer(nn.Module):
    """Post-norm layer (reference: bert.py:64-81): attention with segment
    ids, add and LayerNorm, GELU feed-forward, add and LayerNorm."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.attn = MultiHeadAttention(h, config.num_attention_heads,
                                       dropout=config.attention_probs_dropout_prob,
                                       generator=generator, **kw)
        self.linear1 = nn.Linear(h, config.intermediate_size, **kw)
        self.linear2 = nn.Linear(config.intermediate_size, h, **kw)
        self.norm1 = LayerNorm(h, config.layer_norm_eps, **kw)
        self.norm2 = LayerNorm(h, config.layer_norm_eps, **kw)
        self.dropout1 = Dropout(config.hidden_dropout_prob, generator=generator)
        self.dropout2 = Dropout(config.hidden_dropout_prob, generator=generator)

    def forward(self, x, attn_mask=None, segment_ids=None):
        x = self.norm1(x + self.dropout1(
            self.attn(x, attn_mask=attn_mask, segment_ids=segment_ids)))
        ff = self.linear2(F.gelu(self.linear1(x)))
        return self.norm2(x + self.dropout2(ff))


class BertModel(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype, generator)
        self.encoder = nn.ModuleList(
            [BertEncoderLayer(config, device, dtype, generator)
             for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                device=device, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """input_ids: [b, s] int32; `attention_mask`: [b, s], nonzero on
        tokens.  Returns (sequence output [b, s, hidden], pooled output [b,
        hidden]: tanh of the pooler on position 0)."""
        segs = None if attention_mask is None else to_segs(attention_mask)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, segment_ids=segs)
        return x, torch.tanh(self.pooler(x[:, 0]))


class _BertHead(nn.Module):
    """What the three heads share: the device, dtype and seed of a port
    model, the weights drawn from a torch.Generator seeded with `seed` (the
    reference's defaults: Xavier-normal Linears and embeddings, zero biases,
    LayerNorm 1 and 0), and a second generator, `dropout_generator`, for
    every dropout mask.  `device=None` means the CUDA card (raises when CUDA
    is absent; pass device="cpu" for the plain PyTorch path)."""

    def _setup(self, config, device, dtype, seed):
        device = resolve_device(device)
        self.config = config
        self.dropout_generator = torch.Generator(device=device).manual_seed(int(seed))
        self.bert = BertModel(config, device, to_torch_dtype(dtype),
                              self.dropout_generator)
        return dict(device=device, dtype=to_torch_dtype(dtype))

    @property
    def device(self):
        return self.bert.pooler.weight.device

    @torch.no_grad()
    def init_weights(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                rows, cols = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (rows + cols)), generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()


class BertForQuestionAnswering(_BertHead):
    """SQuAD head (reference: bert.py:120-152): start and end logits per
    position; with `attention_mask`, pad positions' logits are -1e30; with
    `start_positions` and `end_positions` ([b] ids), returns (loss, start,
    end), the loss the mean of the two cross-entropies."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        kw = self._setup(config, device, dtype, seed)
        self.classifier = nn.Linear(config.hidden_size, 2, **kw)
        self.init_weights(seed)
        self.eval()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                start_positions=None, end_positions=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        start_logits, end_logits = self.classifier(seq).unbind(2)
        if attention_mask is not None:
            live = attention_mask.to(torch.int32) > 0
            start_logits = torch.where(live, start_logits, -1e30)
            end_logits = torch.where(live, end_logits, -1e30)
        if start_positions is not None:
            loss = (F.cross_entropy(start_logits, start_positions)
                    + F.cross_entropy(end_logits, end_positions)) / 2
            return loss, start_logits, end_logits
        return start_logits, end_logits


class BertForSequenceClassification(_BertHead):
    """Classification over the pooled output (reference: bert.py:155-166);
    with `labels`, returns (loss, logits)."""

    def __init__(self, config, num_classes=2, device=None, dtype=torch.float32,
                 seed=0):
        super().__init__()
        kw = self._setup(config, device, dtype, seed)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=self.dropout_generator)
        self.classifier = nn.Linear(config.hidden_size, num_classes, **kw)
        self.init_weights(seed)
        self.eval()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.classifier(self.dropout(pooled))
        if labels is not None:
            return F.cross_entropy(logits, labels), logits
        return logits


class BertForMaskedLM(_BertHead):
    """Masked-LM head (reference: bert.py:169-185): Linear, GELU,
    LayerNorm, the vocabulary projection; with `labels` ([b, s], -100
    ignored), returns (loss, logits)."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        kw = self._setup(config, device, dtype, seed)
        h = config.hidden_size
        self.transform = nn.Linear(h, h, **kw)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, **kw)
        self.decoder = nn.Linear(h, config.vocab_size, **kw)
        self.init_weights(seed)
        self.eval()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.decoder(self.layer_norm(F.gelu(self.transform(seq))))
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels.reshape(-1), ignore_index=-100)
            return loss, logits
        return logits
