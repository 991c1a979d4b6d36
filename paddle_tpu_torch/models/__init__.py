"""Models of the port."""

from .bert import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel)
from .gpt import (GPTConfig, GPTForCausalLM, GPTForCausalLMPipe,
                  GPTForCausalLMSpmdPipe, GPTForPretraining, GPTModel,
                  GPTStackedDecoder)
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["BertConfig", "BertForMaskedLM", "BertForQuestionAnswering",
           "BertForSequenceClassification", "BertModel", "GPTConfig",
           "GPTForCausalLM", "GPTForCausalLMPipe", "GPTForCausalLMSpmdPipe",
           "GPTForPretraining", "GPTModel", "GPTStackedDecoder", "LlamaConfig",
           "LlamaForCausalLM"]
