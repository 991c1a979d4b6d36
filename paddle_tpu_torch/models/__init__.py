"""Models of the port."""

from .bert import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel)
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["BertConfig", "BertForMaskedLM", "BertForQuestionAnswering",
           "BertForSequenceClassification", "BertModel", "LlamaConfig",
           "LlamaForCausalLM"]
