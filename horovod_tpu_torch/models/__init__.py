"""Models of the port: GPT-2 and BERT (``transformer.py``) and the flax
parameter converter (``convert.py``)."""

from .convert import params_from_jax  # noqa: F401
from .transformer import (BERT_BASE, BERT_LARGE, GPT2_LARGE,  # noqa: F401
                          GPT2_MEDIUM, GPT2_SMALL, Transformer,
                          TransformerConfig, create_bert, create_gpt2,
                          init_gpt2_, lm_loss)
