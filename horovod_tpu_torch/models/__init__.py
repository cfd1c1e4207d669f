"""Models of the port (so far: GPT-2 for serving)."""

from .convert import params_from_jax  # noqa: F401
from .transformer import (GPT2_LARGE, GPT2_MEDIUM, GPT2_SMALL,  # noqa: F401
                          Transformer, TransformerConfig, create_gpt2,
                          init_gpt2_)
