"""Models of the port: GPT-2 and BERT (``transformer.py``), the ResNet
family (``resnet.py``), the MNIST-scale ``MLP`` / ``MnistCNN``
(``mlp.py``) and the flax parameter converters (``convert.py``)."""

from .convert import (mlp_params_from_jax, params_from_jax,  # noqa: F401
                      resnet_params_from_jax, shard_experts)
from .mlp import MLP, MnistCNN, create_mlp  # noqa: F401
from .resnet import (ResNet, ResNet50, ResNet101, ResNet152,  # noqa: F401
                     create_resnet50, init_kernels_)
from .transformer import (BERT_BASE, BERT_LARGE, GPT2_LARGE,  # noqa: F401
                          GPT2_MEDIUM, GPT2_SMALL, Transformer,
                          TransformerConfig, create_bert, create_gpt2,
                          init_gpt2_, lm_loss)
