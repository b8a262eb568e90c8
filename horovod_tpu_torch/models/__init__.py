"""Models of the port: GPT (full-sequence training and incremental
serving paths) and the flax-tree converters."""

from .convert import gpt_params_from_jax, gpt_params_to_jax
from .gpt import (GPT, CausalSelfAttention, DecoderLayer, gpt_medium,
                  gpt_small, gpt_tiny, init_kv_cache, next_token_loss, rope)

__all__ = ["GPT", "CausalSelfAttention", "DecoderLayer", "gpt_medium",
           "gpt_params_from_jax", "gpt_params_to_jax", "gpt_small",
           "gpt_tiny", "init_kv_cache", "next_token_loss", "rope"]


# The JAX package's other models come with later slices of the port.
_LATER = ("bert_base", "bert_large", "bert_tiny", "InceptionV3", "MLP",
          "ConvNet", "ResNet", "ResNet50", "ResNet101", "ResNet152", "VGG",
          "VGG11", "VGG13", "VGG16", "VGG19", "ViT", "vit_base", "vit_tiny")


def __getattr__(name):
    if name not in _LATER:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    raise NotImplementedError(
        f"horovod_tpu_torch.models.{name} is not ported yet; it comes with "
        "the models slice of the port (BERT-large training on the same "
        "K5-K7 kernels, then ResNet, VGG, Inception and ViT)")
