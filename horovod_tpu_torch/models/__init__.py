"""Models of the port: the GPT incremental path and the flax-tree
converter."""

from .convert import gpt_params_from_jax
from .gpt import (GPT, CausalSelfAttention, DecoderLayer, gpt_medium,
                  gpt_small, gpt_tiny, init_kv_cache, rope)

__all__ = ["GPT", "CausalSelfAttention", "DecoderLayer", "gpt_medium",
           "gpt_params_from_jax", "gpt_small", "gpt_tiny",
           "init_kv_cache", "rope"]
