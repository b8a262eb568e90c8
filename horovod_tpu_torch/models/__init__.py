"""Models of the port, each the counterpart of the JAX package's model of
the same name, with its flax-tree converter pair in ``convert``: GPT
(full-sequence training and incremental serving paths), BERT, ViT,
ResNet, VGG, Inception V3, MLP and ConvNet. Image models take NCHW
tensors. The GPT pipeline helpers (``pipeline_fns``,
``stack_stage_params``, ``param_bytes``, ``activation_bytes``) live in
``models.gpt``."""

from .bert import Bert, bert_base, bert_large, bert_tiny, mlm_loss
from .convert import (bert_params_from_jax, bert_params_to_jax,
                      gpt_params_from_jax, gpt_params_to_jax,
                      inception_params_from_jax, inception_params_to_jax,
                      mlp_params_from_jax, mlp_params_to_jax,
                      resnet_params_from_jax, resnet_params_to_jax,
                      vgg_params_from_jax, vgg_params_to_jax,
                      vit_params_from_jax, vit_params_to_jax)
from .gpt import (GPT, CausalSelfAttention, DecoderLayer, MoeMlp,
                  gpt_medium, gpt_small, gpt_tiny, init_kv_cache,
                  next_token_loss, rope)
from .inception import InceptionV3
from .mlp import MLP, ConvNet
from .resnet import ResNet, ResNet50, ResNet101, ResNet152
from .vgg import VGG, VGG11, VGG13, VGG16, VGG19
from .vit import ViT, vit_base, vit_tiny

__all__ = ["Bert", "CausalSelfAttention", "ConvNet", "DecoderLayer", "GPT",
           "InceptionV3", "MLP", "MoeMlp", "ResNet", "ResNet101", "ResNet152",
           "ResNet50", "VGG", "VGG11", "VGG13", "VGG16", "VGG19", "ViT",
           "bert_base", "bert_large", "bert_params_from_jax",
           "bert_params_to_jax", "bert_tiny", "gpt_medium",
           "gpt_params_from_jax", "gpt_params_to_jax", "gpt_small",
           "gpt_tiny", "inception_params_from_jax",
           "inception_params_to_jax", "init_kv_cache", "mlm_loss",
           "mlp_params_from_jax", "mlp_params_to_jax", "next_token_loss",
           "resnet_params_from_jax", "resnet_params_to_jax", "rope",
           "vgg_params_from_jax", "vgg_params_to_jax", "vit_base",
           "vit_params_from_jax", "vit_params_to_jax", "vit_tiny"]
