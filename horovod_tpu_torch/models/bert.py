"""BERT encoder — the port of ``horovod_tpu/models/bert.py`` (BERT-large
pretraining, the JAX package's second benchmark workload).

Same function as the flax model, numerics included: pre-LN layers with a
fused QKV projection, non-causal attention over a ``(B, S)`` key mask
through ``attend_fn`` (default :func:`~..ops.flash_attention.attend`, the
flash kernels K5/K6/K7 on the card), the tanh-GELU MLP, learned position
embeddings (``pos_emb``, a bare ``(max_len, hidden)`` parameter), and a
masked-LM head tied to the token embedding. bf16 compute over fp32
parameters; the embedding is looked up in fp32 and cast; LayerNorm eps
1e-6 with fp32 statistics; the head multiplies bf16-rounded operands in
fp32, which is exact, as the JAX model's ``dot_general`` with an fp32
output is. No dropout, as in the JAX model.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..common import metrics as metrics_lib
from ..ops.flash_attention import attend as default_attend
from ._layers import LN_EPS, dense, init_weights, layer_norm

AttendFn = Callable[..., torch.Tensor]


class SelfAttention(nn.Module):
    """Fused-QKV multi-head attention, non-causal, under a key mask."""

    def __init__(self, hidden: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attend_fn: Optional[AttendFn] = None) -> torch.Tensor:
        b, s, h = x.shape
        shape = (b, s, self.num_heads, h // self.num_heads)
        q, k, v = (t.reshape(shape) for t in
                   dense(self.qkv, x, self.dtype).split(h, dim=-1))
        o = (attend_fn or default_attend)(q, k, v, mask)
        return dense(self.out, o.reshape(b, s, h), self.dtype)


class TransformerLayer(nn.Module):
    """Pre-LN block: attention, then the dense tanh-GELU MLP (also the
    block of :class:`~.vit.ViT`)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = SelfAttention(hidden, num_heads, dtype)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlp_in = nn.Linear(hidden, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                attend_fn: Optional[AttendFn] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.ln1, x, self.dtype), mask,
                          attend_fn)
        y = layer_norm(self.ln2, x, self.dtype)
        y = F.gelu(dense(self.mlp_in, y, self.dtype), approximate="tanh")
        return x + dense(self.mlp_out, y, self.dtype)


class Bert(nn.Module):
    """BERT encoder with the tied masked-LM head: ``forward(input_ids,
    mask=None, positions=None)`` returns fp32 logits ``(B, S, vocab)``.
    ``mask`` is a ``(B, S)`` key mask (nonzero = attend); ``positions``
    (B, S) overrides the position ids ``0..S-1``."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 1024,
                 num_layers: int = 24, num_heads: int = 16,
                 mlp_dim: int = 4096, max_len: int = 512,
                 dtype: torch.dtype = torch.bfloat16,
                 attend_fn: Optional[AttendFn] = None):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.max_len = max_len
        self.dtype = dtype
        self.attend_fn = attend_fn
        self.tok_emb = nn.Embedding(vocab_size, hidden_size)
        self.pos_emb = nn.Parameter(torch.zeros(max_len, hidden_size))
        self.layers = nn.ModuleList(
            TransformerLayer(hidden_size, num_heads, mlp_dim, dtype)
            for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(hidden_size, eps=LN_EPS)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Bert":
        """Seeded random weights in flax's initializer scales
        (``pos_emb`` N(0, 0.02²)); ``generator`` lives on the parameters'
        device."""
        init_weights(self, generator)
        self.pos_emb.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        with metrics_lib.span("hvd.model.forward"):
            x = self.tok_emb(input_ids.long()).to(self.dtype)
            if positions is None:
                pe = self.pos_emb[None, :x.shape[1]]
            else:
                pe = self.pos_emb[positions.long()]
            x = x + pe.to(self.dtype)
            for layer in self.layers:
                x = layer(x, mask, self.attend_fn)
            x = layer_norm(self.final_ln, x, self.dtype)
            emb = self.tok_emb.weight.to(self.dtype).to(torch.float32)
            return torch.matmul(x.to(torch.float32), emb.t())


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Masked-LM loss: softmax cross-entropy of fp32 ``logits`` against
    ``labels`` (B, S), averaged over the positions where ``weights`` is
    nonzero — the JAX package's benchmark BERT loss."""
    with metrics_lib.span("hvd.model.loss"):
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        per_tok = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
        w = weights.to(torch.float32)
        return (per_tok * w).sum() / w.sum().clamp_min(1.0)


def bert_large(**kw) -> Bert:
    return Bert(hidden_size=1024, num_layers=24, num_heads=16,
                mlp_dim=4096, **kw)


def bert_base(**kw) -> Bert:
    return Bert(hidden_size=768, num_layers=12, num_heads=12,
                mlp_dim=3072, **kw)


def bert_tiny(**kw) -> Bert:
    """For tests. Any field (``max_len`` included) is overridable."""
    cfg = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
               mlp_dim=128, max_len=128)
    cfg.update(kw)
    return Bert(**cfg)
