"""Decoder-only causal LM (GPT-style) as ``nn.Module``s — the port of
``horovod_tpu/models/gpt.py``'s incremental (KV-cache) path.

Same function as the flax model, layout and numerics included:

* pre-LN decoder layers, fused QKV projection, rotary position
  embeddings, dense tanh-GELU MLP, weight-tied LM head;
* bf16 compute over fp32 parameters (``dtype``); the head multiplies
  bf16-rounded operands and accumulates in fp32;
* LayerNorm eps 1e-6 (flax's default; torch's is 1e-5), statistics in
  fp32;
* activations keep the JAX layout ``(B, S, H, D)`` at public functions.

Only the cache path is ported: ``GPT.forward(tokens, cache)``. The
full-sequence forward (the flash-attention kernel's path), tensor and
sequence parallelism, MoE and remat belong to later slices of the port
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device

LN_EPS = 1e-6               # flax nn.LayerNorm's default epsilon
MASK_VALUE = -1e30          # masked attention logit (not -inf)

_TRAINING_SLICE = ("the training slice of the port (full-sequence "
                   "forward with the flash-attention kernels)")


def rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on (B, S, H, D): rotate each head-dim
    pair by a position-dependent angle, in fp32, cast back to
    ``x.dtype``. ``positions`` (B, S) defaults to ``arange(S)``."""
    b, s, h, d = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    positions = positions.to(torch.float32)
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[:, :, None] * freqs[None, None, :]   # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]                   # (B, S, 1, D/2)
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _cache_attend(q: torch.Tensor, k_all: torch.Tensor,
                  v_all: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor) -> torch.Tensor:
    """Attention of ``s_in`` new queries over the ring-buffer KV cache:
    q (B, S_in, H, D) at global positions ``q_pos`` (B, S_in);
    k_all/v_all (B, S_max, H, D) whose line j holds the token at global
    position ``k_pos[b, j]`` (-1 = empty). A line is attendable iff
    occupied AND causally visible. Softmax in fp32, masked logits at
    -1e30 — plain PyTorch, as the JAX package keeps it plain jnp."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k_all.to(torch.float32)) / math.sqrt(float(d))
    visible = ((k_pos[:, None, :] >= 0)
               & (k_pos[:, None, :] <= q_pos[:, :, None]))  # (B,S_in,S_max)
    logits = torch.where(visible[:, None], logits,
                         torch.full_like(logits, MASK_VALUE))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w,
                        v_all.to(torch.float32)).to(q.dtype)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias cast to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: statistics and scale in fp32,
    output in the compute dtype."""
    return F.layer_norm(x.to(torch.float32), ln.normalized_shape,
                        ln.weight, ln.bias, ln.eps).to(dtype)


class CausalSelfAttention(nn.Module):
    """Fused-QKV multi-head attention over the serve KV cache."""

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

    def forward(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                cache_ctx: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
        """Incremental path: RoPE with each token's GLOBAL position,
        write the new K/V into their ring lines (keys stored already
        rotated, so positions survive the ring wrap), attend over the
        cache slab. Returns ``(y, cache)``; the cache is updated in
        place."""
        from ..serve import kvcache as kv_lib

        b, s, h = x.shape
        head_dim = h // self.num_heads
        idx, q_pos, k_pos = cache_ctx
        q, k, v = _dense(self.qkv, x, self.dtype).split(h, dim=-1)
        q = rope(q.reshape(b, s, self.num_heads, head_dim), q_pos)
        k = rope(k.reshape(b, s, self.num_heads, head_dim), q_pos)
        v = v.reshape(b, s, self.num_heads, head_dim)
        cache = kv_lib.layer_write(cache, idx, k, v)
        k_all, v_all = kv_lib.layer_read(cache, torch.float32)
        o = _cache_attend(q, k_all, v_all, q_pos, k_pos).reshape(b, s, h)
        return _dense(self.out, o, self.dtype), cache


class DecoderLayer(nn.Module):
    """Pre-LN block: attention, then the dense tanh-GELU MLP."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = CausalSelfAttention(hidden, num_heads, dtype)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlp_in = nn.Linear(hidden, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, hidden)

    def forward(self, x, cache, cache_ctx):
        y = _layer_norm(self.ln1, x, self.dtype)
        a, cache = self.attn(y, cache, cache_ctx)
        x = x + a
        y = _layer_norm(self.ln2, x, self.dtype)
        y = F.gelu(_dense(self.mlp_in, y, self.dtype), approximate="tanh")
        return x + _dense(self.mlp_out, y, self.dtype), cache


class GPT(nn.Module):
    """Pre-LN decoder-only transformer with a weight-tied LM head.

    ``forward(tokens, cache)`` is the incremental mode: the ``s_in`` new
    tokens of every slot extend that slot's sequence at global positions
    ``pos .. pos + s_in``, landing in ring lines ``(pos + i) % max_len``
    — prefill (``s_in`` = prompt length) and decode (``s_in`` = 1) are
    one code path. Returns ``(logits fp32 (B, s_in, vocab), cache)``;
    the cache is updated in place (the JAX model returns a new pytree)
    and returned for the same call shape."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 12,
                 hidden: int = 768, num_heads: int = 12,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.bfloat16,
                 tp_axis: Optional[str] = None,
                 seq_parallel: Optional[str] = None,
                 moe_experts: int = 0, remat: bool = False):
        super().__init__()
        for name, value in (("tp_axis", tp_axis),
                            ("seq_parallel", seq_parallel),
                            ("moe_experts", moe_experts),
                            ("remat", remat)):
            if value:
                raise NotImplementedError(
                    f"GPT({name}=...) is not ported yet; it comes with "
                    "a later slice of the port (tensor/sequence "
                    "parallelism, MoE and remat)")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.hidden = hidden
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.layers = nn.ModuleList(
            DecoderLayer(hidden, num_heads, mlp_dim, dtype)
            for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(hidden, eps=LN_EPS)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "GPT":
        """Seeded random weights in flax's initializer scales: dense
        kernels N(0, 1/fan_in), embedding N(0, 1/hidden), zero biases,
        unit LayerNorm scales. ``generator`` must live on the
        parameters' device."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, module.in_features ** -0.5,
                                      generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        self.tok_emb.weight.normal_(0.0, self.hidden ** -0.5,
                                    generator=generator)
        return self

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None):
        if cache is None:
            raise NotImplementedError(
                "the full-sequence GPT forward is not ported yet; it "
                f"comes with {_TRAINING_SLICE}. Pass cache= for the "
                "incremental path.")
        b, s_in = tokens.shape
        x = self.tok_emb(tokens.long()).to(self.dtype)
        slot_pos = cache["slot_pos"]
        s_max = slot_pos.shape[1]
        q_pos = (cache["pos"][:, None]
                 + torch.arange(s_in, dtype=torch.int32,
                                device=tokens.device)[None, :])
        idx = (q_pos % s_max).long()
        rows = torch.arange(b, device=tokens.device)[:, None]
        slot_pos[rows, idx] = q_pos
        cache_ctx = (idx, q_pos, slot_pos)
        layers = []
        for layer, layer_cache in zip(self.layers, cache["layers"]):
            x, layer_cache = layer(x, layer_cache, cache_ctx)
            layers.append(layer_cache)
        x = _layer_norm(self.final_ln, x, self.dtype)
        # Weight-tied head: bf16-rounded operands, fp32 accumulation and
        # output (the JAX model's preferred_element_type=float32 dot).
        emb = self.tok_emb.weight.to(self.dtype).to(torch.float32)
        logits = torch.matmul(x.to(torch.float32), emb.t())
        cache["layers"] = layers
        cache["pos"] += s_in
        return logits, cache


def gpt_small(**kw) -> GPT:
    """~124M params (GPT-2 small geometry)."""
    return GPT(num_layers=12, hidden=768, num_heads=12, mlp_dim=3072,
               vocab_size=kw.pop("vocab_size", 50257), **kw)


def gpt_medium(**kw) -> GPT:
    """~350M params (GPT-2 medium geometry)."""
    return GPT(num_layers=24, hidden=1024, num_heads=16, mlp_dim=4096,
               vocab_size=kw.pop("vocab_size", 50257), **kw)


def gpt_tiny(**kw) -> GPT:
    """Test-sized decoder (every field overridable)."""
    for k, v in (("num_layers", 2), ("hidden", 64), ("num_heads", 4),
                 ("mlp_dim", 128), ("vocab_size", 128),
                 ("dtype", torch.float32)):
        kw.setdefault(k, v)
    return GPT(**kw)


def init_kv_cache(model: GPT, slots: int, max_len: int,
                  kind: str = "fp32", device=None) -> Dict[str, Any]:
    """A fresh KV cache matching ``model``'s geometry — the ``cache=``
    argument of the incremental forward. ``kind`` is ``"fp32"``
    (model-dtype storage) or ``"int8"`` (block-scaled, ~4x smaller).
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""
    from ..serve import kvcache as kv_lib

    return kv_lib.init_cache(model.num_layers, slots, max_len,
                             model.num_heads,
                             model.hidden // model.num_heads,
                             kind=kind, dtype=model.dtype,
                             device=resolve_device(device))
