"""Plain fp32 GPT as the ``gpt2_medium`` configuration runs it: pre-LN
decoder blocks with a fused QKV projection, rotary embeddings on q and k
(GPT-NeoX's half-split rotation, base ``rope_base``), causal softmax
attention, a tanh-GELU MLP, a final LayerNorm and the head tied to the token
embedding; LayerNorm eps ``ln_eps``; no dropout. The departures from
GPT-2's published model are listed in ``configs/gpt2_medium.json``.
Parameters are a dict of tensors named as ``param_specs`` gives them."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .layers import (block_specs, gelu_tanh, layer_norm, linear,
                     operand, softmax_attention)


def widths(cfg) -> dict:
    return {"layers": cfg["n_layer"], "hidden": cfg["n_embd"],
            "heads": cfg["n_head"], "mlp": cfg["n_inner"],
            "vocab": cfg["vocab_size"], "causal": True}


def param_specs(cfg) -> List[Tuple[str, tuple, str, float]]:
    """``(name, shape, kind, std)``: ``kind`` is ``weight`` (N(0, std²)),
    ``bias``, ``ln_scale`` or ``ln_shift``."""
    w = widths(cfg)
    h, m, v = w["hidden"], w["mlp"], w["vocab"]
    specs = [("tok_emb.weight", (v, h), "weight", h ** -0.5)]
    for i in range(w["layers"]):
        specs += block_specs(i, h, m)
    specs += [("final_ln.weight", (h,), "ln_scale", 0.0),
              ("final_ln.bias", (h,), "ln_shift", 0.0)]
    return specs


def rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate the (i, i + D/2) pairs of each head by position x
    base^(-2i/D), positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = base ** (-torch.arange(half, dtype=x.dtype, device=x.device)
                   * 2.0 / d)
    ang = torch.arange(s, dtype=x.dtype, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def logits(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
           precision: str = "fp32") -> torch.Tensor:
    w = widths(cfg)
    eps, heads = cfg["ln_eps"], w["heads"]
    x = params["tok_emb.weight"][tokens]
    b, s, h = x.shape
    for i in range(w["layers"]):
        p = lambda n: params[f"layers.{i}.{n}"]  # noqa: E731
        y = layer_norm(x, p("ln1.weight"), p("ln1.bias"), eps)
        q, k, v = linear(y, p("attn.qkv.weight"), p("attn.qkv.bias"),
                         precision).split(h, dim=-1)
        shape = (b, s, heads, h // heads)
        q = rotary(q.reshape(shape), cfg["rope_base"])
        k = rotary(k.reshape(shape), cfg["rope_base"])
        o = softmax_attention(q, k, v.reshape(shape), causal=True)
        x = x + linear(o.reshape(b, s, h), p("attn.out.weight"),
                       p("attn.out.bias"), precision)
        y = layer_norm(x, p("ln2.weight"), p("ln2.bias"), eps)
        y = gelu_tanh(linear(y, p("mlp_in.weight"), p("mlp_in.bias"),
                             precision))
        x = x + linear(y, p("mlp_out.weight"), p("mlp_out.bias"), precision)
    x = layer_norm(x, params["final_ln.weight"], params["final_ln.bias"], eps)
    return operand(x, precision) @ operand(params["tok_emb.weight"],
                                           precision).t()


def loss_count(batch) -> float:
    """The loss's divisor over a rank's batch: every predicted token."""
    t = batch["tokens"]
    return float(t.shape[0] * (t.shape[1] - 1))


def loss_sum(params, batch, cfg, precision: str = "fp32") -> torch.Tensor:
    """Summed next-token cross-entropy of a block of rows."""
    t = batch["tokens"]
    z = logits(params, t[:, :-1], cfg, precision)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]), t[:, 1:].reshape(-1),
                           reduction="sum")
