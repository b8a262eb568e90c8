"""Plain fp32 BERT encoder as the ``bert_large`` configuration runs it:
learned position embeddings added to the token embedding, pre-LN blocks with
a fused QKV projection, non-causal softmax attention under the key mask, a
tanh-GELU MLP, a final LayerNorm and the masked-LM head tied to the token
embedding; LayerNorm eps ``ln_eps``; no dropout, token types, NSP or pooler.
The departures from BERT's published model are listed in
``configs/bert_large.json``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .layers import (block_specs, gelu_tanh, layer_norm, linear,
                     operand, softmax_attention)


def widths(cfg) -> dict:
    return {"layers": cfg["num_hidden_layers"], "hidden": cfg["hidden_size"],
            "heads": cfg["num_attention_heads"],
            "mlp": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "causal": False}


def param_specs(cfg) -> List[Tuple[str, tuple, str, float]]:
    w = widths(cfg)
    h, m, v = w["hidden"], w["mlp"], w["vocab"]
    specs = [("pos_emb", (cfg["max_position_embeddings"], h), "weight",
              0.02),
             ("tok_emb.weight", (v, h), "weight", h ** -0.5)]
    for i in range(w["layers"]):
        specs += block_specs(i, h, m)
    specs += [("final_ln.weight", (h,), "ln_scale", 0.0),
              ("final_ln.bias", (h,), "ln_shift", 0.0)]
    return specs


def logits(params: Dict[str, torch.Tensor], ids: torch.Tensor,
           mask: torch.Tensor, cfg, precision: str = "fp32") -> torch.Tensor:
    w = widths(cfg)
    eps, heads = cfg["ln_eps"], w["heads"]
    b, s = ids.shape
    x = params["tok_emb.weight"][ids] + params["pos_emb"][:s][None]
    h = x.shape[-1]
    for i in range(w["layers"]):
        p = lambda n: params[f"layers.{i}.{n}"]  # noqa: E731
        y = layer_norm(x, p("ln1.weight"), p("ln1.bias"), eps)
        q, k, v = linear(y, p("attn.qkv.weight"), p("attn.qkv.bias"),
                         precision).split(h, dim=-1)
        shape = (b, s, heads, h // heads)
        o = softmax_attention(q.reshape(shape), k.reshape(shape),
                              v.reshape(shape), causal=False, key_mask=mask)
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
    """The loss's divisor over a rank's batch: its MLM targets (at
    least 1)."""
    return max(float(batch["weights"].sum()), 1.0)


def loss_sum(params, batch, cfg, precision: str = "fp32") -> torch.Tensor:
    """Summed cross-entropy of a block's MLM targets."""
    z = logits(params, batch["input_ids"], batch["mask"], cfg, precision)
    ce = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                         batch["labels"].reshape(-1), reduction="none")
    return (ce * batch["weights"].reshape(-1)).sum()
