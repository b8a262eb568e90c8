"""Parameter conversion from the JAX package's flax GPT to the port.

``gpt_params_from_jax`` takes the flax parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, variables)``, with or
without the top-level ``"params"`` key) and returns a ``state_dict``
for :class:`~.gpt.GPT`, so the two packages compute the same function.
This module imports no JAX: the caller hands over numpy arrays.

Layout differences handled here: flax ``nn.Dense`` kernels are
``(in, out)`` where ``nn.Linear`` weights are ``(out, in)``; flax
LayerNorm ``scale`` is ``weight``; the embedding table is the same
``(vocab, hidden)`` array under another name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _tensor(node["kernel"]).t().contiguous(),
            "bias": _tensor(node["bias"])}


def _norm(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _tensor(node["scale"]), "bias": _tensor(node["bias"])}


def gpt_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax GPT params (numpy leaves) -> the port's GPT ``state_dict``."""
    params = tree.get("params", tree)
    layer_keys = sorted((k for k in params if k.startswith("layer")),
                        key=lambda k: int(k[len("layer"):]))
    out: Dict[str, torch.Tensor] = {
        "tok_emb.weight": _tensor(params["tok_emb"]["embedding"])}
    for i, key in enumerate(layer_keys):
        node = params[key]
        if "attn" not in node or "mlp_in" not in node:
            raise ValueError(
                f"{key}: not a dense GPT decoder layer (MoE layers are "
                "not ported yet)")
        parts = {"ln1": _norm(node["LayerNorm_0"]),
                 "attn.qkv": _dense(node["attn"]["qkv"]),
                 "attn.out": _dense(node["attn"]["out"]),
                 "ln2": _norm(node["LayerNorm_1"]),
                 "mlp_in": _dense(node["mlp_in"]),
                 "mlp_out": _dense(node["mlp_out"])}
        for name, tensors in parts.items():
            for leaf, t in tensors.items():
                out[f"layers.{i}.{name}.{leaf}"] = t
    for leaf, t in _norm(params["final_ln"]).items():
        out[f"final_ln.{leaf}"] = t
    return out
