"""Parameter conversion between the JAX package's flax GPT and the port.

``gpt_params_from_jax`` takes the flax parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, variables)``, with or
without the top-level ``"params"`` key) and returns a ``state_dict``
for :class:`~.gpt.GPT`, so the two packages compute the same function.
``gpt_params_to_jax`` is its inverse: a ``state_dict`` (parameters or
their gradients) as the flax ``{"params": ...}`` tree of numpy arrays,
so gradients and updated parameters compare leaf by leaf. This module
imports no JAX: numpy arrays cross the boundary.

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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def gpt_params_to_jax(state: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The port's GPT ``state_dict`` (or a name -> gradient mapping of
    the same keys) -> the flax ``{"params": ...}`` tree, numpy leaves."""
    layers = sorted({int(k.split(".")[1]) for k in state
                     if k.startswith("layers.")})
    params: Dict[str, Any] = {
        "tok_emb": {"embedding": _np(state["tok_emb.weight"])},
        "final_ln": {"scale": _np(state["final_ln.weight"]),
                     "bias": _np(state["final_ln.bias"])}}

    def dense(prefix):
        return {"kernel": _np(state[prefix + ".weight"]).T.copy(),
                "bias": _np(state[prefix + ".bias"])}

    def norm(prefix):
        return {"scale": _np(state[prefix + ".weight"]),
                "bias": _np(state[prefix + ".bias"])}

    for i in layers:
        p = f"layers.{i}"
        params[f"layer{i}"] = {
            "LayerNorm_0": norm(p + ".ln1"),
            "attn": {"qkv": dense(p + ".attn.qkv"),
                     "out": dense(p + ".attn.out")},
            "LayerNorm_1": norm(p + ".ln2"),
            "mlp_in": dense(p + ".mlp_in"),
            "mlp_out": dense(p + ".mlp_out")}
    return {"params": params}
