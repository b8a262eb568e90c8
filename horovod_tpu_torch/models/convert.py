"""Parameter conversion between the JAX package's flax models and the
port's.

``gpt_params_from_jax`` takes the flax parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, variables)``, with or
without the top-level ``"params"`` key) and returns a ``state_dict``
for :class:`~.gpt.GPT`, so the two packages compute the same function.
``gpt_params_to_jax`` is its inverse: a ``state_dict`` (parameters or
their gradients) as the flax ``{"params": ...}`` tree of numpy arrays,
so gradients and updated parameters compare leaf by leaf. Both carry a
GPT-MoE layer's ``moe`` leaves; ``gpt_stage_params_from_jax`` takes the
JAX pipeline's stacked stage layout into one stage's ``state_dict``.
This module imports no JAX: numpy arrays cross the boundary.

Layout differences handled here: flax ``nn.Dense`` kernels are
``(in, out)`` where ``nn.Linear`` weights are ``(out, in)``; flax
LayerNorm ``scale`` is ``weight``; the embedding table is the same
``(vocab, hidden)`` array under another name.

Every pair (``gpt_``, ``bert_``, ``vit_``, ``resnet_``, ``vgg_``,
``inception_`` and ``mlp_params_from_jax`` / ``..._to_jax``; the ``mlp``
pair serves :class:`~.mlp.MLP` and :class:`~.mlp.ConvNet`) renames
module paths by a table of rules, one per family, and converts leaves
the same way in every family: a Dense kernel is transposed, a conv kernel
``(kh, kw, in, out)`` becomes ``(out, in, kh, kw)``, a norm's ``scale``
becomes ``weight``, and ``batch_stats`` ``mean``/``var`` become the
``running_mean``/``running_var`` buffers (the ``to_jax`` side returns
them under ``"batch_stats"``). A bare top-level parameter (``pos_emb``,
``cls``, ``pos_embed``) keeps its name and shape. Every round trip is
exact.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


# -- module names renamed by a family's rules --------------------------------

# (flax module name, port module path); "{i}" stands for a decimal index.
# A module name no rule matches keeps its name.
Rules = Sequence[Tuple[str, str]]

_GPT: Rules = (("layer{i}", "layers.{i}"), ("LayerNorm_0", "ln1"),
               ("LayerNorm_1", "ln2"))
_BLOCK = (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2"),
          ("Dense_0", "mlp_in"), ("Dense_1", "mlp_out"))
_BERT: Rules = (("layer_{i}", "layers.{i}"),) + _BLOCK
_VIT: Rules = (("layer{i}", "layers.{i}"),) + _BLOCK
_RESNET: Rules = (("BottleneckBlock_{i}", "blocks.{i}"),
                  ("Conv_0", "conv1"), ("Conv_1", "conv2"),
                  ("Conv_2", "conv3"), ("BatchNorm_0", "bn1"),
                  ("BatchNorm_1", "bn2"), ("BatchNorm_2", "bn3"))
_INCEPTION: Rules = (("ConvBN_{i}", "convs.{i}"),
                     ("InceptionA_{i}", "inception_a.{i}"),
                     ("InceptionB_{i}", "inception_b.{i}"),
                     ("InceptionC_{i}", "inception_c.{i}"),
                     ("InceptionD_{i}", "inception_d.{i}"),
                     ("InceptionE_{i}", "inception_e.{i}"),
                     ("Conv_0", "conv"), ("BatchNorm_0", "bn"))
_VGG: Rules = ()
_MLP: Rules = (("Dense_{i}", "layers.{i}"), ("Conv_{i}", "convs.{i}"))

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_STAT_FLAX = {v: k for k, v in _STAT_LEAF.items()}


def _pattern(p: str) -> "re.Pattern":
    return re.compile(re.escape(p).replace(re.escape("{i}"), r"(\d+)"))


def _to_port_path(mods: Sequence[str], rules: Rules) -> str:
    parts = []
    for m in mods:
        for flax_p, port_p in rules:
            hit = _pattern(flax_p).fullmatch(m)
            if hit:
                parts.append(port_p.format(i=hit.group(1)) if hit.groups()
                             else port_p)
                break
        else:
            parts.append(m)
    return ".".join(parts)


def _to_flax_path(segs: Sequence[str], rules: Rules) -> List[str]:
    out, pos = [], 0
    while pos < len(segs):
        for flax_p, port_p in rules:
            want = port_p.split(".")
            got = segs[pos:pos + len(want)]
            hits = [_pattern(w).fullmatch(g) for w, g in zip(want, got)]
            if len(got) == len(want) and all(hits):
                index = [h.group(1) for h in hits if h.groups()]
                out.append(flax_p.format(i=index[0]) if index else flax_p)
                pos += len(want)
                break
        else:
            out.append(segs[pos])
            pos += 1
    return out


def _leaves(node: Mapping[str, Any], path=()):
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _from_jax(tree: Mapping[str, Any], rules: Rules
              ) -> Dict[str, torch.Tensor]:
    params = tree.get("params", tree)
    stats = tree.get("batch_stats", {}) if "params" in tree else {}
    out: Dict[str, torch.Tensor] = {}
    for names, node in ((_PARAM_LEAF, params), (_STAT_LEAF, stats)):
        for (*mods, leaf), a in _leaves(node):
            a = np.asarray(a, dtype=np.float32)
            if not mods:                    # a bare top-level parameter
                out[leaf] = _tensor(a)
                continue
            if leaf == "kernel":
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            out[f"{_to_port_path(mods, rules)}.{names[leaf]}"] = \
                _tensor(np.ascontiguousarray(a))
    return out


def _to_jax(state: Mapping[str, torch.Tensor], rules: Rules,
            embeddings: Sequence[str] = ()) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"params": {}}
    for key, t in state.items():
        *segs, name = key.split(".")
        a = _np(t)
        coll, leaf = "params", name
        if name in _STAT_FLAX:
            coll, leaf = "batch_stats", _STAT_FLAX[name]
        elif segs and name == "weight":
            if a.ndim == 1:
                leaf = "scale"
            elif segs[-1] in embeddings:
                leaf = "embedding"
            else:
                leaf = "kernel"
                a = (a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)).copy()
        node = tree.setdefault(coll, {})
        for m in _to_flax_path(segs, rules):
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def _pair(family: str, rules: Rules, embeddings: Sequence[str] = ()
          ) -> Tuple[Callable, Callable]:
    def from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        return _from_jax(tree, rules)

    def to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return _to_jax(state, rules, embeddings)

    from_jax.__name__ = f"{family}_params_from_jax"
    from_jax.__doc__ = (f"flax {family} variables (numpy leaves; with or "
                        f"without the ``params`` key) -> the port's "
                        f"``state_dict``.")
    to_jax.__name__ = f"{family}_params_to_jax"
    to_jax.__doc__ = (f"The port's {family} ``state_dict`` (or a name -> "
                      f"gradient mapping) -> the flax ``{{\"params\": ..., "
                      f"\"batch_stats\": ...}}`` tree, numpy leaves.")
    return from_jax, to_jax


_gpt_from_jax, gpt_params_to_jax = _pair("gpt", _GPT, ("tok_emb",))


# MoeMlp's parameters keep their flax names and layouts: gate (h, E),
# w_in (E, h, mlp), b_in (E, mlp), w_out (E, mlp, h), b_out (E, h).
_MOE_LEAVES = ("gate", "w_in", "b_in", "w_out", "b_out")


def gpt_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax GPT params (numpy leaves) -> the port's GPT ``state_dict``;
    an MoE layer's ``moe`` leaves are carried as they are."""
    params = dict(tree.get("params", tree))
    moe = {}
    for key, node in list(params.items()):
        if not key.startswith("layer"):
            continue
        if "attn" not in node or not ("mlp_in" in node or "moe" in node):
            raise ValueError(f"{key}: not a GPT decoder layer")
        if "moe" in node:
            node = dict(node)
            for leaf, a in node.pop("moe").items():
                if leaf not in _MOE_LEAVES:
                    raise ValueError(f"{key}/moe: unknown leaf {leaf!r}")
                moe[f"{_to_port_path([key], _GPT)}.moe.{leaf}"] = _tensor(a)
            params[key] = node
    out = _gpt_from_jax(params)
    out.update(moe)
    return out


def gpt_stage_params_from_jax(stages: Mapping[str, Any],
                              shared: Mapping[str, Any], stage: int
                              ) -> Dict[str, torch.Tensor]:
    """The JAX pipeline layout (``models.gpt.stack_stage_params``:
    ``stages`` with leaves ``(num_stages, layers_per_stage, ...)``,
    ``shared`` the ``tok_emb``/``final_ln`` tree; numpy leaves) -> the
    ``state_dict`` of pipeline stage ``stage``: a port GPT built with
    ``layers_per_stage`` layers, its layers ``layers.0..`` the stage's."""
    def pick(node, j):
        return {k: pick(v, j) if isinstance(v, Mapping)
                else np.asarray(v)[stage, j] for k, v in node.items()}

    first = next(iter(_leaves(stages)))[1]
    lps = np.asarray(first).shape[1]
    tree = {f"layer{j}": pick(stages, j) for j in range(lps)}
    tree.update(shared)
    return gpt_params_from_jax(tree)


bert_params_from_jax, bert_params_to_jax = _pair("bert", _BERT, ("tok_emb",))
vit_params_from_jax, vit_params_to_jax = _pair("vit", _VIT)
resnet_params_from_jax, resnet_params_to_jax = _pair("resnet", _RESNET)
vgg_params_from_jax, vgg_params_to_jax = _pair("vgg", _VGG)
inception_params_from_jax, inception_params_to_jax = _pair("inception",
                                                           _INCEPTION)
mlp_params_from_jax, mlp_params_to_jax = _pair("mlp", _MLP)
