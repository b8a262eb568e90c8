"""Decoder-only causal LM (GPT-style) as ``nn.Module``s — the port of
``horovod_tpu/models/gpt.py``'s full-sequence (training) and incremental
(KV-cache, serving) paths.

Same function as the flax model, layout and numerics included:

* pre-LN decoder layers, fused QKV projection, rotary position
  embeddings, dense tanh-GELU MLP, weight-tied LM head;
* bf16 compute over fp32 parameters (``dtype``); the head multiplies
  bf16-rounded operands and accumulates in fp32;
* LayerNorm eps 1e-6 (flax's default; torch's is 1e-5), statistics in
  fp32;
* activations keep the JAX layout ``(B, S, H, D)`` at public functions.

``GPT.forward(tokens)`` is the full-sequence path: RoPE at positions
``0..S-1`` and causal attention through ``attend_fn`` — by default the
flash-attention kernels (K5 forward, K6/K7 backward) — differentiable
end to end; :func:`next_token_loss` is the training loss.
``GPT.forward(tokens, cache)`` is the incremental path (no autograd).

``GPT(tp_axis=)`` shards heads and MLP width over a tensor-parallel axis
(column-parallel fused QKV sliced by head, row-parallel output
projection, the column/row MLP pair: two allreduces a layer), and
``GPT(seq_parallel=, seq_impl=, seq_wire=)`` shards the sequence over a
sequence-parallel axis (``"ring"``: the striped causal ring, tokens in
``stripe_layout`` order; ``"ulysses"``: the head scatter, contiguous
shards, ``num_heads % n == 0``), RoPE taking this rank's GLOBAL
positions. Either way the parameters stay the dense model's replicated
tree, sliced in the forward, so one checkpoint (and the JAX converter)
serves the dense model and its tp/sp twins, and
``DistributedOptimizer(parallel=)`` combines the slice gradients. MoE
and per-layer remat come with the pipeline and MoE slice and raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from ..ops import collectives as C
from ..ops.flash_attention import flash_attention
from ._layers import LN_EPS
from ._layers import dense as _dense
from ._layers import layer_norm as _layer_norm

MASK_VALUE = -1e30          # masked attention logit (not -inf)

AttendFn = Callable[..., torch.Tensor]


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


def _causal_attend(q, k, v, mask=None):
    """The default ``attend_fn``: causal flash attention."""
    return flash_attention(q, k, v, mask=mask, causal=True)


# Sequence-parallel implementations: "ring" = the striped causal ring
# (tokens in stripe_layout order), "ulysses" = the head/sequence
# all-to-all (contiguous shards; num_heads % n == 0).
SEQ_IMPLS = ("ring", "ulysses")


def seq_attend_fn(seq_axis, seq_impl: str = "ring",
                  seq_wire: Optional[str] = None) -> AttendFn:
    """The causal ``attend_fn`` of a sequence-parallel GPT: striped ring
    attention or Ulysses head scatter over ``seq_axis``, K/V exchanges in
    ``seq_wire`` (None: the configured sequence wire)."""
    if seq_impl == "ring":
        from ..parallel.ring_attention import striped_attend_fn

        return striped_attend_fn(seq_axis, wire=seq_wire)
    if seq_impl == "ulysses":
        from ..parallel.ulysses import ulysses_attend_fn

        return ulysses_attend_fn(seq_axis, inner=_causal_attend,
                                 wire=seq_wire)
    raise ValueError(
        f"unknown seq_impl {seq_impl!r}; choose from {SEQ_IMPLS}")


def seq_positions(seq_axis, seq_impl: str, s_local: int,
                  device=None) -> torch.Tensor:
    """(1, S_local) GLOBAL positions of this rank's sequence shard —
    stripe positions for the ring, block offsets for Ulysses."""
    if seq_impl == "ring":
        from ..parallel.ring_attention import striped_positions

        return striped_positions(s_local, seq_axis, device)[None, :]
    ax = C._axis(seq_axis)
    return (ax.index * s_local
            + torch.arange(s_local, device=device))[None, :]


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


class CausalSelfAttention(nn.Module):
    """Fused-QKV multi-head attention: causal over the full sequence, or
    over the serve KV cache."""

    def __init__(self, hidden: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16, tp_axis=None,
                 seq_axis=None, seq_impl: str = "ring",
                 seq_wire: Optional[str] = None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.tp_axis = tp_axis
        self.seq_axis = seq_axis
        self.seq_impl = seq_impl
        self.seq_wire = seq_wire
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.out = nn.Linear(hidden, hidden)

    def _resolve_attend(self) -> AttendFn:
        if self.seq_axis:
            return seq_attend_fn(self.seq_axis, self.seq_impl,
                                 self.seq_wire)
        return _causal_attend

    def _forward_tp(self, x, positions, attend_fn):
        """Sharded-head attention over the tp axis: the master fused QKV
        kernel ``(h, 3h)`` (the transpose of the ``nn.Linear`` weight)
        sliced by head for q, k and v, attention on this rank's heads,
        the output projection's head rows row-parallel (one allreduce)."""
        from ..parallel import tensor_parallel as tp_lib

        b, s, h = x.shape
        ax = C._axis(self.tp_axis)
        heads_l = self.num_heads // ax.size
        head_dim = h // self.num_heads
        w3 = tp_lib.shard_heads(self.qkv.weight.t(), self.num_heads, ax,
                                fused=3)             # (h, 3, hl, hd)
        b3 = tp_lib.shard_heads(self.qkv.bias, self.num_heads, ax,
                                fused=3)             # (3, hl, hd)
        xd = x.to(self.dtype)

        def proj(i):
            w = w3[:, i].reshape(h, heads_l * head_dim)
            y = F.linear(xd, w.t().to(self.dtype),
                         b3[i].reshape(heads_l * head_dim).to(self.dtype))
            return y.reshape(b, s, heads_l, head_dim)

        q = rope(proj(0), positions)
        k = rope(proj(1), positions)
        v = proj(2)
        o = (attend_fn or self._resolve_attend())(q, k, v)
        w_loc = tp_lib.shard_head_rows(self.out.weight.t(), self.num_heads,
                                       ax)           # (hl*hd, h)
        return tp_lib.row_parallel(
            o.reshape(b, s, heads_l * head_dim), w_loc.to(self.dtype), ax,
            self.out.bias.to(self.dtype))

    def forward(self, x: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_ctx: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None,
                attend_fn: Optional[AttendFn] = None):
        """Full-sequence path (``cache=None``): RoPE at positions
        ``0..S-1``, ``attend_fn`` (causal flash by default), output
        projection. Incremental path: RoPE with each token's GLOBAL
        position, write the new K/V into their ring lines (keys stored
        already rotated, so positions survive the ring wrap), attend over
        the cache slab; returns ``(y, cache)`` with the cache updated in
        place."""
        b, s, h = x.shape
        head_dim = h // self.num_heads
        positions = None
        if cache is None and self.seq_axis:
            positions = seq_positions(self.seq_axis, self.seq_impl, s,
                                      x.device)
        if self.tp_axis:
            if cache is not None:
                raise NotImplementedError(
                    "GPT(tp_axis=) with a KV cache (tensor-parallel "
                    "decode) is not ported yet; it comes with a later "
                    "serve slice of the port")
            return self._forward_tp(x, positions, attend_fn)
        q, k, v = _dense(self.qkv, x, self.dtype).split(h, dim=-1)
        if cache is None:
            q = rope(q.reshape(b, s, self.num_heads, head_dim), positions)
            k = rope(k.reshape(b, s, self.num_heads, head_dim), positions)
            v = v.reshape(b, s, self.num_heads, head_dim)
            o = (attend_fn or self._resolve_attend())(q, k, v)
            return _dense(self.out, o.reshape(b, s, h), self.dtype)
        from ..serve import kvcache as kv_lib

        idx, q_pos, k_pos = cache_ctx
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
                 dtype: torch.dtype = torch.bfloat16, tp_axis=None,
                 seq_axis=None, seq_impl: str = "ring",
                 seq_wire: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.tp_axis = tp_axis
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = CausalSelfAttention(hidden, num_heads, dtype, tp_axis,
                                        seq_axis, seq_impl, seq_wire)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlp_in = nn.Linear(hidden, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, hidden)

    def forward(self, x, cache=None, cache_ctx=None, attend_fn=None):
        """``x`` -> ``x`` (full sequence), or ``(x, cache)`` with a
        cache."""
        y = _layer_norm(self.ln1, x, self.dtype)
        if cache is None:
            x = x + self.attn(y, attend_fn=attend_fn)
        else:
            a, cache = self.attn(y, cache, cache_ctx)
            x = x + a
        y = _layer_norm(self.ln2, x, self.dtype)
        if self.tp_axis:
            # The column/row-parallel pair over the master kernels (their
            # (in, out) views): one allreduce for the whole MLP.
            from ..parallel import tensor_parallel as tp_lib

            ax = C._axis(self.tp_axis)
            out = x + tp_lib.tp_mlp(
                y.to(self.dtype),
                tp_lib.shard_column(self.mlp_in.weight.t(),
                                    ax).to(self.dtype),
                tp_lib.shard_column(self.mlp_in.bias, ax).to(self.dtype),
                tp_lib.shard_row(self.mlp_out.weight.t(),
                                 ax).to(self.dtype),
                self.mlp_out.bias.to(self.dtype), ax)
            return out
        y = F.gelu(_dense(self.mlp_in, y, self.dtype), approximate="tanh")
        out = x + _dense(self.mlp_out, y, self.dtype)
        return out if cache is None else (out, cache)


class GPT(nn.Module):
    """Pre-LN decoder-only transformer with a weight-tied LM head.

    ``forward(tokens)`` runs the full sequence with autograd and returns
    logits fp32 (B, S, vocab); attention goes through ``attend_fn``
    (``None``: causal flash attention, the K5/K6/K7 kernels on the card;
    with ``seq_parallel``, the striped ring or Ulysses over it, whose
    blocks run those kernels). Under ``seq_parallel`` ``tokens`` is this
    rank's shard ``(B, S_local)`` (stripe order for ``seq_impl="ring"``)
    and the logits are the shard's.

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
                 attend_fn: Optional[AttendFn] = None,
                 tp_axis=None, seq_parallel=None, seq_impl: str = "ring",
                 seq_wire: Optional[str] = None,
                 moe_experts: int = 0, remat: bool = False):
        super().__init__()
        for name, value in (("moe_experts", moe_experts),
                            ("remat", remat)):
            if value:
                raise NotImplementedError(
                    f"GPT({name}=...) is not ported yet; it comes with "
                    "the pipeline and MoE slice of the port")
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(f"unknown seq_impl {seq_impl!r}; choose from "
                             f"{SEQ_IMPLS}")
        #: The tensor-parallel axis (an ``Axis`` or a mesh axis name:
        #: heads and MLP width shard over it) and the sequence-parallel
        #: axis with its implementation and K/V wire.
        self.tp_axis = tp_axis
        self.seq_parallel = seq_parallel
        self.seq_impl = seq_impl
        self.seq_wire = seq_wire
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.hidden = hidden
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.dtype = dtype
        self.attend_fn = attend_fn
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.layers = nn.ModuleList(
            DecoderLayer(hidden, num_heads, mlp_dim, dtype, tp_axis,
                         seq_parallel, seq_impl, seq_wire)
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

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the weight-tied head: bf16-rounded
        operands, fp32 accumulation and output (the JAX model's
        preferred_element_type=float32 dot)."""
        x = _layer_norm(self.final_ln, x, self.dtype)
        emb = self.tok_emb.weight.to(self.dtype).to(torch.float32)
        return torch.matmul(x.to(torch.float32), emb.t())

    def forward(self, tokens: torch.Tensor,
                cache: Optional[Dict[str, Any]] = None):
        if cache is not None:
            with torch.no_grad():
                return self._forward_cached(tokens, cache)
        x = self.tok_emb(tokens.long()).to(self.dtype)
        for layer in self.layers:
            x = layer(x, attend_fn=self.attend_fn)
        return self._head(x)

    def _forward_cached(self, tokens: torch.Tensor, cache: Dict[str, Any]):
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
        logits = self._head(x)
        cache["layers"] = layers
        cache["pos"] += s_in
        return logits, cache


def next_token_loss(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token softmax cross-entropy of fp32 ``logits`` (B, S, V)
    against ``targets`` (B, S) — the JAX package's ``pipeline_fns``
    ``loss_fn`` and its benchmark's GPT loss."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -ll.mean()


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
