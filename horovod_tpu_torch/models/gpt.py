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
projection, the column/row MLP pair: two allreduces a layer) — on the
incremental path too, over a cache holding this rank's heads
(:func:`init_kv_cache`), which is tensor-parallel decode — and
``GPT(seq_parallel=, seq_impl=, seq_wire=)`` shards the sequence over a
sequence-parallel axis (``"ring"``: the striped causal ring, tokens in
``stripe_layout`` order; ``"ulysses"``: the head scatter, contiguous
shards, ``num_heads % n == 0``), RoPE taking this rank's GLOBAL
positions. Either way the parameters stay the dense model's replicated
tree, sliced in the forward, so one checkpoint (and the JAX converter)
serves the dense model and its tp/sp twins, and
``DistributedOptimizer(parallel=)`` combines the slice gradients.

``GPT(moe_experts=E, moe_axis=, moe_route=, moe_wire=, ...)`` swaps each
layer's dense MLP for :class:`MoeMlp` (GShard top-2 over an expert-
parallel world, ``parallel/moe.py``); ``GPT(remat=True)`` runs each
decoder layer under ``torch.utils.checkpoint`` (non-reentrant): its
activations are recomputed in the backward, the values unchanged.

The pipeline helpers: :func:`stack_stage_params` splits a GPT state dict
into per-stage layer dicts and the shared ``tok_emb``/``final_ln``;
:func:`pipeline_fns` gives the ``(stage_fn, pre_fn, loss_fn)`` closures
``parallel.pipeline.pipeline_accumulate_gradients`` takes, for a stage
model (a GPT built with the stage's layer count: each pipeline rank
holds only its own layers); :func:`param_bytes` and
:func:`activation_bytes` are the JAX package's memory accounting.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..common import metrics as metrics_lib
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

    def _forward_tp(self, x, positions, attend_fn, cache=None,
                    cache_ctx=None):
        """Sharded-head attention over the tp axis: the master fused QKV
        kernel ``(h, 3h)`` (the transpose of the ``nn.Linear`` weight)
        sliced by head for q, k and v, attention on this rank's heads,
        the output projection's head rows row-parallel (one allreduce).
        With a cache (the serve path) the cache is this rank's head
        shard: q and k rotate with each token's global position, k/v
        land in the shard's ring lines and the local heads attend over
        it; returns ``(y, cache)``."""
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

        if cache is None:
            q = rope(proj(0), positions)
            k = rope(proj(1), positions)
            v = proj(2)
            o = (attend_fn or self._resolve_attend())(q, k, v)
        else:
            from ..serve import kvcache as kv_lib

            idx, q_pos, k_pos = cache_ctx
            q = rope(proj(0), q_pos)
            k = rope(proj(1), q_pos)
            v = proj(2)
            cache = kv_lib.layer_write(cache, idx, k, v)
            k_all, v_all = kv_lib.layer_read(cache, torch.float32)
            o = _cache_attend(q, k_all, v_all, q_pos, k_pos)
        w_loc = tp_lib.shard_head_rows(self.out.weight.t(), self.num_heads,
                                       ax)           # (hl*hd, h)
        y = tp_lib.row_parallel(
            o.reshape(b, s, heads_l * head_dim), w_loc.to(self.dtype), ax,
            self.out.bias.to(self.dtype))
        return y if cache is None else (y, cache)

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
            return self._forward_tp(x, positions, attend_fn, cache,
                                    cache_ctx)
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


class MoeMlp(nn.Module):
    """The expert-parallel FFN that replaces a layer's dense MLP under
    ``GPT(moe_experts=E)`` (the JAX package's ``MoeMlp``): GShard top-2
    gating and the all-to-all dispatch over the ``axis_name``/``route``
    ep world (``parallel/moe.py``), each expert a tanh-GELU MLP in the
    compute dtype. Parameters, in the flax layout: ``gate`` (h, E),
    ``w_in`` (E, h, mlp), ``b_in`` (E, mlp), ``w_out`` (E, mlp, h),
    ``b_out`` (E, h). The expert bank is REPLICATED: every rank stores
    all E experts and uses its own ``E / n``; backprop through the
    exchange brings every rank's cotangents to each expert's owner.

    After each forward, ``aux`` holds the load-balancing loss and
    ``local_stats`` this rank's drop/load counts, which
    ``GPT.moe_stats()`` sums over the ep world when asked (the JAX model
    sows them into ``intermediates``, dead unless asked for; the forward
    runs no collective for them). ``capacity_factor``, ``wire`` and
    ``overlap_chunks`` left None take ``parallel.moe.moe_defaults`` at
    each forward. ``generator`` (a ``torch.Generator`` on the
    parameters' device, None by default) feeds the router noise when
    ``router_noise > 0``."""

    def __init__(self, hidden: int, num_experts: int, mlp_dim: int,
                 capacity_factor: Optional[float] = None,
                 dtype: torch.dtype = torch.bfloat16, axis_name=None,
                 route=None, wire: Optional[str] = None,
                 overlap_chunks: Optional[int] = None,
                 router_noise: float = 0.0):
        super().__init__()
        e = num_experts
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.axis_name = axis_name
        self.route = route
        self.wire = wire
        self.overlap_chunks = overlap_chunks
        self.router_noise = router_noise
        self.generator: Optional[torch.Generator] = None
        self.gate = nn.Parameter(torch.zeros(hidden, e))
        self.w_in = nn.Parameter(torch.zeros(e, hidden, mlp_dim))
        self.b_in = nn.Parameter(torch.zeros(e, mlp_dim))
        self.w_out = nn.Parameter(torch.zeros(e, mlp_dim, hidden))
        self.b_out = nn.Parameter(torch.zeros(e, hidden))
        self.aux: Optional[torch.Tensor] = None
        self.local_stats = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel import moe as moe_lib

        b, s, h = x.shape
        n = moe_lib.ep_size(self.axis_name, self.route)
        e_local = self.num_experts // n
        base = moe_lib.ep_index(self.axis_name, self.route) * e_local
        dt = self.dtype

        def expert_fn(local_idx: int, tokens: torch.Tensor):
            ge = base + local_idx                    # the global expert id
            y = F.gelu(tokens @ self.w_in[ge].to(dt) + self.b_in[ge].to(dt),
                       approximate="tanh")
            return (y @ self.w_out[ge].to(dt)
                    + self.b_out[ge].to(dt)).to(tokens.dtype)

        noisy = self.router_noise > 0 and self.generator is not None
        y, self.aux, self.local_stats = moe_lib._moe_layer(
            x.reshape(b * s, h), self.gate, expert_fn, self.num_experts,
            self.capacity_factor, self.axis_name, self.route, self.wire,
            self.overlap_chunks, None,
            self.router_noise if noisy else 0.0, None, self.generator,
            True)
        return y.reshape(b, s, h).to(x.dtype)


class DecoderLayer(nn.Module):
    """Pre-LN block: attention, then the dense tanh-GELU MLP (or, with
    ``moe_experts``, the :class:`MoeMlp`)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16, tp_axis=None,
                 seq_axis=None, seq_impl: str = "ring",
                 seq_wire: Optional[str] = None, moe_experts: int = 0,
                 moe_capacity_factor: Optional[float] = None,
                 moe_axis=None, moe_route=None,
                 moe_wire: Optional[str] = None,
                 moe_overlap_chunks: Optional[int] = None,
                 moe_router_noise: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.tp_axis = tp_axis
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = CausalSelfAttention(hidden, num_heads, dtype, tp_axis,
                                        seq_axis, seq_impl, seq_wire)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.moe = None
        if moe_experts:
            self.moe = MoeMlp(hidden, moe_experts, mlp_dim,
                              moe_capacity_factor, dtype, moe_axis,
                              moe_route, moe_wire, moe_overlap_chunks,
                              moe_router_noise)
        else:
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
        if self.moe is not None:
            out = x + self.moe(y)
            return out if cache is None else (out, cache)
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
            return out if cache is None else (out, cache)
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
                 moe_experts: int = 0, remat: bool = False,
                 moe_capacity_factor: Optional[float] = None,
                 moe_axis=None, moe_route=None,
                 moe_wire: Optional[str] = None,
                 moe_overlap_chunks: Optional[int] = None,
                 moe_router_noise: float = 0.0):
        super().__init__()
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
        #: Per-layer remat, and the MoE fields (``moe_experts`` 0: the
        #: dense MLP) every layer's :class:`MoeMlp` takes.
        self.remat = bool(remat)
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_axis = moe_axis
        self.moe_route = moe_route
        self.moe_wire = moe_wire
        self.moe_overlap_chunks = moe_overlap_chunks
        self.moe_router_noise = moe_router_noise
        self.tok_emb = nn.Embedding(vocab_size, hidden)
        self.layers = nn.ModuleList(
            DecoderLayer(hidden, num_heads, mlp_dim, dtype, tp_axis,
                         seq_parallel, seq_impl, seq_wire, moe_experts,
                         moe_capacity_factor, moe_axis, moe_route,
                         moe_wire, moe_overlap_chunks, moe_router_noise)
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
            elif isinstance(module, MoeMlp):
                for w in (module.gate, module.w_in, module.w_out):
                    w.normal_(0.0, 0.02, generator=generator)
                module.b_in.zero_()
                module.b_out.zero_()
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
        with metrics_lib.span("hvd.model.forward"):
            x = self.tok_emb(tokens.long()).to(self.dtype)
            return self._head(self.run_layers(x))

    def run_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The decoder layers on activations ``x`` (B, S, hidden), each
        under ``torch.utils.checkpoint`` with ``remat`` while autograd
        records."""
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(layer, x, attend_fn=self.attend_fn,
                               use_reentrant=False)
            else:
                x = layer(x, attend_fn=self.attend_fn)
        return x

    def moe_aux(self) -> Optional[torch.Tensor]:
        """The sum of the last forward's MoE load-balancing losses over
        the layers (the JAX model's sown ``moe_aux``); None for a dense
        model."""
        aux = [l.moe.aux for l in self.layers
               if l.moe is not None and l.moe.aux is not None]
        return sum(aux) if aux else None

    def moe_stats(self) -> list:
        """Each MoE layer's drop/load statistics of the last forward (the
        sown ``moe_stats``; ``parallel.moe.record_moe_stats`` publishes
        one), summed over the ep world here: one allreduce a layer, so
        every rank of that world calls this together."""
        from ..parallel import moe as moe_lib

        return [moe_lib.reduce_moe_stats(l.moe.local_stats)
                for l in self.layers
                if l.moe is not None and l.moe.local_stats is not None]

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
    with metrics_lib.span("hvd.model.loss"):
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
    ``device`` defaults to ``"cuda"`` and raises without a GPU.

    A tensor-parallel model (``tp_axis``) gets THIS rank's head shard:
    ``num_heads / tp`` heads a line, the shard the JAX package's
    ``P(None, None, tp)`` cache spec hands each device of its tp mesh
    (rank ``i`` holds heads ``i * num_heads / tp`` onward). The tp
    world must exist (``init(parallel=...)``)."""
    from ..serve import kvcache as kv_lib

    heads = model.num_heads
    if model.tp_axis:
        heads //= C._axis(model.tp_axis).size
    return kv_lib.init_cache(model.num_layers, slots, max_len, heads,
                             model.hidden // model.num_heads,
                             kind=kind, dtype=model.dtype,
                             device=resolve_device(device))


# -- the pipeline helpers -----------------------------------------------------

def activation_bytes(model: GPT, batch: int, seq_len: int,
                     dtype_bytes: int = 4) -> int:
    """Analytic per-rank activation accounting of one training step (the
    JAX package's): per decoder layer and token ``10 * hidden + 2 *
    mlp_dim`` values, plus ``hidden + vocab`` for the embedding and the
    logits; linear in ``seq_len``, so sequence parallelism over n ranks
    divides it by n."""
    per_tok_layer = 10 * model.hidden + 2 * model.mlp_dim
    per_tok = (model.num_layers * per_tok_layer + model.hidden
               + model.vocab_size)
    return int(batch) * int(seq_len) * per_tok * int(dtype_bytes)


def param_bytes(params) -> int:
    """Total bytes of a parameter tree: a module, a state dict, or any
    nest of tensors."""
    from ..common import tree as tree_lib

    return sum(t.numel() * t.element_size()
               for t in tree_lib.tensors(params))


#: The state-dict entries every pipeline stage holds besides its layers.
SHARED_KEYS = ("tok_emb.weight", "final_ln.weight", "final_ln.bias")


def stack_stage_params(params, num_stages: int):
    """Split a GPT state dict (or a GPT) into the pipeline layout:
    ``(stages, shared)`` where ``stages[s]`` holds stage ``s``'s decoder
    layers renumbered from 0 (``layers.{j}...``), so it loads into a
    ``GPT`` built with ``num_layers // num_stages`` layers, and
    ``shared`` holds ``tok_emb`` and ``final_ln``, which both pipeline
    ends use. The JAX package stacks the stages on a leading axis for
    ``shard_map``; here each pipeline rank holds only its own stage.
    Raises when the layers do not divide into the stages."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    layer_ids = sorted({int(k.split(".")[1]) for k in params
                        if k.startswith("layers.")})
    n_layers = len(layer_ids)
    if num_stages < 1 or n_layers % num_stages:
        raise ValueError(f"{n_layers} decoder layers do not divide into "
                         f"{num_stages} pipeline stages")
    lps = n_layers // num_stages
    stages = []
    for s in range(num_stages):
        stage = {}
        for k, v in params.items():
            parts = k.split(".")
            if parts[0] != "layers":
                continue
            i = int(parts[1])
            if s * lps <= i < (s + 1) * lps:
                stage[".".join(["layers", str(i - s * lps)] + parts[2:])] = v
        stages.append(stage)
    shared = {k: v for k, v in params.items() if not k.startswith("layers.")}
    return stages, shared


class _Stage(nn.Module):
    """A stage's decoder layers as one module (the parameter names are
    the GPT's ``layers.{j}...``), for ``torch.func.functional_call``."""

    def __init__(self, model: GPT):
        super().__init__()
        self.layers = model.layers
        self.model = [model]           # not a submodule: no extra names

    def forward(self, x):
        return self.model[0].run_layers(x)


def stage_params(model: GPT) -> Dict[str, torch.Tensor]:
    """The stage tree of a stage model: its decoder layers' parameters by
    name (the ``stage_params`` ``pipeline_fns``'s ``stage_fn`` takes)."""
    return {n: p for n, p in model.named_parameters()
            if n.startswith("layers.")}


def global_param_names(model: GPT, stage: int, num_stages: int) -> list:
    """The whole model's names of a stage model's parameters, in
    ``model.parameters()`` order: stage ``stage`` of ``num_stages``
    holds global layers ``stage * L .. (stage + 1) * L - 1`` (``L`` its
    own layer count) as ``layers.0 .. L - 1``, the inverse of
    :func:`stack_stage_params`; the shared entries keep their names.
    Checkpoint keys that name the same leaf on every pipeline layout
    (``ZeroOptimizer.sharded_tree(names)``)."""
    if not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} of {num_stages}")
    out = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(stage * model.num_layers + int(parts[1]))
        out.append(".".join(parts))
    return out


def shared_params(model: GPT) -> Dict[str, torch.Tensor]:
    """The shared tree of a stage model: ``tok_emb`` and ``final_ln``."""
    return {n: p for n, p in model.named_parameters()
            if not n.startswith("layers.")}


def pipeline_fns(model: GPT):
    """The ``(stage_fn, pre_fn, loss_fn)`` closures that plug a GPT into
    ``parallel.pipeline.pipeline_accumulate_gradients``; ``model`` is
    this rank's stage (a GPT with the stage's layer count):

    - ``stage_fn(stage_params, x)`` runs the decoder layers on ``x`` with
      the parameters of the ``stage_params`` dict (:func:`stage_params`'s
      names; the model's own tensors take the direct path, others go
      through ``torch.func.functional_call``), carrying the model's
      tp/sp/MoE fields and per-layer remat;
    - ``pre_fn(shared, tokens)``: the embedding lookup in the compute
      dtype (stage 0's input);
    - ``loss_fn(shared, out, targets)``: the final LayerNorm, the tied
      head (bf16-rounded operands, fp32 accumulation, as the model's own
      head) and the mean next-token cross-entropy (the last stage's).

    The closures are deterministic, as the 1F1B schedule's recompute
    from stored inputs needs (no dropout in this decoder)."""
    stage = _Stage(model)
    own = stage_params(model)

    def stage_fn(params: Dict[str, torch.Tensor], x: torch.Tensor):
        if params.keys() == own.keys() and all(
                params[k] is own[k] for k in own):
            return stage(x)
        return torch.func.functional_call(stage, params, (x,))

    def pre_fn(shared: Dict[str, torch.Tensor], tokens: torch.Tensor):
        return F.embedding(tokens.long(),
                           shared["tok_emb.weight"]).to(model.dtype)

    def loss_fn(shared: Dict[str, torch.Tensor], out: torch.Tensor,
                targets: torch.Tensor):
        x = F.layer_norm(out.to(torch.float32), (model.hidden,),
                         shared["final_ln.weight"], shared["final_ln.bias"],
                         LN_EPS).to(model.dtype)
        emb = shared["tok_emb.weight"].to(model.dtype).to(torch.float32)
        return next_token_loss(torch.matmul(x.to(torch.float32), emb.t()),
                               targets)

    return stage_fn, pre_fn, loss_fn
