"""Ring-buffer KV cache for incremental GPT decode — the port of
``horovod_tpu/serve/kvcache.py``.

The cache is a plain dict of tensors: per layer ``k``/``v`` slabs laid
out (slots, max_len, heads, head_dim), plus per-slot bookkeeping —
``pos`` (tokens written, the ring write head) and ``slot_pos`` (each
line's GLOBAL sequence position, -1 = empty), both int32. Validity is
data, not shape: attention masks on ``slot_pos``, and a write at global
position p lands in line ``p % max_len``.

Two storage formats, selected by ``kind``:

* ``"fp32"`` — k/v stored in the model dtype (bf16 for ``gpt_medium``).
* ``"int8"`` — one fp32 absmax scale per (slot, line, head) vector
  (:func:`quantize_heads`, plain PyTorch as the JAX package keeps it
  plain jnp).

Where the JAX package builds a new pytree, this port updates the cache
tensors IN PLACE (``layer_write``, ``rewind_slots``, ``reset_slot``,
``write_slot``, ``import_slot``) and returns the same dict, so a decode
step does not copy the whole cache.

Slot movement between replicas (the prefill -> decode handoff) ships
every model-dtype K/V leaf through the int8 wire codec of
``ops/kernels.py`` — the hand-written CUDA kernels K2/K4 on a GPU, their
plain versions on the CPU — all of a slot's leaves in one grouped call a
side, the import dequantizing straight into the cache slots.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops import kernels

KINDS = ("fp32", "int8")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_cache(num_layers: int, slots: int, max_len: int, num_heads: int,
               head_dim: int, kind: str = "fp32",
               dtype: torch.dtype = torch.float32,
               device=None) -> Dict[str, Any]:
    """Fresh all-empty cache on ``device`` (default ``"cuda"``; raises
    without a GPU unless ``device="cpu"`` is passed)."""
    from ..common.device import resolve_device

    if kind not in KINDS:
        raise ValueError(f"unknown kv-cache kind {kind!r}; known: {KINDS}")
    dev = resolve_device(device)
    shape = (slots, max_len, num_heads, head_dim)
    layers = []
    for _ in range(num_layers):
        if kind == "int8":
            layers.append({
                "k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=dev),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v_s": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=dev),
            })
        else:
            layers.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype,
                                            device=dev)})
    return {
        "layers": layers,
        "pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "slot_pos": torch.full((slots, max_len), -1, dtype=torch.int32,
                               device=dev),
    }


def cache_nbytes(cache: Dict[str, Any]) -> int:
    """Total bytes of the cache storage."""
    leaves = [cache["pos"], cache["slot_pos"]]
    for layer in cache["layers"]:
        leaves.extend(layer.values())
    return sum(t.numel() * t.element_size() for t in leaves)


# -- the block-scale recipe at KV granularity --------------------------------

def quantize_heads(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 over the trailing head_dim axis, one fp32 absmax scale per
    head vector: ``(q, scales)`` with ``scales.shape == x.shape[:-1]``."""
    xf = x.to(torch.float32)
    absmax = torch.clamp(xf.abs().amax(dim=-1), min=1e-30)
    scales = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xf / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_heads(q: torch.Tensor, scales: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_heads`."""
    return (q.to(torch.float32) * scales[..., None]).to(dtype)


# -- write / read ------------------------------------------------------------

def layer_write(layer: Dict[str, torch.Tensor], idx: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Scatter the new tokens' K/V into their ring lines, in place.
    ``idx`` is (slots, s_in) — each new token's line; ``k_new``/``v_new``
    are (slots, s_in, heads, head_dim)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    if "k_q" in layer:
        kq, ks = quantize_heads(k_new)
        vq, vs = quantize_heads(v_new)
        layer["k_q"][rows, idx] = kq
        layer["k_s"][rows, idx] = ks
        layer["v_q"][rows, idx] = vq
        layer["v_s"][rows, idx] = vs
    else:
        layer["k"][rows, idx] = k_new.to(layer["k"].dtype)
        layer["v"][rows, idx] = v_new.to(layer["v"].dtype)
    return layer


def layer_read(layer: Dict[str, torch.Tensor],
               dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full (slots, max_len, heads, head_dim) K/V slabs in ``dtype``
    (dequantized for the int8 kind); invalid lines are masked by the
    caller through ``slot_pos``."""
    if "k_q" in layer:
        return (dequantize_heads(layer["k_q"], layer["k_s"], dtype),
                dequantize_heads(layer["v_q"], layer["v_s"], dtype))
    return layer["k"].to(dtype), layer["v"].to(dtype)


def rewind_slots(cache: Dict[str, Any],
                 new_pos: torch.Tensor) -> Dict[str, Any]:
    """Truncate every slot's sequence to ``new_pos`` (a (slots,) vector of
    global positions): the write head moves back and every line at a
    global position >= its slot's new_pos is invalidated. The payload
    stays — masked lines are never read."""
    new_pos = new_pos.to(torch.int32)
    sp = cache["slot_pos"]
    sp.masked_fill_(sp >= new_pos[:, None], -1)
    cache["pos"].copy_(new_pos)
    return cache


def reset_slot(cache: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """Mark one slot empty (pos = 0, every line invalid); the k/v
    payload stays in place, masked out of every read."""
    cache["pos"][slot] = 0
    cache["slot_pos"][slot] = -1
    return cache


def write_slot(cache: Dict[str, Any], slot: int,
               single: Dict[str, Any]) -> Dict[str, Any]:
    """Copy a 1-slot cache (a fresh prefill) into ``slot`` of a
    multi-slot cache of the same geometry and kind."""
    for dst, src in zip(cache["layers"], single["layers"]):
        for name, leaf in dst.items():
            leaf[slot].copy_(src[name][0])
    cache["pos"][slot] = single["pos"][0]
    cache["slot_pos"][slot].copy_(single["slot_pos"][0])
    return cache


# -- wire movement: the int8 block-quantized export --------------------------

def export_slot(cache: Dict[str, Any], slot: int,
                exact: bool = False) -> Dict[str, Any]:
    """One slot's cache lines as an int8 block-scaled wire blob: every
    model-dtype K/V leaf rides :func:`kernels.quantize_int8_group` (K2,
    one launch for all of them); int8 leaves and the int8 kind's fp32
    scale leaves (``*_s``) ship raw, so an int8 -> int8 migration is
    bit-exact. ``exact=True`` ships every leaf raw. The bookkeeping
    vectors travel exact. Raw leaves are copies: the source slot may be
    overwritten while the blob waits."""
    out_layers = []
    pending = []                    # (packed, name, slot view) to quantize
    for layer in cache["layers"]:
        packed = {}
        for name, leaf in layer.items():
            arr = leaf[slot]
            if exact or arr.dtype == torch.int8 or name.endswith("_s"):
                packed[name] = {"raw": arr.clone()}
            else:
                packed[name] = None
                pending.append((packed, name, arr))
        out_layers.append(packed)
    coded = kernels.quantize_int8_group([arr for _, _, arr in pending])
    for (packed, name, arr), (q, s, n) in zip(pending, coded):
        packed[name] = {"q": q, "s": s, "n": n, "shape": tuple(arr.shape),
                        "dtype": str(arr.dtype).split(".")[-1]}
    return {
        "layers": out_layers,
        "pos": cache["pos"][slot].clone(),
        "slot_pos": cache["slot_pos"][slot].clone(),
    }


def import_slot(cache: Dict[str, Any], slot: int,
                blob: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`export_slot`: land a wire blob in ``slot`` of a
    same-geometry cache. The quantized leaves go through one
    :func:`kernels.dequantize_int8_into` call (K4): straight into
    ``leaf[slot]`` where the blob's dtype is the leaf's, and into a
    blob-dtype temporary that is then cast into the slot where it is not
    (as the JAX package's ``.at[slot].set`` casts)."""
    items, outs, casts = [], [], []
    for dst, packed in zip(cache["layers"], blob["layers"]):
        for name, leaf in dst.items():
            item = packed[name]
            dest = leaf[slot]
            if "raw" in item:
                dest.copy_(item["raw"])
                continue
            if tuple(item["shape"]) != tuple(dest.shape):
                raise ValueError(f"import_slot: leaf {name!r} of shape "
                                 f"{tuple(item['shape'])} does not fit "
                                 f"the slot's {tuple(dest.shape)}")
            if not dest.is_contiguous():
                raise ValueError(f"import_slot: slot {slot} of leaf "
                                 f"{name!r} is not contiguous")
            dtype = _DTYPES[item["dtype"]]
            if dtype != leaf.dtype:
                tmp = torch.empty(dest.shape, dtype=dtype,
                                  device=dest.device)
                casts.append((dest, tmp))
                dest = tmp
            items.append((item["q"], item["s"], item["n"]))
            outs.append(dest)
    kernels.dequantize_int8_into(items, outs)
    for dest, tmp in casts:
        dest.copy_(tmp)
    cache["pos"][slot] = blob["pos"]
    cache["slot_pos"][slot].copy_(blob["slot_pos"])
    return cache
