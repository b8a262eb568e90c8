"""The cell's weights, made from the run's seed on the device in one
random draw: every leaf of ``param_specs`` is a view of one flat fp32
buffer filled by one ``normal_`` call of a ``torch.Generator`` on that
device, then scaled by its kind. The program and the reference get the same
numbers: the reference draws them again after the program is gone."""

from __future__ import annotations

from typing import Dict

import torch

from .traffic import seed_of

BIAS_STD = 0.02
LN_SCALE_STD = 0.05
LN_SHIFT_STD = 0.02


def generate(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    total = sum(int(torch.Size(shape).numel()) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_of(seed, "weights").generate_state(
        2, dtype="uint64")[0]) >> 1)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    out, at = {}, 0
    with torch.no_grad():
        for name, shape, kind, std in specs:
            n = int(torch.Size(shape).numel())
            leaf = flat[at:at + n].view(shape)
            at += n
            if kind == "weight":
                leaf.mul_(std)
            elif kind == "bias" or kind == "ln_shift":
                leaf.mul_(BIAS_STD if kind == "bias" else LN_SHIFT_STD)
            elif kind == "ln_scale":
                leaf.mul_(LN_SCALE_STD).add_(1.0)
            else:
                raise ValueError(f"unknown kind {kind!r} of {name}")
            out[name] = leaf
    return out
