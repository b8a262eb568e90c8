"""The port's GPT for a ``gpt`` configuration: its model, built empty on
the device (the benchmark's weights fill it), and its training loss."""

from __future__ import annotations

import torch


def build(cfg, device, widths):
    from horovod_tpu_torch.models import gpt

    dtype = getattr(torch, cfg["compute_dtype"])
    with torch.device("meta"):
        model = getattr(gpt, cfg["port_model"])(vocab_size=widths["vocab"],
                                                dtype=dtype)
    got = (model.num_layers, model.hidden, model.num_heads, model.mlp_dim,
           model.vocab_size)
    want = tuple(widths[k] for k in ("layers", "hidden", "heads", "mlp",
                                     "vocab"))
    if got != want:
        raise ValueError(f"{cfg['port_model']} has widths {got}, the "
                         f"configuration {want}")
    return model.to_empty(device=device)


def loss(model, batch):
    from horovod_tpu_torch.models import gpt

    t = batch["tokens"]
    return gpt.next_token_loss(model(t[:, :-1]), t[:, 1:])
