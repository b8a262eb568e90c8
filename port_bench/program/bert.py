"""The port's BERT for a ``bert`` configuration: its model, built empty on
the device (the benchmark's weights fill it), and its masked-LM loss."""

from __future__ import annotations

import torch


def build(cfg, device, widths):
    from horovod_tpu_torch.models import bert

    dtype = getattr(torch, cfg["compute_dtype"])
    with torch.device("meta"):
        model = getattr(bert, cfg["port_model"])(
            vocab_size=widths["vocab"],
            max_len=cfg["max_position_embeddings"], dtype=dtype)
    got = (model.num_layers, model.hidden_size, model.num_heads,
           model.mlp_dim, model.vocab_size)
    want = tuple(widths[k] for k in ("layers", "hidden", "heads", "mlp",
                                     "vocab"))
    if got != want:
        raise ValueError(f"{cfg['port_model']} has widths {got}, the "
                         f"configuration {want}")
    return model.to_empty(device=device)


def loss(model, batch):
    from horovod_tpu_torch.models import bert

    return bert.mlm_loss(model(batch["input_ids"], batch["mask"]),
                         batch["labels"], batch["weights"])
