"""Test-sized cells: a benchmark cell's files with the widths, rows and
sequence cut so that a run fits the CPU. Only tests use these."""

from __future__ import annotations

import time

from port_bench import registry
from port_bench.loops import train

CELLS = {"gpt": "gpt2_medium_lm_b32s1024",
         "bert": "bert_large_mlm_dp4_b32s512"}


def spec(family: str, program: str = "port", chips: int = 1,
         dtype: str = "float32", seconds: float = 1.0, trace: int = 0,
         seed: int = 2 ** 31 + 5):
    bench = registry.benchmark()
    name = CELLS[family]
    entry, wl, cfg, tr = registry.resolve(bench, name)
    cfg, wl, tr, entry = dict(cfg), dict(wl), dict(tr), dict(entry)
    cfg["compute_dtype"] = dtype
    if family == "gpt":
        cfg.update(n_layer=2, n_embd=64, n_head=4, n_inner=128,
                   vocab_size=256, port_model="gpt_tiny")
        tr.update(global_rows=4, seq_len=32, token_range=[0, 255],
                  eot_id=255, mean_doc_tokens=20)
    else:
        cfg.update(num_hidden_layers=2, hidden_size=64,
                   num_attention_heads=4, intermediate_size=128,
                   vocab_size=1200, max_position_embeddings=64,
                   port_model="bert_tiny")
        tr.update(global_rows=8, seq_len=64, token_range=[999, 1200])
    wl.update(profiled_steps=2, reference_block_rows=2)
    entry["chips"] = chips
    return bench, name, {"cell": entry, "workload": wl, "config": cfg,
                         "traffic": tr, "seed": seed, "seconds": seconds,
                         "trace": trace, "t_start": time.time(),
                         "device": "cpu", "program": program}


def run(family: str, **kw):
    """One cell run on the CPU through the training loop, the look for a
    chip skipped: ``(result, notes, forbidden modules)``."""
    bench, name, s = spec(family, **kw)
    kind = "per_layer" if s["trace"] else "end_to_end"
    ranks = train.launch(s)
    out = train.report(s, ranks, registry.metrics_for(bench, name, kind))
    return out["result"], out["notes"], out["forbidden"]
