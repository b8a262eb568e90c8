"""The one traffic generator: a pool of host batches from a mix's data
file (``traffic/<name>.json``) and the run's seed.

Two objectives, both over Zipf-distributed token ids (exponent
``zipf_exponent``; id of rank k fixed by ``rank_permutation_seed``):

* ``causal_lm``: documents of mean length ``mean_doc_tokens`` packed back
  to back with ``eot_id`` between them into rows of ``seq_len + 1`` ids;
  the batch is ``{"tokens": (rows, seq_len + 1) int64}``.
* ``masked_lm``: BERT's ``create_pretraining_data.py``: ``[CLS] A [SEP] B
  [SEP]`` rows, exactly ``round(short_seq_prob * rows)`` of them (at random
  positions) cut to a target length uniform in ``[2, seq_len - 3]``, the
  rest full; ``min(max_predictions_per_seq, max(1, round(masked_lm_prob *
  length)))`` targets among the non-special tokens, replaced by
  ``[MASK]``, a random id or kept with ``mask_replace``'s odds; the batch
  is ``{"input_ids", "labels"}`` int64 and ``{"mask", "weights"}`` fp32,
  each ``(rows, seq_len)``, and its row lengths are ``lengths(batch)``.

Every seed gives batches of the same sizes; only the ids, the positions of
the short rows and their lengths move with it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def seed_of(seed: int, tag: str) -> np.random.SeedSequence:
    """A stream of its own for each use of the run's seed (any integer)."""
    return np.random.SeedSequence(
        [int(seed) % 2 ** 64, *map(ord, tag)])


class _Zipf:
    def __init__(self, lo: int, hi: int, exponent: float, perm_seed: int):
        n = hi - lo
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
        self.cdf = np.cumsum(p / p.sum())
        self.ids = lo + np.random.default_rng(perm_seed).permutation(n)

    def draw(self, rng: np.random.Generator, size) -> np.ndarray:
        k = np.searchsorted(self.cdf, rng.random(size), side="right")
        return self.ids[np.minimum(k, len(self.ids) - 1)]


def _causal_lm(t: Dict[str, Any], rng, zipf: _Zipf) -> Dict[str, np.ndarray]:
    rows, width = t["global_rows"], t["seq_len"] + 1
    ids = zipf.draw(rng, rows * width)
    # Document ends: a geometric gap of mean mean_doc_tokens between EOTs.
    ends = rng.random(rows * width) < 1.0 / t["mean_doc_tokens"]
    ids[ends] = t["eot_id"]
    return {"tokens": ids.reshape(rows, width).astype(np.int64)}


def _masked_lm(t: Dict[str, Any], rng, zipf: _Zipf,
               vocab: int) -> Dict[str, np.ndarray]:
    rows, s = t["global_rows"], t["seq_len"]
    lengths = np.full(rows, s, dtype=np.int64)
    short = rng.choice(rows, size=int(round(t["short_seq_prob"] * rows)),
                       replace=False)
    lengths[short] = 3 + rng.integers(2, s - 3, size=len(short),
                                      endpoint=True)
    ids = np.full((rows, s), t["pad_id"], dtype=np.int64)
    labels = np.zeros((rows, s), dtype=np.int64)
    weights = np.zeros((rows, s), dtype=np.float32)
    p_mask, p_random, _ = t["mask_replace"]
    for r in range(rows):
        n = int(lengths[r])
        target = n - 3
        a = int(rng.integers(1, target, endpoint=True)) if target > 1 else 1
        body = zipf.draw(rng, target)
        row = np.concatenate([[t["cls_id"]], body[:a], [t["sep_id"]],
                              body[a:], [t["sep_id"]]])
        cand = np.concatenate([np.arange(1, 1 + a),
                               np.arange(2 + a, n - 1)])
        k = min(t["max_predictions_per_seq"],
                max(1, int(round(n * t["masked_lm_prob"]))), len(cand))
        pos = np.sort(rng.choice(cand, size=k, replace=False))
        labels[r, pos] = row[pos]
        weights[r, pos] = 1.0
        u = rng.random(k)
        row[pos[u < p_mask]] = t["mask_id"]
        rnd = pos[(u >= p_mask) & (u < p_mask + p_random)]
        row[rnd] = rng.integers(0, vocab, size=len(rnd))
        ids[r, :n] = row
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    return {"input_ids": ids, "mask": mask, "labels": labels,
            "weights": weights}


def make_pool(t: Dict[str, Any], vocab: int, seed: int,
              batches: int) -> List[Dict[str, np.ndarray]]:
    """``batches`` global batches of mix ``t`` from ``seed``."""
    rng = np.random.default_rng(seed_of(seed, "traffic:" + t["name"]))
    lo, hi = t["token_range"]
    zipf = _Zipf(lo, hi, t["zipf_exponent"], t["rank_permutation_seed"])
    if t["objective"] == "causal_lm":
        return [_causal_lm(t, rng, zipf) for _ in range(batches)]
    if t["objective"] == "masked_lm":
        return [_masked_lm(t, rng, zipf, vocab) for _ in range(batches)]
    raise ValueError(f"unknown objective {t['objective']!r}")


def rows_of(batch: Dict[str, Any], rank: int, size: int) -> Dict[str, Any]:
    """Rank ``rank``'s contiguous share of a global batch's rows."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // size
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def lengths(batch: Dict[str, Any]):
    """Each row's length under its key mask, or None without a mask."""
    if "mask" not in batch:
        return None
    return [int(x) for x in np.asarray(batch["mask"]).sum(axis=1)]


def targets(batch: Dict[str, Any]):
    """The positions whose logits the loss reads (a masked-LM batch's
    targets), or None where it reads every position."""
    if "weights" not in batch:
        return None
    return int(np.count_nonzero(np.asarray(batch["weights"])))
