"""The traffic generator's statistics and its dependence on the seed."""

import numpy as np

from port_bench import registry, traffic


def test_bert_pretraining_statistics():
    t = registry.traffic("mlm_b128s512")
    pool = traffic.make_pool(t, 30522, 2 ** 40 + 3, 4)
    s = t["seq_len"]
    for b in pool:
        lengths = np.asarray(traffic.lengths(b))
        # exactly round(0.1 x 128) = 13 short rows a batch, in [5, 512)
        assert (lengths < s).sum() == 13
        assert lengths.min() >= 5
        targets = b["weights"].sum(axis=1)
        want = np.minimum(80, np.maximum(1, np.round(lengths * 0.15)))
        np.testing.assert_array_equal(targets, want)
        assert targets.max() <= t["max_predictions_per_seq"]
        # targets sit on real tokens: not padding, [CLS] or [SEP]
        ids = b["input_ids"]
        pos = b["weights"] > 0
        assert (b["mask"][pos] == 1).all()
        assert not np.isin(b["labels"][pos], [0, 101, 102]).any()
        assert (ids[:, 0] == t["cls_id"]).all()
        assert (ids[b["mask"] == 0] == t["pad_id"]).all()
    pos = np.concatenate([(b["weights"] > 0).ravel() for b in pool])
    ids = np.concatenate([b["input_ids"].ravel() for b in pool])[pos]
    labels = np.concatenate([b["labels"].ravel() for b in pool])[pos]
    masked = (ids == t["mask_id"]).mean()
    kept = (ids == labels).mean()
    assert abs(masked - 0.8) < 0.02 and abs(kept - 0.1) < 0.02


def test_packed_lm():
    t = registry.traffic("lm_packed_b32s1024")
    pool = traffic.make_pool(t, 50257, 7, 3)
    for b in pool:
        assert b["tokens"].shape == (32, 1025)
        assert b["tokens"].dtype == np.int64
        assert b["tokens"].min() >= 0 and b["tokens"].max() <= 50256
    eot = np.mean([(b["tokens"] == 50256).mean() for b in pool])
    assert abs(eot - 1 / t["mean_doc_tokens"]) < 0.5 / t["mean_doc_tokens"]
    assert traffic.lengths(pool[0]) is None


def test_seed_moves_ids_not_sizes():
    t = registry.traffic("mlm_b128s512")
    a = traffic.make_pool(t, 30522, 1, 2)
    b = traffic.make_pool(t, 30522, 1, 2)
    c = traffic.make_pool(t, 30522, 2 ** 33 + 1, 2)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["input_ids"], c[0]["input_ids"])
    for x, z in zip(a, c):
        assert {k: v.shape for k, v in x.items()} == \
            {k: v.shape for k, v in z.items()}
        assert (np.asarray(traffic.lengths(x)) < 512).sum() == \
            (np.asarray(traffic.lengths(z)) < 512).sum()
    # the rows of a pool all differ
    rows = {r.tobytes() for x in a for r in x["input_ids"]}
    assert len(rows) == 2 * 128


def test_rows_of_ranks_cover_the_batch():
    t = registry.traffic("mlm_b128s512")
    b = traffic.make_pool(t, 30522, 5, 1)[0]
    parts = [traffic.rows_of(b, r, 4) for r in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["input_ids"] for p in parts]), b["input_ids"])
