"""FLOP and byte counts of ``work/`` against hand counts."""

import pytest

from port_bench.work import attention, model, peaks

H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


def test_pairs_causal_and_masked():
    # S = 4 causal: 1 + 2 + 3 + 4 pairs a row and head.
    assert attention.pairs(1, 4, 1, causal=True) == 10
    assert attention.pairs(2, 4, 3, causal=True) == 2 * 3 * 10
    # A key mask: every query row attends its row's valid keys.
    assert attention.pairs(2, 4, 1, causal=False, lengths=[2, 3]) == \
        4 * 2 + 4 * 3
    assert attention.pairs(1, 4, 2, causal=False) == 2 * 16
    with pytest.raises(ValueError):
        attention.pairs(2, 4, 1, causal=False, lengths=[1])


def test_train_work_by_hand():
    # B=1, S=2, H=1, D=64, causal: 3 pairs.
    w = attention.train_work(1, 2, 1, 64, causal=True)
    assert w["pairs"] == 3
    assert w["flops"] == 4 * 3 * 64 + 8 * 3 * 64
    # q, k, v, o, do, dq, dk, dv: 8 bf16 tensors of 2 x 64; lse 2 fp32.
    assert w["bytes"] == 8 * 2 * 64 * 2 + 2 * 4
    masked = attention.train_work(1, 2, 1, 64, causal=False, lengths=[1])
    assert masked["pairs"] == 2
    assert masked["bytes"] == 8 * 2 * 64 * 2 + 2 * 4 + 2 * 4


def test_gpt2_medium_step_counts():
    # One H100's GPT-2 medium step at 32 x 1024: 74.5 TFLOP.
    assert model.matmul_params(24, 1024, 4096) == 301_989_888
    flops = model.train_flops(24, 1024, 16, 4096, 50257, 32, 1024, True)
    pairs = 32 * 16 * 1024 * 1025 // 2
    want = (6 * 301_989_888 * 32768 + 6 * 1024 * 50257 * 32768
            + 3 * 4 * pairs * 64 * 24)
    assert flops == want
    assert 74.4e12 < flops < 74.6e12
    w = attention.train_work(32, 1024, 16, 64, causal=True)
    least = attention.least_seconds(w, H100)
    assert least["bound"] == "compute"
    assert least["seconds"] == pytest.approx(12 * pairs * 64 / 989e12)


def test_masked_lm_head_counts_only_targets():
    # B=2, S=4, one layer of hidden 8 (MLP 16), 2 heads, vocab 10, keys
    # 3 and 4 long; 3 targets in all.
    flops = model.train_flops(1, 8, 2, 16, 10, 2, 4, False, [3, 4],
                              targets=3)
    pairs = 2 * (4 * 3 + 4 * 4)
    want = (6 * (4 * 8 * 8 + 2 * 8 * 16) * 8 + 6 * 8 * 10 * 3
            + 3 * 4 * pairs * 4)
    assert flops == want
    every = model.train_flops(1, 8, 2, 16, 10, 2, 4, False, [3, 4])
    assert every - flops == 6 * 8 * 10 * (8 - 3)


def test_memory_bound_call():
    # One key per query: 12 * S * d FLOPs against 16 * S * d bytes.
    w = attention.train_work(1, 1, 1, 64, causal=True)
    assert attention.least_seconds(w, H100)["bound"] == "memory"


def test_unknown_card_has_no_peaks():
    assert peaks.peaks("cpu") is None
