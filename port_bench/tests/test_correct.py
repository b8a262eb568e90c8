"""``correct`` from a whole run on the CPU (the look for a chip skipped),
at a tiny size: true for the port in fp32, false with the timed path
broken underneath (each fault a training cell can have) and false for the
control, the reference in fp8 in the program's place."""

import pytest

from port_bench import correct
from port_bench.tests import tiny


def test_port_in_fp32_is_correct():
    result, _, forbidden = tiny.run("gpt", dtype="float32")
    assert result["correct"], result["checks"]
    assert forbidden == []
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"loss_gap", "grad_norm_gap",
                                     "update_norm_gap", "update_median_gap"}


@pytest.mark.parametrize("program", ["control", "unchanged", "half",
                                     "altered", "lr"])
def test_broken_step_is_not_correct(program):
    result, _, _ = tiny.run("gpt", program=program)
    assert not result["correct"], result["checks"]


def test_wrong_learning_rate_over_two_ranks_is_not_correct():
    result, _, _ = tiny.run("bert", program="lr", chips=2)
    assert not result["correct"], result["checks"]


def test_exchange_left_out_is_not_correct():
    result, _, _ = tiny.run("bert", program="noexchange", chips=2)
    assert not result["correct"], result["checks"]


def test_two_ranks_in_fp32_are_correct():
    result, _, _ = tiny.run("bert", chips=2)
    assert result["correct"], result["checks"]


def test_nan_fails_its_limit():
    ok, checks = correct.judge({"loss_gap": float("nan")},
                               {"loss_gap": 1.0})
    assert not ok and checks["loss_gap"]["limit"] == 1.0


def test_norm_gap_floor_is_the_median_leaf():
    ref = {"a": 1.0, "b": 1.0, "c": 1e-9}
    prog = {"a": 1.0, "b": 1.0, "c": 0.5}
    gap, leaf = correct.norm_gap(prog, ref, list(ref))
    assert leaf == "c" and gap == pytest.approx(0.5)


def test_median_gap_is_the_median_leaf():
    ref = {"a": 1.0, "b": 1.0, "c": 1.0}
    prog = {"a": 1.0, "b": 1.1, "c": 1.5}
    values, leaves = correct.readings(
        {"losses": [[1.0]], "grad_norms": ref, "update_norms": prog},
        {"losses": [[1.0]], "grad_norms": ref, "update_norms": ref})
    assert values["update_median_gap"] == pytest.approx(0.1)
    assert values["update_norm_gap"] == pytest.approx(0.5)
    assert leaves["update_norm_gap"] == "c"
