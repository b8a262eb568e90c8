"""The port's respec solver (``parallel/respec.py``) against the JAX
package's, decision for decision: the preference ladder (shed_dp,
fold_pp, fold_sp, drop_tp, dp_only) on the acceptance worlds, every
capacity of a sweep of specs, the ``order``/``min_dp`` gates, the env
knobs, ``min_world``, the decision line and the applied-reshape counter.
Each case runs both solvers on the same spec string and holds the port's
``(action, spec, np)`` equal to the JAX one's, and to the values the JAX
tests pin (``tests/test_respec.py``). Pure host code: no world, no
tolerance."""

import pytest

from horovod_tpu_torch.common import metrics as metrics_lib
from horovod_tpu_torch.parallel import respec as respec_lib
from horovod_tpu_torch.parallel.respec import (RUNGS, RespecDecision,
                                               min_world, solve_respec)
from horovod_tpu_torch.parallel.spec import ParallelSpec

SPEC = "dp=2,pp=2,tp=2"
SP_SPEC = "dp=2,pp=2,sp=2,tp=2"
SWEEP = (SPEC, "dp=4,pp=4,tp=2", "dp=8,pp=2", "dp=2,pp=3,tp=2",
         SP_SPEC, "dp=2,pp=2,sp=4,tp=2", "dp=2,sp=4", "dp=2,pp=2,ep=2",
         "dp=1,pp=2,ep=2", "pp=2,dp=3,sp=2,tp=2")


@pytest.fixture(scope="module")
def J():
    from horovod_tpu.parallel import respec as jrespec
    from horovod_tpu.parallel.spec import ParallelSpec as JSpec

    return jrespec, JSpec


def _tuple(d):
    return None if d is None else (d.action, d.spec.describe(), d.np)


def _both(J, spec, cap, **kw):
    jrespec, JSpec = J
    got = solve_respec(ParallelSpec.parse(spec), cap, **kw)
    want = jrespec.solve_respec(JSpec.parse(spec), cap, **kw)
    assert _tuple(got) == _tuple(want), (spec, cap, kw)
    return got


@pytest.mark.parametrize("spec,expect", [
    (SPEC, {8: ("keep", "dp=2,pp=2,tp=2", 8),
            7: ("shed_dp", "dp=1,pp=2,tp=2", 4),
            6: ("shed_dp", "dp=1,pp=2,tp=2", 4),
            4: ("shed_dp", "dp=1,pp=2,tp=2", 4),
            3: ("fold_pp", "dp=1,pp=1,tp=2", 2),
            2: ("fold_pp", "dp=1,pp=1,tp=2", 2),
            1: ("dp_only", "dp=1,pp=1,tp=1", 1)}),
    (SP_SPEC, {16: ("keep", "dp=2,pp=2,sp=2,tp=2", 16),
               14: ("shed_dp", "dp=1,pp=2,sp=2,tp=2", 8),
               8: ("shed_dp", "dp=1,pp=2,sp=2,tp=2", 8),
               7: ("fold_pp", "dp=1,pp=1,sp=2,tp=2", 4),
               4: ("fold_pp", "dp=1,pp=1,sp=2,tp=2", 4),
               3: ("fold_sp", "dp=1,pp=1,sp=1,tp=2", 2),
               2: ("fold_sp", "dp=1,pp=1,sp=1,tp=2", 2),
               1: ("dp_only", "dp=1,pp=1,sp=1,tp=1", 1)})])
def test_solver_preference_ladder(J, spec, expect):
    """``test_solver_preference_ladder_2x2x2`` and ``..._with_sp``."""
    for cap, want in expect.items():
        assert _tuple(_both(J, spec, cap)) == want, cap


@pytest.mark.parametrize("spec", SWEEP)
def test_solver_sweep_matches_jax_and_stays_valid(J, spec):
    """``test_solver_never_produces_an_invalid_mesh`` over every capacity
    (and two past the spec), with the JAX answer alongside."""
    s = ParallelSpec.parse(spec)
    for cap in range(0, s.total + 3):
        d = _both(J, spec, cap)
        if cap < 1:
            assert d is None
            continue
        assert d.np == d.spec.total <= max(cap, s.total)
        assert d.np <= cap or d.action == "keep"
        for role, size in d.spec.dims:
            assert size >= 1
            assert s.size_of(role) % size == 0 or role == "dp"
        assert d.spec.roles == s.roles
        assert d == solve_respec(s, cap)


def test_solver_order_and_min_dp_gate_degradation(J):
    """``test_solver_order_gates_degradation``, ``test_fold_sp_prefers_
    fewest_folds`` and ``test_fold_sp_keeps_tp_where_drop_tp_cannot``."""
    assert _both(J, SPEC, 3, order=("shed_dp",)) is None
    d = _both(J, SPEC, 6, min_dp=2)
    assert _tuple(d) == ("fold_pp", "dp=2,pp=1,tp=2", 4)
    sp4 = "dp=2,pp=2,sp=4,tp=2"
    assert _tuple(_both(J, sp4, 7)) == ("fold_sp", "dp=1,pp=1,sp=2,tp=2", 4)
    assert _tuple(_both(J, sp4, 3)) == ("fold_sp", "dp=1,pp=1,sp=1,tp=2", 2)
    tp4 = "dp=2,pp=2,sp=2,tp=4"
    assert _tuple(_both(J, tp4, 5))[:2] == ("fold_sp", "dp=1,pp=1,sp=1,tp=4")
    without = _both(J, tp4, 5, order=("shed_dp", "fold_pp", "drop_tp",
                                      "dp_only"))
    assert without.action == "drop_tp" and without.spec.size_of("tp") < 4
    for order in [("shed_dp", "fold_pp"), ("fold_sp", "dp_only"),
                  ("drop_tp",), RUNGS]:
        for min_dp in (1, 2, 3):
            for cap in range(1, 17):
                _both(J, SP_SPEC, cap, order=order, min_dp=min_dp)
    with pytest.raises(ValueError, match="typo"):
        solve_respec(ParallelSpec.parse(SPEC), 3, order=("shed_dp", "typo"))


def test_solver_env_knobs(J, monkeypatch):
    """``test_solver_env_knobs`` and ``test_fold_sp_env_order_and_
    decision_line``: the order and floor from the environment, a typo
    raising, ``HVD_TPU_RESPEC=0`` turning the solver off."""
    jrespec, _ = J
    monkeypatch.setenv(respec_lib.ENV_ORDER, "shed_dp,dp_only")
    monkeypatch.setenv(respec_lib.ENV_MIN_DP, "1")
    d = _both(J, SPEC, 3)
    assert d.action == "dp_only" and d.np == 3
    monkeypatch.setenv(respec_lib.ENV_ORDER, "shed_dp,fold_sp,dp_only")
    d = _both(J, SP_SPEC, 3)
    assert d.describe() == "fold_sp:dp=1,pp=1,sp=1,tp=2" and d.np == 2
    monkeypatch.setenv(respec_lib.ENV_ORDER, "shed_dp,typo")
    with pytest.raises(ValueError, match="typo"):
        solve_respec(ParallelSpec.parse(SPEC), 3)
    monkeypatch.setenv(respec_lib.ENV_ORDER, "")
    monkeypatch.setenv(respec_lib.ENV_MIN_DP, "x")
    assert respec_lib.respec_min_dp() == jrespec.respec_min_dp() == 1
    for raw in ("0", "off", "1", ""):
        monkeypatch.setenv(respec_lib.ENV_ENABLE, raw)
        assert respec_lib.respec_enabled() == jrespec.respec_enabled()
    assert not respec_lib.respec_enabled({respec_lib.ENV_ENABLE: "no"})
    assert respec_lib.respec_order({}) == jrespec.respec_order({}) == RUNGS


@pytest.mark.parametrize("spec", [SPEC, SP_SPEC, "dp=2,pp=2,ep=2"])
def test_min_world_matches_jax(J, spec):
    """``test_min_world_reflects_order`` and
    ``test_min_world_with_sp_order_variations``."""
    jrespec, JSpec = J
    s, js = ParallelSpec.parse(spec), JSpec.parse(spec)
    for order in (None, ("shed_dp",), ("shed_dp", "fold_pp"),
                  ("shed_dp", "fold_pp", "fold_sp"), RUNGS):
        for min_dp in (1, 2):
            assert min_world(s, min_dp=min_dp, order=order) == \
                jrespec.min_world(js, min_dp=min_dp, order=order)
    if spec == SPEC:
        assert min_world(s) == 1
        assert min_world(s, order=("shed_dp",)) == 4
        assert min_world(s, min_dp=2, order=("shed_dp",)) == 8
    if spec == SP_SPEC:
        assert min_world(s, order=("shed_dp", "fold_pp")) == 4
        assert min_world(s, order=("shed_dp", "fold_pp", "fold_sp")) == 2


def test_decision_and_counter():
    """A decision is a frozen value with the ``rung:spec`` line; each
    applied reshape counts once in ``hvd_tpu_respec_total{from,to}``."""
    d = RespecDecision("shed_dp", ParallelSpec.parse("dp=1,pp=2"), 2)
    assert d.describe() == "shed_dp:dp=1,pp=2"
    with pytest.raises(Exception):
        d.np = 3
    if not metrics_lib.enabled():
        return
    key = {"from": "dp=2,pp=2", "to": "dp=1,pp=2"}

    def value():
        for s in metrics_lib.snapshot().get(
                "hvd_tpu_respec_total", {}).get("samples", []):
            if all(s["labels"].get(k) == v for k, v in key.items()):
                return s["value"]
        return 0.0

    before = value()
    respec_lib.note_respec(key["from"], key["to"])
    assert value() == before + 1
