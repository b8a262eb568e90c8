"""The port's fleet twin (``horovod_tpu_torch/common/fleetsim.py``)
against the JAX package's.

* Every banked scenario of ``results/fleetsim/`` through the port's
  ``run_scenario(device="cpu")`` equals its JSON record exactly (the
  oracle of ``test_fleetsim.py``). The serve-kind scenarios run twice:
  with the port's seeded ``gpt_tiny`` and with the JAX ``gpt_tiny``'s
  initial parameters carried across by ``models/convert.py`` — a serve
  record does not depend on token values (no ``eos_id``, virtual
  clocks), so both must equal the record.
* ``diurnal_trace``, ``simulate_roles`` and the trace-replay functions
  equal the JAX functions' output on the same inputs; a seed override's
  record equals the JAX one's.
* Repeat byte identity, the tick cap through its knob, and the
  validation messages (worded as the JAX module words them).
"""

import copy
import json

import numpy as np
import pytest

from horovod_tpu_torch.common import fleetsim
from horovod_tpu_torch.models import convert, gpt
from test_torch_port_worlds import REPO

TRAIN = ("preempt_storm_4k", "rack_failure", "slow_burn", "flapping_host")
SERVE = ("diurnal_serve", "overload_storm")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The serve worlds' tiny GPT on one torch thread: the default pool
    (a thread a core) only contends with the rest of the suite. The
    records do not depend on it."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def banked(name):
    with open(REPO / "results" / "fleetsim" / f"{name}.json") as f:
        return json.load(f)


def _jax():
    from horovod_tpu.common import fleetsim as jfleetsim

    return jfleetsim


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_banked_scenario_replays_exactly(name):
    rec = fleetsim.run_scenario(name, device="cpu")
    assert rec == banked(name)
    assert json.dumps(rec, sort_keys=True) == \
        json.dumps(banked(name), sort_keys=True)


@pytest.fixture(scope="module")
def jax_gpt_tiny():
    """The JAX ``gpt_tiny``'s initial parameters as the port's model."""
    import jax
    from horovod_tpu.models import gpt_tiny as jgpt_tiny

    params = jgpt_tiny().init(jax.random.PRNGKey(0),
                              np.zeros((1, 4), np.int32))
    model = gpt.gpt_tiny()
    model.load_state_dict(convert.gpt_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return model


@pytest.mark.parametrize("name", SERVE)
def test_serve_scenario_with_the_jax_weights(name, jax_gpt_tiny):
    rec = fleetsim.run_scenario(name, device="cpu",
                                model=copy.deepcopy(jax_gpt_tiny))
    assert rec == banked(name)


def test_serve_scenario_report_matches_the_jax_report():
    """The full report behind a record: the same keys, and the same
    virtual-time percentiles, counts and decisions as the JAX run's."""
    name = "diurnal_serve"
    rec, rep = fleetsim.serve_scenario_report(name, device="cpu")
    jrec, jrep = _jax().serve_scenario_report(name)
    assert rec == jrec == banked(name)
    assert set(rep) == set(jrep)
    for key, want in jrep.items():
        if isinstance(want, (int, float, str)) or key == "decisions":
            assert rep[key] == want, key


def test_serve_scenario_report_needs_a_serve_kind():
    with pytest.raises(ValueError, match="serve-kind"):
        fleetsim.serve_scenario_report("slow_burn", device="cpu")


def test_serve_scenario_raises_without_a_gpu():
    """No fallback: the default device is the GPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleetsim.run_scenario("diurnal_serve")


def test_repeat_byte_identity():
    a = json.dumps(fleetsim.run_scenario("flapping_host"), sort_keys=True)
    b = json.dumps(fleetsim.run_scenario("flapping_host"), sort_keys=True)
    assert a == b


@pytest.mark.parametrize("name,seed", [("slow_burn", 7),
                                       ("flapping_host", 3)])
def test_seed_override_matches_jax(name, seed):
    rec = fleetsim.run_scenario(name, seed=seed, device="cpu")
    assert rec["seed"] == seed and rec != banked(name)
    assert rec == _jax().run_scenario(name, seed=seed)


def test_tick_cap_guards_runaway_scenarios(monkeypatch):
    scn = fleetsim.FleetScenario(name="runaway", hosts=2, duration_s=10.0,
                                 policy={"tick_interval_s": 0.25,
                                         "publish_interval_s": 0.0})
    monkeypatch.setenv("HVD_TPU_FLEETSIM_TICK_CAP", "10")
    with pytest.raises(ValueError, match="FLEETSIM_TICK_CAP"):
        fleetsim.simulate_fleet(scn)
    monkeypatch.setenv("HVD_TPU_FLEETSIM_TICK_CAP", "41")
    assert fleetsim.simulate_fleet(scn).stats["ticks"] == 40


def test_fleetsim_knobs_are_registered():
    from horovod_tpu.common import config as jconfig
    from horovod_tpu_torch.common import config

    for name in ("FLEETSIM_BASELINE_DIR", "FLEETSIM_SEED",
                 "FLEETSIM_TICK_CAP"):
        assert config.RUNTIME_KNOBS[name] == jconfig.RUNTIME_KNOBS[name]


BAD_SCENARIOS = [
    {"name": "x", "hostz": 4}, {"hosts": 4},
    {"name": "x", "kind": "batch"}, {"name": "x", "hosts": 0},
    {"name": "x", "duration_s": -1.0},
    {"name": "x", "events": [{"kind": "meteor", "t": 1.0}]},
    {"name": "x", "events": [{"kind": "flap", "when": 1.0}]}, [1, 2],
]


@pytest.mark.parametrize("data", BAD_SCENARIOS, ids=str)
def test_validation_messages_match_jax(data):
    with pytest.raises(ValueError) as want:
        _jax().FleetScenario.from_dict(copy.deepcopy(data))
    with pytest.raises(ValueError) as got:
        fleetsim.FleetScenario.from_dict(copy.deepcopy(data))
    assert str(got.value) == str(want.value)


def test_unknown_scenario_and_event_named():
    with pytest.raises(ValueError, match="nope"):
        fleetsim.run_scenario("nope")
    with pytest.raises(ValueError, match="meteor"):
        fleetsim.FleetEvent.from_dict({"kind": "meteor", "t": 1.0})


# -- the traffic model, the role-aware twin and trace replay -----------------

@pytest.mark.parametrize("args", [
    (3, 80, 2.0, 40.0, 8.0, (4, 8, 16), (4, 8, 16, 32), 128),
    (11, 48, 2.0, 24.0, 6.0, (64, 128, 256), (16, 32), 50257)])
def test_diurnal_trace_matches_jax(args):
    got = fleetsim.diurnal_trace(*args)
    want = _jax().diurnal_trace(*args)
    assert got.seed == want.seed
    assert [(r.rid, r.arrival_t, r.prompt, r.max_new_tokens)
            for r in got.requests] == \
        [(r.rid, r.arrival_t, r.prompt, r.max_new_tokens)
         for r in want.requests]


def test_diurnal_trace_validates_rates():
    with pytest.raises(ValueError, match="peak_rps"):
        fleetsim.diurnal_trace(0, 10, 5.0, 2.0)


@pytest.mark.parametrize("spec,straggler,ranks_per_host", [
    ("dp=2,pp=2", 2, 1), ("dp=4,pp=2,tp=2", 5, 2)])
def test_simulate_roles_matches_jax(spec, straggler, ranks_per_host):
    from horovod_tpu.parallel.spec import ParallelSpec as JSpec
    from horovod_tpu_torch.parallel.spec import ParallelSpec

    policy = {"tick_interval_s": 0.25, "publish_interval_s": 0.0,
              "window": 8, "straggler_patience": 2, "min_ranks": 3,
              "evict_cooldown_s": 0.5}
    parsed = ParallelSpec.parse(spec)
    kw = dict(hosts=[f"host{i}" for i in
                     range(parsed.total // ranks_per_host)],
              ranks_per_host=ranks_per_host, straggler_rank=straggler,
              straggler_delay=0.4, ticks=12, min_np=parsed.replica_ranks)
    got = fleetsim.simulate_roles(ParallelSpec.parse(spec), policy, **kw)
    want = _jax().simulate_roles(JSpec.parse(spec), policy, **kw)
    assert got == want
    assert any(json.loads(d)["action"] == "evict" for d in got)


def _replay_inputs(tmp_path):
    dump = tmp_path / "podmetrics.jsonl"
    rows = [{"rank": 0, "host": "a", "step_time_s": 0.10},
            {"rank": 0, "host": "a", "step_time_s": 0.30},
            {"rank": 0, "host": "a", "step_time_s": 0.20},
            {"rank": 1, "host": "b", "p50": 0.50},
            {"rank": 2, "step_time_s": 0.40},
            {"rank": 3, "host": "c"},
            {"rank": 4, "host": "d", "value": 0.1}]
    dump.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    boxes = tmp_path / "boxes"
    boxes.mkdir()
    for i, box in enumerate([
            {"rank": 0, "host": "a", "trigger": "stall_timeout"},
            {"rank": 1, "host": "b", "trigger": "peer_failure", "step": 6},
            {"rank": 9, "trigger": "stall_timeout"},
            {"rank": 4, "host": "d", "trigger": "manual"}]):
        (boxes / f"blackbox.rank{i}.json").write_text(json.dumps(box))
    (boxes / "blackbox.rank7.json").write_text("not json")
    return str(dump), str(boxes)


def test_trace_replay_matches_jax(tmp_path):
    dump, boxes = _replay_inputs(tmp_path)
    j = _jax()
    assert fleetsim.steptimes_from_podmetrics(dump) == \
        j.steptimes_from_podmetrics(dump) == \
        {"a": 0.2, "b": 0.5, "d": 0.1, "rank2": 0.4}
    assert fleetsim.plan_from_flightrec(boxes) == \
        j.plan_from_flightrec(boxes)
    got = fleetsim.scenario_from_traces("replay", podmetrics=dump,
                                        flightrec=boxes, duration_s=5.0)
    want = j.scenario_from_traces("replay", podmetrics=dump,
                                  flightrec=boxes, duration_s=5.0)
    assert got.to_dict() == want.to_dict()
    assert [f["host"] for f in got.plan["faults"]] == ["a", "b"]


def test_replay_scenario_runs_as_jax_does(tmp_path):
    dump = tmp_path / "m.jsonl"
    dump.write_text("\n".join(json.dumps(
        {"rank": i, "host": f"w{i}",
         "step_time_s": 0.1 if i else 0.5}) for i in range(4)) + "\n")
    policy = {"tick_interval_s": 0.25, "publish_interval_s": 0.0,
              "window": 8, "straggler_patience": 2, "min_ranks": 3}
    got = fleetsim.run_scenario(fleetsim.scenario_from_traces(
        "incident", podmetrics=str(dump), duration_s=8.0, policy=policy))
    want = _jax().run_scenario(_jax().scenario_from_traces(
        "incident", podmetrics=str(dump), duration_s=8.0, policy=policy))
    assert got == want
    assert {json.loads(d)["target"] for d in got["decisions"]
            if json.loads(d)["action"] == "evict"} == {"w0"}


def test_scenario_library_matches_jax():
    got = {k: v.to_dict() for k, v in fleetsim.builtin_scenarios().items()}
    want = {k: v.to_dict() for k, v in _jax().builtin_scenarios().items()}
    assert got == want
