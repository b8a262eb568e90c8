"""The port's serve plane against the JAX package's, and the port's
package rules.

The slice as a whole mirrors ``test_serve.py``'s
``test_disagg_cluster_completes_and_repeats_byte_identically``: the same
seeded Poisson trace on a ``roles={"prefill": 1, "decode": 1}`` cluster
(gpt_tiny, fp32 cache kind, 4 slots, 32 lines, prompts up to 16) through
both packages must give identical per-request token streams, identical
event and decision logs, identical trace ledgers, zero drops, and a K2/K4
codec call on every K/V leaf of every handoff. The port's repeat run is
byte-identical.
"""

import hashlib
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.models import gpt as jgpt
from horovod_tpu.serve import controller as jcontroller
from horovod_tpu.serve import engine as jengine
from horovod_tpu.serve import kvcache as jkv
from horovod_tpu.serve import tracing as jtracing
from horovod_tpu.serve import traffic as jtraffic
from horovod_tpu_torch.models import convert, gpt
from horovod_tpu_torch.ops import kernels
from horovod_tpu_torch.serve import controller, engine, tracing, traffic
from horovod_tpu_torch.serve import kvcache as kv

GEOMETRY = dict(slots=4, max_len=32, max_prompt_len=16)
ROLES = {"prefill": 1, "decode": 1}


def _trace_args():
    return dict(seed=5, n_requests=20, rate_rps=20.0)


@pytest.fixture(scope="module")
def flax_tiny():
    jm = jgpt.gpt_tiny()
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))
    return jm, params, jax.tree.map(np.asarray, params)


def _port_model(np_params):
    tm = gpt.gpt_tiny()
    tm.load_state_dict(convert.gpt_params_from_jax(np_params))
    return tm


def _digest(report):
    return hashlib.sha256(json.dumps(
        [report["events"], report["decisions"]]).encode()).hexdigest()


@pytest.fixture(scope="module")
def runs(flax_tiny):
    """One JAX run and two port runs of the disaggregated cluster; the
    port runs count the plain codec calls."""
    jm, params, np_params = flax_tiny
    jtracing.reset()
    jc = jcontroller.ServeCluster(
        jengine.make_engine_factory(jm, params, **GEOMETRY),
        policy=jcontroller.SLOPolicy(), roles=ROLES, step_s=0.05,
        log_path="")
    jrep = jc.run(jtraffic.poisson_trace(**_trace_args()))
    jdigest = jtracing.tracer().digest()

    calls = {"quantize": 0, "dequantize": 0}
    quant, dequant = kernels._quantize_plain, kernels._dequantize_plain

    def spy_quant(*a, **k):
        calls["quantize"] += 1
        return quant(*a, **k)

    def spy_dequant(*a, **k):
        calls["dequantize"] += 1
        return dequant(*a, **k)

    port = []
    mp = pytest.MonkeyPatch()
    mp.setattr(kernels, "_quantize_plain", spy_quant)
    mp.setattr(kernels, "_dequantize_plain", spy_dequant)
    try:
        for _ in range(2):
            tracing.reset()
            for k in calls:
                calls[k] = 0
            c = controller.ServeCluster(
                engine.make_engine_factory(_port_model(np_params),
                                           device="cpu", **GEOMETRY),
                policy=controller.SLOPolicy(), roles=ROLES, step_s=0.05,
                log_path="")
            rep = c.run(traffic.poisson_trace(**_trace_args()))
            port.append((c, rep, dict(calls), tracing.tracer().digest()))
    finally:
        mp.undo()
    return (jc, jrep, jdigest), port


def test_disagg_cluster_matches_jax(runs):
    (jc, jrep, jdigest), port = runs
    c, rep, calls, digest = port[0]
    assert rep["dropped"] == 0
    assert rep["completed"] == rep["submitted"] == 20
    assert {r.rid: r.tokens for r in c.completed} == \
        {r.rid: r.tokens for r in jc.completed}
    assert rep["events"] == jrep["events"]
    assert rep["decisions"] == jrep["decisions"]
    assert digest == jdigest
    multi = sum(1 for r in c.completed if len(r.tokens) > 1)
    assert rep["handoffs"] >= max(1, multi)
    assert rep["pending_handoffs"] == 0
    for key in ("handoffs", "prefill_tokens", "generated_tokens",
                "rounds", "ttft_p50_s", "tpot_p50_s", "goodput"):
        assert rep[key] == jrep[key], key


def test_every_handoff_runs_the_codec(runs):
    """Each handoff quantizes (export) and dequantizes (import) every
    model-dtype K/V leaf — 2 leaves x 2 layers of gpt_tiny — through the
    codec's plain path on the CPU."""
    _, port = runs
    _, rep, calls, _ = port[0]
    leaves = 2 * 2
    assert calls == {"quantize": leaves * rep["handoffs"],
                     "dequantize": leaves * rep["handoffs"]}


def test_port_repeat_is_byte_identical(runs):
    _, port = runs
    (c1, rep1, _, d1), (c2, rep2, _, d2) = port
    assert _digest(rep1) == _digest(rep2)
    assert d1 == d2
    assert [r.tokens for r in c1.completed] == \
        [r.tokens for r in c2.completed]


def _filled_pair(rng, kind):
    """A JAX cache and a port cache holding the same seeded contents."""
    shape = (3, 32, 4, 16)
    jc = jkv.init_cache(2, 3, 32, 4, 16, kind=kind)
    tc = kv.init_cache(2, 3, 32, 4, 16, kind=kind, device="cpu")
    layers = []
    for jl, tl in zip(jc["layers"], tc["layers"]):
        new = {}
        for name in jl:
            leaf_shape = shape if not name.endswith("_s") else shape[:3]
            if jl[name].dtype == np.int8:
                a = rng.integers(-127, 128, leaf_shape).astype(np.int8)
            else:
                a = (rng.standard_normal(leaf_shape) * 2).astype(
                    np.float32)
            new[name] = jax.numpy.asarray(a)
            tl[name].copy_(torch.from_numpy(a))
        layers.append(new)
    pos = np.array([7, 32, 40], np.int32)
    sp = rng.integers(-1, 40, (3, 32)).astype(np.int32)
    jc = {"layers": tuple(layers), "pos": jax.numpy.asarray(pos),
          "slot_pos": jax.numpy.asarray(sp)}
    tc["pos"].copy_(torch.from_numpy(pos))
    tc["slot_pos"].copy_(torch.from_numpy(sp))
    return jc, tc


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_export_import_slot_matches_jax_blobs(rng, kind):
    """Slot export: the same blob contents as the JAX package's (codes
    and scales of every quantized leaf, raw leaves, bookkeeping); import
    into a fresh cache lands the same values."""
    jc, tc = _filled_pair(rng, kind)
    jblob = jkv.export_slot(jc, 1, use_pallas=False)
    tblob = kv.export_slot(tc, 1)
    for jl, tl in zip(jblob["layers"], tblob["layers"]):
        assert set(jl) == set(tl)
        for name in jl:
            if "raw" in jl[name]:
                np.testing.assert_array_equal(tl[name]["raw"].numpy(),
                                              np.asarray(jl[name]["raw"]))
                continue
            np.testing.assert_array_equal(tl[name]["q"].numpy(),
                                          np.asarray(jl[name]["q"]))
            np.testing.assert_array_equal(tl[name]["s"].numpy(),
                                          np.asarray(jl[name]["s"]))
            assert tl[name]["n"] == jl[name]["n"]
            assert tl[name]["shape"] == tuple(jl[name]["shape"])
            assert tl[name]["dtype"] == jl[name]["dtype"]
    assert int(tblob["pos"]) == int(jblob["pos"])
    np.testing.assert_array_equal(tblob["slot_pos"].numpy(),
                                  np.asarray(jblob["slot_pos"]))
    jdest = jkv.import_slot(jkv.init_cache(2, 2, 32, 4, 16, kind=kind), 0,
                            jblob, use_pallas=False)
    tdest = kv.import_slot(kv.init_cache(2, 2, 32, 4, 16, kind=kind,
                                         device="cpu"), 0, tblob)
    for jl, tl in zip(jdest["layers"], tdest["layers"]):
        for name in jl:
            np.testing.assert_array_equal(tl[name].numpy(),
                                          np.asarray(jl[name]))
    np.testing.assert_array_equal(tdest["slot_pos"].numpy(),
                                  np.asarray(jdest["slot_pos"]))
    # The blob owns its raw leaves: overwriting the source slot later
    # must not change what the blob ships.
    for layer in tc["layers"]:
        for leaf in layer.values():
            leaf[1].zero_()
    again = kv.import_slot(kv.init_cache(2, 2, 32, 4, 16, kind=kind,
                                         device="cpu"), 0, tblob)
    for jl, tl in zip(jdest["layers"], again["layers"]):
        for name in jl:
            np.testing.assert_array_equal(tl[name].numpy(),
                                          np.asarray(jl[name]))


def test_traffic_and_controller_match_jax():
    """Seeded traffic is identical, and the SLO controller makes the
    same role-targeted decisions from the same signals."""
    args = dict(seed=11, n_requests=30, rate_rps=7.0,
                prompt_lens=(3, 9), temperature=0.5,
                class_mix=[("latency", 0.5), ("batch", 0.5)])
    a = jtraffic.poisson_trace(**args).requests
    b = traffic.poisson_trace(**args).requests
    assert [vars(r) for r in a] == [vars(r) for r in b]
    pol = dict(max_queue_depth=4, max_handoff_depth=3, grow_cooldown_s=0.0,
               min_replicas=2, max_replicas=6, low_occupancy=0.5)
    ticks = [dict(now=1.0, live=2, draining=0, queue_depth=9,
                  occupancy=0.9, below_min=False, disagg=True),
             dict(now=2.0, live=3, draining=0, queue_depth=0,
                  occupancy=0.9, below_min=False, handoff_depth=7,
                  disagg=True),
             dict(now=3.0, live=1, draining=0, queue_depth=0,
                  occupancy=0.0, below_min=True, restore_role="prefill",
                  disagg=True),
             dict(now=9.0, live=4, draining=0, queue_depth=0,
                  occupancy=0.1, below_min=False, shrink_candidate="r3",
                  disagg=True)]
    logs = []
    for mod in (jcontroller, controller):
        ctl = mod.ServeController(mod.SLOPolicy(**pol), log_path="")
        for t in ticks:
            ctl.tick(**t)
        logs.append(ctl.decision_log())
    assert logs[0] == logs[1] and len(logs[0]) == 4


def test_sampling_is_seeded_and_greedy_is_default(flax_tiny):
    """temperature > 0 draws from a generator seeded by (seed, rid,
    position) alone: the same request gives the same tokens on a fresh
    engine; temperature 0 stays greedy argmax."""
    _, _, np_params = flax_tiny
    factory = engine.make_engine_factory(_port_model(np_params),
                                         device="cpu", **GEOMETRY)
    reqs = traffic.poisson_trace(seed=3, n_requests=2, rate_rps=5.0,
                                 temperature=0.8).requests
    outs = []
    for _ in range(2):
        eng = factory("r0")
        for r in reqs:
            r.max_new_tokens = 6
            eng.admit(r)
        done = []
        while eng.active_count():
            done.extend(eng.step())
        outs.append({r.rid: r.tokens for r in done})
    assert outs[0] == outs[1]
    assert all(len(t) == 6 for t in outs[0].values())


def test_entry_points_follow_the_device_rule(flax_tiny):
    """No GPU and no explicit device="cpu": the factory and the engine
    raise instead of falling back; unported levers raise
    NotImplementedError naming a later slice."""
    _, _, np_params = flax_tiny
    tm = _port_model(np_params)
    for kw in ({"parallel": object()}, {"spec_k": 2},
               {"prefix_cache": object()}):
        with pytest.raises(NotImplementedError, match="later serve slice"):
            engine.make_engine_factory(tm, device="cpu", **kw)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.make_engine_factory(tm, **GEOMETRY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.DecodeEngine(tm, **GEOMETRY)


def test_metrics_and_flight_recorder_see_the_run(runs):
    """The serve families register under the JAX package's names, and
    every decode round leaves a ``serve`` flight-recorder event."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.common import flightrec

    snap = metrics()
    for name in ("hvd_tpu_serve_handoffs_total", "hvd_tpu_serve_tokens_total",
                 "hvd_tpu_serve_ttft_seconds", "hvd_tpu_serve_queue_depth",
                 "hvd_tpu_serve_kv_cache_bytes"):
        assert name in snap, name
    assert snap["hvd_tpu_serve_handoffs_total"]["samples"][0]["value"] >= \
        runs[1][0][1]["handoffs"]
    evs = [e for e in flightrec.recorder().events() if e["op"] == "serve"]
    assert evs and all(e["outcome"] == "ok" for e in evs)


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports the whole port (package, serve stack,
    models, kernels) and finds no jax, flax or horovod_tpu module
    loaded."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.serve import controller, engine, batcher,"
        " kvcache, queue, tracing, traffic, overload\n"
        "from horovod_tpu_torch.models import gpt, convert\n"
        "from horovod_tpu_torch.ops import kernels\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'horovod_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
