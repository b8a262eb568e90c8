"""The port's serve plane against the JAX package's, and the port's
package rules.

The slice as a whole mirrors ``test_serve.py``'s
``test_disagg_cluster_completes_and_repeats_byte_identically``: the same
seeded Poisson trace on a ``roles={"prefill": 1, "decode": 1}`` cluster
(gpt_tiny, fp32 cache kind, 4 slots, 32 lines, prompts up to 16) through
both packages must give identical per-request token streams, identical
event and decision logs, identical trace ledgers, zero drops, and a K2/K4
codec call on every K/V leaf of every handoff, all of a handoff side's
leaves in one grouped call. The port's repeat run is byte-identical.
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


@pytest.fixture(scope="module")
def grouped_calls(flax_tiny):
    """One port run of the disaggregated cluster with spies on the
    grouped codec entries: the leaves of each call, by side."""
    _, _, np_params = flax_tiny
    calls = {"quantize": [], "dequantize": []}
    group, into = kernels.quantize_int8_group, kernels.dequantize_int8_into

    def spy_group(xs):
        xs = list(xs)
        calls["quantize"].append(len(xs))
        return group(xs)

    def spy_into(items, outs):
        items = list(items)
        calls["dequantize"].append(len(items))
        return into(items, outs)

    mp = pytest.MonkeyPatch()
    mp.setattr(kernels, "quantize_int8_group", spy_group)
    mp.setattr(kernels, "dequantize_int8_into", spy_into)
    try:
        tracing.reset()
        c = controller.ServeCluster(
            engine.make_engine_factory(_port_model(np_params),
                                       device="cpu", **GEOMETRY),
            policy=controller.SLOPolicy(), roles=ROLES, step_s=0.05,
            log_path="")
        rep = c.run(traffic.poisson_trace(**_trace_args()))
    finally:
        mp.undo()
    return rep, calls


def test_each_handoff_side_is_one_grouped_codec_call(grouped_calls):
    """Export makes one ``quantize_int8_group`` call and import one
    ``dequantize_int8_into`` call per handoff, each carrying all four
    K/V leaves of gpt_tiny's two layers."""
    rep, calls = grouped_calls
    assert rep["handoffs"] >= 1
    assert calls == {"quantize": [4] * rep["handoffs"],
                     "dequantize": [4] * rep["handoffs"]}


def _spy_import(monkeypatch, cache):
    """Spy on one ``import_slot`` into ``cache``: the outputs of each
    ``dequantize_int8_into`` call as (data_ptr, storage ptr, dtype,
    shape), and the ``copy_`` calls made outside it whose destination
    is a K/V leaf of ``cache`` (inside it, the CPU's plain version
    writes its result with a ``copy_``; the card's kernel stores in
    place)."""
    ptrs = {leaf.untyped_storage().data_ptr()
            for layer in cache["layers"] for leaf in layer.values()}
    seen = {"calls": [], "copies": 0, "inside": False}
    copy, into = torch.Tensor.copy_, kernels.dequantize_int8_into

    def spy_copy(self, src, *a, **k):
        if not seen["inside"] and self.untyped_storage().data_ptr() in ptrs:
            seen["copies"] += 1
        return copy(self, src, *a, **k)

    def spy_into(items, outs):
        seen["calls"].append([(o.data_ptr(), o.untyped_storage().data_ptr(),
                               o.dtype, tuple(o.shape)) for o in outs])
        seen["inside"] = True
        try:
            return into(items, outs)
        finally:
            seen["inside"] = False

    monkeypatch.setattr(torch.Tensor, "copy_", spy_copy)
    monkeypatch.setattr(kernels, "dequantize_int8_into", spy_into)
    return seen, ptrs


def _bf16_pair(rng):
    """A JAX and a port bf16 fp32-kind cache with the same contents."""
    shape = (3, 32, 4, 16)
    jc = jkv.init_cache(2, 3, 32, 4, 16, dtype=jax.numpy.bfloat16)
    tc = kv.init_cache(2, 3, 32, 4, 16, dtype=torch.bfloat16, device="cpu")
    layers = []
    for jl, tl in zip(jc["layers"], tc["layers"]):
        new = {}
        for name in jl:
            a = jax.numpy.asarray(rng.standard_normal(shape) * 2,
                                  jax.numpy.bfloat16)
            new[name] = a
            tl[name].copy_(torch.from_numpy(
                np.array(a.astype(jax.numpy.float32))))
        layers.append(new)
    pos = np.array([5, 9, 32], np.int32)
    sp = rng.integers(-1, 32, (3, 32)).astype(np.int32)
    jc = {"layers": tuple(layers), "pos": jax.numpy.asarray(pos),
          "slot_pos": jax.numpy.asarray(sp)}
    tc["pos"].copy_(torch.from_numpy(pos))
    tc["slot_pos"].copy_(torch.from_numpy(sp))
    return jc, tc


def test_import_dequantizes_straight_into_the_slot(rng, monkeypatch):
    """Blob dtype equal to the cache's: one ``dequantize_int8_into``
    call whose outputs ARE the ``leaf[slot]`` views, no temporary and no
    ``copy_`` into a K/V leaf; the landed values equal the JAX
    ``import_slot``'s bitwise."""
    jc, tc = _bf16_pair(rng)
    jblob = jkv.export_slot(jc, 2, use_pallas=False)
    tblob = kv.export_slot(tc, 2)
    dest = kv.init_cache(2, 2, 32, 4, 16, dtype=torch.bfloat16,
                         device="cpu")
    seen, _ = _spy_import(monkeypatch, dest)
    kv.import_slot(dest, 1, tblob)
    assert seen["calls"] == [[
        (leaf[1].data_ptr(), leaf.untyped_storage().data_ptr(),
         torch.bfloat16, (32, 4, 16))
        for layer in dest["layers"] for leaf in layer.values()]]
    assert seen["copies"] == 0
    monkeypatch.undo()
    jdest = jkv.import_slot(
        jkv.init_cache(2, 2, 32, 4, 16, dtype=jax.numpy.bfloat16), 1,
        jblob, use_pallas=False)
    for jl, tl in zip(jdest["layers"], dest["layers"]):
        for name in jl:
            np.testing.assert_array_equal(
                tl[name].to(torch.float32).numpy(),
                np.asarray(jl[name].astype(jax.numpy.float32)))


def test_import_casts_a_bf16_blob_into_an_fp32_cache_like_jax(rng,
                                                              monkeypatch):
    """Blob dtype other than the cache's: the one grouped call
    dequantizes into bf16 temporaries, each then cast into its slot by a
    ``copy_`` (one rounding to bf16, then an exact widening), bitwise the
    JAX ``import_slot`` of the same bf16 blob into an fp32 cache."""
    jc, tc = _bf16_pair(rng)
    jblob = jkv.export_slot(jc, 0, use_pallas=False)
    tblob = kv.export_slot(tc, 0)
    dest = kv.init_cache(2, 2, 32, 4, 16, dtype=torch.float32,
                         device="cpu")
    seen, leaf_ptrs = _spy_import(monkeypatch, dest)
    kv.import_slot(dest, 1, tblob)
    (outs,) = seen["calls"]
    assert len(outs) == 4
    assert all(dt == torch.bfloat16 and ptr not in leaf_ptrs
               for _, ptr, dt, _ in outs)
    assert seen["copies"] == 4
    monkeypatch.undo()
    jdest = jkv.import_slot(jkv.init_cache(2, 2, 32, 4, 16), 1, jblob,
                            use_pallas=False)
    for jl, tl in zip(jdest["layers"], dest["layers"]):
        for name in jl:
            assert tl[name].dtype == torch.float32
            np.testing.assert_array_equal(tl[name].numpy(),
                                          np.asarray(jl[name]))


def test_import_refuses_a_non_contiguous_slot():
    """The import writes the slot in place and never stages a copy: a
    cache whose slot view is not contiguous raises."""
    src = kv.init_cache(1, 2, 32, 4, 16, device="cpu")
    blob = kv.export_slot(src, 0)
    dest = kv.init_cache(1, 2, 32, 4, 16, device="cpu")
    for name, leaf in dest["layers"][0].items():
        dest["layers"][0][name] = leaf.transpose(1, 2).contiguous() \
            .transpose(1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        kv.import_slot(dest, 0, blob)


def test_import_refuses_a_blob_of_another_geometry():
    """A blob whose leaves hold as many values as the slot in another
    shape raises instead of landing reshaped."""
    blob = kv.export_slot(kv.init_cache(1, 2, 32, 4, 16, device="cpu"), 0)
    dest = kv.init_cache(1, 2, 32, 16, 4, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        kv.import_slot(dest, 0, blob)


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
    raise instead of falling back, with every serve lever too. On the
    CPU the levers are ported: the factory takes a prefix cache and a
    draft model (moved to the engine's device), and refuses a tp spec
    over a model built without the axis, naming ``tp_axis``."""
    from horovod_tpu_torch.serve.prefix import PrefixCache

    _, _, np_params = flax_tiny
    tm = _port_model(np_params)
    draft = gpt.gpt_tiny()
    levers = ({"parallel": "tp=2"}, {"draft_model": draft, "spec_k": 2},
              {"prefix_cache": PrefixCache()})
    eng = engine.make_engine_factory(tm, device="cpu", **levers[1],
                                     **levers[2], **GEOMETRY)("r0")
    assert eng.spec_k == 2 and eng.spec_enabled
    assert eng.prefix_cache is levers[2]["prefix_cache"]
    assert {p.device.type for p in eng.draft_model.parameters()} == {"cpu"}
    with pytest.raises(ValueError, match="tp_axis"):
        engine.make_engine_factory(tm, device="cpu", **levers[0],
                                   **GEOMETRY)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    for kw in ({},) + levers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.make_engine_factory(tm, **kw, **GEOMETRY)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.DecodeEngine(tm, **kw, **GEOMETRY)


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
    training stack, models, kernels) and finds no jax, flax or
    horovod_tpu module loaded."""
    code = (
        "import sys\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.serve import controller, engine, batcher,"
        " kvcache, queue, tracing, traffic, overload\n"
        "from horovod_tpu_torch.models import gpt, convert\n"
        "from horovod_tpu_torch.ops import kernels, flash_attention,"
        " collectives, compression\n"
        "from horovod_tpu_torch.common import basics, fusion, exceptions\n"
        "from horovod_tpu_torch import optim\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'horovod_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
