"""The port's serve levers against the JAX package's: the shared-prefix
cache and its fork, speculative decoding with a draft model, tp-sharded
decode over a head-sharded KV ring, and the brownout ladder's
``spec_off`` rung — the oracles of ``test_serve.py``'s lever tests, each
held against the JAX engine or cluster on the same inputs.

* gpt_tiny in fp32 with the same seeded numpy weights in both packages
  (the flax init perturbed by a seeded normal draw, so no LayerNorm
  scale or bias is at its initial value); the draft is a second draw.
* Greedy token streams, event and decision logs, trace digests and the
  engines' prefix and spec counters are compared exactly; logits by
  ``test_serve.py``'s bounds (``FP32_ATOL`` absolute, ``INT8_REL`` of
  the largest logit).
* The tp cases run in a gloo world of 2 (this file as ``--levers-worker
  RANK OUT PARAMS``, one world a test session through
  ``test_torch_port_worlds.session_world``); the JAX side runs in the
  test process under ``shard_map`` over 2 of the conftest's 8 CPU
  devices, holding the session's world slot as a gloo world does (its
  in-process collectives and thread pools are a world too).
* The tp wire: a port rank codes its own head shard. For the int8 kind
  the codes and per-head scales ship raw, so the ranks' blobs
  concatenated over the heads axis are the JAX blob. For the
  model-dtype kind a 4096-element block of a rank's leaf holds only its
  own heads (the JAX block spans every head of its lines), so each
  rank's decoded leaf is held within the codec's per-block bound of the
  exact slot instead.

JAX is imported only inside the ``J`` fixture: the worker processes
import this file and must not pay for it.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import convert, gpt
from horovod_tpu_torch.ops import kernels
from horovod_tpu_torch.serve import controller, engine, prefix, tracing
from horovod_tpu_torch.serve import kvcache as kv
from horovod_tpu_torch.serve import traffic
from horovod_tpu_torch.serve.queue import Request
from test_torch_port_worlds import run_ranks, session_world, world_slot

# test_serve.py's documented decode parity bounds.
FP32_ATOL = 1e-4
INT8_REL = 2e-2
GEOMETRY = dict(slots=4, max_len=32, max_prompt_len=16)
ROLES = {"prefill": 1, "decode": 1}
TP_SPEC = "tp=2"
SPEC_K = 4
# bench.py's overload arm's policy fields, at a tiny cluster's replicas.
OVERLOAD_POLICY = dict(
    tick_interval_s=0.1, window=8, min_replicas=2, max_replicas=2,
    overload=True, latency_deadline_s=3.0, throughput_deadline_s=5.0,
    admission_safety=1.2, brownout_enter_depth=10, brownout_exit_depth=2,
    brownout_enter_ticks=2, brownout_exit_ticks=2, brownout_clamp_tokens=4)
OVERLOAD_MIX = [("latency", 0.5), ("throughput", 0.3), ("batch", 0.2)]
# A load the ladder answers with spec_off alone (enter, then exit while
# slots still decode).
OVERLOAD_REQUESTS = 40
# Serve knobs of the JAX registry the port leaves out, and why
# (ROADMAP, "No counterpart, on purpose").
ABSENT_SERVE_KNOBS = {"SERVE_CLASS_MIX": "read only by the JAX bench.py"}


def _seeded(tree, seed):
    """The numpy leaves of ``tree`` plus a seeded N(0, 0.02) draw."""
    g = np.random.default_rng(seed)
    if isinstance(tree, dict):
        return {k: _seeded(v, seed * 31 + i)
                for i, (k, v) in enumerate(sorted(tree.items()))}
    a = np.asarray(tree, np.float32)
    return (a + 0.02 * g.standard_normal(a.shape)).astype(np.float32)


def _jax_weights(seed):
    import jax

    from horovod_tpu.models.gpt import gpt_tiny

    params = gpt_tiny().init(jax.random.PRNGKey(seed),
                             np.zeros((1, 4), np.int32))
    return _seeded(jax.tree.map(np.asarray, params), 1800 + seed)


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.common import config as jconfig
    from horovod_tpu.models import gpt as jgpt
    from horovod_tpu.parallel.spec import ParallelSpec
    from horovod_tpu.serve import controller as jcontroller
    from horovod_tpu.serve import engine as jengine
    from horovod_tpu.serve import kvcache as jkv
    from horovod_tpu.serve import prefix as jprefix
    from horovod_tpu.serve import queue as jqueue
    from horovod_tpu.serve import tracing as jtracing
    from horovod_tpu.serve import traffic as jtraffic

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=jconfig, gpt=jgpt, spec=ParallelSpec,
        controller=jcontroller, engine=jengine, kv=jkv, prefix=jprefix,
        queue=jqueue, tracing=jtracing, traffic=jtraffic,
        model=jgpt.gpt_tiny(), tp_model=jgpt.gpt_tiny(tp_axis="tp"),
        params=_jax_weights(0), draft=_jax_weights(1))


def _port(params, **kw):
    m = gpt.gpt_tiny(**kw)
    m.load_state_dict(convert.gpt_params_from_jax(params))
    return m


def _decode(factory, name, reqs, request_cls=Request):
    """Admit ``reqs`` (dicts) into a fresh engine and decode until every
    one finished; returns the engine and each request's tokens."""
    eng = factory(name)
    rs = [request_cls(**r) for r in reqs]
    for r in rs:
        eng.admit(r)
    while eng.active_count():
        eng.step(0.0)
    return eng, [r.tokens for r in rs]


# -- the prefix cache ---------------------------------------------------------

def test_prefix_cache_fifo_eviction_and_lookup_clamp_match_jax(J):
    """The same inserts and lookups through both packages' caches: FIFO
    eviction, the exact-prompt clamp to len - 1, the earliest entry on a
    tie, and equal ``stats()`` after every call."""
    caches = [J.prefix.PrefixCache(cap=2), prefix.PrefixCache(cap=2)]
    script = [("insert", (1, 2, 3)), ("insert", (1, 2, 3)),
              ("insert", (9,)), ("insert", (4, 5, 6)),
              ("lookup", (4, 5, 9, 9)), ("insert", (4, 5, 7)),
              ("lookup", (4, 5, 8)), ("insert", (7, 8, 9)),
              ("lookup", (1, 2, 3, 4)), ("lookup", (4, 5, 6)),
              ("lookup", (7, 8, 9)), ("lookup", (5,))]
    for op, prompt in script:
        outs = []
        for pc in caches:
            if op == "insert":
                outs.append(pc.insert(prompt, {"b": prompt}))
            else:
                hit = pc.lookup(prompt)
                outs.append(hit)
                if hit is not None:
                    pc.note_hit(hit[0])
            assert pc.stats() == caches[0].stats(), (op, prompt)
        assert outs[0] == outs[1], (op, prompt)
    pc = caches[1]
    assert pc.lookup((1, 2, 3, 4)) is None          # evicted FIFO
    assert pc.lookup((4, 5, 6)) == (2, {"b": (4, 5, 7)})   # clamp, tie
    assert prefix.PrefixCache(cap=0).insert((1, 2), {}) is False
    assert prefix._content_hash([1, 2, 3]) == \
        J.prefix._content_hash([1, 2, 3])


@pytest.mark.parametrize("raw", [None, "3", "0", "-1", "x"])
def test_prefix_cap_from_env_matches_jax(J, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("HVD_TPU_SERVE_PREFIX_CAP", raising=False)
    else:
        monkeypatch.setenv("HVD_TPU_SERVE_PREFIX_CAP", raw)
    outs = []
    for mod in (J.prefix, prefix):
        try:
            outs.append(mod.prefix_cap_from_env())
        except ValueError as e:
            outs.append(type(e))
    assert outs[0] == outs[1]
    assert prefix.DEFAULT_CAP == J.prefix.DEFAULT_CAP


def test_serve_knobs_match_the_jax_registry(J):
    """Every ``SERVE_*`` knob of the JAX registry is registered in the
    port with the same description, or named absent on purpose."""
    from horovod_tpu_torch.common import config

    jax_knobs = {k: v for k, v in J.config.RUNTIME_KNOBS.items()
                 if k.startswith("SERVE_")}
    port_knobs = {k: v for k, v in config.RUNTIME_KNOBS.items()
                  if k.startswith("SERVE_")}
    assert set(port_knobs) <= set(jax_knobs)
    for name, doc in jax_knobs.items():
        if name in ABSENT_SERVE_KNOBS:
            assert name not in port_knobs
        else:
            assert port_knobs.get(name) == doc, name
    for name in ("SERVE_PREFIX_CAP", "SERVE_SPEC_K"):
        config.runtime_env(name)             # registered: no KeyError


def _shared_prompt_reqs(tail):
    return [dict(rid=1, prompt=(5, 9, 3, 7, 2, 8) + tail, max_new_tokens=6)]


def test_prefix_fork_exact_and_reduces_prefill(J):
    """The second request sharing a system prompt forks the stored
    exact slot copy: it prefills one token, and its stream equals a
    no-cache port engine's and the JAX cached engine's."""
    geo = dict(slots=2, max_len=32, max_prompt_len=16)
    pc = prefix.PrefixCache(cap=4)
    cached = engine.make_engine_factory(_port(J.params), device="cpu",
                                        prefix_cache=pc, **geo)
    plain = engine.make_engine_factory(_port(J.params), device="cpu",
                                       **geo)
    e1, _ = _decode(cached, "rp1", _shared_prompt_reqs((11,)))
    assert e1.prefill_tokens == 7 and pc.stats()["entries"] == 1
    e2, t2 = _decode(cached, "rp2", _shared_prompt_reqs((13,)))
    _, ref = _decode(plain, "rpl", _shared_prompt_reqs((13,)))
    assert t2 == ref
    assert e2.prefill_tokens == 1
    st = pc.stats()
    assert st["hits"] == 1 and st["tokens_saved"] == 6
    jpc = J.prefix.PrefixCache(cap=4)
    jf = J.engine.make_engine_factory(J.model, J.params, prefix_cache=jpc,
                                      **geo)
    _decode(jf, "jp1", _shared_prompt_reqs((11,)), J.queue.Request)
    _, jt2 = _decode(jf, "jp2", _shared_prompt_reqs((13,)),
                     J.queue.Request)
    assert t2 == jt2 and jpc.stats() == st


def test_fresh_prefill_after_a_fork_codes_like_a_fresh_engine():
    """The engine reuses one scratch cache for every prefill; a fork
    writes lines past ``max_prompt_len`` there, and the next fresh
    prefill must leave them zero as the JAX package's fresh template
    does — the handoff codes the whole slot, so a stale line would move
    the block scale of every line beside it."""
    base = gpt.gpt_tiny().init_weights(torch.Generator().manual_seed(77))
    geo = dict(slots=1, max_len=32, max_prompt_len=16)

    def export_after(reqs, pc):
        m = gpt.gpt_tiny()
        m.load_state_dict(base.state_dict())
        eng = engine.DecodeEngine(m, device="cpu", prefix_cache=pc, **geo)
        for r in reqs[:-1]:
            eng.admit(Request(**r))
            eng.retire(0, 0.0)
        eng.admit(Request(**reqs[-1]))
        return eng.export_slot(0)

    shared = (5, 9, 3, 7, 2, 8)
    fresh = dict(rid=3, prompt=(40, 41, 42), max_new_tokens=4)
    pc = prefix.PrefixCache(cap=4)
    forked = export_after([dict(rid=1, prompt=shared + (11,),
                                max_new_tokens=4),
                           dict(rid=2, prompt=shared + (12, 13, 14),
                                max_new_tokens=4), fresh], pc)
    assert pc.stats()["hits"] == 1
    alone = export_after([fresh], None)
    for a, b in zip(forked["layers"], alone["layers"]):
        for name in a:
            for key in ("q", "s"):
                torch.testing.assert_close(a[name][key], b[name][key],
                                           rtol=0, atol=0)


# -- speculative decoding -----------------------------------------------------

SPEC_REQS = [dict(rid=0, prompt=(5, 9, 3), max_new_tokens=9),
             dict(rid=1, prompt=(7,), max_new_tokens=6)]


def _spec_counters(eng):
    return (eng.spec_rounds, eng.spec_fallback_rounds, eng.spec_proposed,
            eng.spec_accepted)


def test_speculative_decode_greedy_token_identity_matches_jax(J):
    """An independent tiny draft at k = 3: the streams equal the plain
    port engine's, and the streams and the spec counters equal the JAX
    engine's. The engine's host copy of the write heads stays the
    cache's."""
    geo = dict(slots=2, max_len=32, max_prompt_len=8)
    spec = engine.make_engine_factory(
        _port(J.params), device="cpu", draft_model=gpt.gpt_tiny(),
        draft_params=convert.gpt_params_from_jax(J.draft), spec_k=3, **geo)
    plain = engine.make_engine_factory(_port(J.params), device="cpu", **geo)
    eng = spec("rsp")
    rs = [Request(**r) for r in SPEC_REQS]
    for r in rs:
        eng.admit(r)
    while eng.active_count():
        live = [s for s, r in enumerate(eng.requests) if r is not None]
        np.testing.assert_array_equal(
            eng._pos[live], eng.cache["pos"].numpy()[live])
        eng.step(0.0)
    toks = [r.tokens for r in rs]
    _, ref = _decode(plain, "rpl", SPEC_REQS)
    assert toks == ref
    assert eng.spec_rounds >= 1 and eng.spec_proposed >= 3
    jf = J.engine.make_engine_factory(
        J.model, J.params, draft_model=J.gpt.gpt_tiny(),
        draft_params=J.draft, spec_k=3, **geo)
    jeng, jtoks = _decode(jf, "jsp", SPEC_REQS, J.queue.Request)
    assert toks == jtoks
    assert _spec_counters(eng) == _spec_counters(jeng)
    assert eng.spec_acceptance_rate() == jeng.spec_acceptance_rate()


def test_speculative_self_draft_hits_the_acceptance_ceiling(J):
    """draft == target: every compared draft token accepts, so the
    acceptance is exactly (k - 1) / k and 11 tokens take 3 rounds — the
    JAX engine's counters too."""
    k = 4
    m = _port(J.params)
    eng, toks = _decode(engine.make_engine_factory(
        m, device="cpu", draft_model=m, spec_k=k, slots=1, max_len=64,
        max_prompt_len=8), "rsd",
        [dict(rid=0, prompt=(5, 9, 3), max_new_tokens=11)])
    assert len(toks[0]) == 11
    assert eng.spec_acceptance_rate() == (k - 1) / k
    assert eng.decode_steps == eng.spec_rounds == 3
    assert eng.spec_fallback_rounds == 0
    jeng, jtoks = _decode(J.engine.make_engine_factory(
        J.model, J.params, draft_model=J.model, draft_params=J.params,
        spec_k=k, slots=1, max_len=64, max_prompt_len=8), "jsd",
        [dict(rid=0, prompt=(5, 9, 3), max_new_tokens=11)],
        J.queue.Request)
    assert toks == jtoks and _spec_counters(eng) == _spec_counters(jeng)


def test_speculative_temperature_falls_back_and_stays_synced(J):
    """A sampling request turns speculation off for its rounds; the
    fallback mirrors the draft ring, and the stream is the plain port
    engine's (sampled parity with JAX is not claimed)."""
    geo = dict(slots=1, max_len=32, max_prompt_len=8)
    req = [dict(rid=4, prompt=(2, 4, 6), max_new_tokens=8,
                temperature=0.9, sample_seed=42)]
    spec = engine.make_engine_factory(
        _port(J.params), device="cpu", draft_model=_port(J.draft),
        spec_k=3, **geo)
    plain = engine.make_engine_factory(_port(J.params), device="cpu", **geo)
    s_eng, s_toks = _decode(spec, "rsf", req)
    _, p_toks = _decode(plain, "rpf", req)
    assert s_toks == p_toks
    assert s_eng.spec_fallback_rounds >= 1 and s_eng.spec_rounds == 0
    assert int(s_eng.draft_cache["pos"][0]) == 0     # retired: reset


def test_levers_refuse_what_jax_refuses(J):
    """Speculation and tp decode together, a draft of another vocab and
    a tp spec over a model without the axis raise ValueError, as in the
    JAX engine."""
    m = _port(J.params)
    with pytest.raises(ValueError, match="separate serve levers"):
        engine.DecodeEngine(m, device="cpu", parallel=TP_SPEC,
                            draft_model=m, spec_k=2)
    with pytest.raises(ValueError, match="share a vocab"):
        engine.DecodeEngine(m, device="cpu", spec_k=2,
                            draft_model=gpt.gpt_tiny(vocab_size=64))


def test_tp_engine_rejects_mismatched_model_axis(J):
    """A tp spec over a model built without ``tp_axis`` raises naming
    it, before any world is needed (the JAX test's case)."""
    with pytest.raises(ValueError, match="tp_axis"):
        engine.DecodeEngine(_port(J.params), device="cpu",
                            parallel=TP_SPEC, name="rbad")
    with pytest.raises(ValueError, match="tp_axis"):
        J.engine.DecodeEngine(J.model, J.params,
                              parallel=J.spec.resolve({"tp": 2}),
                              name="rbad")


# -- clusters against the JAX cluster -----------------------------------------

def _prefix_trace(mod):
    shared = min(8, GEOMETRY["max_prompt_len"] - 2)
    return mod.poisson_trace(
        seed=5, n_requests=20, rate_rps=20.0, shared_prefix_len=shared,
        prompt_lens=(2, 4, GEOMETRY["max_prompt_len"] - shared))


def _cluster_run(mod_controller, mod_tracing, factory, trace, roles=None,
                 policy=None, replicas=2, hook=None):
    mod_tracing.reset()
    c = mod_controller.ServeCluster(
        factory, policy=policy or mod_controller.SLOPolicy(), roles=roles,
        replicas=replicas, step_s=0.05, log_path="")
    rep = c.run(trace, round_hook=hook)
    return c, rep, mod_tracing.tracer().digest()


def _same_run(port, jax_run):
    (c, rep, digest), (jc, jrep, jdigest) = port, jax_run
    assert rep["dropped"] == 0 and jrep["dropped"] == 0
    assert {r.rid: r.tokens for r in c.completed} == \
        {r.rid: r.tokens for r in jc.completed}
    assert rep["events"] == jrep["events"]
    assert rep["decisions"] == jrep["decisions"]
    assert digest == jdigest
    for key in ("submitted", "completed", "handoffs", "prefill_tokens",
                "generated_tokens", "rounds", "spec_proposed",
                "spec_accepted", "spec_acceptance_rate", "shed", "rejected"):
        assert rep.get(key) == jrep.get(key), key


@pytest.fixture(scope="module")
def prefix_runs(J):
    """A disaggregated cluster with one shared PrefixCache on
    shared-system-prompt traffic (bench.py's prefix arm), in both
    packages; the port run counts its codec calls."""
    jpc = J.prefix.PrefixCache(J.prefix.DEFAULT_CAP)
    jrun = _cluster_run(J.controller, J.tracing, J.engine.make_engine_factory(
        J.model, J.params, prefix_cache=jpc, **GEOMETRY),
        _prefix_trace(J.traffic), roles=ROLES)
    calls = {"plain_q": 0, "plain_dq": 0, "group_q": 0, "group_dq": 0}
    mp = pytest.MonkeyPatch()

    def spy(name, key, nonempty=False):
        orig = getattr(kernels, name)

        def wrapped(*a, **k):
            if not nonempty or len(list(a[0])):
                calls[key] += 1
            return orig(*a, **k)
        mp.setattr(kernels, name, wrapped)

    spy("_quantize_plain", "plain_q")
    spy("_dequantize_plain", "plain_dq")
    spy("quantize_int8_group", "group_q", nonempty=True)
    spy("dequantize_int8_into", "group_dq", nonempty=True)
    pc = prefix.PrefixCache(prefix.DEFAULT_CAP)
    try:
        port = _cluster_run(controller, tracing, engine.make_engine_factory(
            _port(J.params), device="cpu", prefix_cache=pc, **GEOMETRY),
            _prefix_trace(traffic), roles=ROLES)
    finally:
        mp.undo()
    return port, jrun, pc, jpc, calls


def test_prefix_cluster_matches_jax(prefix_runs):
    port, jrun, pc, jpc, _ = prefix_runs
    _same_run(port, jrun)
    st = pc.stats()
    assert st == jpc.stats() and st["hits"] >= 1
    rep = port[1]
    # Every fork's saved tokens came off the prefill work.
    prompt = sum(len(r.prompt) for r in port[0].completed)
    assert rep["prefill_tokens"] == prompt - st["tokens_saved"]


def test_prefix_forks_make_no_codec_call(prefix_runs):
    """The stored prefills and the forks are exact slot copies: the
    codec runs only for the handoffs, one grouped call a side, on every
    K/V leaf (2 x 2 of gpt_tiny)."""
    port, _, _, _, calls = prefix_runs
    h = port[1]["handoffs"]
    assert h >= 1
    assert calls == {"plain_q": 4 * h, "plain_dq": 4 * h, "group_q": h,
                     "group_dq": h}


def test_spec_cluster_matches_jax(J):
    """A colocated cluster (``roles=None``: a migrated slot's draft ring
    would be cold) of self-draft engines at k = 4."""
    trace = dict(seed=9, n_requests=16, rate_rps=20.0)
    m = _port(J.params)
    port = _cluster_run(controller, tracing, engine.make_engine_factory(
        m, device="cpu", draft_model=m, spec_k=SPEC_K, **GEOMETRY),
        traffic.poisson_trace(**trace))
    jrun = _cluster_run(J.controller, J.tracing, J.engine.make_engine_factory(
        J.model, J.params, draft_model=J.model, draft_params=J.params,
        spec_k=SPEC_K, **GEOMETRY), J.traffic.poisson_trace(**trace))
    _same_run(port, jrun)
    rep = port[1]
    assert rep["spec_proposed"] > 0
    assert rep["spec_accepted"] <= rep["spec_proposed"] * (SPEC_K - 1) \
        / SPEC_K


def _overload_trace(mod):
    return mod.poisson_trace(
        seed=11, n_requests=OVERLOAD_REQUESTS, rate_rps=40.0,
        class_mix=OVERLOAD_MIX,
        class_deadlines={
            "latency": OVERLOAD_POLICY["latency_deadline_s"],
            "throughput": OVERLOAD_POLICY["throughput_deadline_s"]})


def _overload_run(mod_controller, mod_tracing, factory, mod_traffic):
    """One overload run; the hook samples, each round, whether spec_off
    holds and the engines' spec round counters."""
    samples = []

    def hook(c, _round):
        engines = [b.engine for b in c.batchers.values()]
        samples.append((c.controller.brownout.active("spec_off"),
                        sum(e.spec_rounds for e in engines),
                        sum(e.spec_fallback_rounds for e in engines)))

    run = _cluster_run(mod_controller, mod_tracing, factory,
                       _overload_trace(mod_traffic),
                       policy=mod_controller.SLOPolicy(**OVERLOAD_POLICY),
                       hook=hook)
    return run, samples


@pytest.fixture(scope="module")
def overload_runs(J):
    m = _port(J.params)
    port = [_overload_run(controller, tracing, engine.make_engine_factory(
        m, device="cpu", draft_model=m, spec_k=SPEC_K, **GEOMETRY),
        traffic) for _ in range(2)]
    jrun = _overload_run(J.controller, J.tracing,
                         J.engine.make_engine_factory(
                             J.model, J.params, draft_model=J.model,
                             draft_params=J.params, spec_k=SPEC_K,
                             **GEOMETRY), J.traffic)
    return port, jrun


def test_overload_spec_off_rung_matches_jax(overload_runs):
    """bench.py's overload policy on self-draft engines: the ladder
    enters spec_off and leaves it; while it holds only fallback rounds
    run, after it exits speculative rounds run again; every request
    ends completed, shed or rejected; the run equals the JAX run."""
    port, (jrun, jsamples) = overload_runs
    (run, samples) = port[0]
    _same_run(run, jrun)
    assert samples == jsamples
    c, rep, _ = run
    n = OVERLOAD_REQUESTS
    assert rep["submitted"] == n
    assert rep["completed"] + rep["shed"] + rep["rejected"] == n
    assert rep["dropped"] == 0
    outcomes = {r.rid for r in c.completed + c.shed + c.rejected}
    assert len(outcomes) == n
    assert rep["decisions"][0].find("spec_off:enter") > 0
    held = [i for i, s in enumerate(samples) if s[0]]
    assert held, "spec_off never held"
    assert not samples[-1][0], "spec_off never exited"
    # A sample is taken before the round's tick, which sets the flag the
    # round runs with: round i ran under sample i + 1's state.
    during = [(samples[i + 1][1] - samples[i][1],
               samples[i + 1][2] - samples[i][2])
              for i in range(len(samples) - 1) if samples[i + 1][0]]
    assert during and all(d[0] == 0 for d in during)
    assert sum(d[1] for d in during) > 0
    after = samples[held[-1] + 1:]
    assert after[-1][1] > after[0][1], "no speculative round after exit"


def test_overload_spec_run_repeats_byte_identically(overload_runs):
    port, _ = overload_runs
    (a, sa), (b, sb) = port
    assert a[1]["events"] == b[1]["events"]
    assert a[1]["decisions"] == b[1]["decisions"]
    assert a[2] == b[2] and sa == sb


# -- tp-sharded decode: the gloo world of 2 -----------------------------------

TP_TOKS = (2, 12)
TP_PREFILL = 5
TP_ENGINE_REQS = [dict(rid=0, prompt=(5, 9, 3), max_new_tokens=7),
                  dict(rid=1, prompt=(2, 4), max_new_tokens=5)]
TP_ENGINE_GEO = dict(slots=2, max_len=32, max_prompt_len=8)
TP_CLUSTER_TRACE = dict(seed=5, n_requests=20, rate_rps=20.0)
TP_ARMS = (("fp32", False), ("int8", False), ("fp32", True))
# A queue bound the trace crosses: the tp clusters grow a prefill
# replica (one decision-log line, and a new engine on every rank).
TP_POLICY = dict(max_queue_depth=2, max_replicas=3)


def _tp_tokens():
    return np.random.default_rng(42).integers(1, 128, TP_TOKS).astype(
        np.int64)


def _blob_leaves(blob):
    """A wire blob's leaves (either package's) as numpy arrays by
    ``layer/leaf/part``."""
    out = {}
    for i, layer in enumerate(blob["layers"]):
        for name, item in layer.items():
            for part in ("raw", "q", "s"):
                if part in item:
                    a = item[part]
                    out[f"{i}/{name}/{part}"] = np.asarray(
                        a.detach().cpu() if isinstance(a, torch.Tensor)
                        else a)
    return out


def _levers_worker(rank: int, out_dir: str, pfile: str) -> None:
    """One rank of a tp=2 world: the incremental tp forward, the tp
    engine's streams and three disaggregated tp clusters; everything to
    ``out_dir/rank<r>.*``."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", parallel=TP_SPEC)
    params = np.load(pfile, allow_pickle=True)["params"].item()
    sd = convert.gpt_params_from_jax(params)
    dense = gpt.gpt_tiny()
    dense.load_state_dict(sd)
    m_tp = gpt.gpt_tiny(tp_axis="tp")
    m_tp.load_state_dict(sd)
    arrays, res = {}, {}
    toks = torch.from_numpy(_tp_tokens())
    with torch.no_grad():
        arrays["full"] = dense(toks).numpy()
    for kind in ("fp32", "int8"):
        cache = gpt.init_kv_cache(m_tp, TP_TOKS[0], 16, kind=kind,
                                  device="cpu")
        res[f"cache_shape/{kind}"] = list(cache["layers"][0][
            "k" if kind == "fp32" else "k_q"].shape)
        lp, cache = m_tp(toks[:, :TP_PREFILL], cache=cache)
        outs = [lp]
        for t in range(TP_PREFILL, TP_TOKS[1]):
            lg, cache = m_tp(toks[:, t:t + 1], cache=cache)
            outs.append(lg)
        arrays[f"inc/{kind}"] = torch.cat(outs, dim=1).numpy()
        factory = engine.make_engine_factory(
            m_tp, device="cpu", parallel=TP_SPEC, kv_kind=kind,
            **TP_ENGINE_GEO)
        res[f"engine/{kind}"] = _decode(factory, "rtp", TP_ENGINE_REQS)[1]
    orig_export = kv.export_slot
    for kind, exact in TP_ARMS:
        arm = f"{kind}{'_exact' if exact else ''}"
        blobs, bound = [], []

        def export(cache, slot, exact=False, _forced=exact):
            src = [{n: leaf[slot].clone() for n, leaf in layer.items()}
                   for layer in cache["layers"]]
            blob = orig_export(cache, slot, exact=exact or _forced)
            if not exact:
                blobs.append(_blob_leaves(blob))
                for layer, packed in zip(src, blob["layers"]):
                    for n, x in layer.items():
                        item = packed[n]
                        if "q" not in item:
                            continue
                        back = kernels.dequantize_int8(
                            item["q"], item["s"], item["n"], x.shape,
                            x.dtype)
                        err = (back - x).abs().reshape(-1)
                        nb = item["s"].numel()
                        pad = nb * kernels.BLOCK - err.numel()
                        per = torch.nn.functional.pad(err, (0, pad)).reshape(
                            nb, -1).amax(dim=1)
                        bound.append(float((per / item["s"]).max()))
            return blob

        kv.export_slot = export
        os.environ["HVD_TPU_SERVE_TRACE_DIR"] = os.path.join(
            out_dir, f"trace_{arm}_rank{rank}")
        log = os.path.join(out_dir, f"decisions_{arm}.log")
        try:
            tracing.reset()
            factory = engine.make_engine_factory(
                m_tp, device="cpu", parallel=TP_SPEC, kv_kind=kind,
                **GEOMETRY)
            c = controller.ServeCluster(
                factory, policy=controller.SLOPolicy(**TP_POLICY),
                roles=ROLES, step_s=0.05, log_path=log)
            rep = c.run(traffic.poisson_trace(**TP_CLUSTER_TRACE))
        finally:
            kv.export_slot = orig_export
            del os.environ["HVD_TPU_SERVE_TRACE_DIR"]
        res[f"cluster/{arm}"] = {
            "tokens": {str(r.rid): list(r.tokens) for r in c.completed},
            "events": rep["events"], "decisions": rep["decisions"],
            "digest": tracing.tracer().digest(),
            "report": {k: rep[k] for k in (
                "submitted", "completed", "dropped", "handoffs",
                "prefill_tokens", "generated_tokens", "rounds")},
            "bound": max(bound) if bound else None,
            "tp_rank": factory.tp_rank}
        for i, b in enumerate(blobs):
            for key, a in b.items():
                arrays[f"blob/{arm}/{i}/{key}"] = a
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()


@pytest.fixture(scope="module")
def tp_world(J, tmp_path_factory):
    def run(out):
        pfile = out / "params.npz"
        np.savez(pfile, params=np.array(J.params, dtype=object))
        run_ranks(__file__, lambda r: ("--levers-worker", r, out, pfile), 2,
                  timeout=300)

    out = session_world(tmp_path_factory, "serve_levers_tp", run)
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.json") as f:
            res = json.load(f)
        res["arrays"] = dict(np.load(out / f"rank{r}.npz"))
        ranks.append(res)
    return out, ranks


def _jax_tp_logits(J, kind):
    """The JAX tp model's incremental logits under shard_map over 2
    devices, its cache sharded on the heads axis (test_serve.py's
    oracle)."""
    from jax.sharding import PartitionSpec as P

    jax, jnp = J.jax, J.jnp
    mesh = J.spec.resolve({"tp": 2}).mesh(jax.devices()[:2])
    toks = jnp.asarray(_tp_tokens(), jnp.int32)
    cache = J.gpt.init_kv_cache(J.tp_model, slots=TP_TOKS[0], max_len=16,
                                kind=kind)
    cspec = jax.tree.map(
        lambda leaf: P(None, None, "tp") if leaf.ndim >= 3 else P(), cache)
    apply = jax.jit(jax.shard_map(
        lambda p, t, c: J.tp_model.apply(p, t, cache=c), mesh=mesh,
        in_specs=(P(), P(), cspec), out_specs=(P(), cspec),
        check_vma=False))
    with world_slot():
        lp, cache = apply(J.params, toks[:, :TP_PREFILL], cache)
        outs = [np.asarray(lp)]
        for t in range(TP_PREFILL, TP_TOKS[1]):
            lg, cache = apply(J.params, toks[:, t:t + 1], cache)
            outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_tp_incremental_decode_matches_full_forward_and_jax(J, tp_world,
                                                            kind):
    """Each rank's incremental tp logits against the unsharded full
    forward (test_serve.py's bounds) and against the JAX shard_map
    logits; both ranks' logits are the same bits; each rank's cache
    holds 2 of the 4 heads."""
    _, ranks = tp_world
    full = ranks[0]["arrays"]["full"]
    want = _jax_tp_logits(J, kind)
    for res in ranks:
        inc = res["arrays"][f"inc/{kind}"]
        assert res[f"cache_shape/{kind}"] == [TP_TOKS[0], 16, 2, 16]
        np.testing.assert_array_equal(inc, ranks[0]["arrays"][f"inc/{kind}"])
        if kind == "fp32":
            np.testing.assert_allclose(inc, full, atol=FP32_ATOL, rtol=0)
            np.testing.assert_allclose(inc, want, atol=FP32_ATOL, rtol=0)
        else:
            for ref in (full, want):
                rel = np.max(np.abs(inc - ref)) / np.max(np.abs(ref))
                assert rel <= INT8_REL, rel
            assert (inc.argmax(-1) == full.argmax(-1)).all()


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_tp_engine_token_identical_to_unsharded_and_jax(J, tp_world, kind):
    _, ranks = tp_world
    plain = engine.make_engine_factory(_port(J.params), device="cpu",
                                       kv_kind=kind, **TP_ENGINE_GEO)
    want = [list(t) for t in _decode(plain, "rpl", TP_ENGINE_REQS)[1]]
    jf = J.engine.make_engine_factory(
        J.tp_model, J.params, parallel=J.spec.resolve({"tp": 2}),
        kv_kind=kind, **TP_ENGINE_GEO)
    with world_slot():
        jtoks = [list(t) for t in _decode(jf, "jtp", TP_ENGINE_REQS,
                                          J.queue.Request)[1]]
    for res in ranks:
        assert res[f"engine/{kind}"] == want == jtoks


@pytest.fixture(scope="module")
def jax_tp_clusters(J):
    """The JAX tp cluster of each arm: the run and each handoff's blob."""
    out = {}
    orig = J.kv.export_slot
    for kind, exact in TP_ARMS:
        blobs = []

        def export(cache, slot, use_pallas=None, exact=False,
                   _forced=exact):
            blob = orig(cache, slot, use_pallas=use_pallas,
                        exact=exact or _forced)
            blobs.append(blob)
            return blob

        J.kv.export_slot = export
        try:
            with world_slot():
                run = _cluster_run(
                    J.controller, J.tracing, J.engine.make_engine_factory(
                        J.tp_model, J.params,
                        parallel=J.spec.resolve({"tp": 2}), kv_kind=kind,
                        **GEOMETRY),
                    J.traffic.poisson_trace(**TP_CLUSTER_TRACE),
                    roles=ROLES, policy=J.controller.SLOPolicy(**TP_POLICY))
        finally:
            J.kv.export_slot = orig
        out[f"{kind}{'_exact' if exact else ''}"] = (run, blobs)
    return out


def test_tp_cluster_ranks_agree_and_rank_zero_writes_the_logs(tp_world):
    """Both ranks run the same cluster: the same streams, event and
    decision logs and trace digest, zero drops; only tp rank 0 wrote
    the decision log (once) and the trace dump."""
    out, ranks = tp_world
    for kind, exact in TP_ARMS:
        arm = f"{kind}{'_exact' if exact else ''}"
        a, b = (res[f"cluster/{arm}"] for res in ranks)
        assert (a["tp_rank"], b["tp_rank"]) == (0, 1)
        for key in ("tokens", "events", "decisions", "digest", "report"):
            assert a[key] == b[key], (arm, key)
        rep = a["report"]
        assert rep["dropped"] == 0 and rep["handoffs"] >= 1
        assert rep["completed"] == rep["submitted"] == 20
        assert len(a["decisions"]) >= 1
        with open(out / f"decisions_{arm}.log") as f:
            assert f.read().splitlines() == a["decisions"]
        assert (out / f"trace_{arm}_rank0" / "serve_trace.jsonl").exists()
        assert not (out / f"trace_{arm}_rank1").exists()


def _port_blobs(res_arrays, arm):
    by_handoff = {}
    for key, a in res_arrays.items():
        if key.startswith(f"blob/{arm}/"):
            _, _, i, rest = key.split("/", 3)
            by_handoff.setdefault(int(i), {})[rest] = a
    return [by_handoff[i] for i in sorted(by_handoff)]


def test_tp_int8_wire_is_the_jax_wire_split_by_heads(J):
    """On the same cache contents, the int8 kind's wire blob of each
    rank's head shard, concatenated over the heads axis, is the JAX
    blob of the whole slot byte for byte (codes and per-head scales ship
    raw); the model-dtype kind's shard blobs decode within half a block
    scale of their slot."""
    toks = J.jnp.asarray(_tp_tokens(), J.jnp.int32)
    for kind in ("int8", "fp32"):
        cache = J.gpt.init_kv_cache(J.model, slots=2, max_len=16,
                                    kind=kind)
        _, cache = J.model.apply(J.params, toks[:, :9], cache=cache)
        want = _blob_leaves(J.kv.export_slot(cache, 1))
        shards = []
        for r in range(2):
            part = kv.init_cache(2, 2, 16, 2, 16, kind=kind, device="cpu")
            for dst, src in zip(part["layers"], cache["layers"]):
                for name, leaf in dst.items():
                    leaf.copy_(torch.from_numpy(np.array(
                        src[name][:, :, 2 * r:2 * r + 2])))
            part["pos"].copy_(torch.from_numpy(np.array(cache["pos"])))
            part["slot_pos"].copy_(torch.from_numpy(
                np.array(cache["slot_pos"])))
            blob = kv.export_slot(part, 1)
            shards.append(_blob_leaves(blob))
            if kind == "fp32":
                for layer, packed in zip(part["layers"], blob["layers"]):
                    for name, leaf in layer.items():
                        item = packed[name]
                        back = kernels.dequantize_int8(
                            item["q"], item["s"], item["n"], item["shape"])
                        err = (back - leaf[1]).abs().max()
                        assert err <= 0.5 * item["s"].max() * (1 + 1e-6)
        if kind == "int8":
            assert set(want) == set(shards[0])
            for key, w in want.items():
                np.testing.assert_array_equal(
                    np.concatenate([s[key] for s in shards], axis=1), w,
                    err_msg=key)


def test_tp_cluster_int8_matches_jax(J, tp_world, jax_tp_clusters):
    """The int8 kind ships codes and per-head scales raw: the streams,
    event and decision logs and trace digest are the JAX tp cluster's,
    and the ranks' blobs concatenated over the heads axis are the JAX
    blobs up to the K/V values' own fp32 roundoff (the packages' head
    projections sum in different orders, two layers deep): scales to
    1e-5 relative, codes within one step."""
    _, ranks = tp_world
    (jc, jrep, jdigest), jblobs = jax_tp_clusters["int8"]
    res = ranks[0]["cluster/int8"]
    assert res["tokens"] == {str(r.rid): list(r.tokens)
                             for r in jc.completed}
    assert res["events"] == json.loads(json.dumps(jrep["events"]))
    assert res["decisions"] == jrep["decisions"]
    assert res["digest"] == jdigest
    shards = [_port_blobs(r["arrays"], "int8") for r in ranks]
    assert len(shards[0]) == len(shards[1]) == len(jblobs) >= 1
    for i, jb in enumerate(jblobs):
        want = _blob_leaves(jb)
        assert set(want) == set(shards[0][i])
        for key, w in want.items():
            got = np.concatenate([s[i][key] for s in shards], axis=1)
            assert got.shape == w.shape and got.dtype == w.dtype, key
            if got.dtype == np.int8:
                assert np.abs(got.astype(int) - w.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, w, rtol=1e-5, atol=0,
                                           err_msg=key)


def test_tp_cluster_model_dtype_wire_is_shard_local(J, tp_world,
                                                    jax_tp_clusters):
    """The model-dtype kind codes each rank's own heads: every decoded
    block lies within half its scale of the exact slot on each rank.
    With exact handoffs on both sides the streams, logs and digest are
    the JAX tp cluster's; with the coded wire the decisions are, and a
    stream that parts from the JAX stream parts at a tie within
    test_serve.py's int8 decode bound: the dense full forward over the
    prompt and the JAX stream puts the port's token within ``INT8_REL``
    of the largest logit of the top one."""
    _, ranks = tp_world
    for res in ranks:
        assert res["cluster/fp32"]["bound"] <= 0.5 * (1 + 1e-6)
    (jc, jrep, jdigest), _ = jax_tp_clusters["fp32_exact"]
    res = ranks[0]["cluster/fp32_exact"]
    assert res["tokens"] == {str(r.rid): list(r.tokens)
                             for r in jc.completed}
    assert res["events"] == json.loads(json.dumps(jrep["events"]))
    assert res["decisions"] == jrep["decisions"]
    assert res["digest"] == jdigest
    (jc, jrep, _), _ = jax_tp_clusters["fp32"]
    res = ranks[0]["cluster/fp32"]
    assert res["decisions"] == jrep["decisions"]
    want = {str(r.rid): list(r.tokens) for r in jc.completed}
    assert set(res["tokens"]) == set(want)
    prompts = {str(r.rid): list(r.prompt)[-GEOMETRY["max_prompt_len"]:]
               for r in traffic.poisson_trace(**TP_CLUSTER_TRACE).requests}
    dense = _port(J.params)
    for rid, got in res["tokens"].items():
        if got == want[rid]:
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want[rid]))
                 if a != b)
        with torch.no_grad():
            row = dense(torch.tensor([prompts[rid] + want[rid][:i]]))[0, -1]
        assert int(row.argmax()) == want[rid][i]
        gap = float(row.max() - row[got[i]])
        assert gap <= INT8_REL * float(row.abs().max()), (rid, i, gap)


def test_levers_import_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports the serve levers and finds no jax,
    flax or horovod_tpu module loaded."""
    import subprocess

    code = (
        "import sys\n"
        "from horovod_tpu_torch.serve import prefix, engine, controller\n"
        "from horovod_tpu_torch import serve\n"
        "assert serve.PrefixCache is prefix.PrefixCache\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'horovod_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


if __name__ == "__main__" and sys.argv[1:2] == ["--levers-worker"]:
    _levers_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
