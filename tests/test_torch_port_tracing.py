"""Spans of the port's training path and the counters beside them.

One ``DistributedOptimizer(AdamW)`` step of ``gpt_tiny`` on one CPU rank,
fed by ``DeviceInfeed``:

* under ``torch.profiler`` every span of the path is recorded:
  ``hvd.infeed.next``, ``hvd.model.forward``, ``hvd.model.loss``,
  ``hvd.attn.fwd``, ``hvd.attn.bwd``, ``hvd_step/comm`` (once, with
  metrics on or off) and ``hvd.opt.apply``, and one
  ``hvd.bucket/<index>/<wire bytes>`` a bucket of the plan, whose bytes
  add up to the plan's wire bytes;
* with no profiler running the step opens no ``record_function``;
* with a timeline running, each bucket writes ``ALLREDUCE`` begin then
  end on ``bucket.<index>``, on the profiler's clock: its ``ts`` less
  the trace's ``baseTimeNanoseconds`` lies in the profiled window;
* ``hvd_tpu_allreduce_bytes_total{axis="flat"}`` grows by the plan's
  wire bytes each step.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import metrics as metrics_lib
from horovod_tpu_torch.models import gpt

THRESHOLD = 16 * 1024       # bytes: several buckets for gpt_tiny
SPANS = ("hvd.infeed.next", "hvd.model.forward", "hvd.model.loss",
         "hvd.attn.fwd", "hvd.attn.bwd", "hvd_step/comm", "hvd.opt.apply")
#: optimizer keywords -> (wire label, wire bytes of a bucket of n fp32s)
WIRES = {
    "none": ({}, "none", lambda n: 4 * n),
    "bf16": ({"compression": "bf16"}, "bf16", lambda n: 2 * n),
    "int8_ef": ({"compression": "int8_ef", "quantize_min_bucket_bytes": 0},
                "int8", lambda n: n + 4 * ((n + 4095) // 4096)),
    "overlap": ({"overlap": True}, "none", lambda n: 4 * n),
}


@pytest.fixture()
def world1():
    ctx = hvd.init(device="cpu")
    try:
        yield ctx
    finally:
        hvd.shutdown()


class _Run:
    """gpt_tiny under DistributedOptimizer(AdamW), fed by DeviceInfeed."""

    def __init__(self, steps: int = 2, **opt_kw):
        torch.manual_seed(0)
        self.model = gpt.gpt_tiny()
        self.opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(self.model.parameters(), lr=1e-3),
            named_parameters=self.model.named_parameters(),
            fusion_threshold_bytes=THRESHOLD, **opt_kw)
        batches = [torch.randint(0, 128, (2, 17)) for _ in range(steps)]
        self.feed = hvd.DeviceInfeed(iter(batches), depth=2, device="cpu")

    def step(self):
        t = next(self.feed)
        loss = gpt.next_token_loss(self.model(t[:, :-1]), t[:, 1:])
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return loss

    def close(self):
        self.feed.close()
        for h in self.opt._dist_hooks:
            h.remove()

    def bucket_elems(self):
        return [b.total_elems for b in self.opt._dist_plan.buckets]


def _profiled_names(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.step()
    return [e.name for e in prof.events()]


def _flat_bytes(wire):
    samples = hvd.metrics()["hvd_tpu_allreduce_bytes_total"]["samples"]
    return sum(s["value"] for s in samples
               if s["labels"].get("axis") == "flat"
               and s["labels"].get("wire") == wire)


def _metrics_off(monkeypatch):
    """What ``HVD_TPU_METRICS=0`` gives: a disabled registry, and the
    step-phase histogram the no-op it is made as under one."""
    from horovod_tpu_torch import optim

    monkeypatch.setattr(metrics_lib, "_registry",
                        metrics_lib.MetricsRegistry(enabled=False))
    monkeypatch.setattr(optim, "_M_PHASE", metrics_lib.NOOP)


@pytest.mark.parametrize("wire", ["none", "bf16", "int8_ef"])
def test_a_profiled_step_records_every_span(world1, wire):
    kw, _, nbytes = WIRES[wire]
    run = _Run(**kw)
    try:
        names = _profiled_names(run)
        elems = run.bucket_elems()
    finally:
        run.close()
    assert len(elems) > 2
    for name in SPANS:
        assert name in names, name
    assert names.count("hvd_step/comm") == 1
    # one forward and one backward a layer, one span of each layer a step
    assert names.count("hvd.attn.fwd") == names.count("hvd.attn.bwd") == 2
    buckets = sorted(n for n in names if n.startswith("hvd.bucket/"))
    want = sorted(f"hvd.bucket/{i}/{nbytes(n)}" for i, n in enumerate(elems))
    assert buckets == want
    assert sum(int(n.rsplit("/", 1)[1]) for n in buckets) == \
        sum(nbytes(n) for n in elems)


def test_comm_span_with_metrics_off(world1, monkeypatch):
    """``hvd_step/comm`` is a span, not the phase histogram's range: a
    disabled registry still records it, once."""
    _metrics_off(monkeypatch)
    run = _Run()
    try:
        names = _profiled_names(run)
    finally:
        run.close()
    assert names.count("hvd_step/comm") == 1
    assert "hvd.opt.apply" in names and "hvd.infeed.next" in names


def _phase_count(phase):
    samples = hvd.metrics()["hvd_tpu_step_phase_seconds"]["samples"]
    return sum(s["value"]["count"] for s in samples
               if s["labels"].get("phase") == phase)


@pytest.mark.parametrize("enabled", [True, False])
def test_step_timer_phase_is_one_span(monkeypatch, enabled):
    """A caller's ``StepTimer().phase`` opens the span the optimizer's
    ``comm`` phase opens: one ``hvd_step/<phase>`` range under a
    profiler, with metrics on or off, and one observation of the phase's
    histogram."""
    from horovod_tpu_torch import optim

    if not enabled:
        _metrics_off(monkeypatch)
    before = _phase_count("grad") if enabled else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with optim.StepTimer().phase("grad"):
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("hvd_step/grad") == 1
    if enabled:
        assert _phase_count("grad") == before + 1


def test_b_no_profiler_no_record_function(world1, monkeypatch):
    calls = []

    def refuse(name, *a, **kw):
        calls.append(name)
        raise RuntimeError(f"record_function({name!r}) with no profiler")

    run = _Run()
    try:
        assert not metrics_lib.tracing()
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        run.step()
    finally:
        monkeypatch.undo()
        run.close()
    assert calls == []


@pytest.mark.parametrize("overlap", [False, True])
def test_c_timeline_buckets_on_the_profiler_clock(world1, tmp_path,
                                                  overlap):
    run = _Run(overlap=overlap)
    path = tmp_path / "timeline.json"
    try:
        run.step()
        hvd.start_timeline(str(path))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run.step()
        hvd.stop_timeline()
        n = len(run.bucket_elems())
    finally:
        run.close()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    events = json.loads(path.read_text())["traceEvents"]
    for i in range(n):
        mine = [e for e in events if e.get("tid") == f"bucket.{i}"]
        assert [e["ph"] for e in mine] == ["B", "E"], (i, mine)
        assert mine[0]["name"] == "ALLREDUCE"
        begin, end = (float(e["ts"]) - base_us for e in mine)
        assert lo <= begin <= end <= hi, (i, lo, begin, end, hi)


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_d_flat_byte_counter_grows_by_the_plan(world1, wire):
    kw, label, nbytes = WIRES[wire]
    run = _Run(steps=3, **kw)
    try:
        plan = sum(nbytes(n) for n in run.bucket_elems())
        seen = [_flat_bytes(label)]
        for _ in range(3):
            run.step()
            seen.append(_flat_bytes(label))
    finally:
        run.close()
    assert [b - a for a, b in zip(seen, seen[1:])] == [plan] * 3


def test_tracing_follows_the_profiler_and_the_switch(monkeypatch):
    monkeypatch.setattr(metrics_lib, "_registry",
                        metrics_lib.MetricsRegistry(enabled=True,
                                                    trace_bridge=False))
    assert not metrics_lib.tracing()
    assert metrics_lib.span("x") is metrics_lib.NOOP.time()
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics_lib.tracing()
    assert not metrics_lib.tracing()
    metrics_lib.enable_trace_bridge(True)
    assert metrics_lib.tracing()
