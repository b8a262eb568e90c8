"""The readers of the port's spans on synthetic Chrome traces: launches
are tied to a span by thread and time and to the device by correlation,
the first marked step is left out, bucket names give bytes and calls,
nested spans count in each reader, and a trace without spans gives
nothing."""

import gzip
import json
import types

from port_bench import registry, spans, trace


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=1):
    return _x("user_annotation", name, ts, dur, tid)


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, 7, corr)


def synthetic():
    """Three marked steps (0-100 left out; 100-200, 200-300 kept). Main
    thread 1: forward 110-150 with the attention forward 120-130 inside,
    the loss 150-160, the update 280-290. Autograd thread 2: the attention
    backward 165-175 and bucket 0 (100 MB) 176-180 in step 2, bucket 0
    again 260-265 in step 3. Thread 3 launches at 125 inside no span of
    its own."""
    return [
        _span(trace.STEP, 0, 100), _span(trace.STEP, 100, 100),
        _span(trace.STEP, 200, 100),
        # left out: a span and its launch in the first step
        _span("hvd.model.forward", 10, 20), _launch(12, 1),
        _kernel("gemm", 40, 30, 1),
        _span("hvd.infeed.next", 102, 6),
        _span("hvd.model.forward", 110, 40),
        _launch(115, 2), _kernel("gemm", 150, 20, 2),          # 150-170
        _span("hvd.attn.fwd", 120, 10),
        _launch(122, 3), _kernel("flash_fwd_sm90", 170, 10, 3),  # 170-180
        _launch(125, 4, tid=3), _kernel("other_thread", 300, 50, 4),
        _span("hvd.model.loss", 150, 10),
        _launch(155, 5), _kernel("Memcpy DtoD", 180, 5, 5,
                                 cat="gpu_memcpy"),              # 180-185
        _span("hvd.attn.bwd", 165, 10, tid=2),
        _launch(166, 6, tid=2), _kernel("renamed_dkv", 185, 15, 6),
        _span("hvd.bucket/0/100000000", 176, 4, tid=2),
        _launch(178, 7, tid=2),
        _kernel("ncclDevKernel_AllReduce", 195, 20, 7),  # 195-215
        _span("hvd.bucket/0/100000000", 260, 5, tid=2),
        _launch(261, 8, tid=2),
        _kernel("ncclDevKernel_AllReduce", 262, 10, 8),  # 262-272
        _span("hvd_step/comm", 270, 8),
        _span("hvd.opt.apply", 280, 10),
        _launch(281, 9), _kernel("multi_tensor_apply", 282, 6, 9),
    ]


def test_launches_by_thread_and_correlation():
    ix = spans.Index(synthetic())
    assert ix.steps == 2
    # thread 1's forward holds its own launches 2 and 3, not thread 3's 4
    assert ix.device_us(["hvd.model.forward"]) == 30
    # the backward's launch is on autograd's thread 2
    assert ix.device_us(["hvd.attn.bwd"]) == 15
    assert ix.host_us(["hvd.attn.bwd"]) == 10
    assert ix.device_us(["hvd.model.loss"]) == 5
    assert ix.device_us(["hvd.opt.apply"]) == 6
    assert ix.device_us(["hvd_step/comm"]) == 0
    assert ix.device_us(["hvd.nothing"]) is None


def test_first_marked_step_left_out():
    ix = spans.Index(synthetic())
    assert [s[1] for s in ix.spans["hvd.model.forward"]] == [110.0]
    assert spans.Index(synthetic(), skip_first=0).device_us(
        ["hvd.model.forward"]) == 60


def test_bucket_names_and_exposed_nccl():
    ix = spans.Index(synthetic())
    assert spans.bucket_of("hvd.bucket/12/67108864") == (12, 67108864)
    assert spans.bucket_of("hvd.model.forward") is None
    assert len(ix.spans["hvd.bucket/0/100000000"]) == 2
    # 195-215 overlaps renamed_dkv 185-200 -> 15; 262-272 all exposed
    assert ix.exposed_nccl_us(["hvd.bucket/0/100000000"]) == 25


def _ctx(tmp_path, ranks):
    traces = []
    for r, events in enumerate(ranks):
        path = tmp_path / f"rank{r}.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": events}, f)
        traces.append({"path": str(path), "span": (0, 1), "steps": 2})
    return types.SimpleNamespace(traces=lambda: traces)


def _read(name, ctx):
    got = registry.metric_reader(name)(ctx)
    return got[0] if isinstance(got, tuple) else got


def test_readers_nested_spans_and_bytes(tmp_path):
    ctx = _ctx(tmp_path, [synthetic(), synthetic()])
    # the attention forward's kernel counts in fwd_ms and in attn_ms
    assert _read("fwd_ms", ctx) == (30 + 5) * 1e-3 / 2
    assert _read("attn_ms", ctx) == (10 + 15) * 1e-3 / 2
    assert _read("opt_apply_ms", ctx) == 6 * 1e-3 / 2
    assert _read("infeed_next_ms", ctx) == 6 * 1e-3 / 2
    value, note = registry.metric_reader("allreduce_mb_per_step")(ctx)
    assert value == 2 * 100.0 / 2
    assert "calls a step 1.0" in note and "0:0.013" in note


def test_a_program_without_spans_gives_nothing(tmp_path):
    bare = [e for e in synthetic()
            if not str(e["name"]).startswith("hvd")]
    ctx = _ctx(tmp_path, [bare])
    for name in ("infeed_next_ms", "fwd_ms", "opt_apply_ms", "attn_ms",
                 "allreduce_mb_per_step"):
        assert _read(name, ctx) is None, name
