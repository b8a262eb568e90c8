"""The trace arithmetic on synthetic Chrome traces: union of intervals,
the idle share, exposed NCCL time, and which steps are read."""

from port_bench import trace


def test_union_and_intersect():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert trace.length([(0, 4), (5, 6)]) == 5
    assert trace.intersect([(0, 4), (5, 9)], [(3, 6), (8, 10)]) == \
        [(3, 4), (5, 6), (8, 9)]


def _step(ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": trace.STEP,
            "ts": ts, "dur": dur, "tid": tid}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def synthetic():
    ev = [_step(0, 100), _launch(10, 1), _kernel("warm", 20, 50, 1),
          # measured steps: 100..300
          _step(100, 100), _launch(110, 2), _launch(120, 3), _launch(130, 4),
          _step(200, 100), _launch(210, 5), _launch(220, 6),
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 240,
           "dur": 40, "tid": 1},
          _kernel("gemm", 150, 40, 2),               # 150-190
          _kernel("ncclDevKernel_AllReduce", 170, 40, 3),   # 170-210
          _kernel("Memcpy HtoD", 185, 10, 4, cat="gpu_memcpy"),
          _kernel("gemm", 250, 20, 5),               # 250-270
          _kernel("ncclDevKernel_AllReduce", 280, 20, 6),   # 280-300
          # a kernel launched outside the marked steps is not read
          _launch(400, 9), _kernel("late", 400, 5, 9)]
    return ev


def test_summary_idle_and_gaps():
    s = trace.summarize(synthetic())
    assert s["steps"] == 2
    assert s["span"] == (150.0, 300.0)
    assert {d[0] for d in s["device"]} == {"gemm", "ncclDevKernel_AllReduce",
                                           "Memcpy HtoD"}
    # busy: 150-210, 250-270, 280-300 -> 100 of 150
    assert trace.busy(s) == 100
    # two gaps: 210-250 (mid 230: the step range) and 270-280 (aten::item)
    assert sorted(s["gaps"], key=lambda g: g[1]) == [
        ("aten::item", 10.0), (trace.STEP, 40.0)]


def test_exposed_nccl():
    s = trace.summarize(synthetic())
    def nccl(n):
        return "nccl" in n.lower()
    # 170-210 overlaps gemm 170-190 -> 20 exposed; 280-300 all exposed
    assert trace.exposed(s, nccl) == 40


def test_top_names():
    assert trace.top([("a", 1), ("b", 3), ("a", 3)], n=1) == [("a", 4)]


def test_no_marks():
    assert trace.summarize([_launch(0, 1)])["span"] is None
