"""Device: the share of the profiled span in which no kernel, copy or set
of the profiled steps ran, mean over the ranks."""

import statistics

from port_bench import trace


def read(ctx):
    traces = ctx.traces()
    if not traces:
        return None
    return statistics.fmean(
        100.0 * (1.0 - trace.busy(t) / (t["span"][1] - t["span"][0]))
        for t in traces)
