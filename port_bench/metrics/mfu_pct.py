"""The whole step: model FLOPs of the profiled steps on every rank
(``work/model.py``) over the profiled span, the card's bf16 peak and the
chips."""

import statistics

from port_bench.work import model


def read(ctx):
    traces = ctx.traces()
    if not ctx.peaks or not traces:
        return None
    w = ctx.widths
    flops = sum(model.train_flops(w["layers"], w["hidden"], w["heads"],
                                  w["mlp"], w["vocab"], s["rows"], s["seq"],
                                  w["causal"], s["lengths"], s["targets"])
                for t in traces for s in t["profiled"])
    span = statistics.fmean((t["span"][1] - t["span"][0]) * 1e-6
                            for t in traces)
    # Every rank's steps over one rank's span: the ranks run side by side.
    return 100.0 * flops / (span * ctx.peaks["bf16_flops_per_s"]
                            * ctx.chips)
