"""Model step (``models/``): device milliseconds a step from before the
forward to after ``backward()``, by CUDA events on the step's stream, the
window's total over its steps, mean over the ranks."""

import statistics


def read(ctx):
    windows = [w for w in ctx.windows() if w.get("timed_steps")]
    if not windows:
        return None
    return statistics.fmean(w["fwd_bwd_ms"] / w["timed_steps"]
                             for w in windows)
