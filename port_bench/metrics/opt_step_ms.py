"""Optimizer (``optim.py`` ``DistributedOptimizer``, ``common/fusion.py``,
AdamW): device milliseconds a step from after ``backward()`` to after
``step()`` (the wait for the buckets' reductions, their unfusing and the
update), by CUDA events, the window's total over its steps, mean over the
ranks."""

import statistics


def read(ctx):
    windows = [w for w in ctx.windows() if w.get("timed_steps")]
    if not windows:
        return None
    return statistics.fmean(w["opt_step_ms"] / w["timed_steps"]
                            for w in windows)
