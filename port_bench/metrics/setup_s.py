"""Seconds from the start of the process that runs the cell to the start of
its window (the latest rank's): imports, the ranks' start, ``hvd.init``,
the kernels' build or load, weights, the pool, and the first steps."""


def read(ctx):
    windows = ctx.windows()
    if not windows:
        return None
    return max(w["t0_wall"] for w in windows) - ctx.t_start
