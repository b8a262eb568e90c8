"""Samples completed per second over the whole window, across all ranks:
the window's steps times the global batch's rows, over the slowest rank's
window (each rank synchronizes its device before it stops the clock)."""


def read(ctx):
    windows = ctx.windows()
    if not windows:
        return None
    steps = {w["steps"] for w in windows}
    if len(steps) != 1:
        raise ValueError(f"ranks ran different step counts: {steps}")
    return steps.pop() * ctx.traffic["global_rows"] / max(
        w["elapsed_s"] for w in windows)
