"""Input layer (``data.py`` ``DeviceInfeed``): host milliseconds a step
blocked in ``next(infeed)``, the window's total over its steps, mean over
the ranks."""

import statistics


def read(ctx):
    windows = [w for w in ctx.windows() if w["steps"]]
    if not windows:
        return None
    return statistics.fmean(1e3 * w["infeed_wait_s"] / w["steps"]
                            for w in windows)
