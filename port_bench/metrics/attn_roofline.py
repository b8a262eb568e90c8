"""Kernels (``ops/flash_attention.py`` -> K5/K6/K7 in
``csrc/flash_attention.cu``): the least time the card could take for the
profiled steps' attention calls (``work/attention.py``, from their shapes:
one forward and one backward a layer a step) over the device time of the
kernels whose names hold one of ``KERNELS``. Kernels are matched by name
until the program marks its attention calls itself."""

from port_bench.work import attention

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def read(ctx):
    if not ctx.peaks:
        return None
    w = ctx.widths
    least, spent, bounds = 0.0, 0.0, set()
    for t in ctx.traces():
        kernel_s = sum(d[2] - d[1] for d in t["device"] if d[3] == "kernel"
                       and any(k in d[0] for k in KERNELS)) * 1e-6
        if not kernel_s:
            continue
        spent += kernel_s
        for step in t["profiled"]:
            work = attention.train_work(step["rows"], step["seq"],
                                        w["heads"], w["hidden"] // w["heads"],
                                        w["causal"], step["lengths"])
            bound = attention.least_seconds(work, ctx.peaks)
            least += bound["seconds"] * w["layers"]
            bounds.add(bound["bound"])
    if not spent:
        return None
    return 100.0 * least / spent, f"bound by {'/'.join(sorted(bounds))}"
