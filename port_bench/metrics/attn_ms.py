"""Kernels (``ops/flash_attention.py``, K5/K6/K7): device milliseconds a
step of the work launched inside the port's spans ``hvd.attn.fwd`` and
``hvd.attn.bwd`` (the backward's ``zeros_like`` or ``contiguous`` of the
output's gradient included), whatever the kernels are named, from the
profiled trace, mean over the ranks."""

from port_bench import spans

NAMES = ("hvd.attn.fwd", "hvd.attn.bwd")


def read(ctx):
    device = spans.per_step_ms(ctx, lambda ix: ix.device_us(NAMES))
    if device is None:
        return None
    ixs = spans.indexes(ctx)
    calls = [sum(len(ix.spans.get(n, ())) for n in NAMES) / ix.steps
             for ix in ixs]
    return device, f"spans a step (fwd + bwd) by rank {calls}"
