"""Model step (``models/``): device milliseconds a step of the work the
host launched inside the port's spans ``hvd.model.forward`` (the forward
and the fp32 tied head) and ``hvd.model.loss``, from the profiled trace,
mean over the ranks."""

from port_bench import spans

NAMES = ("hvd.model.forward", "hvd.model.loss")


def read(ctx):
    device = spans.per_step_ms(ctx, lambda ix: ix.device_us(NAMES))
    if device is None:
        return None
    host = spans.per_step_ms(ctx, lambda ix: ix.host_us(NAMES))
    return device, f"host ms a step in the spans {host!r}"
