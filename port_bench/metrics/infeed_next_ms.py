"""Input layer (``data.py`` ``DeviceInfeed``): host milliseconds a step in
the port's span ``hvd.infeed.next`` (the wait for the next device batch
and its hand-over to the step's stream), from the profiled trace, mean
over the ranks."""

from port_bench import spans

NAME = "hvd.infeed.next"


def read(ctx):
    host = spans.per_step_ms(ctx, lambda ix: ix.host_us([NAME]))
    if host is None:
        return None
    device = spans.per_step_ms(ctx, lambda ix: ix.device_us([NAME]))
    return host, f"device ms a step launched in it {device!r}"
