"""Optimizer (``optim.py`` ``DistributedOptimizer.step``): device
milliseconds a step of the base optimizer's update, the work launched
inside the port's span ``hvd.opt.apply``, from the profiled trace, mean
over the ranks. The note gives the same of ``hvd_step/comm``
(``synchronize()``: the wait, the average's division and the unfusing
copies)."""

from port_bench import spans


def read(ctx):
    apply = spans.per_step_ms(ctx, lambda ix: ix.device_us(["hvd.opt.apply"]))
    if apply is None:
        return None
    comm = spans.per_step_ms(ctx, lambda ix: ix.device_us(["hvd_step/comm"]))
    return apply, f"hvd_step/comm device ms a step {comm!r}"
