"""Collectives (``optim.py`` buckets over ``ops/collectives.py``): the
wire bytes a rank hands to its gradient buckets' allreduces a step, in
10^6 B, read from the names of the port's spans
``hvd.bucket/<index>/<wire bytes>`` in the profiled trace, mean over the
ranks. The note gives the calls a step and, by bucket, the NCCL kernel
milliseconds a step launched in its span that no other kernel overlaps
(mean over the ranks)."""

import statistics

from port_bench import spans


def read(ctx):
    ixs = spans.indexes(ctx)
    per_rank, calls, exposed = [], [], {}
    for ix in ixs:
        names = ix.names(lambda n: spans.bucket_of(n) is not None)
        if not names:
            continue
        nbytes = sum(spans.bucket_of(n)[1] * len(ix.spans[n])
                     for n in names)
        per_rank.append(nbytes * 1e-6 / ix.steps)
        calls.append(sum(len(ix.spans[n]) for n in names) / ix.steps)
        for n in names:
            exposed.setdefault(spans.bucket_of(n)[0], []).append(
                ix.exposed_nccl_us([n]) * 1e-3 / ix.steps)
    if not per_rank:
        return None
    by_bucket = " ".join(f"{i}:{statistics.fmean(v):.3f}"
                         for i, v in sorted(exposed.items()))
    return statistics.fmean(per_rank), \
        f"calls a step {statistics.fmean(calls)!r}; exposed NCCL ms a " \
        f"step by bucket {by_bucket}"
