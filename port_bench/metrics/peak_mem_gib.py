"""The window's peak of ``torch.cuda.max_memory_allocated`` (reset as the
window starts), on the fullest rank, in GiB."""


def read(ctx):
    peaks = [w["peak_bytes"] for w in ctx.windows()
             if w.get("peak_bytes") is not None]
    return max(peaks) / 2 ** 30 if peaks else None
