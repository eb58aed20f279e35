"""Host time per step spent waiting for the next batch, the mean over the
unprofiled window's steps, in the benchmark's span around the
prefetching generator. Layer: data (``data/dataset.py`` ``BatchLoader``,
``train/loop.py`` ``_prefetch``, ``train/step.py`` ``to_device``)."""

UNIT = "ms"


def read(ctx):
    w = ctx.get("window", {}).get("wait_s")
    if not w:
        return None
    return sum(w) / len(w) * 1e3
