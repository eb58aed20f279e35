"""Host time of the forward call per room, the mean over the rooms of the
unprofiled window: the call returns once every launch is enqueued, so
this is the host launch path (``models/folded_flow.py``, ``ops/folded.py``
and the ``ops/kernels`` wrappers)."""

UNIT = "ms"


def read(ctx):
    w = ctx.get("window", {}).get("enqueue_s")
    if not w:
        return None
    return sum(w) / len(w) * 1e3
