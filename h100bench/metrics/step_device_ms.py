"""Device time per training step, from the traced stretch: the union of
the device intervals inside the benchmark's host ranges over the steps
traced. Layer: the train step (``train/step.py``, ``models/folded_train.py``,
the ``ops/folded.py`` autograd sites)."""

UNIT = "ms"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("busy_s"):
        return None
    return t["busy_s"] / t["units"] * 1e3
