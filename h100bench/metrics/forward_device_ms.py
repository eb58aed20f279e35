"""Device time of the forward's kernels and copies per room (and of the
surface's extraction), from the traced stretch: the union of the device
intervals inside the benchmark's per-room host ranges over the rooms
served there. Layer: the forward (``models/folded_flow.py``)."""

UNIT = "ms"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("busy_s"):
        return None
    return t["busy_s"] / sum(t["per_room"].values()) * 1e3
