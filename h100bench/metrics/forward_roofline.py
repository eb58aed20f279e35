"""The forward's share of its roofline: the least time the card needs for
the traced rooms (the sum over their sites of the larger of bytes over
3.35 TB/s and operations over 989 TFLOP/s, counted by the reference's
``Work`` from each room's shapes and active voxels) over the device time
the traced stretch took for them. Layer: the kernels (``ops/kernels``,
``csrc``)."""

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("busy_s") or not t.get("floor_s"):
        return None
    return t["floor_s"] / t["busy_s"] * 100.0
