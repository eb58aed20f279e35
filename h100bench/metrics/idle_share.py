"""The device's idle share over the traced stretch of rooms or training
steps: 1 - (the union of its kernel and copy intervals) / (the stretch's
host window), both from the same trace. Layer: the device."""

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("window_s"):
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
