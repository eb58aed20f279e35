"""The whole forward's or training step's share of the card's bf16 peak
(989 TFLOP/s, 700 W): the useful operations of the units the unprofiled
window completed (counted by the reference's ``Work``: per room, each
site's operations; per training step, each conv's forward, input gradient
and weight gradient on the checked batches, their mean), over the
window's seconds."""

UNIT = "%"


def read(ctx):
    w = ctx.get("window", {})
    if not w.get("ops") or not w.get("seconds"):
        return None
    return w["ops"] / w["seconds"] / ctx["peak_flops"] * 100.0
