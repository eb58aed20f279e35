"""Voxels the serving forward's gates kept per room: the ``kept`` counts
of its ``trunk`` span and of every ``refine`` span, over the traced
stretch. The work of the refinement levels follows it, so a change that
moves the gates tells itself from one that speeds the kernels. Layer: the
forward (``models/folded_flow.py``)."""

from h100bench import spans

UNIT = "voxels"


def kept(span: dict):
    return span["counts"].get("kept")


def read(ctx):
    return spans.mean_per_root("forward", {"trunk", "refine"}, kept)
