"""Reading the program's spans (``sgnn_tpu_torch/utils/profiling.py``
``span``, ``spans``): the per-layer metrics of the layers inside the
forward and the training step, from the spans' host times and counts.
The program records its spans only while a profiler records in its
thread, so in a run they are those of the traced stretch; a program
without spans gives none, and every reader then returns None."""

from __future__ import annotations


def recorded() -> list:
    """The program's recorded spans as ``profiling.spans()`` gives them
    (dicts with name, host_ms and counts), [] where it has none."""
    from sgnn_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def host_ms(span: dict):
    return span["host_ms"]


def per_root(spans: list, root: str, names, value=host_ms):
    """The sum of ``value(span)`` over the spans named in ``names`` per
    span named ``root`` (a room's ``forward``, a ``train_step``); None
    where there is no such root or span, or a value is None."""
    roots = sum(s["name"] == root for s in spans)
    values = [value(s) for s in spans if s["name"] in names]
    if not roots or not values or None in values:
        return None
    return sum(values) / roots


def mean_per_root(root: str, names, value=host_ms):
    """per_root over the recorded spans."""
    return per_root(recorded(), root, names, value)
