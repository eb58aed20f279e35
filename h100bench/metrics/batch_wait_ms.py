"""Host time per step of the prefetch's ``batch_wait`` span (the wait for
the loader's next host batch) and ``to_device`` span (its copy's
enqueue), over the traced stretch. Layer: data (``train/loop.py``
``_prefetch``, ``data/dataset.py`` ``BatchLoader``)."""

from h100bench import spans

UNIT = "ms"


def read(ctx):
    return spans.mean_per_root("train_step", {"batch_wait", "to_device"})
