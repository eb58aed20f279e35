"""Host time per step of ``train_step``'s ``backward`` span (the
gradients, a level's zero gradients and, under data parallelism, their
mean), over the traced stretch. Layer: the train step
(``train/step.py``, the ``ops/folded.py`` autograd sites)."""

from h100bench import spans

UNIT = "ms"


def read(ctx):
    return spans.mean_per_root("train_step", {"backward"})
