"""Host time per step of ``train_step``'s ``optimizer`` span (Adam, the
new BN running stats and the loss's mean), over the traced stretch.
Layer: the train step (``train/step.py``, ``train/state.py``)."""

from h100bench import spans

UNIT = "ms"


def read(ctx):
    return spans.mean_per_root("train_step", {"optimizer"})
