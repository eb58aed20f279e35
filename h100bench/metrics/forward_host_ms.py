"""Host time per step of ``train_step``'s ``forward_loss`` span (the
forward and the loss), over the traced stretch. Layer: the train step
(``train/step.py``, ``models/folded_train.py``)."""

from h100bench import spans

UNIT = "ms"


def read(ctx):
    return spans.mean_per_root("train_step", {"forward_loss"})
