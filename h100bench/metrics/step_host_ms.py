"""Host time of the program's ``train_step`` span, the mean over the
traced stretch's steps: the step's call from its batch on the card to its
update enqueued. Layer: the train step (``train/step.py``)."""

from h100bench import spans

UNIT = "ms"


def read(ctx):
    return spans.mean_per_root("train_step", {"train_step"})
