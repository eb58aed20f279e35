"""The readers of the program's spans (``h100bench/spans.py`` and the
metrics that read it): None where the program recorded no span, or has no
spans at all; the right means per room and per step on a fake record."""

import pytest

from h100bench import run as H
from h100bench import spans as S

STEMS = ("kept_voxels", "step_host_ms", "forward_host_ms",
         "backward_host_ms", "optimizer_host_ms", "batch_wait_ms")


def _span(name, host_ms, **counts):
    return {"name": name, "host_ms": host_ms, "counts": counts}


# two rooms: forward's children, then forward itself, as spans() lists them
ROOMS = [_span("encoder", 1.0), _span("trunk", 0.5, kept=10),
         _span("refine", 2.0, kept=100), _span("refine", 2.0, kept=300),
         _span("surface", 1.0), _span("forward", 7.0),
         _span("encoder", 1.0), _span("trunk", 0.5, kept=12),
         _span("refine", 2.0, kept=200), _span("refine", 2.0, kept=400),
         _span("surface", 1.0), _span("forward", 9.0)]
# two steps, each after its batch's wait and copy
STEPS = []
for i in range(2):
    STEPS += [_span("batch_wait", 3.0 + i), _span("to_device", 1.0),
              _span("prepare", 2.0), _span("forward_loss", 20.0 + 10 * i),
              _span("backward", 100.0), _span("optimizer", 30.0 + i),
              _span("train_step", 160.0 + 20 * i)]


@pytest.fixture
def record(monkeypatch):
    """Sets the spans the readers find."""
    def use(spans):
        monkeypatch.setattr(S, "recorded", lambda: spans)
    return use


@pytest.mark.parametrize("stem", STEMS)
def test_nothing_recorded_nothing_read(stem, record):
    reader = H.load_reader(stem)
    assert reader.UNIT in ("ms", "voxels")
    record([])
    assert reader.read({}) is None


def test_a_program_without_spans(monkeypatch):
    """The parent of the program's spans: its profiling module has no
    spans(), and the readers find nothing."""
    from sgnn_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert S.recorded() == []
    assert H.load_reader("step_host_ms").read({}) is None


def test_serving_kept_voxels_per_room(record):
    record(ROOMS)
    # the trunk's and the refine spans' kept voxels over 2 rooms
    assert H.load_reader("kept_voxels.serve").read({}) == \
        pytest.approx((10 + 100 + 300 + 12 + 200 + 400) / 2)
    # none of the training phases in a serving record
    for stem in STEMS[1:]:
        assert H.load_reader(stem + ".serve").read({}) is None


def test_training_means_per_step(record):
    record(STEPS)
    read = {stem: H.load_reader(stem + ".train").read({})
            for stem in STEMS[1:]}
    assert read == {"step_host_ms": pytest.approx(170.0),
                    "forward_host_ms": pytest.approx(25.0),
                    "backward_host_ms": pytest.approx(100.0),
                    "optimizer_host_ms": pytest.approx(30.5),
                    "batch_wait_ms": pytest.approx(4.5)}
    assert H.load_reader("kept_voxels.train").read({}) is None


def test_readers_read_the_program(monkeypatch):
    """recorded() is the program's spans() as it gives them."""
    from sgnn_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: STEPS)
    assert S.recorded() is STEPS
