"""The program's spans and counters (sgnn_tpu_torch/utils/profiling.py
``span``, ``count``, ``recording``, ``spans``, ``idle_gaps``) on the CPU,
with the tiny configurations of the folded serving and training tests.

- Off (no profiler, no ``recording()``): nothing is recorded, and the
  forward and the train step give the same outputs bit for bit as with
  their spans recorded.
- On under ``torch.profiler`` (CPU activities): the forward's ``encoder``,
  ``trunk``, ``refine`` (one a level) and ``surface``, and the train
  step's phases, share their root's unit and nest in its host time; the
  profile holds a ``sgnn::<name>`` range for each span.
- A profiler's warm-up cycle and a thread the profiler does not record in
  record nothing; ``recording()`` records without a profiler.
- The gates' ``kept`` counts are the forward's ``level_active``; the
  prefetch records ``batch_wait`` and ``to_device``; the record is
  bounded; a forward hook on ``refinement[h]`` still sees the level's
  outputs.
- ``idle_gaps`` names each device gap of a synthetic profile by the
  innermost span open on the host at its start.
"""

import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.data import formats as F
from sgnn_tpu_torch.data.capacity import estimate_row_capacities
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.models.folded_train import GenModelFoldedTrain
from sgnn_tpu_torch.params import init_params, load_jax_params
from sgnn_tpu_torch.train import step as TS
from sgnn_tpu_torch.train.loop import Trainer
from sgnn_tpu_torch.utils import profiling as P
from test_torch_model import CFG as SERVE_CFG
from test_torch_model import _surface_rows
from test_torch_train_step import CFG as TRAIN_CFG
from test_torch_train_step import TRUNC, _chunk

STEP_CFG = dict(TRAIN_CFG, batch_size=1)
FORWARD = ["encoder", "trunk", "refine", "refine", "surface", "forward"]
STEP = ["prepare", "forward_loss", "backward", "optimizer", "metrics",
        "train_step"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's forwards and steps on one intra-op thread: their many
    small ops otherwise wait on a pool of threads that a loaded host
    (the suite's parallel workers) schedules late, tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_spans():
    """Each test starts and ends with no recorded span."""
    P.spans(clear=True)
    yield
    P.spans(clear=True)


@pytest.fixture(scope="module")
def served():
    """A tiny serving forward whose gates keep voxels at every level
    (init_params seed 4), and its input."""
    cfg = SGNNConfig(**SERVE_CFG)
    model = GenModelFolded(cfg)
    load_jax_params(model, *init_params(cfg, seed=4))
    locs, feats, n = _surface_rows(cfg.input_dim, cfg.truncation,
                                   cfg.input_cap)
    inputs = (torch.from_numpy(locs[:n]), torch.from_numpy(feats[:n]),
              SERVE_CFG["input_dim"])
    return model, inputs


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """A collated batch of one sphere chunk with sparse targets."""
    f = str(tmp_path_factory.mktemp("tracing_chunks") / "c0.sdfs")
    F.save_train_file(f, _chunk(np.random.RandomState(5)))
    ds = D.SceneDataset([f], TRUNC, 3, sparse_targets=True)
    caps = estimate_row_capacities([f], 3, TRUNC, 1)
    cfg = SGNNConfig(**STEP_CFG)
    return D.collate_sparse([ds[0]], cfg.input_cap, *caps)


class _Descent:
    """Plain gradient descent in train_step's optimizer's place: a
    ``torch.optim`` optimizer's first step imports torch.distributed and
    dynamo (~2.5 s, far more on a loaded host), which no check here
    needs."""

    def __init__(self, params):
        self.params = list(params)
        self.param_groups = [{"lr": 0.0}]

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p -= self.param_groups[0]["lr"] * p.grad


def _step(batch, with_metrics=False):
    """One train step from init_params seed 1: (metrics, the updated
    weights)."""
    cfg = SGNNConfig(**STEP_CFG)
    model = GenModelFoldedTrain(cfg)
    load_jax_params(model, *init_params(cfg, seed=1))
    m = TS.train_step(model, _Descent(model.weights),
                      TS.to_device(batch, "cpu"), np.ones(4, np.float32),
                      1e-3, num_refine_active=2, do_surf=True,
                      with_metrics=with_metrics)
    return m, [w.detach().clone() for w in model.weights]


def _nested(spans: list, root: str) -> None:
    """Every span shares the unit of the one ``root``, whose children the
    others are, inside its host time."""
    top = [s for s in spans if s["name"] == root]
    assert len(top) == 1 and top[0]["parent"] is None
    top = top[0]
    assert top["unit"] == top["id"]
    for s in spans:
        assert s["unit"] == top["unit"], s
        if s is not top:
            assert s["parent"] == top["id"], s
            assert top["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= top["t1_ns"]
        assert s["host_ms"] == pytest.approx((s["t1_ns"] - s["t0_ns"])
                                             / 1e6)


def _ranges(prof) -> list:
    """The names of the profile's ``sgnn::`` ranges, from its raw events
    (a step's ~60k take ~25x less time to list than ``events()``)."""
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return [n[len(P.SPAN_PREFIX):] for n in names
            if n.startswith(P.SPAN_PREFIX)]


def test_off_records_nothing_same_forward(served):
    model, inputs = served
    off = model(*inputs)
    assert P.spans() == []
    with P.recording():
        on = model(*inputs)
    assert [s["name"] for s in P.spans()] == FORWARD
    for a, b in ((off.coarse_out, on.coarse_out),
                 (off.surf_sdf, on.surf_sdf), (off.surf_mask, on.surf_mask)):
        assert torch.equal(a, b)
    assert [int(a) for a in off.level_active] == \
        [int(a) for a in on.level_active]


@pytest.fixture(scope="module")
def steps(batch):
    """One step off and one, with metrics, under the profiler, from the
    same weights and batch: (off, off's spans, on, on's spans, on's
    profile)."""
    P.spans(clear=True)
    off = _step(batch)
    off_spans = P.spans(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _step(batch, with_metrics=True)
    return off, off_spans, on, P.spans(clear=True), prof


def test_off_records_nothing_same_step(steps):
    (m_off, w_off), off_spans, (m_on, w_on), _, _ = steps
    assert off_spans == []
    assert torch.equal(m_off["loss"], m_on["loss"])
    for a, b in zip(w_off, w_on):
        assert torch.equal(a, b)


def test_forward_spans_under_profiler(served):
    model, inputs = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = model(*inputs)
    got = P.spans()
    assert [s["name"] for s in got] == FORWARD
    _nested(got, "forward")
    # the gates' counts: the trunk's and each level's kept voxels
    kept = [s["counts"]["kept"] for s in got if "kept" in s["counts"]]
    assert kept == [int(a) for a in out.level_active]
    assert all(k > 0 for k in kept)
    assert sorted(_ranges(prof)) == sorted(FORWARD)


def test_step_spans_under_profiler(steps):
    *_, got, prof = steps
    assert [s["name"] for s in got] == STEP
    _nested(got, "train_step")
    assert sorted(_ranges(prof)) == sorted(STEP)


def test_warmup_cycle_and_other_threads_record_nothing():
    seen = {}

    def mark(name):
        with P.span(name):
            P.count("n", 1)

    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        mark("warmup")
        prof.step()
        t = threading.Thread(target=mark, args=("thread",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        mark("active")
        prof.step()
    seen["profiled"] = [s["name"] for s in P.spans(clear=True)]
    # recording() alone, in its own thread only, nested blocks counted
    with P.recording():
        with P.recording():
            mark("inner")
        t = threading.Thread(target=mark, args=("thread",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        mark("outer")
    mark("after")
    P.count("n", 2)  # no span open: nothing
    seen["recording"] = P.spans()
    assert seen["profiled"] == ["active"]
    assert [s["name"] for s in seen["recording"]] == ["inner", "outer"]
    assert all(s["counts"] == {"n": 1} for s in seen["recording"])


def test_prefetch_records_wait_and_copy():
    host = [{"x": np.full((4,), i, np.float32), "n": np.int32(i)}
            for i in range(3)]
    owner = types.SimpleNamespace(groups=None, device="cpu",
                                  transfer_dtype=torch.float32)
    with P.recording():
        got = list(Trainer._prefetch(owner, host))
    assert [b for b, _ in got] == host
    assert [float(d["x"][0]) for _, d in got] == [0.0, 1.0, 2.0]
    names = [s["name"] for s in P.spans()]
    # one wait a batch and one for the end, one copy a batch
    assert names == ["batch_wait", "to_device"] * 3 + ["batch_wait"]
    assert all(s["parent"] is None for s in P.spans())


def test_record_is_bounded():
    with P.recording():
        for i in range(P.MAX_SPANS + 5):
            with P.span("s", i=i):
                pass
    got = P.spans()
    assert len(got) == P.MAX_SPANS
    assert got[0]["counts"]["i"] == 5
    assert got[-1]["counts"]["i"] == P.MAX_SPANS + 4


def test_refinement_hook_still_fires(served):
    model, inputs = served
    seen = {}
    hooks = [ref.register_forward_hook(
        lambda _m, _i, out, h=h: seen.__setitem__(h, out[2]))
        for h, ref in enumerate(model.refinement)]
    try:
        with P.recording():
            out = model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    assert sorted(seen) == [0, 1]
    for h, fm in seen.items():
        kept = (fm.data[:, 1:-1, ..., ::16] > 0).sum()
        assert int(kept) == int(out.level_active[h + 1])


def test_idle_gaps_named_by_spans():
    """Device work at 0-2, 5-6, 9-10 and 20-21 us; the host holds the
    step (an outer range), inside it the program's spans."""
    from torch.autograd import DeviceType

    def ev(key, t0, t1, dev=DeviceType.CUDA, annot=False):
        return types.SimpleNamespace(
            key=key, device_type=dev, is_user_annotation=annot,
            time_range=types.SimpleNamespace(start=t0, end=t1))

    def host(key, t0, t1):
        return ev(key, t0, t1, DeviceType.CPU, annot=True)
    k = "void sgnn::conv_site_kernel<float, 16>(...)"
    events = [ev(k, 0, 2), ev(k, 5, 6), ev(k, 9, 10), ev(k, 20, 21),
              ev("sgnn::backward", 0, 21, annot=True),  # GPU-side: no work
              host("ProfilerStep#1", 0, 30),
              host("h100bench::step", 0, 10),
              host("sgnn::train_step", 1, 10),
              host("sgnn::backward", 4, 8),
              ev("aten::mm", 0, 30, DeviceType.CPU)]
    prof = types.SimpleNamespace(events=lambda: events)
    # the span's device work: the kernels inside its GPU-side range
    assert P.range_device_ms(prof, P.SPAN_PREFIX) == {
        "backward": pytest.approx(5e-3)}
    gaps = P.idle_gaps(prof, top=10)
    assert gaps == [("host", pytest.approx(10e-3)),
                    ("sgnn::train_step", pytest.approx(3e-3)),
                    ("sgnn::backward", pytest.approx(3e-3))]
    assert P.idle_gaps(prof, top=1) == gaps[:1]
    # no span open: the other range open there
    events[7] = host("sgnn::train_step", 3, 10)
    assert P.idle_gaps(prof)[1] == ("h100bench::step", pytest.approx(3e-3))
