"""Observability: the program's spans and counters, profiler traces and
where the device time goes (port of ``sgnn_tpu/utils/profiling.py``).

    with trace("traces/fwd") as prof:   # a Chrome trace in that directory
        model(...)
    print(attribution(prof, reps=1))
    print(idle_gaps(prof, top=5))       # each gap named by a span
    print(spans(clear=True))            # the forward's spans, read back

``span(name, **counts)`` marks a layer boundary of the program (the
folded forward, the training step, the batch prefetch) and ``count(name,
value)`` counts work on the innermost open span. Both record only in a
thread that a ``torch.profiler`` session records in, or inside
``recording()``; elsewhere a span is one shared no-op object, so the
serving and training paths pay a gate check a span. A recorded span
holds its name, its unit (the id of its root span, shared by all its
children), its parent, its host start and end and its counts (device
tensors, read at readout), and under the profiler it is a
``record_function`` range ``sgnn::<name>`` on the profiler's clock, whose
device time ``range_device_ms(prof, SPAN_PREFIX)`` reads from the trace.
``spans()`` reads the newest MAX_SPANS back.

``trace`` is a ``torch.profiler`` session (host ops, and the card's
kernels and copies when CUDA is present) in place of ``jax.profiler``;
``attribution``, ``idle_share`` and ``idle_gaps`` read it in place of the
JAX package's reader of TPU traces (``tools/trace_summary.py``).
``device_entry`` is the ``device`` entry of every measuring tool's JSON
result: the card's name and power limit as ``nvidia-smi`` prints them, or
``{"platform": "cpu"}`` for a run on the host, whose numbers are never a
device metric.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import subprocess
import threading
import time
import types

import torch
from torch.autograd import DeviceType, _profiler_enabled

NOT_MEASURED = "not measured"
# the traced cycle's lead-in on the card (profile_window): a host pause,
# then PAD_LAUNCHES of torch.cuda._sleep's kernel, whose rows every
# reading of a profile leaves out
PAD_KERNEL = "spin_kernel"
PAD_LAUNCHES = 8


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler session over the block (CPU activities, and CUDA's
    where a card is present); yields the profiler and writes its Chrome
    trace to ``log_dir/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ------------------------------------------------- the program's spans

SPAN_PREFIX = "sgnn::"  # the profiler range of a span
MAX_SPANS = 65_536      # spans kept, the newest


class _Thread(threading.local):
    forced = 0   # recording() blocks open in this thread
    top = None   # the innermost open span of this thread


_thread = _Thread()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)


class _Off:
    """The span of a thread that does not record: enters and leaves."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "id", "unit", "parent", "up", "t0", "t1",
                 "rf")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        up = _thread.top
        self.id = next(_ids)
        self.up, self.parent = up, None if up is None else up.id
        self.unit = self.id if up is None else up.unit
        _thread.top = self
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(
                SPAN_PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        _thread.top, self.up = self.up, None
        _spans.append(self)
        return False


def span(name: str, **counts):
    """A context manager over one layer's work, recorded where this
    thread records (module docstring), else the shared no-op; ``counts``
    are its counts (numbers or 0-d tensors)."""
    if _thread.forced or _profiler_enabled():
        return _Span(name, counts)
    return _OFF


def count(name: str, value) -> None:
    """Sets the count ``name`` of this thread's innermost open recorded
    span to ``value`` (a number or a 0-d tensor, read at readout); nothing
    where none is open."""
    top = _thread.top
    if top is not None:
        top.counts[name] = value


@contextlib.contextmanager
def recording():
    """Spans record in this thread inside the block, with or without a
    profiler."""
    _thread.forced += 1
    try:
        yield
    finally:
        _thread.forced -= 1


def _number(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def spans(clear: bool = False) -> list:
    """The recorded spans, oldest first (the newest MAX_SPANS), each a
    dict: name, id, unit, parent (None for a root), t0_ns and t1_ns
    (``perf_counter_ns``), host_ms and counts (numbers, a device
    tensor's read here); ``clear`` forgets them."""
    recs = ([_spans.popleft() for _ in range(len(_spans))] if clear
            else list(_spans))
    out = []
    for s in recs:
        out.append({"name": s.name, "id": s.id, "unit": s.unit,
                    "parent": s.parent, "t0_ns": s.t0, "t1_ns": s.t1,
                    "host_ms": (s.t1 - s.t0) / 1e6,
                    "counts": {k: _number(v) for k, v in s.counts.items()}})
    return out


def device_memory_stats() -> dict:
    """Per CUDA device: bytes in use and at peak (PyTorch's allocator) and
    the device's memory; {} without one, as JAX gives on the CPU."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def device_entry(device) -> dict:
    """The ``device`` entry of a tool's result: on a CUDA device its kind,
    the device count and the card's line of ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader``; ``{"platform": "cpu"}``
    on the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    idx = device.index or 0
    if smi.returncode or len(lines) <= idx:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(idx),
            "count": torch.cuda.device_count(), "card": lines[idx]}


def cuda_ms(fn, device, reps: int):
    """Mean ms of ``fn()`` over ``reps`` calls by CUDA events, after one
    warm-up call; NOT_MEASURED off the card."""
    if torch.device(device).type != "cuda":
        return NOT_MEASURED
    fn()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------- reading a profile

CATEGORIES = ("cuDNN convs", "GEMMs", "elementwise and reduce",
              "copies and memsets", "other")


def category(name: str) -> str:
    """A device row's category: a hand-written kernel's KERNEL_NAMES
    label, or one of CATEGORIES for PyTorch's and its libraries'."""
    from sgnn_tpu_torch.ops.kernels import kernel_label

    label = kernel_label(name)
    if label is not None:
        return label
    n = name.lower()
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copies and memsets"
    if any(k in n for k in ("cudnn", "conv", "fprop", "dgrad", "wgrad",
                            "nchwtonhwc", "nhwctonchw")):
        return "cuDNN convs"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "cublas", "xmma")):
        return "GEMMs"
    if any(k in n for k in ("elementwise", "reduce", "at::native", "index",
                            "gather", "scatter", "cub::", "fill", "sort")):
        return "elementwise and reduce"
    return "other"


def _device_work(e) -> bool:
    """A device event or row of a kernel or a copy: not a profiler range's
    GPU-side span (a ``record_function`` range, the schedule's
    ``ProfilerStep#``), which covers other device work."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")
            and PAD_KERNEL not in e.key)


def device_rows(prof) -> list:
    """(kernel or copy name, device ms, launches) of every device row of a
    profile, the largest first; [] when it recorded none."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if _device_work(e) and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def attribution(prof, reps: int = 1) -> dict:
    """Device ms and launches per forward or step (the profile holds
    ``reps`` of them): ``kernels`` per name, ``categories`` per
    category(); NOT_MEASURED for both when the profile holds no device
    row."""
    rows = device_rows(prof)
    if not rows:
        return {"device_ms": NOT_MEASURED, "kernels": NOT_MEASURED,
                "categories": NOT_MEASURED}
    kernels, cats = {}, {}
    for name, ms, n in rows:
        kernels[name] = {"ms": ms / reps, "launches": n / reps}
        c = cats.setdefault(category(name), {"ms": 0.0, "launches": 0.0})
        c["ms"] += ms / reps
        c["launches"] += n / reps
    return {"device_ms": sum(r[1] for r in rows) / reps, "kernels": kernels,
            "categories": dict(sorted(cats.items(),
                                      key=lambda kv: -kv[1]["ms"]))}


def _work_spans(prof) -> list:
    """(start, end) µs of every device kernel and copy, sorted."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if _device_work(e) and e.time_range.end > e.time_range.start)


def _busy(spans: list, lo: float = float("-inf"),
          hi: float = float("inf")) -> list:
    """The merged intervals of sorted ``spans`` clipped to [lo, hi]."""
    out = []
    for a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_us(spans: list, lo: float = float("-inf"),
              hi: float = float("inf")) -> float:
    """µs covered by sorted ``spans`` clipped to [lo, hi]."""
    return sum(b - a for a, b in _busy(spans, lo, hi))


def idle_share(prof):
    """1 - (the union of the device's kernel and copy intervals in the
    profile) / (the traced stretch's own host-clock window,
    ``prof.profiled_window_s``, which profile_window takes around the
    traced run: busy time and window of one stretch, both under the
    profiler); NOT_MEASURED when the profile holds no device interval or
    no window."""
    spans = _work_spans(prof)
    window_s = getattr(prof, "profiled_window_s", 0.0)
    if not spans or window_s <= 0:
        return NOT_MEASURED
    return 1.0 - _union_us(spans) / 1e6 / window_s


def _host_ranges(prof) -> list:
    """(start, end, name) µs of the profile's host ranges
    (``record_function``, the program's spans among them), the
    profiler's own ``ProfilerStep#`` left out."""
    return [(e.time_range.start, e.time_range.end, e.key)
            for e in prof.events()
            if e.device_type == DeviceType.CPU
            and getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def idle_gaps(prof, top: int = 10) -> list:
    """The ``top`` longest gaps between the device's kernels and copies,
    longest first, as (name, ms): each named by the innermost of the
    program's spans (``sgnn::<name>``) open on the host at the gap's
    start, else by the innermost other host range open there, else
    ``host``; [] when the profile holds no device interval."""
    busy = _busy(_work_spans(prof))
    ranges = _host_ranges(prof)
    ours = [r for r in ranges if r[2].startswith(SPAN_PREFIX)]
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        name = "host"
        for rs in (ours, ranges):
            open_ = [r for r in rs if r[0] <= a < r[1]]
            if open_:
                name = max(open_, key=lambda r: r[0])[2]
                break
        gaps.append((name, (b - a) / 1e3))
    return sorted(gaps, key=lambda g: -g[1])[:top]


def range_device_ms(prof, prefix: str) -> dict:
    """Per profiler range named ``prefix`` + name (``record_function``):
    ms of device work inside the range's GPU-side spans, which run from
    the first to the last kernel launched inside it (a kernel launched
    outside PyTorch's ops, as the hand-written ones are, is attributed to
    no op, so a range's op totals miss it)."""
    spans, out = _work_spans(prof), {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA and e.key.startswith(prefix)
                and getattr(e, "is_user_annotation", False)):
            name = e.key[len(prefix):]
            out[name] = out.get(name, 0.0) + _union_us(
                spans, e.time_range.start, e.time_range.end) / 1e3
    return out


def _pad(device) -> None:
    """The traced cycle's lead-in on the card: the profiler now and then
    loses the first device events of its window (one to six kernels, on
    the H100), so a pause and PAD_LAUNCHES spin kernels go first and take
    that loss; _device_work leaves their rows out."""
    time.sleep(0.002)
    with torch.cuda.device(device):
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(20_000)
    torch.cuda.synchronize(device)


def _lost(prof, launched: dict) -> dict:
    """Per kernel label, the launches the wrappers made in the traced
    cycle (``launched``, launches_by_label) that the profile lacks."""
    from sgnn_tpu_torch.ops.kernels import kernel_label

    seen = {}
    for name, _, n in device_rows(prof):
        label = kernel_label(name)
        if label is not None:
            seen[label] = seen.get(label, 0) + n
    return {k: n - seen.get(k, 0) for k, n in launched.items()
            if seen.get(k, 0) < n}


def profile_window(fn, device, log_dir: str | None = None, warm=None,
                   tries: int = 4):
    """``fn()`` (forwards or steps) traced by torch.profiler, into
    ``log_dir/trace.json`` when ``log_dir`` is given: the profile, its
    ``key_averages()`` and ``events()`` those of ``fn()`` alone and its
    ``profiled_window_s`` the host clock's over ``fn()`` (a synchronize
    at each end on the card), the idle share's window. The program's
    spans record in that run (its cycle is the profiler's active one)
    and in no other. On the card ``warm()`` (``fn`` by default) runs in
    the profiler's warm-up cycle, recorded and dropped, and the traced
    cycle starts with _pad. A session is complete when it recorded device
    events and every hand-written kernel launch that the wrappers counted
    in it; an incomplete one is tried again, up to ``tries`` sessions,
    and the last is returned, its ``lost`` (label -> launches missing)
    and ``sessions`` saying how it went and its ``launches`` the wrappers'
    launches (launch_counts()) in its traced ``fn()``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from sgnn_tpu_torch.ops import kernels as K

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    got = types.SimpleNamespace(lost={}, sessions=0, launches={})

    def ready(p):  # the active cycle's results, read before the next
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            p.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        ka, ev = p.key_averages(), p.events()
        got.key_averages, got.events = (lambda: ka), (lambda: ev)

    def timed():
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    for _ in range(tries if cuda else 1):
        with profile(activities=acts, on_trace_ready=ready,
                     schedule=schedule(wait=0, warmup=int(cuda), active=1,
                                       repeat=1)) as prof:
            if cuda:
                (warm or fn)()
                torch.cuda.synchronize(device)
                prof.step()
                _pad(device)
            before = K.launch_counts()
            got.profiled_window_s = timed()
            after = K.launch_counts()
            prof.step()
        got.sessions += 1
        got.launches = {k: after[k] - before[k] for k in after}
        if not cuda:
            break
        got.lost = _lost(got, K.launches_by_label(got.launches))
        if device_rows(got) and not got.lost:
            break
    return got


def report(prof, reps: int, top: int, what: str, tag: str = "") -> dict:
    """Prints (each line led by ``[tag]`` when given) and returns where
    the device time of ``reps`` forwards or steps went: the ``top``
    largest kernels, each category, each hand-written kernel, each of the
    program's spans (``span_device_ms``: the device work inside its
    ``sgnn::`` ranges, range_device_ms), the idle share of the traced
    stretch (idle_share) and its ``top`` longest idle gaps, each named by
    the span that held the host (idle_gaps)."""
    def say(line):
        print(f"[{tag}] {line}" if tag else line)

    att = attribution(prof, reps)
    idle = idle_share(prof)
    att["idle_share"] = idle
    att["idle_gaps"] = idle_gaps(prof, top)
    att["span_device_ms"] = {
        k: ms / reps for k, ms in range_device_ms(prof, SPAN_PREFIX).items()}
    att["profiled_window_ms"] = prof.profiled_window_s * 1e3 / reps
    att["lost_launches"] = getattr(prof, "lost", {})
    sessions = getattr(prof, "sessions", 1)
    if sessions > 1 or att["lost_launches"]:
        say(f"{what}: {sessions} profiler sessions; the last lacks "
            f"{att['lost_launches'] or 'no'} hand-written kernel launches")
    profiled = att["profiled_window_ms"]
    if att["device_ms"] == NOT_MEASURED:
        say(f"{what}: device time {NOT_MEASURED} (the profiler recorded "
            f"no device events); host-clock window {profiled:.3f} ms per "
            f"run under the profiler")
        return att
    say(f"{what}: {att['device_ms']:.3f} ms of device time per run "
        f"(torch.profiler, {reps} runs) in a host-clock window of "
        f"{profiled:.3f} ms under the profiler; idle share {idle:.4f}")
    for name, k in list(att["kernels"].items())[:top]:
        say(f"  {k['ms']:9.3f} ms {k['launches']:7.1f} x {name[:100]}")
    say("by category:")
    for c, v in att["categories"].items():
        say(f"  {c:24s} {v['ms']:9.3f} ms {v['launches']:7.1f} launches")
    say("by span (device work inside its sgnn:: ranges):")
    for name, ms in att["span_device_ms"].items():
        say(f"  {name:24s} {ms:9.3f} ms")
    say("longest idle gaps (the span or range that held the host):")
    for name, ms in att["idle_gaps"]:
        say(f"  {ms:9.3f} ms  {name}")
    return att
