"""Observability: step timing, profiler traces and where the device time
goes (port of ``sgnn_tpu/utils/profiling.py``).

    with trace("traces/fwd") as prof:   # a Chrome trace in that directory
        model(...)
    print(attribution(prof, reps=1))

    timer = StepTimer()
    with timer.step(device):
        ...
    print(timer.summary())

``trace`` is a ``torch.profiler`` session (host ops, and the card's
kernels and copies when CUDA is present) in place of ``jax.profiler``;
``attribution`` and ``idle_share`` read it in place of the JAX package's
reader of TPU traces (``tools/trace_summary.py``). ``device_entry`` is the
``device`` entry of every measuring tool's JSON result: the card's name
and power limit as ``nvidia-smi`` prints them, or ``{"platform": "cpu"}``
for a run on the host, whose numbers are never a device metric.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType

NOT_MEASURED = "not measured"
WINDOW_RUNS = 3  # unprofiled runs whose median window the idle share reads
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


class StepTimer:
    """Wall-clock step statistics with warmup exclusion. ``step(device)``
    synchronizes a CUDA device before each clock reading, so a step's time
    holds its device work."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._n = 0

    @contextlib.contextmanager
    def step(self, device=None):
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        a = np.asarray(self.times)
        return {
            "steps": len(a),
            "mean_s": float(a.mean()),
            "median_s": float(np.median(a)),
            "p90_s": float(np.percentile(a, 90)),
            "steps_per_sec": float(1.0 / np.median(a)),
        }


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


def _union_us(spans: list, lo: float = float("-inf"),
              hi: float = float("inf")) -> float:
    """µs covered by sorted ``spans`` clipped to [lo, hi]."""
    busy, start, end = 0.0, None, None
    for a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if start is None or a > end:
            busy += 0.0 if start is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    return busy + (0.0 if start is None else end - start)


def idle_share(prof, window_s: float):
    """1 - (the union of the device's kernel and copy intervals in the
    profile) / (the same work's window on the host clock, ``window_s``,
    which profile_window takes from a run without the profiler: the
    profiler slows the host's launches, not the kernels); NOT_MEASURED
    when the profile holds no device interval."""
    spans = _work_spans(prof)
    if not spans or window_s <= 0:
        return NOT_MEASURED
    return 1.0 - _union_us(spans) / 1e6 / window_s


def range_device_ms(prof, prefix: str) -> dict:
    """Per profiler range named ``prefix`` + name (``record_function``):
    ms of device work inside the range's GPU-side spans, which run from
    the first to the last kernel launched inside it (a kernel launched
    outside PyTorch's ops, as the hand-written ones are, is attributed to
    no op, so a range's op totals miss it)."""
    spans, out = _work_spans(prof), {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.key.startswith(prefix):
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
    ``log_dir/trace.json`` when ``log_dir`` is given: (profile, window
    seconds), the profile's ``key_averages()`` and ``events()`` those of
    ``fn()`` alone. On a CUDA device the window is the host clock's over
    ``fn()`` before the profiler starts, which slows the host's launches
    while it runs (its time under the profiler is the profile's
    ``profiled_window_s``): after ``warm()`` (``fn`` by default), the
    median of WINDOW_RUNS runs, each clock reading after a synchronize,
    since one run's host clock moves by a few ms with the host's load; on
    the host it is the traced run's. On the card ``warm()`` also runs in
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

    window = None
    if cuda:
        (warm or fn)()
        window = float(np.median([timed() for _ in range(WINDOW_RUNS)]))
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
    return got, (window if cuda else got.profiled_window_s)


def report(prof, window_s: float, reps: int, top: int, what: str,
           tag: str = "") -> dict:
    """Prints (each line led by ``[tag]`` when given) and returns where
    the device time of ``reps`` forwards or steps went: the ``top``
    largest kernels, each category, each hand-written kernel, and the
    idle share over ``window_s``, the host-clock window that
    profile_window took without the profiler."""
    def say(line):
        print(f"[{tag}] {line}" if tag else line)

    att = attribution(prof, reps)
    idle = idle_share(prof, window_s)
    att["idle_share"] = idle
    att["window_ms"] = window_s * 1e3 / reps
    att["profiled_window_ms"] = prof.profiled_window_s * 1e3 / reps
    att["lost_launches"] = getattr(prof, "lost", {})
    sessions = getattr(prof, "sessions", 1)
    if sessions > 1 or att["lost_launches"]:
        say(f"{what}: {sessions} profiler sessions; the last lacks "
            f"{att['lost_launches'] or 'no'} hand-written kernel launches")
    if att["device_ms"] == NOT_MEASURED:
        say(f"{what}: device time {NOT_MEASURED} (the profiler recorded "
            f"no device events); host-clock window {att['window_ms']:.3f} "
            f"ms per run")
        return att
    profiled = att["profiled_window_ms"]
    say(f"{what}: {att['device_ms']:.3f} ms of device time per run "
        f"(torch.profiler, {reps} runs) in a host-clock window of "
        f"{att['window_ms']:.3f} ms unprofiled ({profiled:.3f} ms under "
        f"the profiler); idle share {idle:.4f}")
    for name, k in list(att["kernels"].items())[:top]:
        say(f"  {k['ms']:9.3f} ms {k['launches']:7.1f} x {name[:100]}")
    say("by category:")
    for c, v in att["categories"].items():
        say(f"  {c:24s} {v['ms']:9.3f} ms {v['launches']:7.1f} launches")
    return att
