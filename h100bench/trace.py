"""Reading a torch.profiler session of a traced stretch: the device's busy
time, the longest idle gaps and the device operations that took most time.

The interval arithmetic is a copy of ``sgnn_tpu_torch/utils/profiling.py``
(``_device_work``, ``_work_spans``, ``_union_us`` and the lead-in of
``profile_window``), kept here so that a change to the program cannot
move the yardstick. Busy time and the window come from the same traced
stretch: the window runs from the start of the first of the benchmark's
host ranges to the end of the last, on the profiler's clock, and busy is
the union of the device's kernel and copy intervals clipped to it.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import DeviceType

RANGE = "h100bench::"
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, the lead-in's
PAD_LAUNCHES = 8


def _device_work(e) -> bool:
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")
            and not e.key.startswith(RANGE)
            and PAD_KERNEL not in e.key)


def work_spans(events) -> list:
    """(start, end) µs of every device kernel and copy, sorted."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if _device_work(e) and e.time_range.end > e.time_range.start)


def union(spans: list, lo: float = float("-inf"),
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


def host_ranges(events) -> list:
    """(start, end, name) µs of the benchmark's host ranges, sorted."""
    return sorted((e.time_range.start, e.time_range.end, e.key[len(RANGE):])
                  for e in events
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith(RANGE))


def lead_in(device) -> None:
    """The traced cycle's lead-in: the profiler now and then loses the
    first device events of its window, so a pause and a few spin kernels
    go first and take that loss; their rows are left out of every
    reading."""
    time.sleep(0.002)
    with torch.cuda.device(device):
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(20_000)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def traced(device, warm):
    """A profiler session whose warm-up cycle runs ``warm()`` (recorded
    and dropped) and whose active cycle is the block, after the lead-in.
    Yields a namespace that holds ``events`` and ``key_averages`` of the
    active cycle once the block has ended."""
    from torch.profiler import ProfilerActivity, profile, schedule

    got = type("Trace", (), {})()
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda

    def ready(p):
        got.events, got.key_averages = p.events(), p.key_averages()

    with profile(activities=acts, on_trace_ready=ready,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        if cuda:
            torch.cuda.synchronize(device)
        prof.step()
        if cuda:
            lead_in(device)
        yield got
        if cuda:
            torch.cuda.synchronize(device)
        prof.step()


def reduce(got, top: int = 10) -> dict:
    """busy_s, window_s, the top device operations and the longest idle
    gaps (each named by the benchmark's host range that held the host at
    the gap's start) of a traced stretch."""
    events = got.events
    ranges = host_ranges(events)
    if not ranges:
        return {}
    lo = ranges[0][0]
    hi = max(r[1] for r in ranges)
    busy = union(work_spans(events), lo, hi)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = next((n for s, e, n in ranges if s <= a < e), "host")
            gaps.append((f"idle during {name}", (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = {}
    for e in got.key_averages:
        if _device_work(e) and e.self_device_time_total > 0:
            ops[e.key] = ops.get(e.key, 0.0) + e.self_device_time_total / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": gaps[:top]}
