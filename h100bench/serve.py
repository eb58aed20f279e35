"""The serving driver: a closed stream of rooms through the port's folded
forward in its only-surface form, as ``SceneInferencer`` serves it.

Set-up makes the configuration's weights and the traffic's pool of rooms
on the card from ``--seed``, loads the weights through the port's
``load_jax_params`` and serves every room once (the shapes' warm-up; the
first run in a checkout also builds the kernels). In a closed loop
(the traffic's ``in_flight``) the window keeps that many rooms in flight:
it enqueues the next room's forward and then completes the oldest room;
in an open loop (``arrivals_per_s``) a room arrives at fixed intervals
and is launched as it arrives, with at most ``in_flight`` on the card. A room is completed as
``SceneInferencer.collect`` takes it: its surface (voxel locations and
sdf) goes to the host on a stream of its own that waits only for that
room's forward, extracted with ``nonzero`` and copied (these lines do
what ``collect`` and ``_extract`` do; the rooms are their padded dims, so
nothing is cropped). A room's latency runs from its arrival (the closed
loop: its launch) to its surface on the host.

Correctness (``check``): for each room of the pool, one completion of
the window, drawn from the seed, is kept with the level masks its forward
made (read by forward hooks on ``GenModelFolded.refinement``, which hold
references and copy nothing). After the window the plain reference runs
each kept room in f32 following the program's gate decisions, and the
widest gaps by which a decision or a surface value departs from the
reference are compared with the cell's limits.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from h100bench import trace as T
from h100bench.reference import sgnn as R
from h100bench.rooms import rng_for, room_pool, stream_order
from h100bench.weights import make_weights, to_numpy

_nothing = contextlib.nullcontext

PEAK_BYTES = 3.35e12  # H100 SXM data sheet, 700 W: HBM3
PEAK_BF16 = 989e12    # dense bf16 tensor-core FLOP/s
TRACE_PASSES = 2      # passes over the pool in the traced stretch
NEVER = 1e30          # the numbers of a room that never completed
UNITS = {"rooms_per_s": "rooms/s", "room_ms_p95": "ms", "setup_s": "s"}


def model_config(config: dict, traffic: dict):
    from sgnn_tpu_torch.config import SGNNConfig

    Y = max(f[0] for f in traffic["footprints"])
    X = max(f[1] for f in traffic["footprints"])
    m = config["model"]
    return SGNNConfig(
        encoder_dim=m["encoder_dim"], nf_coarse=m["nf_coarse"], nf=m["nf"],
        num_hierarchy_levels=m["num_hierarchy_levels"],
        truncation=m["truncation"], input_dim=(traffic["z"], Y, X),
        batch_size=1, compute_dtype=config["compute_dtype"],
        execution="folded", quantize_int8=config.get("quantize_int8", False))


def net_of(config: dict) -> R.Net:
    m = config["model"]
    return R.Net(encoder_dim=m["encoder_dim"], nf_coarse=m["nf_coarse"],
                 nf=m["nf"], num_hierarchy_levels=m["num_hierarchy_levels"],
                 truncation=m["truncation"])


class Stream:
    """The served path: enqueue and complete rooms, keeping one completion
    of each pool room (reservoir sampling from the seed) for the check."""

    def __init__(self, model, pool: list, seed: int, in_flight: int,
                 device):
        self.model, self.pool, self.device = model, pool, device
        self.in_flight = in_flight
        self.order = stream_order(len(pool), seed)
        self.rng = rng_for(seed, 4)
        self.cuda = torch.device(device).type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.sampling = True
        self.pending = collections.deque()
        self.seen = [0] * len(pool)
        self.kept = [None] * len(pool)
        self._slot = None
        self.hooks = [ref.register_forward_hook(self._capture(h))
                      for h, ref in enumerate(model.refinement)]

    def _capture(self, h):
        def hook(_module, _inputs, out):
            if self._slot is not None:
                self._slot["fm"][h] = out[2]
        return hook

    def enqueue(self, due: float | None = None) -> None:
        """Launch the next room's forward; its latency counts from ``due``
        (its arrival in an open loop), else from the launch."""
        room = self.pool[next(self.order)]
        slot = {"room": room, "fm": {}}
        self._slot = slot
        with torch.profiler.record_function(T.RANGE + "enqueue"):
            t0 = time.perf_counter()
            out = self.model(room["locs"], room["feats"], room["dims"],
                             batch_size=1)
            slot["enqueue_s"] = time.perf_counter() - t0
        self._slot = None
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        slot.update(t0=t0 if due is None else due, out=out, done=done)
        self.pending.append(slot)

    def complete(self) -> dict:
        slot = self.pending.popleft()
        with torch.profiler.record_function(T.RANGE + "complete"):
            if self.cuda:
                self.side.wait_event(slot["done"])
            with torch.cuda.stream(self.side) if self.cuda else _nothing():
                sm = slot["out"].surf_mask[0]
                locs = torch.nonzero(sm).to(torch.int32).cpu().numpy()
                sdf = slot["out"].surf_sdf[0][sm].cpu().numpy()
        slot["t_done"] = time.perf_counter()
        slot["latency_s"] = slot["t_done"] - slot["t0"]
        i = slot["room"]["index"]
        self.seen[i] += self.sampling
        if self.sampling and self.rng.random() * self.seen[i] < 1.0:
            out = slot["out"]
            self.kept[i] = {"coarse_out": out.coarse_out,
                            "fm": [slot["fm"][h] for h in
                                   range(len(self.hooks) - 1)],
                            "surf_locs": locs, "surf_sdf": sdf}
        for k in ("out", "fm", "done"):
            slot.pop(k)
        return slot

    def run(self, n: int | None = None, seconds: float | None = None):
        """Serve ``n`` rooms, or rooms until ``seconds`` have passed;
        returns the completed slots (those completed before the deadline)
        and the window's length (first enqueue to last completion)."""
        done = []
        t_start = time.perf_counter()
        deadline = None if seconds is None else t_start + seconds
        while n is None or len(done) + len(self.pending) < n:
            self.enqueue()
            if len(self.pending) >= self.in_flight:
                slot = self.complete()
                if deadline is not None and slot["t_done"] > deadline:
                    break
                done.append(slot)
        while self.pending:
            slot = self.complete()
            if deadline is None:
                done.append(slot)
        t_end = done[-1]["t_done"] if done else time.perf_counter()
        return done, t_end - t_start

    def run_open(self, seconds: float, rate: float):
        """An open loop: a room arrives every 1 / ``rate`` seconds for
        ``seconds`` and is launched once it has arrived and fewer than
        ``in_flight`` rooms are on the card (it waits on the host
        otherwise, as behind a server's queue); a room whose forward has
        ended is completed first. Above the card's capacity the backlog
        grows on the host, not in the card's memory. Returns every room
        that arrived in the window, each completed, and the window's
        length."""
        done = []
        t_start = time.perf_counter()
        due, deadline = t_start, t_start + seconds
        while due < deadline or self.pending:
            if self.pending and (not self.cuda
                                 or self.pending[0]["done"].query()):
                done.append(self.complete())
            elif (due < deadline and len(self.pending) < self.in_flight
                  and time.perf_counter() >= due):
                self.enqueue(due)
                due += 1.0 / rate
            else:
                time.sleep(1e-4)
        return done, seconds

    def close(self) -> None:
        for h in self.hooks:
            h.remove()


def _dense_mask(locs, dims, device):
    m = torch.zeros(1, *dims, dtype=torch.bool, device=device)
    if len(locs):
        t = torch.from_numpy(np.asarray(locs)).long().to(device)
        m[0, t[:, 0], t[:, 1], t[:, 2]] = True
    return m


def check_room(net, P, S, room, kept, device) -> dict:
    """The reference's run of one kept completion, following its gate
    decisions: the numbers compared (``R.gate_gaps``, and the surface's
    sdf against the reference's at its voxels: the widest gap and the RMS,
    over the reference's RMS there) and the room's counted work."""
    from sgnn_tpu_torch.ops import folded as FO

    dims = room["dims"]
    masks = [torch.sigmoid(kept["coarse_out"][..., 0]) > 0.5]
    masks += [FO.unfold(fm)[..., 0] > 0.5 for fm in kept["fm"]]
    masks.append(_dense_mask(kept["surf_locs"], dims, device))
    work = R.Work()
    fw = R.Forward(net, P, S, work)
    with torch.no_grad(), R.precise():
        _, sdf, _ = fw(room["locs"], room["feats"], dims, masks=masks)
    gate = R.gate_gaps(fw)
    sdf_gap = sdf_rms = 0.0
    locs = kept["surf_locs"]
    if len(locs):
        t = torch.from_numpy(np.asarray(locs)).long().to(device)
        ref = sdf[0, t[:, 0], t[:, 1], t[:, 2]]
        err = torch.from_numpy(kept["surf_sdf"]).to(device) - ref
        rms = ref.pow(2).mean().sqrt().clamp_min(1e-30)
        sdf_gap = float(err.abs().max() / rms)
        sdf_rms = float(err.pow(2).mean().sqrt() / rms)
    return {"numbers": {**gate, "sdf_gap": sdf_gap, "sdf_rms": sdf_rms},
            "work": work}


def run(cell: dict, config: dict, traffic: dict, args, t0: float,
        device=None, fault=None) -> dict:
    """One run of a serving cell; ``fault(model)``, where given (the
    benchmark's tests), breaks the served path underneath before the
    window."""
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.params import load_jax_params

    device = torch.device("cuda", 0) if device is None else device
    cuda = device.type == "cuda"
    net = net_of(config)
    cfg = model_config(config, traffic)
    P, S = make_weights(net, config["weights_seed"], args.seed,
                        config["weights_jitter"], device)
    model = GenModelFolded(cfg).to(device)
    load_jax_params(model, to_numpy(P), to_numpy(S))
    pool = room_pool(traffic, device, net.truncation)
    if fault is not None:
        fault(model)
    stream = Stream(model, pool, args.seed, traffic["in_flight"], device)
    # warm-up: every room's shape once (the first run builds the kernels)
    stream.sampling = False
    stream.run(n=len(pool))
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    stream.sampling = True

    if "arrivals_per_s" in traffic:
        done, window_s = stream.run_open(args.seconds,
                                         traffic["arrivals_per_s"])
    else:
        done, window_s = stream.run(seconds=args.seconds)
    stream.sampling = False
    peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    if not done:
        raise RuntimeError("no room was completed inside the window")
    lat_ms = [s["latency_s"] * 1e3 for s in done]
    res = {"units": UNITS, "window_s": window_s,
           "memory_peak_bytes": peak,
           "metrics": {"rooms_per_s": len(done) / window_s,
                       "room_ms_p95": float(np.percentile(lat_ms, 95)),
                       "setup_s": setup_s}}
    per_room = collections.Counter(s["room"]["index"] for s in done)
    ctx = {"window": {"units": len(done), "seconds": window_s,
                      "enqueue_s": [s["enqueue_s"] for s in done]}}

    if args.trace:
        n = TRACE_PASSES * len(pool)
        with T.traced(device, warm=lambda: stream.run(n=len(pool))) as got:
            traced_done, _ = stream.run(n=n)
        ctx["trace"] = T.reduce(got)
        ctx["trace"]["per_room"] = collections.Counter(
            s["room"]["index"] for s in traced_done)
    stream.close()
    kept = stream.kept
    del stream, model
    if cuda:
        torch.cuda.empty_cache()

    # ---- correctness: the reference over one completion of every room
    numbers = {"gate_gap": 0.0, "gate_rms": 0.0, "sdf_gap": 0.0,
               "sdf_rms": 0.0}
    works, failed = {}, 0
    limits = cell["limits"]
    for room, k in zip(pool, kept):
        if k is None:  # a room never completed
            numbers = {n: NEVER for n in numbers}
            failed += 1
            continue
        c = check_room(net, P, S, room, k, device)
        works[room["index"]] = c["work"]
        failed += any(c["numbers"][n] > v for n, v in limits.items())
        for name, v in c["numbers"].items():
            numbers[name] = max(numbers[name], v)
    ctx["window"]["ops"] = sum(works[i].ops() * c for i, c in
                               per_room.items() if i in works)
    if "trace" in ctx:
        ctx["trace"]["floor_s"] = sum(
            works[i].floor_s(PEAK_BYTES, PEAK_BF16) * c
            for i, c in ctx["trace"]["per_room"].items() if i in works)
    ctx["peak_flops"] = PEAK_BF16
    res.update(ctx=ctx, attempted=len(done), failed=failed,
               numbers=numbers,
               checks={n: {"value": numbers[n], "limit": v}
                       for n, v in limits.items()})
    return res
