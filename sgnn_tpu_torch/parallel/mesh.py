"""Process groups, per-rank batches and the rank launcher (port of
``sgnn_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` with a "data" axis (and,
for spatial sharding, a "space" axis) and reduces over an axis by name
inside ``shard_map``. Here every device is a process (a rank) of
``torch.distributed``, and an axis is a process group:

  * ``Groups`` holds this rank's data group (the ranks that share its
    space index: batch moments, gradients and metrics are reduced over it)
    and its space group (the ranks that share its data index: the z-slabs
    of one scene), laid out as ``__graft_entry__.py:349-352`` lays out its
    mesh, data major and space minor: rank = data_index * num_space +
    space_index. A group of one rank is ``None`` and reduces nothing.
  * ``launch`` starts the ranks, each in a process of its own, with their
    rendezvous in a ``FileStore`` (no TCP port to collide on).
  * ``device_batch`` regroups a collated global batch into per-rank
    sub-batches exactly as the JAX package assigns samples and capacities
    (a numpy copy of ``mesh.py:65-174``); ``put_device_batch`` moves this
    rank's slice to its device, ``prefetch_to_device`` two batches ahead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's place in a data x space grid of ranks."""
    data: object | None    # ProcessGroup over the data axis, None if 1 rank
    space: object | None   # ProcessGroup over the space axis, None if 1
    rank: int
    world: int
    device: torch.device
    num_data: int = 1
    num_space: int = 1

    @property
    def data_index(self) -> int:
        return self.rank // self.num_space

    @property
    def space_index(self) -> int:
        return self.rank % self.num_space


def init_groups(num_data: int, num_space: int,
                device: str | torch.device) -> Groups:
    """The data and space groups of an initialised process group of
    ``num_data * num_space`` ranks. ``device``: "cpu", "cuda" (one card a
    rank: cuda:rank modulo the cards), or a device every rank shares
    ("cuda:0"). Every rank calls ``dist.new_group`` for every group, in the
    same order, as torch.distributed requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_data * num_space != world:
        raise ValueError(f"{num_data} x {num_space} ranks, the process group "
                         f"has {world}")
    backend = dist.get_backend()
    data = space = None
    if num_data > 1:
        for s in range(num_space):
            g = dist.new_group([d * num_space + s for d in range(num_data)],
                               backend=backend)
            if rank % num_space == s:
                data = g
    if num_space > 1:
        for d in range(num_data):
            g = dist.new_group([d * num_space + s for s in range(num_space)],
                               backend=backend)
            if rank // num_space == d:
                space = g
    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if str(device) == "cuda" else torch.device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Groups(data, space, rank, world, dev, num_data, num_space)


def launch(fn, nprocs: int, backend: str = "gloo", args: tuple = (),
           timeout_s: float = 900.0) -> list:
    """Run ``fn(*args)`` in ``nprocs`` ranks, each a spawned process with
    one CPU thread, inside an initialised process group (``backend``:
    "nccl" with a card a rank, "gloo" otherwise, CUDA tensors included);
    returns each rank's return value in rank order. ``fn`` must be
    importable by the children (a function of this package: a child
    imports the module that holds it). A rank that raises fails the launch
    and ends the others; a collective that waits ``timeout_s`` raises."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="sgnn-ranks-")
    try:
        mp.spawn(_rank_main, args=(fn, nprocs, backend, tmp, args, timeout_s),
                 nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, fn, world, backend, tmp, args, timeout_s):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------- per-rank batches (mesh.py:65)


def _split_rows(locs, vals, n, num_devices: int, per: int, cap_d: int,
                locs_dtype=np.int32):
    """Re-collate pooled sparse rows (batch column = locs[:, 3]) into
    per-device arrays with device-local batch indices and equal capacity.

    ``locs_dtype`` int16 halves coordinate H2D bytes (any chunk/scene dim
    and per-device batch index fits in int16; the device step casts back
    to int32 — put_device_batch).
    """
    out_locs = np.full((num_devices, cap_d, 4), -1, locs_dtype)
    val_shape = (num_devices, cap_d) + vals.shape[1:]
    out_vals = np.zeros(val_shape, np.float32)
    out_num = np.zeros((num_devices,), np.int32)
    for d in range(num_devices):
        m = (locs[:n, 3] >= d * per) & (locs[:n, 3] < (d + 1) * per)
        sel_locs = locs[:n][m].astype(locs_dtype)
        sel_locs[:, 3] -= d * per
        k = min(len(sel_locs), cap_d)
        out_locs[d, :k] = sel_locs[:k]
        out_vals[d, :k] = vals[:n][m][:k]
        out_num[d] = k
    return out_locs, out_vals, out_num


def device_batch(batch: dict, num_devices: int,
                 transfer_dtype=np.float32) -> dict:
    """Regroup a collated global batch into per-device sub-batches.

    Every array gains a leading [D] axis; sparse coordinate batch indices
    are rewritten to be device-local. The global batch size must divide by
    num_devices; sparse rows are re-collated per device with equal
    capacity (global_cap // D each).

    Two schemas (data/dataset.py):
      * dense (collate): dense "sdf"/"known"/"hierarchy" grids.
      * sparse-target (collate_sparse): "target_locs/vals", per-level
        "hier_locs/vals", bit-packed "known_unk" — the device step
        densifies (train/step.py). Sparse rows additionally ship their
        coordinates as int16 (half the bytes).

    ``transfer_dtype``: the numpy dtype float arrays are regrouped in
    (put_device_batch ships them in a torch type of its own).
    """
    sparse_tgt = "target_locs" in batch
    B = (batch["known_unk"] if sparse_tgt else batch["sdf"]).shape[0]
    assert B % num_devices == 0, f"batch {B} not divisible by {num_devices}"
    per = B // num_devices
    cap = batch["input_locs"].shape[0]
    cap_d = cap // num_devices

    in_dtype = np.int16 if sparse_tgt else np.int32
    out_locs, out_feats, out_num = _split_rows(
        batch["input_locs"], batch["input_sdf"],
        int(batch["input_num_valid"]), num_devices, per, cap_d,
        locs_dtype=in_dtype,
    )

    def split(a):
        return a.reshape(num_devices, per, *a.shape[1:])

    td = np.dtype(transfer_dtype)

    def fcast(a):
        return a.astype(td) if a.dtype == np.float32 else a

    out = {
        "input_locs": out_locs,
        "input_sdf": fcast(out_feats),
        "input_num_valid": out_num,
    }
    if sparse_tgt:
        tl, tv, tn = _split_rows(
            batch["target_locs"], batch["target_vals"],
            int(batch["target_num_valid"]), num_devices, per,
            batch["target_locs"].shape[0] // num_devices,
            locs_dtype=np.int16,
        )
        out.update(
            target_locs=tl, target_vals=fcast(tv), target_num_valid=tn
        )
        hl_out, hv_out, hn_out = [], [], []
        for hl, hv, hn in zip(
            batch["hier_locs"], batch["hier_vals"], batch["hier_num"]
        ):
            a, b, c = _split_rows(
                hl, hv, int(hn), num_devices, per,
                hl.shape[0] // num_devices, locs_dtype=np.int16,
            )
            hl_out.append(a)
            hv_out.append(fcast(b))
            hn_out.append(c)
        out.update(
            hier_locs=hl_out, hier_vals=hv_out, hier_num=hn_out,
            known_unk=split(batch["known_unk"]),
            target_pos=split(batch["target_pos"]),
            hier_pos=[split(hp) for hp in batch["hier_pos"]],
        )
        return out
    out["sdf"] = fcast(split(batch["sdf"]))
    out["known"] = split(batch["known"])
    if batch.get("hierarchy") is not None:
        out["hierarchy"] = [fcast(split(h)) for h in batch["hierarchy"]]
    else:
        out["hierarchy"] = None
    return out


def rank_slice(dev_batch: dict, index: int) -> dict:
    """Device ``index``'s sub-batch of a ``device_batch`` result, in the
    one-device schema ``train/step.py`` takes (counts as numpy ints)."""
    def take(v):
        if isinstance(v, list):
            return [take(x) for x in v]
        if v is None:
            return None
        a = np.asarray(v[index])
        return a[()] if a.ndim == 0 else np.ascontiguousarray(a)
    return {k: take(v) for k, v in dev_batch.items()}


def put_device_batch(dev_batch: dict, index: int, device,
                     transfer_dtype=torch.float32, stream=None) -> dict:
    """Device ``index``'s slice of a ``device_batch`` result on
    ``device``: pinned host copies sent with non-blocking copies on
    ``stream`` (a side CUDA stream; the current stream when None), float
    arrays in ``transfer_dtype`` and int16 coordinates widened to int32 on
    the device. A consumer on another stream waits for ``stream`` before
    it reads the tensors (``prefetch_to_device`` does)."""
    from sgnn_tpu_torch.train.step import to_device

    dev = torch.device(device)
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        out = to_device(rank_slice(dev_batch, index), dev, transfer_dtype)

        def widen(v):
            if isinstance(v, list):
                return [widen(x) for x in v]
            if torch.is_tensor(v) and v.dtype == torch.int16:
                return v.int()
            return v
        return {k: widen(v) for k, v in out.items()}


def prefetch_to_device(batches, index: int, device, size: int = 2,
                       transfer_dtype=torch.float32):
    """Yield (host batch, this rank's device batch) with ``size`` batches'
    copies in flight ahead of the consumer: each ``device_batch`` result's
    slice ``index`` goes through ``put_device_batch`` on a side stream,
    and the consumer's stream waits for it before the batch is handed
    out. ``batches`` yields (host batch, device_batch result) pairs."""
    dev = torch.device(device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    buf = collections.deque()

    def ready(item):
        host, b, ev = item
        if side is not None:
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(ev)
            # the side stream allocated them: keep the allocator from
            # reusing their memory before the consumer's stream is done
            for t in _tensors(b):
                t.record_stream(cur)
        return host, b

    for host, dbatch in batches:
        b = put_device_batch(dbatch, index, dev, transfer_dtype, side)
        ev = None
        if side is not None:
            ev = torch.cuda.Event()
            ev.record(side)
        buf.append((host, b, ev))
        if len(buf) >= size:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree
