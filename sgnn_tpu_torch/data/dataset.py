"""Samples, collation into fixed-capacity batches, and the batch loader.

Port of ``sgnn_tpu/data/dataset.py``, the host-side counterpart of the
reference's ``scene_dataloader.py:13-116``. ``SceneDataset`` has two
modes:

  * chunk mode (training; no ``target_path``): .sdfs train chunks, with the
    target and hierarchy either densified (``collate``) or, with
    ``sparse_targets``, kept as the file's rows and densified on the
    device (``collate_sparse``, train/step.py);
  * scene mode (inference): paired input/target .sdf plus the target's
    .knw, the height crop at ``max_input_height`` and the pad to a
    multiple of ``dim_round`` (default hierarchy_factor * 4, the
    reference's choice).

``BatchLoader`` shuffles with a seeded generator, batches (drop-last) and
collates in worker threads ahead of the consumer, in order.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from sgnn_tpu_torch.data import formats as F

UP_AXIS = 0  # z (reference train.py:73)
UNK_THRESH = 2  # known >= 2 is unobserved (loss.py:10)


def shard_files(files, host_id: int, num_hosts: int):
    """Disjoint per-host file shards for multi-host data parallelism
    (dataset.py:30-38): each host loads only its stride slice of the file
    list, so no file is read twice."""
    return files[host_id::num_hosts]


class SceneDataset:
    """Chunk samples (dicts with ``name``, ``input_locs`` [N, 3] zyx,
    ``input_sdf`` [N] with |sdf| < truncation, the target as ``sdf`` /
    ``known`` / ``hierarchy`` grids or, with ``sparse_targets``, as
    ``target_locs`` / ``target_vals`` / ``target_pos`` / ``hier_rows`` /
    ``hier_pos`` / ``known_unk``, ``world2grid``, ``orig_dims``), or scene
    samples (``sdf`` the padded dense target, -inf where unknown,
    ``known`` 255 in the padding, ``hierarchy`` None, ``orig_dims`` the
    target's dims before the crop and the pad). ``num_overfit`` repeats a
    short file list to about that many samples (the reference's overfit
    mode)."""

    def __init__(self, files, truncation: float, num_hierarchy_levels: int,
                 max_input_height: int = 0, num_overfit: int = 0,
                 target_path: str = "", dim_round=0,
                 sparse_targets: bool = False):
        if num_hierarchy_levels > 4:
            raise ValueError("the precomputed hierarchy has 3 levels")
        self.is_chunks = target_path == ""
        if self.is_chunks:
            self.files = [f for f in files if os.path.isfile(f)]
        else:
            self.files = [
                (f, os.path.join(target_path, os.path.basename(f)))
                for f in files
                if os.path.isfile(f) and os.path.isfile(
                    os.path.join(target_path, os.path.basename(f)))
            ]
        self.truncation = truncation
        self.num_hierarchy_levels = num_hierarchy_levels
        self.max_input_height = max_input_height
        # a scalar rounds every axis; a (z, y, x) triple rounds per axis
        base = 2 ** (num_hierarchy_levels - 1) * 4
        if np.ndim(dim_round) == 0:
            dim_round = (dim_round or base,) * 3
        self.dim_round = np.asarray(dim_round, np.int64)
        if self.dim_round.shape != (3,) or (self.dim_round <= 0).any() or (
                self.dim_round % base).any():
            raise ValueError(f"dim_round {tuple(self.dim_round)} must be "
                             f"positive multiples of hierarchy_factor*4 = "
                             f"{base}")
        self.sparse_targets = sparse_targets and self.is_chunks
        if num_overfit > 0 and self.files:
            self.files = self.files * max(1, num_overfit // len(self.files))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        if self.is_chunks:
            return self._get_chunk(self.files[idx])
        return self._get_scene(*self.files[idx])

    def _levels(self, hierarchy):
        return hierarchy[4 - self.num_hierarchy_levels:]

    def _get_chunk_sparse(self, path):
        """Chunk sample with the target and hierarchy as sparse rows,
        thinned without loss: the loss reads values only through the clamp
        to +-truncation, so rows <= -truncation are dropped (they densify
        as missing, -inf, which clamps the same) and rows >= +truncation
        become one bit each in a packed plane (rebuilt as +truncation on
        the device)."""
        name = os.path.splitext(os.path.basename(path))[0]
        c = F.load_train_file_sparse(path)
        dims = tuple(int(d) for d in c.dims)
        trunc = self.truncation

        def band_and_bits(locs, vals, d):
            keep = (vals > -trunc) & (vals < trunc)
            plane = np.zeros(d[0] * d[1] * d[2], np.bool_)
            pl = locs[vals >= trunc]
            plane[(pl[:, 0] * d[1] + pl[:, 1]) * d[2] + pl[:, 2]] = True
            return locs[keep], vals[keep], np.packbits(plane,
                                                       bitorder="little")

        t_locs, t_vals, t_pos = band_and_bits(c.target_locs, c.target_vals,
                                              dims)
        hier_rows, hier_pos = [], []
        L = self.num_hierarchy_levels
        for h, (locs, vals) in enumerate(self._levels(c.hierarchy)):
            f = 2 ** (L - 1 - h)
            hl, hv, hp = band_and_bits(locs, vals,
                                       tuple(d // f for d in dims))
            hier_rows.append((hl, hv))
            hier_pos.append(hp)
        mask = np.abs(c.input_sdf) < trunc
        return {
            "name": name,
            "input_locs": c.input_locs[mask],
            "input_sdf": c.input_sdf[mask],
            "target_locs": t_locs,
            "target_vals": t_vals,
            "target_pos": t_pos,
            "hier_rows": hier_rows,
            "hier_pos": hier_pos,
            "known_unk": np.packbits((c.known >= UNK_THRESH).reshape(-1),
                                     bitorder="little"),
            "world2grid": c.world2grid,
            "orig_dims": np.array(c.dims, np.int64),
        }

    def _get_chunk(self, path):
        if self.sparse_targets:
            return self._get_chunk_sparse(path)
        name = os.path.splitext(os.path.basename(path))[0]
        c = F.load_train_file(path)
        mask = np.abs(c.input_sdf) < self.truncation
        return {
            "name": name,
            "input_locs": c.input_locs[mask],
            "input_sdf": c.input_sdf[mask],
            "sdf": c.target_sdf,
            "known": c.known,
            "hierarchy": self._levels(c.hierarchy),
            "world2grid": c.world2grid,
            "orig_dims": np.array(c.dims, np.int64),
        }

    def _get_scene(self, input_file, target_file):
        name = os.path.splitext(os.path.basename(input_file))[0]
        inp = F.load_scene(input_file)
        tgt = F.load_scene(target_file)
        known = F.load_scene_known(os.path.splitext(target_file)[0] + ".knw")
        targets = F.sparse_to_dense(tgt.locs, tgt.sdf, tgt.dims, -np.inf)
        orig_dims = np.array(targets.shape, np.int64)

        in_locs, in_sdf = inp.locs, inp.sdf
        max_dim = np.array(targets.shape)
        mh = self.max_input_height
        if mh > 0 and max_dim[UP_AXIS] > mh:
            max_dim[UP_AXIS] = mh
            m = in_locs[:, UP_AXIS] < mh
            in_locs, in_sdf = in_locs[m], in_sdf[m]
        r = self.dim_round
        max_dim = ((max_dim + r - 1) // r) * r
        mh = mh if mh > 0 else targets.shape[0]
        Zc, Y, X = min(mh, targets.shape[0]), targets.shape[1], \
            targets.shape[2]
        padded = np.full(tuple(max_dim), -np.inf, np.float32)
        padded[:Zc, :Y, :X] = targets[:mh]
        known_pad = np.full(tuple(max_dim), 255, np.uint8)
        known_pad[:min(mh, known.shape[0]), :known.shape[1],
                  :known.shape[2]] = known[:mh]

        mask = np.abs(in_sdf) < self.truncation
        return {
            "name": name,
            "input_locs": in_locs[mask],
            "input_sdf": in_sdf[mask],
            "sdf": padded,
            "known": known_pad,
            "hierarchy": None,
            "world2grid": inp.world2grid,
            "orig_dims": orig_dims,
        }


def _pool_rows(locs_per_sample, vals_per_sample, capacity: int):
    """Per-sample rows with a batch column appended, concatenated and cut
    or padded to ``capacity``: (locs [cap, 4] int32, vals [cap] f32,
    num_valid, overflow)."""
    locs = np.concatenate(
        [np.concatenate([lc, np.full((len(lc), 1), b, np.int32)], 1)
         for b, lc in enumerate(locs_per_sample)], 0).astype(np.int32)
    vals = np.concatenate(vals_per_sample, 0).astype(np.float32)
    n = len(locs)
    overflow = max(0, n - capacity)
    if overflow:
        locs, vals, n = locs[:capacity], vals[:capacity], capacity
    pad = capacity - n
    locs = np.concatenate([locs, np.full((pad, 4), -1, np.int32)], 0)
    vals = np.concatenate([vals, np.zeros((pad,), np.float32)], 0)
    return locs, vals, np.int32(n), overflow


def collate_sparse(samples, input_capacity: int, target_capacity: int,
                   hier_capacities):
    """Sparse-target chunk samples -> fixed-capacity row arrays plus the
    bit-packed planes; the device step densifies them."""
    in_locs, in_vals, in_n, in_ovf = _pool_rows(
        [s["input_locs"] for s in samples],
        [s["input_sdf"] for s in samples], input_capacity)
    t_locs, t_vals, t_n, t_ovf = _pool_rows(
        [s["target_locs"] for s in samples],
        [s["target_vals"] for s in samples], target_capacity)
    nh = len(samples[0]["hier_rows"])
    if len(hier_capacities) < nh:
        raise ValueError(f"{len(hier_capacities)} hierarchy capacities for "
                         f"{nh} levels")
    hier_locs, hier_vals, hier_num, h_ovf = [], [], [], 0
    for h in range(nh):
        hl, hv, hn, ho = _pool_rows(
            [s["hier_rows"][h][0] for s in samples],
            [s["hier_rows"][h][1] for s in samples], hier_capacities[h])
        hier_locs.append(hl)
        hier_vals.append(hv)
        hier_num.append(hn)
        h_ovf = max(h_ovf, ho)
    return {
        "input_locs": in_locs,
        "input_sdf": in_vals[:, None],
        "input_num_valid": in_n,
        "target_locs": t_locs,
        "target_vals": t_vals,
        "target_num_valid": t_n,
        "hier_locs": hier_locs,
        "hier_vals": hier_vals,
        "hier_num": hier_num,
        "target_pos": np.stack([s["target_pos"] for s in samples]),
        "hier_pos": [np.stack([s["hier_pos"][h] for s in samples])
                     for h in range(nh)],
        "known_unk": np.stack([s["known_unk"] for s in samples]),
        "world2grid": np.stack([s["world2grid"] for s in samples]),
        "orig_dims": np.stack([s["orig_dims"] for s in samples]),
        "names": [s["name"] for s in samples],
        "input_overflow": in_ovf,
        "target_overflow": max(t_ovf, h_ovf),
    }


def collate(samples, input_capacity: int):
    """Samples -> input rows at a fixed capacity and stacked dense grids:
    input_locs [cap, 4] int32 (z, y, x, b), input_sdf [cap, 1] f32,
    input_num_valid, sdf, known, hierarchy (chunk mode, else None),
    world2grid, orig_dims, names, input_overflow."""
    locs, feats, n, overflow = _pool_rows(
        [s["input_locs"] for s in samples],
        [s["input_sdf"] for s in samples], input_capacity)
    batch = {
        "input_locs": locs,
        "input_sdf": feats[:, None],
        "input_num_valid": n,
        "sdf": np.stack([s["sdf"] for s in samples]),
        "known": np.stack([s["known"] for s in samples]),
        "world2grid": np.stack([s["world2grid"] for s in samples]),
        "orig_dims": np.stack([s["orig_dims"] for s in samples]),
        "names": [s["name"] for s in samples],
        "input_overflow": overflow,
        "hierarchy": None,
    }
    if samples[0]["hierarchy"] is not None:
        batch["hierarchy"] = [np.stack([s["hierarchy"][h] for s in samples])
                              for h in range(len(samples[0]["hierarchy"]))]
    return batch


class BatchLoader:
    """Shuffling (a seeded generator, reshuffled each epoch), batching with
    drop-last, and collation in worker threads feeding an order-preserving
    bounded buffer (the reference's DataLoader(num_workers=2), train.py:102;
    numpy parsing releases the GIL, so threads suffice). ``transform`` runs
    on each collated batch inside the worker thread."""

    def __init__(self, dataset: SceneDataset, batch_size: int,
                 input_capacity: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, transform=None,
                 target_capacity: int = 0, hier_capacities=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.input_capacity = input_capacity
        self.target_capacity = target_capacity
        self.hier_capacities = hier_capacities
        if getattr(dataset, "sparse_targets", False) and not (
                target_capacity > 0 and hier_capacities):
            raise ValueError("a sparse_targets dataset needs target and "
                             "hierarchy capacities (data/capacity.py: "
                             "estimate_row_capacities)")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.transform = transform

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def _collate(self, samples):
        if getattr(self.dataset, "sparse_targets", False):
            return collate_sparse(samples, self.input_capacity,
                                  self.target_capacity, self.hier_capacities)
        return collate(samples, self.input_capacity)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        nw = min(self.num_workers, nb) or 1
        stop = threading.Event()
        ready = threading.Condition()
        slots: dict[int, object] = {}
        next_claim = [0]
        # bounds how far ahead of the consumer the workers may run
        credits = threading.Semaphore(self.prefetch + nw)

        def worker():
            while not stop.is_set():
                credits.acquire()
                with ready:
                    i = next_claim[0]
                    if stop.is_set() or i >= nb:
                        return
                    next_claim[0] = i + 1
                try:
                    item = self._collate([self.dataset[j]
                                          for j in batches[i]])
                    if self.transform is not None:
                        item = self.transform(item)
                except Exception as e:  # raised in the consumer
                    item = e
                with ready:
                    slots[i] = item
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(nw)]
        for t in threads:
            t.start()
        try:
            for i in range(nb):
                with ready:
                    while i not in slots:
                        ready.wait()
                    item = slots.pop(i)
                credits.release()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            for _ in threads:  # unblock workers parked on the semaphore
                credits.release()
            for t in threads:
                t.join()
