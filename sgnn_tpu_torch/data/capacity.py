"""Capacities sized from the training data (port of
``sgnn_tpu/data/capacity.py``).

``estimate_row_capacities`` sizes the sparse-target transfer's row
capacities, which the training CLI needs; the rest autotunes the level
capacities of the sparse (coordinate-list) execution, which the CLI's
``--autotune_capacity`` reports and which size the input rows' capacity.

``estimate_occupancy_fractions`` scans a sample of train chunks and
measures, per hierarchy level, the fraction of voxels whose target is
occupied (|sdf| < truncation, what a converged model's predictions
track), takes a high quantile across chunks, and applies a safety
margin.
"""

from __future__ import annotations

import numpy as np

from sgnn_tpu_torch.data import formats as F


def chunk_level_occupancy(chunk, num_hierarchy_levels: int,
                          truncation: float) -> tuple[list, float]:
    """Per-level occupied fraction for one TrainChunk (coarse -> fine),
    plus the input's active fraction at full resolution."""
    hier = chunk.hierarchy
    if num_hierarchy_levels < 4:
        hier = hier[4 - num_hierarchy_levels:]
    fr = []
    for h in range(num_hierarchy_levels - 1):
        g = hier[h]
        fr.append(float((np.abs(g) < truncation).mean()))
    tgt = chunk.target_sdf
    fr.append(float((np.abs(tgt) < truncation).mean()))
    n_in = int((np.abs(chunk.input_sdf) < truncation).sum())
    return fr, n_in / float(tgt.size)


def estimate_row_capacities(
    files,
    num_hierarchy_levels: int,
    truncation: float,
    batch_size: int,
    sample: int = 32,
    quantile: float = 0.95,
    margin: float = 1.3,
    round_to: int = 1024,
    seed: int = 0,
) -> tuple[int, list]:
    """Static row capacities for the sparse-target transfer path
    (SceneDataset(sparse_targets=True) / collate_sparse).

    Scans up to ``sample`` chunks, counts target and per-level hierarchy
    rows AFTER the lossless open-band thinning (-trunc < val < trunc —
    saturated rows ship as bit planes, see SceneDataset.
    _get_chunk_sparse), and sizes whole-batch capacities as batch_size *
    quantile-count * margin, rounded up. Overflow beyond the capacity
    drops rows (counted and warned per step); the quantile + margin make
    that rare, and overflow only perturbs — never crashes — the loss.

    Returns (target_capacity, hier_capacities[num_hierarchy_levels - 1]).
    """
    rng = np.random.RandomState(seed)
    files = list(files)
    if len(files) > sample:
        files = [files[i] for i in rng.choice(len(files), sample, False)]
    t_counts, h_counts = [], []
    for f in files:
        try:
            c = F.load_train_file_sparse(f)
        except Exception:
            continue
        hier = c.hierarchy
        if num_hierarchy_levels < 4:
            hier = hier[4 - num_hierarchy_levels:]
        t_counts.append(int(
            ((c.target_vals > -truncation)
             & (c.target_vals < truncation)).sum()
        ))
        h_counts.append([
            int(((vals > -truncation) & (vals < truncation)).sum())
            for _, vals in hier
        ])
    if not t_counts:
        raise ValueError("no readable chunks to size row capacities from")

    def cap(counts):
        q = float(np.quantile(np.asarray(counts, np.float64), quantile))
        c = int(np.ceil(q * margin * batch_size))
        return max(round_to, ((c + round_to - 1) // round_to) * round_to)

    target_capacity = cap(t_counts)
    hh = np.asarray(h_counts)  # [n, L-1]
    hier_capacities = [cap(hh[:, h]) for h in range(hh.shape[1])]
    return target_capacity, hier_capacities


def estimate_occupancy_fractions(
    files,
    num_hierarchy_levels: int,
    truncation: float,
    sample: int = 64,
    quantile: float = 0.99,
    margin: float = 1.5,
    seed: int = 0,
) -> tuple[tuple, float]:
    """Returns (occupancy_fractions, input_fraction) for SGNNConfig.

    Scans up to ``sample`` random chunks; per level takes the ``quantile``
    across chunks of the occupied fraction and multiplies by ``margin``
    (capped at 1.0). The margin covers train-time predictions overshooting
    their targets; overflow counts remain observable either way
    (train loop warns on GenModelOutput.overflows > 0).
    """
    rng = np.random.RandomState(seed)
    files = list(files)
    if len(files) > sample:
        files = [files[i] for i in rng.choice(len(files), sample, False)]
    per_level = []
    inputs = []
    for f in files:
        try:
            c = F.load_train_file(f)
        except Exception:
            continue
        fr, fin = chunk_level_occupancy(c, num_hierarchy_levels, truncation)
        per_level.append(fr)
        inputs.append(fin)
    if not per_level:
        raise ValueError("no readable chunks to autotune from")
    a = np.asarray(per_level)  # [n, L]
    q = np.quantile(a, quantile, axis=0)
    fractions = tuple(float(min(1.0, v * margin)) for v in q)
    input_fraction = float(
        min(1.0, np.quantile(np.asarray(inputs), quantile) * margin)
    )
    return fractions, input_fraction
