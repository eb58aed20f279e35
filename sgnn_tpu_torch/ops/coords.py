"""Coordinate-list primitives of the sparse execution (port of
``sgnn_tpu/ops/coords.py``).

Sparse voxel sets are fixed-capacity coordinate lists ``locs [cap, 4]``
int32 in ``(z, y, x, b)`` order, the first ``num_valid`` rows valid and
every padding row ``INVALID_COORD`` (-1). Neighbour lookup goes through
the dense *index grid*: an int32 ``[B*Z*Y*X]`` array holding ``row + 1``
at active sites and 0 elsewhere. Keys are int32 flat indices, -1 for an
invalid or out-of-bounds row; every scatter and gather on keys masks the
-1 rows explicitly (the JAX package's ``oob_key`` exists only because
``.at[]`` wraps negative indices).

``num_valid`` is a Python int here: PyTorch shapes are dynamic, so the
counts that JAX keeps on the device are read once where they are made.
"""

from __future__ import annotations

import numpy as np
import torch

INVALID_COORD = -1
_KEY_SENTINEL = np.iinfo(np.int32).max  # sorts after every valid key


def valid_mask(num_valid: int, capacity: int, device=None) -> torch.Tensor:
    """bool [capacity]: True for rows < num_valid."""
    return torch.arange(capacity, device=device) < num_valid


def flat_key(locs: torch.Tensor, spatial_size: tuple, batch_size: int
             ) -> torch.Tensor:
    """(z, y, x, b) rows [..., 4] -> int32 keys ``((b*Z + z)*Y + y)*X + x``,
    -1 for rows outside the volume or the batch."""
    Z, Y, X = spatial_size
    if batch_size * Z * Y * X >= _KEY_SENTINEL:
        raise ValueError("flat key would overflow int32")
    l64 = locs.long()
    z, y, x, b = l64.unbind(-1)
    inb = ((z >= 0) & (z < Z) & (y >= 0) & (y < Y) & (x >= 0) & (x < X)
           & (b >= 0) & (b < batch_size))
    key = ((b * Z + z) * Y + y) * X + x
    return torch.where(inb, key, -1).to(torch.int32)


def flat_key_nd(locs: torch.Tensor, spatial_size: tuple, batch_size: int
                ) -> torch.Tensor:
    """flat_key for rows with any leading dims."""
    return flat_key(locs, spatial_size, batch_size)


def build_index_grid(locs: torch.Tensor, num_valid: int, spatial_size: tuple,
                     batch_size: int) -> torch.Tensor:
    """int32 [B*Z*Y*X]: row + 1 at each valid row's key, 0 elsewhere."""
    Z, Y, X = spatial_size
    cap = locs.shape[0]
    keys = flat_key(locs, spatial_size, batch_size).long()
    ok = valid_mask(num_valid, cap, locs.device) & (keys >= 0)
    grid = torch.zeros(batch_size * Z * Y * X, dtype=torch.int32,
                       device=locs.device)
    rows = torch.arange(1, cap + 1, dtype=torch.int32, device=locs.device)
    grid[keys[ok]] = rows[ok]
    return grid


def lookup(keys: torch.Tensor, index_grid: torch.Tensor) -> torch.Tensor:
    """row + 1 for each key (any shape), 0 for a missing or -1 key."""
    k = keys.long()
    ok = k >= 0
    return torch.where(ok, index_grid[k.clamp_min(0)], 0).to(torch.int32)


def compact(keep: torch.Tensor, arrays: tuple, out_capacity: int,
            num_valid: int | None = None):
    """The rows where ``keep`` (rows < ``num_valid`` only) to the front of
    ``out_capacity``-row outputs, in their original order; rows beyond
    the capacity are dropped (lowest index wins). Integer outputs are
    padded with INVALID_COORD, floats with 0. Returns (outputs, new
    num_valid, overflow count)."""
    cap = keep.shape[0]
    if num_valid is not None:
        keep = keep & valid_mask(num_valid, cap, keep.device)
    sel = torch.nonzero(keep).squeeze(1)
    total = int(sel.shape[0])
    sel = sel[:out_capacity]
    outs = []
    for a in arrays:
        fill = INVALID_COORD if not a.dtype.is_floating_point else 0
        o = torch.full((out_capacity, *a.shape[1:]), fill, dtype=a.dtype,
                       device=a.device)
        o[:sel.shape[0]] = a[sel]
        outs.append(o)
    return (tuple(outs), min(total, out_capacity),
            max(total - out_capacity, 0))


def unique_locs(locs: torch.Tensor, num_valid: int, spatial_size: tuple,
                batch_size: int, out_capacity: int):
    """Deduplicated valid rows in key order (stable sort), cut to
    ``out_capacity``: (locs [out_capacity, 4], count, overflow)."""
    cap = locs.shape[0]
    keys = flat_key(locs, spatial_size, batch_size).long()
    keys = torch.where(valid_mask(num_valid, cap, locs.device) & (keys >= 0),
                       keys, _KEY_SENTINEL)
    sk, order = torch.sort(keys, stable=True)
    prev = torch.cat([sk.new_full((1,), -2), sk[:-1]])
    first = (sk != prev) & (sk != _KEY_SENTINEL)
    (out,), n, overflow = compact(first, (locs[order],), out_capacity)
    return out, n, overflow


def upsample_locs_x2(locs: torch.Tensor, feats: torch.Tensor):
    """The 8 children (2 * parent + offset, offsets in C order over
    {0, 1}^3) of every row, features copied: [8 cap, 4], [8 cap, C].
    Padding rows stay invalid (a child of -1 has a negative coordinate)."""
    cap = locs.shape[0]
    off = torch.tensor([[dz, dy, dx] for dz in (0, 1) for dy in (0, 1)
                        for dx in (0, 1)], dtype=locs.dtype,
                       device=locs.device)
    zyx = locs[:, None, :3] * 2 + off[None]
    b = locs[:, None, 3:4].expand(cap, 8, 1)
    new_locs = torch.cat([zyx, b], -1).reshape(cap * 8, 4)
    new_feats = feats[:, None].expand(cap, 8, feats.shape[-1]).reshape(
        cap * 8, feats.shape[-1])
    return new_locs, new_feats


def parent_locs(locs: torch.Tensor) -> torch.Tensor:
    """Stride-2 parents; padding rows stay -1."""
    zyx = torch.where(locs[:, :3] >= 0, torch.div(locs[:, :3], 2,
                                                  rounding_mode="floor"),
                      INVALID_COORD)
    return torch.cat([zyx, locs[:, 3:4]], -1)


def neighbor_offsets(filter_size: int, device=None) -> torch.Tensor:
    """Tap offsets [K, 3] int32 in C order (z slowest): centred for odd
    sizes ({-1, 0, 1}^3), from 0 for even ones ({0, 1}^3)."""
    if filter_size % 2 == 1:
        r = range(-(filter_size // 2), filter_size // 2 + 1)
    else:
        r = range(filter_size)
    return torch.tensor([[dz, dy, dx] for dz in r for dy in r for dx in r],
                        dtype=torch.int32, device=device)
