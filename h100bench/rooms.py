"""The general generator of the benchmark's inputs: scanned box rooms.

A traffic file (``traffic/<name>.json``) holds only parameters; this
module turns them and ``--seed`` into rooms on the card. A room follows
the synthetic rooms the port's tools draw (``make_synthetic_scenes``'s
footprints of 3.2-5.6 m at 2 cm voxels, ``chip_smoke.py``'s box room): the
signed distance in voxels to a floor, walls and (on some rooms) a ceiling
``inset`` voxels in from the volume's faces, plus furniture boxes on the
floor; the scan sees the truncation band of that distance minus an
unscanned corner and spherical occlusion holes. The rooms themselves
(shapes, ceilings, the boxes' and holes' places and sizes, the scan's
rows) are drawn from the traffic file's ``content_seed``, so every seed
serves the same set of rooms and does the same work; ``--seed`` draws the
order they arrive in (and, in the drivers, the weights' jitter and the
completions the check samples).

Rows are what ``SceneInferencer.dispatch`` hands the folded forward: the
observed voxels sorted by (z, y, x), int64 ``[N, 4]`` locations with the
batch column 0, and f32 ``[N, 1]`` TSDF values, here made on the card.
A room's scan keeps a seeded uniform subset of its voxels,
``rows_per_column`` rows for each (y, x) column of its footprint (a
sparser scan of the same surfaces), so every room of a shape has the same
count, inside the range that Matterport rooms hold (~68k-630k observed
voxels).
"""

from __future__ import annotations

import numpy as np
import torch


def rng_for(seed: int, *key: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any non-negative integer, however
    large) and a stream key."""
    return np.random.default_rng([int(seed) % (1 << 64), *key])


def torch_gen(seed: int, device, *key: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng_for(seed, *key).integers(1 << 62)))
    return g


def room_field(dims, p: dict, index: int, rng: np.random.Generator,
               device):
    """(signed distance [Z, Y, X] f32 in voxels, seen [Z, Y, X] bool) of
    the pool's room ``index`` on ``device``: a ceiling where
    ``p["ceilings"]`` says so (the same rooms for every seed), boxes and
    holes placed and sized from ``rng``."""
    Z, Y, X = dims
    z = torch.arange(Z, device=device, dtype=torch.float32)[:, None, None]
    y = torch.arange(Y, device=device, dtype=torch.float32)[None, :, None]
    x = torch.arange(X, device=device, dtype=torch.float32)[None, None, :]
    a = p["inset"]
    faces = [z - a, y - a, Y - 1 - a - y, x - a, X - 1 - a - x]
    if p["ceilings"][index]:
        faces.append(Z - 1 - a - z)
    d = faces[0]
    for f in faces[1:]:
        d = torch.minimum(d, f)
    lo, hi = p["box_half"]
    for _ in range(int(rng.integers(p["boxes"][0], p["boxes"][1] + 1))):
        h = rng.uniform(lo, hi, 3)
        c = (a + h[0], rng.uniform(a + h[1] + 4, Y - a - h[1] - 4),
             rng.uniform(a + h[2] + 4, X - a - h[2] - 4))
        box = torch.maximum(torch.maximum((z - c[0]).abs() - h[0],
                                          (y - c[1]).abs() - h[1]),
                            (x - c[2]).abs() - h[2])
        d = torch.minimum(d, box)
    cy, cx = p["unscanned_corner"]
    seen = ~((y > cy * Y) & (x > cx * X)).expand(Z, Y, X)
    rlo, rhi = p["hole_radius"]
    for _ in range(int(p["holes"])):
        c, r = rng.uniform(0, dims), rng.uniform(rlo, rhi)
        seen = seen & (((z - c[0]) ** 2 + (y - c[1]) ** 2
                        + (x - c[2]) ** 2) > r * r)
    return d, seen


def room_rows(dims, p: dict, seed: int, index: int, device,
              truncation: float):
    """One room's input rows (locs [N, 4] int64, feats [N, 1] f32) on
    ``device``, sorted by (z, y, x): ``p["rows_per_column"]`` for each
    (y, x) column, or every observed voxel where the scan holds fewer."""
    d, seen = room_field(dims, p, index, rng_for(seed, 1, index), device)
    obs = (d.abs() < truncation) & seen
    zyx = torch.nonzero(obs)  # row-major: sorted by (z, y, x)
    n = round(p["rows_per_column"] * dims[1] * dims[2])
    if len(zyx) > n:
        keep = torch.randperm(len(zyx), device=device,
                              generator=torch_gen(seed, device, 2, index))
        zyx = zyx[keep[:n].sort().values]
    locs = torch.zeros(len(zyx), 4, dtype=torch.int64, device=device)
    locs[:, :3] = zyx
    feats = d[zyx[:, 0], zyx[:, 1], zyx[:, 2]][:, None].contiguous()
    return locs, feats


def room_pool(traffic: dict, device, truncation: float) -> list:
    """The traffic's rooms (from its ``content_seed``): one per footprint,
    each a dict with ``dims``, ``locs`` and ``feats``."""
    Z, seed = traffic["z"], traffic["content_seed"]
    pool = []
    for i, (Y, X) in enumerate(traffic["footprints"]):
        dims = (Z, Y, X)
        locs, feats = room_rows(dims, traffic["room"], seed, i, device,
                                truncation)
        pool.append({"index": i, "dims": dims, "locs": locs,
                     "feats": feats})
    return pool


def stream_order(n: int, seed: int):
    """An endless sequence of pool indices: each pass over the pool in a
    new order drawn from ``seed``."""
    rng = rng_for(seed, 3)
    while True:
        yield from (int(i) for i in rng.permutation(n))


# ------------------------------------------------------------ training chunks

_HEADER = np.dtype([("dimx", "<u8"), ("dimy", "<u8"), ("dimz", "<u8"),
                    ("voxelsize", "<f4"), ("world2grid", "<f4", (16,))])


def _block(f, locs, vals, voxel_size: float) -> None:
    """A sparse block of a chunk file: the count, xyz uint32 locations and
    the values in world units."""
    np.array([len(locs)], "<u8").tofile(f)
    np.ascontiguousarray(np.asarray(locs, np.uint32)[:, ::-1]).tofile(f)
    (np.asarray(vals, np.float32) * voxel_size).tofile(f)


def write_chunk(path: str, dims, voxel_size: float, in_locs, in_sdf,
                target, known, hierarchy) -> None:
    """A ``.sdfs`` training chunk (the SG-NN data format): header, input
    rows, target rows, known grid, then the hierarchy's rows finest first
    (``hierarchy`` given coarse -> fine); a grid's rows are its finite
    voxels in C order."""
    Z, Y, X = dims
    with open(path, "wb") as f:
        h = np.zeros((), _HEADER)
        h["dimx"], h["dimy"], h["dimz"] = X, Y, Z
        h["voxelsize"] = voxel_size
        h["world2grid"] = np.eye(4, dtype=np.float32).reshape(16)
        h.tofile(f)
        _block(f, in_locs, in_sdf, voxel_size)
        for grid in (target, None, *reversed(hierarchy)):
            if grid is None:
                np.array([known.size], "<u8").tofile(f)
                np.asarray(known, np.uint8).tofile(f)
                continue
            locs = np.stack(np.nonzero(np.isfinite(grid)), -1)
            _block(f, locs, grid[tuple(locs.T)], voxel_size)


def chunk_files(traffic: dict, device, truncation: float,
                out_dir: str) -> list:
    """The traffic's training chunks written under ``out_dir``: from each
    room of the pool (its ``content_seed``), ``chunk_grid`` chunks of
    ``chunk`` voxels at
    fixed positions (a grid over the footprint, so walls and floor fall in
    every pass), as the port's box-room chunks are cut: the input the
    room's scanned rows inside the chunk, the target and its hierarchy
    (factors 8, 4, 2) the distance within ``target_band`` truncations,
    known 255 off the scan (unobserved), 0 on it. Returns the paths, in
    pool order."""
    import os

    seed = traffic["content_seed"]
    cz, cy, cx = traffic["chunk"]
    ny, nx = traffic["chunk_grid"]
    band_t = traffic["target_band"] * truncation
    vs = traffic["voxel_size_m"]
    paths = []
    for i, (Y, X) in enumerate(traffic["footprints"]):
        dims = (traffic["z"], Y, X)
        p = traffic["room"]
        d, seen = room_field(dims, p, i, rng_for(seed, 1, i), device)
        locs, feats = room_rows(dims, p, seed, i, device, truncation)
        inp = torch.zeros(dims, dtype=torch.bool, device=device)
        inp[locs[:, 0], locs[:, 1], locs[:, 2]] = True
        ys = np.linspace(0, Y - cy, ny).round().astype(int) // 8 * 8
        xs = np.linspace(0, X - cx, nx).round().astype(int) // 8 * 8
        for y0 in ys:
            for x0 in xs:
                sl = (slice(0, cz), slice(y0, y0 + cy), slice(x0, x0 + cx))
                dc = d[sl].cpu().numpy()
                ic = torch.nonzero(inp[sl]).cpu().numpy()
                band = np.where(np.abs(dc) < band_t, dc, -np.inf)
                hier = [np.where(np.abs(dc[::f, ::f, ::f] / f) < band_t,
                                 dc[::f, ::f, ::f] / f, -np.inf)
                        .astype(np.float32) for f in (8, 4, 2)]
                known = np.where(seen[sl].cpu().numpy(), 0, 255)
                path = os.path.join(out_dir, f"room{i}_y{y0}_x{x0}.sdfs")
                write_chunk(path, (cz, cy, cx), vs, ic,
                            dc[tuple(ic.T)], band.astype(np.float32),
                            known.astype(np.uint8), hier)
                paths.append(path)
    return paths


def epoch_order(paths: list, passes: int, seed: int) -> list:
    """The file list of a training run: ``passes`` passes over the chunks,
    each in a new order drawn from ``seed`` (so the first pass's batches
    hold distinct chunks)."""
    rng = rng_for(seed, 5)
    return [paths[i] for _ in range(passes)
            for i in rng.permutation(len(paths))]
