"""Binary volume formats: .sdf (scene), .sdfs (train chunk), .knw (known).

Port of ``sgnn_tpu/data/formats.py``, whose byte layouts are defined by
the reference parsers (``data_util.py:63-144``) and writers (datagen
``VoxelGrid.h:120-218``):

    header: uint64 dimx, dimy, dimz; float32 voxelsize; float32[16] world2grid
    sparse block: uint64 num; uint32 locs[num*3] (x,y,z); float32 vals[num]
    .sdf  = header + sparse block
    .sdfs = header + input block + target block
            + uint64 num(==dimx*dimy*dimz) + uint8 known[dimz*dimy*dimx]
            + 3 hierarchy levels (factor 2, 4, 8): sparse blocks
    .knw  = header + uint8 known[dimz*dimy*dimx]

Parsers return zyx-ordered locs and SDF in voxel units (divided by
voxelsize), as the reference loaders do.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_HEADER = np.dtype([
    ("dimx", "<u8"),
    ("dimy", "<u8"),
    ("dimz", "<u8"),
    ("voxelsize", "<f4"),
    ("world2grid", "<f4", (16,)),
])


@dataclasses.dataclass
class SceneVolume:
    locs: np.ndarray  # [N, 3] int32, zyx
    sdf: np.ndarray  # [N] float32, voxel units
    dims: tuple[int, int, int]  # (dimz, dimy, dimx)
    voxelsize: float
    world2grid: np.ndarray  # [4, 4] float32


@dataclasses.dataclass
class TrainChunk:
    input_locs: np.ndarray  # [N, 3] int32, zyx
    input_sdf: np.ndarray  # [N] float32, voxel units
    target_sdf: np.ndarray  # [Z, Y, X] float32 dense, -inf default
    dims: tuple[int, int, int]
    voxelsize: float
    world2grid: np.ndarray
    known: np.ndarray  # [Z, Y, X] uint8
    hierarchy: list  # L-1 dense [z, y, x] float32, COARSE -> FINE


@dataclasses.dataclass
class TrainChunkSparse:
    """A .sdfs chunk with the target and hierarchy kept as the file's
    sparse rows (densified on the device, train/step.py)."""
    input_locs: np.ndarray  # [N, 3] int32, zyx
    input_sdf: np.ndarray  # [N] float32, voxel units
    target_locs: np.ndarray  # [M, 3] int32, zyx
    target_vals: np.ndarray  # [M] float32, voxel units
    dims: tuple[int, int, int]
    voxelsize: float
    world2grid: np.ndarray
    known: np.ndarray  # [Z, Y, X] uint8
    hierarchy: list  # L-1 of (locs [K, 3] int32, vals [K] f32), COARSE->FINE
    hier_dims: list  # L-1 of (z, y, x), COARSE -> FINE


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, dtype, count=1):
        dt = np.dtype(dtype)
        out = np.frombuffer(self.buf, dt, count, self.off)
        self.off += dt.itemsize * count
        return out

    def header(self):
        h = self.take(_HEADER)[0]
        dims = (int(h["dimz"]), int(h["dimy"]), int(h["dimx"]))
        return dims, float(h["voxelsize"]), np.array(
            h["world2grid"], np.float32).reshape(4, 4)

    def sparse_block(self, voxelsize):
        num = int(self.take("<u8")[0])
        locs = self.take("<u4", num * 3).reshape(num, 3).astype(np.int32)
        locs = locs[:, ::-1].copy()  # xyz (file) -> zyx
        vals = self.take("<f4", num).astype(np.float32) / voxelsize
        return locs, vals


def sparse_to_dense(locs, values, dims, default_val):
    """zyx locs -> dense [Z, Y, X] (reference data_util.py:43-53)."""
    dense = np.full(dims, default_val, np.float32)
    dense[locs[:, 0], locs[:, 1], locs[:, 2]] = values
    return dense


def load_scene(path) -> SceneVolume:
    """.sdf scene file (reference data_util.py:112-129)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    dims, vs, w2g = r.header()
    locs, sdf = r.sparse_block(vs)
    return SceneVolume(locs, sdf, dims, vs, w2g)


def load_scene_known(path) -> np.ndarray:
    """.knw file (reference data_util.py:132-144)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    dims, _, _ = r.header()
    return r.take("u1", dims[0] * dims[1] * dims[2]).reshape(dims).copy()


def load_train_file_sparse(path) -> TrainChunkSparse:
    """.sdfs train chunk, target and hierarchy kept sparse (the byte walk
    of the reference's data_util.py:63-108 without its densify)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    dims, vs, w2g = r.header()
    in_locs, in_sdf = r.sparse_block(vs)
    t_locs, t_sdf = r.sparse_block(vs)
    num = int(r.take("<u8")[0])
    if num != dims[0] * dims[1] * dims[2]:
        raise ValueError(f"bad known block in {path}")
    known = r.take("u1", num).reshape(dims).copy()
    hierarchy, hier_dims = [], []
    factor = 2
    for _ in range(3):
        hierarchy.append(r.sparse_block(vs))
        hier_dims.append(tuple(d // factor for d in dims))
        factor *= 2
    hierarchy.reverse()  # the file is fine -> coarse
    hier_dims.reverse()
    return TrainChunkSparse(in_locs, in_sdf, t_locs, t_sdf, dims, vs, w2g,
                            known, hierarchy, hier_dims)


def load_train_file(path) -> TrainChunk:
    """.sdfs train chunk, dense (the reference's data_util.py:63-108)."""
    c = load_train_file_sparse(path)
    target = sparse_to_dense(c.target_locs, c.target_vals, c.dims, -np.inf)
    hierarchy = [sparse_to_dense(locs, vals, hd, -np.inf)
                 for (locs, vals), hd in zip(c.hierarchy, c.hier_dims)]
    return TrainChunk(c.input_locs, c.input_sdf, target, c.dims,
                      c.voxelsize, c.world2grid, c.known, hierarchy)


def _write_header(f, dims, voxelsize, world2grid):
    Z, Y, X = dims
    np.array([X, Y, Z], "<u8").tofile(f)
    np.array([voxelsize], "<f4").tofile(f)
    np.asarray(world2grid, "<f4").reshape(16).tofile(f)


def _write_sparse_block(f, locs, vals, voxelsize):
    """locs zyx (int), vals in voxel units -> file stores xyz + world units."""
    np.array([len(locs)], "<u8").tofile(f)
    np.ascontiguousarray(np.asarray(locs, np.uint32)[:, ::-1]).tofile(f)
    (np.asarray(vals, np.float32) * voxelsize).tofile(f)


def save_scene(path, volume: SceneVolume):
    with open(path, "wb") as f:
        _write_header(f, volume.dims, volume.voxelsize, volume.world2grid)
        _write_sparse_block(f, volume.locs, volume.sdf, volume.voxelsize)


def save_known(path, dims, voxelsize, world2grid, known):
    with open(path, "wb") as f:
        _write_header(f, dims, voxelsize, world2grid)
        np.asarray(known, np.uint8).tofile(f)


def save_train_file(path, chunk: TrainChunk):
    """Inverse of load_train_file (hierarchy given coarse -> fine; the
    target and hierarchy rows are their finite voxels in C order)."""
    vs = chunk.voxelsize
    with open(path, "wb") as f:
        _write_header(f, chunk.dims, vs, chunk.world2grid)
        _write_sparse_block(f, chunk.input_locs, chunk.input_sdf, vs)
        for grid in (chunk.target_sdf, None, *reversed(chunk.hierarchy)):
            if grid is None:  # the known block sits after the target
                np.array([chunk.known.size], "<u8").tofile(f)
                np.asarray(chunk.known, np.uint8).tofile(f)
                continue
            locs = np.stack(np.nonzero(np.isfinite(grid)), -1)
            _write_sparse_block(f, locs, grid[tuple(locs.T)], vs)


def get_train_files(data_path, file_list, val_file_list=""):
    """File-list resolution (reference data_util.py:12-21): names without
    an extension get '__0__.sdf' appended."""
    with open(file_list) as f:
        names = f.read().splitlines()
    if names and "." not in names[0]:
        names = [n + "__0__.sdf" for n in names]
    files = [os.path.join(data_path, n) for n in names]
    val_files = []
    if val_file_list:
        with open(val_file_list) as f:
            val_files = [os.path.join(data_path, n)
                         for n in f.read().splitlines()]
    return files, val_files
