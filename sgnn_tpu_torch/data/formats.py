"""Binary volume formats, scene side: .sdf (scene) and .knw (known).

Port of ``sgnn_tpu/data/formats.py`` (:28-127, :176-233), whose byte
layouts are defined by the reference parsers (``data_util.py:63-144``)
and writers (datagen ``VoxelGrid.h:120-218``):

    header: uint64 dimx, dimy, dimz; float32 voxelsize; float32[16] world2grid
    sparse block: uint64 num; uint32 locs[num*3] (x,y,z); float32 vals[num]
    .sdf  = header + sparse block
    .knw  = header + uint8 known[dimz*dimy*dimx]

Parsers return zyx-ordered locs and SDF in voxel units (divided by
voxelsize), as the reference loaders do. The training chunks (.sdfs) are
not read here yet.
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
