"""Train-chunk generation: scene .sdf pairs -> .sdfs training chunks
(port of ``sgnn_tpu/datagen/chunking.py``).

The reference ships 85,564 precomputed chunks (release_64-64-128) but not
the chunking tool; this module reconstructs it from the documented contract
(.sdfs layout, the reference's torch/data_util.py:63-108): a chunk couples
an incomplete-scan input crop with the complete-scan target crop, the
known-state crop, and a 3-level coarse SDF hierarchy (factors 2, 4, 8).

Hierarchy construction: min-|sdf| pooling — each coarse voxel takes the
child SDF closest to the surface (preserves zero crossings, the standard
TSDF downsample); a coarse voxel is present when any child is finite.
Values stay in world units like every .sdf block (the training loader
divides by the FINE voxel size, so coarser levels span a wider band and
compute_targets' clamp to ±truncation reproduces a 3-fine-voxel band).
"""

from __future__ import annotations

import numpy as np

from sgnn_tpu_torch.data import formats as F


def downsample_tsdf_min_abs(dense: np.ndarray) -> np.ndarray:
    """[Z, Y, X] -> [Z/2, Y/2, X/2] taking the child with min |sdf|;
    -inf children are ignored; all-invalid -> -inf."""
    Z, Y, X = dense.shape
    v = dense.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2)
    v = np.moveaxis(v, (1, 3, 5), (3, 4, 5)).reshape(
        Z // 2, Y // 2, X // 2, 8
    )
    finite = np.isfinite(v)
    absv = np.where(finite, np.abs(v), np.inf)
    idx = absv.argmin(-1)
    out = np.take_along_axis(v, idx[..., None], -1)[..., 0]
    out = np.where(finite.any(-1), out, -np.inf)
    return out.astype(np.float32)


def make_chunk(
    input_dense,  # [Z, Y, X] world-unit SDF, -inf missing (incomplete scan)
    target_dense,  # same, complete scan
    known,  # [Z, Y, X] uint8
    origin_zyx,  # chunk corner in the scene grid
    chunk_dims_zyx,  # e.g. (128, 64, 64)
    voxelsize: float,
    world2grid_scene: np.ndarray,
    input_trunc_factor: float = 3.0,
) -> F.TrainChunk:
    z0, y0, x0 = origin_zyx
    Z, Y, X = chunk_dims_zyx
    sl = (slice(z0, z0 + Z), slice(y0, y0 + Y), slice(x0, x0 + X))
    inp = input_dense[sl]
    tgt = target_dense[sl]
    knw = known[sl]
    # sparse input block: voxels within the save band (|sdf| <= 3*vs, the
    # loader re-sparsifies at |sdf|/vs < truncation anyway)
    m = np.isfinite(inp) & (np.abs(inp) <= input_trunc_factor * voxelsize)
    locs = np.stack(np.nonzero(m), -1).astype(np.int32)
    vals = (inp[m] / voxelsize).astype(np.float32)
    hier = []
    cur = tgt
    for _ in range(3):  # factors 2, 4, 8 (stored coarse->fine in TrainChunk)
        cur = downsample_tsdf_min_abs(cur)
        hier.append(cur)
    hier.reverse()
    # chunk-local world2grid: scene w2g then translate by -origin (xyz)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [-x0, -y0, -z0]
    w2g = t @ np.asarray(world2grid_scene, np.float32)
    # target dense in voxel units like load_train_file returns
    tgt_vox = np.where(np.isfinite(tgt), tgt / voxelsize, -np.inf).astype(
        np.float32
    )
    return F.TrainChunk(
        input_locs=locs,
        input_sdf=vals,
        target_sdf=tgt_vox,
        dims=(Z, Y, X),
        voxelsize=voxelsize,
        world2grid=w2g,
        known=knw.astype(np.uint8),
        hierarchy=[
            np.where(np.isfinite(h), h / voxelsize, -np.inf).astype(np.float32)
            for h in hier
        ],
    )


def chunk_scene(
    input_vol: F.SceneVolume,
    target_vol: F.SceneVolume,
    known: np.ndarray,
    chunk_dims_zyx=(128, 64, 64),
    stride_zyx=(64, 32, 32),
    min_target_surface: int = 1000,
    min_input_surface: int = 200,
    truncation: float = 3.0,
):
    """Yield TrainChunks tiling a scene (accepted when both crops carry
    enough near-surface voxels)."""
    dims = target_vol.dims
    vs = target_vol.voxelsize
    inp = F.sparse_to_dense(
        input_vol.locs, input_vol.sdf * vs, dims, -np.inf
    )
    tgt = F.sparse_to_dense(
        target_vol.locs, target_vol.sdf * vs, dims, -np.inf
    )
    Z, Y, X = chunk_dims_zyx
    # pad scenes smaller than a chunk so crops are always full-size
    if any(d < c for d, c in zip(dims, chunk_dims_zyx)):
        pdims = tuple(max(d, c) for d, c in zip(dims, chunk_dims_zyx))
        def pad(a, fill):
            out = np.full(pdims, fill, a.dtype)
            out[: dims[0], : dims[1], : dims[2]] = a
            return out
        inp = pad(inp, -np.inf)
        tgt = pad(tgt, -np.inf)
        known = pad(np.asarray(known), np.uint8(255))
        dims = pdims
    sz, sy, sx = stride_zyx
    for z0 in range(0, max(dims[0] - Z, 0) + 1, sz):
        for y0 in range(0, max(dims[1] - Y, 0) + 1, sy):
            for x0 in range(0, max(dims[2] - X, 0) + 1, sx):
                sl = (
                    slice(z0, z0 + Z), slice(y0, y0 + Y), slice(x0, x0 + X)
                )
                tgt_c = tgt[sl]
                n_tgt = int(
                    (np.isfinite(tgt_c)
                     & (np.abs(tgt_c) < truncation * vs)).sum()
                )
                if n_tgt < min_target_surface:
                    continue
                inp_c = inp[sl]
                n_inp = int(
                    (np.isfinite(inp_c)
                     & (np.abs(inp_c) < truncation * vs)).sum()
                )
                if n_inp < min_input_surface:
                    continue
                yield (z0, y0, x0), make_chunk(
                    inp, tgt, known, (z0, y0, x0), chunk_dims_zyx, vs,
                    _vox_w2g(target_vol.world2grid),
                )


def _vox_w2g(w2g):
    return np.asarray(w2g, np.float32)
