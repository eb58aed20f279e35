"""Prediction export: meshes + per-level occupancy point clouds.

Port of ``sgnn_tpu/meshing/export.py``, itself a port of the reference's
data_util.save_predictions (the reference's data_util.py:
250-284): per sample writes input mesh, per-level target/pred occupancy
point clouds, predicted mesh, and target mesh — all through marching cubes
with isovalue 0, truncation-0.1, thresh 10. ``mc_impl`` picks the
marching-cubes core ("native" or "numpy", marching_cubes.py).
"""

from __future__ import annotations

import os

import numpy as np

from sgnn_tpu_torch.data.formats import sparse_to_dense
from sgnn_tpu_torch.meshing import ply
from sgnn_tpu_torch.meshing.marching_cubes import marching_cubes


def make_scale_transform(scale):
    t = np.eye(4)
    for k in range(3):
        t[k, k] = scale
    return t


def _occ_points(mask_zyx):
    """Voxel-center point cloud (x, y, z) of a boolean grid."""
    z, y, x = np.nonzero(mask_zyx)
    return np.stack([x, y, z], -1).astype(np.float32) + 0.5


def save_predictions(
    output_path,
    name: str,
    input_locs,  # [N, 3] zyx
    input_sdf,  # [N]
    dims,  # (Z, Y, X)
    target_for_sdf=None,  # [Z, Y, X] or None
    target_for_occs=None,  # list of [z, y, x] occupancy or None
    pred_surf=None,  # (locs [M,3] zyx, sdf [M]) or None
    pred_occ_locs=None,  # list of [m, 3] zyx per level or None
    truncation: float = 3.0,
    ext: str = ".ply",
    mc_impl: str = "native",
):
    os.makedirs(output_path, exist_ok=True)
    isovalue = 0.0
    trunc = truncation - 0.1
    Z, Y, X = dims

    inp = sparse_to_dense(input_locs, input_sdf, dims, -np.inf)
    marching_cubes(
        inp, None, isovalue, trunc, 10.0,
        os.path.join(output_path, name + "input-mesh" + ext), impl=mc_impl,
    )
    num_levels = 0
    if pred_occ_locs is not None:
        num_levels = len(pred_occ_locs)
    elif target_for_occs is not None:
        num_levels = len(target_for_occs)
    factors = [2 ** (num_levels - 1 - h) for h in range(num_levels)]
    for h in range(num_levels):
        transform = make_scale_transform(factors[h])
        if target_for_occs is not None:
            pts = _occ_points(np.asarray(target_for_occs[h]) == 1)
            if len(pts):
                ply.save_points(
                    os.path.join(output_path, f"{name}target-{h}{ext}"),
                    pts, transform=transform,
                )
        if pred_occ_locs is not None and pred_occ_locs[h] is not None \
                and len(pred_occ_locs[h]):
            locs = np.asarray(pred_occ_locs[h])
            pts = locs[:, ::-1].astype(np.float32) + 0.5  # zyx -> xyz
            ply.save_points(
                os.path.join(output_path, f"{name}pred-{h}{ext}"),
                pts, transform=transform,
            )
    if pred_surf is not None and len(pred_surf[0]):
        locs, sdf = pred_surf
        dense = sparse_to_dense(
            np.asarray(locs), np.asarray(sdf), dims, -np.inf
        )
        marching_cubes(
            dense, None, isovalue, trunc, 10.0,
            os.path.join(output_path, name + "pred-mesh" + ext),
            impl=mc_impl,
        )
    if target_for_sdf is not None:
        marching_cubes(
            np.asarray(target_for_sdf), None, isovalue, trunc, 10.0,
            os.path.join(output_path, name + "target-mesh" + ext),
            impl=mc_impl,
        )
