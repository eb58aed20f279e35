"""Point-cloud visualization helpers (port of ``sgnn_tpu/utils/vis.py``; the
reference's data_util.py:159-248 equivalents)."""

from __future__ import annotations

import numpy as np

from sgnn_tpu_torch.meshing.ply import save_points


def visualize_sdf_as_points(sdf, iso, output_file, transform=None):
    """Near-surface voxel centers of a dense [Z, Y, X] SDF."""
    z, y, x = np.nonzero(np.abs(sdf) < iso)
    if len(z) == 0:
        print(f"warning: no valid sdf points for {output_file}")
        return
    verts = np.stack([x, y, z], -1).astype(np.float32) + 0.5
    save_points(output_file, verts, transform=transform)


def visualize_sparse_sdf_as_points(sdf_locs, sdf_vals, iso, output_file,
                                   transform=None):
    mask = np.abs(sdf_vals) < iso
    verts = np.asarray(sdf_locs)[:, :3][mask]
    if len(verts) == 0:
        print(f"warning: no valid sdf points for {output_file}")
        return
    verts = verts[:, ::-1].astype(np.float32) + 0.5  # zyx -> xyz
    save_points(output_file, verts, transform=transform)


def visualize_occ_as_points(occ, thresh, output_file, transform=None,
                            thresh_max=float("inf")):
    vals = np.abs(np.asarray(occ, np.float32))
    z, y, x = np.nonzero((vals > thresh) & (vals < thresh_max))
    if len(z) == 0:
        print(f"warning: no valid occ points for {output_file}")
        return
    verts = np.stack([x, y, z], -1).astype(np.float32) + 0.5
    save_points(output_file, verts, transform=transform)


def visualize_sparse_locs_as_points(locs, output_file, transform=None):
    verts = np.asarray(locs)[:, :3]
    if len(verts) == 0:
        print(f"warning: no valid occ points for {output_file}")
        return
    verts = verts[:, ::-1].astype(np.float32) + 0.5
    save_points(output_file, verts, transform=transform)


def compute_batchids(output_occs, output_sdf, batch_size):
    """Per-level, per-batch row masks (data_util.py:30-39)."""
    batchids = [None] * (len(output_occs) + 1)
    for h in range(len(output_occs)):
        batchids[h] = [
            output_occs[h][0][:, -1] == b for b in range(batch_size)
        ]
    batchids[-1] = [output_sdf[0][:, -1] == b for b in range(batch_size)]
    return batchids
