"""Whole-scene samples for inference.

Port of ``sgnn_tpu/data/dataset.py`` ``SceneDataset`` in scene mode
(:41-98, :186-224), the host-side counterpart of the reference's
``scene_dataloader.py:39-116``: paired input/target ``.sdf`` files plus
the target's ``.knw``, the height crop at ``max_input_height``, and the
pad to a multiple of ``dim_round`` (default hierarchy_factor * 4, the
reference's choice). Training chunks (.sdfs) are not read here yet.
"""

from __future__ import annotations

import os

import numpy as np

from sgnn_tpu_torch.data import formats as F

UP_AXIS = 0  # z (reference train.py:73)


class SceneDataset:
    """Scene samples: dicts with ``name``, ``input_locs`` [N, 3] zyx,
    ``input_sdf`` [N] (voxel units, |sdf| < truncation), ``sdf`` the
    padded dense target (-inf where unknown), ``known`` (255 in the
    padding), ``hierarchy`` None, ``world2grid`` and ``orig_dims`` (the
    target's dims before the crop and the pad)."""

    def __init__(self, files, truncation: float, num_hierarchy_levels: int,
                 max_input_height: int = 0, target_path: str = "",
                 dim_round=0):
        if not target_path:
            raise ValueError("SceneDataset reads scenes (input + target "
                             ".sdf); training chunks are not ported yet")
        if num_hierarchy_levels > 4:
            raise ValueError("the precomputed hierarchy has 3 levels")
        self.files = [
            (f, os.path.join(target_path, os.path.basename(f)))
            for f in files
            if os.path.isfile(f) and os.path.isfile(
                os.path.join(target_path, os.path.basename(f)))
        ]
        self.truncation = truncation
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

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        return self._get_scene(*self.files[idx])

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
