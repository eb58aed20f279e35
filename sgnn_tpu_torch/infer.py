"""Whole-scene inference (port of ``sgnn_tpu/infer.py`` SceneInferencer).

It takes a scene sample dict (``data.dataset.SceneDataset`` gives them:
``sdf`` for the padded dims, ``input_locs``, ``input_sdf``, ``orig_dims``,
``name``), sorts the rows, runs a serving forward and returns the surface
voxels cropped to ``orig_dims``. One model serves every scene shape: the
dims are checked per scene through ``cfg.for_scene``. ``dispatch``
launches a scene's forward and returns a handle; ``collect`` crops,
extracts and copies the results to the host, so a caller overlaps scene
i+1's forward with scene i's meshing (``tools/test_scene.py``).

Every forward sees the scene's first ``cfg.input_cap`` input rows in
file order, sorted, as the JAX inferencer cuts them. Three forwards serve:
- ``GenModelFolded``, the only-surface folded forward. The JAX
  inferencer's capacity refit and overflow refetch exist only because XLA
  shapes are static; PyTorch extracts the surface with a dynamic
  ``nonzero``, so neither is needed, and only the real rows are passed
  (no padding rows).
- ``GenModelSparse`` (the coordinate-list execution) and
  ``GenModelDense`` (the dense-flow execution): the rows are padded to
  ``input_cap``, and the results carry what the JAX inferencer's
  ``_postprocess_sparse`` /
  ``_postprocess_dense`` give: every refinement level's ``locs`` and
  ``out`` (occ logit, sdf) besides the surface (the coordinate lists
  cropped to ``orig_dims``, the dense levels not), and for the sparse
  execution each level's compaction ``overflows``.

``measured_fractions`` is the JAX inferencer's calibration record
(``sgnn_tpu/infer.py:327-337``): per padded scene shape, the most sites
each refinement level ran on over the scenes served, over the level's
voxels. A level's sites are the children of the previous level's kept
voxels, 8 per voxel (the JAX forward's unpruned ``refine_masks_unfilt``),
read from ``level_active``. The JAX inferencer's capacity refit
(``_cap_override``) has no counterpart: the folded forward's shapes are
dynamic.

``cfg.quantize_int8`` is read by ``GenModelFolded`` alone: its int8 sites
take weights quantized once, at load, and serve here unchanged. The
secondary executions serve exact under the same config, as the JAX
package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from sgnn_tpu_torch.models.dense_flow import GenModelDense
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.models.sgnn import GenModelSparse
from sgnn_tpu_torch.ops.sparse import make_sparse


def synthetic_scene(dims: tuple, seed: int = 0, truncation: float = 3.0,
                    keep: float = 0.8, orig_dims: tuple | None = None,
                    name: str = "sphere") -> dict:
    """A surface-like scene sample: the TSDF of a sphere of radius
    0.35 * min(dims) at the volume's centre, with ``keep`` of the voxels
    within the truncation observed (a partial scan), as the JAX package
    builds it in __graft_entry__.py:9-41."""
    rng = np.random.RandomState(seed)
    Z, Y, X = dims
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    d = np.sqrt((zz - Z / 2.0) ** 2 + (yy - Y / 2.0) ** 2
                + (xx - X / 2.0) ** 2) - min(Z, Y, X) * 0.35
    z, y, x = np.nonzero(np.abs(d) < truncation)
    sel = rng.rand(len(z)) < keep
    z, y, x = z[sel], y[sel], x[sel]
    return {
        "name": name,
        "sdf": d.astype(np.float32),
        "input_locs": np.stack([z, y, x], -1).astype(np.int32),
        "input_sdf": d[z, y, x].astype(np.float32),
        "orig_dims": np.asarray(orig_dims or dims, np.int32),
        "world2grid": np.eye(4, dtype=np.float32),
    }


class SceneInferencer:
    """Runs scene samples through a loaded GenModelFolded, GenModelSparse
    or GenModelDense.

    ``impl="plain"`` runs every kernel's plain PyTorch version (on the
    card too); the default launches the CUDA kernels for a model on the
    card and the plain versions for a model on the CPU."""

    def __init__(self, model: GenModelFolded | GenModelSparse
                 | GenModelDense, impl: str | None = None):
        self.model = model
        self.impl = impl
        self._side = None  # the card's stream for collect()
        # padded dims -> {level: the most sites seen}
        self.observed_counts = {}

    def dispatch(self, sample: dict) -> dict:
        """Launch one scene's forward (asynchronous on the card) and
        return the handle for ``collect``."""
        dims = tuple(int(d) for d in sample["sdf"].shape)
        cfg = self.model.cfg.for_scene(dims)  # raises for dims it cannot take
        device = self.model.trunk.occ_w.device
        locs3 = np.asarray(sample["input_locs"])
        if len(locs3) and ((locs3 < 0).any() or (locs3 >= dims).any()):
            raise ValueError(f"{sample['name']}: input_locs outside {dims}")
        in_sdf = np.asarray(sample["input_sdf"], np.float32)
        folded = isinstance(self.model, GenModelFolded)
        n = min(len(locs3), cfg.input_cap)
        cap = n if folded else cfg.input_cap
        locs3, in_sdf = locs3[:n], in_sdf[:n]
        order = np.lexsort((locs3[:, 2], locs3[:, 1], locs3[:, 0]))
        locs3, in_sdf = locs3[order], in_sdf[order]
        locs = torch.full((cap, 4), -1, dtype=torch.int64)
        locs[:len(locs3), :3] = torch.from_numpy(locs3.astype(np.int64))
        locs[:len(locs3), 3] = 0
        feats = torch.zeros(cap, 1)
        feats[:len(locs3), 0] = torch.from_numpy(in_sdf)
        locs, feats = locs.to(device), feats.to(device)
        if folded:
            out = self.model(locs, feats, dims, batch_size=1, impl=self.impl)
        else:
            out = self.model(make_sparse(locs, feats, len(locs3), dims, 1),
                             impl=self.impl)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return {"sample": sample, "out": out, "done": done,
                "locs3": locs3, "in_sdf": in_sdf}

    def collect(self, handle: dict) -> dict:
        """Crop, extract and copy one dispatched scene to the host. On
        the card this runs on a stream of its own that waits only for
        this scene's forward, so a scene dispatched later keeps running."""
        if handle["done"] is None:
            res = self._extract(handle)
        else:
            if self._side is None:
                self._side = torch.cuda.Stream(
                    handle["out"].coarse_out.device)
            self._side.wait_event(handle["done"])
            with torch.cuda.stream(self._side):
                res = self._extract(handle)
        self._record_counts(tuple(handle["sample"]["sdf"].shape), res)
        return res

    def __call__(self, sample: dict) -> dict:
        return self.collect(self.dispatch(sample))

    def _record_counts(self, dims: tuple, res: dict) -> None:
        """Level i >= 1 runs on the 8 children of each voxel level i - 1
        kept; the surface shares the finest level's slot, as in the JAX
        inferencer's _compact_counts."""
        act = res["level_active"]
        counts = {i: 8 * act[i - 1] for i in range(1, len(act))}
        last = len(act) - 1
        counts[last] = max(counts[last], len(res["surf_locs"]))
        rec = self.observed_counts.setdefault(dims, {})
        for i, c in counts.items():
            rec[i] = max(rec.get(i, 0), c)

    def measured_fractions(self) -> dict:
        """Per padded scene shape: {level: the most sites seen / the
        level's voxels}, rounded to 4 places, the calibration record for
        ``occupancy_fractions``."""
        res = {}
        for dims, rec in self.observed_counts.items():
            cfg = self.model.cfg.for_scene(dims)
            res[dims] = {i: round(c / cfg.level_voxels(i), 4)
                         for i, c in sorted(rec.items())}
        return res

    @staticmethod
    def _extract(handle: dict) -> dict:
        sample, out = handle["sample"], handle["out"]
        locs3, in_sdf = handle["locs3"], handle["in_sdf"]
        orig = np.asarray(sample["orig_dims"])
        levels = [{"dense_out": out.coarse_out[0].cpu().numpy()}]
        res = {}
        if hasattr(out, "surf_num_valid"):  # coordinate lists
            def unpad(locs, num, *vals):
                zyx = locs[:num, :3]
                m = (zyx < torch.from_numpy(orig).to(zyx.device)).all(1)
                return (zyx[m].cpu().numpy(),
                        *[v[:num][m].cpu().numpy() for v in vals])

            surf_locs, surf_sdf = unpad(out.surf_locs, out.surf_num_valid,
                                        out.surf_sdf[:, 0])
            for locs_u, out_u, num_u in out.refine_outs:
                lv_locs, lv_out = unpad(locs_u, num_u, out_u)
                levels.append({"locs": lv_locs, "out": lv_out})
            res["overflows"] = [int(o) for o in out.overflows]
        else:
            sm = out.surf_mask[0].clone()
            sm[int(orig[0]):] = False
            sm[:, int(orig[1]):] = False
            sm[:, :, int(orig[2]):] = False
            surf_locs = torch.nonzero(sm).to(torch.int32).cpu().numpy()
            surf_sdf = out.surf_sdf[0][sm].cpu().numpy()
            for grid, mask in zip(getattr(out, "refine_outs", ()),
                                  getattr(out, "refine_masks_unfilt", ())):
                m = mask[0]
                levels.append({
                    "locs": torch.nonzero(m).to(torch.int32).cpu().numpy(),
                    "out": grid[0][m].cpu().numpy()})
        keep = ((locs3[:, 0] < orig[0]) & (locs3[:, 1] < orig[1])
                & (locs3[:, 2] < orig[2]))
        return {
            "name": sample["name"],
            "surf_locs": surf_locs.astype(np.int32),
            "surf_sdf": surf_sdf,
            "levels": levels,
            "level_active": [int(a) for a in out.level_active],
            "input_locs": locs3[keep],
            "input_sdf": in_sdf[keep],
            "orig_dims": orig,
            "world2grid": sample.get("world2grid"),
            **res,
        }
