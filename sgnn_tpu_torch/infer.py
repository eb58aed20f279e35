"""Whole-scene inference (port of ``sgnn_tpu/infer.py`` SceneInferencer).

It takes a scene sample dict (``data.dataset.SceneDataset`` gives them:
``sdf`` for the padded dims, ``input_locs``, ``input_sdf``, ``orig_dims``,
``name``), sorts the rows, runs the only-surface serving forward and
returns the surface voxels cropped to ``orig_dims``. One model serves
every scene shape: the dims are checked per scene through
``cfg.for_scene``. ``dispatch`` launches a scene's forward and returns a
handle; ``collect`` crops, extracts and copies the surface to the host,
so a driver overlaps scene i+1's forward with scene i's meshing
(``tools/test_scene.py``). The JAX inferencer's capacity refit and
overflow refetch exist only because XLA shapes are static; PyTorch
extracts the surface with a dynamic ``nonzero``, so neither is needed
here, and the input rows are not cut to a capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from sgnn_tpu_torch.models.folded_flow import GenModelFolded


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
    """Runs scene samples through a loaded GenModelFolded.

    ``impl="plain"`` runs every kernel's plain PyTorch version (on the
    card too); the default launches the CUDA kernels for a model on the
    card and the plain versions for a model on the CPU."""

    def __init__(self, model: GenModelFolded, impl: str | None = None):
        self.model = model
        self.impl = impl
        self._side = None  # the card's stream for collect()

    def dispatch(self, sample: dict) -> dict:
        """Launch one scene's forward (asynchronous on the card) and
        return the handle for ``collect``."""
        dims = tuple(int(d) for d in sample["sdf"].shape)
        self.model.cfg.for_scene(dims)  # raises for dims it cannot take
        device = self.model.trunk.occ_w.device
        locs3 = np.asarray(sample["input_locs"])
        if len(locs3) and ((locs3 < 0).any() or (locs3 >= dims).any()):
            raise ValueError(f"{sample['name']}: input_locs outside {dims}")
        order = np.lexsort((locs3[:, 2], locs3[:, 1], locs3[:, 0]))
        locs3 = locs3[order]
        in_sdf = np.asarray(sample["input_sdf"], np.float32)[order]
        locs = torch.zeros(len(locs3), 4, dtype=torch.int64)
        locs[:, :3] = torch.from_numpy(locs3.astype(np.int64))
        feats = torch.from_numpy(in_sdf)[:, None]
        out = self.model(locs.to(device), feats.to(device), dims,
                         batch_size=1, impl=self.impl)
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
            return self._extract(handle)
        if self._side is None:
            self._side = torch.cuda.Stream(handle["out"].surf_mask.device)
        self._side.wait_event(handle["done"])
        with torch.cuda.stream(self._side):
            return self._extract(handle)

    def __call__(self, sample: dict) -> dict:
        return self.collect(self.dispatch(sample))

    @staticmethod
    def _extract(handle: dict) -> dict:
        sample, out = handle["sample"], handle["out"]
        locs3, in_sdf = handle["locs3"], handle["in_sdf"]
        orig = np.asarray(sample["orig_dims"])
        sm = out.surf_mask[0].clone()
        sm[int(orig[0]):] = False
        sm[:, int(orig[1]):] = False
        sm[:, :, int(orig[2]):] = False
        surf_locs = torch.nonzero(sm).to(torch.int32)
        surf_sdf = out.surf_sdf[0][sm]
        keep = ((locs3[:, 0] < orig[0]) & (locs3[:, 1] < orig[1])
                & (locs3[:, 2] < orig[2]))
        return {
            "name": sample["name"],
            "surf_locs": surf_locs.cpu().numpy(),
            "surf_sdf": surf_sdf.cpu().numpy(),
            "levels": [{"dense_out": out.coarse_out[0].cpu().numpy()}],
            "level_active": [int(a) for a in out.level_active],
            "input_locs": locs3[keep],
            "input_sdf": in_sdf[keep],
            "orig_dims": orig,
            "world2grid": sample.get("world2grid"),
        }
