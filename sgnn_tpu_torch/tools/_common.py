"""What the measuring tools share: the benchmark scene's configuration, a
serving model with seeded random weights that leave a surface, a scene's
input rows, and the device a tool runs on."""

from __future__ import annotations

import argparse

import numpy as np
import torch

# the JAX package's bench.py workload (bench.py:41-42, 201-209)
SCENE_DIM = (96, 192, 192)
FRACTIONS = (1.0, 0.4, 0.2, 0.1)
SEEDS = range(4)  # init_params seeds tried for weights that leave a surface


def device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU with the kernels' plain "
                        "versions (device numbers are then not measured)")


def device_of(args, prog: str) -> torch.device:
    """cuda:0, or the host with --cpu; exits with a message when there is
    no CUDA device and no --cpu."""
    from sgnn_tpu_torch.tools.test_scene import select_device

    return select_device(args.cpu, 0, prog)


def rows(scene: dict, device) -> tuple:
    """A scene sample's input rows as the folded forward takes them:
    (locs [N, 4] int64 (z, y, x, 0), feats [N, 1] f32) on ``device``."""
    locs = torch.zeros(len(scene["input_locs"]), 4, dtype=torch.int64)
    locs[:, :3] = torch.from_numpy(scene["input_locs"].astype(np.int64))
    feats = torch.from_numpy(np.asarray(scene["input_sdf"], np.float32))
    return locs.to(device), feats[:, None].to(device)


def serving_model(cfg, scene: dict, device, sparse: bool = False
                  ) -> tuple:
    """(the serving model of ``cfg`` on ``device``, its (params, stats),
    seed): GenModelFolded, or with ``sparse`` GenModelSparse, with the
    weights of the first of SEEDS that leave a surface on ``scene``
    (random gates can close every level; chip_smoke.py phase 4 picks its
    weights the same way), else the last tried."""
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.models.sgnn import GenModelSparse
    from sgnn_tpu_torch.params import init_params, load_jax_params

    model = (GenModelSparse(cfg) if sparse else GenModelFolded(cfg)
             ).to(device)
    locs, feats = rows(scene, device)
    for seed in SEEDS:
        weights = init_params(cfg, seed)
        load_jax_params(model, *weights)
        if sparse:
            res = SceneInferencer(model, want_levels=False)(scene)
            surface = len(res["surf_locs"])
        else:
            surface = int(model(locs, feats, cfg.input_dim).surf_mask.sum())
        if surface:
            break
    return model, weights, seed
