"""End-to-end scene -> mesh benchmark: forward, surface extraction and copy
to the host, marching cubes, vertex weld and PLY files on disk, pipelined
(port of the JAX package's ``tools/bench_e2e.py``).

This measures what the reference's test_scene.py does per scene (its
test_scene.py:59-103: forward, padding crop, save_predictions), not only
the forward. Scenes are synthetic sphere shells at the benchmark's dims
(96x192x192 at 2 cm, about an mp-rooms room) with per-seed jittered
centre and radius, so every scene extracts and meshes a distinct surface.
The scenes go through ``tools/test_scene.py``'s ``run_pipeline`` (scene
i+1's forward dispatched before scene i is meshed in a worker thread),
or one after another with ``--serial``; the host clock runs from the
first dispatch to the last PLY, after a warm-up scene.

    python -m sgnn_tpu_torch.tools.bench_e2e [--scenes 12] [--serial]
        [--execution folded|sparse|dense_flow] [--compute_dtype bfloat16]
        [--int8] [--no_compact] [--keep_output DIR] [--cpu]

The forward is bench.py's by default: the folded execution in bf16 at
occupancy fractions (1.0, 0.4, 0.2, 0.1), seeded random weights that
leave a surface, its only-surface form, the surface extracted on the
device (``infer.py``). The JAX tool's options pick another form:
``--execution sparse`` serves through the coordinate lists
(``GenModelSparse``, its level capacities from those fractions);
``dense_flow`` is the folded forward, as in the port's scene CLI (the
TPU's mapping of both); ``--compute_dtype``; ``--int8`` the folded
forward's int8 sites (``cfg.quantize_int8``); ``--no_compact`` the dense
fetch (every output grid, the level outputs too, copied to the host and
extracted there; ``SceneInferencer(compact=False)``), labelled
``+dense_fetch`` in ``mode`` where the default is ``+compact_fetch``;
``--keep_output DIR`` writes the PLYs there and keeps them. Prints one
JSON line {"e2e_scenes_per_sec": ..., ...}. Runs on the card; ``--cpu``
runs the plain versions on the host.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P


def synthetic_scene(dims, seed):
    """Sphere-shell TSDF scan with per-seed centre and radius jitter (the
    JAX tool's generator, draw for draw)."""
    rng = np.random.RandomState(seed)
    Z, Y, X = dims
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    r = min(Z, Y, X) * (0.30 + 0.08 * rng.rand())
    cz = Z * (0.45 + 0.1 * rng.rand())
    cy = Y * (0.45 + 0.1 * rng.rand())
    cx = X * (0.45 + 0.1 * rng.rand())
    d = np.sqrt((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) - r
    z, y, x = np.nonzero(np.abs(d) < 3.0)
    keep = rng.rand(len(z)) < 0.8  # partial scan
    z, y, x = z[keep], y[keep], x[keep]
    return {
        "name": f"synth{seed:03d}__cmp",
        "input_locs": np.stack([z, y, x], -1).astype(np.int32),
        "input_sdf": d[z, y, x].astype(np.float32),
        # only .shape is read by dispatch; no dense target needed
        "sdf": np.broadcast_to(np.float32(0), dims),
        "world2grid": np.eye(4, dtype=np.float32),
        "orig_dims": np.array(dims, np.int64),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=12)
    ap.add_argument("--serial", action="store_true",
                    help="no dispatch/mesh overlap (the naive loop)")
    ap.add_argument("--no_compact", action="store_true",
                    help="fetch the whole output grids and extract on the "
                         "host (the dense fetch)")
    ap.add_argument("--execution", default="folded",
                    choices=["folded", "sparse", "dense_flow"])
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--int8", action="store_true",
                    help="the folded forward's int8 sites")
    ap.add_argument("--keep_output", default="",
                    help="write the PLYs into this directory and keep them")
    ap.add_argument("--dims", type=int, nargs=3, default=list(C.SCENE_DIM))
    C.device_arg(ap)
    args = ap.parse_args(argv)
    if args.int8 and args.execution == "sparse":
        ap.error("--int8 serves the folded forward; the coordinate lists "
                 "have no int8 mode")
    return args


def main(argv=None) -> dict:
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.meshing.export import save_predictions
    from sgnn_tpu_torch.tools.test_scene import run_pipeline

    args = parse_args(argv)
    device = C.device_of(args, "bench_e2e")
    dims = tuple(args.dims)
    cfg = SGNNConfig(input_dim=dims, batch_size=1,
                     occupancy_fractions=C.FRACTIONS,
                     execution=args.execution,
                     compute_dtype=args.compute_dtype,
                     quantize_int8=args.int8)
    scenes = [synthetic_scene(dims, s) for s in range(args.scenes)]
    model, _, seed = C.serving_model(cfg, scenes[0], device,
                                     sparse=args.execution == "sparse")
    if args.keep_output:
        os.makedirs(args.keep_output, exist_ok=True)
    with contextlib.ExitStack() as stack:
        out_dir = args.keep_output or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="bench_e2e_"))
        inf = SceneInferencer(model, want_levels=False,
                              compact=not args.no_compact)

        # warm-up on scene 0 (the kernels' first launches, the allocator)
        t0 = time.perf_counter()
        r = inf(scenes[0])
        first_s = time.perf_counter() - t0
        surf_n = len(r["surf_locs"])
        if not surf_n:
            raise SystemExit("bench_e2e: degenerate warm-up, no surface "
                             "voxels")

        t0 = time.perf_counter()
        if args.serial:
            for s in scenes:
                res = inf(s)
                save_predictions(
                    out_dir, res["name"], res["input_locs"],
                    res["input_sdf"], tuple(int(d) for d in res["orig_dims"]),
                    pred_surf=(res["surf_locs"], res["surf_sdf"]),
                    truncation=3.0)
            n_ok = len(scenes)
        else:
            n_ok = run_pipeline(inf, scenes, out_dir, 3.0)["num_meshed"]
            print()  # after run_pipeline's progress line
        wall = time.perf_counter() - t0

        meshes = [f for f in os.listdir(out_dir)
                  if f.endswith("pred-mesh.ply")]
        mesh_bytes = sum(os.path.getsize(os.path.join(out_dir, f))
                         for f in meshes)
        if len(meshes) != args.scenes:
            raise SystemExit(f"bench_e2e: {len(meshes)} predicted meshes "
                             f"for {args.scenes} scenes")
    res = {
        "e2e_scenes_per_sec": n_ok / wall,
        "mean_scene_ms": wall / n_ok * 1e3,
        "scenes": n_ok,
        "surf_voxels_scene0": surf_n,
        "pred_mesh_files": len(meshes),
        "pred_mesh_mb": mesh_bytes / 1e6,
        "compile_plus_first_s": first_s,
        "mode": ("serial" if args.serial else "pipelined")
        + ("+dense_fetch" if args.no_compact else "+compact_fetch"),
        "execution": args.execution,
        "compute_dtype": args.compute_dtype,
        "int8": args.int8,
        "seed": seed,
        "device": P.device_entry(device),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
