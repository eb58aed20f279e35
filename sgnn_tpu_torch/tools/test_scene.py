"""Whole-scene inference CLI, flag-compatible with the reference
test_scene.py and with the JAX package's ``tools/test_scene.py``.

    python -m sgnn_tpu_torch.tools.test_scene \\
        --input_data_path ./data/mp_sdf_vox_2cm_input \\
        --target_data_path ./data/mp_sdf_vox_2cm_target \\
        --test_file_list filelists/mp-rooms_test-scenes.txt \\
        --model_path sgnn.pth --output output/mp

``--model_path`` takes a reference ``.pth`` (converted on load) or a
``.ckpt`` written by either package. The forward runs on the CUDA device
``--gpu`` with the hand-written kernels; ``--cpu`` runs it on the host
with every kernel's plain PyTorch version. Without ``--cpu`` a missing
CUDA device is an error. ``--execution dense_flow`` and ``folded`` run
the folded forward (``GenModelFolded``), the TPU's mapping of both;
``--execution sparse`` runs the coordinate-list execution
(``GenModelSparse``, its sparse convs on K10), with level capacities
sized by ``--occupancy_fractions``. ``SGNN_NO_SURFPACK=1`` builds the
folded model with the summed surface head instead of the multi-scale
one, as it selects that branch in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    # the reference's test_scene.py:20-46, plus the JAX package's additions
    p = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.test_scene",
        description="Complete whole scenes and export their meshes.")
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index (ignored with --cpu)")
    p.add_argument("--input_data_path", required=True)
    p.add_argument("--target_data_path", required=True)
    p.add_argument("--test_file_list", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--output", default="./output")
    p.add_argument("--num_hierarchy_levels", type=int, default=4)
    p.add_argument("--max_input_height", type=int, default=128)
    p.add_argument("--truncation", type=float, default=3.0)
    p.add_argument("--input_dim", type=int, default=128,
                   help="accepted for compatibility; each scene runs at "
                        "its own padded dims")
    p.add_argument("--encoder_dim", type=int, default=8)
    p.add_argument("--coarse_feat_dim", type=int, default=16)
    p.add_argument("--refine_feat_dim", type=int, default=16)
    p.add_argument("--no_pass_occ", action="store_true")
    p.add_argument("--no_pass_feats", action="store_true")
    p.add_argument("--use_skip_sparse", type=int, default=1)
    p.add_argument("--use_skip_dense", type=int, default=1)
    p.add_argument("--max_to_vis", type=int, default=10)
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU with the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--dim_round", type=int, nargs="+", default=[0],
                   help="pad scene dims to a multiple of this (0 = "
                        "hierarchy_factor*4); one value or a per-axis "
                        "'z y x' triple")
    p.add_argument("--occupancy_fractions", type=float, nargs="+",
                   default=[1.0, 0.5, 0.25, 0.2],
                   help="per-level capacity fractions of the sparse "
                        "execution (its rows beyond a capacity are "
                        "dropped and counted); the folded forward's "
                        "shapes are dynamic and ignore them")
    p.add_argument("--execution", default="dense_flow",
                   choices=["sparse", "dense_flow", "folded"],
                   help="dense_flow and folded both run the folded "
                        "forward; sparse the coordinate-list execution")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--tap_order", default="c", choices=["c", "flipped"],
                   help="scn filter-tap enumeration of a .pth")
    p.add_argument("--mesh_workers", type=int, default=2,
                   help="host meshing worker threads (the native "
                        "marching-cubes core releases the GIL)")
    args = p.parse_args(argv)
    if args.no_pass_feats and args.no_pass_occ:
        p.error("--no_pass_feats and --no_pass_occ exclude each other")
    if args.num_hierarchy_levels <= 1:
        p.error("--num_hierarchy_levels must be > 1")
    if len(args.dim_round) not in (1, 3):
        p.error(f"--dim_round takes 1 value or a 'z y x' triple, got "
                f"{len(args.dim_round)}: {args.dim_round}")
    return args


def load_params(model_path, cfg, tap_order="c"):
    """(params, stats) numpy trees from a reference .pth or a .ckpt."""
    if str(model_path).endswith(".pth"):
        from sgnn_tpu_torch.utils.ckpt_convert import \
            load_reference_checkpoint

        params, stats, _ = load_reference_checkpoint(model_path, cfg,
                                                     tap_order=tap_order)
        return params, stats
    from sgnn_tpu_torch.checkpoint import load_checkpoint

    ck = load_checkpoint(model_path, cfg)
    return ck.params, ck.stats


def select_device(cpu: bool, gpu: int, prog: str) -> torch.device:
    """The host CPU with ``cpu``, else CUDA device ``gpu``; exits with a
    message when there is no CUDA device."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; pass --cpu to run the "
                         f"plain versions on the host")
    return torch.device("cuda", gpu)


def build_model(cfg, params, stats, device):
    """The serving model of ``cfg.execution`` (module docstring), filled
    with (params, stats) and moved to ``device``."""
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.models.sgnn import GenModelSparse
    from sgnn_tpu_torch.params import load_jax_params

    if cfg.execution == "sparse":
        model = GenModelSparse(cfg)
    else:
        model = GenModelFolded(
            cfg, surf_pack=not os.environ.get("SGNN_NO_SURFPACK"))
    load_jax_params(model, params, stats)
    return model.to(device)


def main(argv=None) -> dict:
    """Runs the CLI; returns run_pipeline's statistics."""
    args = parse_args(argv)
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.data import formats as F
    from sgnn_tpu_torch.data.dataset import SceneDataset
    from sgnn_tpu_torch.infer import SceneInferencer

    device = select_device(args.cpu, args.gpu, "test_scene")

    f = 2 ** (args.num_hierarchy_levels - 1) * 4
    cfg = SGNNConfig(
        encoder_dim=args.encoder_dim,
        input_dim=(f,) * 3,  # placeholder; per-scene dims via for_scene
        nf_coarse=args.coarse_feat_dim,
        nf=args.refine_feat_dim,
        num_hierarchy_levels=args.num_hierarchy_levels,
        pass_occ=not args.no_pass_occ,
        pass_feats=not args.no_pass_feats,
        use_skip_sparse=bool(args.use_skip_sparse),
        use_skip_dense=bool(args.use_skip_dense),
        truncation=args.truncation,
        batch_size=1,
        occupancy_fractions=tuple(args.occupancy_fractions),
        execution=args.execution,
        compute_dtype=args.compute_dtype,
    )
    model = build_model(cfg, *load_params(args.model_path, cfg,
                                           args.tap_order), device)
    print(f"loaded model: {args.model_path} ({device})")

    test_files, _ = F.get_train_files(args.input_data_path,
                                      args.test_file_list, "")
    if len(test_files) > args.max_to_vis:
        test_files = test_files[:args.max_to_vis]
    random.seed(42)  # the reference's test_scene.py:114
    random.shuffle(test_files)
    print(f"#test files = {len(test_files)}")
    ds = SceneDataset(
        test_files, args.truncation, args.num_hierarchy_levels,
        max_input_height=args.max_input_height,
        target_path=args.target_data_path,
        dim_round=(args.dim_round[0] if len(args.dim_round) == 1
                   else tuple(args.dim_round)),
    )
    os.makedirs(args.output, exist_ok=True)
    stats = run_pipeline(SceneInferencer(model), ds, args.output,
                         args.truncation, mesh_workers=args.mesh_workers)
    times = stats["scene_times"]
    if len(times) > 1:
        print(f"\ndone; mean scene->mesh time {np.mean(times[1:]):.3f}s "
              f"(excl. first)")
    elif times:
        print(f"\ndone; scene->mesh time {times[0]:.3f}s")
    else:
        print("\ndone")
    return stats


def run_pipeline(inferencer, ds, output, truncation, max_scenes=None,
                 save=True, mesh_workers=2):
    """Scene -> mesh pipeline: scene i+1's forward is dispatched before
    scene i is collected, and scene i's marching cubes, weld and PLY run
    in a worker thread (the native core releases the GIL).

    The reference loop's work (test_scene.py:59-103 and the export at
    data_util.py:250-284), pipelined. A scene that raises is reported and
    skipped, as there; ``skipped`` counts them. ``scene_times`` holds each
    scene's seconds from dispatch to collected surface.
    """
    from concurrent.futures import ThreadPoolExecutor

    from sgnn_tpu_torch.meshing.export import save_predictions

    n_total = len(ds) if max_scenes is None else min(len(ds), max_scenes)
    times, mesh_futs = [], []

    def mesh_one(result):
        if save:
            save_predictions(
                output, result["name"], result["input_locs"],
                result["input_sdf"],
                tuple(int(d) for d in result["orig_dims"]),
                pred_surf=(result["surf_locs"], result["surf_sdf"]),
                truncation=truncation,
            )
        return result["name"]

    pool = ThreadPoolExecutor(max_workers=max(1, mesh_workers))
    pending = None  # (t0, handle) of the scene in flight
    skipped = 0
    try:
        for i in range(n_total + 1):
            handle = None
            if i < n_total:
                sample = ds[i]
                dims = sample["sdf"].shape
                sys.stdout.write(f"\r[ {i} | {n_total} ] {sample['name']} "
                                 f"({dims[0]}, {dims[1]}, {dims[2]})    ")
                sys.stdout.flush()
                try:
                    handle = (time.time(), inferencer.dispatch(sample))
                except Exception as e:  # skip-and-continue
                    print(f"\nexception at {sample['name']}: {e}")
                    skipped += 1
            if pending is not None:
                t0, h = pending
                try:
                    result = inferencer.collect(h)
                    mesh_futs.append(pool.submit(mesh_one, result))
                    times.append(time.time() - t0)
                except Exception as e:
                    print(f"\nexception at {h['sample']['name']}: {e}")
                    skipped += 1
            pending = handle
        for fut in mesh_futs:
            fut.result()  # surface meshing exceptions
    finally:
        pool.shutdown(wait=True)
    return {"scene_times": times, "num_meshed": len(mesh_futs),
            "skipped": skipped}


if __name__ == "__main__":
    sys.exit(1 if main()["skipped"] else 0)
