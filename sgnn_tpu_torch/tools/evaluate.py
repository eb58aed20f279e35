"""Per-scene evaluation: SDF L1 and occupancy IoU on scene pairs; port of
the JAX package's ``tools/evaluate.py``, with its flags, its per-scene
records and aggregate, and its JSON layout.

    python -m sgnn_tpu_torch.tools.evaluate --input_data_path ... \\
        --target_data_path ... \\
        --test_file_list filelists/mp-rooms_val-scenes.txt \\
        --model_path sgnn.pth --output metrics.json

``--model_path`` takes a reference ``.pth`` (converted on load) or a
``.ckpt`` of either package. The forward runs on the CUDA device
``--gpu`` with the hand-written kernels; ``--cpu`` runs it on the host
with every kernel's plain PyTorch version. Without ``--cpu`` a missing
CUDA device is an error. ``--execution dense_flow`` and ``folded`` serve
through ``GenModelFolded``, ``sparse`` through ``GenModelSparse``, as the
scene CLI maps them (``tools/test_scene.py``), the folded model with the
serving ablations that CLI reads from the environment. The metrics (the
reference's loss.py:84-231, ``losses.py``) are computed from the
inferencer's surface on the device the forward ran on. Each scene's
``seconds`` is its forward and the copy of its surface to the host.

The JSON holds ``aggregate`` (the mean of each metric over the scenes
where it is defined, -1 where none is), ``scenes``,
``measured_occupancy_fractions`` (``SceneInferencer.measured_fractions``)
and, with ``--tap_order auto``, ``tap_order``. The JAX tool's
``refit_capacities`` has no counterpart: the port refits no capacities.
A scene that raises is reported and left out, and the run then exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.evaluate",
        description="Score a model on scene pairs: SDF L1 and occupancy "
                    "IoU per scene and in aggregate.")
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index (ignored with --cpu)")
    p.add_argument("--input_data_path", required=True)
    p.add_argument("--target_data_path", required=True)
    p.add_argument("--test_file_list", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--output", default="metrics.json")
    p.add_argument("--num_hierarchy_levels", type=int, default=4)
    p.add_argument("--max_input_height", type=int, default=128)
    p.add_argument("--truncation", type=float, default=3.0)
    p.add_argument("--encoder_dim", type=int, default=8)
    p.add_argument("--coarse_feat_dim", type=int, default=16)
    p.add_argument("--refine_feat_dim", type=int, default=16)
    p.add_argument("--max_scenes", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU with the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--occupancy_fractions", type=float, nargs="+",
                   default=[1.0, 0.5, 0.25, 0.2],
                   help="per-level capacity fractions of the sparse "
                        "execution; the folded forward's shapes are "
                        "dynamic and ignore them")
    p.add_argument("--dim_round", type=int, nargs="+", default=[0],
                   help="pad scene dims to a multiple of this (0 = "
                        "hierarchy_factor*4); one value or a per-axis "
                        "'z y x' triple")
    p.add_argument("--execution", default="dense_flow",
                   choices=["sparse", "dense_flow", "folded"],
                   help="dense_flow and folded both run the folded "
                        "forward; sparse the coordinate-list execution")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--tap_order", default="c",
                   choices=["c", "flipped", "auto"],
                   help="scn filter-tap enumeration of a .pth. 'auto' "
                        "evaluates the first scene under both and keeps "
                        "the self-consistent one (lower SDF L1 at "
                        "predicted voxels); the verdict is printed and "
                        "recorded in the output JSON")
    args = p.parse_args(argv)
    if args.num_hierarchy_levels <= 1:
        p.error("--num_hierarchy_levels must be > 1")
    if len(args.dim_round) not in (1, 3):
        p.error(f"--dim_round takes 1 value or a 'z y x' triple, got "
                f"{len(args.dim_round)}: {args.dim_round}")
    if args.tap_order == "auto" and not args.model_path.endswith(".pth"):
        p.error("--tap_order auto certifies reference .pth conversions")
    return args


def main(argv=None) -> dict:
    """Runs the CLI; returns ``metrics`` (the JSON written) and
    ``skipped`` (scenes that raised)."""
    args = parse_args(argv)
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.data import formats as F
    from sgnn_tpu_torch.data.dataset import SceneDataset
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.tools.test_scene import build_model, load_params, \
        select_device

    device = select_device(args.cpu, args.gpu, "evaluate")
    f = 2 ** (args.num_hierarchy_levels - 1) * 4
    cfg = SGNNConfig(
        encoder_dim=args.encoder_dim,
        input_dim=(f,) * 3,  # placeholder; per-scene dims via for_scene
        nf_coarse=args.coarse_feat_dim,
        nf=args.refine_feat_dim,
        num_hierarchy_levels=args.num_hierarchy_levels,
        truncation=args.truncation,
        batch_size=1,
        occupancy_fractions=tuple(args.occupancy_fractions),
        execution=args.execution,
        compute_dtype=args.compute_dtype,
    )
    files, _ = F.get_train_files(args.input_data_path, args.test_file_list)
    if args.max_scenes:
        files = files[: args.max_scenes]
    ds = SceneDataset(
        files, args.truncation, args.num_hierarchy_levels,
        max_input_height=args.max_input_height,
        target_path=args.target_data_path,
        dim_round=(args.dim_round[0] if len(args.dim_round) == 1
                   else tuple(args.dim_round)),
    )

    tap_verdict = None
    if args.tap_order == "auto":
        # a wrong tap order scrambles every 3^3 / 2^3 conv, so the SDF L1
        # at predicted voxels degrades by orders of magnitude: evaluate the
        # first scene under both conventions and keep the self-consistent
        # one (the reference's test_scene.py:61-62 checkpoint load)
        sample0 = ds[0]
        scores = {}
        for order in ("c", "flipped"):
            model = build_model(
                cfg, *load_params(args.model_path, cfg, order), device)
            rec = _eval_scene(SceneInferencer(model), sample0,
                              args.truncation, device)
            scores[order] = rec["l1_pred"] if rec else float("inf")
            print(f"[tap-order {order}] l1_pred = {scores[order]}")
        best = min(scores, key=lambda k: scores[k]
                   if scores[k] >= 0 else float("inf"))
        tap_verdict = {"chosen": best, "l1_pred_c": scores["c"],
                       "l1_pred_flipped": scores["flipped"]}
        print(f"[tap-order] certified: '{best}' "
              f"(c={scores['c']:.4g}, flipped={scores['flipped']:.4g})")
        args.tap_order = best

    model = build_model(
        cfg, *load_params(args.model_path, cfg, args.tap_order), device)
    inferencer = SceneInferencer(model)
    per_scene, skipped = [], 0
    for i in range(len(ds)):
        rec = _eval_scene(inferencer, ds[i], args.truncation, device)
        if rec is None:
            skipped += 1
            continue
        per_scene.append(rec)
        print(rec)
    agg = {}
    for k in ("l1_pred", "l1_tgt", "iou_surface", "seconds"):
        vals = [s[k] for s in per_scene if s[k] >= 0]
        agg[k] = float(np.mean(vals)) if vals else -1.0
    out = {"aggregate": agg, "scenes": per_scene}
    # calibration record: the observed per-level occupancy fractions
    # (bake these into --occupancy_fractions for the sparse execution)
    out["measured_occupancy_fractions"] = {
        "x".join(map(str, dims)): fr
        for dims, fr in inferencer.measured_fractions().items()
    }
    if tap_verdict is not None:
        out["tap_order"] = tap_verdict
    with open(args.output, "w") as fo:
        json.dump(out, fo, indent=1)
    print("aggregate:", agg)
    return {"metrics": out, "skipped": skipped}


def _eval_scene(inferencer, sample: dict, truncation: float,
               device) -> dict | None:
    """One scene's record: its forward, then l1_pred, l1_tgt and
    iou_surface of its surface (-1 with no surface) on ``device``; None
    if the scene raised."""
    from sgnn_tpu_torch import losses as L

    t0 = time.time()
    try:
        r = inferencer(sample)
    except Exception as e:  # the reference's skip-and-continue
        print(f"exception at {sample['name']}: {e!r}")
        return None
    dt = time.time() - t0
    n = len(r["surf_locs"])
    rec = {"name": r["name"], "l1_pred": -1.0, "l1_tgt": -1.0,
           "iou_surface": -1.0, "seconds": round(dt, 3), "surf_voxels": n}
    if not n:
        return rec
    tgt = torch.from_numpy(sample["sdf"][None]).to(device)
    known = torch.from_numpy(sample["known"][None]).to(device)
    tgt_clamped = L.preprocess_sdf(tgt, truncation)
    locs4 = torch.zeros(n, 4, dtype=torch.int32)
    locs4[:, :3] = torch.from_numpy(r["surf_locs"])
    locs4 = locs4.to(device)
    sdf = torch.from_numpy(r["surf_sdf"]).float().to(device)
    rec["l1_pred"] = float(L.compute_l1_predsurf_sparse_dense(
        locs4, n, sdf, tgt_clamped, None, False, True,
        known >= L.UNK_THRESH))
    rec["l1_tgt"] = float(L.compute_l1_tgtsurf_sparse_dense(
        locs4, n, sdf, tgt_clamped, truncation, True, known))
    occ_t = torch.where(known >= L.UNK_THRESH,
                        torch.full_like(tgt_clamped, L.UNK_ID),
                        (tgt_clamped.abs() < truncation).float())
    rec["iou_surface"] = float(L.compute_iou_sparse_dense(
        locs4, n, torch.ones(n, dtype=torch.bool, device=device), occ_t,
        True))
    return rec


if __name__ == "__main__":
    sys.exit(1 if main()["skipped"] else 0)
