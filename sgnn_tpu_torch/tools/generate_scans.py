"""Offline data generation: fuse Matterport RGB-D streams into .sdf/.knw
volumes (complete + incomplete pairs); port of the JAX package's
``tools/generate_scans.py``, with its flags.

Host-side replacement for the reference's Win32/D3D11 GenerateScans app:
same outputs, no renderer (the default path uses raw .sens depth,
zParametersScanMP.txt:40). The TSDF update runs in the native core
(datagen/cpp/fuse.cpp, and cpp/rasterize.cpp with --use_rendered_depth),
built with g++ before the first room; a failed build ends the run. A room
that raises is reported and skipped, as in the reference
(Visualizer.cpp:129-140), and the run then exits non-zero.

Example:
    python -m sgnn_tpu_torch.tools.generate_scans \\
        --scan_path data/Matterport/v1/scans \\
        --scan_mesh_path data/Matterport/v1/scans \\
        --scene_file_list filelists/mp-rooms_trainval.txt \\
        --output_complete out/mp_sdf_vox_2cm_scanned \\
        --output_incomplete out/mp_sdf_vox_2cm_incomplete \\
        --incomplete_frame_path out/frames/matterport
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    # defaults follow zParametersScanMP.txt:16-44
    p = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.generate_scans",
        description="Fuse .sens depth streams into .sdf/.knw scene pairs.")
    p.add_argument("--param_file", default="",
                   help="reference-style parameter file (key = value;) "
                        "overlaid on the flags")
    p.add_argument("--scan_path", default="")
    p.add_argument("--scan_mesh_path", default="")
    p.add_argument("--scene_file_list", default="")
    p.add_argument("--output_complete", default="")
    p.add_argument("--output_incomplete", default="")
    p.add_argument("--incomplete_frame_path", default="")
    p.add_argument("--max_num_scenes", type=int, default=0)
    p.add_argument("--max_num_sens", type=int, default=3)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--voxel_size", type=float, default=0.02)
    p.add_argument("--scene_padding", type=int, default=6)
    p.add_argument("--height_pad", type=int, default=3)
    p.add_argument("--chance_drop_frames", type=float, default=0.65)
    p.add_argument("--no_filter_depth", action="store_true")
    p.add_argument("--no_known", action="store_true")
    p.add_argument("--use_rendered_depth", action="store_true",
                   help="render depth from the room mesh instead of raw "
                        ".sens depth (zParametersScanMP s_bUseRenderedDepth)")
    p.add_argument("--debug_vis", action="store_true",
                   help="verify save round-trips and export debug meshes "
                        "(the reference's s_bDebugVis)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.param_file:
        from sgnn_tpu_torch.datagen.params import apply_param_file

        apply_param_file(args, args.param_file)
    for req in ("scan_path", "scan_mesh_path", "scene_file_list",
                "output_incomplete"):
        if not getattr(args, req):
            p.error(f"--{req} (or param file entry) required")
    return args


def main(argv=None) -> dict:
    """Runs the CLI; returns counts: ``fused``, ``skipped`` (rooms that
    raised), ``existing`` and ``no_frames``."""
    args = parse_args(argv)
    from sgnn_tpu_torch.datagen import fusion as FU
    from sgnn_tpu_torch.datagen import render
    from sgnn_tpu_torch.datagen.scene import Scene, load_matterport_list

    # the native cores, built (or found) before any room: a failed build
    # ends the run instead of skipping every room
    FU.get_fuse_lib()
    if args.use_rendered_depth:
        render.get_raster_lib()

    scans = load_matterport_list(
        args.scan_path, args.scan_mesh_path, args.scene_file_list,
        args.max_num_sens,
    )
    if args.max_num_scenes:
        scans = scans[: args.max_num_scenes]
    os.makedirs(args.output_incomplete, exist_ok=True)
    if args.output_complete:
        os.makedirs(args.output_complete, exist_ok=True)
    if args.incomplete_frame_path:
        os.makedirs(args.incomplete_frame_path, exist_ok=True)

    counts = {"fused": 0, "skipped": 0, "existing": 0, "no_frames": 0}
    for i, info in enumerate(scans):
        name = info.scene_name
        out_inc_sdf = os.path.join(args.output_incomplete, name + "__0__.sdf")
        out_inc_knw = os.path.join(args.output_incomplete, name + "__0__.knw")
        out_cmp_sdf = (
            os.path.join(args.output_complete, name + "__0__.sdf")
            if args.output_complete else None
        )
        out_cmp_knw = (
            os.path.join(args.output_complete, name + "__0__.knw")
            if args.output_complete else None
        )
        # skip-if-exists (Visualizer.cpp:82-91)
        done = os.path.isfile(out_inc_sdf) and (
            not out_cmp_sdf or os.path.isfile(out_cmp_sdf)
        )
        if done:
            print(f"[{i + 1}/{len(scans)}] (skip) {name}")
            counts["existing"] += 1
            continue
        try:
            scene = Scene(info, use_rendered_depth=args.use_rendered_depth)
            complete = FU.select_frames_in_obb(scene.poses, scene.obb)
            if not complete:
                print(f"[{i + 1}/{len(scans)}] (no frames) {name}")
                counts["no_frames"] += 1
                continue
            # persisted incomplete frame lists (Visualizer.cpp:104-121)
            frame_file = (
                os.path.join(args.incomplete_frame_path, name + "__0__.txt")
                if args.incomplete_frame_path else ""
            )
            if frame_file and os.path.isfile(frame_file):
                incomplete = [
                    int(l) for l in open(frame_file).read().splitlines() if l
                ]
            else:
                incomplete = FU.drop_frames(
                    complete, args.chance_drop_frames, seed=args.seed + i
                )
                if frame_file:
                    with open(frame_file, "w") as f:
                        f.writelines(f"{v}\n" for v in incomplete)
            print(
                f"[{i + 1}/{len(scans)}] {name}: fusing "
                f"{len(complete)} complete | {len(incomplete)} incomplete"
            )
            grid = FU.make_grid_for_scene(
                scene.bbox_min, scene.bbox_max, args.voxel_size, scene.obb,
                args.scene_padding, args.height_pad,
            )
            frames = {}
            for fid in set(complete) | set(incomplete):
                f = scene.depth_frame(fid, args.width, args.height)
                if f is not None:
                    frames[fid] = f
            FU.fuse_scene(
                grid,
                [frames.get(i) for i in range(max(frames) + 1)] if frames else [],
                [i for i in incomplete if i in frames],
                [i for i in complete if i in frames],
                out_incomplete=(out_inc_sdf,
                                None if args.no_known else out_inc_knw),
                out_complete=(out_cmp_sdf,
                              None if args.no_known else out_cmp_knw)
                if out_cmp_sdf else None,
                # rendered depth is clean: no bilateral filter
                # (Fuser.cpp: bFilterDepth = !s_bUseRenderedDepth)
                filter_depth=(
                    not args.no_filter_depth
                    and not args.use_rendered_depth
                ),
            )
            if args.debug_vis:
                last_sdf = out_cmp_sdf or out_inc_sdf
                ok = FU.verify_roundtrip(grid, last_sdf)
                FU.export_debug_mesh(
                    grid, last_sdf.replace(".sdf", "_debug-mesh.ply")
                )
                print(f"  [debug_vis] roundtrip "
                      f"{'OK' if ok else 'MISMATCH'}")
            scene.close()
            counts["fused"] += 1
        except Exception as e:  # per-room skip (Visualizer.cpp:129-140)
            print(f"exception at scene {name}: {e!r}")
            counts["skipped"] += 1
    print("done!")
    return counts


if __name__ == "__main__":
    sys.exit(1 if main()["skipped"] else 0)
