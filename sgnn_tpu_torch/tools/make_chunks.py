"""Generate .sdfs training chunks from paired incomplete/complete scene
volumes (the reference's release_64-64-128 data, whose tool is not
published; see datagen/chunking.py); port of the JAX package's
``tools/make_chunks.py``, with its flags. A scene that raises is reported
and skipped, and the run then exits non-zero.

Example:
    python -m sgnn_tpu_torch.tools.make_chunks \\
        --input_data_path out/mp_sdf_vox_2cm_incomplete \\
        --target_data_path out/mp_sdf_vox_2cm_scanned \\
        --scene_file_list filelists/mp-rooms_trainval.txt \\
        --output out/completion_blocks_2cm/release_64-64-128
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.make_chunks",
        description="Cut .sdfs training chunks from .sdf/.knw scene pairs.")
    p.add_argument("--input_data_path", required=True)
    p.add_argument("--target_data_path", required=True)
    p.add_argument("--scene_file_list", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--chunk_dims", type=int, nargs=3, default=[128, 64, 64],
                   help="zyx")
    p.add_argument("--stride", type=int, nargs=3, default=[64, 32, 32])
    p.add_argument("--min_target_surface", type=int, default=1000)
    p.add_argument("--min_input_surface", type=int, default=200)
    p.add_argument("--list_out", default="",
                   help="write the chunk file list here")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the CLI; returns ``written`` (the chunk file names),
    ``missing`` and ``skipped`` (scenes that raised)."""
    args = parse_args(argv)
    from sgnn_tpu_torch.data import formats as F
    from sgnn_tpu_torch.datagen.chunking import chunk_scene

    os.makedirs(args.output, exist_ok=True)
    names = [l for l in open(args.scene_file_list).read().splitlines() if l]
    written = []
    missing = skipped = 0
    for i, name in enumerate(names):
        in_sdf = os.path.join(args.input_data_path, name + "__0__.sdf")
        tg_sdf = os.path.join(args.target_data_path, name + "__0__.sdf")
        tg_knw = os.path.join(args.target_data_path, name + "__0__.knw")
        if not (os.path.isfile(in_sdf) and os.path.isfile(tg_sdf)):
            print(f"[{i + 1}/{len(names)}] (missing) {name}")
            missing += 1
            continue
        try:
            inp = F.load_scene(in_sdf)
            tgt = F.load_scene(tg_sdf)
            known = (
                F.load_scene_known(tg_knw) if os.path.isfile(tg_knw)
                else np.full(tgt.dims, 255, "uint8")
            )
            count = 0
            for origin, chunk in chunk_scene(
                inp, tgt, known,
                tuple(args.chunk_dims), tuple(args.stride),
                args.min_target_surface, args.min_input_surface,
            ):
                fname = f"{name}__{count}__.sdfs"
                F.save_train_file(os.path.join(args.output, fname), chunk)
                written.append(fname)
                count += 1
            print(f"[{i + 1}/{len(names)}] {name}: {count} chunks")
        except Exception as e:
            print(f"exception at {name}: {e!r}")
            skipped += 1
    if args.list_out:
        with open(args.list_out, "w") as f:
            f.writelines(w + "\n" for w in written)
    print(f"done: {len(written)} chunks")
    return {"written": written, "missing": missing, "skipped": skipped}


if __name__ == "__main__":
    sys.exit(1 if main()["skipped"] else 0)
