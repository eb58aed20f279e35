"""Host meshing throughput: ``save_predictions`` (sparse -> dense scatter,
marching cubes, vertex weld, two binary PLY meshes) per scene against the
number of worker threads, at the benchmark scene's dims (port of the JAX
package's ``tools/bench_mesh.py``).

This isolates the host half of the scene -> mesh pipeline (the worker of
``tools/test_scene.py``'s ``run_pipeline``), so ``--mesh_workers`` can be
sized to the host; the reference's per-scene export is its
data_util.py:250-284 and marching_cubes.cpp:459-478. The predicted
surface is the scan shell itself (``bench_e2e.synthetic_scene``), of the
density of a real prediction. It runs on the host only and needs no card.

    python -m sgnn_tpu_torch.tools.bench_mesh [--scenes 8] [--workers 1 2 4]

Prints one JSON line per worker count.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.tools.bench_e2e import synthetic_scene


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--dims", type=int, nargs=3, default=list(C.SCENE_DIM))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from sgnn_tpu_torch.meshing.export import save_predictions

    args = parse_args(argv)
    dims = tuple(args.dims)
    results = []
    for s in range(args.scenes):
        sc = synthetic_scene(dims, s)
        results.append({
            "name": sc["name"], "input_locs": sc["input_locs"],
            "input_sdf": sc["input_sdf"],
            "orig_dims": np.array(dims, np.int64),
            "surf_locs": sc["input_locs"], "surf_sdf": sc["input_sdf"] * 0.5,
        })

    def mesh_one(out_dir, r):
        save_predictions(
            out_dir, r["name"], r["input_locs"], r["input_sdf"],
            tuple(int(d) for d in r["orig_dims"]), target_for_sdf=None,
            target_for_occs=None, pred_surf=(r["surf_locs"], r["surf_sdf"]),
            pred_occ_locs=None, truncation=3.0)

    # the native marching-cubes library (built at first use) and the page
    # cache, warmed outside the timed runs
    warm = tempfile.mkdtemp(prefix="bench_mesh_warm_")
    mesh_one(warm, results[0])
    shutil.rmtree(warm, ignore_errors=True)

    runs = []
    for w in args.workers:
        out_dir = tempfile.mkdtemp(prefix="bench_mesh_")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=w) as pool:
            for f in [pool.submit(mesh_one, out_dir, r) for r in results]:
                f.result()
        dt = time.perf_counter() - t0
        n_ply = len([f for f in os.listdir(out_dir) if f.endswith(".ply")])
        shutil.rmtree(out_dir, ignore_errors=True)
        run = {"mesh_workers": w, "host_cpus": os.cpu_count(),
               "scenes": args.scenes, "ply_files": n_ply,
               "ms_per_scene": dt / args.scenes * 1e3,
               "scenes_per_sec": args.scenes / dt}
        print(json.dumps(run))
        runs.append(run)
    return {"device": {"platform": "cpu"}, "runs": runs}


if __name__ == "__main__":
    main()
