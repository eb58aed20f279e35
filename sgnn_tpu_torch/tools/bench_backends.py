"""Compare the coordinate-list conv backends and the dense flow on the
benchmark scene (port of the JAX package's ``tools/bench_backends.py``).

For each of ``--backends``: ``gather`` and ``dense`` (``GenModelSparse``
with that ``conv_backend``: K10, or cuDNN convs on densified grids) and
``dense_flow`` (``GenModelDense``, K8 where ``use_pallas_conv`` routes
it). The configuration is the JAX tool's: the full-width model on the
96x192x192 sphere scene, occupancy fractions (1.0, 0.4, 0.2, 0.1), f32 by
default, seeded random weights that leave a surface through the folded
forward. Per backend: ``setup_s`` (model build, weight load and the first
forward, host clock; the JAX tool's ``compile_s``), then ms per scene by
CUDA events over ``--reps`` forwards and scenes per second.

    python -m sgnn_tpu_torch.tools.bench_backends
        [--backends gather dense dense_flow] [--reps 10] [--cpu]

Prints a line per backend, then one JSON line. Runs on the card;
``--cpu`` runs the plain versions on the host (the forward times are then
not measured).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P

BACKENDS = ("gather", "dense", "dense_flow")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backends", nargs="+", default=["gather", "dense"],
                    choices=BACKENDS)
    ap.add_argument("--dims", type=int, nargs=3, default=list(C.SCENE_DIM))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    C.device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import synthetic_scene
    from sgnn_tpu_torch.models.dense_flow import GenModelDense
    from sgnn_tpu_torch.models.sgnn import GenModelSparse
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.ops.sparse import make_sparse
    from sgnn_tpu_torch.params import load_jax_params

    args = parse_args(argv)
    device = C.device_of(args, "bench_backends")
    dims = tuple(args.dims)
    base = SGNNConfig(input_dim=dims, batch_size=1,
                      occupancy_fractions=C.FRACTIONS,
                      compute_dtype=args.compute_dtype)
    scene = synthetic_scene(dims, seed=0, truncation=base.truncation)
    folded, weights, seed = C.serving_model(base, scene, device)
    del folded
    # the first input_cap rows, padded to it (as SceneInferencer passes
    # them to these executions)
    locs, feats = C.rows(scene, device)
    cap = base.input_cap
    n = min(len(locs), cap)
    locs_p = torch.cat([locs[:n], locs.new_full((cap - n, 4), -1)])
    feats_p = torch.cat([feats[:n], feats.new_zeros(cap - n, 1)])
    results = {}
    for backend in args.backends:
        if backend == "dense_flow":
            cfg = dataclasses.replace(base, execution="dense_flow",
                                      use_pallas_conv=True)
            cls = GenModelDense
        else:
            cfg = dataclasses.replace(base, execution="sparse",
                                      conv_backend=backend)
            cls = GenModelSparse
        t0 = time.perf_counter()
        model = cls(cfg)
        load_jax_params(model, *weights)
        model.to(device)

        def fwd(model=model):
            return model(make_sparse(locs_p, feats_p, n, dims, 1))
        fwd()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        K.reset_launch_counts()
        fwd()
        launches = {k: v for k, v in K.launch_counts().items() if v}
        ms = P.cuda_ms(fwd, device, args.reps)
        results[backend] = {
            "setup_s": setup_s, "per_scene_ms": ms,
            "scenes_per_sec": 1e3 / ms if isinstance(ms, float) else ms,
            "launches": launches}
        print(f"[{backend}] {results[backend]}", file=sys.stderr)
        del model
    res = {"device": P.device_entry(device), "seed": seed,
           "backends": results}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
