"""Stage-level timing of the folded forward on the benchmark scene (port
of the JAX package's ``tools/bench_stages.py``).

Times partial forwards, ``num_refine_active`` = 0 .. L-1 without the
surface and then the whole forward with it, so each refinement level's
and the surface block's cost is the delta between consecutive rows. The
configuration is the JAX tool's: the full-width model at 96x192x192,
bf16, occupancy fractions (1.0, 0.5, 0.25, 0.125), seeded random weights
that leave a surface, the level-output form (the JAX tool's forward keeps
``want_level_outputs`` at its default). Each stage's ``--reps`` forwards
are traced by torch.profiler after a warm-up (``profiling.
profile_window``): ``cum_ms`` and ``delta_ms`` are device time per
forward, which the host's launch pace does not move. Beside them,
``wall_ms`` is the same forwards' CUDA-event time, paced by the host's
launches where the device idles between kernels, and ``idle_share`` the
stage's idle share; each stage's kernel launches per forward are counted
on the warm-up.

    python -m sgnn_tpu_torch.tools.bench_stages [--reps 20] [--cpu]

Prints one line per stage, then their JSON list. Runs on the card;
``--cpu`` runs the plain versions on the host (the times are then not
measured).
"""

from __future__ import annotations

import argparse
import json

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P

FRACTIONS = (1.0, 0.5, 0.25, 0.125)


def stages(num_refine_levels: int) -> list:
    """(name, num_refine_active, do_surf) of each stage, in order."""
    out = [("encoder+trunk", 0, False)]
    out += [(f"+refine{h}", h + 1, False) for h in range(num_refine_levels)]
    return out + [("+surface", num_refine_levels, True)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dims", type=int, nargs=3, default=list(C.SCENE_DIM))
    C.device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import synthetic_scene
    from sgnn_tpu_torch.ops import kernels as K

    args = parse_args(argv)
    device = C.device_of(args, "bench_stages")
    dims = tuple(args.dims)
    cfg = SGNNConfig(input_dim=dims, batch_size=1,
                     occupancy_fractions=FRACTIONS, compute_dtype="bfloat16")
    scene = synthetic_scene(dims, seed=0, truncation=cfg.truncation)
    model, _, seed = C.serving_model(cfg, scene, device)
    locs, feats = C.rows(scene, device)
    rows, prev = [], 0.0
    for name, nra, do_surf in stages(cfg.num_refine_levels):
        def fwd(nra=nra, do_surf=do_surf):
            return model(locs, feats, dims, num_refine_active=nra,
                         do_surf=do_surf, want_level_outputs=True)

        def reps():
            for _ in range(args.reps):
                fwd()
        K.reset_launch_counts()
        fwd()
        launches = {k: v for k, v in K.launch_counts().items() if v}
        ms = wall = idle = P.NOT_MEASURED  # no device time on the host
        if device.type == "cuda":
            prof = P.profile_window(reps, device, warm=fwd)
            ms = P.attribution(prof, args.reps)["device_ms"]
            wall = P.cuda_ms(fwd, device, args.reps)
            idle = P.idle_share(prof)
        timed = isinstance(ms, float)
        row = {"stage": name, "cum_ms": ms,
               "delta_ms": ms - prev if timed else ms, "wall_ms": wall,
               "idle_share": idle, "launches": launches}
        prev = ms if timed else prev
        rows.append(row)
        print(row)
    print(json.dumps(rows))
    res = {"device": P.device_entry(device), "seed": seed,
           "reps": args.reps, "stages": rows}
    if res["device"]["platform"] == "gpu":
        print(res["device"]["card"])
    return res


if __name__ == "__main__":
    main()
