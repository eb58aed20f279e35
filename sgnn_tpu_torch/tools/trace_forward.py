"""Trace the serving forward and attribute its device time (port of the
JAX package's ``tools/trace_forward.py``).

The workload is bench.py's: the folded forward of the full-width model
(L=4, encoder_dim 8, nf 16) on the 96x192x192 sphere scene
(``infer.synthetic_scene``, the ``__graft_entry__`` scene), bf16,
occupancy fractions (1.0, 0.4, 0.2, 0.1), seeded random weights that
leave a surface, in its only-surface form (``--full_outputs``: the
level-output form). One warm-up forward, then ``--reps`` forwards traced
by torch.profiler into ``--out`` (a Chrome trace); it prints the device
time per forward by kernel and by category (each hand-written kernel by
its CUDA name, cuDNN convs, GEMMs, elementwise and reduce, copies and
memsets), each kernel wrapper's launches per forward, and the forward's
idle share: 1 - (union of the device's kernel and copy intervals in the
trace) / (the host-clock window of the traced forwards themselves), and
the longest idle gaps, each named by the program's span (``sgnn::<name>``,
``profiling.span``) open on the host at its start. A
profiler session that misses device events is tried again
(``profiling.profile_window``); when none of its sessions recorded any,
the device numbers print as "not measured".

    python -m sgnn_tpu_torch.tools.trace_forward [--int8] [--full_outputs]
        [--reps 3] [--out DIR] [--top 40] [--dims Z Y X] [--cpu]

Runs on the card; ``--cpu`` runs the plain versions on the host (no device
number is measured there).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sgnn_trace"))
    ap.add_argument("--full_outputs", action="store_true",
                    help="materialize per-level outputs too")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--dims", type=int, nargs=3, default=list(C.SCENE_DIM))
    C.device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import synthetic_scene

    args = parse_args(argv)
    device = C.device_of(args, "trace_forward")
    dims = tuple(args.dims)
    cfg = SGNNConfig(input_dim=dims, batch_size=1,
                     occupancy_fractions=C.FRACTIONS,
                     compute_dtype="bfloat16", quantize_int8=args.int8)
    scene = synthetic_scene(dims, seed=0, truncation=cfg.truncation)
    model, _, seed = C.serving_model(cfg, scene, device)
    locs, feats = C.rows(scene, device)
    acc = []

    def fwd():
        out = model(locs, feats, dims, want_level_outputs=args.full_outputs)
        acc.append(torch.where(out.surf_mask, out.surf_sdf, 0.0).sum()
                   + out.coarse_out.mean())

    fwd()  # warm-up outside the trace

    def traced():
        for _ in range(args.reps):
            fwd()
    prof = P.profile_window(traced, device, args.out, warm=fwd)
    launches = {k: v / args.reps for k, v in prof.launches.items() if v}
    what = (f"{'int8 ' if args.int8 else ''}forward {dims}"
            f"{' with level outputs' if args.full_outputs else ''}")
    att = P.report(prof, args.reps, args.top, what)
    res = {"device": P.device_entry(device), "what": what, "seed": seed,
           "reps": args.reps, "trace": os.path.join(args.out, "trace.json"),
           "launches": launches, "acc": float(sum(acc[-args.reps:])), **att}
    print("wrapper launches per forward: " + json.dumps(launches))
    if res["device"]["platform"] == "gpu":
        print(res["device"]["card"])
    print(f"traced {args.reps} forwards -> {res['trace']}")
    return res


if __name__ == "__main__":
    main()
