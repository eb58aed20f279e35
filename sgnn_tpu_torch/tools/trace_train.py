"""Trace training steps and attribute their device time (port of the JAX
package's ``tools/trace_train.py``).

The workload is bench_train's: batch 8 of synthetic 128x64x64 chunks
(``bench_train.make_chunk``) with sparse targets, every level and the
surface active, bf16, through the port's ``Trainer.run_step`` (the
steady-state step, or with ``--with_metrics`` the metrics step). One
warm-up step in the profiler's warm-up cycle, then ``--reps`` steps
traced by torch.profiler into ``--out``; it prints what
``trace_forward`` prints for them: the device time per step by kernel
and by category, each kernel wrapper's launches per step, and the step's
idle share (1 - (union of the device's kernel and copy intervals in the
trace) / (the host-clock window of the traced steps themselves), "not
measured" when the profiler recorded no device events) and the longest
idle gaps, each named by the step's span (``sgnn::<phase>``,
``profiling.span``) that held the host.

    python -m sgnn_tpu_torch.tools.trace_train
        [--execution folded|sparse|dense_flow] [--reps 3] [--out DIR]
        [--with_metrics] [--cpu]

Runs on the card; ``--cpu`` runs the plain versions on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.tools import bench_train as BT
from sgnn_tpu_torch.utils import profiling as P


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--execution", default="folded",
                    choices=["folded", "sparse", "dense_flow"])
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--with_metrics", action="store_true",
                    help="trace the metrics step instead of the "
                         "steady-state one")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sgnn_train_trace"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--dims", type=int, nargs=3, default=[128, 64, 64],
                    help="chunk dims")
    C.device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:

    args = parse_args(argv)
    device = C.device_of(args, "trace_train")
    with tempfile.TemporaryDirectory(prefix="trace_train_") as tmp:
        # a batch for the warm-up step and each traced one
        files = BT.write_chunks(tmp, max(args.batch_size * (args.reps + 1),
                                         16), tuple(args.dims))
        trainer, loader = BT.full_level_trainer(
            files, os.path.join(tmp, "logs"), device, dims=args.dims,
            batch_size=args.batch_size, execution=args.execution,
            compute_dtype=args.compute_dtype)
        batches = []
        for batch, dev in trainer._prefetch(loader):
            batches.append((batch, dev))
            if len(batches) >= args.reps + 1:
                break
        # off the log_every boundary the loop takes the steady-state step
        it = 20 if args.with_metrics else 41
        losses = []

        def warm():  # the profiler's warm-up cycle
            trainer.iteration = it
            m, _ = trainer.run_step(batches[0][0], args.with_metrics,
                                    batches[0][1])
            losses.append(m["loss"])

        def traced():
            for batch, dev in batches[1:]:
                trainer.iteration = it
                m, _ = trainer.run_step(batch, args.with_metrics, dev)
                losses.append(m["loss"])
        reps = len(batches) - 1
        prof = P.profile_window(traced, device, args.out, warm=warm)
    launches = {k: v / reps for k, v in prof.launches.items() if v}
    what = (f"{args.execution} train step, batch {args.batch_size} "
            f"{tuple(args.dims)} {args.compute_dtype}"
            f"{' with metrics' if args.with_metrics else ''}")
    att = P.report(prof, reps, args.top, what)
    res = {"device": P.device_entry(device), "what": what, "reps": reps,
           "trace": os.path.join(args.out, "trace.json"),
           "launches": launches, "loss": float(losses[-1]),
           "peak_memory": P.device_memory_stats(), **att}
    print("wrapper launches per step: " + json.dumps(launches))
    if res["device"]["platform"] == "gpu":
        print(res["device"]["card"])
    print(f"traced {reps} steps -> {res['trace']}")
    return res


if __name__ == "__main__":
    main()
