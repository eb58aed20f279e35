"""Readings that a cell's correctness limits are set from: the numbers its
check compares, for the program as configured and for its control, on
many seeds in one process (one set-up of the card for all of them).

    python3 -m h100bench.calibrate --workload <cell> --seconds 3 \
        --seeds 1 2 3 ...

The control of a bf16 serving configuration is the program's own int8
path (``quantize_int8``: int8 products at the conv, down and upsample
sites), the precision below the one the configuration states; its
readings have to fail the limits the program's readings pass. Each seed
runs the cell's driver with a short window at the cell's own load, which
finishes every room of the pool. The control of a bf16 training
configuration is the reference in the program's place with its products'
inputs rounded to float8 (``train.control_numbers``); the training
faults of ``faults.py`` run through the driver (``faults.TRAIN``), the
program in f32 (``f32``) says how far the reference and the program's
own step lie apart without bf16's rounding, and the f32 reference in the
program's place with its inputs moved by one rounding (``nudged``) how
far the numbers move for that alone. Prints one JSON line per seed
and side. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from h100bench import faults
from h100bench.run import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control"],
                    choices=["program", "control", "f32", "nudged",
                             *faults.TRAIN])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    cell, config, traffic = load_cell(args.workload)
    driver = importlib.import_module("h100bench." + cell["driver"])

    training = cell["driver"] == "train"
    for seed in args.seeds:
        for side in args.sides:
            if training and side in ("control", "nudged"):
                kw = {"quant": None, "nudge": 2.0 ** -23} \
                    if side == "nudged" else {}
                numbers = driver.control_numbers(
                    config, traffic, seed, torch.device("cuda", 0), **kw)
                print(json.dumps({"seed": seed, "side": side,
                                  "numbers": numbers}), flush=True)
                continue
            conf = dict(config)
            if side == "control":
                conf["quantize_int8"] = True
            if side == "f32":
                conf["compute_dtype"] = "float32"
            fault = faults.TRAIN[side]() if side in faults.TRAIN else None
            run_args = argparse.Namespace(seed=seed, seconds=args.seconds,
                                          trace=0)
            res = driver.run(cell, conf, traffic, run_args,
                             time.perf_counter(), fault=fault)
            print(json.dumps({"seed": seed, "side": side,
                              "units": res["attempted"],
                              "numbers": res["numbers"],
                              "metrics": res["metrics"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
