"""The benchmark of the PyTorch and CUDA port of SG-NN on one H100.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name in files of its own:
``cells/<cell>.json`` (its configuration, traffic, driver, metrics and
correctness limits), ``configs/<config>.json`` (the model's sizes and
precision), ``traffic/<traffic>.json`` (the parameters the generator of
``rooms.py`` reads) and ``metrics/<metric>.py`` (one reader per per-layer
metric, ``read(ctx)`` -> a number, or None where it finds nothing to
read; ``metrics/<stem>.py`` serves every ``<stem>.<cell>`` that has no
file of its own). The driver module (``serve.py``, ``train.py``) sets
up, warms up, measures for ``--seconds`` and checks the outputs against
the plain reference.

With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the traced
stretch's busy and window seconds and a breakdown; ``checks``, the
numbers compared with their limits, comes last, and the same numbers are
the last lines on standard error. A run without a CUDA card, or whose
process holds JAX or the JAX package once the window has closed, exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "sgnn_tpu")


def load_json(kind: str, name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, kind, name + ".json")) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = HERE) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a cell, by name."""
    cell = load_json("cells", name, root)
    return (cell, load_json("configs", cell["config"], root),
            load_json("traffic", cell["traffic"], root))


def load_reader(name: str, root: str = HERE):
    """The reader module of a per-layer metric, by name:
    ``metrics/<name>.py``, or where there is none, the reader of the
    quantity, ``metrics/<stem>.py`` (the name up to its first dot), so
    that ``enqueue_ms.<cell>`` needs no file of its own."""
    path = os.path.join(root, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(root, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def result_line(res: dict, cell: dict, trace: bool, device: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, device, with a
    trace the breakdown, and the checks last."""
    if trace:
        metrics = {}
        for name in cell["per_layer"]:
            reader = load_reader(name)
            value = reader.read(res["ctx"])
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    else:
        metrics = {name: {"value": res["metrics"][name],
                          "unit": res["units"][name]}
                   for name in cell["end_to_end"]}
    checks = res["checks"]
    line = {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()) and not res["failed"],
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dict(device)}
    t = res["ctx"].get("trace")
    if trace and t:
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": [list(x) for x in
                                            t["device_ops"]],
                             "idle_gaps": [list(x) for x in t["idle_gaps"]]}
    line["checks"] = checks
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell, config, traffic = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"h100bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found none or fewer", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    driver = importlib.import_module("h100bench." + cell["driver"])
    res = driver.run(cell, config, traffic, args, T0)
    bad = forbidden_modules()
    if bad:
        print(f"h100bench: the process holds {bad}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result_line(res, cell, bool(args.trace), device)
    print(f"h100bench: peak device memory {res['memory_peak_bytes']} bytes",
          flush=True)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
