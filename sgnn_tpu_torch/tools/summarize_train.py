"""Summarize a training run's log.csv / log_val.csv into a per-level
convergence table (markdown); port of the JAX package's
``tools/summarize_train.py``, byte for byte in its output.

The reference's de-facto quality validation is epochs of training with
per-epoch val IoU/L1 printed to log_val.csv (the reference's
train.py:307-319, 404-428); this condenses those CSVs, as the port's
``Trainer`` writes them, into one table.

    python -m sgnn_tpu_torch.tools.summarize_train logs/run [--every 5]
"""

import argparse
import csv
import os
import sys


def read_csv(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def read_val_csv(path, num_levels=4):
    """log_val.csv: one row per epoch in validate()'s schema
    (epoch, iter, loss, iou per level, l1-pred, l1-tgt), parsed
    positionally so header drift in old runs doesn't matter."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        next(f, None)  # header
        for line in f:
            v = line.strip().split(",")
            if len(v) < 3 + num_levels + 2:
                continue
            rows.append({
                "epoch": v[0],
                "iter": v[1],
                "val_loss(total)": v[2],
                **{f"val_iou({h})": v[3 + h] for h in range(num_levels)},
                "val_l1-pred": v[3 + num_levels],
                "val_l1-tgt": v[4 + num_levels],
            })
    return rows


def fmt(v, nd=3):
    try:
        x = float(v)
    except (TypeError, ValueError):
        return "—"
    if x == -1.0:  # inactive-level sentinel (reference loss.py:168-193)
        return "—"
    return f"{x:.{nd}f}"


def main(argv=None) -> dict:
    """Prints the table; returns its rows of cells (header excluded)."""
    p = argparse.ArgumentParser()
    p.add_argument("run_dir")
    p.add_argument("--every", type=int, default=5,
                   help="print every Nth epoch (last always printed)")
    args = p.parse_args(argv)

    val = read_val_csv(os.path.join(args.run_dir, "log_val.csv"))
    train = read_csv(os.path.join(args.run_dir, "log.csv"))
    if not val and not train:
        sys.exit(f"no logs under {args.run_dir}")

    # last train row per epoch for the fade-in state / train loss
    by_epoch = {}
    for r in train:
        by_epoch[int(r["epoch"])] = r

    print("| epoch | iter | train loss | val loss | val l1-pred | "
          "val l1-tgt | val IoU(0) | IoU(1) | IoU(2) | IoU(3) |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    rows = val if val else [by_epoch[e] for e in sorted(by_epoch)]
    table = []
    for i, r in enumerate(rows):
        ep = int(r["epoch"])
        if ep % args.every and i != len(rows) - 1:
            continue
        tr = by_epoch.get(ep, {})
        cells = [
            str(ep),
            r.get("iter", tr.get("iter", "—")),
            fmt(tr.get("train_loss(total)")),
            fmt(r.get("val_loss(total)")),
            fmt(r.get("val_l1-pred")),
            fmt(r.get("val_l1-tgt")),
            fmt(r.get("val_iou(0)")),
            fmt(r.get("val_iou(1)")),
            fmt(r.get("val_iou(2)")),
            fmt(r.get("val_iou(3)")),
        ]
        print("| " + " | ".join(cells) + " |")
        table.append(cells)
    return {"rows": table}


if __name__ == "__main__":
    main()
