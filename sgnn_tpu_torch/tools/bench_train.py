"""Training-throughput benchmark on synthetic chunks (port of the JAX
package's ``tools/bench_train.py``).

Measures whole optimization steps (forward, backward, Adam, the metrics
cadence) at the reference's training configuration (batch 8, chunks
128x64x64 at 2 cm, L=4; the reference's train.py:40-64) through the
port's ``Trainer``: the chunk files, ``SceneDataset``, ``BatchLoader``
with its worker threads and the trainer's device prefetch, so a loader or
pipeline change shows here, not only a kernel's. Every level and the
surface are active from the first step; targets travel as sparse rows
(``--dense_transfer``: the dense target, known and hierarchy grids,
``SceneDataset(sparse_targets=False)``) in ``--transfer_dtype`` (f32 by
default), and the metrics step comes every ``--log_every`` iterations
(20, the trainer's default). Each step is timed on the host clock from
the previous step's end to its own, each end a fetch of the loss (a
synchronize), so a step after an epoch's end holds the loader's restart;
``step_ms`` is their median and ``chunks_per_sec`` all timed chunks over
all timed seconds. ``--window N`` > 1 is the JAX tool's windowed mode,
the production sync cadence: one fetch every N steps (and after the
last), each window's seconds over its steps, windows shorter than N/2
dropped, the first from the first fetch on, the clock running on across
an epoch's end (the sustained rate holds the loader's restarts); ``step_ms`` is then the median window's
per-step time and ``steps`` the windows kept.

    python -m sgnn_tpu_torch.tools.bench_train [--steps 30]
        [--batch_size 8] [--execution folded|sparse|dense_flow]
        [--window N] [--log_every 20] [--transfer_dtype float32]
        [--dense_transfer] [--no_fuse_train_bn] [--cpu]

Prints one JSON line {"step_ms": ..., "chunks_per_sec": ..., ...}. Runs on
the card; ``--cpu`` runs the plain versions on the host. The default
execution is the port's training CLI's (folded); the JAX tool's is the
dense flow.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P

NUM_LEVELS = 4


def make_chunk(rng, dims=(128, 64, 64), vs=0.02, n_surface=8000):
    """A synthetic training chunk: ``n_surface`` random input voxels with
    their target values, a random known grid and ~8% occupied voxels per
    hierarchy level (real scan chunks' sparsity: a 12-voxel band around
    room surfaces), the JAX tool's generator draw for draw."""
    from sgnn_tpu_torch.data import formats as F

    Z, Y, X = dims
    flat = rng.choice(Z * Y * X, size=n_surface, replace=False)
    z, rem = flat // (Y * X), flat % (Y * X)
    y, x = rem // X, rem % X
    in_locs = np.stack([z, y, x], -1).astype(np.int32)
    in_sdf = rng.randn(n_surface).astype(np.float32)
    target = np.full(dims, -np.inf, np.float32)
    target[z, y, x] = in_sdf
    known = (rng.rand(*dims) * 3).astype(np.uint8)
    hier = []
    for f in (8, 4, 2):
        hd = (Z // f, Y // f, X // f)
        g = np.full(hd, -np.inf, np.float32)
        m = rng.rand(*hd) > 0.92
        g[m] = rng.randn(int(m.sum())).astype(np.float32)
        hier.append(g)
    return F.TrainChunk(in_locs, in_sdf, target, dims, vs,
                        np.eye(4, dtype=np.float32), known, hier)


def write_chunks(root: str, n: int, dims: tuple, seed: int = 0) -> list:
    """``n`` make_chunk chunks of ``dims`` as .sdfs files under ``root``;
    chunks smaller than 128x64x64 keep its 8000 input voxels' density."""
    from sgnn_tpu_torch.data import formats as F

    rng = np.random.RandomState(seed)
    n_surface = min(8000, int(np.prod(dims)) // 64)
    files = []
    for i in range(n):
        p = os.path.join(root, f"c{i}.sdfs")
        F.save_train_file(p, make_chunk(rng, dims, n_surface=n_surface))
        files.append(p)
    return files


def full_level_trainer(files: list, save: str, device, *, dims,
                       batch_size: int, execution: str, compute_dtype: str,
                       fuse_train_bn: bool = True,
                       transfer_dtype: str = "float32", log_every: int = 20,
                       sparse_targets: bool = True):
    """(Trainer with every level and the surface active, its BatchLoader
    over ``files``): the JAX tools' training configuration (L=4, full
    width, lr 1e-3, no checkpoints or prediction dumps); the targets as
    sparse rows or, without ``sparse_targets``, dense grids."""
    from sgnn_tpu_torch import schedules as S
    from sgnn_tpu_torch.data.capacity import estimate_row_capacities
    from sgnn_tpu_torch.data.dataset import BatchLoader, SceneDataset
    from sgnn_tpu_torch.train.loop import TrainOptions, Trainer

    opts = TrainOptions(
        input_dim=tuple(dims), num_hierarchy_levels=NUM_LEVELS,
        num_iters_per_level=1, batch_size=batch_size, max_epoch=1000,
        lr=1e-3, execution=execution, compute_dtype=compute_dtype,
        transfer_dtype=transfer_dtype, log_every=log_every,
        fuse_train_bn=fuse_train_bn, ckpt_every=0, save_epoch=0, save=save,
        device=str(device))
    trainer = Trainer(opts)
    trainer.iteration = 10 * NUM_LEVELS  # past the fade-in: all active
    lw = S.get_loss_weights(trainer.iteration, NUM_LEVELS, 1,
                            opts.weight_sdf_loss)
    if S.active_levels(lw) != (NUM_LEVELS - 1, True):
        raise RuntimeError(f"levels not all active: {S.active_levels(lw)}")
    ds = SceneDataset(files, 3.0, NUM_LEVELS, sparse_targets=sparse_targets)
    target_cap, hier_caps = (estimate_row_capacities(
        files, NUM_LEVELS, 3.0, batch_size) if sparse_targets else (0, None))
    loader = BatchLoader(ds, batch_size, trainer.cfg.input_cap,
                         shuffle=True, seed=0, target_capacity=target_cap,
                         hier_capacities=hier_caps)
    return trainer, loader


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_chunks", type=int, default=64)
    ap.add_argument("--execution", default="folded",
                    choices=["folded", "sparse", "dense_flow"])
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--transfer_dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--window", type=int, default=1,
                    help=">1: time windows of N steps with one completion "
                         "fetch per window (the production sync cadence) "
                         "instead of fetching every step")
    ap.add_argument("--dense_transfer", action="store_true",
                    help="ship dense target grids instead of sparse rows")
    ap.add_argument("--no_fuse_train_bn", action="store_true",
                    help="folded: the composed BN -> op ablation (the "
                         "training CLI's --fuse_train_bn 0)")
    ap.add_argument("--dims", type=int, nargs=3, default=[128, 64, 64],
                    help="chunk dims")
    C.device_arg(ap)
    return ap.parse_args(argv)


def _timed_steps(args, device, tmp: str) -> tuple:
    """(the timed samples, the last step's metrics, the targets' layout)
    of ``--warmup`` + ``--steps`` steps on chunks written under ``tmp``:
    [(seconds, steps)] of each step after the warm-up, or with
    ``--window`` of each window kept."""
    files = write_chunks(tmp, args.num_chunks, tuple(args.dims))
    trainer, loader = full_level_trainer(
        files, os.path.join(tmp, "logs"), device, dims=args.dims,
        batch_size=args.batch_size, execution=args.execution,
        compute_dtype=args.compute_dtype,
        fuse_train_bn=not args.no_fuse_train_bn,
        transfer_dtype=args.transfer_dtype, log_every=args.log_every,
        sparse_targets=not args.dense_transfer)
    samples, metrics, layout = [], None, None
    total = args.steps + args.warmup
    done, t_win = 0, None
    t_prev = (time.perf_counter(), 0)
    while done < total:
        before = done
        for batch, dev in trainer._prefetch(loader):
            layout = "dense grids" if "sdf" in batch else "sparse rows"
            with_metrics = (args.log_every > 0
                            and trainer.iteration % args.log_every == 0)
            metrics, _ = trainer.run_step(batch, with_metrics, dev)
            done += 1
            if args.window <= 1:
                float(metrics["loss"])
                t = time.perf_counter()
                if done > args.warmup:
                    samples.append((t - t_prev[0], 1))
                t_prev = (t, done)
            elif done % args.window == 0 or done >= total:
                float(metrics["loss"])
                t = time.perf_counter()
                # from the first fetch on, windows ending after the
                # warm-up; a short last window amortizes its fetch over
                # too few steps
                if t_win is not None and done > args.warmup:
                    n = done - t_win[1]
                    if n >= max(1, args.window // 2):
                        samples.append((t - t_win[0], n))
                t_win = (t, done)
            if done >= total:
                break
        if done == before:
            raise SystemExit("bench_train: an epoch gave no batch; raise "
                             "--num_chunks")
    return samples, metrics, layout


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = C.device_of(args, "bench_train")
    with tempfile.TemporaryDirectory(prefix="bench_train_") as tmp:
        samples, metrics, layout = _timed_steps(args, device, tmp)
    if not samples:
        raise SystemExit("bench_train: no step was timed; raise --steps")
    secs, steps = np.array(samples).T
    steady = secs / steps  # seconds per step of each sample
    res = {
        "step_ms": float(np.median(steady) * 1e3),
        "chunks_per_sec": args.batch_size * steps.sum() / secs.sum(),
        "mean_step_ms": float(steady.mean() * 1e3),
        "p90_step_ms": float(np.percentile(steady, 90) * 1e3),
        "steps": len(steady),
        "loss": float(metrics["loss"]),
        "times_ms": [float(t * 1e3) for t in steady],
        "window": args.window,
        "execution": args.execution,
        "fuse_train_bn": not args.no_fuse_train_bn,
        "transfer_dtype": args.transfer_dtype,
        "log_every": args.log_every,
        "targets": layout,
        "peak_memory": P.device_memory_stats(),
        "device": P.device_entry(device),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
