"""The training driver: the port's training CLI path, ``Trainer.run_step``
on batches from ``Trainer._prefetch(BatchLoader(...))``, every level and
the surface active.

Set-up writes the traffic's chunks under ``TMPDIR`` (``rooms.chunk_files``),
builds one ``Trainer`` (the folded execution in the configuration's
precision, Adam at lr 1e-3), fills it with the configuration's weights
made on the card from the seed (``load_jax_params``, as a checkpoint is
loaded), and runs its first steps through the window's own loop: the first
three are the ones the reference follows (the initial parameters, the
first gradient as Adam holds it after step 1, and the parameters after
step 3 are kept on the card), the rest warm up. The window then runs steps
for ``--seconds``: the loss is fetched each step, as the training loop's
log does, and metrics are computed every ``log_every`` iterations.

After the window the reference repeats the first three steps in f32 from
the same weights on the same chunks (read back from the same files), and
the gaps in each step's loss, the first gradient's norm per leaf and the
norm of each leaf's change over the three steps are compared with the
cell's limits.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from h100bench import trace as T
from h100bench.reference import sgnn as R
from h100bench.reference import train as RT
from h100bench.rooms import chunk_files, epoch_order
from h100bench.serve import PEAK_BF16, net_of
from h100bench.weights import make_weights, to_numpy

CHECKED = 3  # the steps the reference follows
TRACE_STEPS = 4
UNITS = {"train_samples_per_s": "samples/s", "setup_s": "s"}


def make_trainer(config: dict, traffic: dict, save: str, device):
    from sgnn_tpu_torch import schedules as S
    from sgnn_tpu_torch.train.loop import TrainOptions, Trainer

    m = config["model"]
    L = m["num_hierarchy_levels"]
    opts = TrainOptions(
        input_dim=tuple(traffic["chunk"]), encoder_dim=m["encoder_dim"],
        coarse_feat_dim=m["nf_coarse"], refine_feat_dim=m["nf"],
        num_hierarchy_levels=L, truncation=m["truncation"],
        num_iters_per_level=1, batch_size=traffic["batch_size"],
        max_epoch=1000, lr=config["lr"], execution="folded",
        compute_dtype=config["compute_dtype"], log_every=traffic["log_every"],
        ckpt_every=0, save_epoch=0, save=save, device=str(device))
    trainer = Trainer(opts)
    trainer.iteration = 10 * L  # past the fade-in: every level active
    lw = S.get_loss_weights(trainer.iteration, L, 1, opts.weight_sdf_loss)
    if S.active_levels(lw) != (L - 1, True):
        raise RuntimeError(f"levels not all active: {S.active_levels(lw)}")
    return trainer


def make_loader(trainer, files: list, traffic: dict, truncation: float):
    from sgnn_tpu_torch.data.capacity import estimate_row_capacities
    from sgnn_tpu_torch.data.dataset import BatchLoader, SceneDataset

    L = trainer.cfg.num_hierarchy_levels
    B = traffic["batch_size"]
    distinct = sorted(set(files))
    target_cap, hier_caps = estimate_row_capacities(distinct, L, truncation,
                                                    B)
    ds = SceneDataset(files, truncation, L, sparse_targets=True)
    return BatchLoader(ds, B, trainer.cfg.input_cap, shuffle=False,
                       target_capacity=target_cap, hier_capacities=hier_caps)


@contextlib.contextmanager
def captured_masks(record: list):
    """While active, every folded training forward the step runs appends
    the voxels its gates kept, coarse to fine ([B, z, y, x] bool, by
    reference, nothing copied): the coarse gate's from its logit, each
    refinement level's from the next level's candidates (the children of
    the kept voxels), the finest from the surface's mask."""
    from sgnn_tpu_torch.train import step as TS

    orig = TS.genmodel_apply_folded_train

    def forward(*a, **kw):
        out, new_stats = orig(*a, **kw)
        kept = [torch.sigmoid(out.coarse_out[..., 0].detach()) > 0.5]
        kept += [m[:, ::2, ::2, ::2] for m in out.refine_masks_unfilt[1:]]
        record.append(kept + [out.surf_mask])
        return out, new_stats

    TS.genmodel_apply_folded_train = forward
    try:
        yield record
    finally:
        TS.genmodel_apply_folded_train = orig


class Steps:
    """The served path of training: the next batch from the prefetching
    loader (the time spent waiting for it kept), one step, its loss
    fetched."""

    def __init__(self, trainer, loader, log_every: int, fault=None):
        self.trainer, self.log_every = trainer, log_every
        self.gen = trainer._prefetch(loader)
        self.fault = fault
        self.wait_s = []
        self.names = []

    def step(self) -> float:
        tr = self.trainer
        with torch.profiler.record_function(T.RANGE + "loader"):
            t0 = time.perf_counter()
            batch, dev = next(self.gen)
            self.wait_s.append(time.perf_counter() - t0)
        if batch.get("input_overflow", 0) or batch.get("target_overflow", 0):
            raise RuntimeError(f"rows dropped at collate: {batch['names']}")
        self.names.append(list(batch["names"]))
        with torch.profiler.record_function(T.RANGE + "step"):
            with_metrics = tr.iteration % self.log_every == 0
            if self.fault is not None:
                batch, dev = self.fault.batch(batch, dev, tr)
            metrics, _ = tr.run_step(batch, with_metrics, dev)
            loss = float(metrics["loss"])
            if with_metrics:
                float(metrics["iou"].sum())
        return loss

    def run(self, n: int | None = None, seconds: float | None = None):
        """``n`` steps, or steps until ``seconds`` have passed: (losses of
        the steps done before the deadline, the window's seconds)."""
        losses = []
        t0 = time.perf_counter()
        t_end = t0
        while n is None or len(losses) < n:
            loss = self.step()
            t = time.perf_counter()
            if seconds is not None and t - t0 > seconds:
                break
            losses.append(loss)
            t_end = t
        return losses, t_end - t0

    def close(self):
        self.gen.close()


def _leaf_norms(ts) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in ts])


def leaf_gaps(got: list, ref: list, ref_grad_norms: torch.Tensor):
    """Per leaf, the gap between the program's norm and the reference's,
    against the larger of the reference leaf's norm and the median
    leaf's; and the leaves kept: those whose reference gradient is not
    under a thousandth of the median leaf's (nought to rounding)."""
    gn, rn = _leaf_norms(got), _leaf_norms(ref)
    keep = ref_grad_norms >= 1e-3 * ref_grad_norms.median()
    scale = torch.maximum(rn, rn[keep].median())
    return (gn - rn).abs() / scale, keep


def compare(prog: dict, ref_steps: list, initial: list,
            names: list) -> dict:
    """The check's numbers: the checked steps' largest loss gap
    (``loss_gap``), the first gradient's leaf gaps and those of each
    leaf's change over the checked steps (the median leaf's,
    ``grad_median_gap`` and ``step_median_gap``; the worst of the conv
    and linear weights, the leaves of more than one dimension,
    ``grad_weight_gap`` and ``step_weight_gap``; the worst of all,
    ``grad_gap`` and ``step_gap``), the first step's gate gaps
    (``R.gate_gaps``, where program and reference start from the same
    parameters), and under ``worst`` the leaf that each worst gap names,
    its size and the share of its elements whose sign differs between
    program and reference."""
    rg = _leaf_norms(ref_steps[0]["grads"])
    losses = [abs(p - r["loss"]) / abs(r["loss"])
              for p, r in zip(prog["losses"], ref_steps)]
    pairs = {"grad": (prog["grad1"], ref_steps[0]["grads"]),
             "step": ([a - b for a, b in zip(prog["params3"], initial)],
                      [a - b for a, b in zip(ref_steps[-1]["params"],
                                             initial)])}
    grads, keep = leaf_gaps(*pairs["grad"], rg)
    steps, _ = leaf_gaps(*pairs["step"], rg)
    weight = keep & torch.tensor([t.dim() > 1 for t in initial],
                                 device=keep.device)
    out, worst = {"loss_gap": max(losses)}, {}
    for what, gaps in (("grad", grads), ("step", steps)):
        out[what + "_median_gap"] = float(gaps[keep].median())
        for suffix, sel in (("_weight_gap", weight), ("_gap", keep)):
            g = torch.where(sel, gaps, torch.zeros_like(gaps))
            out[what + suffix] = float(g.max())
            i = int(g.argmax())
            a, b = (t[i] for t in pairs[what])
            worst[what + suffix] = [names[i], a.numel(), float(
                (torch.sign(a) != torch.sign(b)).float().mean())]
    return {**out, **ref_steps[0]["gates"], "worst": worst}


def check(net, P, S, chunks: list, names: list, prog: dict, initial: list,
          masks: list, lr: float, device):
    """The reference's first steps in f32 on the checked batches (read back
    from the chunk files), following the gates the program kept; returns
    the numbers (``compare``) and the batches."""
    by_name = {os.path.splitext(os.path.basename(p))[0]: p for p in chunks}
    batches = [RT.batch_tensors([RT.read_chunk(by_name[n], net.truncation)
                                 for n in step], device) for step in names]
    ref_steps = RT.train_steps(net, P, S, batches, lr=lr, masks=masks)
    names = [k for k, _ in R.leaves(P)]
    return compare(prog, ref_steps, initial, names), batches


def control_numbers(config: dict, traffic: dict, seed: int, device,
                    quant=RT.fp8, nudge: float = 0.0) -> dict:
    """The numbers the check gives for the control: the reference in the
    program's place with every product's inputs rounded to float8 e4m3
    (the precision below the configuration's bf16), on the batches the
    program's first steps would take. With ``quant=None`` and ``nudge``,
    the reference in f32 in the program's place, with every input
    feature moved by the share ``nudge`` up or down (at random): how far
    the numbers move when the inputs move by a rounding."""
    net = net_of(config)
    P, S = make_weights(net, config["weights_seed"], seed,
                        config["weights_jitter"], device)
    work_dir = tempfile.mkdtemp(prefix="h100bench-chunks-")
    try:
        chunks = chunk_files(traffic, device, net.truncation, work_dir)
        files = epoch_order(chunks, traffic["passes"], seed)
        B = traffic["batch_size"]
        names = [[os.path.splitext(os.path.basename(f))[0]
                  for f in files[i * B:(i + 1) * B]] for i in range(CHECKED)]
        by_name = {os.path.splitext(os.path.basename(p))[0]: p
                   for p in chunks}
        batches = [RT.batch_tensors([RT.read_chunk(by_name[n],
                                                   net.truncation)
                                     for n in step], device)
                   for step in names]
        if nudge:
            g = torch.Generator(device=device).manual_seed(seed % (1 << 62))
            for b in batches:
                sign = torch.randint(0, 2, b["feats"].shape, generator=g,
                                     device=device) * 2 - 1
                b["feats"] = b["feats"] * (1 + nudge * sign)
        ctrl = RT.train_steps(net, P, S, batches, lr=config["lr"],
                              quant=quant)
        prog = {"losses": [c["loss"] for c in ctrl],
                "grad1": ctrl[0]["grads"], "params3": ctrl[-1]["params"]}
        initial = [v.detach().clone() for _, v in R.leaves(P)]
        numbers, _ = check(net, P, S, chunks, names, prog, initial,
                           [c["kept"] for c in ctrl], config["lr"], device)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    return numbers


def run(cell: dict, config: dict, traffic: dict, args, t0: float,
        device=None, fault=None) -> dict:
    """One run of a training cell; ``fault``, where given (the benchmark's
    tests and calibration), breaks the step underneath."""
    device = torch.device("cuda", 0) if device is None else device
    cuda = device.type == "cuda"
    net = net_of(config)
    P, S = make_weights(net, config["weights_seed"], args.seed,
                        config["weights_jitter"], device)
    work_dir = tempfile.mkdtemp(prefix="h100bench-chunks-")
    try:
        chunks = chunk_files(traffic, device, net.truncation, work_dir)
        files = epoch_order(chunks, traffic["passes"], args.seed)
        trainer = make_trainer(config, traffic, os.path.join(work_dir, "log"),
                               device)
        from sgnn_tpu_torch.params import load_jax_params

        load_jax_params(trainer.model, to_numpy(P), to_numpy(S))
        if fault is not None:
            fault.install(trainer)
        loader = make_loader(trainer, files, traffic, net.truncation)
        steps = Steps(trainer, loader, traffic["log_every"], fault)
        initial = [w.detach().clone() for w in trainer.model.weights]
        with captured_masks([]) as masks:
            prog = {"losses": [steps.step()]}
            prog["grad1"] = [trainer.opt.state[w]["exp_avg"].detach()
                             .clone() / 0.1 if w in trainer.opt.state
                             else torch.zeros_like(w)
                             for w in trainer.model.weights]
            prog["losses"] += steps.run(n=CHECKED - 1)[0]
        prog["params3"] = [w.detach().clone() for w in trainer.model.weights]
        steps.run(n=traffic["warmup_steps"] - CHECKED)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        wait_before = len(steps.wait_s)

        losses, window_s = steps.run(seconds=args.seconds)
        peak = 0
        if cuda:
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        if not losses:
            raise RuntimeError("no step was completed inside the window")
        B = traffic["batch_size"]
        ctx = {"window": {"units": len(losses), "seconds": window_s,
                          "wait_s": steps.wait_s[wait_before:
                                                 wait_before + len(losses)]},
               "peak_flops": PEAK_BF16}
        if args.trace:
            with T.traced(device, warm=lambda: steps.run(n=1)) as got:
                steps.run(n=TRACE_STEPS)
            ctx["trace"] = T.reduce(got)
            ctx["trace"]["units"] = TRACE_STEPS
        checked_names = steps.names[:CHECKED]
        steps.close()
        del trainer, steps, loader
        if cuda:
            torch.cuda.empty_cache()
        numbers, batches = check(net, P, S, chunks, checked_names, prog,
                                 initial, masks, config["lr"], device)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    ops = []
    for b in batches:
        work = R.Work()
        with torch.no_grad(), R.precise():
            R.Forward(net, P, S, work, training=True)(
                b["locs"], b["feats"], b["dims"], b["batch"])
        ops.append(3 * work.ops())  # forward, input and weight gradients
    ctx["window"]["ops"] = float(np.mean(ops)) * len(losses)
    limits = cell["limits"]
    failed = int(any(numbers[n] > v for n, v in limits.items()))
    return {"units": UNITS, "window_s": window_s, "memory_peak_bytes": peak,
            "metrics": {"train_samples_per_s": len(losses) * B / window_s,
                        "setup_s": setup_s},
            "ctx": ctx, "attempted": len(losses), "failed": failed,
            "numbers": numbers, "checks": {n: {"value": numbers[n], "limit": v}
                       for n, v in limits.items()}}
