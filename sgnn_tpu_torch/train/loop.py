"""Training orchestration: epochs, schedules, logs, checkpoints, on one
device or data-parallel over ranks (port of ``sgnn_tpu/train/loop.py``
``Trainer``, :97-533; the reference's train.py:233-453).

Adam with the StepLR halving, the progressive level fade-in, IoU/L1
metrics every ``log_every`` iterations, ``log.csv`` / ``log_val.csv`` with
the JAX trainer's headers, a ``.ckpt`` every ``ckpt_every`` iterations and
after every epoch (with the Adam state, readable by either package), and
``retrain`` from a ``.ckpt`` of either package (``"auto"``: the newest in
the run directory), and the per-epoch prediction dump
(``visualize_batch``). Batches go to the device through pinned memory,
one batch ahead of the step.

Data parallelism (``num_devices`` > 1, in a rank of ``parallel.mesh.
launch`` with its ``Groups``): every rank builds the same global batch
(one seeded loader) and steps on its own slice (``parallel.mesh.
device_batch``, as the JAX trainer assigns samples and capacities, :100-
116), with the per-rank config's batch ``batch_size // num_devices``; the
step averages over the data group, so the ranks hold the same parameters.
Rank 0 alone writes the logs, checkpoints and predictions and prints.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from sgnn_tpu_torch import checkpoint as CK
from sgnn_tpu_torch import schedules as S
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.params import export_params, load_jax_params
from sgnn_tpu_torch.train import state as ST
from sgnn_tpu_torch.train import step as TS
from sgnn_tpu_torch.utils import profiling as P

_END = object()  # the end of a loader's batches, in _prefetch


@dataclasses.dataclass
class TrainOptions:
    """The CLI's options (names follow the reference's train.py:21-58)."""
    save: str = "./logs"
    retrain: str = ""
    input_dim: tuple = (128, 64, 64)
    encoder_dim: int = 8
    coarse_feat_dim: int = 16
    refine_feat_dim: int = 16
    no_pass_occ: bool = False
    no_pass_feats: bool = False
    use_skip_sparse: int = 1
    use_skip_dense: int = 1
    logweight_target_sdf: bool = True
    num_hierarchy_levels: int = 4
    num_iters_per_level: int = 2000
    truncation: float = 3.0
    batch_size: int = 8
    start_epoch: int = 0
    max_epoch: int = 5
    lr: float = 1e-3
    decay_lr: int = 10
    weight_decay: float = 0.0
    weight_sdf_loss: float = 1.0
    weight_missing_geo: float = 5.0
    use_loss_masking: bool = True
    seed: int = 0
    input_capacity: int = 0
    occupancy_fractions: tuple = (1.0, 0.5, 0.25, 0.125)
    compute_dtype: str = "float32"
    # the dtype float batch arrays are shipped to the device in
    transfer_dtype: str = "float32"
    # 0 = LR steps per epoch (StepLR); > 0 = halve every N iterations
    scheduler_step_size: int = 0
    max_steps: int = 0  # 0 = unlimited
    log_every: int = 20
    ckpt_every: int = 2000
    save_epoch: int = 1  # prediction dump every N epochs (0 = never)
    execution: str = "folded"
    # folded execution: the fused BN -> op training sites (False: the
    # composed BN -> op ablation, as the JAX trainer's flag)
    fuse_train_bn: bool = True
    device: str = "cuda"
    num_devices: int = 1  # > 1: data parallelism over the ranks


class Trainer:
    def __init__(self, opts: TrainOptions, groups=None):
        """``groups``: this rank's ``parallel.mesh.Groups`` under data
        parallelism (``opts.num_devices`` ranks; its device is used)."""
        self.opts = opts
        n = max(1, opts.num_devices)
        if n > 1 and (groups is None or groups.num_data != n):
            raise ValueError(f"num_devices {n} needs the Groups of a "
                             f"{n}-rank data group")
        if opts.batch_size % n:
            raise ValueError(f"batch {opts.batch_size} not divisible by "
                             f"{n} devices")
        self.groups = groups if n > 1 else None
        self.group = self.groups.data if self.groups else None
        self.lead = self.groups is None or self.groups.rank == 0
        self.device = (self.groups.device if self.groups
                       else torch.device(opts.device))
        self.cfg = SGNNConfig(
            encoder_dim=opts.encoder_dim,
            input_dim=tuple(opts.input_dim),
            input_nf=1,
            nf_coarse=opts.coarse_feat_dim,
            nf=opts.refine_feat_dim,
            num_hierarchy_levels=opts.num_hierarchy_levels,
            pass_occ=not opts.no_pass_occ,
            pass_feats=not opts.no_pass_feats,
            use_skip_sparse=bool(opts.use_skip_sparse),
            use_skip_dense=bool(opts.use_skip_dense),
            truncation=opts.truncation,
            batch_size=opts.batch_size // n,
            input_capacity=opts.input_capacity,
            occupancy_fractions=tuple(opts.occupancy_fractions),
            execution=opts.execution,
            compute_dtype=opts.compute_dtype,
            fuse_train_bn=opts.fuse_train_bn,
        )
        self.model = TS.train_model(self.cfg, seed=opts.seed).to(self.device)
        self.opt = ST.make_optimizer(self.model, opts.lr, opts.weight_decay)
        self.transfer_dtype = getattr(torch, opts.transfer_dtype)
        self.start_epoch = opts.start_epoch
        self.iteration = 0
        self.epoch = 0
        self.loss_history = []  # (iteration, total loss) of every step
        retrain = opts.retrain
        if retrain == "auto":
            retrain = latest_checkpoint(opts.save) or ""
        if retrain:
            meta = self.load_ckpt(retrain)
            self.start_epoch = (opts.start_epoch if opts.start_epoch != 0
                                else meta["epoch"])
            self.iteration = meta.get("iteration", 0)
            self.say(f"loaded checkpoint {retrain} (epoch "
                     f"{self.start_epoch})")

    def say(self, *a) -> None:
        """print, on rank 0 only."""
        if self.lead:
            print(*a, flush=True)

    # ------------------------------------------------------- checkpoint IO
    def load_ckpt(self, path) -> dict:
        ck = CK.load_checkpoint(path, self.cfg)
        load_jax_params(self.model, ck.params, ck.stats)
        ST.load_adam_state(self.opt, self.model, ck.mu, ck.nu, ck.count)
        return ck.meta

    def save_ckpt(self, path, epoch: int) -> None:
        params, stats = export_params(self.model)
        mu, nu, count = ST.adam_state(self.opt, self.model)
        CK.save_checkpoint(path, params, stats, epoch=epoch,
                           iteration=self.iteration, step=self.iteration,
                           mu=mu, nu=nu, count=count,
                           weight_decay=self.opts.weight_decay)

    # ------------------------------------------------------------ training
    def _schedule(self):
        """(loss weights, (num_refine_active, do_surf), lr) at this
        iteration."""
        o = self.opts
        lw = S.get_loss_weights(self.iteration, o.num_hierarchy_levels,
                                o.num_iters_per_level, o.weight_sdf_loss)
        if o.scheduler_step_size > 0:
            lr = S.step_lr(o.lr, self.iteration, o.scheduler_step_size)
        else:
            lr = S.step_lr(o.lr, self.epoch, o.decay_lr)
        return lw, S.active_levels(lw), lr

    def _prefetch(self, loader):
        """Yield (host batch, device batch), the next batch's copy enqueued
        before the current one is handed out (under data parallelism this
        rank's slice, through ``parallel.mesh.prefetch_to_device``). On
        one device the wait for the loader's next batch is the span
        ``batch_wait`` and its copy's enqueue ``to_device``
        (``profiling.span``)."""
        if self.groups is not None:
            from sgnn_tpu_torch.parallel import mesh as PM

            n = self.groups.num_data
            yield from PM.prefetch_to_device(
                ((b, PM.device_batch(b, n)) for b in loader),
                self.groups.data_index, self.device,
                transfer_dtype=self.transfer_dtype)
            return
        pending, batches = None, iter(loader)
        while True:
            with P.span("batch_wait"):
                b = next(batches, _END)
            if b is _END:
                break
            with P.span("to_device"):
                nxt = (b, TS.to_device(b, self.device, self.transfer_dtype))
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def run_step(self, batch: dict, with_metrics: bool = False,
                 dev_batch: dict | None = None):
        """One optimization step on a collated batch."""
        o = self.opts
        lw, (n_active, do_surf), lr = self._schedule()
        if dev_batch is None and self.groups is not None:
            from sgnn_tpu_torch.parallel import mesh as PM

            dev_batch = PM.put_device_batch(
                PM.device_batch(batch, self.groups.num_data),
                self.groups.data_index, self.device, self.transfer_dtype)
        elif dev_batch is None:
            dev_batch = TS.to_device(batch, self.device, self.transfer_dtype)
        metrics = TS.train_step(
            self.model, self.opt, dev_batch, lw, lr,
            num_refine_active=n_active, do_surf=do_surf,
            use_log_transform=o.logweight_target_sdf,
            weight_missing_geo=o.weight_missing_geo,
            use_loss_masking=o.use_loss_masking, with_metrics=with_metrics,
            group=self.group)
        self.iteration += 1
        return metrics, lw

    def fit(self, train_loader, val_loader=None, log_dir=None):
        o = self.opts
        log_dir = log_dir or o.save
        os.makedirs(log_dir, exist_ok=True)
        L = o.num_hierarchy_levels
        headers = ["epoch", "iter", "train_loss(total)"]
        headers += [f"train_loss({h})" for h in range(L)]
        headers += ["train_loss(sdf)", "train_l1-pred", "train_l1-tgt"]
        headers += [f"train_iou({h})" for h in range(L)] + ["time"]
        resume = self.iteration > 0 or self.start_epoch > 0
        log_f = (_open_log(os.path.join(log_dir, "log.csv"), headers, resume)
                 if self.lead else open(os.devnull, "w"))
        val_f = None
        if val_loader is not None and self.lead:
            vh = ["epoch", "iter", "val_loss(total)"]
            vh += [f"val_iou({h})" for h in range(L)]
            vh += ["val_l1-pred", "val_l1-tgt"]
            val_f = _open_log(os.path.join(log_dir, "log_val.csv"), vh,
                              resume)
        done = False
        for epoch in range(self.start_epoch, o.max_epoch):
            self.epoch = epoch
            start = time.time()
            accum = _MetricAccum(L)
            vis_batch, num_batches = None, len(train_loader)
            for t, (batch, dev) in enumerate(self._prefetch(train_loader)):
                if (o.save_epoch and epoch % o.save_epoch == 0
                        and t + 2 == num_batches):
                    vis_batch = batch  # the reference's train.py:270
                with_metrics = (o.log_every > 0
                                and self.iteration % o.log_every == 0)
                metrics, lw = self.run_step(batch, with_metrics, dev)
                if batch.get("target_overflow", 0) > 0:
                    self.say(f"[capacity] WARNING iter {self.iteration}: "
                          f"{batch['target_overflow']} target/hierarchy rows "
                          f"dropped at collate (raise the capacities)")
                if metrics["overflow"] > 0:
                    self.say(f"[capacity] WARNING iter {self.iteration}: "
                          f"{metrics['overflow']} voxels overflowed a level "
                          f"capacity (raise occupancy_fractions or use "
                          f"--autotune_capacity)")
                accum.add(metrics, with_metrics)
                self.loss_history.append((self.iteration,
                                          accum.losses[0][-1]))
                if o.log_every > 0 and self.iteration % o.log_every == 0:
                    took = time.time() - start
                    row = accum.row(epoch, self.iteration, took)
                    log_f.write(",".join(str(v) for v in row) + "\n")
                    log_f.flush()
                    self.say(f"epoch {epoch} iter {self.iteration} loss "
                             f"{accum.losses[0][-1]:.6f} lw "
                             f"{np.array2string(lw, precision=2)} "
                             f"({took:.1f}s)")
                if (o.ckpt_every and self.iteration % o.ckpt_every == 0
                        and self.lead):
                    self.save_ckpt(os.path.join(
                        log_dir,
                        f"model-iter{self.iteration}-epoch{epoch}.ckpt"),
                        epoch)
                if o.max_steps and self.iteration >= o.max_steps:
                    done = True
                    break
            lw = S.get_loss_weights(self.iteration, L, o.num_iters_per_level,
                                    o.weight_sdf_loss)
            if (vis_batch is not None and self.lead
                    and S.active_levels(lw) == (L - 1, True)):
                self.visualize_batch(vis_batch, os.path.join(
                    log_dir, f"iter{self.iteration}-epoch{epoch}", "train"))
            if val_loader is not None and not done:
                self.validate(val_loader, val_f, epoch)
            if self.lead:
                self.save_ckpt(os.path.join(log_dir,
                                            f"model-epoch-{epoch}.ckpt"),
                               epoch + 1)
            if done:
                break
        log_f.close()
        if val_f:
            val_f.close()

    @torch.no_grad()
    def visualize_batch(self, batch: dict, out_dir: str) -> None:
        """The first ``cfg.batch_size`` samples of a collated host batch
        through the execution's eval forward (every level and the surface;
        BN on its running stats): per sample the input, predicted and
        target meshes and each level's predicted occupancy as a point cloud
        (meshing/export.save_predictions; the JAX trainer's
        visualize_batch, train/loop.py:192-317). Runs the kernels on the
        card and raises on a failure."""
        from sgnn_tpu_torch.meshing.export import save_predictions
        from sgnn_tpu_torch.ops.sparse import make_sparse

        cfg, trunc = self.cfg, self.opts.truncation
        B, dims = cfg.batch_size, cfg.input_dim
        if "sdf" in batch:
            sdf = batch["sdf"]
        else:  # sparse-target rows: the dense target on the host
            tn = int(batch["target_num_valid"])
            tl, tv = batch["target_locs"][:tn], batch["target_vals"][:tn]
            Bf = int(batch["known_unk"].shape[0])
            sdf = np.full((Bf,) + tuple(dims), -np.inf, np.float32)
            pos = np.unpackbits(batch["target_pos"].reshape(Bf, -1), axis=1,
                                bitorder="little")[:, :int(np.prod(dims))]
            sdf[pos.reshape(sdf.shape) > 0] = trunc
            sdf[tl[:, 3], tl[:, 0], tl[:, 1], tl[:, 2]] = tv
        n = int(batch["input_num_valid"])
        keep = batch["input_locs"][:n, 3] < B
        k = min(int(keep.sum()), cfg.input_cap)
        locs = np.full((cfg.input_cap, 4), -1, np.int32)
        feats = np.zeros((cfg.input_cap, 1), np.float32)
        locs[:k] = batch["input_locs"][:n][keep][:k]
        feats[:k] = batch["input_sdf"][:n][keep][:k]
        tl, tf = (torch.from_numpy(a).to(self.device) for a in (locs, feats))
        kw = dict(num_refine_active=cfg.num_refine_levels, do_surf=True,
                  training=False)
        if cfg.execution == "folded":
            out, _ = self.model(tl, tf, k, **kw)
        else:
            out, _ = self.model(make_sparse(tl, tf, k, dims, B), **kw)
        names = batch.get("names", [])
        for b in range(B):
            sel = locs[:k, 3] == b
            if hasattr(out, "refine_masks_unfilt"):
                occs = [(m[b] & (torch.sigmoid(g[b][..., 0]) > 0.5))
                        .nonzero().cpu().numpy().astype(np.int32)
                        for g, m in zip(out.refine_outs,
                                        out.refine_masks_unfilt)]
                sm = out.surf_mask[b]
                surf = (sm.nonzero().cpu().numpy().astype(np.int32),
                        out.surf_sdf[b][sm].cpu().numpy())
            else:
                occs = []
                for lu, ou, nu in out.refine_outs:
                    lu, ou = lu[:nu], ou[:nu]
                    m = (lu[:, 3] == b) & (torch.sigmoid(ou[:, 0]) > 0.5)
                    occs.append(lu[m][:, :3].cpu().numpy())
                sn = out.surf_num_valid
                sl = out.surf_locs[:sn]
                m = sl[:, 3] == b
                surf = (sl[m][:, :3].cpu().numpy(),
                        out.surf_sdf[:sn, 0][m].cpu().numpy())
            save_predictions(
                out_dir, names[b] if b < len(names) else str(b),
                locs[:k][sel][:, :3], feats[:k][sel][:, 0], dims,
                target_for_sdf=sdf[b], target_for_occs=None,
                pred_surf=surf if len(surf[0]) else None,
                pred_occ_locs=occs or None, truncation=trunc)

    def validate(self, val_loader, val_f=None, epoch: int = 0) -> dict:
        o = self.opts
        lw, (n_active, do_surf), _ = self._schedule()
        losses, ious, l1p, l1t = [], [], [], []
        for _, dev in self._prefetch(val_loader):
            m = TS.eval_step(self.model, dev, lw,
                             num_refine_active=n_active, do_surf=do_surf,
                             use_log_transform=o.logweight_target_sdf,
                             weight_missing_geo=o.weight_missing_geo,
                             use_loss_masking=o.use_loss_masking,
                             group=self.group)
            losses.append(float(m["loss"]))
            ious.append(m["iou"].cpu().numpy())
            l1p.append(float(m["l1pred"]))
            l1t.append(float(m["l1tgt"]))
        result = {
            "loss": float(np.mean(losses)) if losses else -1,
            "iou": np.mean(np.stack(ious), 0).tolist() if ious else [],
            "l1pred": _mean_valid(l1p),
            "l1tgt": _mean_valid(l1t),
        }
        if val_f:
            val_f.write(f"{epoch},{self.iteration},{result['loss']},"
                        + ",".join(str(v) for v in result["iou"])
                        + f",{result['l1pred']},{result['l1tgt']}\n")
            val_f.flush()
        self.say(f"[val] epoch {epoch}: {result}")
        return result


def _open_log(path, headers, resume):
    """A CSV log: appended to on resume when its header matches, else the
    old file is moved aside to ``.old`` and a new one started."""
    header = ",".join(headers)
    if resume and os.path.exists(path):
        with open(path) as f:
            existing = f.readline().rstrip("\n")
        if existing == header:
            return open(path, "a")
        os.replace(path, path + ".old")
        print(f"[log] header mismatch in {path}; moved the old file to "
              f"{path}.old")
    f = open(path, "w")
    f.write(header + "\n")
    return f


def latest_checkpoint(save_dir):
    """The newest .ckpt in a run directory (``retrain="auto"``)."""
    if not os.path.isdir(save_dir):
        return None
    cks = [os.path.join(save_dir, f) for f in os.listdir(save_dir)
           if f.endswith(".ckpt")]
    return max(cks, key=os.path.getmtime) if cks else None


def _mean_valid(vals):
    a = np.asarray(vals)
    a = a[a >= 0]
    return float(a.mean()) if len(a) else -1.0


class _MetricAccum:
    def __init__(self, num_levels):
        self.L = num_levels
        self.losses = [[] for _ in range(num_levels + 2)]
        self.ious = [[] for _ in range(num_levels)]
        self.l1pred = []
        self.l1tgt = []

    def add(self, metrics, with_metrics):
        self.losses[0].append(float(metrics["loss"]))
        per = metrics["per_level"].cpu().numpy()
        for h in range(self.L):
            self.losses[h + 1].append(float(per[h]))
        self.losses[-1].append(float(per[-1]))
        if with_metrics and "iou" in metrics:
            iou = metrics["iou"].cpu().numpy()
            for h in range(self.L):
                self.ious[h].append(float(iou[h]))
            self.l1pred.append(float(metrics["l1pred"]))
            self.l1tgt.append(float(metrics["l1tgt"]))

    def row(self, epoch, iteration, took):
        row = [epoch, iteration]
        row += [_mean_valid(x) for x in self.losses]
        row += [_mean_valid(self.l1pred), _mean_valid(self.l1tgt)]
        row += [_mean_valid(x) for x in self.ious]
        row += [took]
        return row
