"""One training step and one eval step, on one device or data-parallel
over a process group (port of ``sgnn_tpu/train/step.py``).

A collated batch goes to the device (``to_device``: pinned, non-blocking
copies, float arrays in the transfer type), targets are densified there
(``_densify_rows``, ``_unpack_known_bits``), the training forward of the
model's execution (``cfg.execution``: folded, dense_flow or the coordinate
lists, sparse) and its loss run (``losses.compute_loss_dense_flow``, or
``compute_loss`` at the coordinate lists' rows), autograd gives the
gradients, Adam updates the parameters and the new BN running stats are
stored. Under data parallelism (``group``, the data group of
``parallel.mesh``) each rank runs this on its own slice of the batch: every
BN sums its moments over the group (with a gradient), the gradients, the
loss and the metrics are averaged over it before the update (the JAX
step's ``pmean``s, :345-364), so every rank applies the same update and
holds the same parameters, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sgnn_tpu_torch import losses as L
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import (GenModelDenseTrain,
                                              genmodel_apply_dense_train)
from sgnn_tpu_torch.models.folded_train import (GenModelFoldedTrain,
                                                genmodel_apply_folded_train)
from sgnn_tpu_torch.models.sgnn import (GenModelSparseTrain,
                                        genmodel_apply_train)
from sgnn_tpu_torch.ops.sparse import make_sparse
from sgnn_tpu_torch.parallel import comm
from sgnn_tpu_torch.train.state import set_lr
from sgnn_tpu_torch.utils import profiling as P

# the trainable model of each execution (cfg.execution)
TRAIN_MODELS = {m.EXECUTION: m for m in (
    GenModelFoldedTrain, GenModelDenseTrain, GenModelSparseTrain)}


def train_model(cfg: SGNNConfig, seed: int = 0):
    """The trainable model of ``cfg.execution``, initialised from
    ``params.init_params(cfg, seed)``."""
    if cfg.execution not in TRAIN_MODELS:
        raise ValueError(f"execution {cfg.execution!r}, expected one of "
                         f"{sorted(TRAIN_MODELS)}")
    return TRAIN_MODELS[cfg.execution](cfg, seed=seed)


def to_device(batch: dict, device, transfer_dtype=torch.float32) -> dict:
    """A collated numpy batch as tensors on ``device``: arrays through
    pinned host memory with non-blocking copies (float32 arrays shipped in
    ``transfer_dtype``; the step casts back to f32), scalar counts as
    Python ints, everything else as it is."""
    dev = torch.device(device)

    def move(v):
        if isinstance(v, list):
            return [move(x) for x in v]
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dtype == torch.float32:
                t = t.to(transfer_dtype)
            if dev.type == "cuda":
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)
        if isinstance(v, np.integer):
            return int(v)
        return v
    return {k: move(v) for k, v in batch.items()}


def flat_key(locs: torch.Tensor, dims: tuple, B: int) -> torch.Tensor:
    """(z, y, x, b) rows -> b*Z*Y*X + z*Y*X + y*X + x; -1 out of bounds."""
    Z, Y, X = dims
    z, y, x, b = (locs[:, i].long() for i in range(4))
    inb = ((z >= 0) & (z < Z) & (y >= 0) & (y < Y) & (x >= 0) & (x < X)
           & (b >= 0) & (b < B))
    key = ((b * Z + z) * Y + y) * X + x
    return torch.where(inb, key, torch.full_like(key, -1))


def _bits(packed: torch.Tensor, nvox: int, B: int) -> torch.Tensor:
    """[B, nbytes] little-endian bit planes -> [B, nvox] uint8 {0, 1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(B, -1)[:, :nvox]


def _densify_rows(locs, vals, num: int, dims: tuple, B: int,
                  default: float, pos_bits=None, pos_fill: float = 0.0):
    """Sparse rows (z, y, x, b) -> dense [B, *dims] f32: ``default``, or
    ``pos_fill`` where ``pos_bits`` marks a voxel, then the first ``num``
    rows' values on top (the device half of the sparse-target transfer,
    bit-identical to densifying the full row set)."""
    nvox = dims[0] * dims[1] * dims[2]
    dev = vals.device
    if pos_bits is not None:
        bits = _bits(pos_bits, nvox, B).reshape(-1)
        flat = torch.where(bits > 0, torch.tensor(pos_fill, device=dev),
                           torch.tensor(default, device=dev))
    else:
        flat = torch.full((B * nvox,), default, device=dev)
    keys = flat_key(locs[:num], dims, B)
    keep = keys >= 0
    flat[keys[keep]] = vals[:num][keep].float()
    return flat.reshape(B, *dims)


def _unpack_known_bits(packed, dims: tuple, B: int) -> torch.Tensor:
    """[B, nbytes] bit-packed (known >= UNK_THRESH) -> uint8 [B, *dims] in
    {0, 255}: the only predicate of ``known`` the loss reads."""
    unk = _bits(packed, dims[0] * dims[1] * dims[2], B).reshape(B, *dims)
    return torch.where(unk > 0, 255, 0).to(torch.uint8)


def _unpack_batch(cfg: SGNNConfig, batch: dict):
    """A device batch -> (input locs, input feats f32, input count, target
    sdf, known, hierarchy), for both batch schemas: dense grids
    ("sdf"/"known"/"hierarchy") or sparse target rows ("target_locs",
    "hier_locs", "known_unk"; densified here)."""
    B = cfg.batch_size
    locs, n = batch["input_locs"], batch["input_num_valid"]
    feats = batch["input_sdf"].float()
    if "target_locs" in batch:
        sdf = _densify_rows(batch["target_locs"], batch["target_vals"],
                            batch["target_num_valid"], cfg.input_dim, B,
                            -np.inf, pos_bits=batch["target_pos"],
                            pos_fill=cfg.truncation)
        Lh = cfg.num_hierarchy_levels
        hierarchy = []
        for h in range(Lh - 1):
            f = 2 ** (Lh - 1 - h)
            dims_h = tuple(d // f for d in cfg.input_dim)
            hierarchy.append(_densify_rows(
                batch["hier_locs"][h], batch["hier_vals"][h],
                batch["hier_num"][h], dims_h, B, -np.inf,
                pos_bits=batch["hier_pos"][h], pos_fill=cfg.truncation))
        known = _unpack_known_bits(batch["known_unk"], cfg.input_dim, B)
        return locs, feats, n, sdf, known, hierarchy
    hierarchy = batch.get("hierarchy")
    if hierarchy is not None:
        hierarchy = [h.float() for h in hierarchy]
    return (locs, feats, n, batch["sdf"].float(), batch["known"],
            hierarchy)


def _input_mask(cfg: SGNNConfig, locs, n: int) -> torch.Tensor:
    """[B, Z, Y, X] bool: the sparse input's voxels."""
    Z, Y, X = cfg.input_dim
    B = cfg.batch_size
    keys = flat_key(locs[:n], cfg.input_dim, B)
    mask = torch.zeros(B * Z * Y * X, dtype=torch.bool, device=locs.device)
    mask[keys[keys >= 0]] = True
    return mask.reshape(B, Z, Y, X)


def _forward_loss(params, stats, cfg, inputs, targets, loss_weights, known,
                  *, num_refine_active, do_surf, use_log_transform,
                  weight_missing_geo, use_loss_masking, training, group=None):
    """The training forward of ``cfg.execution`` and its loss (the JAX
    step's _forward_loss, train/step.py:135-182); ``group``: the data
    group every training BN sums its moments over."""
    locs, feats, n = inputs
    kw = dict(num_refine_active=num_refine_active, do_surf=do_surf,
              training=training)
    lkw = dict(num_refine_active=num_refine_active, do_surf=do_surf,
               use_log_transform=use_log_transform,
               weight_missing_geo=weight_missing_geo,
               use_loss_masking=use_loss_masking, known=known)
    if cfg.execution == "folded":
        out, new_stats = genmodel_apply_folded_train(params, stats, cfg, locs,
                                                     feats, n, group=group,
                                                     **kw)
    else:
        st = make_sparse(locs, feats, n, cfg.input_dim, cfg.batch_size)
        if cfg.execution == "sparse":
            out, new_stats = genmodel_apply_train(params, stats, cfg, st,
                                                  group=group, **kw)
            total, per_level = L.compute_loss(
                out, targets, loss_weights, cfg.truncation, input_locs=st.locs,
                input_num_valid=st.num_valid, **lkw)
            return total, (per_level, out, new_stats)
        out, new_stats = genmodel_apply_dense_train(params, stats, cfg, st,
                                                    data=group, **kw)
    total, per_level = L.compute_loss_dense_flow(
        out, targets, loss_weights, cfg.truncation,
        input_mask=_input_mask(cfg, locs, n), **lkw)
    return total, (per_level, out, new_stats)


def _iou(pred, tgt1):
    inter, union = (pred & tgt1).sum(), (pred | tgt1).sum()
    return torch.where(union > 0, inter / union.clamp_min(1),
                       torch.tensor(-1.0, device=pred.device))


def _metrics(cfg, out, targets, known, *, num_refine_active, do_surf,
             use_loss_masking) -> dict:
    """IoU per level and the surface L1 metrics (train.py:271-297), of a
    dense-flow output or at the coordinate lists' rows
    (train/step.py:185-277; the rows' metrics summed in f64, as the
    evaluation's)."""
    dev = out.coarse_out.device
    minus1 = torch.tensor(-1.0, device=dev)
    rows = not hasattr(out, "refine_masks_unfilt")
    occ0 = targets.target_for_occs[0]
    pred0 = torch.sigmoid(out.coarse_out[..., 0]) > 0.5
    if use_loss_masking:
        pred0 = pred0 & (occ0 != L.UNK_ID)
    ious = [_iou(pred0, occ0 == 1.0)]
    for h in range(1, cfg.num_hierarchy_levels):
        if h - 1 >= num_refine_active:
            ious.append(minus1)
            continue
        occ_t = targets.target_for_occs[h]
        if rows:
            locs_u, out_u, num_u = out.refine_outs[h - 1]
            ious.append(L.compute_iou_sparse_dense(
                locs_u, num_u, torch.sigmoid(out_u[:, 0]) > 0.5, occ_t,
                use_loss_masking))
            continue
        pred = out.refine_masks_unfilt[h - 1] & (
            torch.sigmoid(out.refine_outs[h - 1][..., 0]) > 0.5)
        if use_loss_masking:
            pred = pred & (occ_t != L.UNK_ID)
        ious.append(_iou(pred, occ_t == 1.0))
    l1pred = l1tgt = minus1
    if do_surf and rows:
        tgt = targets.target_for_sdf
        l1pred = L.compute_l1_predsurf_sparse_dense(
            out.surf_locs, out.surf_num_valid, out.surf_sdf[:, 0], tgt, None,
            False, use_loss_masking,
            known >= L.UNK_THRESH if use_loss_masking else None)
        l1tgt = L.compute_l1_tgtsurf_sparse_dense(
            out.surf_locs, out.surf_num_valid, out.surf_sdf[:, 0], tgt,
            cfg.truncation, use_loss_masking, known)
    elif do_surf:
        tgt, m = targets.target_for_sdf, out.surf_mask
        if use_loss_masking:
            m = m & (known < L.UNK_THRESH)
        zero = torch.zeros_like(tgt)
        l1pred = torch.where(m, (out.surf_sdf - tgt).abs(), zero).sum() / \
            m.sum().clamp_min(1)
        pred_dense = torch.where(out.surf_mask, out.surf_sdf,
                                 torch.full_like(tgt, -cfg.truncation))
        tmask = tgt.abs() < cfg.truncation
        if use_loss_masking:
            tmask = tmask & (known < L.UNK_THRESH)
        l1tgt = torch.where(tmask, (pred_dense - tgt).abs(), zero).sum() / \
            tmask.sum().clamp_min(1)
    return {"iou": torch.stack(ious), "l1pred": l1pred, "l1tgt": l1tgt}


def _mean(tensors: list, group) -> list:
    """Each tensor averaged over the ranks of ``group`` (the JAX step's
    pmean: the sum, then divided by the group's size), in one all-reduce;
    the tensors as they are without a group."""
    if group is None:
        return tensors
    n = comm.size(group)
    return [(t / n).to(u.dtype) for t, u in zip(comm.all_reduce_each(
        [u.detach().float() for u in tensors], group), tensors)]


def _mean_metrics(metrics: dict, group) -> dict:
    keys = list(metrics)
    return dict(zip(keys, _mean([metrics[k] for k in keys], group)))


def _prepare(cfg, batch, use_loss_masking):
    locs, feats, n, sdf, known, hierarchy = _unpack_batch(cfg, batch)
    targets = L.compute_targets(sdf, hierarchy, cfg.num_hierarchy_levels,
                                cfg.truncation, use_loss_masking, known)
    return (locs, feats, n), targets, known


def train_step(model, opt, batch: dict, loss_weights, lr: float, *,
               num_refine_active: int, do_surf: bool,
               use_log_transform: bool = True,
               weight_missing_geo: float = 5.0,
               use_loss_masking: bool = True,
               with_metrics: bool = False, group=None) -> dict:
    """Forward, loss, backward, one Adam update at ``lr`` and the new BN
    running stats, on a device batch (``to_device``). Returns the metrics
    as device tensors: loss, per_level (L + 1 entries, -1 inactive) and,
    with ``with_metrics``, iou / l1pred / l1tgt. ``group``: data
    parallelism over its ranks (module docstring); the batch is this
    rank's slice and ``model.cfg.batch_size`` its size. Its spans
    (``profiling.span``): ``train_step`` over ``prepare``,
    ``forward_loss`` (the forward and the loss), ``backward`` (the
    gradients, a level's zeros and their mean over ``group``),
    ``optimizer`` (Adam, the BN stats and the loss's mean) and,
    ``with_metrics``, ``metrics``."""
    cfg = model.cfg
    with P.span("train_step"):
        with P.span("prepare"):
            inputs, targets, known = _prepare(cfg, batch, use_loss_masking)
        lw = [float(w) for w in loss_weights]
        with P.span("forward_loss"):
            total, (per_level, out, new_stats) = _forward_loss(
                model.param_tree(), model.stat_tree(), cfg, inputs, targets,
                lw, known, num_refine_active=num_refine_active,
                do_surf=do_surf, use_log_transform=use_log_transform,
                weight_missing_geo=weight_missing_geo,
                use_loss_masking=use_loss_masking, training=True,
                group=group)
        with P.span("backward"):
            opt.zero_grad(set_to_none=True)
            total.backward()
            for p in model.weights:
                # a level the fade-in has not reached gets a zero gradient,
                # as from jax.grad: Adam then steps every parameter, its
                # count is global and a level's first moments decay from
                # the step it joins
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if group is not None:
                grads = _mean([p.grad for p in model.weights], group)
                for p, g in zip(model.weights, grads):
                    p.grad.copy_(g)
        with P.span("optimizer"):
            set_lr(opt, lr)
            opt.step()
            model.set_stats(new_stats)
            total, per = _mean([total.detach(), torch.stack(
                [p.detach() for p in per_level])], group)
        metrics = {"loss": total, "per_level": per,
                   # rows the coordinate lists' compactions dropped at a
                   # capacity (train/step.py:349-356); 0 for a dense output
                   "overflow": max(getattr(out, "overflows", None) or [0])}
        if with_metrics:
            with P.span("metrics"), torch.no_grad():
                metrics.update(_mean_metrics(_metrics(
                    cfg, out, targets, known,
                    num_refine_active=num_refine_active, do_surf=do_surf,
                    use_loss_masking=use_loss_masking), group))
    return metrics


@torch.no_grad()
def eval_step(model, batch: dict, loss_weights, *, num_refine_active: int,
              do_surf: bool, use_log_transform: bool = True,
              weight_missing_geo: float = 5.0,
              use_loss_masking: bool = True, group=None) -> dict:
    """Forward, loss and metrics with BN in inference mode; no update.
    ``group``: the loss and the metrics averaged over its ranks."""
    cfg = model.cfg
    inputs, targets, known = _prepare(cfg, batch, use_loss_masking)
    total, (per_level, out, _) = _forward_loss(
        model.param_tree(), model.stat_tree(), cfg, inputs, targets,
        [float(w) for w in loss_weights], known,
        num_refine_active=num_refine_active, do_surf=do_surf,
        use_log_transform=use_log_transform,
        weight_missing_geo=weight_missing_geo,
        use_loss_masking=use_loss_masking, training=False)
    m = _metrics(cfg, out, targets, known,
                 num_refine_active=num_refine_active, do_surf=do_surf,
                 use_loss_masking=use_loss_masking)
    return _mean_metrics({"loss": total, "per_level": torch.stack(per_level),
                          **m}, group)
