"""Hierarchical occupancy/SDF losses (port of ``sgnn_tpu/losses.py``:
``preprocess_sdf:48``, ``apply_log_transform:54``, ``compute_targets:59``,
``compute_bce_dense:152``, ``compute_l1_dense:200``,
``compute_weights_missing_geo_dense:221``, ``compute_loss_dense_flow:235``
for the dense-flow and folded executions; ``compute_weights_missing_geo:
91``, ``compute_bce_sparse_dense:131``, ``compute_loss:379`` for the
coordinate lists; the reference's loss.py) and the evaluation metrics at a
coordinate list of predicted voxels (``compute_l1_predsurf_sparse_dense:
172``, ``compute_l1_tgtsurf_sparse_dense:327``,
``compute_iou_sparse_dense:353``), computed on the device their tensors
lie on. Every reduction is a masked mean over dense grids or rows: the
losses' in f32 as the JAX package sums them, the metrics' in f64.

Conventions (loss.py:10-13): UNK_THRESH = 2, UNK_ID = -1. A voxel with
known >= UNK_THRESH is unobserved; with use_loss_masking those voxels are
excluded from BCE/L1 and marked UNK_ID in the occupancy targets.
"""

from __future__ import annotations

import dataclasses

import torch

from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops import dense as D
from sgnn_tpu_torch.ops.sparse import gather_dense

UNK_THRESH = 2
UNK_ID = -1.0


@dataclasses.dataclass
class TargetBundle:
    """Per-level targets, coarse to fine: target_for_sdf [B, Z, Y, X]
    clamped SDF; target_for_occs [B, z, y, x] occupancy in {0, 1,
    UNK_ID}; target_for_hier [B, z, y, x] clamped SDF."""
    target_for_sdf: torch.Tensor
    target_for_occs: list
    target_for_hier: list


def preprocess_sdf(sdf: torch.Tensor, truncation: float) -> torch.Tensor:
    """Clamp to +-truncation (-inf, missing, becomes -truncation)."""
    return sdf.clamp(-truncation, truncation)


def apply_log_transform(sdf: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(|x| + 1) (loss.py:51-55)."""
    return torch.sign(sdf) * torch.log(sdf.abs() + 1.0)


def subsample2(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 subsample of [B, Z, Y, X] (loss.py:46)."""
    return x[:, ::2, ::2, ::2]


def compute_targets(target: torch.Tensor, hierarchy: list,
                    num_hierarchy_levels: int, truncation: float,
                    use_loss_masking: bool, known: torch.Tensor | None
                    ) -> TargetBundle:
    """loss.py:15-32; the finest hierarchy target is the clamped SDF (the
    JAX package's deliberate deviation, losses.py:76-84)."""
    L = num_hierarchy_levels
    target_for_sdf = preprocess_sdf(target, truncation)
    occ = (target_for_sdf.abs() < truncation).float()
    if use_loss_masking:
        occ = torch.where(known >= UNK_THRESH, torch.full_like(occ, UNK_ID),
                          occ)
    occs, hier = [None] * L, [None] * L
    occs[-1], hier[-1] = occ, target_for_sdf
    for h in range(L - 2, -1, -1):
        occs[h] = D.max_pool3d(occs[h + 1])
        hier[h] = preprocess_sdf(hierarchy[h], truncation)
    return TargetBundle(target_for_sdf, occs, hier)


def _masked_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    cnt = mask.sum()
    return torch.where(mask, vals, torch.zeros_like(vals)).sum() / \
        cnt.clamp_min(1)


def _metric_mean(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """_masked_mean summed in f64, rounded to f32: an evaluation metric
    over a scene's millions of voxels then depends on the values alone,
    not on the device's summation order."""
    total = torch.where(mask, vals, torch.zeros_like(vals)).sum(
        dtype=torch.float64)
    return (total / mask.sum().clamp_min(1)).float()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (stable form). The
    max(x, 0) is torch.relu, whose gradient at 0 is 0 as jnp.maximum's is:
    a voxel whose trunk features are all zero has a logit of exactly 0."""
    return (torch.relu(logits) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def compute_bce_dense(logits, dense_tgts, weights, use_loss_masking):
    """Level-0 BCE over every coarse voxel."""
    tgt = dense_tgts
    if use_loss_masking:
        mask = tgt != UNK_ID
    else:
        mask = torch.ones_like(tgt, dtype=torch.bool)
        tgt = torch.where(tgt == UNK_ID, torch.zeros_like(tgt), tgt)
    loss = bce_with_logits(logits, tgt)
    if weights is not None:
        loss = loss * weights
    return _masked_mean(loss, mask)


def compute_l1_dense(preds, dense_tgts, weights, use_log_transform,
                     use_loss_masking, known_mask_unk):
    """Level-0 L1 over every coarse voxel."""
    mask = torch.ones_like(dense_tgts, dtype=torch.bool)
    if use_loss_masking and known_mask_unk is not None:
        mask = ~known_mask_unk
    p, t = preds, dense_tgts
    if use_log_transform:
        p, t = apply_log_transform(p), apply_log_transform(t)
    loss = (p - t).abs()
    if weights is not None:
        loss = loss * weights
    return _masked_mean(loss, mask)


def compute_weights_missing_geo_dense(weight_missing_geo: float,
                                      input_mask: torch.Tensor,
                                      num_levels: int) -> list:
    """weight_missing_geo off the sparse input's voxels, 1 on them, per
    level by stride-2 subsampling (loss.py:35-48)."""
    w = torch.where(input_mask, 1.0, weight_missing_geo).float()
    weights = [None] * num_levels
    weights[-1] = w
    for h in range(num_levels - 2, -1, -1):
        weights[h] = subsample2(weights[h + 1])
    return weights


def _coarse_loss(coarse_out, targets: TargetBundle, w0, use_log_transform,
                 use_loss_masking):
    """Level 0: BCE and L1 of the dense coarse prediction over every
    coarse voxel."""
    occ0 = targets.target_for_occs[0]
    return compute_bce_dense(coarse_out[..., 0], occ0, w0,
                             use_loss_masking) + compute_l1_dense(
        coarse_out[..., 1], targets.target_for_hier[0], w0,
        use_log_transform, use_loss_masking, occ0 == UNK_ID)


def compute_loss_dense_flow(out, targets: TargetBundle, loss_weights,
                            truncation: float, *, num_refine_active: int,
                            do_surf: bool, use_log_transform: bool = True,
                            weight_missing_geo: float = 1.0,
                            input_mask=None, use_loss_masking: bool = True,
                            known=None):
    """Total hierarchical loss of a DenseFlowOutput (loss.py:160-199, at
    the unpruned upsampled sites). ``loss_weights`` is a sequence of L + 1
    floats. Returns (total, per-level list: level 0..L-1, surface; -1 for
    an inactive level)."""
    L = len(targets.target_for_occs)
    weights = [None] * L
    if weight_missing_geo > 1:
        weights = compute_weights_missing_geo_dense(weight_missing_geo,
                                                    input_mask, L)
    minus1 = torch.tensor(-1.0, device=out.coarse_out.device)
    lvl0 = _coarse_loss(out.coarse_out, targets, weights[0],
                        use_log_transform, use_loss_masking)
    total = loss_weights[0] * lvl0
    losses = [lvl0]

    def masked_level(pred, site_mask, occ_t, hier_t, w):
        unk = occ_t == UNK_ID
        bmask = site_mask & ~unk if use_loss_masking else site_mask
        tgt = occ_t if use_loss_masking else torch.where(
            unk, torch.zeros_like(occ_t), occ_t)
        bce = bce_with_logits(pred[..., 0], tgt)
        if w is not None:
            bce = bce * w
        p, t = pred[..., 1], hier_t
        if use_log_transform:
            p, t = apply_log_transform(p), apply_log_transform(t)
        l1 = (p - t).abs()
        if w is not None:
            l1 = l1 * w
        return _masked_mean(bce, bmask) + _masked_mean(l1, bmask)

    for h in range(1, L):
        if h - 1 < num_refine_active:
            lvl = masked_level(out.refine_outs[h - 1],
                               out.refine_masks_unfilt[h - 1],
                               targets.target_for_occs[h],
                               targets.target_for_hier[h], weights[h])
            total = total + loss_weights[h] * lvl
            losses.append(lvl)
        else:
            losses.append(minus1)
    if do_surf:
        mask = out.surf_mask
        if use_loss_masking and known is not None:
            mask = mask & (known < UNK_THRESH)
        p, t = out.surf_sdf, targets.target_for_sdf
        if use_log_transform:
            p, t = apply_log_transform(p), apply_log_transform(t)
        loss = (p - t).abs()
        if weights[-1] is not None:
            loss = loss * weights[-1]
        surf = _masked_mean(loss, mask)
        total = total + loss_weights[-1] * surf
        losses.append(surf)
    else:
        losses.append(minus1)
    return total, losses


def compute_l1_predsurf_sparse_dense(locs, num_valid: int, preds,
                                     dense_tgts, weights,
                                     use_log_transform: bool,
                                     use_loss_masking: bool,
                                     known_mask_unk, mean=None):
    """L1 at the predicted voxels ``locs [cap, 4]`` (z, y, x, b), the first
    ``num_valid`` rows, against the dense target SDF [B, Z, Y, X]; with
    ``use_loss_masking`` the voxels ``known_mask_unk`` (bool, True =
    unknown) marks are left out (the reference's loss.py:122-157).
    ``mean``: the masked mean, the metric's f64 one by default; the loss
    passes ``_masked_mean``."""
    tgt = gather_dense(dense_tgts[..., None], locs)[:, 0]
    mask = C.valid_mask(num_valid, locs.shape[0], locs.device)
    if use_loss_masking and known_mask_unk is not None:
        unk = gather_dense(known_mask_unk[..., None].float(), locs)[:, 0]
        mask = mask & (unk == 0)
    p, t = preds, tgt
    if use_log_transform:
        p, t = apply_log_transform(p), apply_log_transform(t)
    loss = (p - t).abs()
    if weights is not None:
        loss = loss * gather_dense(weights[..., None], locs)[:, 0]
    return (mean or _metric_mean)(loss, mask)


def _scatter_rows(locs, rows, vals, fill, shape) -> torch.Tensor:
    """A dense ``shape`` [B, Z, Y, X] grid holding ``fill``, and ``vals``
    at the rows of ``locs`` that ``rows`` (bool [cap]) selects and that
    lie inside the volume."""
    keys = C.flat_key(locs, tuple(shape[1:]), shape[0]).long()
    ok = rows & (keys >= 0)
    n = shape[0] * shape[1] * shape[2] * shape[3]
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    out[keys[ok]] = vals[ok]
    return out.reshape(shape)


def compute_l1_tgtsurf_sparse_dense(locs, num_valid: int, preds,
                                    dense_tgts, truncation: float,
                                    use_loss_masking: bool, known):
    """L1 at the target's near-surface voxels (|sdf| < truncation; with
    ``use_loss_masking`` only the observed ones, known < UNK_THRESH); a
    voxel with no prediction reads -truncation, so missed geometry counts
    (the reference's loss.py:201-231)."""
    valid = C.valid_mask(num_valid, locs.shape[0], locs.device)
    pred_dense = _scatter_rows(locs, valid, preds.float(), -truncation,
                               dense_tgts.shape)
    tmask = dense_tgts.abs() < truncation
    if use_loss_masking and known is not None:
        tmask = tmask & (known < UNK_THRESH)
    return _metric_mean((pred_dense - dense_tgts).abs(), tmask)


def compute_iou_sparse_dense(locs, num_valid: int, occupied, dense_tgts,
                             use_loss_masking: bool) -> torch.Tensor:
    """Occupancy IoU of the predicted voxels (``occupied [cap]`` bool at
    ``locs``) against the target occupancy [B, Z, Y, X] in {0, 1, UNK_ID};
    with ``use_loss_masking`` predictions at UNK_ID voxels are left out.
    -1 when the union is empty (the reference's loss.py:84-120)."""
    keep = C.valid_mask(num_valid, locs.shape[0], locs.device) & occupied
    pred = _scatter_rows(locs, keep, torch.ones_like(keep), False,
                         dense_tgts.shape)
    tgt1 = dense_tgts == 1.0
    if use_loss_masking:
        pred = pred & (dense_tgts != UNK_ID)
    inter = (pred & tgt1).sum()
    union = (pred | tgt1).sum()
    iou = inter.float() / union.clamp_min(1).float()
    return torch.where(union > 0, iou, torch.full_like(iou, -1.0))


def compute_weights_missing_geo(weight_missing_geo: float, input_locs,
                                input_num_valid: int, target_for_occs: list
                                ) -> list:
    """compute_weights_missing_geo_dense at the voxels of the sparse input
    rows ``input_locs`` (the first ``input_num_valid``)."""
    finest = target_for_occs[-1]
    valid = C.valid_mask(input_num_valid, input_locs.shape[0],
                         input_locs.device)
    is_input = _scatter_rows(input_locs, valid, torch.ones_like(valid), False,
                             finest.shape)
    return compute_weights_missing_geo_dense(weight_missing_geo, is_input,
                                             len(target_for_occs))


def compute_bce_sparse_dense(locs, num_valid: int, logits, dense_tgts,
                             weights, use_loss_masking: bool):
    """BCE of the logits at ``locs [cap, 4]`` (the first ``num_valid``
    rows) against the dense occupancy [B, z, y, x] in {0, 1, UNK_ID}
    (the reference's loss.py:58-82)."""
    tgt = gather_dense(dense_tgts[..., None], locs)[:, 0]
    mask = C.valid_mask(num_valid, locs.shape[0], locs.device)
    if use_loss_masking:
        mask = mask & (tgt != UNK_ID)
    else:
        tgt = torch.where(tgt == UNK_ID, torch.zeros_like(tgt), tgt)
    loss = bce_with_logits(logits, tgt)
    if weights is not None:
        loss = loss * gather_dense(weights[..., None], locs)[:, 0]
    return _masked_mean(loss, mask)


def compute_loss(out, targets: TargetBundle, loss_weights, truncation: float,
                 *, num_refine_active: int, do_surf: bool,
                 use_log_transform: bool = True,
                 weight_missing_geo: float = 1.0, input_locs=None,
                 input_num_valid: int = 0, use_loss_masking: bool = True,
                 known=None):
    """Total hierarchical loss of a coordinate-list GenModelOutput
    (loss.py:160-199, at each level's unpruned rows): the same terms as
    compute_loss_dense_flow, gathered at the rows. Returns (total,
    per-level list: level 0..L-1, surface; -1 for an inactive level)."""
    L = len(targets.target_for_occs)
    weights = [None] * L
    if weight_missing_geo > 1:
        weights = compute_weights_missing_geo(
            weight_missing_geo, input_locs, input_num_valid,
            targets.target_for_occs)
    minus1 = torch.tensor(-1.0, device=out.coarse_out.device)
    lvl0 = _coarse_loss(out.coarse_out, targets, weights[0],
                        use_log_transform, use_loss_masking)
    total = loss_weights[0] * lvl0
    losses = [lvl0]
    for h in range(1, L):
        if h - 1 < num_refine_active:
            locs_u, out_u, num_u = out.refine_outs[h - 1]
            occ_t = targets.target_for_occs[h]
            lvl = compute_bce_sparse_dense(
                locs_u, num_u, out_u[:, 0], occ_t, weights[h],
                use_loss_masking) + compute_l1_predsurf_sparse_dense(
                locs_u, num_u, out_u[:, 1], targets.target_for_hier[h],
                weights[h], use_log_transform, use_loss_masking,
                occ_t == UNK_ID, mean=_masked_mean)
            total = total + loss_weights[h] * lvl
            losses.append(lvl)
        else:
            losses.append(minus1)
    if do_surf:
        known_unk = (known >= UNK_THRESH if use_loss_masking
                     and known is not None else None)
        surf = compute_l1_predsurf_sparse_dense(
            out.surf_locs, out.surf_num_valid, out.surf_sdf[:, 0],
            targets.target_for_sdf, weights[-1], use_log_transform,
            use_loss_masking, known_unk, mean=_masked_mean)
        total = total + loss_weights[-1] * surf
        losses.append(surf)
    else:
        losses.append(minus1)
    return total, losses
