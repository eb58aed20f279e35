"""The folded training forward (port of ``sgnn_tpu/models/folded_train.py``
``genmodel_apply_folded_train``, :208-409, with ``fuse_train_bn``).

The same [B, Z+2, Y+2, xq, 128] folded layout as the serving forward, over
parameter tensors so that autograd gives the gradients: every site is one
of the training Functions of ``ops/folded.py`` (K7 for the 3^3 convs,
forward and input gradient; K1 for the fused BN -> conv sites; K2, K3 and
K4 forward with the composed backward; K6 at the input). Level 0 runs at
cpad 8 when its widths allow, as in serving. Control flow and the stats
tree mirror the JAX function; the returned ``DenseFlowOutput`` and new
stats are what ``train/step.py`` consumes. ``jax.checkpoint`` is not
ported (the step fits the card without recomputation; ROADMAP). Under
data parallelism every training BN sums its moments over the data group
(``group``, the JAX function's ``axis_name``).

``GenModelFoldedTrain`` holds the JAX tree's parameters and running stats
(``models/dense_flow.TrainModel``: ``params.load_jax_params`` fills it,
``params.export_params`` reads it back).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import TrainModel, dense_trunk_train
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops.folded import FGrid

CPAD = 16


@dataclasses.dataclass
class DenseFlowOutput:
    """coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf); refine_outs per
    active level [B, z, y, x, 2] f32 at the unpruned sites;
    refine_masks_unfilt per level [B, z, y, x] bool; surf_sdf [B, Z, Y, X]
    f32; surf_mask [B, Z, Y, X] bool."""
    coarse_out: torch.Tensor
    refine_outs: list
    refine_masks_unfilt: list
    surf_sdf: torch.Tensor
    surf_mask: torch.Tensor


def _resblock(p, st, fg, fm, training, group):
    s = {}
    y, s["bn0"] = FO.bn_conv_folded_train(p["bn0"], st["bn0"], [fg], fm,
                                          p["conv0"], p["conv0"].shape[-1],
                                          training=training, group=group)
    y, s["bn1"] = FO.bn_conv_folded_train(p["bn1"], st["bn1"], [y], fm,
                                          p["conv1"], p["conv1"].shape[-1],
                                          training=training, group=group)
    return fg.with_data(fg.data + y.data), s


def _unet(p, st, x, fm, training, group):
    s = {}
    x, s["block"] = _resblock(p["block"], st["block"], x, fm, training,
                              group)
    if "deeper" not in p:
        return [x], s
    down, down_fm, s["down_bn"] = FO.bn_downconv_folded_train(
        p["down_bn"], st["down_bn"], x, fm, p["down_conv"],
        p["down_conv"].shape[-1], training=training, group=group)
    deep, s["deeper"] = _unet(p["deeper"], st["deeper"], down, down_fm,
                              training, group)
    ups = []
    for d in deep:
        u = FO.upsample2_folded(d)
        ups.append(u.with_data(u.data * fm.data))
    return [x, *ups], s


def _encoder_layer(p, st, x, fm, cpad_out, training, group):
    s = {}
    x = FO.subm_conv_folded_train([x], fm, p["p1"], p["p1"].shape[-1])
    x, s["p2"] = _resblock(p["p2"], st["p2"], x, fm, training, group)
    # p2_bn stays a materialized pass: its output is the skip tensor
    y, s["p2_bn"] = FO.bn_folded_train(p["p2_bn"], st["p2_bn"], x, fm,
                                       training=training, group=group)
    down, down_fm = FO.downconv_folded_train(y, fm, p["p3"],
                                             p["p3"].shape[-1],
                                             cpad_out=cpad_out)
    z, s["p3_bn"] = FO.bn_folded_train(p["p3_bn"], st["p3_bn"], down,
                                       down_fm, training=training,
                                       group=group)
    return z, down_fm, (y, fm), s


def _refine_level(p, st, cfg, cur, cur_fm, training, group):
    s = {}
    nf = p["p1"].shape[-1]
    z = FO.subm_conv_folded_train(cur, cur_fm, p["p1"], nf)
    zg, s["p2"] = _unet(p["p2"], st["p2"], z, cur_fm, training, group)
    fm_unfilt = FO.upsample2_folded(cur_fm)
    w2 = torch.cat([p["linear"]["weight"], p["linearsdf"]["weight"]], 1)
    b2 = torch.cat([p["linear"]["bias"], p["linearsdf"]["bias"]])
    up, s["p3"] = FO.bn_upconv_folded_train(
        p["p3"], st["p3"], zg, cur_fm, fm_unfilt, p["n1"],
        p["n1"].shape[-1], training=training, group=group)
    upm, o2m, new_fm, out2, s["n2"] = FO.bn_head_site_folded_train(
        p["n2"], st["n2"], up, fm_unfilt, w2, b2, training=training,
        group=group)
    nxt = [upm] * cfg.pass_feats + [o2m] * cfg.pass_occ
    return nxt, new_fm, out2, fm_unfilt, s


def genmodel_apply_folded_train(params: dict, stats: dict, cfg: SGNNConfig,
                                locs: torch.Tensor, feats: torch.Tensor,
                                num_valid: int, *, num_refine_active: int,
                                do_surf: bool, training: bool = True,
                                group=None):
    """The folded training forward over ``params``/``stats`` trees of
    tensors: ``locs [cap, 4]`` (z, y, x, b) and ``feats [cap, 1]`` input
    rows, the first ``num_valid`` valid. Returns (DenseFlowOutput, new
    stats); with ``training=False`` every BN uses its running stats.
    ``group``: the data-parallel group every training BN's moments are
    summed over (``axis_name`` there)."""
    s: dict[str, Any] = {}
    dt = getattr(torch, cfg.compute_dtype)
    Z, Y, X = cfg.input_dim
    B = cfg.batch_size
    cpad0 = 8 if (cfg.input_nf <= 8 and cfg.nf_per_level[0] <= 8
                  and X % 16 == 0) else CPAD
    x, m = FO.scatter_sparse(locs, feats, num_valid, cfg.input_dim, B,
                             cpad=cpad0, dtype=dt, feat_bound=cfg.truncation)

    # ---- encoder sparse levels
    enc_s, skips = [], []
    for lvl in range(len(cfg.nf_per_level)):
        widen = lvl == 0 and cpad0 != CPAD
        x, m, ft2, s_lvl = _encoder_layer(
            params["encoder"]["process_sparse"][lvl],
            stats["encoder"]["process_sparse"][lvl], x, m,
            CPAD if widen else None, training, group)
        enc_s.append(s_lvl)
        if widen:  # the full-res skip is consumed at CPAD (surface p1)
            ft2 = (FO.repack_cpad(ft2[0], CPAD), ft2[1])
        skips.append(ft2)
    skips.append((x, m))
    s["encoder"] = {"process_sparse": enc_s}

    # ---- coarse dense trunk (1/8 res, unfolded)
    y, coarse_out, s_trunk = dense_trunk_train(
        params["encoder"], stats["encoder"], cfg, FO.unfold(x),
        training=training, group=group)
    s["encoder"].update(s_trunk)

    cur_fm = FO.fold_mask(torch.sigmoid(coarse_out[..., 0]) > 0.5, CPAD, dt)
    cur = []
    if cfg.pass_occ:
        o = FO.fold(coarse_out.to(dt), CPAD)
        cur.append(o.with_data(o.data * cur_fm.data))
    if cfg.pass_feats:
        f = FO.fold(y, CPAD)
        cur.append(f.with_data(f.data * cur_fm.data))

    # ---- refinement levels
    L_ref = cfg.num_refine_levels
    ref_outs, ref_masks = [], []
    new_ref = list(stats["refinement"])
    for h in range(num_refine_active):
        if cfg.use_skip_sparse:
            sk = skips[L_ref - h][0]
            cur = [*cur, sk.with_data(sk.data * cur_fm.data)]
        cur, cur_fm, out2, fm_unfilt, new_ref[h] = _refine_level(
            params["refinement"][h], stats["refinement"][h], cfg, cur,
            cur_fm, training, group)
        ref_outs.append(FO.unfold(out2).float())
        ref_masks.append(FO.unfold(fm_unfilt)[..., 0] > 0.5)
    s["refinement"] = new_ref

    # ---- surface prediction
    if do_surf and num_refine_active == L_ref:
        p, st_s = params["surfacepred"], stats["surfacepred"]
        if cfg.use_skip_sparse:
            sk = skips[0][0]
            cur = [*cur, sk.with_data(sk.data * cur_fm.data)]
        s_s = {}
        z = FO.subm_conv_folded_train(cur, cur_fm, p["p1"],
                                      p["p1"].shape[-1])
        zg, s_s["p2"] = _unet(p["p2"], st_s["p2"], z, cur_fm, training,
                              group)
        surf_fg, s_s["p3"] = FO.bn_surf_head_folded_train(
            p["p3"], st_s["p3"], zg, cur_fm, p["linear"]["weight"],
            p["linear"]["bias"], training=training, group=group)
        surf = FO.unfold(surf_fg)[..., 0]
        surf_mask = FO.unfold(cur_fm)[..., 0] > 0.5
        s["surfacepred"] = s_s
    else:
        dev = coarse_out.device
        surf = torch.zeros(B, Z, Y, X, device=dev)
        surf_mask = torch.zeros(B, Z, Y, X, dtype=torch.bool, device=dev)
        s["surfacepred"] = stats["surfacepred"]
    return DenseFlowOutput(coarse_out, ref_outs, ref_masks, surf,
                           surf_mask), s


class GenModelFoldedTrain(TrainModel):
    """The trainable folded model (``genmodel_apply_folded_train``)."""

    EXECUTION = "folded"

    def forward(self, locs, feats, num_valid: int, *, num_refine_active: int,
                do_surf: bool, training: bool = True, group=None):
        return genmodel_apply_folded_train(
            self.param_tree(), self.stat_tree(), self.cfg, locs, feats,
            num_valid, num_refine_active=num_refine_active, do_surf=do_surf,
            training=training, group=group)
