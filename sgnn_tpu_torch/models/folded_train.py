"""The folded training forward (port of ``sgnn_tpu/models/folded_train.py``
``genmodel_apply_folded_train``, :208-409, with ``fuse_train_bn``).

The same [B, Z+2, Y+2, xq, 128] folded layout as the serving forward, over
parameter tensors so that autograd gives the gradients. Two branches, as
the JAX function selects them (``training and cfg.fuse_train_bn``):

- fused (the training step's default): the training Functions of
  ``ops/folded.py`` (K7 for the plain 3^3 convs, forward and input
  gradient; K1 for the fused BN -> conv sites; K2, K3 and K4 forward with
  the composed backward);
- composed (``fuse_train_bn=False``, and every ``training=False``
  forward: the eval step and the per-epoch prediction dump): each BN a
  materialised masked pass, every 3^3 conv on K7 per input group (the
  refinement's n1 over the three upsampled groups), the stride-2 sites,
  heads and gates the lane-algebra helpers of ``ops/folded.py``.

K6 scatters the input in both. Level 0 runs at cpad 8 when its widths
allow, as in serving, and the composed encoder then takes the cross
stride site. Control flow and the stats tree mirror the JAX function; the
returned ``DenseFlowOutput`` and new stats are what ``train/step.py``
consumes. ``jax.checkpoint`` is not ported (ROADMAP, not ported on
purpose). Under data parallelism every training BN sums its moments over
the data group (``group``, the JAX function's ``axis_name``).

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


@dataclasses.dataclass
class _Run:
    """How the forward runs its BNs: ``training`` (batch moments over
    ``group``'s ranks, else the running stats) and ``fuse``, the fused
    training sites (training and cfg.fuse_train_bn, the JAX function's
    guard); else the composed BN -> op branch."""
    training: bool
    fuse: bool
    group: Any = None


def _mask_bn(p, st, groups, fm, r: _Run):
    """Grouped masked BN + ReLU (_mask_bn_f:47): each group with its slice
    of the channels; the new stats the groups' concatenated when
    training, else the running stats unchanged."""
    outs, parts, off = [], [], 0
    for fg in groups:
        sl = slice(off, off + fg.real_c)
        y, ns = FO.bn_folded_train(
            {k: p[k][sl] for k in ("scale", "bias")},
            {k: st[k][sl] for k in ("mean", "var")}, fg, fm,
            training=r.training, group=r.group)
        outs.append(y)
        parts.append(ns)
        off += fg.real_c
    return outs, FO.cat_stats(parts) if r.training else st


def _resblock(p, st, fg, fm, r: _Run):
    s = {}
    if r.fuse:
        y, s["bn0"] = FO.bn_conv_folded_train(
            p["bn0"], st["bn0"], [fg], fm, p["conv0"], p["conv0"].shape[-1],
            group=r.group)
        y, s["bn1"] = FO.bn_conv_folded_train(
            p["bn1"], st["bn1"], [y], fm, p["conv1"], p["conv1"].shape[-1],
            group=r.group)
        return fg.with_data(fg.data + y.data), s
    y, s["bn0"] = _mask_bn(p["bn0"], st["bn0"], [fg], fm, r)
    y = FO.subm_conv_folded_train(y, fm, p["conv0"], p["conv0"].shape[-1])
    y, s["bn1"] = _mask_bn(p["bn1"], st["bn1"], [y], fm, r)
    y = FO.subm_conv_folded_train(y, fm, p["conv1"], p["conv1"].shape[-1])
    return fg.with_data(fg.data + y.data), s


def _unet(p, st, x, fm, r: _Run):
    s = {}
    x, s["block"] = _resblock(p["block"], st["block"], x, fm, r)
    if "deeper" not in p:
        return [x], s
    cout = p["down_conv"].shape[-1]
    if r.fuse:
        down, down_fm, s["down_bn"] = FO.bn_downconv_folded_train(
            p["down_bn"], st["down_bn"], x, fm, p["down_conv"], cout,
            group=r.group)
    else:
        y, s["down_bn"] = _mask_bn(p["down_bn"], st["down_bn"], [x], fm, r)
        down, down_fm = FO.strided_site_folded(y, fm, p["down_conv"], cout)
    deep, s["deeper"] = _unet(p["deeper"], st["deeper"], down, down_fm, r)
    ups = []
    for d in deep:
        u = FO.upsample2_folded(d)
        ups.append(u.with_data(u.data * fm.data))
    return [x, *ups], s


def _encoder_layer(p, st, x, fm, cpad_out, r: _Run):
    s = {}
    x = FO.subm_conv_folded_train([x], fm, p["p1"], p["p1"].shape[-1])
    x, s["p2"] = _resblock(p["p2"], st["p2"], x, fm, r)
    # p2_bn stays a materialized pass: its output is the skip tensor
    y, s["p2_bn"] = FO.bn_folded_train(p["p2_bn"], st["p2_bn"], x, fm,
                                       training=r.training, group=r.group)
    cout = p["p3"].shape[-1]
    if r.fuse:
        down, down_fm = FO.downconv_folded_train(y, fm, p["p3"], cout,
                                                 cpad_out=cpad_out)
    else:  # the cross site where cpad_out widens the lane budget
        down, down_fm = FO.strided_site_folded([y], fm, p["p3"], cout,
                                               cpad_out=cpad_out)
    z, s["p3_bn"] = FO.bn_folded_train(p["p3_bn"], st["p3_bn"], down,
                                       down_fm, training=r.training,
                                       group=r.group)
    return z, down_fm, (y, fm), s


def _refine_level(p, st, cfg, cur, cur_fm, r: _Run):
    s = {}
    nf = p["p1"].shape[-1]
    z = FO.subm_conv_folded_train(cur, cur_fm, p["p1"], nf)
    zg, s["p2"] = _unet(p["p2"], st["p2"], z, cur_fm, r)
    fm_unfilt = FO.upsample2_folded(cur_fm)
    w2 = torch.cat([p["linear"]["weight"], p["linearsdf"]["weight"]], 1)
    b2 = torch.cat([p["linear"]["bias"], p["linearsdf"]["bias"]])
    if r.fuse:
        up, s["p3"] = FO.bn_upconv_folded_train(
            p["p3"], st["p3"], zg, cur_fm, fm_unfilt, p["n1"],
            p["n1"].shape[-1], group=r.group)
        upm, o2m, new_fm, out2, s["n2"] = FO.bn_head_site_folded_train(
            p["n2"], st["n2"], up, fm_unfilt, w2, b2, group=r.group)
    else:
        # per-group p3 BN, the 2x upsample (no mask multiply), the n1 conv
        # over the upsampled groups (K7 per group), n2 BN, the heads
        zb, s["p3"] = _mask_bn(p["p3"], st["p3"], zg, cur_fm, r)
        up = FO.subm_conv_folded_train([FO.upsample2_folded(g) for g in zb],
                                       fm_unfilt, p["n1"], p["n1"].shape[-1])
        upl, s["n2"] = _mask_bn(p["n2"], st["n2"], [up], fm_unfilt, r)
        upm, o2m, new_fm, out2 = FO.head_gate_composed(upl[0], fm_unfilt, w2,
                                                       b2)
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
    stats). The BN -> op sites run fused (the training Functions of
    ``ops/folded.py``) when ``training`` and ``cfg.fuse_train_bn``, else
    composed (the JAX function's guard, :72-361); with ``training=False``
    every BN uses its running stats and the stats come back unchanged.
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
    r = _Run(training, training and cfg.fuse_train_bn, group)

    # ---- encoder sparse levels
    enc_s, skips = [], []
    for lvl in range(len(cfg.nf_per_level)):
        widen = lvl == 0 and cpad0 != CPAD
        x, m, ft2, s_lvl = _encoder_layer(
            params["encoder"]["process_sparse"][lvl],
            stats["encoder"]["process_sparse"][lvl], x, m,
            CPAD if widen else None, r)
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
            cur_fm, r)
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
        zg, s_s["p2"] = _unet(p["p2"], st_s["p2"], z, cur_fm, r)
        W, b = p["linear"]["weight"], p["linear"]["bias"]
        if r.fuse:
            surf_fg, s_s["p3"] = FO.bn_surf_head_folded_train(
                p["p3"], st_s["p3"], zg, cur_fm, W, b, group=group)
        else:  # per-group p3 BN, the per-group linear heads summed
            zb, s_s["p3"] = _mask_bn(p["p3"], st_s["p3"], zg, cur_fm, r)
            surf_fg = FO.linear_sum_folded(zb, W, b)
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
