"""The coordinate-list execution of GenModel (port of
``sgnn_tpu/models/sgnn.py``): a sparse encoder over fixed-capacity
coordinate lists, the dense trunk at 1/8 resolution, the generative
refinement levels (sparse U-Net -> 2x voxel upsample -> occupancy-gated
compaction into the next level's capacity) and the surface head.

The repo's test oracle. Its capacities are part of what it computes: rows
beyond a capacity are dropped as the JAX package drops them, and
``GenModelOutput.overflows`` counts them. Every sparse conv goes through
``ops/conv.py`` with the config's ``conv_backend`` (``"gather"``: K10 on
the card, forward and input gradient; ``"dense"``: cuDNN convs over
densified grids).

``genmodel_apply`` is one forward for serving and training: the blocks
apply each BN node with the ``bn`` they are given (nn/blocks.py) and the
trunk is a callable. ``GenModelSparse`` serves with prepared eval
constants and the prepared ``DenseTrunk``; ``genmodel_apply_train`` and
``GenModelSparseTrain`` train over parameter tensors (batch moments,
``dense_trunk_train``), with the fade-in's ``num_refine_active`` and
``do_surf``.

Feature concatenation orders follow the reference (sgnn.py:20-24):
  * coarse -> refine 0: [occ(2) | coarse_feats(nf_coarse)]
  * refine h -> h+1:    [x(nf) | occ(2)]
  * concat_skip appends the encoder's skip features last.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import (EvalModel, TrainModel,
                                              dense_trunk_train,
                                              sparse_levels)
from sgnn_tpu_torch.nn import blocks as B
from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import conv as CV
from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops.sparse import (SparseTensor, dense_to_sparse,
                                       make_sparse, sparse_to_dense)


def tsdf_encoder_apply(tree: dict, stats, st: SparseTensor, *, trunk, bn,
                       backend: str, impl: str | None = None):
    """Returns (dense feats [B, Z8, Y8, X8, nf_coarse], coarse_out [...,
    2] f32 (occ, sdf), the sparse skips ft2 per level and then ft3, the
    encoder's new stats). ``trunk(x) -> (y, coarse_out, its new stats)``."""
    skips, x, new = [], st, []
    for lvl, p in enumerate(tree["process_sparse"]):
        x, ft2, s_l = B.encoder_layer_apply(
            p, None if stats is None else stats["process_sparse"][lvl], x,
            out_capacity=x.capacity, bn=bn, backend=backend, impl=impl)
        skips.append(ft2)
        new.append(s_l)
    skips.append(x)
    y, coarse_out, s_trunk = trunk(sparse_to_dense(x))
    return y, coarse_out, skips, {"process_sparse": new, **s_trunk}


def _head(y: torch.Tensor, p: dict) -> torch.Tensor:
    """y @ W + b in f32 (the compute-type rows promote to f32 there)."""
    return y.float() @ p["weight"] + p["bias"]


def refinement_apply(p: dict, s, cfg: SGNNConfig, st: SparseTensor, *,
                     out_capacity: int, bn, backend: str,
                     impl: str | None = None):
    """One generative level. Returns (the pruned SparseTensor at 2x
    resolution, (locs_unfilt, out [occ, sdf], num_unfilt), overflow, new
    stats)."""
    kw = dict(backend=backend, impl=impl)
    nbr = CV.neighbours(st, backend)
    new = {}
    x = CV.submanifold_conv3d(st, p["p1"], nbr=nbr, **kw)
    x, new["p2"] = B.sparse_unet_apply(p["p2"], B.sub(s, "p2"), x, bn=bn,
                                       nbr=nbr, **kw)
    y, new["p3"] = bn(p["p3"], B.sub(s, "p3"), x.feats, x.valid())
    locs_unfilt, feats_up = C.upsample_locs_x2(st.locs, y)
    num_unfilt = st.num_valid * 8
    Z, Y, X = st.spatial_size
    up = make_sparse(locs_unfilt, feats_up, num_unfilt, (Z * 2, Y * 2, X * 2),
                     st.batch_size)
    up = CV.submanifold_conv3d(up, p["n1"], **kw)
    y, new["n2"] = bn(p["n2"], B.sub(s, "n2"), up.feats, up.valid())
    occ = _head(y, p["linear"])
    out = torch.cat([occ, _head(y, p["linearsdf"])], -1)
    keep = (torch.sigmoid(occ[:, 0]) > 0.5) & up.valid()
    nxt = [y] * cfg.pass_feats + [out.to(y.dtype)] * cfg.pass_occ
    (nl, nf), num, overflow = C.compact(keep, (up.locs, torch.cat(nxt, -1)),
                                        out_capacity)
    return (make_sparse(nl, nf, num, up.spatial_size, up.batch_size),
            (up.locs, out, num_unfilt), overflow, new)


def surface_pred_apply(p: dict, s, st: SparseTensor, *, bn, backend: str,
                       impl: str | None = None):
    """The surface head's sdf [cap, 1] f32 and its new stats."""
    kw = dict(backend=backend, impl=impl)
    nbr = CV.neighbours(st, backend)
    new = {}
    x = CV.submanifold_conv3d(st, p["p1"], nbr=nbr, **kw)
    x, new["p2"] = B.sparse_unet_apply(p["p2"], B.sub(s, "p2"), x, bn=bn,
                                       nbr=nbr, **kw)
    y, new["p3"] = bn(p["p3"], B.sub(s, "p3"), x.feats, x.valid())
    return _head(y, p["linear"]), new


def concat_skip(skip: SparseTensor, x: SparseTensor) -> SparseTensor:
    """Appends the skip's features at the shared sites, zeros elsewhere."""
    keys = C.flat_key(x.locs, skip.spatial_size, skip.batch_size)
    rows = C.lookup(keys, skip.index_grid()).long()
    table = torch.cat([skip.feats.new_zeros(1, skip.num_channels),
                       skip.masked_feats()])
    extra = torch.where(x.valid()[:, None], table[rows], 0)
    return x.with_feats(torch.cat([x.feats, extra], -1))


@dataclasses.dataclass
class GenModelOutput:
    """coarse_out: dense [B, Z8, Y8, X8, 2] f32 (occ logit, sdf);
    refine_outs: per active refinement level (locs_unfilt [cap, 4], out
    [cap, 2] f32, num_valid) before the occupancy pruning; surf_locs [cap,
    4], surf_sdf [cap, 1] f32, surf_num_valid: the surface (zeros and 0
    without the surface head); overflows: rows each level's compaction
    dropped; level_active: active rows per level, coarse to fine (the last
    is the surface's)."""
    coarse_out: torch.Tensor
    refine_outs: list
    surf_locs: torch.Tensor
    surf_sdf: torch.Tensor
    surf_num_valid: int
    overflows: list
    level_active: list


def genmodel_apply(tree: dict, stats, cfg: SGNNConfig, st: SparseTensor, *,
                   trunk, bn, num_refine_active: int | None = None,
                   do_surf: bool = True, impl: str | None = None):
    """The forward (sgnn.py:361-442): ``tree``/``stats`` the sparse levels'
    subtrees (``process_sparse``, ``refinement``, ``surfacepred``; stats
    None for a prepared tree), ``trunk`` and ``bn`` as in
    ``tsdf_encoder_apply`` and nn/blocks.py. The first
    ``num_refine_active`` refinement levels run (all by default), the
    surface head with ``do_surf`` once all do. Returns (GenModelOutput,
    new stats in the JAX tree's layout; an inactive level keeps its
    stats)."""
    backend = cfg.conv_backend
    CV._check_backend(backend)
    L_ref = cfg.num_refine_levels
    n_active = L_ref if num_refine_active is None else num_refine_active
    dt = getattr(torch, cfg.compute_dtype)
    st = st.with_feats(st.feats.to(dt))
    kw = dict(bn=bn, backend=backend, impl=impl)
    x_dense, coarse_out, skips, s_enc = tsdf_encoder_apply(
        tree, stats, st, trunk=trunk, **kw)

    keep = torch.sigmoid(coarse_out[..., 0]) > 0.5
    feats = ([coarse_out.to(dt)] * cfg.pass_occ
             + [x_dense] * cfg.pass_feats)
    caps = cfg.level_capacities
    x = dense_to_sparse(torch.cat(feats, -1), keep, caps[0])
    refine_outs, overflows, active = [], [], [x.num_valid]
    new_ref = list(B.sub(stats, "refinement") or [None] * L_ref)
    for h in range(n_active):
        if cfg.use_skip_sparse:
            x = concat_skip(skips[L_ref - h], x)
        cap_next = caps[min(h + 1, cfg.num_hierarchy_levels - 1)]
        x, out_h, ovf, new_ref[h] = refinement_apply(
            tree["refinement"][h], None if stats is None
            else stats["refinement"][h], cfg, x, out_capacity=cap_next, **kw)
        refine_outs.append(out_h)
        overflows.append(ovf)
        active.append(x.num_valid)

    surf_locs, surf_num = x.locs, x.num_valid
    if do_surf and n_active == L_ref:
        if cfg.use_skip_sparse:
            x = concat_skip(skips[0], x)
        surf_sdf, new_surf = surface_pred_apply(
            tree["surfacepred"], B.sub(stats, "surfacepred"), x, **kw)
    else:
        surf_sdf = torch.zeros(x.capacity, 1, device=x.feats.device)
        surf_num, new_surf = 0, B.sub(stats, "surfacepred")
    new = {"encoder": s_enc, "refinement": new_ref, "surfacepred": new_surf}
    return GenModelOutput(coarse_out, refine_outs, surf_locs, surf_sdf,
                          surf_num, overflows, active), new


def genmodel_apply_train(params: dict, stats: dict, cfg: SGNNConfig,
                         st: SparseTensor, *, num_refine_active: int,
                         do_surf: bool, training: bool = True,
                         impl: str | None = None, group=None):
    """``genmodel_apply`` over the JAX tree's parameter tensors (batch
    moments when ``training``, summed over the ranks of ``group``, the
    data-parallel group, at every BN as ``axis_name`` there; the running
    stats else). Returns (GenModelOutput, new stats)."""
    def trunk(x):
        return dense_trunk_train(params["encoder"], stats["encoder"], cfg, x,
                                 training=training, group=group)
    return genmodel_apply(
        sparse_levels(params), sparse_levels(stats), cfg, st, trunk=trunk,
        bn=functools.partial(BN.batch_norm, training=training, group=group),
        num_refine_active=num_refine_active, do_surf=do_surf, impl=impl)


class GenModelSparse(EvalModel):
    """The coordinate-list serving forward of a SparseTensor of input
    rows (its capacity is the config's ``input_cap`` at its volume, as the
    JAX inferencer builds it)."""

    @torch.no_grad()
    def forward(self, st: SparseTensor, impl: str | None = None
                ) -> GenModelOutput:
        return genmodel_apply(self.weights.tree(), None, self.scene_cfg(st),
                              st, trunk=self.trunk_fn, bn=B.prepared_bn,
                              impl=impl)[0]


class GenModelSparseTrain(TrainModel):
    """The trainable coordinate-list model (``genmodel_apply_train``)."""

    EXECUTION = "sparse"

    def forward(self, st: SparseTensor, *, num_refine_active: int,
                do_surf: bool, training: bool = True,
                impl: str | None = None, group=None):
        return genmodel_apply_train(
            self.param_tree(), self.stat_tree(), self.cfg, st,
            num_refine_active=num_refine_active, do_surf=do_surf,
            training=training, impl=impl, group=group)
