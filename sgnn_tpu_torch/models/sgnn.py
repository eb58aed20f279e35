"""The coordinate-list execution of GenModel (port of
``sgnn_tpu/models/sgnn.py``, the eval forward): a sparse encoder over
fixed-capacity coordinate lists, the dense trunk at 1/8 resolution, the
generative refinement levels (sparse U-Net -> 2x voxel upsample ->
occupancy-gated compaction into the next level's capacity) and the
surface head.

The repo's test oracle. Its capacities are part of what it computes: rows
beyond a capacity are dropped as the JAX package drops them, and
``GenModelOutput.overflows`` counts them. Every sparse conv goes through
``ops/conv.py`` with the config's ``conv_backend`` (``"gather"``: K10 on
the card; ``"dense"``: cuDNN convs over densified grids).

Feature concatenation orders follow the reference (sgnn.py:20-24):
  * coarse -> refine 0: [occ(2) | coarse_feats(nf_coarse)]
  * refine h -> h+1:    [x(nf) | occ(2)]
  * concat_skip appends the encoder's skip features last.
"""

from __future__ import annotations

import dataclasses

import torch

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import DenseTrunk, EvalModel
from sgnn_tpu_torch.nn import blocks as B
from sgnn_tpu_torch.ops import conv as CV
from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops.sparse import (SparseTensor, dense_to_sparse,
                                       make_sparse, sparse_to_dense)


def tsdf_encoder_apply(tree: dict, trunk: DenseTrunk, st: SparseTensor, *,
                       backend: str, impl: str | None = None):
    """Returns (dense feats [B, Z8, Y8, X8, nf_coarse], coarse_out [...,
    2] f32 (occ, sdf), the sparse skips ft2 per level and then ft3)."""
    skips, x = [], st
    for p in tree["process_sparse"]:
        x, ft2 = B.encoder_layer_apply(p, x, out_capacity=x.capacity,
                                       backend=backend, impl=impl)
        skips.append(ft2)
    skips.append(x)
    y, coarse_out = trunk(sparse_to_dense(x))
    return y, coarse_out, skips


def _head(y: torch.Tensor, p: dict) -> torch.Tensor:
    """y @ W + b in f32 (the compute-type rows promote to f32 there)."""
    return y.float() @ p["weight"] + p["bias"]


def refinement_apply(p: dict, cfg: SGNNConfig, st: SparseTensor, *,
                     out_capacity: int, backend: str,
                     impl: str | None = None):
    """One generative level. Returns (the pruned SparseTensor at 2x
    resolution, (locs_unfilt, out [occ, sdf], num_unfilt), overflow)."""
    kw = dict(backend=backend, impl=impl)
    x = CV.submanifold_conv3d(st, p["p1"], **kw)
    x = B.sparse_unet_apply(p["p2"], x, **kw)
    y = B.bn_relu(p["p3"], x.feats, x.valid())
    locs_unfilt, feats_up = C.upsample_locs_x2(st.locs, y)
    num_unfilt = st.num_valid * 8
    Z, Y, X = st.spatial_size
    up = make_sparse(locs_unfilt, feats_up, num_unfilt, (Z * 2, Y * 2, X * 2),
                     st.batch_size)
    up = CV.submanifold_conv3d(up, p["n1"], **kw)
    y = B.bn_relu(p["n2"], up.feats, up.valid())
    occ = _head(y, p["linear"])
    out = torch.cat([occ, _head(y, p["linearsdf"])], -1)
    keep = (torch.sigmoid(occ[:, 0]) > 0.5) & up.valid()
    nxt = [y] * cfg.pass_feats + [out.to(y.dtype)] * cfg.pass_occ
    (nl, nf), num, overflow = C.compact(keep, (up.locs, torch.cat(nxt, -1)),
                                        out_capacity)
    return (make_sparse(nl, nf, num, up.spatial_size, up.batch_size),
            (up.locs, out, num_unfilt), overflow)


def surface_pred_apply(p: dict, st: SparseTensor, *, backend: str,
                       impl: str | None = None) -> torch.Tensor:
    """The surface head's sdf [cap, 1] f32."""
    x = CV.submanifold_conv3d(st, p["p1"], backend=backend, impl=impl)
    x = B.sparse_unet_apply(p["p2"], x, backend=backend, impl=impl)
    return _head(B.bn_relu(p["p3"], x.feats, x.valid()), p["linear"])


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
    refine_outs: per refinement level (locs_unfilt [cap, 4], out [cap, 2]
    f32, num_valid) before the occupancy pruning; surf_locs [cap, 4],
    surf_sdf [cap, 1] f32, surf_num_valid: the surface; overflows: rows
    each level's compaction dropped; level_active: active rows per level,
    coarse to fine (the last is the surface's)."""
    coarse_out: torch.Tensor
    refine_outs: list
    surf_locs: torch.Tensor
    surf_sdf: torch.Tensor
    surf_num_valid: int
    overflows: list
    level_active: list


def genmodel_apply(tree: dict, trunk: DenseTrunk, cfg: SGNNConfig,
                   st: SparseTensor, *, impl: str | None = None
                   ) -> GenModelOutput:
    """The eval forward with every refinement level and the surface head
    (sgnn.py:361 with training=False, num_refine_active = all,
    do_surf=True). ``tree``: the prepared sparse-level subtrees
    (models/dense_flow.sparse_levels_tree)."""
    backend = cfg.conv_backend
    CV._check_backend(backend)
    dt = getattr(torch, cfg.compute_dtype)
    st = st.with_feats(st.feats.to(dt))
    kw = dict(backend=backend, impl=impl)
    x_dense, coarse_out, skips = tsdf_encoder_apply(tree, trunk, st, **kw)

    keep = torch.sigmoid(coarse_out[..., 0]) > 0.5
    feats = ([coarse_out.to(dt)] * cfg.pass_occ
             + [x_dense] * cfg.pass_feats)
    caps = cfg.level_capacities
    x = dense_to_sparse(torch.cat(feats, -1), keep, caps[0])
    refine_outs, overflows, active = [], [], [x.num_valid]
    L_ref = cfg.num_refine_levels
    for h, p in enumerate(tree["refinement"]):
        if cfg.use_skip_sparse:
            x = concat_skip(skips[L_ref - h], x)
        cap_next = caps[min(h + 1, cfg.num_hierarchy_levels - 1)]
        x, out_h, ovf = refinement_apply(p, cfg, x, out_capacity=cap_next,
                                         **kw)
        refine_outs.append(out_h)
        overflows.append(ovf)
        active.append(x.num_valid)

    surf_locs, surf_num = x.locs, x.num_valid
    if cfg.use_skip_sparse:
        x = concat_skip(skips[0], x)
    surf_sdf = surface_pred_apply(tree["surfacepred"], x, **kw)
    return GenModelOutput(coarse_out, refine_outs, surf_locs, surf_sdf,
                          surf_num, overflows, active)


class GenModelSparse(EvalModel):
    """The coordinate-list serving forward of a SparseTensor of input
    rows (its capacity is the config's ``input_cap`` at its volume, as the
    JAX inferencer builds it)."""

    @torch.no_grad()
    def forward(self, st: SparseTensor, impl: str | None = None
                ) -> GenModelOutput:
        return genmodel_apply(self.weights.tree(), self.trunk,
                              self.scene_cfg(st), st, impl=impl)
