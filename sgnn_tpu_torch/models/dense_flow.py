"""The dense-flow execution (port of ``sgnn_tpu/models/dense_flow.py``).

- The coarse dense trunk at 1/8 resolution (``dense_trunk`` :328 and
  ``models/sgnn.py:94`` ``_dense_cbr``): a small conv / transposed-conv
  U-Net over the encoder's last level, then the occupancy and SDF heads.
  ``DenseTrunk`` serves with prepared eval constants; ``dense_trunk_train``
  is the same trunk over parameter tensors, with batch-moment BN when
  training. Every execution of the port shares it.
- The eval forward of ``genmodel_apply_dense`` (:390-596),
  ``GenModelDense``: every level is a masked dense channels-last grid
  ``[B, Z, Y, X, C]`` with a bool mask ``[B, Z, Y, X]``; submanifold
  convs are dense convs times the mask, strided convs max-pool the mask,
  the generative upsample is a transposed conv, pruning ands the mask
  with the occupancy gate. Concatenations stay virtual: activations are
  lists of channel groups, and each consumer splits its weights per
  group. With ``cfg.use_pallas_conv`` every eligible 3^3 conv (volume
  >= ``cfg.pallas_min_voxels``, shapes ``conv3d_3x3x3_folded`` supports)
  runs K8, exactly where the JAX package routes its Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.nn.blocks import PreparedTree
from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops import dense as D
from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl
from sgnn_tpu_torch.ops.sparse import SparseTensor, sparse_to_dense


def trunk_layers(cfg: SGNNConfig) -> list:
    """(name, cin, cout, kernel, stride, padding, transpose) per layer."""
    nf = cfg.nf_per_level[-1]
    nf0, nf1 = nf * 3 // 2, nf * 2
    nf2 = nf1
    nf3 = nf1 + nf2 if cfg.use_skip_dense else nf2
    nf4 = nf3 // 2
    nf4_in = nf4 + nf0 if cfg.use_skip_dense else nf4
    nf5 = nf4_in // 2
    return [
        ("encode_dense0", nf, nf0, 4, 2, 1, False),
        ("encode_dense1", nf0, nf1, 4, 2, 1, False),
        ("bottleneck_dense2", nf1, nf2, 1, 1, 0, False),
        ("decode_dense3", nf3, nf4, 4, 2, 1, True),
        ("decode_dense4", nf4_in, nf5, 4, 2, 1, True),
        ("final", nf5, cfg.nf_coarse, 1, 1, 0, False),
    ]


def _rounded(a, dtype: torch.dtype) -> torch.Tensor:
    """A weight array as f32 holding values rounded to the compute type."""
    return torch.tensor(np.asarray(a, np.float32)).to(dtype).float()


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 padding: int, transpose: bool):
        super().__init__()
        self.stride, self.padding, self.transpose = stride, padding, transpose
        shape = (cin, cout, k, k, k) if transpose else (cout, cin, k, k, k)
        self.register_buffer("w", torch.zeros(shape))
        for name in ("mean", "inv", "bias"):
            self.register_buffer(name, torch.zeros(cout))

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.w.copy_(_rounded(p["conv"], dtype))
        for buf, v in zip((self.mean, self.inv, self.bias),
                          BN.eval_constants(p["bn"], s["bn"])):
            buf.copy_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = D.conv_transpose3d if self.transpose else D.conv3d
        y = conv(x, self.w, stride=self.stride, padding=self.padding)
        return BN.batch_norm_eval(y, self.mean, self.inv, self.bias)


class DenseTrunk(nn.Module):
    """Returns (features y [B, Z8, Y8, X8, nf_coarse] in the compute type,
    coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf))."""

    def __init__(self, cfg: SGNNConfig):
        super().__init__()
        self.skip = cfg.use_skip_dense
        self.layers = nn.ModuleDict({
            name: ConvBNReLU(cin, cout, k, s, p, tr)
            for name, cin, cout, k, s, p, tr in trunk_layers(cfg)
        })
        self.register_buffer("occ_w", torch.zeros(1, cfg.nf_coarse, 1, 1, 1))
        self.register_buffer("sdf_w", torch.zeros(1, cfg.nf_coarse, 1, 1, 1))

    def load(self, enc_p: dict, enc_s: dict, dtype: torch.dtype) -> None:
        for name, layer in self.layers.items():
            layer.load(enc_p[name], enc_s[name], dtype)
        self.occ_w.copy_(_rounded(enc_p["occpred"], dtype))
        self.sdf_w.copy_(_rounded(enc_p["sdfpred"], dtype))

    def forward(self, x: torch.Tensor):
        L = self.layers
        enc0 = L["encode_dense0"](x)
        enc1 = L["encode_dense1"](enc0)
        bott = L["bottleneck_dense2"](enc1)
        dec_in = torch.cat([bott, enc1], -1) if self.skip else bott
        dec0 = L["decode_dense3"](dec_in)
        dec_in = torch.cat([dec0, enc0], -1) if self.skip else dec0
        y = L["final"](L["decode_dense4"](dec_in))
        occ = D.conv3d(y, self.occ_w)
        sdf = D.conv3d(y, self.sdf_w)
        return y, torch.cat([occ, sdf], -1).float()


def dense_trunk_train(enc_p: dict, enc_s: dict, cfg: SGNNConfig,
                      x: torch.Tensor, *, training: bool):
    """dense_trunk(training=...) over the encoder's parameter tensors:
    returns (features y, coarse_out f32, new stats of the trunk's BNs).
    Weights are rounded to x's type, as ``w.astype(x.dtype)`` does."""
    dt = x.dtype
    layers = {name: (stride, pad, tr)
              for name, _, _, _, stride, pad, tr in trunk_layers(cfg)}
    s = {}

    def cbr(name, inp):
        stride, pad, tr = layers[name]
        conv = D.conv_transpose3d if tr else D.conv3d
        y = conv(inp, enc_p[name]["conv"].to(dt).float(), stride=stride,
                 padding=pad)
        y, bn_s = BN.batch_norm_dense(enc_p[name]["bn"], enc_s[name]["bn"],
                                      y, training=training)
        s[name] = {"bn": bn_s}
        return y

    skip = cfg.use_skip_dense
    enc0 = cbr("encode_dense0", x)
    enc1 = cbr("encode_dense1", enc0)
    bott = cbr("bottleneck_dense2", enc1)
    dec0 = cbr("decode_dense3", torch.cat([bott, enc1], -1) if skip else bott)
    y = cbr("decode_dense4", torch.cat([dec0, enc0], -1) if skip else dec0)
    y = cbr("final", y)
    occ = D.conv3d(y, enc_p["occpred"].to(dt).float())
    sdf = D.conv3d(y, enc_p["sdfpred"].to(dt).float())
    return y, torch.cat([occ, sdf], -1).float(), s


# ------------------------------------------------- the dense-flow forward
#
# A "groups" value is a list of [B, Z, Y, X, C_i] grids sharing one mask:
# the virtual concatenation along channels. Parameters are a prepared
# tree (ops/bn.prepare_eval_tree): f32 weights, BN eval constants.


def _pallas_ok(grid: torch.Tensor, weight: torch.Tensor, min_voxels: int
               ) -> bool:
    """K8 routing (dense_flow.py:71-82): on (``min_voxels`` > 0), a
    volume of at least ``min_voxels`` and shapes K8 supports."""
    if not min_voxels:
        return False
    B, Z, Y, X, _ = grid.shape
    return Z * Y * X >= min_voxels and K_cl.supported(grid.shape,
                                                       weight.shape)


def _conv_one(grid, weight, filter_size, use_pallas, impl):
    """Dense f^3 conv (zero padding) of one group, weight [f^3, C, Cout],
    in the grid's type: K8 where routed, else the plain conv."""
    if filter_size == 3 and _pallas_ok(grid, weight, use_pallas):
        return K_cl.conv3d_3x3x3_folded(grid, weight, impl=impl)
    k = filter_size
    w = weight.to(grid.dtype).float().reshape(k, k, k, *weight.shape[1:])
    return D.conv3d(grid, w.permute(4, 3, 0, 1, 2), padding=(k - 1) // 2)


def _subm_conv(groups, mask, weight, use_pallas=0, impl=None,
               filter_size=3):
    """Per-group convs summed in the compute type, then masked: weight
    [K, sum(C_i), Cout] -> one grid."""
    if weight.shape[1] != sum(g.shape[-1] for g in groups):
        raise ValueError(f"conv Cin {weight.shape[1]} != groups "
                         f"{[g.shape[-1] for g in groups]}")
    y, off = None, 0
    for g in groups:
        c = g.shape[-1]
        yi = _conv_one(g, weight[:, off:off + c], filter_size, use_pallas,
                       impl)
        y = yi if y is None else y + yi
        off += c
    return y * mask[..., None].to(y.dtype)


def _strided_conv(groups, mask, weight):
    """Stride-2 2^3 conv; the new mask is any active child."""
    y, off = None, 0
    cout = weight.shape[-1]
    for g in groups:
        c = g.shape[-1]
        w = weight[:, off:off + c].to(g.dtype).float().reshape(
            2, 2, 2, c, cout)
        yi = D.conv3d(g, w.permute(4, 3, 0, 1, 2), stride=2)
        y = yi if y is None else y + yi
        off += c
    new_mask = D.max_pool3d(mask.float()) > 0
    return y * new_mask[..., None].to(y.dtype), new_mask


def _upsampled_conv(groups, weight27):
    """Fused [2x NN upsample -> 3^3 conv] per group, summed."""
    y, off = None, 0
    for g in groups:
        c = g.shape[-1]
        yi = D.upsampled_conv3d(g, weight27[:, off:off + c])
        y = yi if y is None else y + yi
        off += c
    return y


def _linear(groups, p):
    """concat(groups) @ W + b per group: each group's product rounded to
    its type, then summed in f32 (dense_flow.py:181)."""
    acc, off = None, 0
    for g in groups:
        c = g.shape[-1]
        w = p["weight"][off:off + c].to(g.dtype).float()
        yi = (g.float() @ w).to(g.dtype).float()
        acc = yi if acc is None else acc + yi
        off += c
    return acc + p["bias"]


def _mask_bn(p, groups, mask):
    """Masked eval BN + ReLU per group over the group's channel slice."""
    outs, off = [], 0
    for g in groups:
        c = g.shape[-1]
        outs.append(BN.batch_norm_rows(g, mask, p["mean"][off:off + c],
                                       p["inv"][off:off + c],
                                       p["bias"][off:off + c]))
        off += c
    return outs


def _upsample2(grid):
    """2x nearest-neighbour upsample of the z, y, x axes."""
    for ax in (1, 2, 3):
        grid = grid.repeat_interleave(2, dim=ax)
    return grid


def _resblock(p, grid, mask, use_pallas, impl):
    y = _mask_bn(p["bn0"], [grid], mask)
    y = _subm_conv(y, mask, p["conv0"], use_pallas, impl)
    y = _mask_bn(p["bn1"], [y], mask)
    y = _subm_conv(y, mask, p["conv1"], use_pallas, impl)
    return grid + y


def _unet(p, groups, mask, use_pallas, impl):
    """FullyConvolutionalNet (reps=1, residual): returns the groups [x,
    up(deeper)...] at this resolution."""
    x = groups[0] if len(groups) == 1 else torch.cat(groups, -1)
    x = _resblock(p["block"], x, mask, use_pallas, impl)
    if "deeper" not in p:
        return [x]
    y = _mask_bn(p["down_bn"], [x], mask)
    down, down_mask = _strided_conv(y, mask, p["down_conv"])
    deep = _unet(p["deeper"], [down], down_mask, use_pallas, impl)
    m = mask[..., None]
    return [x, *[_upsample2(d) * m.to(d.dtype) for d in deep]]


def _encoder_layer(p, groups, mask, use_pallas, impl):
    """Returns (the downsampled grid, its mask, (the skip ft2, its
    mask))."""
    x = _subm_conv(groups, mask, p["p1"], use_pallas, impl)
    x = _resblock(p["p2"], x, mask, use_pallas, impl)
    y = _mask_bn(p["p2_bn"], [x], mask)
    down, down_mask = _strided_conv(y, mask, p["p3"])
    z = _mask_bn(p["p3_bn"], [down], down_mask)
    return z[0], down_mask, (y[0], mask)


@dataclasses.dataclass
class DenseFlowOutput:
    """coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf); refine_outs:
    per level [B, z, y, x, 2] f32 at the unpruned upsampled sites;
    refine_masks_unfilt: per level [B, z, y, x] bool, those sites;
    surf_sdf [B, Z, Y, X] f32; surf_mask [B, Z, Y, X] bool; level_active:
    active voxels per level, coarse to fine (0-d tensors; the last is the
    surface's)."""
    coarse_out: torch.Tensor
    refine_outs: list
    refine_masks_unfilt: list
    surf_sdf: torch.Tensor
    surf_mask: torch.Tensor
    level_active: list


def genmodel_apply_dense(tree: dict, trunk: DenseTrunk, cfg: SGNNConfig,
                         st: SparseTensor, *, impl: str | None = None
                         ) -> DenseFlowOutput:
    """The eval forward of every level and the surface head
    (dense_flow.py:390-596 with training=False, num_refine_active = all,
    do_surf=True, no spatial sharding). ``tree``: the prepared
    ``process_sparse`` / ``refinement`` / ``surfacepred`` subtrees."""
    use_pallas = (max(1, int(cfg.pallas_min_voxels))
                  if cfg.use_pallas_conv else 0)
    dt = getattr(torch, cfg.compute_dtype)
    B = st.batch_size
    Z, Y, X = st.spatial_size
    grid = sparse_to_dense(st).to(dt)
    keys = C.flat_key(st.locs, st.spatial_size, B).long()
    mask = torch.zeros(B * Z * Y * X, dtype=torch.bool,
                       device=st.locs.device)
    mask[keys[st.valid() & (keys >= 0)]] = True
    mask = mask.reshape(B, Z, Y, X)

    skips = []
    x, m = grid, mask
    for p in tree["process_sparse"]:
        x, m, ft2 = _encoder_layer(p, [x], m, use_pallas, impl)
        skips.append(ft2)
    skips.append((x, m))

    y, coarse_out = trunk(x)
    cur_mask = torch.sigmoid(coarse_out[..., 0]) > 0.5
    cmf = cur_mask[..., None].to(dt)
    cur = ([coarse_out.to(dt) * cmf] * cfg.pass_occ
           + [y * cmf] * cfg.pass_feats)
    active = [cur_mask.sum()]

    L_ref = cfg.num_refine_levels
    ref_outs, ref_masks = [], []
    for h, p in enumerate(tree["refinement"]):
        if cfg.use_skip_sparse:
            sk = skips[L_ref - h][0]
            cur = [*cur, sk * cur_mask[..., None].to(sk.dtype)]
        z = _subm_conv(cur, cur_mask, p["p1"], use_pallas, impl)
        z = _unet(p["p2"], [z], cur_mask, use_pallas, impl)
        z = _mask_bn(p["p3"], z, cur_mask)
        mask_unfilt = _upsample2(cur_mask)
        up = _upsampled_conv(z, p["n1"])
        up = up * mask_unfilt[..., None].to(up.dtype)
        up = _mask_bn(p["n2"], [up], mask_unfilt)[0]
        occ = _linear([up], p["linear"])
        out_h = torch.cat([occ, _linear([up], p["linearsdf"])], -1)
        cur_mask = mask_unfilt & (torch.sigmoid(occ[..., 0]) > 0.5)
        nmf = cur_mask[..., None].to(dt)
        cur = ([up * nmf] * cfg.pass_feats
               + [out_h.to(dt) * nmf] * cfg.pass_occ)
        ref_outs.append(out_h)
        ref_masks.append(mask_unfilt)
        active.append(cur_mask.sum())

    p = tree["surfacepred"]
    if cfg.use_skip_sparse:
        sk = skips[0][0]
        cur = [*cur, sk * cur_mask[..., None].to(sk.dtype)]
    z = _subm_conv(cur, cur_mask, p["p1"], use_pallas, impl)
    z = _unet(p["p2"], [z], cur_mask, use_pallas, impl)
    z = _mask_bn(p["p3"], z, cur_mask)
    surf = _linear(z, p["linear"])[..., 0]
    return DenseFlowOutput(coarse_out, ref_outs, ref_masks, surf, cur_mask,
                           active)


def sparse_levels_tree(params: dict, stats: dict) -> dict:
    """The prepared subtrees of the sparse levels (BN eps 1e-4): the
    encoder's process_sparse, the refinements and the surface head."""
    sel = [{"process_sparse": t["encoder"]["process_sparse"],
            "refinement": t["refinement"], "surfacepred": t["surfacepred"]}
           for t in (params, stats)]
    return BN.prepare_eval_tree(*sel)


class EvalModel(nn.Module):
    """The dense trunk plus the prepared sparse-level tree, filled by
    ``load`` (``params.load_jax_params``) and moved with ``.to``."""

    def __init__(self, cfg: SGNNConfig):
        from sgnn_tpu_torch.params import init_params

        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.trunk = DenseTrunk(cfg)
        self.weights = PreparedTree(sparse_levels_tree(*init_params(cfg)))

    def load(self, params: dict, stats: dict) -> None:
        self.trunk.load(params["encoder"], stats["encoder"], self.dtype)
        self.weights.load(sparse_levels_tree(params, stats))

    def scene_cfg(self, st: SparseTensor) -> SGNNConfig:
        """The config at ``st``'s volume and batch (raises for dims the
        model cannot take)."""
        return dataclasses.replace(self.cfg, input_dim=st.spatial_size,
                                   batch_size=st.batch_size)


class GenModelDense(EvalModel):
    """The dense-flow serving forward of a SparseTensor of input rows."""

    @torch.no_grad()
    def forward(self, st: SparseTensor, impl: str | None = None
                ) -> DenseFlowOutput:
        return genmodel_apply_dense(self.weights.tree(), self.trunk,
                                    self.scene_cfg(st), st, impl=impl)
