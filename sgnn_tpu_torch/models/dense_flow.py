"""The dense-flow execution (port of ``sgnn_tpu/models/dense_flow.py``).

- The coarse dense trunk at 1/8 resolution (``dense_trunk`` :328 and
  ``models/sgnn.py:94`` ``_dense_cbr``): a small conv / transposed-conv
  U-Net over the encoder's last level, then the occupancy and SDF heads.
  ``DenseTrunk`` serves with prepared eval constants; ``dense_trunk_train``
  is the same trunk over parameter tensors, with batch-moment BN when
  training. Every execution of the port shares it.
- ``genmodel_apply_dense`` (:390-596), served by ``GenModelDense`` and
  trained by ``GenModelDenseTrain`` (batch moments, no K8 under training,
  as the JAX package has it): every level is a masked dense channels-last grid
  ``[B, Z, Y, X, C]`` with a bool mask ``[B, Z, Y, X]``; submanifold
  convs are dense convs times the mask, strided convs max-pool the mask,
  the generative upsample is a transposed conv, pruning ands the mask
  with the occupancy gate. Concatenations stay virtual: activations are
  lists of channel groups, and each consumer splits its weights per
  group. With ``cfg.use_pallas_conv`` every eligible 3^3 conv of the eval
  forward (volume >= ``cfg.pallas_min_voxels``, shapes
  ``conv3d_3x3x3_folded`` supports) runs K8, exactly where the JAX
  package routes its Pallas kernel. With ``space`` (a process group) the
  scene's z is sharded over ranks (``sp_axis`` there): each rank scatters
  its slab, 3^3 and upsampled convs exchange one boundary plane with each
  neighbour and run as plain convs, the trunk runs on the gathered grid
  (``sharded_trunk``), and BN moments are summed over the data and space
  groups (the trunk's over the data group).
- ``EvalModel`` and ``TrainModel``, the serving and the trainable models'
  bases, which every execution shares.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.nn.blocks import PreparedTree, prepared_bn, sub
from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops import dense as D
from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl
from sgnn_tpu_torch.ops.sparse import SparseTensor, sparse_to_dense
from sgnn_tpu_torch.parallel import comm
from sgnn_tpu_torch.parallel.spatial import halo_exchange


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
                      x: torch.Tensor, *, training: bool, group=None):
    """dense_trunk(training=...) over the encoder's parameter tensors:
    returns (features y, coarse_out f32, new stats of the trunk's BNs).
    Weights are rounded to x's type, as ``w.astype(x.dtype)`` does.
    ``group``: the data group the BN moments are summed over (never the
    space group: ``sharded_trunk``)."""
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
                                      y, training=training, group=group)
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


def sharded_trunk(trunk, x: torch.Tensor, space):
    """``trunk(x) -> (y, coarse_out, stats)`` of a z-sharded 1/8-res grid
    (dense_trunk's ``sp_axis``, :338-386): the slabs are all-gathered over
    the space group, the trunk runs replicated on the whole grid and each
    rank keeps its own slab of y and coarse_out. The trunk's BN reduces
    over the data group only: the gathered grid is already whole in z, and
    a space all-reduce would count every voxel n times (:338-342)."""
    if comm.size(space) == 1:
        return trunk(x)
    zl, i = x.shape[1], comm.index(space)
    y, coarse_out, s = trunk(comm.all_gather(x, space, 1))
    return (y.narrow(1, i * zl, zl).contiguous(),
            coarse_out.narrow(1, i * zl, zl).contiguous(), s)


# ------------------------------------------------- the dense-flow forward
#
# A "groups" value is a list of [B, Z, Y, X, C_i] grids sharing one mask:
# the virtual concatenation along channels. Parameters are a prepared
# tree (ops/bn.prepare_eval_tree: f32 weights, BN eval constants, stats
# None) with ``bn = prepared_bn``, or parameter tensors with
# ``ops/bn.batch_norm`` (nn/blocks.py); every block returns its new stats.


def _pallas_ok(grid: torch.Tensor, weight: torch.Tensor, min_voxels: int
               ) -> bool:
    """K8 routing (dense_flow.py:71-82): on (``min_voxels`` > 0), a
    volume of at least ``min_voxels`` and shapes K8 supports."""
    if not min_voxels:
        return False
    B, Z, Y, X, _ = grid.shape
    return Z * Y * X >= min_voxels and K_cl.supported(grid.shape,
                                                       weight.shape)


def _conv_one(grid, weight, filter_size, use_pallas, impl, space=None):
    """Dense f^3 conv (zero padding) of one group, weight [f^3, C, Cout],
    in the grid's type: K8 where routed, else the plain conv. With
    ``space`` the grid is a z-slab: one boundary plane is exchanged with
    each neighbour and the conv runs unpadded in z, always as the plain
    conv (dense_flow.py:85-128: the JAX package takes XLA's conv there,
    never its kernel, which pads z with zeros itself)."""
    k = filter_size
    w = weight.to(grid.dtype).float().reshape(k, k, k, *weight.shape[1:])
    w = w.permute(4, 3, 0, 1, 2)
    if space is not None and k == 3:
        return D.conv3d(halo_exchange(grid, 1, space), w, padding=(0, 1, 1))
    if k == 3 and _pallas_ok(grid, weight, use_pallas):
        return K_cl.conv3d_3x3x3_folded(grid, weight, impl=impl)
    return D.conv3d(grid, w, padding=(k - 1) // 2)


def _subm_conv(groups, mask, weight, use_pallas=0, impl=None,
               filter_size=3, space=None):
    """Per-group convs summed in the compute type, then masked: weight
    [K, sum(C_i), Cout] -> one grid."""
    if weight.shape[1] != sum(g.shape[-1] for g in groups):
        raise ValueError(f"conv Cin {weight.shape[1]} != groups "
                         f"{[g.shape[-1] for g in groups]}")
    y, off = None, 0
    for g in groups:
        c = g.shape[-1]
        yi = _conv_one(g, weight[:, off:off + c], filter_size, use_pallas,
                       impl, space)
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


def _upsampled_conv(groups, weight27, space=None):
    """Fused [2x NN upsample -> 3^3 conv] per group, summed. With ``space``
    one coarse halo plane a side gives the two fine planes the conv needs
    across the slab boundary, and the halo's fine planes are cropped
    (:151-172)."""
    y, off = None, 0
    for g in groups:
        c = g.shape[-1]
        if space is not None:
            g = halo_exchange(g, 1, space)
        yi = D.upsampled_conv3d(g, weight27[:, off:off + c])
        if space is not None:
            yi = yi[:, 2:-2]
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


def _mask_bn(bn, p, s, groups, mask):
    """Masked BN + ReLU per group over the group's channel slice of the
    node's vectors (dense_flow.py:187-215). Returns (the groups, the new
    stats: the groups' slices concatenated; None for a prepared node)."""
    outs, parts, off = [], [], 0
    for g in groups:
        c = g.shape[-1]
        pg = {k: v[off:off + c] for k, v in p.items()}
        sg = None if s is None else {k: v[off:off + c] for k, v in s.items()}
        y, ns = bn(pg, sg, g, mask)
        outs.append(y)
        parts.append(ns)
        off += c
    if s is None:
        return outs, None
    return outs, {k: torch.cat([q[k] for q in parts]) for k in parts[0]}


def _upsample2(grid):
    """2x nearest-neighbour upsample of the z, y, x axes."""
    for ax in (1, 2, 3):
        grid = grid.repeat_interleave(2, dim=ax)
    return grid


def _resblock(p, s, grid, mask, bn, use_pallas, impl, space=None):
    new = {}
    y, new["bn0"] = _mask_bn(bn, p["bn0"], sub(s, "bn0"), [grid], mask)
    y = _subm_conv(y, mask, p["conv0"], use_pallas, impl, space=space)
    y, new["bn1"] = _mask_bn(bn, p["bn1"], sub(s, "bn1"), [y], mask)
    y = _subm_conv(y, mask, p["conv1"], use_pallas, impl, space=space)
    return grid + y, new


def _unet(p, s, groups, mask, bn, use_pallas, impl, space=None):
    """FullyConvolutionalNet (reps=1, residual): returns (the groups [x,
    up(deeper)...] at this resolution, new stats)."""
    x = groups[0] if len(groups) == 1 else torch.cat(groups, -1)
    new = {}
    x, new["block"] = _resblock(p["block"], sub(s, "block"), x, mask, bn,
                                use_pallas, impl, space)
    if "deeper" not in p:
        return [x], new
    y, new["down_bn"] = _mask_bn(bn, p["down_bn"], sub(s, "down_bn"), [x],
                                 mask)
    down, down_mask = _strided_conv(y, mask, p["down_conv"])
    deep, new["deeper"] = _unet(p["deeper"], sub(s, "deeper"), [down],
                                down_mask, bn, use_pallas, impl, space)
    m = mask[..., None]
    return [x, *[_upsample2(d) * m.to(d.dtype) for d in deep]], new


def _encoder_layer(p, s, groups, mask, bn, use_pallas, impl, space=None):
    """Returns (the downsampled grid, its mask, (the skip ft2, its mask),
    new stats)."""
    new = {}
    x = _subm_conv(groups, mask, p["p1"], use_pallas, impl, space=space)
    x, new["p2"] = _resblock(p["p2"], sub(s, "p2"), x, mask, bn, use_pallas,
                             impl, space)
    y, new["p2_bn"] = _mask_bn(bn, p["p2_bn"], sub(s, "p2_bn"), [x], mask)
    down, down_mask = _strided_conv(y, mask, p["p3"])
    z, new["p3_bn"] = _mask_bn(bn, p["p3_bn"], sub(s, "p3_bn"), [down],
                               down_mask)
    return z[0], down_mask, (y[0], mask), new


def _refine_level(p, s, cfg, cur, cur_mask, bn, use_pallas, impl,
                  space=None):
    """One generative level (dense_flow.py:486-528): U-Net, the fused
    upsample conv, the heads and the pruned mask. Returns (the next groups,
    their mask, out [B, z, y, x, 2] f32, the unpruned mask, new stats)."""
    new = {}
    z = _subm_conv(cur, cur_mask, p["p1"], use_pallas, impl, space=space)
    z, new["p2"] = _unet(p["p2"], sub(s, "p2"), [z], cur_mask, bn,
                         use_pallas, impl, space)
    z, new["p3"] = _mask_bn(bn, p["p3"], sub(s, "p3"), z, cur_mask)
    mask_unfilt = _upsample2(cur_mask)
    up = _upsampled_conv(z, p["n1"], space)
    up = up * mask_unfilt[..., None].to(up.dtype)
    up, new["n2"] = _mask_bn(bn, p["n2"], sub(s, "n2"), [up], mask_unfilt)
    up = up[0]
    occ = _linear([up], p["linear"])
    out_h = torch.cat([occ, _linear([up], p["linearsdf"])], -1)
    new_mask = mask_unfilt & (torch.sigmoid(occ[..., 0]) > 0.5)
    nmf = new_mask[..., None].to(up.dtype)
    nxt = [up * nmf] * cfg.pass_feats + [out_h.to(up.dtype) * nmf] * \
        cfg.pass_occ
    return nxt, new_mask, out_h, mask_unfilt, new


@dataclasses.dataclass
class DenseFlowOutput:
    """coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf); refine_outs:
    per active level [B, z, y, x, 2] f32 at the unpruned upsampled sites;
    refine_masks_unfilt: per level [B, z, y, x] bool, those sites;
    surf_sdf [B, Z, Y, X] f32; surf_mask [B, Z, Y, X] bool (zeros without
    the surface head); level_active: active voxels per level, coarse to
    fine (0-d tensors; the last is the surface's)."""
    coarse_out: torch.Tensor
    refine_outs: list
    refine_masks_unfilt: list
    surf_sdf: torch.Tensor
    surf_mask: torch.Tensor
    level_active: list


def genmodel_apply_dense(tree: dict, stats, cfg: SGNNConfig,
                         st: SparseTensor, *, trunk, bn,
                         num_refine_active: int | None = None,
                         do_surf: bool = True, training: bool = False,
                         impl: str | None = None, space=None):
    """The dense-flow forward (dense_flow.py:390-596): ``tree``/``stats``
    the sparse levels' subtrees (``process_sparse``, ``refinement``,
    ``surfacepred``; stats None for a prepared tree), ``trunk(x) -> (y,
    coarse_out, its new stats)``, ``bn`` as in nn/blocks.py. The first
    ``num_refine_active`` refinement levels run (all by default), the
    surface head with ``do_surf`` once all do. With ``training`` no conv
    runs K8 (the JAX package turns its kernel off under training) and
    nothing is recomputed in the backward (no ``jax.checkpoint``).

    ``space``: a process group to shard the scene's z over (``sp_axis``).
    Every rank passes the whole ``st`` with ``st.spatial_size`` the GLOBAL
    dims, scatters its own z-slab, exchanges a boundary plane at each 3^3
    and upsampled conv (plain convs: no K8), runs the trunk replicated
    (``sharded_trunk``), and gets local z-slabs out. ``bn`` must then sum
    its moments over the space group too (and the data group), and
    ``trunk``'s over the data group only. Z must divide by 32 times the
    group's size. Returns (DenseFlowOutput, new stats in the JAX tree's
    layout; an inactive level keeps its stats)."""
    use_pallas = (max(1, int(cfg.pallas_min_voxels))
                  if cfg.use_pallas_conv and not training and space is None
                  else 0)
    dt = getattr(torch, cfg.compute_dtype)
    B = st.batch_size
    Z, Y, X = st.spatial_size
    n_sp = comm.size(space)
    if space is not None and Z % (32 * n_sp):
        raise ValueError(f"spatial sharding: Z={Z} must divide by 32*{n_sp} "
                         "so every strided conv sees an even local extent")
    zl = Z // n_sp
    if space is None:
        grid = sparse_to_dense(st).to(dt)
        keys = C.flat_key(st.locs, st.spatial_size, B).long()
        ok = st.valid() & (keys >= 0)
    else:
        lz = st.locs[:, 0].long() - comm.index(space) * zl
        ok = st.valid() & (lz >= 0) & (lz < zl)
        keys = ((st.locs[:, 3].long() * zl + lz) * Y
                + st.locs[:, 1].long()) * X + st.locs[:, 2].long()
        flat = torch.zeros(B * zl * Y * X, st.num_channels, dtype=dt,
                           device=st.locs.device)
        flat[keys[ok]] = st.feats[ok].to(dt)
        grid = flat.reshape(B, zl, Y, X, st.num_channels)
    mask = torch.zeros(B * zl * Y * X, dtype=torch.bool,
                       device=st.locs.device)
    mask[keys[ok]] = True
    mask = mask.reshape(B, zl, Y, X)

    skips, enc_s = [], []
    x, m = grid, mask
    for lvl, p in enumerate(tree["process_sparse"]):
        x, m, ft2, s_l = _encoder_layer(
            p, None if stats is None else stats["process_sparse"][lvl], [x],
            m, bn, use_pallas, impl, space)
        skips.append(ft2)
        enc_s.append(s_l)
    skips.append((x, m))

    y, coarse_out, s_trunk = sharded_trunk(trunk, x, space)
    cur_mask = torch.sigmoid(coarse_out[..., 0]) > 0.5
    cmf = cur_mask[..., None].to(dt)
    cur = ([coarse_out.to(dt) * cmf] * cfg.pass_occ
           + [y * cmf] * cfg.pass_feats)
    active = [cur_mask.sum()]

    L_ref = cfg.num_refine_levels
    n_active = L_ref if num_refine_active is None else num_refine_active
    ref_outs, ref_masks = [], []
    new_ref = list(sub(stats, "refinement") or [None] * L_ref)
    for h in range(n_active):
        if cfg.use_skip_sparse:
            sk = skips[L_ref - h][0]
            cur = [*cur, sk * cur_mask[..., None].to(sk.dtype)]
        cur, cur_mask, out_h, mask_unfilt, new_ref[h] = _refine_level(
            tree["refinement"][h], None if stats is None
            else stats["refinement"][h], cfg, cur, cur_mask, bn, use_pallas,
            impl, space)
        ref_outs.append(out_h)
        ref_masks.append(mask_unfilt)
        active.append(cur_mask.sum())

    if do_surf and n_active == L_ref:
        p, s_s = tree["surfacepred"], sub(stats, "surfacepred")
        if cfg.use_skip_sparse:
            sk = skips[0][0]
            cur = [*cur, sk * cur_mask[..., None].to(sk.dtype)]
        new_surf = {}
        z = _subm_conv(cur, cur_mask, p["p1"], use_pallas, impl,
                       space=space)
        z, new_surf["p2"] = _unet(p["p2"], sub(s_s, "p2"), [z], cur_mask, bn,
                                  use_pallas, impl, space)
        z, new_surf["p3"] = _mask_bn(bn, p["p3"], sub(s_s, "p3"), z,
                                     cur_mask)
        surf = _linear(z, p["linear"])[..., 0]
    else:
        surf = torch.zeros(B, zl, Y, X, device=grid.device)
        cur_mask = torch.zeros_like(mask)
        new_surf = sub(stats, "surfacepred")
    new = {"encoder": {"process_sparse": enc_s, **s_trunk},
           "refinement": new_ref, "surfacepred": new_surf}
    return DenseFlowOutput(coarse_out, ref_outs, ref_masks, surf, cur_mask,
                           active), new


def sparse_levels(tree: dict) -> dict:
    """The sparse levels' subtrees of a params or stats tree: the
    encoder's process_sparse, the refinements and the surface head."""
    return {"process_sparse": tree["encoder"]["process_sparse"],
            "refinement": tree["refinement"],
            "surfacepred": tree["surfacepred"]}


def sparse_levels_tree(params: dict, stats: dict) -> dict:
    """The prepared subtrees of the sparse levels (BN eps 1e-4)."""
    return BN.prepare_eval_tree(sparse_levels(params), sparse_levels(stats))


def genmodel_apply_dense_train(params: dict, stats: dict, cfg: SGNNConfig,
                               st: SparseTensor, *, num_refine_active: int,
                               do_surf: bool, training: bool = True,
                               impl: str | None = None, data=None,
                               space=None):
    """``genmodel_apply_dense`` over the JAX tree's parameter tensors
    (batch moments when ``training``, the running stats else; K8 only
    when not training). ``data``: the data-parallel group; ``space``: the
    z-sharding group. The sparse levels' moments are summed over both,
    the trunk's over ``data`` only (dense_flow.py:421-425, :487). Returns
    (DenseFlowOutput, new stats)."""
    def trunk(x):
        return dense_trunk_train(params["encoder"], stats["encoder"], cfg, x,
                                 training=training, group=data)
    both = tuple(g for g in (data, space) if g is not None) or None
    return genmodel_apply_dense(
        sparse_levels(params), sparse_levels(stats), cfg, st, trunk=trunk,
        bn=functools.partial(BN.batch_norm, training=training, group=both),
        num_refine_active=num_refine_active, do_surf=do_surf,
        training=training, impl=impl, space=space)


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

    def trunk_fn(self, x: torch.Tensor):
        """The prepared trunk as the forwards' ``trunk``."""
        return (*self.trunk(x), {})

    def scene_cfg(self, st: SparseTensor) -> SGNNConfig:
        """The config at ``st``'s volume and batch (raises for dims the
        model cannot take)."""
        return dataclasses.replace(self.cfg, input_dim=st.spatial_size,
                                   batch_size=st.batch_size)


class GenModelDense(EvalModel):
    """The dense-flow serving forward of a SparseTensor of input rows."""

    @torch.no_grad()
    def forward(self, st: SparseTensor, impl: str | None = None,
                space=None) -> DenseFlowOutput:
        """``space``: shard the scene's z over this process group (every
        rank passes the whole scene; the outputs are its local slabs)."""
        return genmodel_apply_dense(self.weights.tree(), None,
                                    self.scene_cfg(st), st,
                                    trunk=self.trunk_fn, bn=prepared_bn,
                                    impl=impl, space=space)[0]


class TrainModel(nn.Module):
    """A trainable model of any execution: one ``nn.Parameter`` per leaf
    of the JAX params tree and one buffer per leaf of its stats tree, both
    in the JAX flatten order (``params.tree_items``); ``param_tree``/
    ``stat_tree`` give them back as the nested trees the functional
    forwards take, so checkpoints move between the executions and the two
    packages. Initialised from ``params.init_params(cfg, seed)``. Each
    subclass trains one execution, ``EXECUTION``, which its ``cfg`` is set
    to (the train step dispatches on ``cfg.execution``)."""

    EXECUTION = ""

    def __init__(self, cfg: SGNNConfig, seed: int = 0):
        from sgnn_tpu_torch.params import init_params, tree_items

        super().__init__()
        self.cfg = dataclasses.replace(cfg, execution=self.EXECUTION)
        p, st = init_params(cfg, seed)
        self._templates = (p, st)
        self.param_keys = [k for k, _ in tree_items(p)]
        self.stat_keys = [k for k, _ in tree_items(st)]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.array(v)))
            for _, v in tree_items(p))
        for i, (_, v) in enumerate(tree_items(st)):
            self.register_buffer(f"stat{i}", torch.from_numpy(np.array(v)))

    def _stat_list(self) -> list:
        return [getattr(self, f"stat{i}") for i in range(len(self.stat_keys))]

    def params_like(self, leaves) -> dict:
        """The params tree with ``leaves`` (in ``param_keys`` order)."""
        from sgnn_tpu_torch.params import tree_build

        by_key = dict(zip(self.param_keys, leaves))
        return tree_build(self._templates[0], lambda k, _: by_key[k])

    def param_tree(self) -> dict:
        return self.params_like(self.weights)

    def stat_tree(self) -> dict:
        from sgnn_tpu_torch.params import tree_build

        by_key = dict(zip(self.stat_keys, self._stat_list()))
        return tree_build(self._templates[1], lambda k, _: by_key[k])

    @torch.no_grad()
    def load(self, params: dict, stats: dict) -> None:
        """Copy numpy (or tensor) trees in the JAX layout into the model."""
        from sgnn_tpu_torch.params import tree_items

        for t, (_, v) in zip(self.weights, tree_items(params)):
            t.copy_(torch.tensor(np.asarray(v, np.float32)))
        self.set_stats(stats)

    @torch.no_grad()
    def set_stats(self, stats: dict) -> None:
        """Store a stats tree (the forward's new running stats)."""
        from sgnn_tpu_torch.params import tree_items

        for t, (_, v) in zip(self._stat_list(), tree_items(stats)):
            t.copy_(v if torch.is_tensor(v)
                    else torch.tensor(np.asarray(v, np.float32)))


class GenModelDenseTrain(TrainModel):
    """The trainable dense-flow model (``genmodel_apply_dense_train``)."""

    EXECUTION = "dense_flow"

    def forward(self, st: SparseTensor, *, num_refine_active: int,
                do_surf: bool, training: bool = True,
                impl: str | None = None, data=None, space=None):
        return genmodel_apply_dense_train(
            self.param_tree(), self.stat_tree(), self.cfg, st,
            num_refine_active=num_refine_active, do_surf=do_surf,
            training=training, impl=impl, data=data, space=space)
