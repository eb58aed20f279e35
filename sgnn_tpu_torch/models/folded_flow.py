"""Folded execution of GenModel: the only-surface serving forward.

Port of ``sgnn_tpu/models/folded_flow.py`` ``genmodel_apply_folded``
(:126) in its serving form: ``want_level_outputs=False`` (no per-level
raw head grids), every refinement level and the surface head active, no
spatial sharding, no int8. The surface head is the multi-scale packed
head (``surf_head_packed``, K5) over the surface U-Net's groups at their
native resolutions; ``GenModelFolded(cfg, surf_pack=False)`` builds the
counterpart of the JAX package's ``SGNN_NO_SURFPACK`` branch instead:
the groups upsampled to full resolution and the summed head site
(``surf_head_fused``, K4 summed mode).

Each site module prepares its kernel-ready weights once, in ``load``
(called by ``params.load_jax_params``), and keeps them as buffers; the
JAX package's record/replay weight stream has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import DenseTrunk
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops.folded import MAXC, FGrid

CPAD = 16  # lane budget of every level but the encoder's first


def _check_widths(groups: list, widths: tuple, site: str) -> None:
    got = tuple(g.real_c for g in groups)
    if got != widths:
        raise ValueError(f"{site}: group widths {got}, expected {widths}")


class ConvSite(nn.Module):
    """A 3^3 submanifold conv over input groups (kernel K1)."""

    def __init__(self, widths, cout: int, affine: bool = False):
        super().__init__()
        self.widths, self.cout, self.affine = tuple(widths), cout, affine
        G = len(self.widths)
        self.register_buffer("w", torch.zeros(G, 27, MAXC, MAXC))
        self.register_buffer(
            "aff", torch.zeros(G, 2, MAXC) if affine else None)

    def load(self, w27, dtype: torch.dtype, bn: tuple | None = None) -> None:
        self.w.copy_(FO.prep_conv_weights(w27, self.widths, dtype))
        if self.affine:
            self.aff.copy_(FO.prep_affines(*bn, self.widths))

    def forward(self, groups: list, fm: FGrid, residual: FGrid | None = None,
                impl: str | None = None) -> FGrid:
        _check_widths(groups, self.widths, "conv site")
        return FO.subm_conv_fused(groups, fm, self.w, self.cout, aff=self.aff,
                                  residual=residual, impl=impl)


class DownSite(nn.Module):
    """A stride-2 2^3 conv plus the coarse mask (kernel K2)."""

    def __init__(self, cin: int, cout: int, affine: bool):
        super().__init__()
        self.cin, self.cout, self.affine = cin, cout, affine
        self.register_buffer("w", torch.zeros(8, MAXC, MAXC))
        self.register_buffer("aff", torch.zeros(2, MAXC) if affine else None)

    def load(self, w8, dtype: torch.dtype, bn: tuple | None = None) -> None:
        self.w.copy_(FO.prep_downconv_weights(w8, self.cin, dtype))
        if self.affine:
            self.aff.copy_(FO.prep_affines(*bn, [self.cin])[0])

    def forward(self, fg: FGrid, fm: FGrid, cpad_out: int | None = None,
                impl: str | None = None) -> tuple[FGrid, FGrid]:
        _check_widths([fg], (self.cin,), "down site")
        return FO.downconv_fused(fg, fm, self.w, self.cout, aff=self.aff,
                                 cpad_out=cpad_out, impl=impl)


class UpSite(nn.Module):
    """BN + ReLU + mask, 2x upsample and a 3^3 conv from coarse groups
    (kernel K3); the fine mask is expanded from the coarse one."""

    def __init__(self, widths, cout: int):
        super().__init__()
        self.widths, self.cout = tuple(widths), cout
        G = len(self.widths)
        self.register_buffer("w", torch.zeros(G, 8, 8, MAXC, MAXC))
        self.register_buffer("aff", torch.zeros(G, 2, MAXC))

    def load(self, w27, bn: tuple, dtype: torch.dtype) -> None:
        self.w.copy_(FO.prep_upconv_weights(w27, self.widths, dtype))
        self.aff.copy_(FO.prep_affines(*bn, self.widths))

    def forward(self, groups: list, cfm: FGrid, impl: str | None = None
                ) -> FGrid:
        _check_widths(groups, self.widths, "up site")
        return FO.upconv_fused(groups, cfm, None, self.w, self.cout,
                               aff=self.aff, impl=impl)


class HeadSite(nn.Module):
    """n2 BN + ReLU + mask, occ|sdf heads and the occupancy gate (kernel
    K4, gate mode)."""

    def __init__(self, nf: int):
        super().__init__()
        self.nf = nf
        self.register_buffer("w", torch.zeros(MAXC, MAXC))
        self.register_buffer("bias", torch.zeros(MAXC))
        self.register_buffer("aff", torch.zeros(2, MAXC))

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        w2 = np.concatenate([p["linear"]["weight"],
                             p["linearsdf"]["weight"]], axis=1)
        b2 = np.concatenate([p["linear"]["bias"], p["linearsdf"]["bias"]])
        self.w.copy_(FO.prep_head_weights(w2, [self.nf], dtype)[0])
        self.bias.copy_(FO.prep_bias(b2))
        self.aff.copy_(FO.prep_affines(p["n2"], s["n2"], [self.nf])[0])

    def forward(self, up: FGrid, cfm: FGrid, impl: str | None = None):
        _check_widths([up], (self.nf,), "head site")
        return FO.head_site_fused(up, cfm, self.w, self.bias, self.aff, 2,
                                  fm_scale=2, impl=impl)


class SurfHead(nn.Module):
    """p3 BN + ReLU + mask per group and the SDF head -> (sdf, mask)
    [B, Z, Y, X]: the multi-scale packed head over (group, scale) pairs
    (kernel K5), or with ``pack=False`` the summed head over full-
    resolution groups (kernel K4, summed mode)."""

    def __init__(self, widths, pack: bool):
        super().__init__()
        self.widths, self.pack = tuple(widths), pack
        G = len(self.widths)
        self.register_buffer("w", torch.zeros(G, MAXC, MAXC))
        self.register_buffer("bias", torch.zeros(MAXC))
        self.register_buffer("aff", torch.zeros(G, 2, MAXC))

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.w.copy_(FO.prep_head_weights(p["linear"]["weight"], self.widths,
                                          dtype))
        self.bias.copy_(FO.prep_bias(p["linear"]["bias"]))
        self.aff.copy_(FO.prep_affines(p["p3"], s["p3"], self.widths))

    def forward(self, groups: list, fm: FGrid, impl: str | None = None):
        if self.pack:
            _check_widths([g for g, _ in groups], self.widths, "surface head")
            return FO.surf_head_packed(groups, fm, self.w, self.bias,
                                       self.aff, impl=impl)
        _check_widths(groups, self.widths, "surface head")
        out = FO.surf_head_fused(groups, fm, self.w, self.bias, self.aff,
                                 impl=impl)
        return FO.unfold(out)[..., 0], FO.unfold(fm)[..., 0] > 0.5


class BNFolded(nn.Module):
    """Eval-mode masked BN + ReLU on one folded grid (plain PyTorch)."""

    def __init__(self, c: int):
        super().__init__()
        for name in ("mean", "inv", "bias"):
            self.register_buffer(name, torch.zeros(c))

    def load(self, params: dict, stats: dict) -> None:
        c = self.mean.shape[0]
        for buf, v in zip((self.mean, self.inv, self.bias),
                          FO.bn_eval_constants(params, stats, c)):
            buf.copy_(v)

    def forward(self, fg: FGrid, fm: FGrid) -> FGrid:
        return FO.bn_folded(fg, fm, self.mean, self.inv, self.bias)


class ResBlock(nn.Module):
    """Two BN -> conv sites; the identity branch is added inside the
    second kernel, after its mask."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv0 = ConvSite([nf], nf, affine=True)
        self.conv1 = ConvSite([nf], nf, affine=True)

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.conv0.load(p["conv0"], dtype, (p["bn0"], s["bn0"]))
        self.conv1.load(p["conv1"], dtype, (p["bn1"], s["bn1"]))

    def forward(self, fg: FGrid, fm: FGrid, impl: str | None = None
                ) -> FGrid:
        y = self.conv0([fg], fm, impl=impl)
        return self.conv1([y], fm, residual=fg, impl=impl)


class UNet(nn.Module):
    """FullyConvolutionalNet (reps=1, residual) over ``levels`` levels of
    width nf; returns the GROUPS [x, up(deeper)...] at this resolution, or
    with ``defer`` the (group, scale) pairs at their native resolutions
    (scale = the NN-upsample factor to this one; nothing is upsampled)."""

    def __init__(self, nf: int, levels: int = 3):
        super().__init__()
        self.block = ResBlock(nf)
        self.down = DownSite(nf, nf, affine=True) if levels > 1 else None
        self.deeper = UNet(nf, levels - 1) if levels > 1 else None

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.block.load(p["block"], s["block"], dtype)
        if self.deeper is not None:
            self.down.load(p["down_conv"], dtype,
                           (p["down_bn"], s["down_bn"]))
            self.deeper.load(p["deeper"], s["deeper"], dtype)

    def forward(self, fg: FGrid, fm: FGrid, impl: str | None = None,
                defer: bool = False) -> list:
        x = self.block(fg, fm, impl=impl)
        if self.deeper is None:
            return [(x, 1)] if defer else [x]
        down, down_fm = self.down(x, fm, impl=impl)
        deep = self.deeper(down, down_fm, impl=impl, defer=defer)
        if defer:
            return [(x, 1), *[(d, 2 * s) for d, s in deep]]
        # no mask multiply on the upsampled groups: every consumer applies
        # the level mask in-kernel with its input affine
        return [x, *[FO.upsample2_folded(d) for d in deep]]


class EncoderLayer(nn.Module):
    """p1 conv -> residual block -> BN (the skip) -> stride-2 conv -> BN."""

    def __init__(self, nf_in: int, nf: int):
        super().__init__()
        self.p1 = ConvSite([nf_in], nf)
        self.p2 = ResBlock(nf)
        self.p2_bn = BNFolded(nf)
        self.p3 = DownSite(nf, nf, affine=False)
        self.p3_bn = BNFolded(nf)

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.p1.load(p["p1"], dtype)
        self.p2.load(p["p2"], s["p2"], dtype)
        self.p2_bn.load(p["p2_bn"], s["p2_bn"])
        self.p3.load(p["p3"], dtype)
        self.p3_bn.load(p["p3_bn"], s["p3_bn"])

    def forward(self, groups: list, fm: FGrid, cpad_out: int | None = None,
                impl: str | None = None):
        x = self.p1(groups, fm, impl=impl)
        x = self.p2(x, fm, impl=impl)
        y = self.p2_bn(x, fm)
        down, down_fm = self.p3(y, fm, cpad_out=cpad_out, impl=impl)
        return self.p3_bn(down, down_fm), down_fm, (y, fm)


class Refinement(nn.Module):
    """One generative level: conv -> U-Net -> upsample-conv -> heads and
    the occupancy gate, at twice the input resolution."""

    def __init__(self, widths_in, nf: int):
        super().__init__()
        self.p1 = ConvSite(widths_in, nf)
        self.p2 = UNet(nf)
        self.up = UpSite([nf] * 3, nf)
        self.head = HeadSite(nf)

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.p1.load(p["p1"], dtype)
        self.p2.load(p["p2"], s["p2"], dtype)
        self.up.load(p["n1"], (p["p3"], s["p3"]), dtype)
        self.head.load(p, s, dtype)

    def forward(self, cur: list, cur_fm: FGrid, impl: str | None = None):
        z = self.p1(cur, cur_fm, impl=impl)
        zg = self.p2(z, cur_fm, impl=impl)
        # the unfiltered fine mask is the NN-dup of cur_fm: the upconv and
        # the head site expand it from the coarse grid
        up = self.up(zg, cur_fm, impl=impl)
        return self.head(up, cur_fm, impl=impl)


class SurfacePred(nn.Module):
    """conv -> U-Net -> surface head; returns (sdf, mask) [B, Z, Y, X]."""

    def __init__(self, widths_in, nf: int, pack: bool):
        super().__init__()
        self.p1 = ConvSite(widths_in, nf)
        self.p2 = UNet(nf)
        self.head = SurfHead([nf] * 3, pack)

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.p1.load(p["p1"], dtype)
        self.p2.load(p["p2"], s["p2"], dtype)
        self.head.load(p, s, dtype)

    def forward(self, cur: list, cur_fm: FGrid, impl: str | None = None):
        z = self.p1(cur, cur_fm, impl=impl)
        groups = self.p2(z, cur_fm, impl=impl, defer=self.head.pack)
        return self.head(groups, cur_fm, impl=impl)


@dataclasses.dataclass
class FoldedOutput:
    """coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf); surf_sdf
    [B, Z, Y, X] f32; surf_mask [B, Z, Y, X] bool; level_active: active
    voxels per level, coarse to fine (0-d tensors; the last is the
    surface's)."""
    coarse_out: torch.Tensor
    surf_sdf: torch.Tensor
    surf_mask: torch.Tensor
    level_active: list


def refine_widths(cfg: SGNNConfig) -> tuple[list, list]:
    """Input group widths of each refinement level's and of the surface
    head's first conv (pass_occ / pass_feats / skip order of the JAX
    forward)."""
    L = cfg.num_hierarchy_levels
    nf_per = list(cfg.nf_per_level) + [cfg.nf_per_level[-1]]
    levels = []
    for h in range(L):  # h == L - 1: the surface head
        w = []
        if h == 0:
            w += [2] * cfg.pass_occ + [cfg.nf_coarse] * cfg.pass_feats
        else:
            w += [cfg.nf] * cfg.pass_feats + [2] * cfg.pass_occ
        if cfg.use_skip_sparse:
            w.append(nf_per[L - 1 - h])
        levels.append(w)
    return levels[:-1], levels[-1]


class GenModelFolded(nn.Module):
    """The serving forward. Weights enter through params.load_jax_params.
    ``surf_pack=False`` takes the summed surface head (module docstring).
    """

    def __init__(self, cfg: SGNNConfig, surf_pack: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        nfs = cfg.nf_per_level
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg.input_nf if i == 0 else nfs[i - 1], nf)
            for i, nf in enumerate(nfs)
        )
        self.trunk = DenseTrunk(cfg)
        ref_w, surf_w = refine_widths(cfg)
        self.refinement = nn.ModuleList(Refinement(w, cfg.nf) for w in ref_w)
        self.surface = SurfacePred(surf_w, cfg.nf, surf_pack)

    def load(self, params: dict, stats: dict) -> None:
        dt = self.dtype
        enc_p, enc_s = params["encoder"], stats["encoder"]
        for lvl, layer in enumerate(self.encoder):
            layer.load(enc_p["process_sparse"][lvl],
                       enc_s["process_sparse"][lvl], dt)
        self.trunk.load(enc_p, enc_s, dt)
        for h, ref in enumerate(self.refinement):
            ref.load(params["refinement"][h], stats["refinement"][h], dt)
        self.surface.load(params["surfacepred"], stats["surfacepred"], dt)

    @torch.no_grad()
    def forward(self, locs: torch.Tensor, feats: torch.Tensor, dims: tuple,
                batch_size: int = 1, impl: str | None = None
                ) -> FoldedOutput:
        """``locs [N, 4]`` (z, y, x, b) rows and ``feats [N, 1]`` TSDF
        values of the active input voxels of a ``dims`` scene."""
        cfg, dt = self.cfg, self.dtype
        X = dims[2]
        # level 0 runs at cpad 8 when its widths allow: 16 voxels per row
        cpad0 = 8 if (cfg.input_nf <= 8 and cfg.nf_per_level[0] <= 8
                      and X % 16 == 0) else CPAD
        x, m = FO.scatter_sparse(locs, feats, locs.shape[0], dims,
                                 batch_size, cpad=cpad0, dtype=dt,
                                 feat_bound=cfg.truncation, impl=impl)

        # ---- encoder levels
        skips = []
        for lvl, layer in enumerate(self.encoder):
            widen = lvl == 0 and cpad0 != CPAD
            x, m, ft2 = layer([x], m, cpad_out=CPAD if widen else None,
                              impl=impl)
            if widen:  # the full-res skip is consumed at cpad 16
                ft2 = (FO.repack_cpad(ft2[0], CPAD), ft2[1])
            skips.append(ft2)
        skips.append((x, m))

        # ---- coarse dense trunk (1/8 res)
        y, coarse_out = self.trunk(FO.unfold(x))
        cur_mask = torch.sigmoid(coarse_out[..., 0]) > 0.5
        cur_fm = FO.fold_mask(cur_mask, CPAD, dt)
        cur = []
        if cfg.pass_occ:
            o = FO.fold(coarse_out.to(dt), CPAD)
            cur.append(o.with_data(o.data * cur_fm.data))
        if cfg.pass_feats:
            f = FO.fold(y, CPAD)
            cur.append(f.with_data(f.data * cur_fm.data))
        active = [cur_mask.sum()]

        # ---- refinement levels
        L_ref = cfg.num_refine_levels
        for h, ref in enumerate(self.refinement):
            if cfg.use_skip_sparse:
                sk = skips[L_ref - h][0]
                cur = [*cur, sk.with_data(sk.data * cur_fm.data)]
            upm, o2m, cur_fm = ref(cur, cur_fm, impl=impl)
            cur = [upm] * cfg.pass_feats + [o2m] * cfg.pass_occ
            active.append((cur_fm.data[..., ::CPAD] > 0).sum())

        # ---- surface prediction
        if cfg.use_skip_sparse:
            sk = skips[0][0]
            cur = [*cur, sk.with_data(sk.data * cur_fm.data)]
        surf, surf_mask = self.surface(cur, cur_fm, impl=impl)
        return FoldedOutput(coarse_out, surf, surf_mask, active)
