"""Folded execution of GenModel: the serving forward.

Port of ``sgnn_tpu/models/folded_flow.py`` ``genmodel_apply_folded``
(:126), on one device or z-sharded over a process group (``space``: the
halo exchange at each 3^3 site, ``ops/folded.py:halo_exchange_z``). Two
forms, as there:

- the only-surface form (``want_level_outputs=False``, the default here:
  the model serves the surface): the unfiltered fine mask of each
  refinement level is never materialised, K3 and K4's gate expand it from
  the coarse mask in-register, and no raw head grid is written;
- the level-output form (``want_level_outputs=True``, :254-310): each
  level's unfiltered fine mask is ``upsample2_folded`` of the coarse one,
  K3 takes it as given, K4's gate reads it at scale 1 and also writes the
  raw f32 head grid, and ``FoldedOutput`` carries each active level's raw
  heads and mask (under ``space``, this rank's z-slab of them).

``num_refine_active`` < all levels or ``do_surf=False`` gives a partial
forward (:314): it stops after that many refinement levels, and the
surface grids come back as zeros.

The surface head is the multi-scale packed head (``surf_head_packed``,
K5) over the surface U-Net's groups at their native resolutions;
``GenModelFolded``'s ablation options build the counterparts of the JAX
package's ``SGNN_NO_SURFPACK``, ``SGNN_NO_UPCONV``, ``SGNN_NO_HEADK`` and
``SGNN_NO_MASKFUSE`` branches (its docstring; ``ablations_from_env`` reads
the variables for the CLIs): each takes a fused kernel out and puts the
composed ops back.

``cfg.quantize_int8`` serves every conv, down and upsample site in its
int8 mode (K1-K3 with ``quantize=True``: int8 weights with per-column
scales, dynamic per-tile activation scales, ``ops/quant.py``), as the JAX
forward passes ``quantize=q8`` to each of them; the input scatter, the
heads, the trunk and the BN passes stay exact there too.

Each site module prepares its kernel-ready weights once, in ``load``
(called by ``params.load_jax_params``), and keeps them as buffers; the
JAX package's record/replay weight stream has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import DenseTrunk, sharded_trunk
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.ops.folded import MAXC, FGrid
from sgnn_tpu_torch.parallel import comm
from sgnn_tpu_torch.utils import profiling as P

CPAD = 16  # lane budget of every level but the encoder's first


def _same(g: FGrid) -> FGrid:
    return g


def _check_widths(groups: list, widths: tuple, site: str) -> None:
    got = tuple(g.real_c for g in groups)
    if got != widths:
        raise ValueError(f"{site}: group widths {got}, expected {widths}")


class _WeightedSite(nn.Module):
    """A site's prepared weights ``w``: f32, or with ``quantize`` int8
    with their per-column scales ``ws`` (the int8 mode), prepared once in
    ``load`` as the JAX package's prepare_folded_weights hoists them."""

    def _weights(self, shape: tuple, ws_shape: tuple, quantize: bool
                 ) -> None:
        self.quantize = quantize
        self.register_buffer("w", torch.zeros(
            *shape, dtype=torch.int8 if quantize else torch.float32))
        self.register_buffer("ws", torch.zeros(ws_shape) if quantize
                             else None)

    def _set(self, w: torch.Tensor, quantize_fn) -> None:
        if self.quantize:
            w, ws = quantize_fn(w)
            self.ws.copy_(ws)
        self.w.copy_(w)


class ConvSite(_WeightedSite):
    """A 3^3 submanifold conv over input groups (kernel K1)."""

    def __init__(self, widths, cout: int, affine: bool = False,
                 quantize: bool = False):
        super().__init__()
        self.widths, self.cout, self.affine = tuple(widths), cout, affine
        G = len(self.widths)
        self._weights((G, 27, MAXC, MAXC), (G, MAXC), quantize)
        self.register_buffer(
            "aff", torch.zeros(G, 2, MAXC) if affine else None)

    def load(self, w27, dtype: torch.dtype, bn: tuple | None = None) -> None:
        self._set(FO.prep_conv_weights(w27, self.widths, dtype),
                  Q.quantize_conv_weights)
        if self.affine:
            self.aff.copy_(FO.prep_affines(*bn, self.widths))

    def forward(self, groups: list, fm: FGrid, residual: FGrid | None = None,
                impl: str | None = None) -> FGrid:
        _check_widths(groups, self.widths, "conv site")
        return FO.subm_conv_fused(groups, fm, self.w, self.cout, aff=self.aff,
                                  residual=residual, quantize=self.quantize,
                                  ws=self.ws, impl=impl)


class DownSite(_WeightedSite):
    """A stride-2 2^3 conv plus the coarse mask (kernel K2)."""

    def __init__(self, cin: int, cout: int, affine: bool,
                 quantize: bool = False):
        super().__init__()
        self.cin, self.cout, self.affine = cin, cout, affine
        self._weights((8, MAXC, MAXC), (MAXC,), quantize)
        self.register_buffer("aff", torch.zeros(2, MAXC) if affine else None)

    def load(self, w8, dtype: torch.dtype, bn: tuple | None = None) -> None:
        self._set(FO.prep_downconv_weights(w8, self.cin, dtype),
                  Q.quantize_downconv_weights)
        if self.affine:
            self.aff.copy_(FO.prep_affines(*bn, [self.cin])[0])

    def forward(self, fg: FGrid, fm: FGrid, cpad_out: int | None = None,
                impl: str | None = None) -> tuple[FGrid, FGrid]:
        _check_widths([fg], (self.cin,), "down site")
        return FO.downconv_fused(fg, fm, self.w, self.cout, aff=self.aff,
                                 cpad_out=cpad_out, quantize=self.quantize,
                                 ws=self.ws, impl=impl)


class UpSite(_WeightedSite):
    """BN + ReLU + mask, 2x upsample and a 3^3 conv from coarse groups
    (kernel K3); the fine mask ``ffm``, or with None the expansion of the
    coarse one."""

    def __init__(self, widths, cout: int, quantize: bool = False):
        super().__init__()
        self.widths, self.cout = tuple(widths), cout
        G = len(self.widths)
        self._weights((G, 8, 8, MAXC, MAXC), (G, 2, MAXC), quantize)
        self.register_buffer("aff", torch.zeros(G, 2, MAXC))

    def load(self, w27, bn: tuple, dtype: torch.dtype) -> None:
        self._set(FO.prep_upconv_weights(w27, self.widths, dtype),
                  Q.quantize_upconv_weights)
        self.aff.copy_(FO.prep_affines(*bn, self.widths))

    def forward(self, groups: list, cfm: FGrid, ffm: FGrid | None = None,
                impl: str | None = None, ex=_same) -> FGrid:
        _check_widths(groups, self.widths, "up site")
        return FO.upconv_fused([ex(g) for g in groups], cfm, ffm,
                               self.w, self.cout, aff=self.aff,
                               quantize=self.quantize, ws=self.ws, impl=impl)


class HeadSite(nn.Module):
    """n2 BN + ReLU + mask, occ|sdf heads and the occupancy gate (kernel
    K4, gate mode): the level mask is the coarse level's, expanded in
    place (``fm_scale`` 2), or the fine one (1); with ``raw`` the raw f32
    heads come out too (else None)."""

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

    def forward(self, up: FGrid, fm: FGrid, fm_scale: int, raw: bool,
                impl: str | None = None) -> tuple:
        _check_widths([up], (self.nf,), "head site")
        outs = FO.head_site_fused(up, fm, self.w, self.bias, self.aff, 2,
                                  fm_scale=fm_scale, emit_raw=raw, impl=impl)
        return outs if raw else (*outs, None)


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

    def load(self, params: dict, stats: dict, off: int = 0) -> None:
        c = self.mean.shape[0]
        for buf, v in zip((self.mean, self.inv, self.bias),
                          FO.bn_eval_constants(params, stats, c, off)):
            buf.copy_(v)

    def forward(self, fg: FGrid, fm: FGrid) -> FGrid:
        return FO.bn_folded(fg, fm, self.mean, self.inv, self.bias)


class BNGroups(nn.Module):
    """Eval-mode BN + ReLU over grouped grids, each group with its slice
    of the BN's channels (_bn_groups, folded_flow.py:47)."""

    def __init__(self, widths):
        super().__init__()
        self.widths = tuple(widths)
        self.bns = nn.ModuleList(BNFolded(c) for c in self.widths)

    def load(self, params: dict, stats: dict) -> None:
        off = 0
        for bn, c in zip(self.bns, self.widths):
            bn.load(params, stats, off)
            off += c

    def forward(self, groups: list, fm: FGrid) -> list:
        _check_widths(groups, self.widths, "BN groups")
        return [bn(g, fm) for bn, g in zip(self.bns, groups)]


class UpComposed(nn.Module):
    """SGNN_NO_UPCONV's generative upsample (folded_flow.py:262-266): p3 BN
    per coarse group, each group upsampled 2x, then one conv site (K1)
    over the upsampled groups on the given fine mask, without an affine
    and exact under int8 too (the JAX forward passes it no quantize)."""

    def __init__(self, widths, cout: int):
        super().__init__()
        self.bn = BNGroups(widths)
        self.conv = ConvSite(widths, cout)

    def load(self, w27, bn: tuple, dtype: torch.dtype) -> None:
        self.bn.load(*bn)
        self.conv.load(w27, dtype)

    def forward(self, groups: list, cfm: FGrid, ffm: FGrid,
                impl: str | None = None, ex=_same) -> FGrid:
        ups = [ex(FO.upsample2_folded(g))
               for g in self.bn(groups, cfm)]
        return self.conv(ups, ffm, impl=impl)


class HeadComposed(nn.Module):
    """SGNN_NO_HEADK's refinement tail (folded_flow.py:276-282): n2 BN, the
    occ|sdf heads as one lane GEMM in f32, the occupancy gate times the
    fine mask, and the masked outputs; the raw heads are that GEMM's."""

    def __init__(self, nf: int):
        super().__init__()
        self.bn = BNFolded(nf)
        self.register_buffer("w", torch.zeros(nf, 2))
        self.register_buffer("bias", torch.zeros(MAXC))

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.bn.load(p["n2"], s["n2"])
        self.w.copy_(FO.prep_linear(np.concatenate(
            [p["linear"]["weight"], p["linearsdf"]["weight"]], 1), dtype))
        self.bias.copy_(FO.prep_bias(np.concatenate(
            [p["linear"]["bias"], p["linearsdf"]["bias"]])))

    def forward(self, up: FGrid, fm: FGrid, fm_scale: int, raw: bool,
                impl: str | None = None) -> tuple:
        if fm_scale != 1:
            raise ValueError("composed head: needs the fine mask")
        upm, o2m, new_fm, out2 = FO.head_gate_composed(
            self.bn(up, fm), fm, self.w, self.bias)
        return upm, o2m, new_fm, out2 if raw else None


class ResBlock(nn.Module):
    """Two BN -> conv sites; the identity branch is added inside the
    second kernel, after its mask. ``ex``: the z halo exchange of each
    conv input under spatial sharding (the residual is read inside the
    slab only)."""

    def __init__(self, nf: int, q: bool = False):
        super().__init__()
        self.conv0 = ConvSite([nf], nf, affine=True, quantize=q)
        self.conv1 = ConvSite([nf], nf, affine=True, quantize=q)

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.conv0.load(p["conv0"], dtype, (p["bn0"], s["bn0"]))
        self.conv1.load(p["conv1"], dtype, (p["bn1"], s["bn1"]))

    def forward(self, fg: FGrid, fm: FGrid, impl: str | None = None,
                ex=_same) -> FGrid:
        y = self.conv0([ex(fg)], fm, impl=impl)
        return self.conv1([ex(y)], fm, residual=fg, impl=impl)


class UNet(nn.Module):
    """FullyConvolutionalNet (reps=1, residual) over ``levels`` levels of
    width nf; returns the GROUPS [x, up(deeper)...] at this resolution, or
    with ``defer`` the (group, scale) pairs at their native resolutions
    (scale = the NN-upsample factor to this one; nothing is upsampled).
    ``ex``: the z halo exchange of conv inputs and of the coarse mask
    under spatial sharding."""

    def __init__(self, nf: int, levels: int = 3, q: bool = False):
        super().__init__()
        self.block = ResBlock(nf, q)
        self.down = (DownSite(nf, nf, affine=True, quantize=q)
                     if levels > 1 else None)
        self.deeper = UNet(nf, levels - 1, q) if levels > 1 else None

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.block.load(p["block"], s["block"], dtype)
        if self.deeper is not None:
            self.down.load(p["down_conv"], dtype,
                           (p["down_bn"], s["down_bn"]))
            self.deeper.load(p["deeper"], s["deeper"], dtype)

    def forward(self, fg: FGrid, fm: FGrid, impl: str | None = None,
                defer: bool = False, ex=_same) -> list:
        x = self.block(fg, fm, impl=impl, ex=ex)
        if self.deeper is None:
            return [(x, 1)] if defer else [x]
        # the down site reads inside the slab only: no exchange
        down, down_fm = self.down(x, fm, impl=impl)
        deep = self.deeper(down, ex(down_fm), impl=impl, defer=defer, ex=ex)
        if defer:
            return [(x, 1), *[(d, 2 * s) for d, s in deep]]
        # no mask multiply on the upsampled groups: every consumer applies
        # the level mask in-kernel with its input affine
        return [x, *[FO.upsample2_folded(d) for d in deep]]


class EncoderLayer(nn.Module):
    """p1 conv -> residual block -> BN (the skip) -> stride-2 conv -> BN."""

    def __init__(self, nf_in: int, nf: int, q: bool = False):
        super().__init__()
        self.p1 = ConvSite([nf_in], nf, quantize=q)
        self.p2 = ResBlock(nf, q)
        self.p2_bn = BNFolded(nf)
        self.p3 = DownSite(nf, nf, affine=False, quantize=q)
        self.p3_bn = BNFolded(nf)

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.p1.load(p["p1"], dtype)
        self.p2.load(p["p2"], s["p2"], dtype)
        self.p2_bn.load(p["p2_bn"], s["p2_bn"])
        self.p3.load(p["p3"], dtype)
        self.p3_bn.load(p["p3_bn"], s["p3_bn"])

    def forward(self, groups: list, fm: FGrid, cpad_out: int | None = None,
                impl: str | None = None, ex=_same):
        x = self.p1([ex(g) for g in groups], fm, impl=impl)
        x = self.p2(x, fm, impl=impl, ex=ex)
        y = self.p2_bn(x, fm)
        down, down_fm = self.p3(y, fm, cpad_out=cpad_out, impl=impl)
        down_fm = ex(down_fm)
        return self.p3_bn(down, down_fm), down_fm, (y, fm)


class Refinement(nn.Module):
    """One generative level: conv -> U-Net -> upsample-conv -> heads and
    the occupancy gate, at twice the input resolution. Returns (masked
    feats, masked heads, new mask, raw f32 heads, unfiltered fine mask),
    the last two None unless ``levels`` (the level-output form).
    ``upconv`` / ``head_kernel`` False: the composed sites of the JAX
    package's SGNN_NO_UPCONV / SGNN_NO_HEADK; any of those or
    ``mask_fuse`` False (SGNN_NO_MASKFUSE) materialises the fine mask."""

    def __init__(self, widths_in, nf: int, q: bool = False,
                 upconv: bool = True, head_kernel: bool = True,
                 mask_fuse: bool = True):
        super().__init__()
        self.p1 = ConvSite(widths_in, nf, quantize=q)
        self.p2 = UNet(nf, q=q)
        self.up = (UpSite([nf] * 3, nf, quantize=q) if upconv
                   else UpComposed([nf] * 3, nf))
        self.head = HeadSite(nf) if head_kernel else HeadComposed(nf)
        self.fuse_mask = upconv and head_kernel and mask_fuse

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.p1.load(p["p1"], dtype)
        self.p2.load(p["p2"], s["p2"], dtype)
        self.up.load(p["n1"], (p["p3"], s["p3"]), dtype)
        self.head.load(p, s, dtype)

    def forward(self, cur: list, cur_fm: FGrid, impl: str | None = None,
                ex=_same, levels: bool = False):
        z = self.p1([ex(g) for g in cur], cur_fm, impl=impl)
        zg = self.p2(z, cur_fm, impl=impl, ex=ex)
        # the unfiltered fine mask is the NN-dup of cur_fm: the upconv and
        # the head site expand it from the coarse grid, unless the level
        # outputs or an ablation materialise it (folded_flow.py:254-260)
        fuse = self.fuse_mask and not levels
        ffm = None if fuse else ex(FO.upsample2_folded(cur_fm))
        up = self.up(zg, cur_fm, ffm, impl=impl, ex=ex)
        upm, o2m, new_fm, raw = self.head(up, cur_fm if fuse else ffm,
                                          2 if fuse else 1, levels,
                                          impl=impl)
        return upm, o2m, ex(new_fm), raw, ffm


class SurfacePred(nn.Module):
    """conv -> U-Net -> surface head; returns (sdf, mask) [B, Z, Y, X].
    The head is the multi-scale one (``pack``), the summed one, or with
    ``head_kernel`` False (SGNN_NO_HEADK) the composed one, which the
    JAX package takes over the packed one too (folded_flow.py:322)."""

    def __init__(self, widths_in, nf: int, pack: bool, q: bool = False,
                 head_kernel: bool = True):
        super().__init__()
        self.p1 = ConvSite(widths_in, nf, quantize=q)
        self.p2 = UNet(nf, q=q)
        self.head = (SurfHead([nf] * 3, pack) if head_kernel
                     else SurfHeadComposed([nf] * 3))
        self.defer = pack and head_kernel

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.p1.load(p["p1"], dtype)
        self.p2.load(p["p2"], s["p2"], dtype)
        self.head.load(p, s, dtype)

    def forward(self, cur: list, cur_fm: FGrid, impl: str | None = None,
                ex=_same):
        z = self.p1([ex(g) for g in cur], cur_fm, impl=impl)
        groups = self.p2(z, cur_fm, impl=impl, defer=self.defer, ex=ex)
        # the heads read inside the slab only (folded_flow.py:90)
        return self.head(groups, cur_fm, impl=impl)


class SurfHeadComposed(nn.Module):
    """SGNN_NO_HEADK's surface tail (folded_flow.py:334-350): p3 BN per
    full-resolution group, each group's rows of the linear head as a lane
    GEMM in f32, summed in group order, plus the bias -> (sdf, mask)."""

    def __init__(self, widths):
        super().__init__()
        self.bn = BNGroups(widths)
        self.register_buffer("w", torch.zeros(sum(widths), 1))
        self.register_buffer("bias", torch.zeros(MAXC))

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.bn.load(p["p3"], s["p3"])
        self.w.copy_(FO.prep_linear(p["linear"]["weight"], dtype))
        self.bias.copy_(FO.prep_bias(p["linear"]["bias"]))

    def forward(self, groups: list, fm: FGrid, impl: str | None = None):
        out = FO.linear_sum_folded(self.bn(groups, fm), self.w, self.bias)
        return FO.unfold(out)[..., 0], FO.unfold(fm)[..., 0] > 0.5


@dataclasses.dataclass
class FoldedOutput:
    """coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf); surf_sdf
    [B, Z, Y, X] f32; surf_mask [B, Z, Y, X] bool (zeros in a partial
    forward); level_active: active voxels per level, coarse to fine, one
    for the coarse grid and one for each active refinement level (0-d
    tensors; the last of a whole forward is the surface's); in the
    level-output form, per active refinement level h, refine_outs
    [B, z, y, x, 2] f32, the raw (occ logit, sdf) heads at every voxel,
    and refine_masks_unfilt [B, z, y, x] bool, the unfiltered sites (the
    children of the previous level's kept voxels); empty lists in the
    only-surface form."""
    coarse_out: torch.Tensor
    surf_sdf: torch.Tensor
    surf_mask: torch.Tensor
    level_active: list
    refine_outs: list = dataclasses.field(default_factory=list)
    refine_masks_unfilt: list = dataclasses.field(default_factory=list)


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


# the JAX package's serving ablations, read from the environment where it
# builds the folded forward, and the GenModelFolded option each turns off
ABLATIONS = {"SGNN_NO_SURFPACK": "surf_pack", "SGNN_NO_UPCONV": "upconv",
             "SGNN_NO_HEADK": "head_kernel", "SGNN_NO_MASKFUSE": "mask_fuse"}


def ablations_from_env(environ=None) -> dict:
    """GenModelFolded's ablation options from ``environ`` (os.environ by
    default): an option is off where its variable is set non-empty."""
    env = os.environ if environ is None else environ
    return {opt: not env.get(var) for var, opt in ABLATIONS.items()}


class GenModelFolded(nn.Module):
    """The serving forward. Weights enter through params.load_jax_params.
    ``cfg.quantize_int8`` serves the int8 sites; the forward's arguments
    pick the form (module docstring). The ablations take one fused kernel
    out and put the JAX package's composed ops back (ABLATIONS,
    folded_flow.py:254-350):

    - ``surf_pack=False``: the summed surface head (K4) over the surface
      U-Net's groups upsampled to full resolution, instead of K5;
    - ``mask_fuse=False``: the fine mask of each level materialised, K3
      given it, K4's gate reading it at scale 1;
    - ``upconv=False``: that, and the p3 BN per group, each group
      upsampled, one K1 site over the three upsampled groups (exact under
      int8) instead of K3;
    - ``head_kernel=False``: that fine mask, the n2 BN, heads and gate
      composed instead of K4, and the composed surface head (per-group BN
      and linear heads over full-resolution groups) instead of K5 or K4.
    """

    def __init__(self, cfg: SGNNConfig, surf_pack: bool = True,
                 upconv: bool = True, head_kernel: bool = True,
                 mask_fuse: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        nfs = cfg.nf_per_level
        q8 = bool(cfg.quantize_int8)
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg.input_nf if i == 0 else nfs[i - 1], nf, q8)
            for i, nf in enumerate(nfs)
        )
        self.trunk = DenseTrunk(cfg)
        ref_w, surf_w = refine_widths(cfg)
        self.refinement = nn.ModuleList(
            Refinement(w, cfg.nf, q8, upconv, head_kernel, mask_fuse)
            for w in ref_w)
        self.surface = SurfacePred(surf_w, cfg.nf, surf_pack, q8,
                                   head_kernel)

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
                batch_size: int = 1, impl: str | None = None, space=None,
                num_refine_active: int | None = None, do_surf: bool = True,
                want_level_outputs: bool = False) -> FoldedOutput:
        """``locs [N, 4]`` (z, y, x, b) rows and ``feats [N, 1]`` TSDF
        values of the active input voxels of a ``dims`` scene.

        ``num_refine_active``: the refinement levels to run (all by
        default); the surface head runs with ``do_surf`` once all do.
        ``want_level_outputs``: the level-output form (module docstring).

        ``space``: a process group to shard the scene's z over
        (folded_flow.py:126-330, ``sp_axis``): every rank passes the whole
        scene with ``dims`` the GLOBAL dims and scatters its own slab
        (``scatter_sparse_sharded``); each 3^3 conv and upconv site refills
        its inputs' z ring from the neighbours (``halo_exchange_z``), and
        so does every mask a site reads; the trunk runs replicated
        (``sharded_trunk``); every other op is slab-local, and the outputs
        are this rank's z-slabs, the level outputs too (each level's raw
        heads and unfiltered mask inside the slab). Z must divide by 32
        times the group's size. Under ``cfg.quantize_int8`` each int8
        site picks its tiles on the slab it is given and takes each
        tile's amax over the slab's window, ring rows included once they
        are exchanged, as the JAX int8 bodies do on each device's slab
        under ``shard_map``: the activation scales follow the slabs, so
        the answer is the JAX package's sharded one, not the unsharded
        forward's."""
        cfg, dt = self.cfg, self.dtype
        L_ref = cfg.num_refine_levels
        n_active = L_ref if num_refine_active is None else num_refine_active
        if not 0 <= n_active <= L_ref:
            raise ValueError(f"num_refine_active {n_active} of {L_ref} "
                             f"refinement levels")
        with P.span("forward"):
            return self._forward(locs, feats, dims, batch_size, impl, space,
                                 n_active, do_surf, want_level_outputs)

    def _forward(self, locs, feats, dims, batch_size, impl, space, n_active,
                 do_surf, want_level_outputs) -> FoldedOutput:
        """The forward's levels, each under its span: ``encoder`` (the input
        scatter and the encoder levels), ``trunk`` (the coarse trunk and
        its gate), one ``refine`` a refinement level and ``surface``;
        ``trunk`` and each ``refine`` count the voxels their gate kept
        (``kept``, the level's ``level_active`` entry)."""
        cfg, dt = self.cfg, self.dtype
        L_ref = cfg.num_refine_levels
        X = dims[2]
        # level 0 runs at cpad 8 when its widths allow: 16 voxels per row
        cpad0 = 8 if (cfg.input_nf <= 8 and cfg.nf_per_level[0] <= 8
                      and X % 16 == 0) else CPAD
        if space is None:
            ex = _same
        else:
            n_sp = comm.size(space)
            if dims[0] % (32 * n_sp):
                raise ValueError(f"spatial folded: Z={dims[0]} must divide "
                                 f"by 32*{n_sp}")

            def ex(g):
                return FO.halo_exchange_z(g, space)

        with P.span("encoder"):
            if space is None:
                x, m = FO.scatter_sparse(locs, feats, locs.shape[0], dims,
                                         batch_size, cpad=cpad0, dtype=dt,
                                         feat_bound=cfg.truncation,
                                         impl=impl)
            else:
                x, m = FO.scatter_sparse_sharded(
                    locs, feats, locs.shape[0], dims, batch_size, space,
                    cpad=cpad0, dtype=dt, feat_bound=cfg.truncation,
                    impl=impl)
                m = ex(m)
            skips = []
            for lvl, layer in enumerate(self.encoder):
                widen = lvl == 0 and cpad0 != CPAD
                x, m, ft2 = layer([x], m, cpad_out=CPAD if widen else None,
                                  impl=impl, ex=ex)
                if widen:  # the full-res skip is consumed at cpad 16
                    ft2 = (FO.repack_cpad(ft2[0], CPAD), ft2[1])
                skips.append(ft2)
            skips.append((x, m))

        with P.span("trunk"):  # the coarse dense trunk (1/8 res)
            y, coarse_out, _ = sharded_trunk(
                lambda t: (*self.trunk(t), None), FO.unfold(x), space)
            cur_mask = torch.sigmoid(coarse_out[..., 0]) > 0.5
            cur_fm = ex(FO.fold_mask(cur_mask, CPAD, dt))
            cur = []
            if cfg.pass_occ:
                o = FO.fold(coarse_out.to(dt), CPAD)
                cur.append(o.with_data(o.data * cur_fm.data))
            if cfg.pass_feats:
                f = FO.fold(y, CPAD)
                cur.append(f.with_data(f.data * cur_fm.data))
            active = [cur_mask.sum()]
            P.count("kept", active[-1])

        out = FoldedOutput(coarse_out, None, None, active)
        for h, ref in enumerate(self.refinement[:n_active]):
            with P.span("refine"):
                if cfg.use_skip_sparse:
                    sk = skips[L_ref - h][0]
                    cur = [*cur, sk.with_data(sk.data * cur_fm.data)]
                upm, o2m, cur_fm, raw, fm_unfilt = ref(
                    cur, cur_fm, impl=impl, ex=ex, levels=want_level_outputs)
                cur = [upm] * cfg.pass_feats + [o2m] * cfg.pass_occ
                # inside the slab (under sharding the ring holds a
                # neighbour's)
                active.append((cur_fm.data[:, 1:-1, ..., ::CPAD] > 0).sum())
                P.count("kept", active[-1])
                if want_level_outputs:
                    out.refine_outs.append(FO.unfold(raw).float())
                    out.refine_masks_unfilt.append(
                        FO.unfold(fm_unfilt)[..., 0] > 0.5)

        with P.span("surface"):
            if do_surf and n_active == L_ref:
                if cfg.use_skip_sparse:
                    sk = skips[0][0]
                    cur = [*cur, sk.with_data(sk.data * cur_fm.data)]
                out.surf_sdf, out.surf_mask = self.surface(cur, cur_fm,
                                                           impl=impl, ex=ex)
            else:  # the JAX forward's zeros (folded_flow.py:365-367)
                shape = (batch_size, *skips[0][1].dims)
                out.surf_sdf = torch.zeros(shape, device=coarse_out.device)
                out.surf_mask = torch.zeros(shape, dtype=torch.bool,
                                            device=coarse_out.device)
        return out
