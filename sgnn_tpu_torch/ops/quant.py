"""The int8 modes of the conv, down and upsample sites: tile partitions,
activation scales and weight quantization.

Port of the ``quantize=True`` bodies of sgnn_tpu/ops/pallas/conv3d_folded.py
(K1 ``_kernel_fused`` :413-451, K3 ``_kernel_upconv`` :868-923, K2
``_kernel_downconv`` :1228-1262) and of the int8 branches of its weight
preps (``prep_conv_weights`` :557, ``prep_upconv_weights`` :1023,
``prep_downconv_weights`` :1345).

The TPU kernels quantize each input group with one dynamic scale per
(batch element, TPU tile, group): ``s = max(amax, 1e-8) / 127`` with
``amax`` the largest ``|tf|`` over every voxel and every lane of the rows
that tile reads (``tf``: the f32 input after the site's affine, ReLU and
mask, or the stored input), and ``q = clip(round(tf * (1 / s)), -127,
127)``. A voxel that two tiles read takes each tile's scale for that
tile's outputs. The tiles are the ones the TPU kernels' pickers choose,
so the pickers are copied here verbatim: another partition gives other
int8 answers. Weights are quantized per output column from values already
rounded to the compute type, ``ws = max(amax_col, 1e-8) / 127``; the
products are summed exactly in integers and dequantized as
``f32(iacc) * (s * ws)`` per group, in the reference's order.
"""

from __future__ import annotations

import dataclasses

import torch

LANES = 128
QMAX = 127.0
EPS = 1e-8


# ----------------------------------------------------------- tile pickers
#
# Verbatim copies of the TPU kernels' VMEM-budget tile pickers (plain
# Python over shapes): they fix the activation-scale partition.


def pick_tiles_conv(Z, Y, xq, G, itemsize, budget_bytes=12_500_000,
                    extra_interior_bytes=0, quant=False):
    """(tz, ty) of K1 (conv3d_folded.py:_pick_tiles_budget, :526)."""
    best = (1, 1)
    for tz in (16, 12, 8, 6, 4, 3, 2, 1):
        if Z % tz:
            continue
        for ty in (32, 24, 16, 12, 8, 6, 4, 3, 2, 1):
            if Y % ty:
                continue
            T = (tz + 2) * (ty + 2) * xq * LANES   # halo'd tile elements
            R = tz * ty * xq * LANES               # interior elements
            cost = 2 * (G + 1) * T * itemsize      # tbuf (2 slots)
            cost += 2 * R * itemsize               # obuf (2 slots)
            cost += R * extra_interior_bytes       # e.g. residual rbuf
            cost += T * (4 + 3 * itemsize)         # affine f32 + shifts
            cost += R * 4                          # f32 accumulator
            if quant:
                cost += R * 4                      # int32 accumulator
                cost += T * 3                      # int8 q + shift copies
            cost += (tz + ty + 1) * xq * LANES * itemsize  # zero ring bufs
            cost += G * 2 * 9 * LANES * LANES * itemsize   # folded weights
            if cost <= budget_bytes and tz * ty > best[0] * best[1]:
                best = (tz, ty)
    return best


def pick_tiles_upconv(Zf, Yf, xqf, xqc, G, itemsize,
                      budget_bytes=12_000_000):
    """(tzf, tyf) of K3 (conv3d_folded.py:_pick_tiles_upconv, :995)."""
    best = (2, 2)
    wbytes = G * 2 * 16 * LANES * 2 * LANES * itemsize
    for tzf in (16, 12, 8, 6, 4, 2):
        if Zf % tzf or tzf % 2:
            continue
        for tyf in (32, 24, 16, 12, 8, 6, 4, 2):
            if Yf % tyf or tyf % 2:
                continue
            tzc, tyc = tzf // 2, tyf // 2
            Tf = tzf * tyf * xqf * LANES
            Tc = (tzc + 2) * (tyc + 2) * xqc * LANES
            cost = wbytes
            cost += 2 * 2 * Tf * itemsize          # mbuf + obuf (2 slots)
            cost += 2 * (G + 1) * Tc * itemsize    # coarse tbuf
            cost += Tc * (4 + 3 * itemsize)        # affine f32 + shifts
            cost += tzc * tyc * xqc * 2 * LANES * 4  # f32 accumulator
            cost += Tf * (4 + itemsize)            # parity stack + mask f32
            cost += (tzf + tyf + 1) * xqf * LANES * itemsize  # ring bufs
            if cost <= budget_bytes and tzf * tyf > best[0] * best[1]:
                best = (tzf, tyf)
    return best


def pick_tiles_downconv(Zc, Yc, xqf, xqc, quant=False):
    """(tzc, tyc) of K2: the inline loop of fused_downconv_folded
    (conv3d_folded.py:1413-1428)."""
    best = (1, 1)
    for tzc in (8, 6, 4, 3, 2, 1):
        if Zc % tzc:
            continue
        for tyc in (16, 12, 8, 6, 4, 3, 2, 1):
            if Yc % tyc:
                continue
            Tf = 4 * tzc * tyc * xqf * LANES
            Rc = tzc * tyc * xqc * LANES
            cost = 2 * 2 * Tf * 2 + 4 * Rc * 2 + Tf * (4 + 2) + 2 * Rc * 4
            if quant:
                cost += Tf * (4 + 1) + 4 * Rc  # f32+int8 copies, i32 acc
            if cost <= 11_000_000 and tzc * tyc > best[0] * best[1]:
                best = (tzc, tyc)
    return best


# ---------------------------------------------------- a site's partition


@dataclasses.dataclass(frozen=True)
class Tiles:
    """A site's TPU tiles. Tile (iz, iy), of ``nz x ny``, writes output
    interior rows [iz tz, (iz + 1) tz) x [iy ty, (iy + 1) ty) and reads
    padded input rows z in [iz sz + oz, iz sz + oz + lz) (y alike), all x
    blocks and lanes; its activation scale is that window's."""
    nz: int
    ny: int
    tz: int
    ty: int
    sz: int
    oz: int
    lz: int
    sy: int
    oy: int
    ly: int

    @property
    def window(self) -> list:
        return [self.sz, self.oz, self.lz, self.sy, self.oy, self.ly]


def site_input(x: torch.Tensor, mask: torch.Tensor, aff, g: int,
               cpad: int) -> torch.Tensor:
    """The f32 value a site quantizes, over every lane: relu(x * a + b) *
    mask with group g's affine (zero on dead lanes), else x."""
    t = x.float()
    if aff is None:
        return t
    F = LANES // cpad
    a = aff[g, 0, :cpad].repeat(F)
    b = aff[g, 1, :cpad].repeat(F)
    return (t * a + b).clamp_min(0.0) * mask.float()


def conv_tiles(grid: torch.Tensor, G: int, residual: bool) -> Tiles:
    """K1 over a halo'd grid [B, Z+2, Y+2, xq, 128]: tile (iz, iy) writes
    interior rows [iz tz, (iz + 1) tz) and reads the halo'd padded rows
    [iz tz, iz tz + tz + 2) (y alike)."""
    _, Zp, Yp, xq, _ = grid.shape
    isz = grid.element_size()
    tz, ty = pick_tiles_conv(Zp - 2, Yp - 2, xq, G, isz,
                             extra_interior_bytes=2 * isz if residual else 0,
                             quant=True)
    return Tiles((Zp - 2) // tz, (Yp - 2) // ty, tz, ty,
                 tz, 0, tz + 2, ty, 0, ty + 2)


def upconv_tiles(coarse: torch.Tensor, xqf: int, G: int) -> Tiles:
    """K3 from a coarse grid [B, Zc+2, Yc+2, xqc, 128]: fine tile (iz, iy)
    writes fine interior rows [iz tzf, (iz + 1) tzf) and reads the coarse
    halo'd rows [iz tzc, iz tzc + tzc + 2), tzc = tzf / 2."""
    _, Zcp, Ycp, xqc, _ = coarse.shape
    Zf, Yf = 2 * (Zcp - 2), 2 * (Ycp - 2)
    tzf, tyf = pick_tiles_upconv(Zf, Yf, xqf, xqc, G, coarse.element_size())
    tzc, tyc = tzf // 2, tyf // 2
    return Tiles(Zf // tzf, Yf // tyf, tzf, tyf,
                 tzc, 0, tzc + 2, tyc, 0, tyc + 2)


def downconv_tiles(fine: torch.Tensor, xqc: int) -> Tiles:
    """K2 from a fine grid [B, Zf+2, Yf+2, xqf, 128]: coarse tile (iz, iy)
    writes coarse interior rows [iz tzc, (iz + 1) tzc) and reads the fine
    interior rows [1 + 2 iz tzc, 1 + 2 (iz + 1) tzc), no halo."""
    _, Zfp, Yfp, xqf, _ = fine.shape
    Zc, Yc = (Zfp - 2) // 2, (Yfp - 2) // 2
    tzc, tyc = pick_tiles_downconv(Zc, Yc, xqf, xqc, quant=True)
    return Tiles(Zc // tzc, Yc // tyc, tzc, tyc,
                 2 * tzc, 1, 2 * tzc, 2 * tyc, 1, 2 * tyc)


def tile_amax_plain(xs: list, mask: torch.Tensor, aff: torch.Tensor | None,
                    cpad: int, tiles: Tiles) -> torch.Tensor:
    """Per padded row, the max over its x blocks and lanes; then the max
    over each tile's window of rows."""
    t = tiles
    rows = torch.stack([site_input(x, mask, aff, g, cpad).abs().amax(
        dim=(3, 4)) for g, x in enumerate(xs)], -1)  # [B, Zp, Yp, G]
    z = rows[:, t.oz:].unfold(1, t.lz, t.sz)[:, :t.nz].amax(-1)
    return z[:, :, t.oy:].unfold(2, t.ly, t.sy)[:, :, :t.ny].amax(-1)


def _div_qmax(t: torch.Tensor) -> torch.Tensor:
    """t / 127 correctly rounded on every device: PyTorch's CUDA division
    by a scalar multiplies by its reciprocal (one bit off at times), a
    tensor divisor divides."""
    return t / torch.full_like(t, QMAX)


def scales_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """s = max(amax, 1e-8) / 127 (f32), as the TPU kernels compute it."""
    return _div_qmax(amax.clamp_min(EPS))


def tile_scales_plain(xs: list, mask: torch.Tensor, aff, cpad: int,
                      tiles: Tiles) -> torch.Tensor:
    """[B, nz, ny, G] f32 activation scales of a site's input groups."""
    return scales_from_amax(tile_amax_plain(xs, mask, aff, cpad, tiles))


def per_row(s: torch.Tensor, tz: int, ty: int) -> torch.Tensor:
    """[B, nz, ny] per-tile values -> [B, nz tz, ny ty]: each row's."""
    return s.repeat_interleave(tz, 1).repeat_interleave(ty, 2)


def quantize(tf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(tf * (1 / s)), -127, 127) as f32 integers (round half
    to even, as jnp.round)."""
    return torch.round(tf * (1.0 / s)).clamp(-QMAX, QMAX)


# ------------------------------------------------------- int8 weights
#
# Inputs are the port's prepared f32 weights (prep_*_weights: compact
# layouts, values rounded to the compute type, zero-padded to 16
# channels). Outputs put the input channel last, [..., co, ci], so a
# kernel reads an output channel's 16 int8 weights as one 16-byte word.


def _quantize_cols(w: torch.Tensor, amax: torch.Tensor, bshape: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    ws = scales_from_amax(amax)
    return quantize(w, ws.reshape(bshape)).to(torch.int8), ws


def quantize_conv_weights(w: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """[G, 27, ci, co] -> (int8 [G, 27, co, ci], ws [G, 16]): one scale
    per (group, output channel), the max over taps and input channels
    (the TPU layout's column g, x * cpad + co holds every tap of (g, co)
    in its main or carry matrix)."""
    G = w.shape[0]
    q, ws = _quantize_cols(w, w.abs().amax(dim=(1, 2)), (G, 1, 1, -1))
    return q.transpose(2, 3).contiguous(), ws


def quantize_downconv_weights(w: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """[8, ci, co] -> (int8 [8, co, ci], ws [16]): one scale per output
    channel, in the same-cpad and the widening (8 -> 16) modes alike."""
    q, ws = _quantize_cols(w, w.abs().amax(dim=(0, 1)), (1, 1, -1))
    return q.transpose(1, 2).contiguous(), ws


def quantize_upconv_weights(w: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """[G, 8 parity, 8 tap, ci, co] -> (int8 [G, 8, 8, co, ci], ws
    [G, 2, 16]): one scale per (group, fine x parity px, output channel).
    The TPU column o_hi * 128 + o_lo * cpad + co is fine slot o = o_hi F +
    o_lo of a block pair, whose parity is o % 2; its values are the
    parity-(pz, py, px) combined taps over every (pz, py, ez, ey, ex, ci)."""
    G = w.shape[0]
    by_px = w.view(G, 2, 2, 2, 8, *w.shape[3:])  # [G, pz, py, px, tap, ...]
    q, ws = _quantize_cols(by_px, by_px.abs().amax(dim=(1, 2, 4, 5)),
                           (G, 1, 1, 2, 1, 1, -1))
    return q.view(w.shape).transpose(3, 4).contiguous(), ws
