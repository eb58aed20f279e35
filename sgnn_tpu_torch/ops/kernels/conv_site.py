"""K1: the fused 3^3 submanifold conv site (csrc/conv_site.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_conv_folded`` (:593):

    out = round(mask * sum_g conv3(in_g')) [+ residual], zero halo ring
    in_g' = round(relu(in_g * scale_g + bias_g) * mask)   (with an affine)

Grids are FGrids ``[B, Z+2, Y+2, xq, 128]`` at lane budget ``cpad``. The
prepared weights ``w [G, 27, 16, 16]`` hold each group's taps (C order over
(dz, dy, dx)) zero-padded to 16 channels and rounded to the compute type;
``aff [G, 2, 16]`` holds each group's eval-BN (scale, bias). bf16 grids
take bf16-valued weights: the tensor cores read each weight as bf16, so one
that is no bf16 value counts as its nearest one, where ``conv_site_plain``
multiplies it in f32.

``conv_site_q`` is the int8 mode (K1q, ``quantize=True``, :413-451): each
group's f32 input ``tf`` (the affine's value before any rounding) is
quantized with the activation scale of the TPU tile that holds the output
voxel (``ops/quant.py``), multiplied with int8 weights ``wq [G, 27, co,
ci]`` in exact integer sums, and dequantized per group as
``acc += f32(iacc) * (s_g * ws[g, co])`` before the mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.ops.kernels import build, tile_amax as K_amax

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()
# the bf16 launches among them: the bf16 mode has one body, the tensor
# cores', so this follows the grids' type
mma_launches = 0
q_launches = 0  # the same for the int8 mode


def _check(name, xs, mask, cins, cpad, aff, residual):
    G = len(xs)
    if len(cins) != G or not 1 <= G <= 4 or cpad not in (8, 16):
        raise ValueError(f"{name}: G={G}, cins={cins}, cpad={cpad}")
    if max(cins) > cpad:
        raise ValueError(f"{name}: widths {cins} exceed cpad {cpad}")
    for i, x in enumerate(xs):
        build.check_grid(f"xs[{i}]", x, mask)
    if residual is not None:
        build.check_grid("residual", residual, mask)
    build.check_grid("mask", mask, mask)
    if aff is not None:
        build.check_f32("aff", aff, (G, 2, 16), mask)


def conv_site(xs: list, mask: torch.Tensor, w: torch.Tensor, cins: list,
              cpad: int, *, aff: torch.Tensor | None = None,
              residual: torch.Tensor | None = None,
              impl: str | None = None) -> torch.Tensor:
    global launches, mma_launches
    G = len(xs)
    _check("conv_site", xs, mask, cins, cpad, aff, residual)
    build.check_f32("w", w, (G, 27, 16, 16), mask)
    if not build.use_kernel(mask, impl):
        return conv_site_plain(xs, mask, w, cins, cpad, aff=aff,
                               residual=residual)
    B, Zp, Yp, xq, _ = mask.shape
    out = torch.empty_like(mask)
    rc = build.lib().sgnn_conv_site(
        build.ptr_array(xs), build.int_array(cins), G, build.ptr(mask),
        build.ptr(residual), build.ptr(w), build.ptr(aff),
        build.ptr(out), B, Zp, Yp, xq, cpad, build.is_bf16(mask),
        build.stream(mask),
    )
    launches += 1
    mma_launches += build.is_bf16(mask)
    build.check(rc, "conv_site")
    return out


def conv_site_plain(xs: list, mask: torch.Tensor, w: torch.Tensor,
                    cins: list, cpad: int, *,
                    aff: torch.Tensor | None = None,
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """The same site as unfold -> affine/ReLU/mask -> F.conv3d -> mask ->
    residual -> fold, rounding where the kernel does (f32 accumulation)."""
    dt = mask.dtype
    B, Zp, Yp, xq, _ = mask.shape
    Xs = xq * (LANES // cpad)
    m = mask.view(B, Zp, Yp, Xs, cpad)[..., 0].float()
    acc = None
    for g, (x, cin) in enumerate(zip(xs, cins)):
        t = x.view(B, Zp, Yp, Xs, cpad)[..., :cin].float()
        if aff is not None:
            t = (t * aff[g, 0, :cin] + aff[g, 1, :cin]).clamp_min(0.0)
            t = (t * m[..., None]).to(dt).float()
        wk = w[g, :, :cin, :cpad].reshape(3, 3, 3, cin, cpad)
        # z/y padding is the halo ring; x needs one zero slot per side
        y = F.conv3d(t.permute(0, 4, 1, 2, 3), wk.permute(4, 3, 0, 1, 2),
                     padding=(0, 0, 1))
        acc = y if acc is None else acc + y
    res = (acc.permute(0, 2, 3, 4, 1) * m[:, 1:-1, 1:-1, :, None]).to(dt)
    if residual is not None:
        res = res + residual.view(B, Zp, Yp, Xs, cpad)[:, 1:-1, 1:-1]
    out = torch.zeros(B, Zp, Yp, Xs, cpad, dtype=dt, device=mask.device)
    out[:, 1:-1, 1:-1] = res
    return out.view(B, Zp, Yp, xq, LANES)


def conv_site_q(xs: list, mask: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor, cins: list, cpad: int, *,
                aff: torch.Tensor | None = None,
                residual: torch.Tensor | None = None,
                impl: str | None = None) -> torch.Tensor:
    """The int8 mode: the tile scales come from one ``tile_amax`` launch,
    then K1q runs."""
    global q_launches
    G = len(xs)
    _check("conv_site_q", xs, mask, cins, cpad, aff, residual)
    build.check_tensor("wq", wq, torch.int8, (G, 27, 16, 16), mask)
    build.check_f32("ws", ws, (G, 16), mask)
    if not build.use_kernel(mask, impl):
        return conv_site_q_plain(xs, mask, wq, ws, cins, cpad, aff=aff,
                                 residual=residual)
    tiles = Q.conv_tiles(mask, G, residual is not None)
    amax = K_amax.tile_amax(xs, mask, aff, cpad, tiles)
    B, Zp, Yp, xq, _ = mask.shape
    out = torch.empty_like(mask)
    rc = build.lib().sgnn_conv_site_q(
        build.ptr_array(xs), build.int_array(cins), G, build.ptr(mask),
        build.ptr(residual), build.ptr(wq), build.ptr(ws), build.ptr(aff),
        build.ptr(amax), build.ptr(out), B, Zp, Yp, xq, cpad, tiles.tz,
        tiles.ty, tiles.nz, tiles.ny, build.is_bf16(mask),
        build.stream(mask),
    )
    q_launches += 1
    build.check(rc, "conv_site_q")
    return out


def conv_site_q_plain(xs: list, mask: torch.Tensor, wq: torch.Tensor,
                      ws: torch.Tensor, cins: list, cpad: int, *,
                      aff: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None) -> torch.Tensor:
    """Each tile's halo'd window of each group quantized with its scale,
    the windows convolved as one batch in f64 (sums of integers below
    2^24, exact in any order; the round() removes what a transform-based
    algorithm would leave), dequantized in the reference's order, the
    tiles put back, then mask -> cast -> residual."""
    dt = mask.dtype
    B, Zp, Yp, xq, _ = mask.shape
    Xs = xq * (LANES // cpad)
    t = Q.conv_tiles(mask, len(xs), residual is not None)
    s = Q.tile_scales_plain(xs, mask, aff, cpad, t)  # [B, nz, ny, G]
    acc = None
    for g, (x, cin) in enumerate(zip(xs, cins)):
        tf = Q.site_input(x, mask, aff, g, cpad).view(B, Zp, Yp, Xs, cpad)
        win = tf[..., :cin].unfold(1, t.lz, t.sz).unfold(2, t.ly, t.sy)
        # [B, nz, ny, Xs, cin, lz, ly] -> [B nz ny, cin, lz, ly, Xs]
        sg = s[..., g, None, None, None, None]
        q = Q.quantize(win, sg).permute(0, 1, 2, 4, 5, 6, 3).reshape(
            -1, cin, t.lz, t.ly, Xs)
        wk = wq[g, :, :cpad, :cin].double().reshape(3, 3, 3, cpad, cin)
        iacc = F.conv3d(q.double(), wk.permute(3, 4, 0, 1, 2),
                        padding=(0, 0, 1)).round().float()
        # [B nz ny, co, tz, ty, Xs] -> [B, Z, Y, Xs, co]
        iacc = iacc.view(B, t.nz, t.ny, cpad, t.tz, t.ty, Xs).permute(
            0, 1, 4, 2, 5, 6, 3).reshape(B, Zp - 2, Yp - 2, Xs, cpad)
        sw = Q.per_row(s[..., g], t.tz, t.ty)[..., None, None] * ws[g, :cpad]
        y = iacc * sw
        acc = y if acc is None else acc + y
    m = mask.view(B, Zp, Yp, Xs, cpad)[:, 1:-1, 1:-1, :, :1].float()
    res = (acc * m).to(dt)
    if residual is not None:
        res = res + residual.view(B, Zp, Yp, Xs, cpad)[:, 1:-1, 1:-1]
    out = torch.zeros(B, Zp, Yp, Xs, cpad, dtype=dt, device=mask.device)
    out[:, 1:-1, 1:-1] = res
    return out.view(B, Zp, Yp, xq, LANES)

