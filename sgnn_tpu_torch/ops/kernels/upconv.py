"""K3: the fused generative upsample-conv site (csrc/upconv.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_upconv_folded``
(:1055): fmask * conv3(nn_up2(sum_g in_g')) computed from the COARSE
groups, in_g' = round(relu(in_g * scale_g + bias_g) * cmask) with an
affine. Along each axis fine f = 2q + p reads coarse q + p - 1 + e
(e in {0, 1}); ``w [G, 8 parity, 8 tap, 16, 16]`` holds the parity's
combined taps (summed in f32, then rounded — ops/folded.py
prep_upconv_weights), indexed (pz, py, px) and (ez, ey, ex). ``fmask=None``
expands the fine mask from the coarse one (the serving case).

``upconv_q`` is the int8 mode (K3q, ``quantize=True``, :868-923): each
coarse group's ``tf`` is quantized with the scale of the TPU tile that
holds the fine output voxel (its window is the tile's coarse halo'd rows),
multiplied with int8 weights ``wq [G, 8 parity, 8 tap, co, ci]`` in exact
integer sums and dequantized per group as ``acc += f32(iacc) * (s_g *
ws[g, px, co])`` (``px`` the fine x parity), then the fine mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.ops.kernels import build, tile_amax as K_amax

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()
q_launches = 0  # the same for the int8 mode


def _check(name, xs, cmask, fmask, cins, cpad, xqf, aff) -> tuple:
    """Checks a call's arguments; returns the fine output's shape."""
    G = len(xs)
    if len(cins) != G or not 1 <= G <= 4 or cpad not in (8, 16):
        raise ValueError(f"{name}: G={G}, cins={cins}, cpad={cpad}")
    if max(cins) > cpad:
        raise ValueError(f"{name}: widths {cins} exceed cpad {cpad}")
    for i, x in enumerate(xs):
        build.check_grid(f"xs[{i}]", x, cmask)
    build.check_grid("cmask", cmask, cmask)
    if aff is not None:
        build.check_f32("aff", aff, (G, 2, 16), cmask)
    B, Zcp, Ycp, xqc, _ = cmask.shape
    shape = (B, 2 * (Zcp - 2) + 2, 2 * (Ycp - 2) + 2, xqf, LANES)
    if fmask is not None:
        build.check_grid("fmask", fmask, cmask)
        if tuple(fmask.shape) != shape:
            raise ValueError(f"{name}: fmask {tuple(fmask.shape)} != "
                             f"{shape}")
    if xqf > 2 * xqc:
        raise ValueError(f"{name}: {xqf} fine blocks from {xqc} coarse")
    return shape


def upconv(xs: list, cmask: torch.Tensor, fmask: torch.Tensor | None,
           w: torch.Tensor, cins: list, cpad: int, xqf: int, *,
           aff: torch.Tensor | None = None,
           impl: str | None = None) -> torch.Tensor:
    global launches
    G = len(xs)
    shape = _check("upconv", xs, cmask, fmask, cins, cpad, xqf, aff)
    build.check_f32("w", w, (G, 8, 8, 16, 16), cmask)
    B, Zcp, Ycp, xqc, _ = cmask.shape
    if not build.use_kernel(cmask, impl):
        return upconv_plain(xs, cmask, fmask, w, cins, cpad, xqf, aff=aff)
    out = torch.empty(shape, dtype=cmask.dtype, device=cmask.device)
    rc = build.lib().sgnn_upconv(
        build.ptr_array(xs), build.int_array(cins), G, build.ptr(cmask),
        build.ptr(fmask), build.ptr(w), build.ptr(aff),
        build.ptr(out), B, Zcp, Ycp, xqc, xqf, cpad, build.is_bf16(cmask),
        build.stream(cmask),
    )
    launches += 1
    build.check(rc, "upconv")
    return out


def upconv_plain(xs: list, cmask: torch.Tensor, fmask: torch.Tensor | None,
                 w: torch.Tensor, cins: list, cpad: int, xqf: int, *,
                 aff: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Per fine parity, a 2^3 F.conv3d of the affined coarse grid with
    that parity's combined taps; the 8 results interleave into the fine
    grid, which is masked and folded with a zero ring."""
    dt = cmask.dtype
    B, Zcp, Ycp, xqc, _ = cmask.shape
    Zc, Yc = Zcp - 2, Ycp - 2
    Xsc = xqc * (LANES // cpad)
    Xsf = xqf * (LANES // cpad)
    cm = cmask.view(B, Zcp, Ycp, Xsc, cpad)[..., 0].float()
    acc = [None] * 8
    for g, (x, cin) in enumerate(zip(xs, cins)):
        t = x.view(B, Zcp, Ycp, Xsc, cpad)[..., :cin].float()
        if aff is not None:
            t = (t * aff[g, 0, :cin] + aff[g, 1, :cin]).clamp_min(0.0)
            t = (t * cm[..., None]).to(dt).float()
        # the z/y ring is the zero padding; x gets one zero slot per side
        t = F.pad(t.permute(0, 4, 1, 2, 3), (1, 1))
        for par in range(8):
            pz, py, px = par >> 2, (par >> 1) & 1, par & 1
            wk = w[g, par, :, :cin, :cpad].reshape(2, 2, 2, cin, cpad)
            y = F.conv3d(t, wk.permute(4, 3, 0, 1, 2))
            y = y[:, :, pz:pz + Zc, py:py + Yc, px:px + Xsc]
            acc[par] = y if acc[par] is None else acc[par] + y
    # fine[2q + pz, 2r + py, 2s + px] = acc[(pz, py, px)][q, r, s]
    fine = torch.stack(acc).view(2, 2, 2, B, cpad, Zc, Yc, Xsc)
    fine = fine.permute(3, 5, 0, 6, 1, 7, 2, 4).reshape(
        B, 2 * Zc, 2 * Yc, 2 * Xsc, cpad)[:, :, :, :Xsf]
    if fmask is not None:
        mf = fmask.view(B, 2 * Zc + 2, 2 * Yc + 2, Xsf, cpad)[
            :, 1:-1, 1:-1, :, 0].float()
    else:
        mf = cm[:, 1:-1, 1:-1]
        for ax in (1, 2, 3):
            mf = mf.repeat_interleave(2, dim=ax)
        mf = mf[:, :, :, :Xsf]
    out = torch.zeros(B, 2 * Zc + 2, 2 * Yc + 2, Xsf, cpad, dtype=dt,
                      device=cmask.device)
    out[:, 1:-1, 1:-1] = (fine * mf[..., None]).to(dt)
    return out.view(B, 2 * Zc + 2, 2 * Yc + 2, xqf, LANES)


def upconv_q(xs: list, cmask: torch.Tensor, fmask: torch.Tensor | None,
             wq: torch.Tensor, ws: torch.Tensor, cins: list, cpad: int,
             xqf: int, *, aff: torch.Tensor | None = None,
             impl: str | None = None) -> torch.Tensor:
    """The int8 mode: the tile scales come from one ``tile_amax`` launch,
    then K3q runs."""
    global q_launches
    G = len(xs)
    shape = _check("upconv_q", xs, cmask, fmask, cins, cpad, xqf, aff)
    build.check_tensor("wq", wq, torch.int8, (G, 8, 8, 16, 16), cmask)
    build.check_f32("ws", ws, (G, 2, 16), cmask)
    if not build.use_kernel(cmask, impl):
        return upconv_q_plain(xs, cmask, fmask, wq, ws, cins, cpad, xqf,
                              aff=aff)
    tiles = Q.upconv_tiles(cmask, xqf, G)
    amax = K_amax.tile_amax(xs, cmask, aff, cpad, tiles)
    B, Zcp, Ycp, xqc, _ = cmask.shape
    out = torch.empty(shape, dtype=cmask.dtype, device=cmask.device)
    rc = build.lib().sgnn_upconv_q(
        build.ptr_array(xs), build.int_array(cins), G, build.ptr(cmask),
        build.ptr(fmask), build.ptr(wq), build.ptr(ws), build.ptr(aff),
        build.ptr(amax), build.ptr(out), B, Zcp, Ycp, xqc, xqf, cpad,
        tiles.tz, tiles.ty, tiles.nz, tiles.ny, build.is_bf16(cmask),
        build.stream(cmask),
    )
    q_launches += 1
    build.check(rc, "upconv_q")
    return out


def upconv_q_plain(xs: list, cmask: torch.Tensor,
                   fmask: torch.Tensor | None, wq: torch.Tensor,
                   ws: torch.Tensor, cins: list, cpad: int, xqf: int, *,
                   aff: torch.Tensor | None = None) -> torch.Tensor:
    """Each tile's coarse halo'd window of each group quantized with its
    scale; per fine parity a 2^3 F.conv3d of the windows in f64 (exact
    integer sums), dequantized per group in the reference's order; the
    parities interleave, the tiles go back in place, then the fine mask."""
    dt = cmask.dtype
    B, Zcp, Ycp, xqc, _ = cmask.shape
    Zc, Yc = Zcp - 2, Ycp - 2
    Xsc = xqc * (LANES // cpad)
    Xsf = xqf * (LANES // cpad)
    t = Q.upconv_tiles(cmask, xqf, len(xs))
    tzc, tyc = t.tz // 2, t.ty // 2
    s = Q.tile_scales_plain(xs, cmask, aff, cpad, t)  # [B, nz, ny, G]
    acc = [None] * 8
    for g, (x, cin) in enumerate(zip(xs, cins)):
        tf = Q.site_input(x, cmask, aff, g, cpad).view(B, Zcp, Ycp, Xsc,
                                                       cpad)
        win = tf[..., :cin].unfold(1, t.lz, t.sz).unfold(2, t.ly, t.sy)
        sg = s[..., g, None, None, None, None]
        # [B, nz, ny, Xsc, cin, lz, ly] -> [B nz ny, cin, lz, ly, Xsc + 2]
        q = Q.quantize(win, sg).permute(0, 1, 2, 4, 5, 6, 3).reshape(
            -1, cin, t.lz, t.ly, Xsc).double()
        q = F.pad(q, (1, 1))
        for par in range(8):
            pz, py, px = par >> 2, (par >> 1) & 1, par & 1
            wk = wq[g, par, :, :cpad, :cin].double().reshape(
                2, 2, 2, cpad, cin)
            iacc = F.conv3d(q, wk.permute(3, 4, 0, 1, 2))[
                :, :, pz:pz + tzc, py:py + tyc, px:px + Xsc].round().float()
            # [B nz ny, co, tzc, tyc, Xsc] -> [B, nz, ny, tzc, tyc, Xsc, co]
            iacc = iacc.view(B, t.nz, t.ny, cpad, tzc, tyc, Xsc).permute(
                0, 1, 2, 4, 5, 6, 3)
            y = iacc * (sg * ws[g, px, :cpad])
            acc[par] = y if acc[par] is None else acc[par] + y
    # fine[iz tzf + 2 a + pz, iy tyf + 2 b + py, 2 c + px] =
    #     acc[(pz, py, px)][iz, iy, a, b, c]
    fine = torch.stack(acc).view(2, 2, 2, B, t.nz, t.ny, tzc, tyc, Xsc, cpad)
    fine = fine.permute(3, 4, 6, 0, 5, 7, 1, 8, 2, 9).reshape(
        B, 2 * Zc, 2 * Yc, 2 * Xsc, cpad)[:, :, :, :Xsf]
    if fmask is not None:
        mf = fmask.view(B, 2 * Zc + 2, 2 * Yc + 2, Xsf, cpad)[
            :, 1:-1, 1:-1, :, 0].float()
    else:
        mf = cmask.view(B, Zcp, Ycp, Xsc, cpad)[:, 1:-1, 1:-1, :, 0].float()
        for ax in (1, 2, 3):
            mf = mf.repeat_interleave(2, dim=ax)
        mf = mf[:, :, :, :Xsf]
    out = torch.zeros(B, 2 * Zc + 2, 2 * Yc + 2, Xsf, cpad, dtype=dt,
                      device=cmask.device)
    out[:, 1:-1, 1:-1] = (fine * mf[..., None]).to(dt)
    return out.view(B, 2 * Zc + 2, 2 * Yc + 2, xqf, LANES)
