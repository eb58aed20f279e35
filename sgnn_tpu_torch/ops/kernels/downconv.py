"""K2: the fused stride-2 down site (csrc/downconv.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_downconv_folded``
(:1375): an optional eval-BN affine + ReLU + fine mask, a stride-2 2^3
conv, and the coarse mask (maxpool2 of the fine mask) in the same pass.
Returns (coarse grid, coarse mask), both halo'd with a zero ring. With
``cpad_out == 2 * cpad`` (cross mode) one fine x-block maps onto one
coarse block at the wider lane budget. ``w [8, 16, 16]``: taps in
(dz, dy, dx) order, zero-padded, rounded to the compute type.

``downconv_q`` is the int8 mode (K2q, ``quantize=True``, :1228-1264): the
fine input ``tf`` is quantized with the scale of the TPU tile that holds
the coarse output voxel (its window is the tile's fine interior rows, no
halo), multiplied with int8 weights ``wq [8, co, ci]`` in exact integer
sums and dequantized as ``f32(iacc) * (s * ws[co])``, then the coarse
mask; the coarse mask itself is computed exactly as in the other modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.ops.kernels import build, tile_amax as K_amax

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()
q_launches = 0  # the same for the int8 mode


def coarse_xq(xqf: int, cpad: int, cpad_out: int) -> int:
    """Coarse x-block count (fused_downconv_folded:1401-1406): the same
    count in cross mode, else half the fine blocks rounded up to 8."""
    if cpad_out != cpad:
        return xqf
    return -(-(xqf // 2) // 8) * 8


def _check(name, x, fmask, cin, cpad, co, aff):
    if (cpad, co) not in ((8, 8), (8, 16), (16, 16)) or cin > cpad:
        raise ValueError(f"{name}: cpad {cpad} -> {co}, cin {cin}")
    build.check_grid("x", x, fmask)
    build.check_grid("fmask", fmask, fmask)
    if aff is not None:
        build.check_f32("aff", aff, (2, 16), fmask)
    _, Zfp, Yfp, xqf, _ = x.shape
    if (Zfp - 2) % 2 or (Yfp - 2) % 2 or xqf % 2:
        raise ValueError(f"{name}: odd fine grid {tuple(x.shape)}")


def downconv(x: torch.Tensor, fmask: torch.Tensor, w: torch.Tensor,
             cin: int, cpad: int, cpad_out: int | None = None, *,
             aff: torch.Tensor | None = None,
             impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    co = cpad_out or cpad
    _check("downconv", x, fmask, cin, cpad, co, aff)
    build.check_f32("w", w, (8, 16, 16), fmask)
    B, Zfp, Yfp, xqf, _ = x.shape
    if not build.use_kernel(x, impl):
        return downconv_plain(x, fmask, w, cin, cpad, co, aff=aff)
    xqc = coarse_xq(xqf, cpad, co)
    shape = (B, (Zfp - 2) // 2 + 2, (Yfp - 2) // 2 + 2, xqc, LANES)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    mout = torch.empty(shape, dtype=x.dtype, device=x.device)
    rc = build.lib().sgnn_downconv(
        build.ptr(x), build.ptr(fmask), build.ptr(w), build.ptr(aff),
        cin, build.ptr(out), build.ptr(mout), B, Zfp, Yfp, xqf,
        xqc, cpad, co, build.is_bf16(x), build.stream(x),
    )
    launches += 1
    build.check(rc, "downconv")
    return out, mout


def downconv_plain(x: torch.Tensor, fmask: torch.Tensor, w: torch.Tensor,
                   cin: int, cpad: int, cpad_out: int, *,
                   aff: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """unfold -> affine/ReLU/mask -> F.conv3d(stride 2) and max_pool3d of
    the mask -> fold at the coarse lane budget."""
    dt = x.dtype
    B, Zfp, Yfp, xqf, _ = x.shape
    Zc, Yc = (Zfp - 2) // 2, (Yfp - 2) // 2
    Xsf = xqf * (LANES // cpad)
    xqc = coarse_xq(xqf, cpad, cpad_out)
    Xsc = xqc * (LANES // cpad_out)
    mf = fmask.view(B, Zfp, Yfp, Xsf, cpad)[:, 1:-1, 1:-1, :, 0].float()
    t = x.view(B, Zfp, Yfp, Xsf, cpad)[:, 1:-1, 1:-1, :, :cin].float()
    if aff is not None:
        t = (t * aff[0, :cin] + aff[1, :cin]).clamp_min(0.0)
        t = (t * mf[..., None]).to(dt).float()
    wk = w[:, :cin, :cpad_out].reshape(2, 2, 2, cin, cpad_out)
    y = F.conv3d(t.permute(0, 4, 1, 2, 3), wk.permute(4, 3, 0, 1, 2),
                 stride=2)
    mc = F.max_pool3d(mf[:, None], 2)[:, 0]
    n = min(Xsf // 2, Xsc)
    res = (y.permute(0, 2, 3, 4, 1) * mc[..., None])[:, :, :, :n].to(dt)
    shape = (B, Zc + 2, Yc + 2, Xsc, cpad_out)
    out = torch.zeros(shape, dtype=dt, device=x.device)
    mout = torch.zeros(shape, dtype=dt, device=x.device)
    out[:, 1:-1, 1:-1, :n] = res
    mout[:, 1:-1, 1:-1, :n] = mc[:, :, :, :n, None].to(dt)
    return (out.view(B, Zc + 2, Yc + 2, xqc, LANES),
            mout.view(B, Zc + 2, Yc + 2, xqc, LANES))


def downconv_q(x: torch.Tensor, fmask: torch.Tensor, wq: torch.Tensor,
               ws: torch.Tensor, cin: int, cpad: int,
               cpad_out: int | None = None, *,
               aff: torch.Tensor | None = None, impl: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 mode: the tile scales come from one ``tile_amax`` launch,
    then K2q runs."""
    global q_launches
    co = cpad_out or cpad
    _check("downconv_q", x, fmask, cin, cpad, co, aff)
    build.check_tensor("wq", wq, torch.int8, (8, 16, 16), fmask)
    build.check_f32("ws", ws, (16,), fmask)
    if not build.use_kernel(x, impl):
        return downconv_q_plain(x, fmask, wq, ws, cin, cpad, co, aff=aff)
    B, Zfp, Yfp, xqf, _ = x.shape
    xqc = coarse_xq(xqf, cpad, co)
    tiles = Q.downconv_tiles(x, xqc)
    amax = K_amax.tile_amax([x], fmask, aff[None] if aff is not None
                            else None, cpad, tiles)
    shape = (B, (Zfp - 2) // 2 + 2, (Yfp - 2) // 2 + 2, xqc, LANES)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    mout = torch.empty(shape, dtype=x.dtype, device=x.device)
    rc = build.lib().sgnn_downconv_q(
        build.ptr(x), build.ptr(fmask), build.ptr(wq), build.ptr(ws),
        build.ptr(aff), build.ptr(amax), cin, build.ptr(out),
        build.ptr(mout), B, Zfp, Yfp, xqf, xqc, cpad, co, tiles.tz,
        tiles.ty, tiles.nz, tiles.ny, build.is_bf16(x), build.stream(x),
    )
    q_launches += 1
    build.check(rc, "downconv_q")
    return out, mout


def downconv_q_plain(x: torch.Tensor, fmask: torch.Tensor, wq: torch.Tensor,
                     ws: torch.Tensor, cin: int, cpad: int, cpad_out: int,
                     *, aff: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fine interior quantized with each voxel's tile scale (the
    windows do not overlap), F.conv3d(stride 2) in f64 (exact integer
    sums), dequantized per coarse voxel with its tile's scale, masked."""
    dt = x.dtype
    B, Zfp, Yfp, xqf, _ = x.shape
    Zc, Yc = (Zfp - 2) // 2, (Yfp - 2) // 2
    Xsf = xqf * (LANES // cpad)
    xqc = coarse_xq(xqf, cpad, cpad_out)
    Xsc = xqc * (LANES // cpad_out)
    t = Q.downconv_tiles(x, xqc)
    a = aff[None] if aff is not None else None
    s = Q.tile_scales_plain([x], fmask, a, cpad, t)[..., 0]  # [B, nz, ny]
    mf = fmask.view(B, Zfp, Yfp, Xsf, cpad)[:, 1:-1, 1:-1, :, 0].float()
    tf = Q.site_input(x, fmask, a, 0, cpad).view(B, Zfp, Yfp, Xsf, cpad)[
        :, 1:-1, 1:-1, :, :cin]
    q = Q.quantize(tf, Q.per_row(s, 2 * t.tz, 2 * t.ty)[..., None, None])
    wk = wq[:, :cpad_out, :cin].double().reshape(2, 2, 2, cpad_out, cin)
    iacc = F.conv3d(q.permute(0, 4, 1, 2, 3).double(),
                    wk.permute(3, 4, 0, 1, 2), stride=2).round().float()
    sc = Q.per_row(s, t.tz, t.ty)[..., None, None]
    y = iacc.permute(0, 2, 3, 4, 1) * (sc * ws[:cpad_out])
    mc = F.max_pool3d(mf[:, None], 2)[:, 0]
    n = min(Xsf // 2, Xsc)
    res = (y * mc[..., None])[:, :, :, :n].to(dt)
    shape = (B, Zc + 2, Yc + 2, Xsc, cpad_out)
    out = torch.zeros(shape, dtype=dt, device=x.device)
    mout = torch.zeros(shape, dtype=dt, device=x.device)
    out[:, 1:-1, 1:-1, :n] = res
    mout[:, 1:-1, 1:-1, :n] = mc[:, :, :, :n, None].to(dt)
    return (out.view(B, Zc + 2, Yc + 2, xqc, LANES),
            mout.view(B, Zc + 2, Yc + 2, xqc, LANES))
