"""K2: the fused stride-2 down site (csrc/downconv.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_downconv_folded``
(:1375): an optional eval-BN affine + ReLU + fine mask, a stride-2 2^3
conv, and the coarse mask (maxpool2 of the fine mask) in the same pass.
Returns (coarse grid, coarse mask), both halo'd with a zero ring. With
``cpad_out == 2 * cpad`` (cross mode) one fine x-block maps onto one
coarse block at the wider lane budget. ``w [8, 16, 16]``: taps in
(dz, dy, dx) order, zero-padded, rounded to the compute type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()


def coarse_xq(xqf: int, cpad: int, cpad_out: int) -> int:
    """Coarse x-block count (fused_downconv_folded:1401-1406): the same
    count in cross mode, else half the fine blocks rounded up to 8."""
    if cpad_out != cpad:
        return xqf
    return -(-(xqf // 2) // 8) * 8


def downconv(x: torch.Tensor, fmask: torch.Tensor, w: torch.Tensor,
             cin: int, cpad: int, cpad_out: int | None = None, *,
             aff: torch.Tensor | None = None,
             impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    co = cpad_out or cpad
    if (cpad, co) not in ((8, 8), (8, 16), (16, 16)) or cin > cpad:
        raise ValueError(f"downconv: cpad {cpad} -> {co}, cin {cin}")
    build.check_grid("x", x, fmask)
    build.check_grid("fmask", fmask, fmask)
    build.check_f32("w", w, (8, 16, 16), fmask)
    if aff is not None:
        build.check_f32("aff", aff, (2, 16), fmask)
    B, Zfp, Yfp, xqf, _ = x.shape
    if (Zfp - 2) % 2 or (Yfp - 2) % 2 or xqf % 2:
        raise ValueError(f"downconv: odd fine grid {tuple(x.shape)}")
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
