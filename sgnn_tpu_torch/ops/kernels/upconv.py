"""K3: the fused generative upsample-conv site (csrc/upconv.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_upconv_folded``
(:1055): fmask * conv3(nn_up2(sum_g in_g')) computed from the COARSE
groups, in_g' = round(relu(in_g * scale_g + bias_g) * cmask) with an
affine. Along each axis fine f = 2q + p reads coarse q + p - 1 + e
(e in {0, 1}); ``w [G, 8 parity, 8 tap, 16, 16]`` holds the parity's
combined taps (summed in f32, then rounded — ops/folded.py
prep_upconv_weights), indexed (pz, py, px) and (ez, ey, ex). ``fmask=None``
expands the fine mask from the coarse one (the serving case).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()


def upconv(xs: list, cmask: torch.Tensor, fmask: torch.Tensor | None,
           w: torch.Tensor, cins: list, cpad: int, xqf: int, *,
           aff: torch.Tensor | None = None,
           impl: str | None = None) -> torch.Tensor:
    global launches
    G = len(xs)
    if len(cins) != G or not 1 <= G <= 4 or cpad not in (8, 16):
        raise ValueError(f"upconv: G={G}, cins={cins}, cpad={cpad}")
    if max(cins) > cpad:
        raise ValueError(f"upconv: widths {cins} exceed cpad {cpad}")
    for i, x in enumerate(xs):
        build.check_grid(f"xs[{i}]", x, cmask)
    build.check_grid("cmask", cmask, cmask)
    build.check_f32("w", w, (G, 8, 8, 16, 16), cmask)
    if aff is not None:
        build.check_f32("aff", aff, (G, 2, 16), cmask)
    B, Zcp, Ycp, xqc, _ = cmask.shape
    shape = (B, 2 * (Zcp - 2) + 2, 2 * (Ycp - 2) + 2, xqf, LANES)
    if fmask is not None:
        build.check_grid("fmask", fmask, cmask)
        if tuple(fmask.shape) != shape:
            raise ValueError(f"upconv: fmask {tuple(fmask.shape)} != {shape}")
    if xqf > 2 * xqc:
        raise ValueError(f"upconv: {xqf} fine blocks from {xqc} coarse")
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
