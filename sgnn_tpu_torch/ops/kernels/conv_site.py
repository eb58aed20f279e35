"""K1: the fused 3^3 submanifold conv site (csrc/conv_site.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_conv_folded`` (:593):

    out = round(mask * sum_g conv3(in_g')) [+ residual], zero halo ring
    in_g' = round(relu(in_g * scale_g + bias_g) * mask)   (with an affine)

Grids are FGrids ``[B, Z+2, Y+2, xq, 128]`` at lane budget ``cpad``. The
prepared weights ``w [G, 27, 16, 16]`` hold each group's taps (C order over
(dz, dy, dx)) zero-padded to 16 channels and rounded to the compute type;
``aff [G, 2, 16]`` holds each group's eval-BN (scale, bias).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()


def conv_site(xs: list, mask: torch.Tensor, w: torch.Tensor, cins: list,
              cpad: int, *, aff: torch.Tensor | None = None,
              residual: torch.Tensor | None = None,
              impl: str | None = None) -> torch.Tensor:
    global launches
    G = len(xs)
    if len(cins) != G or not 1 <= G <= 4 or cpad not in (8, 16):
        raise ValueError(f"conv_site: G={G}, cins={cins}, cpad={cpad}")
    if max(cins) > cpad:
        raise ValueError(f"conv_site: widths {cins} exceed cpad {cpad}")
    for i, x in enumerate(xs):
        build.check_grid(f"xs[{i}]", x, mask)
    if residual is not None:
        build.check_grid("residual", residual, mask)
    build.check_grid("mask", mask, mask)
    build.check_f32("w", w, (G, 27, 16, 16), mask)
    if aff is not None:
        build.check_f32("aff", aff, (G, 2, 16), mask)
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
