"""K5: the multi-scale surface head (csrc/surf_head.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_surf_head_ms``
(:1975). Group g is an FGrid at 1/scales[g] of the fine resolution
``dims`` (Z, Y, X); per fine voxel each group's coarse voxel
(z // s, y // s, x // s) goes through its eval-BN affine, ReLU and
rounding to the compute type, then the head column; the group results
are summed in group order in f32, multiplied by the fine mask and the
bias added:

    out = (sum_g round(relu(in_g * scale_g + bias_g)) @ W_g) * m + b

Returns the dense ``[B, Z, Y, X]`` f32 sdf. ``w [G, 16, 16]`` holds each
group's head rows (column 0 is the sdf head) rounded to the compute type;
``bias [16]`` and ``aff [G, 2, 16]`` are f32.
"""

from __future__ import annotations

import torch

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()


def surf_head(xs: list, scales: list, mask: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor, aff: torch.Tensor, cins: list, cpad: int,
              dims: tuple, *, impl: str | None = None) -> torch.Tensor:
    global launches
    G = len(xs)
    if (len(cins) != G or len(scales) != G or not 1 <= G <= 4
            or cpad not in (8, 16)):
        raise ValueError(f"surf_head: G={G}, cins={cins}, scales={scales}, "
                         f"cpad={cpad}")
    if max(cins) > cpad:
        raise ValueError(f"surf_head: widths {cins} exceed cpad {cpad}")
    build.check_grid("mask", mask, mask)
    B, Zp, Yp, xq, _ = mask.shape
    Z, Y, X = dims
    F = LANES // cpad
    if (Zp, Yp) != (Z + 2, Y + 2) or X > xq * F:
        raise ValueError(f"surf_head: mask {tuple(mask.shape)} does not "
                         f"hold dims {dims}")
    for i, (x, s) in enumerate(zip(xs, scales)):
        build.check_grid(f"xs[{i}]", x, mask)
        if s < 1 or Z % s or Y % s or X % s:
            raise ValueError(f"surf_head: scale {s} does not divide {dims}")
        if (tuple(x.shape[:3]) != (B, Z // s + 2, Y // s + 2)
                or X // s > x.shape[3] * F):
            raise ValueError(f"surf_head: group {i} {tuple(x.shape)} is not "
                             f"dims {dims} at scale {s}")
    build.check_f32("w", w, (G, 16, 16), mask)
    build.check_f32("bias", bias, (16,), mask)
    build.check_f32("aff", aff, (G, 2, 16), mask)
    if not build.use_kernel(mask, impl):
        return surf_head_plain(xs, scales, mask, w, bias, aff, cins, cpad,
                               dims)
    out = torch.empty(B, Z, Y, X, dtype=torch.float32, device=mask.device)
    rc = build.lib().sgnn_surf_head(
        build.ptr_array(xs), build.int_array(cins), build.int_array(scales),
        build.int_array([x.shape[3] for x in xs]), G, build.ptr(mask),
        build.ptr(w), build.ptr(bias), build.ptr(aff), build.ptr(out),
        B, Z, Y, X, xq, cpad, build.is_bf16(mask), build.stream(mask),
    )
    launches += 1
    build.check(rc, "surf_head")
    return out


def surf_head_plain(xs, scales, mask, w, bias, aff, cins, cpad, dims):
    """Each group's affine, ReLU, rounding and head product at its native
    resolution, then the NN expansion (repeat_interleave), the crop to X,
    the sum, the mask and the bias."""
    dt = mask.dtype
    B = mask.shape[0]
    Z, Y, X = dims
    m = mask.view(B, Z + 2, Y + 2, -1, cpad)[:, 1:-1, 1:-1, :X, 0].float()
    acc = None
    for g, (x, s, cin) in enumerate(zip(xs, scales, cins)):
        t = x.view(B, Z // s + 2, Y // s + 2, -1, cpad)[
            :, 1:-1, 1:-1, :X // s, :cin].float()
        t = (t * aff[g, 0, :cin] + aff[g, 1, :cin]).clamp_min(0.0)
        h = torch.matmul(t.to(dt).float(), w[g, :cin, :1])[..., 0]
        for ax in (1, 2, 3):
            h = h.repeat_interleave(s, dim=ax)
        acc = h if acc is None else acc + h
    return acc * m + bias[0]
