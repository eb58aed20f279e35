"""K7: the plain folded 3^3 convolution of the training path
(csrc/conv_raw.cu).

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``conv_folded_raw`` (:213):

    out = round(sum_taps in[v + tap] @ W[tap])      in's type, f32 sums

``x`` is a halo'd FGrid ``[B, Z+2, Y+2, xq, 128]`` at lane budget ``cpad``
(zero ring); the output is the UNPADDED ``[B, Z, Y, xq, 128]`` grid of
every slot, not masked (the input gradient of a conv site is this call
with flipped, in/out-transposed taps, and it needs every voxel). ``w
[27, 16, 16]``: the taps (C order over (dz, dy, dx)) zero-padded to 16
channels and rounded to the compute type; ``cin`` input channels are
read.

Precondition of the bf16 kernel: ``w`` is f32 holding bf16 values (every
caller prepares it with ``ops/folded.py`` ``_prep_taps(w, x.dtype)``). The
kernel runs its products on the tensor cores in bf16, so it takes those
values as they are; other values would be rounded there, and the plain
version would not be.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()


def conv_raw(x: torch.Tensor, w: torch.Tensor, cin: int, cpad: int, *,
             impl: str | None = None) -> torch.Tensor:
    global launches
    if cpad not in (8, 16) or not 1 <= cin <= cpad:
        raise ValueError(f"conv_raw: cpad {cpad}, cin {cin}")
    build.check_grid("x", x, x)
    build.check_f32("w", w, (27, 16, 16), x)
    if not build.use_kernel(x, impl):
        return conv_raw_plain(x, w, cin, cpad)
    if x.data_ptr() % 16:  # the kernel reads voxels as 16-byte vectors
        x = x.clone()
    B, Zp, Yp, xq, _ = x.shape
    out = torch.empty(B, Zp - 2, Yp - 2, xq, LANES, dtype=x.dtype,
                      device=x.device)
    rc = build.lib().sgnn_conv_raw(
        build.ptr(x), build.ptr(w), cin, build.ptr(out), B, Zp - 2, Yp - 2,
        xq, cpad, build.is_bf16(x), build.stream(x),
    )
    launches += 1
    build.check(rc, "conv_raw")
    return out


def conv_raw_plain(x: torch.Tensor, w: torch.Tensor, cin: int, cpad: int
                   ) -> torch.Tensor:
    """F.conv3d on the slot view: the z/y padding is the halo ring, x
    gets one zero slot per side; f32 sums rounded to x's type."""
    B, Zp, Yp, xq, _ = x.shape
    Xs = xq * (LANES // cpad)
    t = x.view(B, Zp, Yp, Xs, cpad)[..., :cin].float()
    wk = w[:, :cin, :cpad].reshape(3, 3, 3, cin, cpad)
    y = F.conv3d(t.permute(0, 4, 1, 2, 3), wk.permute(4, 3, 0, 1, 2),
                 padding=(0, 0, 1))
    y = y.permute(0, 2, 3, 4, 1).to(x.dtype)
    return y.reshape(B, Zp - 2, Yp - 2, xq, LANES)
