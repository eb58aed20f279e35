"""K8 and K9: the zero-padded 3^3 convolution over a channels-last grid
(csrc/conv3d_cl.cu; two entry points, each with its own CUDA kernel and
counter, both one body: output bricks on the tensor cores in bf16).

    out = round(conv3x3x3(x, W))      x [B, Z, Y, X, Cin], f32 sums

- K8, ``conv3d_3x3x3_folded``: port of
  sgnn_tpu/ops/pallas/conv3d_folded.py ``conv3d_3x3x3_folded`` (:268,
  kernel ``_conv_impl`` :178) with its custom gradient (:279-300) as a
  ``torch.autograd.Function``. It takes only the shapes ``supported()``
  admits (C in {8, 16, 32}, X % (128 / C) == 0, Cout <= C) and raises
  outside them, so the dense-flow execution routes exactly as the JAX
  package does.
- K9, ``conv3d_3x3x3``: port of sgnn_tpu/ops/pallas/conv3d.py
  ``conv3d_3x3x3_pallas`` (:77), any Cin and Cout, forward only; on the
  card Cin up to 64 (the kernel stages a brick's input in shared memory
  and refuses wider rows: a launch error).

``weight27 [27, Cin, Cout]`` (taps in C order over (dz, dy, dx)) is
rounded to x's type; the output is in x's type, rounded once. The plain
version is ``F.conv3d`` in f32 on the rounded operands under the dense
trunk's cuDNN flags (ops/dense.py).
"""

from __future__ import annotations

import torch

from sgnn_tpu_torch.ops import dense
from sgnn_tpu_torch.ops.kernels import build
from sgnn_tpu_torch.ops.kernels.gather_gemm import (chunking, prep_weight,
                                                    vec_rows)

LANES = 128
folded_launches = 0  # K8 launches since the last reset_launch_counts()
launches = 0  # K9 launches


def supported(x_shape, w_shape) -> bool:
    """True when conv3d_3x3x3_folded takes this (x, weight27) pair
    (sgnn_tpu/ops/pallas/conv3d_folded.py:supported)."""
    if len(x_shape) != 5 or len(w_shape) != 3:
        return False
    B, Z, Y, X, C = x_shape
    K, cin, cout = w_shape
    if K != 27 or cin != C or cout > cin:
        return False
    if C not in (8, 16, 32):
        return False
    return X % (LANES // C) == 0 and Z >= 1 and Y >= 1


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x {x.dtype} {tuple(x.shape)}, need "
                         f"float32/bfloat16 [B, Z, Y, X, C]")
    if (w.dim() != 3 or tuple(w.shape[:2]) != (27, x.shape[-1])
            or not w.is_floating_point() or w.device != x.device):
        raise ValueError(f"{name}: weight {tuple(w.shape)} on {w.device}, "
                         f"need [27, {x.shape[-1]}, Cout] on {x.device}")


def _launch(entry: str, x: torch.Tensor, weight27: torch.Tensor
            ) -> torch.Tensor:
    x = x.contiguous()
    B, Z, Y, X, cin = x.shape
    cout = weight27.shape[2]
    co, coutp = chunking(cout)
    w = prep_weight(weight27, x.dtype)
    out = torch.empty(B, Z, Y, X, cout, dtype=x.dtype, device=x.device)
    rc = getattr(build.lib(), entry)(
        build.ptr(x), build.ptr(w), build.ptr(out), B, Z, Y, X, cin, cout,
        coutp, co, vec_rows(x, cin), build.is_bf16(x), build.stream(x),
    )
    build.check(rc, entry)
    return out


def _conv_folded(x: torch.Tensor, w: torch.Tensor, impl: str | None
                 ) -> torch.Tensor:
    global folded_launches
    if not build.use_kernel(x, impl):
        return conv3d_plain(x, w)
    if x.is_contiguous() and x.data_ptr() % 16:
        x = x.clone()  # K8 stages 16-byte chunks: an aligned copy
    out = _launch("sgnn_conv3d_folded", x, w)
    folded_launches += 1
    return out


class _Conv3dFolded(torch.autograd.Function):
    """K8 with the JAX custom VJP: dx is K8 on the flipped, in/out-
    transposed taps where supported() admits them, else the plain conv;
    dW is the plain conv's weight gradient, rounded to x's type."""

    @staticmethod
    def forward(ctx, x, w, impl):
        ctx.save_for_backward(x, w)
        ctx.impl = impl
        return _conv_folded(x, w, impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _, cin, cout = w.shape
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = torch.flip(w.reshape(3, 3, 3, cin, cout), (0, 1, 2))
            wt = wt.reshape(27, cin, cout).transpose(1, 2)
            dx = (_conv_folded(g, wt, ctx.impl)
                  if supported(g.shape, wt.shape) else conv3d_plain(g, wt))
        if ctx.needs_input_grad[1]:
            wk = w.to(x.dtype).float().reshape(3, 3, 3, cin, cout)
            with torch.backends.cudnn.flags(**dense._CUDNN):
                _, gw, _ = torch.ops.aten.convolution_backward(
                    g.float().permute(0, 4, 1, 2, 3),
                    x.float().permute(0, 4, 1, 2, 3),
                    wk.permute(4, 3, 0, 1, 2), None, [1] * 3, [1] * 3,
                    [1] * 3, False, [0] * 3, 1, [False, True, False])
            dw = gw.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
            dw = dw.to(x.dtype).to(w.dtype)
        return dx, dw, None


def conv3d_3x3x3_folded(x: torch.Tensor, weight27: torch.Tensor, *,
                        impl: str | None = None) -> torch.Tensor:
    """K8; raises ValueError for shapes supported() refuses."""
    _check("conv3d_3x3x3_folded", x, weight27)
    if not supported(x.shape, weight27.shape):
        raise ValueError(f"conv3d_3x3x3_folded: unsupported shapes x="
                         f"{tuple(x.shape)} w={tuple(weight27.shape)}")
    return _Conv3dFolded.apply(x, weight27, impl)


def conv3d_3x3x3(x: torch.Tensor, weight27: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    """K9: any Cin and Cout (on the card Cin <= 64)."""
    global launches
    _check("conv3d_3x3x3", x, weight27)
    if not build.use_kernel(x, impl):
        return conv3d_plain(x, weight27)
    out = _launch("sgnn_conv3d", x, weight27)
    launches += 1
    return out


def conv3d_plain(x: torch.Tensor, weight27: torch.Tensor) -> torch.Tensor:
    """F.conv3d (padding 1) in f32 on x and the weights rounded to x's
    type, under ops/dense.py's cuDNN flags; rounded to x's type."""
    _, cin, cout = weight27.shape
    w = weight27.to(x.dtype).float().reshape(3, 3, 3, cin, cout)
    return dense.conv3d(x, w.permute(4, 3, 0, 1, 2), padding=1)
