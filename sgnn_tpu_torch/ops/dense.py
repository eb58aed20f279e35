"""Dense 3D convolutions (port of ``sgnn_tpu/ops/dense.py``): the
1/8-resolution trunk's conv and transposed conv (:32-85), and the
dense-flow execution's upsampled conv and the max pool of the masks and
of the loss's target pyramid (:88-145).

Channels-last ``[B, Z, Y, X, C]`` activations, weights in torch layout
(conv3d ``[Cout, Cin, k, k, k]``, conv_transpose3d ``[Cin, Cout, k, k, k]``),
as the JAX package stores them. The JAX package leaves these to XLA
outside any Pallas kernel, so they run as cuDNN convolutions here. The
conv runs in f32 on operands already rounded to the compute type and the
result is rounded back, which is where XLA rounds a bf16 convolution.

Both calls and their backward run under fixed cuDNN flags (``_CUDNN``),
scoped to the call:
- ``allow_tf32=False``: PyTorch's default lets cuDNN round f32 operands
  to TF32 (about three decimal digits) on the card, while the JAX trunk
  computes in f32;
- ``deterministic=True, benchmark=False``: with its default choice of
  algorithms cuDNN may sum in a different order from run to run, and the
  occupancy gates downstream turn a last-bit difference into a different
  surface. One scene must give one surface, as it does on the TPU.
At 1/8 resolution the deterministic algorithms cost little; the
secondary executions run them at full resolution too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

_CUDNN = dict(enabled=True, benchmark=False, deterministic=True,
              allow_tf32=False)


class _Conv(torch.autograd.Function):
    """A 3-D convolution (or transposed convolution) whose backward runs
    under ``_CUDNN`` as its forward does (autograd would run it later,
    outside the forward's flags)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.save_for_backward(x, w)
        pad = list(padding) if isinstance(padding, tuple) else [padding] * 3
        ctx.conf = ([stride] * 3, pad, transposed)
        fn = nnf.conv_transpose3d if transposed else nnf.conv3d
        with torch.backends.cudnn.flags(**_CUDNN):
            return fn(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.conf
        with torch.backends.cudnn.flags(**_CUDNN):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, [1] * 3, transposed, [0] * 3,
                1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def conv3d(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1,
           padding: int | tuple = 0) -> torch.Tensor:
    """nn.Conv3d on channels-last input; ``weight`` already rounded;
    ``padding`` one int or (z, y, x)."""
    y = _Conv.apply(x.permute(0, 4, 1, 2, 3).float(), weight, stride,
                    padding, False)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor, *,
                     stride: int = 2, padding: int = 1) -> torch.Tensor:
    """nn.ConvTranspose3d on channels-last input; ``weight`` already
    rounded."""
    y = _Conv.apply(x.permute(0, 4, 1, 2, 3).float(), weight, stride,
                    padding, True)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


# Per-axis fold of [2x NN upsample -> 3-tap conv] into the 4 taps of a
# stride-2 transposed conv on the coarse grid (sgnn_tpu/ops/dense.py:88-99):
# out[2p] = W[-1] x[p-1] + (W[0] + W[1]) x[p],
# out[2p+1] = (W[-1] + W[0]) x[p] + W[1] x[p+1].
_UPFOLD_T = torch.tensor([[1, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]],
                         dtype=torch.float32)  # [s=4, t=3]


def fold_upsample_conv_weights(weight: torch.Tensor) -> torch.Tensor:
    """A 27-tap conv weight [27, Cin, Cout] -> the [4, 4, 4, Cin, Cout]
    kernel of the equivalent stride-2 transposed conv on the coarse grid
    (summed in the weight's type)."""
    w = weight.reshape(3, 3, 3, *weight.shape[1:])
    t = _UPFOLD_T.to(weight.device, weight.dtype)
    return torch.einsum("abcio,xa,yb,zc->xyzio", w, t, t, t)


def upsampled_conv3d(x: torch.Tensor, weight27: torch.Tensor
                     ) -> torch.Tensor:
    """conv3x3x3(nn_upsample_2x(x)) on the coarse grid: x [B, Z, Y, X,
    Cin] -> [B, 2Z, 2Y, 2X, Cout]. The folded kernel is rounded to x's
    type (as the JAX package rounds it), then run as the input-dilated
    correlation it is: a stride-2 transposed conv of the flipped kernel,
    padding 1 (a cuDNN call, as XLA computes it outside any kernel)."""
    w = fold_upsample_conv_weights(weight27).to(x.dtype).float()
    w = torch.flip(w, (0, 1, 2)).permute(3, 4, 0, 1, 2)
    return conv_transpose3d(x, w, stride=2, padding=1)


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool3d(2) on a float [B, Z, Y, X]."""
    return nnf.max_pool3d(x[:, None], 2)[:, 0]
