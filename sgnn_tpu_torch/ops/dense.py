"""Dense 3D convolutions of the 1/8-resolution trunk (port of
``sgnn_tpu/ops/dense.py:32-85``).

Channels-last ``[B, Z, Y, X, C]`` activations, weights in torch layout
(conv3d ``[Cout, Cin, k, k, k]``, conv_transpose3d ``[Cin, Cout, k, k, k]``),
as the JAX package stores them. The JAX package leaves these to XLA
outside any Pallas kernel, so they run as cuDNN convolutions here. The
conv runs in f32 on operands already rounded to the compute type and the
result is rounded back, which is where XLA rounds a bf16 convolution.

Both calls run under fixed cuDNN flags (``_CUDNN``), scoped to the call:
- ``allow_tf32=False``: PyTorch's default lets cuDNN round f32 operands
  to TF32 (about three decimal digits) on the card, while the JAX trunk
  computes in f32;
- ``deterministic=True, benchmark=False``: with its default choice of
  algorithms cuDNN may sum in a different order from run to run, and the
  occupancy gates downstream turn a last-bit difference into a different
  surface. One scene must give one surface, as it does on the TPU.
At 1/8 resolution the deterministic algorithms cost little.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

_CUDNN = dict(enabled=True, benchmark=False, deterministic=True,
              allow_tf32=False)


def conv3d(x: torch.Tensor, weight: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """nn.Conv3d on channels-last input; ``weight`` already rounded."""
    with torch.backends.cudnn.flags(**_CUDNN):
        y = nnf.conv3d(x.permute(0, 4, 1, 2, 3).float(), weight,
                       stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor, *,
                     stride: int = 2, padding: int = 1) -> torch.Tensor:
    """nn.ConvTranspose3d on channels-last input; ``weight`` already
    rounded."""
    with torch.backends.cudnn.flags(**_CUDNN):
        y = nnf.conv_transpose3d(x.permute(0, 4, 1, 2, 3).float(), weight,
                                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)
