"""Spatial sharding of channels-last grids along z (port of
``sgnn_tpu/parallel/spatial.py``).

A scene too large for one card is cut along z into one slab a rank of the
space group; a 3^3 convolution needs one plane of each neighbour's slab,
which ``halo_exchange`` brings in (``comm.shift``: point-to-point over
NCCL, or through pinned host buffers over gloo). Grids are ``[B, Z, Y, X,
C]``, sharded on z (axis 1), as the dense flow holds them; weights in
torch layout ``[Cout, Cin, k, k, k]``.
"""

from __future__ import annotations

import torch

from sgnn_tpu_torch.ops import dense as D
from sgnn_tpu_torch.parallel import comm


def halo_exchange(x: torch.Tensor, halo: int, group, *, axis: int = 1
                  ) -> torch.Tensor:
    """Append the neighbours' boundary slabs along ``axis``: [..., Zl, ...]
    -> [..., Zl + 2 * halo, ...]. The ranks at the ends of the group (and a
    group of one) get zeros (spatial.py:23-43). Differentiable."""
    top = x.narrow(axis, x.shape[axis] - halo, halo)
    bot = x.narrow(axis, 0, halo)
    from_prev, from_next = comm.shift(top, bot, group)
    return torch.cat([from_prev, x, from_next], axis)


def sharded_conv3d(x: torch.Tensor, weight: torch.Tensor, group, *,
                   stride: int = 1, padding: int = 1) -> torch.Tensor:
    """3-D conv of a z-sharded grid, zero-padded at the global boundary:
    k = 3, stride 1, padding 1 (the halo is exchanged and z is not padded)
    or k = stride = 2, padding 0 on an even local z (no halo needed)."""
    k = weight.shape[2]
    if stride == 1:
        xh = halo_exchange(x, padding, group) if padding else x
        return D.conv3d(xh, weight, padding=(0, padding, padding))
    if not (k == stride == 2 and padding == 0):
        raise ValueError(f"sharded_conv3d: k {k}, stride {stride}, padding "
                         f"{padding}")
    if x.shape[1] % 2:
        raise ValueError(f"sharded_conv3d: local z {x.shape[1]} is odd")
    return D.conv3d(x, weight, stride=2)


def sharded_max_pool2(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 max pool of a z-sharded float [B, Z, Y, X] (even local
    z)."""
    if x.shape[1] % 2:
        raise ValueError(f"sharded_max_pool2: local z {x.shape[1]} is odd")
    return D.max_pool3d(x)
