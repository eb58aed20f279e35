"""K6: the input scatter (csrc/scatter.cu).

Port of sgnn_tpu/ops/pallas/scatter_folded.py ``scatter_slots_folded``
(:92) together with the encode and decode around it in ops/folded.py
``scatter_sparse`` (:248-295). Sparse TSDF rows become the level-0 feature
grid (the value on the voxel's channel-0 lane) and its mask grid (1 on all
the voxel's lanes), both ``[B, Z+2, Y+2, xq, 128]`` with a zero ring. A
row's value is encoded as e = feat + K in f32 (K a power of two above
|feat|) and decoded as (e - K, mask 1) when e > 0, else (e, mask 0): the
rounding of the JAX package's one-scatter form. Rows are unique voxels;
rows outside the grid are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
launches = 0  # kernel launches since the last reset_launch_counts()


def scatter(locs: torch.Tensor, feats: torch.Tensor, dims: tuple,
            batch_size: int, cpad: int, xq: int, dtype: torch.dtype,
            K: float, *, impl: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``locs [n, 4]`` int64 (z, y, x, b) rows, ``feats [n, 1]`` float32
    -> (feature grid, mask grid) of ``dims`` at lane budget ``cpad``."""
    global launches
    if cpad not in (8, 16) or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scatter: cpad {cpad}, dtype {dtype}")
    n = locs.shape[0]
    if (locs.dtype != torch.int64 or locs.dim() != 2 or locs.shape[1] != 4
            or not locs.is_contiguous()):
        raise ValueError(f"scatter: locs {locs.dtype} {tuple(locs.shape)}")
    if (feats.dtype != torch.float32 or tuple(feats.shape) != (n, 1)
            or not feats.is_contiguous() or feats.device != locs.device):
        raise ValueError(f"scatter: feats {feats.dtype} "
                         f"{tuple(feats.shape)} on {feats.device}")
    Z, Y, _ = dims
    shape = (batch_size, Z + 2, Y + 2, xq, LANES)
    if not build.use_kernel(feats, impl):
        return scatter_plain(locs, feats, dims, batch_size, cpad, xq, dtype,
                             K)
    data = torch.zeros(shape, dtype=dtype, device=feats.device)
    mask = torch.zeros(shape, dtype=dtype, device=feats.device)
    if n:
        rc = build.lib().sgnn_scatter(
            build.ptr(locs), build.ptr(feats), n, K, build.ptr(data),
            build.ptr(mask), batch_size, *dims, xq, cpad,
            build.is_bf16(data), build.stream(feats),
        )
        launches += 1
        build.check(rc, "scatter")
    return data, mask


def scatter_plain(locs: torch.Tensor, feats: torch.Tensor, dims: tuple,
                  batch_size: int, cpad: int, xq: int, dtype: torch.dtype,
                  K: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One f32 index_put of feat + K into a slot buffer (dropped rows go
    to one spare slot past its end), then the sign decode and the lane
    expansion."""
    Z, Y, X = dims
    Xs = xq * (LANES // cpad)
    z, y, x, b = locs.unbind(1)
    keep = ((z >= 0) & (z < Z) & (y >= 0) & (y < Y) & (x >= 0) & (x < X)
            & (b >= 0) & (b < batch_size))
    total = batch_size * (Z + 2) * (Y + 2) * Xs
    slot = ((b * (Z + 2) + z + 1) * (Y + 2) + y + 1) * Xs + x
    enc = torch.zeros(total + 1, dtype=torch.float32, device=feats.device)
    enc[torch.where(keep, slot, total)] = feats[:, 0] + K
    enc = enc[:total].view(batch_size, Z + 2, Y + 2, Xs)
    occ = enc > 0
    small = (enc - K * occ).to(dtype)
    shape = (batch_size, Z + 2, Y + 2, xq, LANES)
    data = F.pad(small[..., None], (0, cpad - 1)).reshape(shape)
    mask = occ.to(dtype)[..., None].expand(*occ.shape, cpad).reshape(shape)
    return data, mask
