"""SparseTensor, the coordinate-list voxel tensor of the sparse execution
(port of ``sgnn_tpu/ops/sparse.py``):

    locs      int32 [capacity, 4]  (z, y, x, batch); padding rows -1
    feats     float [capacity, C]  padding rows 0
    num_valid int                  rows [0, num_valid) are valid

The capacities are fixed as in the JAX package: the rows that ``compact``
and ``unique_locs`` drop beyond a capacity are part of what the
execution computes, and the overflow counts report them.
"""

from __future__ import annotations

import dataclasses

import torch

from sgnn_tpu_torch.ops import coords as C


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    locs: torch.Tensor
    feats: torch.Tensor
    num_valid: int
    spatial_size: tuple
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.locs.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    def valid(self) -> torch.Tensor:
        return C.valid_mask(self.num_valid, self.capacity, self.locs.device)

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        assert feats.shape[0] == self.capacity
        return dataclasses.replace(self, feats=feats)

    def masked_feats(self) -> torch.Tensor:
        """Features with the padding rows forced to zero."""
        return torch.where(self.valid()[:, None], self.feats, 0)

    def index_grid(self) -> torch.Tensor:
        return C.build_index_grid(self.locs, self.num_valid,
                                  self.spatial_size, self.batch_size)


def make_sparse(locs: torch.Tensor, feats: torch.Tensor, num_valid: int,
                spatial_size, batch_size: int) -> SparseTensor:
    """A SparseTensor with int32 locs and its padding rows normalised."""
    locs = locs.to(torch.int32)
    if feats.dim() == 1:
        feats = feats[:, None]
    num_valid = int(num_valid)
    mask = C.valid_mask(num_valid, locs.shape[0], locs.device)[:, None]
    return SparseTensor(
        locs=torch.where(mask, locs, C.INVALID_COORD).to(torch.int32),
        feats=torch.where(mask, feats, 0),
        num_valid=num_valid,
        spatial_size=tuple(int(s) for s in spatial_size),
        batch_size=int(batch_size),
    )


def sparse_to_dense(st: SparseTensor, default_val: float = 0.0
                    ) -> torch.Tensor:
    """The valid rows' features in a dense [B, Z, Y, X, C] grid."""
    Z, Y, X = st.spatial_size
    B, Cn = st.batch_size, st.num_channels
    keys = C.flat_key(st.locs, st.spatial_size, B).long()
    ok = st.valid() & (keys >= 0)
    flat = torch.full((B * Z * Y * X, Cn), default_val, dtype=st.feats.dtype,
                      device=st.feats.device)
    flat[keys[ok]] = st.feats[ok]
    return flat.reshape(B, Z, Y, X, Cn)


def gather_dense(dense: torch.Tensor, locs: torch.Tensor,
                 fill_value: float = 0.0) -> torch.Tensor:
    """Rows of a dense [B, Z, Y, X, ...] grid at ``locs``; invalid rows
    read ``fill_value``."""
    B, Z, Y, X = dense.shape[:4]
    keys = C.flat_key(locs, (Z, Y, X), B).long()
    flat = dense.reshape(B * Z * Y * X, *dense.shape[4:])
    out = flat[keys.clamp_min(0)]
    ok = (keys >= 0).reshape(-1, *([1] * (out.dim() - 1)))
    return torch.where(ok, out, fill_value)


def dense_to_sparse(dense: torch.Tensor, keep: torch.Tensor,
                    capacity: int) -> SparseTensor:
    """The sites of a dense [B, Z, Y, X, C] grid where ``keep``, in flat
    index order, cut to ``capacity`` rows."""
    B, Z, Y, X, Cn = dense.shape
    idx = torch.nonzero(keep.reshape(-1)).squeeze(1)
    total = int(idx.shape[0])
    idx = idx[:capacity]
    b, rem = idx // (Z * Y * X), idx % (Z * Y * X)
    z, rem = rem // (Y * X), rem % (Y * X)
    locs = torch.full((capacity, 4), C.INVALID_COORD, dtype=torch.int32,
                      device=dense.device)
    locs[:idx.shape[0]] = torch.stack([z, rem // X, rem % X, b],
                                      -1).to(torch.int32)
    feats = torch.zeros(capacity, Cn, dtype=dense.dtype, device=dense.device)
    feats[:idx.shape[0]] = dense.reshape(-1, Cn)[idx]
    return SparseTensor(locs, feats, min(total, capacity), (Z, Y, X), B)
