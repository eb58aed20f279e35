"""Sparse 3-D convolutions of the coordinate-list execution (port of
``sgnn_tpu/ops/conv.py``).

Two backends compute one function, selected by ``backend`` (the
config's ``conv_backend``), passed explicitly down every call:

- ``"gather"``: the input's index grid gives each output row's
  neighbour rows (``neighbor_rows``, held by a ``NeighbourList``), and
  ``gather_gemm`` contracts them with the taps (K10 on the card, forward
  and, under autograd, the input gradient over the list's inverse). The
  convs of one active-site set share one list (``neighbours``), so its
  inverse is built once;
- ``"dense"``: densify, one dense conv, gather at the active sites. The
  JAX package leaves these convs to XLA, so they are cuDNN calls here,
  under the dense trunk's flags (``ops/dense.py``: f32, no TF32,
  deterministic), on operands rounded to the compute type, under autograd
  too.

Submanifold semantics: inactive sites are absent from the index grid, so
the op is a zero-padded dense conv evaluated at the active sites.
"""

from __future__ import annotations

import torch

from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops import dense as D
from sgnn_tpu_torch.ops.kernels import gather_gemm as K_gg
from sgnn_tpu_torch.ops.sparse import (SparseTensor, gather_dense,
                                       make_sparse, sparse_to_dense)

BACKENDS = ("gather", "dense")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"conv backend {backend!r}, expected one of "
                         f"{BACKENDS}")


def gather_gemm(feats: torch.Tensor, nbr_rows: torch.Tensor,
                weight: torch.Tensor, *, impl: str | None = None, nbr=None
                ) -> torch.Tensor:
    """y[n] = sum_k W[k] @ feats[nbr_rows[n, k] - 1], 0 for missing
    neighbours, in feats' type (K10 for a CUDA tensor)."""
    return K_gg.gather_gemm(feats, nbr_rows, weight, impl=impl, nbr=nbr)


def neighbor_rows(locs: torch.Tensor, index_grid: torch.Tensor,
                  offsets: torch.Tensor, spatial_size: tuple,
                  batch_size: int, *, scale: int = 1) -> torch.Tensor:
    """int32 [cap, K]: row + 1 of each row's neighbour at
    ``locs * scale + offset`` in the index grid's volume, 0 if absent."""
    cap, K = locs.shape[0], offsets.shape[0]
    zyx = locs[:, None, :3] * scale + offsets[None]
    b = locs[:, None, 3:4].expand(cap, K, 1)
    keys = C.flat_key_nd(torch.cat([zyx, b], -1), spatial_size, batch_size)
    return C.lookup(keys, index_grid)


def neighbours(st: SparseTensor, backend: str, index_grid=None, *,
               filter_size: int = 3):
    """The submanifold neighbour list of ``st``'s sites for the "gather"
    backend (None for "dense", which needs none)."""
    if backend != "gather":
        return None
    if index_grid is None:
        index_grid = st.index_grid()
    rows = neighbor_rows(st.locs, index_grid,
                         C.neighbor_offsets(filter_size, st.locs.device),
                         st.spatial_size, st.batch_size)
    return K_gg.NeighbourList(rows, st.num_valid, st.capacity)


def _dense_weight(weight: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """[k^3, Cin, Cout] -> torch conv layout [Cout, Cin, k, k, k], f32
    holding values rounded to ``dtype``."""
    w = weight.to(dtype).float().reshape(k, k, k, *weight.shape[1:])
    return w.permute(4, 3, 0, 1, 2)


def submanifold_conv3d(st: SparseTensor, weight: torch.Tensor, *,
                       filter_size: int = 3, index_grid=None, nbr=None,
                       backend: str = "gather", impl: str | None = None
                       ) -> SparseTensor:
    """scn.SubmanifoldConvolution: output sites == input sites. Weight
    [filter_size^3, Cin, Cout], taps in C order. ``nbr``: the sites'
    neighbour list (``neighbours``), built here when not given."""
    _check_backend(backend)
    if weight.shape[0] != filter_size ** 3:
        raise ValueError(f"weight taps {weight.shape[0]} != "
                         f"{filter_size ** 3}")
    valid = st.valid()[:, None]
    if backend == "dense":
        dense = sparse_to_dense(st)
        y = D.conv3d(dense, _dense_weight(weight, filter_size, dense.dtype),
                     padding=(filter_size - 1) // 2)
        return st.with_feats(torch.where(valid, gather_dense(y, st.locs), 0))
    if nbr is None:
        nbr = neighbours(st, backend, index_grid, filter_size=filter_size)
    out = gather_gemm(st.masked_feats(), nbr.rows, weight, impl=impl,
                      nbr=nbr)
    return st.with_feats(torch.where(valid, out, 0))


def strided_conv3d_down(st: SparseTensor, weight: torch.Tensor, *,
                        out_capacity: int | None = None, index_grid=None,
                        backend: str = "gather", impl: str | None = None
                        ) -> SparseTensor:
    """scn.Convolution(filter 2, stride 2): the output sites are the
    unique parents of the active sites (key order), each gathering its
    up to 8 active children. Weight [8, Cin, Cout]."""
    _check_backend(backend)
    if weight.shape[0] != 8:
        raise ValueError(f"strided conv weight {tuple(weight.shape)}")
    Z, Y, X = st.spatial_size
    out_size = (Z // 2, Y // 2, X // 2)
    cap_out = out_capacity if out_capacity is not None else st.capacity
    out_locs, num_out, _ = C.unique_locs(C.parent_locs(st.locs),
                                         st.num_valid, out_size,
                                         st.batch_size, cap_out)
    if backend == "dense":
        dense = sparse_to_dense(st)
        y = D.conv3d(dense, _dense_weight(weight, 2, dense.dtype), stride=2)
        out = gather_dense(y, out_locs)
    else:
        if index_grid is None:
            index_grid = st.index_grid()
        rows = neighbor_rows(out_locs, index_grid,
                             C.neighbor_offsets(2, st.locs.device),
                             st.spatial_size, st.batch_size, scale=2)
        nbr = K_gg.NeighbourList(rows, num_out, st.capacity)
        out = gather_gemm(st.masked_feats(), rows, weight, impl=impl,
                          nbr=nbr)
    valid = C.valid_mask(num_out, cap_out, out.device)[:, None]
    return make_sparse(out_locs, torch.where(valid, out, 0), num_out,
                       out_size, st.batch_size)


def unpool_x2(fine_locs: torch.Tensor, fine_num_valid: int,
              coarse: SparseTensor, *, coarse_index_grid=None
              ) -> SparseTensor:
    """scn.UnPooling(2, 2): each fine site reads its parent's coarse
    feature (0 where the parent is absent)."""
    if coarse_index_grid is None:
        coarse_index_grid = coarse.index_grid()
    keys = C.flat_key(C.parent_locs(fine_locs), coarse.spatial_size,
                      coarse.batch_size)
    rows = C.lookup(keys, coarse_index_grid).long()
    table = torch.cat([coarse.feats.new_zeros(1, coarse.num_channels),
                       coarse.masked_feats()])
    Z, Y, X = coarse.spatial_size
    return make_sparse(fine_locs, table[rows], fine_num_valid,
                       (Z * 2, Y * 2, X * 2), coarse.batch_size)
