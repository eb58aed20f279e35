"""Building blocks of the coordinate-list execution over SparseTensors
(port of ``sgnn_tpu/nn/blocks.py``, the apply side; the parameter trees
come from ``params.init_params`` or the JAX package).

Each block takes its parameter subtree, its running-stats subtree and a
``bn(params, stats, x, mask) -> (y, new stats)`` that applies one BN node
with its ReLU: ``prepared_bn`` for the serving forward, whose tree is
*prepared* (``PreparedTree``: every BN node already holds its eval
constants, ``ops/bn.prepare_eval_tree``; stats None), or ``ops/bn.
batch_norm`` over parameter tensors (batch moments when training, summed
over a process group bound in with ``functools.partial(..., group=)``:
the JAX blocks' ``axis_name``). Each returns its new stats subtree. The
wiring follows the reference for checkpoint parity:
  * residual block: identity + BN-ReLU-conv x2;
  * encoder layer: subm conv -> residual block -> BN-ReLU (the skip) ->
    stride-2 conv -> BN-ReLU;
  * sparse U-Net: per level a residual block, then [identity | BN-ReLU ->
    stride-2 conv -> recurse -> unpool] concatenated.
All submanifold convs at one active-site set share one neighbour list.
"""

from __future__ import annotations

import torch
from torch import nn

from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import conv as CV
from sgnn_tpu_torch.ops.sparse import SparseTensor


class PreparedTree(nn.Module):
    """A nested dict/list tree of tensors held as buffers, so that
    ``.to(device)`` moves it; ``load`` copies a tree of the same layout
    in, ``tree()`` gives it back as nested dicts and lists."""

    def __init__(self, template):
        super().__init__()
        self._names = self._register(template, [0])

    def _register(self, t, counter):
        if isinstance(t, dict):
            return {k: self._register(v, counter) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [self._register(v, counter) for v in t]
        name = f"leaf{counter[0]}"
        counter[0] += 1
        self.register_buffer(name, torch.zeros_like(t))
        return name

    def load(self, tree) -> None:
        def copy(names, t):
            if isinstance(names, dict):
                if set(names) != set(t):
                    raise ValueError(f"keys {sorted(t)}, expected "
                                     f"{sorted(names)}")
                for k in names:
                    copy(names[k], t[k])
            elif isinstance(names, list):
                for n, v in zip(names, t, strict=True):
                    copy(n, v)
            else:
                getattr(self, names).copy_(t)
        copy(self._names, tree)

    def tree(self):
        def build(names):
            if isinstance(names, dict):
                return {k: build(v) for k, v in names.items()}
            if isinstance(names, list):
                return [build(v) for v in names]
            return getattr(self, names)
        return build(self._names)


def prepared_bn(p: dict, s, feats: torch.Tensor, mask: torch.Tensor):
    """Eval BN + ReLU of the rows of ``feats`` with a prepared BN node;
    rows where ``mask`` is False are zero. The stats pass through."""
    return BN.batch_norm_rows(feats, mask, p["mean"], p["inv"],
                              p["bias"]), s


def sub(stats, key):
    """A stats subtree, or None for a prepared tree's (absent) stats."""
    return None if stats is None else stats[key]


def resblock_apply(p: dict, s, st: SparseTensor, *, bn, nbr=None,
                   backend: str, impl: str | None = None):
    if nbr is None:
        nbr = CV.neighbours(st, backend)
    mask = st.valid()
    kw = dict(nbr=nbr, backend=backend, impl=impl)
    new = {}
    y, new["bn0"] = bn(p["bn0"], sub(s, "bn0"), st.feats, mask)
    y = CV.submanifold_conv3d(st.with_feats(y), p["conv0"], **kw).feats
    y, new["bn1"] = bn(p["bn1"], sub(s, "bn1"), y, mask)
    y = CV.submanifold_conv3d(st.with_feats(y), p["conv1"], **kw).feats
    return st.with_feats(st.feats + y), new


def encoder_layer_apply(p: dict, s, st: SparseTensor, *, out_capacity: int,
                        bn, backend: str, impl: str | None = None):
    """Returns (the downsampled SparseTensor, the skip ft2, new stats)."""
    grid = st.index_grid()
    kw = dict(backend=backend, impl=impl)
    nbr = CV.neighbours(st, backend, grid)
    new = {}
    x = CV.submanifold_conv3d(st, p["p1"], nbr=nbr, **kw)
    x, new["p2"] = resblock_apply(p["p2"], sub(s, "p2"), x, bn=bn, nbr=nbr,
                                  **kw)
    y, new["p2_bn"] = bn(p["p2_bn"], sub(s, "p2_bn"), x.feats, x.valid())
    ft2 = x.with_feats(y)
    x = CV.strided_conv3d_down(ft2, p["p3"], out_capacity=out_capacity,
                               index_grid=grid, **kw)
    y, new["p3_bn"] = bn(p["p3_bn"], sub(s, "p3_bn"), x.feats, x.valid())
    return x.with_feats(y), ft2, new


def sparse_unet_apply(p: dict, s, st: SparseTensor, *, bn, nbr=None,
                      backend: str, impl: str | None = None):
    """FullyConvolutionalNet (reps=1, residual): the output carries the
    widths of every level (identity first, then the unpooled deeper
    branch). Returns (it, new stats)."""
    grid = st.index_grid()
    if nbr is None:
        nbr = CV.neighbours(st, backend, grid)
    kw = dict(backend=backend, impl=impl)
    new = {}
    x, new["block"] = resblock_apply(p["block"], sub(s, "block"), st, bn=bn,
                                     nbr=nbr, **kw)
    if "deeper" not in p:
        return x, new
    y, new["down_bn"] = bn(p["down_bn"], sub(s, "down_bn"), x.feats,
                           x.valid())
    down = CV.strided_conv3d_down(x.with_feats(y), p["down_conv"],
                                  out_capacity=x.capacity, index_grid=grid,
                                  **kw)
    deep, new["deeper"] = sparse_unet_apply(p["deeper"], sub(s, "deeper"),
                                            down, bn=bn, **kw)
    up = CV.unpool_x2(x.locs, x.num_valid, deep)
    return x.with_feats(torch.cat([x.feats, up.feats], -1)), new
