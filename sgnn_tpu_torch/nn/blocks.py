"""Building blocks of the coordinate-list execution over SparseTensors
(port of ``sgnn_tpu/nn/blocks.py``, the eval-mode apply side; the
parameter trees come from ``params.init_params`` or the JAX package).

Blocks take a *prepared* subtree (``PreparedTree``): every BN node
already holds its eval constants (``ops/bn.prepare_eval_tree``), every
other leaf the f32 parameter. The wiring follows the reference for
checkpoint parity:
  * residual block: identity + BN-ReLU-conv x2;
  * encoder layer: subm conv -> residual block -> BN-ReLU (the skip) ->
    stride-2 conv -> BN-ReLU;
  * sparse U-Net: per level a residual block, then [identity | BN-ReLU ->
    stride-2 conv -> recurse -> unpool] concatenated.
All submanifold convs at one active-site set share one index grid.
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


def bn_relu(p: dict, feats: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """Eval BN + ReLU of the rows of ``feats`` with a prepared BN node;
    rows where ``mask`` is False are zero."""
    return BN.batch_norm_rows(feats, mask, p["mean"], p["inv"], p["bias"])


def resblock_apply(p: dict, st: SparseTensor, *, index_grid=None,
                   backend: str, impl: str | None = None) -> SparseTensor:
    if index_grid is None:
        index_grid = st.index_grid()
    mask = st.valid()
    kw = dict(index_grid=index_grid, backend=backend, impl=impl)
    y = bn_relu(p["bn0"], st.feats, mask)
    y = CV.submanifold_conv3d(st.with_feats(y), p["conv0"], **kw).feats
    y = bn_relu(p["bn1"], y, mask)
    y = CV.submanifold_conv3d(st.with_feats(y), p["conv1"], **kw).feats
    return st.with_feats(st.feats + y)


def encoder_layer_apply(p: dict, st: SparseTensor, *, out_capacity: int,
                        backend: str, impl: str | None = None):
    """Returns (the downsampled SparseTensor, the skip ft2)."""
    kw = dict(index_grid=st.index_grid(), backend=backend, impl=impl)
    x = CV.submanifold_conv3d(st, p["p1"], **kw)
    x = resblock_apply(p["p2"], x, **kw)
    ft2 = x.with_feats(bn_relu(p["p2_bn"], x.feats, x.valid()))
    x = CV.strided_conv3d_down(ft2, p["p3"], out_capacity=out_capacity, **kw)
    return x.with_feats(bn_relu(p["p3_bn"], x.feats, x.valid())), ft2


def sparse_unet_apply(p: dict, st: SparseTensor, *, backend: str,
                      impl: str | None = None) -> SparseTensor:
    """FullyConvolutionalNet (reps=1, residual): the output carries the
    widths of every level (identity first, then the unpooled deeper
    branch)."""
    index_grid = st.index_grid()
    x = resblock_apply(p["block"], st, index_grid=index_grid,
                       backend=backend, impl=impl)
    if "deeper" not in p:
        return x
    y = bn_relu(p["down_bn"], x.feats, x.valid())
    down = CV.strided_conv3d_down(x.with_feats(y), p["down_conv"],
                                  out_capacity=x.capacity,
                                  index_grid=index_grid, backend=backend,
                                  impl=impl)
    deep = sparse_unet_apply(p["deeper"], down, backend=backend, impl=impl)
    up = CV.unpool_x2(x.locs, x.num_valid, deep)
    return x.with_feats(torch.cat([x.feats, up.feats], -1))
