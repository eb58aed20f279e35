"""Batch norm (port of ``sgnn_tpu/ops/bn.py``): dense channels-last grids
(``batch_norm_dense``: ``nn.BatchNorm3d`` semantics, eps 1e-5) in the eval
form with precomputed constants and in the training form with batch
moments (all-reduced over a process group under data parallelism or
spatial sharding) and the running-stats update; and the masked rows of
the sparse levels (``batch_norm`` with a mask, scn's eps 1e-4): the eval
form with precomputed constants (``batch_norm_rows``) and the form over
parameter tensors (``batch_norm``, with the batch moments of the mask's
rows when training)."""

from __future__ import annotations

import numpy as np
import torch

from sgnn_tpu_torch.parallel import comm

SPARSE_BN_EPS = 1e-4
DENSE_BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # retain factor: new_running = m * old + (1 - m) * batch


def eval_constants(params: dict, stats: dict, eps: float = DENSE_BN_EPS):
    """(mean, inv, bias) f32 with inv = rsqrt(var + eps) * scale."""
    mean, var, scale, bias = (
        torch.tensor(np.asarray(a, np.float32))
        for a in (stats["mean"], stats["var"], params["scale"], params["bias"])
    )
    return mean, torch.rsqrt(var + eps) * scale, bias


def batch_norm_eval(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """relu((x - mean) * inv + bias) over the last axis, in f32, rounded
    back to x's type."""
    y = ((x.float() - mean) * inv + bias).clamp_min(0.0)
    return y.to(x.dtype)


def batch_norm_rows(x: torch.Tensor, mask: torch.Tensor | None,
                    mean: torch.Tensor, inv: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Eval-mode BN + ReLU over the last axis, rounded to x's type, then
    zero where ``mask`` (broadcast over the last axis) is False: the
    order ops/bn.py:batch_norm rounds in."""
    y = batch_norm_eval(x, mean, inv, bias)
    return y if mask is None else torch.where(mask[..., None], y, 0)


def prepare_eval_tree(params, stats, eps: float = SPARSE_BN_EPS):
    """A copy of a (params, stats) subtree as f32 CPU tensors in which
    every BN node ``{"scale", "bias"}`` becomes its eval constants
    ``{"mean", "inv", "bias"}`` (eval_constants, computed on the CPU so
    that the card's approximate rsqrt never enters them); other leaves
    are kept unrounded."""
    if isinstance(params, dict) and set(params) == {"scale", "bias"}:
        return dict(zip(("mean", "inv", "bias"),
                        eval_constants(params, stats, eps)))
    if isinstance(params, dict):
        return {k: prepare_eval_tree(v, (stats or {}).get(k), eps)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [prepare_eval_tree(p, s, eps)
                for p, s in zip(params, stats or [None] * len(params))]
    return torch.tensor(np.asarray(params, np.float32))


def masked_moments(x: torch.Tensor, mask: torch.Tensor | None,
                   group=None):
    """(mean, biased var, count) f32 over the rows of ``x [..., C]`` where
    ``mask [...]`` is True (every row without a mask), in one pass:
    E[x^2] - E[x]^2, the count clamped to at least 1, the variance to at
    least 0 (torch.relu: gradient 0 at exactly 0). With ``group`` (a
    process group or a tuple of them) the count and the sums are summed
    over its ranks first, where ops/bn.py:56-59 psums them (one
    all-reduce; its backward all-reduces the cotangents)."""
    xf = x.float().reshape(-1, x.shape[-1])
    if mask is not None:
        m = mask.reshape(-1, 1).float()
        count = m.sum()
        s, sq = (xf * m).sum(0), (xf * xf * m).sum(0)
    else:
        count = torch.tensor(float(xf.shape[0]), device=x.device)
        s, sq = xf.sum(0), (xf * xf).sum(0)
    count, s, sq = comm.all_reduce_each([count, s, sq], group)
    count = count.clamp_min(1.0)
    mean = s / count
    return mean, torch.relu(sq / count - mean * mean), count


def batch_norm(params: dict, stats: dict, x: torch.Tensor,
               mask: torch.Tensor | None = None, *, training: bool,
               eps: float = SPARSE_BN_EPS, momentum: float = BN_MOMENTUM,
               group=None, relu: bool = True):
    """BN + ReLU (BN alone without ``relu``) over the last axis of ``x
    [..., C]`` with parameter tensors (ops/bn.py:batch_norm; every model
    site takes the ReLU). Training: the batch moments
    of the rows where ``mask [...]`` is True (over the ranks of ``group``
    too, as ``axis_name`` there), and the running stats updated with the
    unbiased variance (detached); eval: the running stats. The output is
    rounded to x's type, then zero where ``mask`` is False. Returns (y,
    new stats)."""
    if training:
        mean, var, count = masked_moments(x, mask, group)
        unbiased = var * (count / (count - 1.0).clamp_min(1.0))
        new_stats = {
            "mean": (momentum * stats["mean"]
                     + (1.0 - momentum) * mean).detach(),
            "var": (momentum * stats["var"]
                    + (1.0 - momentum) * unbiased).detach(),
        }
    else:
        mean, var, new_stats = stats["mean"], stats["var"], stats
    inv = torch.rsqrt(var + eps) * params["scale"]
    y = (x.float() - mean) * inv + params["bias"]
    y = (torch.relu(y) if relu else y).to(x.dtype)
    if mask is not None:
        y = torch.where(mask[..., None], y, 0)
    return y, new_stats


def batch_norm_dense(params: dict, stats: dict, x: torch.Tensor, *,
                     training: bool, eps: float = DENSE_BN_EPS,
                     momentum: float = BN_MOMENTUM, group=None,
                     relu: bool = True):
    """BN + ReLU (``relu`` False: ``nn.BatchNorm3d`` alone) over the last
    axis of ``x [..., C]``, every voxel counted (ops/bn.py:
    batch_norm_dense): ``batch_norm`` without a mask at the dense eps.
    Returns (y in x's type, new stats). The clamps are torch.relu:
    gradient 0 at exactly 0."""
    return batch_norm(params, stats, x, training=training, eps=eps,
                      momentum=momentum, group=group, relu=relu)
