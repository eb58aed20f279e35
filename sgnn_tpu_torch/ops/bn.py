"""Batch norm of dense channels-last grids (port of ``sgnn_tpu/ops/bn.py``
``batch_norm_dense``: ``nn.BatchNorm3d`` semantics, eps 1e-5): the eval
form with precomputed constants, and the training form with batch
moments and the running-stats update."""

from __future__ import annotations

import numpy as np
import torch

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


def batch_norm_dense(params: dict, stats: dict, x: torch.Tensor, *,
                     training: bool, eps: float = DENSE_BN_EPS,
                     momentum: float = BN_MOMENTUM):
    """BN + ReLU over the last axis of ``x [..., C]`` with parameter tensors
    (ops/bn.py:batch_norm, relu=True). Training: one-pass batch moments
    (E[x^2] - E[x]^2) over every voxel, and the running stats updated with
    the unbiased variance (detached); eval: the running stats. Returns
    (y in x's type, new stats). The clamps are torch.relu: gradient 0 at
    exactly 0, as jnp.maximum's."""
    if training:
        xf = x.float().reshape(-1, x.shape[-1])
        n = max(float(xf.shape[0]), 1.0)
        mean = xf.sum(0) / n
        var = torch.relu((xf * xf).sum(0) / n - mean * mean)
        unbiased = var * (n / max(n - 1.0, 1.0))
        new_stats = {
            "mean": (momentum * stats["mean"]
                     + (1.0 - momentum) * mean).detach(),
            "var": (momentum * stats["var"]
                    + (1.0 - momentum) * unbiased).detach(),
        }
    else:
        mean, var, new_stats = stats["mean"], stats["var"], stats
    inv = torch.rsqrt(var + eps) * params["scale"]
    y = torch.relu((x.float() - mean) * inv + params["bias"])
    return y.to(x.dtype), new_stats
