"""Eval-mode batch norm of dense channels-last grids (port of the eval path
of ``sgnn_tpu/ops/bn.py``: ``nn.BatchNorm3d`` semantics, eps 1e-5)."""

from __future__ import annotations

import numpy as np
import torch

DENSE_BN_EPS = 1e-5


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
