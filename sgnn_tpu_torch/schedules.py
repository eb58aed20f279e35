"""Host-side training schedules (pure functions of the iteration count).

A copy of ``sgnn_tpu/schedules.py`` (the JAX package cannot be imported
without jax).
"""

from __future__ import annotations

import numpy as np


def get_loss_weights(iteration: int, num_hierarchy_levels: int,
                     num_iters_per_level: int,
                     factor_l1_loss: float) -> np.ndarray:
    """Progressive level fade-in (the reference's train.py:203-231): one
    hierarchy level activates every num_iters_per_level iterations; the
    next level's weight fades in with a stepped linear ramp (step_factor
    20) at the tail of each window; the final surface L1 weight fades in
    last."""
    weights = np.zeros(num_hierarchy_levels + 1, dtype=np.float32)
    cur_level = iteration // num_iters_per_level
    if cur_level > num_hierarchy_levels:
        weights.fill(1)
        weights[-1] = factor_l1_loss
        return weights
    for level in range(0, cur_level + 1):
        weights[level] = 1.0
    step_factor = 20
    fade_amount = max(1.0, min(100, num_iters_per_level // step_factor))
    fade_level = iteration % num_iters_per_level
    cur_weight = 0.0
    l1_weight = 0.0
    if fade_level >= num_iters_per_level - fade_amount + step_factor:
        fade_level_step = (
            fade_level - num_iters_per_level + fade_amount
        ) // step_factor
        cur_weight = float(fade_level_step) / float(fade_amount // step_factor)
    if cur_level + 1 < num_hierarchy_levels:
        weights[cur_level + 1] = cur_weight
    elif cur_level < num_hierarchy_levels:
        l1_weight = factor_l1_loss * cur_weight
    else:
        l1_weight = 1.0
    weights[-1] = l1_weight
    return weights


def active_levels(loss_weights: np.ndarray) -> tuple[int, bool]:
    """Loss weights -> (num_refine_active, do_surf): refinement level h
    runs iff loss_weights[h+1] > 0 (levels activate coarse to fine, so a
    count suffices); the surface runs iff its weight is > 0 and every
    refinement level runs."""
    L = len(loss_weights) - 1  # num_hierarchy_levels
    n = 0
    for h in range(1, L):
        if loss_weights[h] > 0:
            n = h
        else:
            break
    do_surf = bool(loss_weights[-1] > 0) and n == L - 1
    return n, do_surf


def step_lr(base_lr: float, epoch: int, decay_epochs: int,
            gamma: float = 0.5) -> float:
    """StepLR(step_size=decay_epochs, gamma=0.5): halve every N epochs
    (the reference's train.py:89)."""
    return base_lr * (gamma ** (epoch // decay_epochs))
