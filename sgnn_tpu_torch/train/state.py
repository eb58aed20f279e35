"""The optimizer: Adam with torch semantics (port of
``sgnn_tpu/train/state.py``).

Adam(lr, betas=(0.9, 0.999), eps=1e-8) with optional L2 weight decay added
to the gradient before the moment updates (the reference's train.py:81;
``torch.optim.Adam`` computes the update of optax's
``add_decayed_weights`` + ``scale_by_adam``). The learning rate is set per
step (the StepLR schedule). ``adam_state``/``load_adam_state`` move the
moments and the step count to and from the JAX tree layout of a ``.ckpt``.
"""

from __future__ import annotations

import numpy as np
import torch

from sgnn_tpu_torch.params import tree_items


def make_optimizer(model, lr: float = 1e-3, weight_decay: float = 0.0
                   ) -> torch.optim.Adam:
    return torch.optim.Adam(model.weights, lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for g in opt.param_groups:
        g["lr"] = lr


def adam_state(opt: torch.optim.Adam, model) -> tuple[dict, dict, int]:
    """(mu, nu) as numpy trees in the params layout, and the step count
    (zeros and 0 before the first step)."""
    mu, nu, count = [], [], 0
    for p in model.weights:
        st = opt.state.get(p, {})
        zero = np.zeros(tuple(p.shape), np.float32)
        mu.append(st["exp_avg"].cpu().numpy() if st else zero)
        nu.append(st["exp_avg_sq"].cpu().numpy() if st else zero)
        count = int(st["step"]) if st else count
    return model.params_like(mu), model.params_like(nu), count


def load_adam_state(opt: torch.optim.Adam, model, mu: dict, nu: dict,
                    count: int) -> None:
    """Set the Adam moments and step count from numpy trees."""
    mus, nus = dict(tree_items(mu)), dict(tree_items(nu))
    for k, p in zip(model.param_keys, model.weights):
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(np.array(mus[k]), dtype=p.dtype,
                                       device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(nus[k]), dtype=p.dtype,
                                          device=p.device),
        }
