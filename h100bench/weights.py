"""Model weights made on the card from seeds, in a few large calls.

Every leaf of the reference's ``param_spec`` takes a slice of one normal
and one uniform draw of a generator seeded with the configuration's
``weights_seed``: convs N(0, sqrt(2 / fan_in)), dense layers
U(-b, b), BN scales and running variances U(0.8, 1.2), BN biases and
running means U(-0.1, 0.1) (random running stats, so that a BN read in the
wrong order shows). Each value is then scaled by (1 + ``jitter`` n), n
from a third draw seeded by the run's ``--seed``: the weights differ from
seed to seed, while the gates of random weights, which decide how many
voxels every level runs on, keep nearly the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference.sgnn import Net, leaves, param_spec, tree_map
from h100bench.rooms import torch_gen

BN_RANGES = {"bn_scale": (0.8, 1.2), "bn_var": (0.8, 1.2),
             "bn_bias": (-0.1, 0.1), "bn_mean": (-0.1, 0.1)}


def make_weights(net: Net, weights_seed: int, seed: int, jitter: float,
                 device) -> tuple[dict, dict]:
    """(params, stats) trees of f32 tensors on ``device``."""
    spec = param_spec(net)
    total = sum(int(np.prod(shape)) for tree in spec
                for _, (shape, _) in leaves(tree))
    g = torch_gen(weights_seed, device, 10)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    scale = 1 + jitter * torch.randn(total, device=device,
                                     generator=torch_gen(seed, device, 11))
    offsets = {}
    off = 0
    for t, tree in enumerate(spec):
        for path, (shape, _) in leaves(tree):
            offsets[(t, path)] = off
            off += int(np.prod(shape))

    def leaf(t):
        def make(path, spec_leaf):
            shape, init = spec_leaf
            o = offsets[(t, path)]
            n = int(np.prod(shape))
            if isinstance(init, str):
                lo, hi = BN_RANGES[init]
                v = lo + (hi - lo) * uniform[o:o + n]
            elif init[0] == "normal":
                v = init[1] * normal[o:o + n]
            else:
                v = init[1] * (2 * uniform[o:o + n] - 1)
            return (v * scale[o:o + n]).reshape(shape).contiguous()
        return make

    return tuple(tree_map(leaf(t), tree) for t, tree in enumerate(spec))


def to_numpy(tree):
    """A tree of tensors as numpy f32 arrays (the port's loader's input)."""
    return tree_map(lambda _, v: v.detach().float().cpu().numpy(), tree)
