"""The ``.ckpt`` checkpoint format: reader and writer.

Port of ``sgnn_tpu/train/checkpoint.py`` (:19-65). A checkpoint is one
``.npz`` holding the JAX package's TrainState leaves, each keyed by its
jax key-path string, plus a JSON manifest:

    .params['encoder']['process_sparse'][0]['p1']   model weights
    .stats[...]                                      BN running stats
    .opt_state.mu[...], .opt_state.nu[...]           Adam moments
    .opt_state.count, .step                          int32 scalars
    __meta__                                         uint8 JSON bytes

(with weight decay the JAX optimizer is a chain and its Adam state sits at
``.opt_state[1]``; the reader takes either, the writer writes the one its
``weight_decay`` gives). The trees are the numpy ``(params, stats)`` trees
of ``params.init_params``, which ``params.load_jax_params`` takes.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.params import init_params, tree_build, tree_items

_ADAM_PREFIXES = (".opt_state", ".opt_state[1]")


@dataclasses.dataclass
class Checkpoint:
    params: dict
    stats: dict
    mu: dict  # Adam first moments, shaped like params
    nu: dict  # Adam second moments
    count: int  # Adam step count
    step: int
    meta: dict  # __meta__: epoch, iteration and any extra keys


def _read_tree(data, template, prefix: str, path: str):
    """A tree shaped like ``template`` with the leaves under ``prefix``."""
    def leaf(key, ref):
        if prefix + key not in data.files:
            raise KeyError(f"{path}: checkpoint missing leaf {prefix + key}")
        val = data[prefix + key]
        if val.shape != ref.shape:
            raise ValueError(f"{path}: shape mismatch at {prefix + key}: "
                             f"ckpt {val.shape} vs template {ref.shape}")
        return val
    return tree_build(template, leaf)


def load_checkpoint(path, cfg: SGNNConfig) -> Checkpoint:
    """Read a ``.ckpt`` written by either package; every leaf is checked
    against the shapes ``init_params(cfg)`` gives."""
    params_t, stats_t = init_params(cfg, 0)
    with np.load(path, allow_pickle=False) as data:
        adam = next((p for p in _ADAM_PREFIXES
                     if f"{p}.count" in data.files), None)
        if adam is None:
            raise KeyError(f"{path}: no Adam state (.opt_state.count)")
        return Checkpoint(
            params=_read_tree(data, params_t, ".params", path),
            stats=_read_tree(data, stats_t, ".stats", path),
            mu=_read_tree(data, params_t, f"{adam}.mu", path),
            nu=_read_tree(data, params_t, f"{adam}.nu", path),
            count=int(data[f"{adam}.count"]),
            step=int(data[".step"]),
            meta=json.loads(bytes(data["__meta__"]).decode()),
        )


def save_checkpoint(path, params: dict, stats: dict, *, epoch: int,
                    iteration: int, step: int = 0, mu: dict | None = None,
                    nu: dict | None = None, count: int = 0,
                    weight_decay: float = 0.0,
                    extra: dict | None = None) -> None:
    """Write a ``.ckpt`` that the JAX package's ``load_checkpoint`` reads
    into the TrainState of an optimizer with this ``weight_decay``: Adam's
    state at ``.opt_state`` without decay, at ``.opt_state[1]`` (the
    optax chain's second state) with it. Moments are zero unless given.
    Written to a temporary file, then renamed."""
    adam = _ADAM_PREFIXES[1] if weight_decay > 0 else _ADAM_PREFIXES[0]
    payload = {}
    for name, tree in ((".params", params), (".stats", stats),
                       (f"{adam}.mu", mu), (f"{adam}.nu", nu)):
        for key, leaf in tree_items(params if tree is None else tree):
            payload[name + key] = (np.zeros_like(leaf) if tree is None
                                   else np.asarray(leaf, np.float32))
    payload[f"{adam}.count"] = np.asarray(count, np.int32)
    payload[".step"] = np.asarray(step, np.int32)
    meta = {"epoch": epoch, "iteration": iteration, **(extra or {})}
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, os.path.basename(path) + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
