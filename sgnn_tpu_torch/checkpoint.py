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
``.opt_state[1]``). The trees are the numpy ``(params, stats)`` trees of
``params.init_params``, which ``params.load_jax_params`` takes.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.params import init_params

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


def _paths(tree, prefix: str):
    """(key-path string, leaf) pairs of a dict/list tree, in the form
    ``jax.tree_util.keystr`` gives them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _read_tree(data, template, prefix: str, path: str):
    """A tree shaped like ``template`` with the leaves under ``prefix``."""
    if isinstance(template, dict):
        return {k: _read_tree(data, v, f"{prefix}['{k}']", path)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_read_tree(data, v, f"{prefix}[{i}]", path)
                for i, v in enumerate(template)]
    if prefix not in data.files:
        raise KeyError(f"{path}: checkpoint missing leaf {prefix}")
    val = data[prefix]
    if val.shape != template.shape:
        raise ValueError(f"{path}: shape mismatch at {prefix}: ckpt "
                         f"{val.shape} vs template {template.shape}")
    return val


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
                    extra: dict | None = None) -> None:
    """Write a ``.ckpt`` that the JAX package's ``load_checkpoint`` reads
    (the Adam state of an optimizer without weight decay; moments zero
    unless given). Written to a temporary file, then renamed."""
    zeros = {k: np.zeros_like(v) for k, v in _paths(params, "")}
    payload = {}
    for name, tree in (("params", params), ("stats", stats),
                       ("opt_state.mu", mu), ("opt_state.nu", nu)):
        for key, leaf in _paths(params if tree is None else tree, ""):
            payload[f".{name}{key}"] = (zeros[key] if tree is None
                                        else np.asarray(leaf, np.float32))
    payload[".opt_state.count"] = np.asarray(count, np.int32)
    payload[".step"] = np.asarray(step, np.int32)
    meta = {"epoch": epoch, "iteration": iteration, **(extra or {})}
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, os.path.basename(path) + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
