"""Model parameters: seeded initialisation and the one way weights enter.

``init_params(cfg, seed)`` returns numpy ``(params, stats)`` trees with the
nested dict structure, key names and shapes of the JAX package's
``genmodel_init`` (sgnn_tpu/models/sgnn.py:278) and the same
distributions (sgnn_tpu/nn/init.py), drawn from a numpy generator.

``load_jax_params(model, params, stats)`` takes such trees — from
``init_params`` or from the JAX package (``jax.device_get`` of its
params/stats) — checks them against the model's configuration and fills
the model: the serving model's site modules, which prepare their
kernel-ready weights, or the training model's parameters and running
stats. ``export_params(model)`` gives a training model's trees back as
numpy, for ``GenModelFolded`` and ``checkpoint.save_checkpoint``.

``tree_items`` and ``tree_build`` walk such trees in the JAX package's
flatten order and name each leaf by its ``jax.tree_util.keystr`` path.
"""

from __future__ import annotations

import numpy as np

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import trunk_layers

_F32 = np.float32


def _subm_conv(rng, filter_volume: int, cin: int, cout: int) -> np.ndarray:
    """SparseConvNet conv init: N(0, sqrt(2 / fan_in))."""
    std = (2.0 / (filter_volume * cin)) ** 0.5
    return (std * rng.standard_normal((filter_volume, cin, cout))).astype(_F32)


def _uniform(rng, shape, fan_in: int) -> np.ndarray:
    bound = (1.0 / fan_in) ** 0.5
    return rng.uniform(-bound, bound, shape).astype(_F32)


def _linear(rng, cin: int, cout: int) -> dict:
    """Torch nn.Linear default, stored [cin, cout]."""
    return {"weight": _uniform(rng, (cin, cout), cin),
            "bias": _uniform(rng, (cout,), cin)}


def _bn(c: int) -> tuple[dict, dict]:
    return ({"scale": np.ones(c, _F32), "bias": np.zeros(c, _F32)},
            {"mean": np.zeros(c, _F32), "var": np.ones(c, _F32)})


def _resblock(rng, nf: int):
    (pb0, sb0), (pb1, sb1) = _bn(nf), _bn(nf)
    return ({"bn0": pb0, "conv0": _subm_conv(rng, 27, nf, nf),
             "bn1": pb1, "conv1": _subm_conv(rng, 27, nf, nf)},
            {"bn0": sb0, "bn1": sb1})


def _encoder_layer(rng, nf_in: int, nf: int):
    p_res, s_res = _resblock(rng, nf)
    (p_bno, s_bno), (p_bn3, s_bn3) = _bn(nf), _bn(nf)
    return ({"p1": _subm_conv(rng, 27, nf_in, nf), "p2": p_res,
             "p2_bn": p_bno, "p3": _subm_conv(rng, 8, nf, nf),
             "p3_bn": p_bn3},
            {"p2": s_res, "p2_bn": s_bno, "p3_bn": s_bn3})


def _unet(rng, n_planes: list):
    nf = n_planes[0]
    p_res, s_res = _resblock(rng, nf)
    if len(n_planes) == 1:
        return {"block": p_res}, {"block": s_res}
    p_bn, s_bn = _bn(nf)
    p_deep, s_deep = _unet(rng, n_planes[1:])
    return ({"block": p_res, "down_bn": p_bn,
             "down_conv": _subm_conv(rng, 8, nf, n_planes[1]),
             "deeper": p_deep},
            {"block": s_res, "down_bn": s_bn, "deeper": s_deep})


def _refinement(rng, nf_in: int, nf: int):
    p_unet, s_unet = _unet(rng, [nf, nf, nf])
    (p_bn3, s_bn3), (p_n2, s_n2) = _bn(nf * 3), _bn(nf)
    return ({"p1": _subm_conv(rng, 27, nf_in, nf), "p2": p_unet,
             "p3": p_bn3, "n1": _subm_conv(rng, 27, nf * 3, nf),
             "n2": p_n2, "linear": _linear(rng, nf, 1),
             "linearsdf": _linear(rng, nf, 1)},
            {"p2": s_unet, "p3": s_bn3, "n2": s_n2})


def _surface(rng, nf_in: int, nf: int):
    p_unet, s_unet = _unet(rng, [nf, nf, nf])
    p_bn3, s_bn3 = _bn(nf * 3)
    return ({"p1": _subm_conv(rng, 27, nf_in, nf), "p2": p_unet,
             "p3": p_bn3, "linear": _linear(rng, nf * 3, 1)},
            {"p2": s_unet, "p3": s_bn3})


def init_params(cfg: SGNNConfig, seed: int = 0) -> tuple[dict, dict]:
    """Random (params, stats) in the JAX package's tree layout."""
    from sgnn_tpu_torch.models.folded_flow import refine_widths

    rng = np.random.default_rng(seed)
    enc_p, enc_s = {"process_sparse": []}, {"process_sparse": []}
    nf_in = cfg.input_nf
    for nf in cfg.nf_per_level:
        p, s = _encoder_layer(rng, nf_in, nf)
        enc_p["process_sparse"].append(p)
        enc_s["process_sparse"].append(s)
        nf_in = nf
    for name, cin, cout, k, _, _, tr in trunk_layers(cfg):
        shape = (cin, cout, k, k, k) if tr else (cout, cin, k, k, k)
        p_bn, s_bn = _bn(cout)
        enc_p[name] = {"conv": _uniform(rng, shape, cin * k ** 3),
                       "bn": p_bn}
        enc_s[name] = {"bn": s_bn}
    for name in ("occpred", "sdfpred"):
        enc_p[name] = _uniform(rng, (1, cfg.nf_coarse, 1, 1, 1),
                               cfg.nf_coarse)
    ref_w, surf_w = refine_widths(cfg)
    refs = [_refinement(rng, sum(w), cfg.nf) for w in ref_w]
    surf_p, surf_s = _surface(rng, sum(surf_w), cfg.nf)
    params = {"encoder": enc_p, "refinement": [p for p, _ in refs],
              "surfacepred": surf_p}
    stats = {"encoder": enc_s, "refinement": [s for _, s in refs],
             "surfacepred": surf_s}
    return params, stats


def _check_tree(ref, got, path: str) -> None:
    if isinstance(ref, dict):
        if not isinstance(got, dict) or set(ref) != set(got):
            keys = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"{path}: keys {keys}, expected {sorted(ref)}")
        for k in ref:
            _check_tree(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(ref):
            raise ValueError(f"{path}: expected a list of {len(ref)}")
        for i, (r, g) in enumerate(zip(ref, got)):
            _check_tree(r, g, f"{path}/{i}")
    elif np.shape(got) != ref.shape:
        raise ValueError(f"{path}: shape {np.shape(got)}, expected "
                         f"{ref.shape}")


def load_jax_params(model, params: dict, stats: dict) -> None:
    """Fill ``model`` (a GenModelFolded) from numpy (params, stats) trees in
    the JAX package's layout. Raises ValueError on a tree that does not
    match the model's configuration."""
    ref_p, ref_s = init_params(model.cfg, 0)
    _check_tree(ref_p, params, "params")
    _check_tree(ref_s, stats, "stats")
    model.load(params, stats)


def tree_items(tree, prefix: str = ""):
    """(key-path string, leaf) pairs of a dict/list tree, in the order
    and the form ``jax.tree_util.tree_flatten_with_path`` and ``keystr``
    give them (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_build(template, leaf, prefix: str = ""):
    """A tree shaped like ``template`` whose leaves are
    ``leaf(key-path string, template leaf)``."""
    if isinstance(template, dict):
        return {k: tree_build(v, leaf, f"{prefix}['{k}']")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [tree_build(v, leaf, f"{prefix}[{i}]")
                for i, v in enumerate(template)]
    return leaf(prefix, template)


def export_params(model) -> tuple[dict, dict]:
    """A training model's (params, stats) as numpy f32 trees."""
    def host(t):
        return t.detach().cpu().numpy()
    return (model.params_like([host(t) for t in model.weights]),
            tree_build(model.stat_tree(), lambda _, t: host(t)))
