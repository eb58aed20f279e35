"""The port's config copy, seeded init and weight loading against the JAX
package's SGNNConfig and genmodel_init."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import sgnn as JM
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.folded_flow import (
    ConvSite, DownSite, GenModelFolded, UpSite,
)
from sgnn_tpu_torch.params import init_params, load_jax_params

CONFIGS = [
    dict(encoder_dim=4, input_dim=(16, 16, 16), nf_coarse=8, nf=8,
         num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
         occupancy_fractions=(1.0, 1.0, 1.0), execution="dense_flow"),
    dict(input_dim=(96, 192, 192), batch_size=1,
         occupancy_fractions=(1.0, 0.4, 0.2, 0.1), compute_dtype="bfloat16"),
    dict(num_hierarchy_levels=2, input_dim=(32, 32, 32),
         use_skip_sparse=False, use_skip_dense=False, pass_occ=False),
    dict(),
]


def test_config_fields_match():
    want = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(SGNNConfig)]
    assert got == want


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_properties_match(kw):
    a, b = SGNNConfig(**kw), JConfig(**kw)
    assert a == SGNNConfig(**dataclasses.asdict(b))
    assert a.nf_per_level == b.nf_per_level
    assert a.level_capacities == b.level_capacities
    assert a.input_cap == b.input_cap
    assert a.num_refine_levels == b.num_refine_levels
    assert [a.level_spatial(h) for h in range(3)] == \
        [b.level_spatial(h) for h in range(3)]
    assert a.for_scene((64, 64, 64)).input_dim == \
        b.for_scene((64, 64, 64)).input_dim


def _tree_shapes(t):
    if isinstance(t, dict):
        return {k: _tree_shapes(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_shapes(v) for v in t]
    return (tuple(t.shape), str(t.dtype))


@pytest.mark.parametrize("kw", CONFIGS)
def test_init_tree_matches_genmodel_init(kw):
    p, s = init_params(SGNNConfig(**kw), seed=3)
    jp, js = jax.eval_shape(lambda k: JM.genmodel_init(k, JConfig(**kw)),
                            jax.random.PRNGKey(0))
    assert _tree_shapes(p) == _tree_shapes(jp)
    assert _tree_shapes(s) == _tree_shapes(js)


def _dicts(t, path=()):
    if isinstance(t, dict):
        yield path, t
        for k, v in t.items():
            yield from _dicts(v, path + (k,))
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _dicts(v, path + (i,))


def test_init_distributions():
    """He-normal sparse convs, torch-default uniform dense convs and
    linears, identity BN (sgnn_tpu/nn/init.py, ops/bn.py:init_bn)."""
    cfg = SGNNConfig(**CONFIGS[1])
    p, s = init_params(cfg, seed=0)
    n = 0
    for path, d in _dicts(p):
        if "scale" in d:  # BN
            assert (d["scale"] == 1).all() and (d["bias"] == 0).all(), path
            continue
        if "weight" in d:  # linear [cin, cout]: U(+-1/sqrt(cin))
            bound = d["weight"].shape[0] ** -0.5
            for a in d.values():
                assert np.abs(a).max() <= bound, path
            assert d["weight"].std() > bound / 3, path
            n += 1
        for k, a in d.items():
            if not isinstance(a, np.ndarray):
                continue
            if a.ndim == 3:  # [taps, cin, cout]: N(0, sqrt(2 / fan_in))
                std = (2.0 / (a.shape[0] * a.shape[1])) ** 0.5
                assert abs(a.std() / std - 1) < 0.25, (path, k)
                n += 1
            elif a.ndim == 5:  # dense conv: U(+-1/sqrt(cin k^3))
                cin = a.shape[0] if "decode" in str(path) else a.shape[1]
                bound = (cin * a.shape[2] ** 3) ** -0.5
                assert np.abs(a).max() <= bound + 1e-7, (path, k)
                n += 1
    assert n > 50
    for path, d in _dicts(s):
        if "var" in d:
            assert (d["var"] == 1).all() and (d["mean"] == 0).all(), path
    q, _ = init_params(cfg, seed=0)
    r, _ = init_params(cfg, seed=1)
    a0 = q["refinement"][0]["p1"]
    assert (a0 == p["refinement"][0]["p1"]).all()
    assert not (a0 == r["refinement"][0]["p1"]).all()


def _param_path(name):
    """Module name -> path of its weight in the JAX params tree."""
    rename = {"encoder": ("encoder", "process_sparse"),
              "surface": ("surfacepred",), "down": ("down_conv",),
              "up": ("n1",)}
    path = []
    for part in name.split("."):
        if part.isdigit():
            path.append(int(part))
        else:
            path.extend(rename.get(part, (part,)))
    return path


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_load_jax_params_round_trip():
    """Every site's prepared weights give back the JAX arrays it was
    loaded from (f32: the rounding is the identity)."""
    cfg = SGNNConfig(**CONFIGS[0])
    params, stats = jax.device_get(jax.jit(
        JM.genmodel_init, static_argnums=1)(jax.random.PRNGKey(1),
                                            JConfig(**CONFIGS[0])))
    model = GenModelFolded(cfg)
    load_jax_params(model, params, stats)
    seen = {ConvSite: 0, DownSite: 0, UpSite: 0}
    for name, mod in model.named_modules():
        if isinstance(mod, ConvSite):
            w27 = _get(params, _param_path(name))
            off = 0
            for g, c in enumerate(mod.widths):
                got = mod.w[g, :, :c, :w27.shape[2]].numpy()
                np.testing.assert_array_equal(got, w27[:, off:off + c])
                off += c
            assert off == w27.shape[1]
        elif isinstance(mod, DownSite):
            w8 = _get(params, _param_path(name))
            np.testing.assert_array_equal(
                mod.w[:, :w8.shape[1], :w8.shape[2]].numpy(), w8)
        elif isinstance(mod, UpSite):
            # every original tap lands on exactly one combined tap of each
            # fine parity, so each parity's taps sum to the 27 taps' sum
            w27 = _get(params, _param_path(name))
            total = mod.w.sum(dim=2)[:, :, :, :w27.shape[2]]
            off = 0
            for g, c in enumerate(mod.widths):
                want = w27[:, off:off + c].sum(0)
                for par in range(8):
                    np.testing.assert_allclose(total[g, par, :c].numpy(),
                                               want, rtol=1e-5, atol=1e-6)
                off += c
        else:
            continue
        seen[type(mod)] += 1
    # L=3: 2 encoder levels, 2 refinement levels and the surface head
    assert seen == {ConvSite: 2 * 3 + 3 * 7, DownSite: 2 + 3 * 2, UpSite: 2}
    head = model.refinement[1].head.w.numpy()
    ref = params["refinement"][1]
    np.testing.assert_array_equal(head[:8, 0], ref["linear"]["weight"][:, 0])
    np.testing.assert_array_equal(head[:8, 1],
                                  ref["linearsdf"]["weight"][:, 0])
    np.testing.assert_array_equal(
        model.trunk.layers["decode_dense3"].w.numpy(),
        params["encoder"]["decode_dense3"]["conv"])


def test_load_jax_params_rejects_mismatch():
    cfg = SGNNConfig(**CONFIGS[0])
    params, stats = init_params(cfg, 0)
    model = GenModelFolded(cfg)
    bad = dict(params, surfacepred=dict(params["surfacepred"]))
    del bad["surfacepred"]["linear"]
    with pytest.raises(ValueError, match="surfacepred"):
        load_jax_params(model, bad, stats)
    bad = dict(params, encoder=dict(params["encoder"]))
    bad["encoder"]["occpred"] = np.zeros((2, 8, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="occpred"):
        load_jax_params(model, bad, stats)
    load_jax_params(model, params, stats)
    assert model.surface.head.w.dtype == torch.float32
