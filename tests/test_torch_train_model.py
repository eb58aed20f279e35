"""The port's folded training forward against the JAX package's
``genmodel_apply_folded_train``, on the CPU in f32 (the kernels' plain
versions; the JAX side on its XLA compositions).

The configuration of tests/test_folded_train.py:17-21: (32, 32, 32),
batch 2, L = 3, encoder_dim 4, nf 8, which reaches cpad 8 at level 0 and
the cross down site. Same weights and input rows (numpy seed) on both
sides. Compared: the coarse output (1e-4, as test_folded_train), every
level's raw heads (1e-3), the level masks and the surface mask
bit-equal, the surface sdf (1e-3), every new running stat (1e-4), and
the gradient of the loss of test_folded_train.py:91-99 for every
parameter to 5e-3 of that parameter's largest |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import sgnn as M
from sgnn_tpu.models.folded_train import genmodel_apply_folded_train as jfwd
from sgnn_tpu.ops.sparse import make_sparse
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.folded_train import GenModelFoldedTrain
from sgnn_tpu_torch.ops import kernels as K
from sgnn_tpu_torch.params import export_params, load_jax_params, tree_items

CFG = dict(input_dim=(32, 32, 32), batch_size=2, num_hierarchy_levels=3,
           encoder_dim=4, nf_coarse=8, nf=8, compute_dtype="float32")


def _rows(n=600, seed=0):
    rng = np.random.RandomState(seed)
    locs = np.stack([rng.randint(0, 32, n), rng.randint(0, 32, n),
                     rng.randint(0, 32, n), rng.randint(0, 2, n)], -1)
    _, first = np.unique(locs, axis=0, return_index=True)
    locs = locs[np.sort(first)].astype(np.int32)  # input voxels are unique
    feats = rng.rand(len(locs), 1).astype(np.float32) * 4 - 2
    return locs, feats


def _loss_j(out):
    t = sum(jnp.sum(o * o) for o in out.refine_outs)
    return (jnp.sum(out.coarse_out ** 2) + t
            + jnp.sum(jnp.where(out.surf_mask, out.surf_sdf, 0.0) ** 2))


def _loss_t(out):
    t = sum((o * o).sum() for o in out.refine_outs)
    return ((out.coarse_out ** 2).sum() + t
            + torch.where(out.surf_mask, out.surf_sdf, 0.0).pow(2).sum())


@pytest.fixture(scope="module")
def runs():
    cfg = JConfig(execution="folded", **CFG)
    params, stats = jax.jit(M.genmodel_init, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    locs, feats = _rows()
    st = make_sparse(jnp.asarray(locs), jnp.asarray(feats), len(locs),
                     cfg.input_dim, cfg.batch_size)

    def f(p):
        out, s = jfwd(p, stats, cfg, st, num_refine_active=2, do_surf=True,
                      training=True)
        return _loss_j(out), (out, s)

    (jl, (jout, js)), jg = jax.value_and_grad(f, has_aux=True)(params)
    weights = jax.device_get((params, stats))

    model = GenModelFoldedTrain(SGNNConfig(**CFG))
    load_jax_params(model, *weights)
    K.reset_launch_counts()
    out, s = model(torch.from_numpy(locs), torch.from_numpy(feats),
                   len(locs), num_refine_active=2, do_surf=True)
    loss = _loss_t(out)
    loss.backward()
    assert set(K.launch_counts().values()) == {0}  # CPU: plain versions
    return dict(jax=(float(jl), jout, jax.device_get(js),
                     jax.device_get(jg)),
                port=(float(loss.detach()), out, s, model), weights=weights)


def test_forward(runs):
    jl, jout, _, _ = runs["jax"]
    loss, out, _, _ = runs["port"]
    np.testing.assert_allclose(loss, jl, rtol=1e-4)
    np.testing.assert_allclose(out.coarse_out.detach().numpy(),
                               np.asarray(jout.coarse_out), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(out.refine_outs, jout.refine_outs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-3, atol=1e-3)
    for a, b in zip(out.refine_masks_unfilt, jout.refine_masks_unfilt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert 0 < int(a.sum()) < a.numel()
    np.testing.assert_array_equal(out.surf_mask.numpy(),
                                  np.asarray(jout.surf_mask))
    assert int(out.surf_mask.sum()) > 0
    np.testing.assert_allclose(out.surf_sdf.detach().numpy(),
                               np.asarray(jout.surf_sdf), rtol=1e-3,
                               atol=1e-3)


def test_new_stats(runs):
    _, _, js, _ = runs["jax"]
    _, _, s, _ = runs["port"]
    want = dict(tree_items(js))
    got = list(tree_items(s))
    assert [k for k, _ in got] == list(want)
    for k, v in got:
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_gradients(runs):
    _, _, _, jg = runs["jax"]
    model = runs["port"][3]
    want = dict(tree_items(jg))
    assert model.param_keys == list(want)
    for k, p in zip(model.param_keys, model.weights):
        b = np.asarray(want[k])
        assert p.grad is not None, k
        denom = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / denom, b / denom,
                                   atol=5e-3, err_msg=k)


def test_export_roundtrip(runs):
    """export_params gives back the loaded trees."""
    params, stats = runs["weights"]
    model = GenModelFoldedTrain(SGNNConfig(**CFG))
    load_jax_params(model, params, stats)
    p2, s2 = export_params(model)
    for (ka, a), (kb, b) in zip(tree_items(params), tree_items(p2)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(a), b)
    for (ka, a), (kb, b) in zip(tree_items(stats), tree_items(s2)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(a), b)
