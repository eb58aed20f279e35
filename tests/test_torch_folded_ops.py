"""The port's folded-layout ops against sgnn_tpu/ops/folded.py on the CPU.

Inputs are made with numpy from a seed and fed to both packages; f32
results must be bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgnn_tpu.ops import folded as JFO
from sgnn_tpu_torch.ops import folded as FO

DIMS = (4, 6, 20)  # X not a multiple of F: exercises the x tail
B = 2


def _dense(rng, C, dims=DIMS):
    return rng.randn(B, *dims, C).astype(np.float32)


def _jfg(fg):
    return JFO.FGrid(jnp.asarray(fg.data.numpy()), fg.dims, fg.real_c,
                     fg.cpad)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cpad,C", [(8, 3), (8, 8), (16, 5), (16, 16)])
def test_fold_unfold(cpad, C):
    d = _dense(np.random.RandomState(C), C)
    fg = FO.fold(torch.from_numpy(d), cpad)
    jfg = JFO.fold(jnp.asarray(d), cpad)
    _eq(fg.data, jfg.data)
    assert (fg.dims, fg.real_c, fg.cpad) == (jfg.dims, jfg.real_c, jfg.cpad)
    _eq(FO.unfold(fg), JFO.unfold(jfg))
    _eq(FO.unfold(fg), d)


@pytest.mark.parametrize("cpad", [8, 16])
def test_fold_mask(cpad):
    m = np.random.RandomState(1).rand(B, *DIMS) < 0.6
    _eq(FO.fold_mask(torch.from_numpy(m), cpad, torch.float32).data,
        JFO.fold_mask(jnp.asarray(m), cpad, jnp.float32).data)


@pytest.mark.parametrize("cpad", [8, 16])
def test_scatter_sparse(cpad):
    rng = np.random.RandomState(2)
    Z, Y, X = DIMS
    n, cap = 150, 200
    flat = rng.choice(B * Z * Y * X, n, replace=False)
    b, rem = flat // (Z * Y * X), flat % (Z * Y * X)
    z, rem = rem // (Y * X), rem % (Y * X)
    locs = np.full((cap, 4), -1, np.int32)
    locs[:n] = np.stack([z, rem // X, rem % X, b], -1)
    feats = np.zeros((cap, 1), np.float32)
    feats[:n, 0] = rng.uniform(-2.99, 2.99, n)
    fg, fm = FO.scatter_sparse(torch.from_numpy(locs), torch.from_numpy(feats),
                               n, DIMS, B, cpad=cpad, dtype=torch.float32,
                               feat_bound=3.0)
    jfg, jfm = JFO.scatter_sparse(jnp.asarray(locs), jnp.asarray(feats),
                                  jnp.int32(n), DIMS, B, cpad=cpad,
                                  dtype=jnp.float32, feat_bound=3.0)
    _eq(fg.data, jfg.data)
    _eq(fm.data, jfm.data)
    assert int((fm.data[..., ::cpad] > 0).sum()) == n


@pytest.mark.parametrize("cpad,C", [(8, 6), (16, 16)])
def test_upsample2(cpad, C):
    d = _dense(np.random.RandomState(3), C)
    fg = FO.fold(torch.from_numpy(d), cpad)
    up = FO.upsample2_folded(fg)
    jup = JFO.upsample2_folded(_jfg(fg))
    _eq(up.data, jup.data)
    assert up.dims == jup.dims


@pytest.mark.parametrize("X", [20, 32, 48])
def test_repack_cpad(X):
    """Against the JAX function, and against an independent unfold -> fold
    at the wider budget (the JAX test of this op compares the function
    with a copy of itself)."""
    d = _dense(np.random.RandomState(4), 7, (4, 6, X))
    fg = FO.fold(torch.from_numpy(d), 8)
    rp = FO.repack_cpad(fg, 16)
    _eq(rp.data, JFO.repack_cpad(_jfg(fg), 16).data)
    _eq(rp.data, FO.fold(FO.unfold(fg), 16).data)
    assert (rp.real_c, rp.cpad) == (7, 16)


def _bn_params(rng, C):
    return ({"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
             "bias": rng.randn(C).astype(np.float32)},
            {"mean": rng.randn(C).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, C).astype(np.float32)})


@pytest.mark.parametrize("cpad,C", [(8, 8), (16, 10)])
def test_bn_folded_eval(cpad, C):
    rng = np.random.RandomState(5)
    p, s = _bn_params(rng, C)
    fg = FO.fold(torch.from_numpy(_dense(rng, C)), cpad)
    fm = FO.fold_mask(torch.from_numpy(rng.rand(B, *DIMS) < 0.6), cpad,
                      torch.float32)
    jy, _ = JFO.bn_folded(p, s, _jfg(fg), _jfg(fm), training=False)
    mean, inv, bias = FO.bn_eval_constants(p, s, C)
    # XLA's CPU rsqrt is not correctly rounded (torch's is): the constants
    # agree to an ulp, and the folded pass is bit-equal given XLA's
    jinv = np.array(jax.lax.rsqrt(jnp.asarray(s["var"]) + 1e-4)
                    * p["scale"])
    np.testing.assert_allclose(inv.numpy(), jinv, rtol=2e-7, atol=0)
    y = FO.bn_folded(fg, fm, mean, torch.from_numpy(jinv), bias)
    _eq(y.data, jy.data)


@pytest.mark.parametrize("cpad", [8, 16])
def test_eval_affine(cpad):
    rng = np.random.RandomState(6)
    p, s = _bn_params(rng, 24)
    a, b = FO.eval_affine(p, s, 6, off=5)
    ja, jb = JFO._eval_affine(p, s, 6, cpad, off=5)
    F = 128 // cpad
    tile = lambda v: np.tile(np.pad(v.numpy(), (0, cpad - 6)), F)  # noqa
    np.testing.assert_allclose(tile(a), np.asarray(ja), rtol=2e-7, atol=0)
    np.testing.assert_allclose(tile(b), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
