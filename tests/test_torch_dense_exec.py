"""The dense-flow execution of the port against the JAX package's.

Same inputs, made with numpy from a seed, go through each JAX function
and its counterpart in sgnn_tpu_torch: K8's plain version against
``conv3d_3x3x3_folded`` and K9's against ``conv3d_3x3x3_pallas``, both
in interpret mode (f32 1e-5 of the output scale, bf16 2 ulps of it),
K8's ``supported()`` on a grid of shapes and its gradients against
``jax.vjp`` (1e-5 of scale); the upsampled conv and the max pool; and
the whole ``genmodel_apply_dense`` on a tiny model, with the Pallas conv
routed wherever the JAX package routes it (``pallas_min_voxels=0``; the
same number of K8 calls as JAX's kernel calls) and without (f32: masks
bit-equal, coarse 1e-4, levels and surface 2e-3; bf16: see
``_compare_bf16``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import dense_flow as JDF
from sgnn_tpu.ops import dense as JD
from sgnn_tpu.ops.sparse import make_sparse as jmake_sparse
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.dense_flow import GenModelDense
from sgnn_tpu_torch.ops import dense as D
from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl
from sgnn_tpu_torch.ops.sparse import make_sparse
from sgnn_tpu_torch.params import init_params, load_jax_params
from test_torch_model import _surface_rows

CFG = dict(encoder_dim=8, input_dim=(16, 16, 32), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0), execution="dense_flow")


def _tol(ref, dtype):
    scale = float(np.abs(ref).max())
    if dtype == "bfloat16":
        return 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    return 1e-5 * scale + 1e-6


def _interpret(module):
    """Context: ``module``'s pallas_call runs in interpret mode."""
    import contextlib

    import jax.experimental.pallas as pl

    @contextlib.contextmanager
    def ctx():
        orig = pl.pallas_call
        module.pl.pallas_call = lambda *a, **k: orig(
            *a, **{**k, "interpret": True})
        try:
            yield
        finally:
            module.pl.pallas_call = orig
    return ctx()


def _masked(rng, shape, frac=0.4):
    x = rng.randn(*shape).astype(np.float32)
    return x * (rng.rand(*shape[:-1], 1) < frac)


# ------------------------------------------------------------ K8 and K9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,cout,X", [(8, 8, 16), (16, 1, 8), (16, 12, 16),
                                      (32, 32, 4), (32, 5, 8)])
def test_conv3d_folded_plain_matches_jax(rng, dtype, C, cout, X):
    """K8's plain version against the Pallas kernel (interpret mode), for
    C 8/16/32 and Cout 1 / < C / = C, Y != X."""
    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    x = _masked(rng, (2, 4, 6, X, C))
    w = (0.2 * rng.randn(27, C, cout)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    with _interpret(PC):
        ref = np.asarray(PC.conv3d_3x3x3_folded(
            jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)),
            np.float32)
    got = K_cl.conv3d_3x3x3_folded(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(ref, dtype))


def test_supported_matches_jax():
    from sgnn_tpu.ops.pallas.conv3d_folded import supported

    for C in (1, 2, 4, 8, 12, 16, 24, 32, 64):
        for cout in (1, C - 1, C, C + 1):
            for X in (4, 8, 12, 16, 24, 32, 48):
                for shape in ((1, 4, 6, X, C), (1, 4, 6, X), (4, 6, X, C)):
                    ws = (27, C, cout)
                    assert K_cl.supported(shape, ws) == supported(shape, ws)
        assert K_cl.supported((1, 4, 4, 16, C), (8, C, C)) == supported(
            (1, 4, 4, 16, C), (8, C, C))
    x = torch.zeros(1, 4, 4, 12, 16)
    with pytest.raises(ValueError, match="unsupported"):
        K_cl.conv3d_3x3x3_folded(x, torch.zeros(27, 16, 16))


@pytest.mark.parametrize("cout", [16, 12])
def test_conv3d_folded_grads_match_jax(rng, cout):
    """dx (K8 on the flipped, transposed taps for Cout = C; the plain conv
    otherwise) and dW against jax.vjp of the Pallas kernel's custom VJP,
    f32, 1e-5 of each gradient's scale."""
    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    x = _masked(rng, (1, 4, 6, 8, 16))
    w = (0.2 * rng.randn(27, 16, cout)).astype(np.float32)
    g = rng.randn(1, 4, 6, 8, cout).astype(np.float32)
    with _interpret(PC):
        _, vjp = jax.vjp(PC.conv3d_3x3x3_folded, jnp.asarray(x),
                         jnp.asarray(w))
        jdx, jdw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    K_cl.conv3d_3x3x3_folded(tx, tw).backward(torch.from_numpy(g))
    for got, ref in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(8, 8), (26, 16), (16, 3), (48, 40),
                                      (5, 7)])
def test_conv3d_plain_matches_jax(rng, dtype, cin, cout):
    """K9's plain version against conv3d_3x3x3_pallas (interpret mode), at
    the widths of tests/test_pallas_gather.py:46 and more: Cout < Cin,
    C48 -> 40 (K9's column groups on the card) and an odd Cin below Cout
    (rows of 10 or 20 bytes, staged in words smaller than 16 bytes)."""
    import sgnn_tpu.ops.pallas.conv3d as PK9

    x = rng.randn(1, 4, 8, 16, cin).astype(np.float32)
    w = (0.2 * rng.randn(27, cin, cout)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    with _interpret(PK9):
        ref = np.asarray(PK9.conv3d_3x3x3_pallas(
            jnp.asarray(x).astype(jdt), jnp.asarray(w)), np.float32)
    got = K_cl.conv3d_3x3x3(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(w))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(ref, dtype))


# ----------------------------------------------------- dense-flow ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsampled_conv_and_pool_match_jax(rng, dtype):
    x = _masked(rng, (1, 4, 6, 8, 12))
    w = (0.2 * rng.randn(27, 12, 16)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    np.testing.assert_allclose(
        D.fold_upsample_conv_weights(torch.from_numpy(w)).numpy(),
        np.asarray(JD.fold_upsample_conv_weights(jnp.asarray(w))),
        rtol=0, atol=1e-6)
    ref = np.asarray(JD.upsampled_conv3d(jnp.asarray(x).astype(jdt),
                                         jnp.asarray(w)), np.float32)
    got = D.upsampled_conv3d(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w))
    assert got.shape == (1, 8, 12, 16, 16) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(ref, dtype))
    m = rng.rand(2, 6, 8, 10) < 0.2  # the strided conv's mask pool
    np.testing.assert_array_equal(
        (D.max_pool3d(torch.from_numpy(m).float()) > 0).numpy(),
        np.asarray(JD.max_pool3d(jnp.asarray(m).astype(jnp.int8)) > 0))


# ------------------------------------------------------- whole forward


@pytest.mark.parametrize("dtype,pallas", [("float32", True),
                                          ("bfloat16", True),
                                          ("float32", False)])
def test_genmodel_apply_dense_matches_jax(monkeypatch, dtype, pallas):
    """The eval forward with K8 routed at every eligible conv
    (use_pallas_conv, pallas_min_voxels=0: the JAX side's Pallas kernel in
    interpret mode) and without; the port calls K8's wrapper exactly as
    often as the JAX forward calls its kernel."""
    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    cfg = dict(CFG, compute_dtype=dtype, use_pallas_conv=pallas,
               pallas_min_voxels=0)
    jcfg = JConfig(**cfg)
    params, stats = init_params(SGNNConfig(**cfg), seed=5)
    locs, feats, n = _surface_rows(jcfg.input_dim, jcfg.truncation,
                                   jcfg.input_cap)
    calls = {"jax": 0, "port": 0}
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def counted(*a, **k):
        calls["jax"] += 1
        return orig(*a, **{**k, "interpret": True})
    PC.pl.pallas_call = counted
    try:
        ref = jax.device_get(jax.jit(lambda p, s, st: JDF.genmodel_apply_dense(
            p, s, jcfg, st, num_refine_active=jcfg.num_refine_levels,
            do_surf=True, training=False)[0])(
                params, stats, jmake_sparse(jnp.asarray(locs),
                                            jnp.asarray(feats), n,
                                            jcfg.input_dim, 1)))
    finally:
        PC.pl.pallas_call = orig
    model = GenModelDense(SGNNConfig(**cfg))
    load_jax_params(model, params, stats)
    k8 = K_cl.conv3d_3x3x3_folded

    def counted_k8(*a, **k):
        calls["port"] += 1
        return k8(*a, **k)
    monkeypatch.setattr(K_cl, "conv3d_3x3x3_folded", counted_k8)
    out = model(make_sparse(torch.from_numpy(locs), torch.from_numpy(feats),
                            n, cfg["input_dim"], 1))
    assert calls["port"] == calls["jax"] and (calls["jax"] > 0) == pallas

    if dtype == "bfloat16":
        _compare_bf16(ref, out)
        return
    np.testing.assert_allclose(out.coarse_out.numpy(),
                               np.asarray(ref.coarse_out), rtol=0, atol=1e-4)
    for a, b, ma, mb in zip(ref.refine_outs, out.refine_outs,
                            ref.refine_masks_unfilt, out.refine_masks_unfilt,
                            strict=True):
        ma = np.asarray(ma)
        np.testing.assert_array_equal(mb.numpy(), ma)
        np.testing.assert_allclose(b.numpy()[ma], np.asarray(a)[ma], rtol=0,
                                   atol=2e-3)
    sm = np.asarray(ref.surf_mask)
    assert sm.sum() > 0, "degenerate case: empty surface"
    np.testing.assert_array_equal(out.surf_mask.numpy(), sm)
    np.testing.assert_allclose(out.surf_sdf.numpy()[sm],
                               np.asarray(ref.surf_sdf)[sm], rtol=0,
                               atol=2e-3)


def _compare_bf16(ref, out):
    """bf16: the coarse output and the first refinement level (its mask
    bit-equal, its outputs within 2 bf16 ulps of their scale); after the
    first occupancy gate a one-ulp difference may flip a voxel and
    everything it feeds (ROADMAP, Queue 3), so the finer masks and the
    surface are held to IoU >= 0.95 (the surface's is 0.976 here)."""
    coarse = np.asarray(ref.coarse_out)
    np.testing.assert_allclose(out.coarse_out.numpy(), coarse, rtol=0,
                               atol=_tol(coarse, "bfloat16"))
    ma = np.asarray(ref.refine_masks_unfilt[0])
    np.testing.assert_array_equal(out.refine_masks_unfilt[0].numpy(), ma)
    a = np.asarray(ref.refine_outs[0])[ma]
    np.testing.assert_allclose(out.refine_outs[0].numpy()[ma], a, rtol=0,
                               atol=_tol(a, "bfloat16"))
    for want, got in (*zip(ref.refine_masks_unfilt[1:],
                           out.refine_masks_unfilt[1:]),
                      (ref.surf_mask, out.surf_mask)):
        want, got = np.asarray(want), got.numpy()
        assert want.sum() > 0, "degenerate case: empty mask"
        assert (want & got).sum() / (want | got).sum() >= 0.95
