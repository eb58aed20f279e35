"""The plain versions of the port's kernels K1-K4 and K6 against JAX.

Each case feeds the same numpy inputs (made from a seed) to a JAX fused
site of sgnn_tpu/ops/folded.py, whose Pallas kernel runs in interpret
mode, and to the port's site on the CPU, which takes the kernel's plain
PyTorch version. Tolerance: atol = rtol = 1e-5 on values in f32 (the two
sum in different orders); masks and the zero halo rings bit-equal; the
raw f32 surface head's ring is unspecified and excluded. Masks are ~60%
dense so no case is vacuous. The input scatter (K6) is held bit-equal to
``scatter_sparse`` with the Pallas binned scatter forced on.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sgnn_tpu.ops import folded as JFO
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops import kernels as K
from sgnn_tpu_torch.ops.kernels import build

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    import jax.experimental.pallas as pl

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    yield
    PC.pl.pallas_call = orig


def _grid(rng, dims, C, cpad, mask=None):
    d = rng.randn(1, *dims, C).astype(np.float32)
    if mask is not None:
        d = d * mask[..., None]
    return FO.fold(torch.from_numpy(d), cpad)


def _mask(rng, dims, cpad, p=0.6):
    m = rng.rand(1, *dims) < p
    return m, FO.fold_mask(torch.from_numpy(m), cpad, F32)


def _bn(rng, C):
    return ({"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
             "bias": (0.3 * rng.randn(C)).astype(np.float32)},
            {"mean": (0.3 * rng.randn(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)})


def _j(fg):
    return JFO.FGrid(jnp.asarray(fg.data.numpy()), fg.dims, fg.real_c,
                     fg.cpad)


def _assert_grid(got, want, ring_zero=True):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, **TOL)
    if ring_zero:
        for a in (got, want):
            assert not a[:, [0, -1]].any() and not a[:, :, [0, -1]].any()


@pytest.mark.parametrize("cpad,widths,cout,affine,resid", [
    (16, [5], 7, False, False),
    (16, [8, 2, 6], 8, True, True),
    (8, [4], 8, True, False),
    (8, [1], 8, False, False),
])
def test_conv_site(cpad, widths, cout, affine, resid):
    rng = np.random.RandomState(sum(widths) + cpad)
    dims = (8, 16, 32)
    m, fm = _mask(rng, dims, cpad)
    groups = [_grid(rng, dims, c, cpad) for c in widths]
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    # the residual is masked upstream (it is added after the output mask)
    res = _grid(rng, dims, cout, cpad, m) if resid else None
    want = JFO.subm_conv_fused(
        [_j(g) for g in groups], _j(fm), jnp.asarray(w27), cout,
        bn_params=bn[0], bn_stats=bn[1],
        residual=_j(res) if resid else None,
    )
    aff = FO.prep_affines(*bn, widths) if affine else None
    got = FO.subm_conv_fused(groups, fm, FO.prep_conv_weights(
        w27, widths, F32), cout, aff=aff, residual=res)
    _assert_grid(got.data, want.data)
    assert np.abs(got.data.numpy()).max() > 0.1


@pytest.mark.parametrize("cpad,cpad_out,cin,cout,affine", [
    (16, None, 12, 16, True),
    (8, 16, 8, 8, False),   # cross mode: the encoder's level-0 exit
    (8, None, 4, 6, True),
])
def test_downconv(cpad, cpad_out, cin, cout, affine):
    rng = np.random.RandomState(cin + cpad)
    dims = (8, 16, 32)
    _, fm = _mask(rng, dims, cpad)
    fg = _grid(rng, dims, cin, cpad)
    w8 = (0.3 * rng.randn(8, cin, cout)).astype(np.float32)
    bn = _bn(rng, cin) if affine else (None, None)
    jout, jm = JFO.downconv_fused(_j(fg), _j(fm), jnp.asarray(w8), cout,
                                  bn_params=bn[0], bn_stats=bn[1],
                                  cpad_out=cpad_out)
    aff = FO.prep_affines(*bn, [cin])[0] if affine else None
    out, m = FO.downconv_fused(fg, fm, FO.prep_downconv_weights(w8, cin, F32),
                               cout, aff=aff, cpad_out=cpad_out)
    _assert_grid(out.data, jout.data)
    np.testing.assert_array_equal(m.data.numpy(), np.asarray(jm.data))
    assert (out.dims, out.cpad, m.cpad) == (jout.dims, jout.cpad, jm.cpad)
    assert m.data.numpy().any() and not m.data.numpy().all()


@pytest.mark.parametrize("cpad,widths,affine,explicit_fmask", [
    (16, [8, 8, 8], True, False),  # the serving case
    (16, [6], True, True),
    (8, [5, 3], False, True),
])
def test_upconv(cpad, widths, affine, explicit_fmask):
    rng = np.random.RandomState(sum(widths) + cpad)
    cdims = (4, 8, 16)
    fdims = (8, 16, 32)
    cm, cfm = _mask(rng, cdims, cpad)
    groups = [_grid(rng, cdims, c, cpad) for c in widths]
    cout = 8
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    ffm = _mask(rng, fdims, cpad)[1] if explicit_fmask else None
    want = JFO.upconv_fused([_j(g) for g in groups], _j(cfm),
                            _j(ffm) if ffm is not None else None,
                            jnp.asarray(w27), cout, bn_params=bn[0],
                            bn_stats=bn[1])
    aff = FO.prep_affines(*bn, widths) if affine else None
    got = FO.upconv_fused(groups, cfm, ffm,
                          FO.prep_upconv_weights(w27, widths, F32), cout,
                          aff=aff)
    assert got.dims == want.dims
    _assert_grid(got.data, want.data)
    assert np.abs(got.data.numpy()).max() > 0.1


@pytest.mark.parametrize("mask_scale", [1, 2])
def test_head_gate(mask_scale):
    rng = np.random.RandomState(7 + mask_scale)
    dims, cpad, C = (8, 16, 32), 16, 8
    mdims = tuple(d // mask_scale for d in dims)
    _, fm = _mask(rng, mdims, cpad)
    up = _grid(rng, dims, C, cpad)
    bn = _bn(rng, C)
    W2 = rng.randn(C, 2).astype(np.float32)
    b2 = (0.2 * rng.randn(2)).astype(np.float32)
    jupm, jo2m, jfm, raw = JFO.head_site_fused(
        _j(up), _j(fm), bn[0], bn[1], jnp.asarray(W2), jnp.asarray(b2),
        dtype=jnp.float32, emit_raw=False, fm_scale=mask_scale)
    assert raw is None
    upm, o2m, nfm = FO.head_site_fused(
        up, fm, FO.prep_head_weights(W2, [C], F32)[0], FO.prep_bias(b2),
        FO.prep_affines(*bn, [C])[0], 2, fm_scale=mask_scale)
    _assert_grid(upm.data, jupm.data)
    _assert_grid(o2m.data, jo2m.data)
    np.testing.assert_array_equal(nfm.data.numpy(), np.asarray(jfm.data))
    # the gate is non-trivial: it closes some active voxels, keeps others
    kept = int((nfm.data[..., ::cpad] > 0).sum())
    active = int((fm.data[..., ::cpad] > 0).sum()) * mask_scale ** 3
    assert 0 < kept < active


def test_head_sum():
    rng = np.random.RandomState(11)
    dims, cpad, widths = (8, 16, 32), 16, [8, 8, 8]
    _, fm = _mask(rng, dims, cpad)
    groups = [_grid(rng, dims, c, cpad) for c in widths]
    bn = _bn(rng, sum(widths))
    W = rng.randn(sum(widths), 1).astype(np.float32)
    b = (0.2 * rng.randn(1)).astype(np.float32)
    want = JFO.surf_head_fused([_j(g) for g in groups], _j(fm), bn[0],
                               bn[1], jnp.asarray(W), jnp.asarray(b))
    got = FO.surf_head_fused(groups, fm, FO.prep_head_weights(W, widths, F32),
                             FO.prep_bias(b), FO.prep_affines(*bn, widths))
    assert got.data.dtype == torch.float32 and got.real_c == 1
    # the raw f32 head grid's halo ring is unspecified: compare interiors
    _assert_grid(got.data[:, 1:-1, 1:-1], np.asarray(want.data)[:, 1:-1, 1:-1],
                 ring_zero=False)


@pytest.mark.parametrize("cpad,dtype", [(8, F32), (16, F32),
                                        (8, torch.bfloat16)])
def test_scatter(cpad, dtype, monkeypatch):
    """K6 on unsorted rows with padding rows past ``num_valid``, against
    scatter_sparse on the Pallas scatter_slots_folded path (interpret)."""
    rng = np.random.RandomState(cpad)
    B, dims = 2, (4, 6, 32)
    Z, Y, X = dims
    n, cap = 300, 320
    flat = rng.choice(B * Z * Y * X, n, replace=False)
    b, rem = flat // (Z * Y * X), flat % (Z * Y * X)
    locs = np.full((cap, 4), -1, np.int32)
    locs[:n] = np.stack([rem // (Y * X), rem // X % Y, rem % X, b], -1)
    feats = np.zeros((cap, 1), np.float32)
    feats[:n, 0] = rng.uniform(-2.99, 2.99, n)
    monkeypatch.setattr("jax.default_backend", lambda: "tpu")
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    jfg, jfm = JFO.scatter_sparse(jnp.asarray(locs), jnp.asarray(feats),
                                  jnp.int32(n), dims, B, cpad=cpad,
                                  dtype=jdt, feat_bound=3.0)
    fg, fm = FO.scatter_sparse(torch.from_numpy(locs), torch.from_numpy(feats),
                               n, dims, B, cpad=cpad, dtype=dtype,
                               feat_bound=3.0)
    for got, want in ((fg, jfg), (fm, jfm)):
        assert got.data.dtype == dtype
        np.testing.assert_array_equal(got.data.float().numpy(),
                                      np.asarray(want.data, np.float32))
    assert int((fm.data[..., ::cpad] > 0).sum()) == n


def test_dispatch_rule():
    """CPU tensors take the plain version without counting a launch; an
    unknown impl or a device with no route raises."""
    rng = np.random.RandomState(0)
    dims, cpad = (2, 2, 16), 16
    _, fm = _mask(rng, dims, cpad)
    x = _grid(rng, dims, 4, cpad)
    w = FO.prep_conv_weights(np.ones((27, 4, 4), np.float32), [4], F32)
    K.reset_launch_counts()
    FO.subm_conv_fused([x], fm, w, 4)
    FO.subm_conv_fused([x], fm, w, 4, impl="plain")
    assert set(K.launch_counts().values()) == {0}
    assert K.conv_site.mma_launches == 0
    with pytest.raises(ValueError):
        FO.subm_conv_fused([x], fm, w, 4, impl="cuda")
    with pytest.raises(ValueError):
        build.use_kernel(torch.empty(1, device="meta"), None)
    assert not build.use_kernel(fm.data, None)
    assert not build.use_kernel(fm.data, "plain")


def test_kernel_sources():
    """Every kernel has its CUDA source, built only on first use."""
    names = {p.name for p in build.sources()}
    assert {"conv_site.cu", "downconv.cu", "upconv.cu", "head.cu",
            "scatter.cu", "surf_head.cu", "conv_raw.cu", "conv3d_cl.cu",
            "gather_gemm.cu"} <= names
    for p in build.sources():
        assert "Replaces: sgnn_tpu/ops/pallas/" in p.read_text(), p.name
    assert build._lib is None
