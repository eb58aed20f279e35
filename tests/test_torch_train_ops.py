"""The training path's kernels and autograd sites against the JAX package.

K7 (``conv_raw``) and K4's raw mode are held, through their plain PyTorch
versions, against the Pallas kernels in interpret mode (f32, atol = rtol =
1e-5: the two sum in different orders); K7 also at the edges of its
Hopper design's output bricks (2 x 4 x 32 voxels): dims off the brick,
x-tail slots, cpad 8 with cin 1 and 5, an all-zero input. Every training site
(``ops/folded.py``'s autograd Functions) is held against its JAX function:
outputs, new running stats and the gradients of one random linear
functional of the outputs, to atol = rtol = 2e-4 (as
tests/test_folded_train.py:233-237); masks bit-equal. Inputs come from
numpy seeds; batch 2, Y != X, masks ~60% dense.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.ops import folded as JFO
from sgnn_tpu.ops.pallas.conv3d_folded import conv_folded_raw
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops import kernels as K
from sgnn_tpu_torch.ops.kernels import conv_raw as K_raw
from sgnn_tpu_torch.ops.kernels import head as K_head

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-4, atol=2e-4)
B = 2
DIMS = (8, 12, 32)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    import jax.experimental.pallas as pl

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    yield
    PC.pl.pallas_call = orig


def _mask_np(rng, dims, p=0.6):
    return rng.rand(B, *dims) < p


def _fgrid(a, dims, c, cpad):
    """numpy [B, Z, Y, X, C] -> (port FGrid, JAX FGrid) of the same bytes."""
    fg = FO.fold(torch.from_numpy(a), cpad)
    return fg, JFO.FGrid(jnp.asarray(fg.data.numpy()), dims, c, cpad)


def _mask(rng, dims, cpad, p=0.6):
    m = _mask_np(rng, dims, p)
    fm = FO.fold_mask(torch.from_numpy(m), cpad, F32)
    return m, fm, JFO.FGrid(jnp.asarray(fm.data.numpy()), dims, cpad, cpad)


def _grid(rng, dims, c, cpad, m=None):
    a = rng.randn(B, *dims, c).astype(np.float32)
    if m is not None:
        a = a * m[..., None]
    return _fgrid(a, dims, c, cpad)


def _bn(rng, c):
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": (0.3 * rng.randn(c)).astype(np.float32)}
    s = {"mean": (0.2 * rng.randn(c)).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return p, s


def _t(tree, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), err_msg=what, **tol)


# ------------------------------------------------------------------ K7


@pytest.mark.parametrize("cpad,cin,cout,dims", [
    (16, 16, 16, (6, 10, 32)),
    (16, 11, 7, (6, 10, 24)),
    (8, 8, 8, (4, 6, 48)),
    (8, 5, 3, (4, 10, 32)),
    # the edges of the Hopper kernel's output bricks (2 x 4 x 32 voxels)
    (16, 16, 16, (5, 7, 40)),   # Z and Y off the brick
    (16, 9, 12, (3, 5, 20)),    # x-tail slots 20..63
    (8, 1, 8, (5, 6, 40)),      # cpad 8, cin 1
    (8, 5, 8, (3, 9, 24)),      # cpad 8, cin 5
])
@pytest.mark.parametrize("flipped", [False, True])
def test_conv_raw(cpad, cin, cout, dims, flipped):
    """K7's plain version against conv_folded_raw (Pallas, interpret), and
    with the flipped, in/out-transposed taps of the input gradient; every
    x-tail slot is computed (a neighbour makes slot X non-zero)."""
    _check_conv_raw(cpad, cin, cout, dims, flipped)


def test_conv_raw_all_zero_input():
    """An all-zero input (each of the Hopper kernel's bricks skipped):
    exact zeros, as conv_folded_raw gives."""
    _check_conv_raw(16, 16, 16, (4, 6, 32), False, zero=True)


def _check_conv_raw(cpad, cin, cout, dims, flipped, zero=False):
    rng = np.random.RandomState(cpad + cin + cout)
    m = np.zeros((B, *dims), bool) if zero else _mask_np(rng, dims)
    fg, jfg = _grid(rng, dims, cin, cpad, m)
    w27 = (0.2 * rng.randn(27, cin, cout)).astype(np.float32)
    if flipped:
        w27 = np.flip(w27.reshape(3, 3, 3, cin, cout), (0, 1, 2)).reshape(
            27, cin, cout).transpose(0, 2, 1).copy()
        cin, cout = cout, cin
        fg, jfg = _grid(rng, dims, cin, cpad, _mask_np(rng, dims))
    jout = conv_folded_raw(jfg.data, jnp.asarray(w27), cpad,
                           (dims[0], dims[1], jfg.data.shape[3] * 128 // cpad))
    w = FO._prep_taps(torch.from_numpy(w27), F32)
    K.reset_launch_counts()
    out = K_raw.conv_raw(fg.data, w, cin, cpad)
    assert K.launch_counts()["conv_raw"] == 0  # CPU: the plain version
    assert out.shape == (B, dims[0], dims[1], fg.data.shape[3], 128)
    _close(out, jout)
    lanes = out.view(*out.shape[:4], 128 // cpad, cpad)
    assert not lanes[..., cout:].any(), "dead lanes must stay zero"
    if zero:
        assert not out.any()
    else:
        assert out.abs().max() > 0.1
        slots = out.view(*out.shape[:3], -1, cpad)
        assert slots[:, :, :, dims[2]].any(), "x-tail slot X is computed"


def test_conv_folded_train_grads():
    """conv_folded_train: forward, dx (ring zero) and dW against
    jax.vjp(ops/folded.conv_folded_train)."""
    rng = np.random.RandomState(3)
    cpad, cin, cout = 16, 12, 9
    fg, jfg = _grid(rng, DIMS, cin, cpad, _mask_np(rng, DIMS))
    w27 = (0.2 * rng.randn(27, cin, cout)).astype(np.float32)
    cot = rng.randn(B, DIMS[0], DIMS[1], fg.data.shape[3], 128).astype(
        np.float32)
    jy, pull = jax.vjp(lambda x, w: JFO.conv_folded_train(x, w, cpad),
                       jfg.data, jnp.asarray(w27))
    jdx, jdw = pull(jnp.asarray(cot))
    x = fg.data.clone().requires_grad_(True)
    w = torch.from_numpy(w27).requires_grad_(True)
    y = FO.conv_folded_train(x, w, cpad)
    y.backward(torch.from_numpy(cot))
    _close(y, jy)
    _close(x.grad, jdx, GTOL, "dx")
    _close(w.grad, jdw, GTOL, "dw")
    assert not x.grad[:, [0, -1]].any() and not x.grad[:, :, [0, -1]].any()


# ------------------------------------------------------------- K4 raw


@pytest.mark.parametrize("cpad", [16, 8])
def test_head_gate_raw(cpad):
    """K4 gate mode with the raw output, mask_scale 1 (the training call):
    the plain version against fused_head_folded(emit_raw=True)."""
    rng = np.random.RandomState(5 + cpad)
    C = min(cpad, 8)
    m, fm, jfm = _mask(rng, DIMS, cpad)
    up, jup = _grid(rng, DIMS, C, cpad)
    p, s = _bn(rng, C)
    W2 = rng.randn(C, 2).astype(np.float32)
    b2 = (0.2 * rng.randn(2)).astype(np.float32)
    jouts = JFO.head_site_fused(jup, jfm, p, s, jnp.asarray(W2),
                                jnp.asarray(b2), dtype=jnp.float32,
                                emit_raw=True, fm_scale=1)
    K.reset_launch_counts()
    outs = K_head.head_gate(
        up.data, fm.data, FO.prep_head_weights(W2, [C], F32)[0],
        FO.prep_bias(b2), FO.prep_affines(p, s, [C])[0], cpad,
        emit_raw=True)
    assert set(K.launch_counts().values()) == {0}
    assert len(outs) == 4 and outs[3].dtype == F32
    for got, want in zip(outs[:2], jouts[:2]):
        _close(got, want.data)
    np.testing.assert_array_equal(outs[2].numpy(), np.asarray(jouts[2].data))
    # the raw grid's ring is unspecified: interiors only
    _close(outs[3][:, 1:-1, 1:-1], np.asarray(jouts[3].data)[:, 1:-1, 1:-1])
    kept = int((outs[2][..., ::cpad] > 0).sum())
    assert 0 < kept < int(m.sum())


# ---------------------------------------------------------- train sites


def test_bn_conv_site():
    """bn_conv_folded_train, two groups (the upconv's n1 shape)."""
    rng = np.random.RandomState(11)
    cpad, widths, cout = 16, [8, 5], 8
    m, fm, jfm = _mask(rng, DIMS, cpad)
    gs = [_grid(rng, DIMS, c, cpad, m) for c in widths]
    p, s = _bn(rng, sum(widths))
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    cot = rng.randn(*gs[0][0].data.shape).astype(np.float32)

    def jf(xs, scale, bias, w):
        groups = [JFO.FGrid(x, DIMS, c, cpad) for x, c in zip(xs, widths)]
        out, ns = JFO.bn_conv_folded_train({"scale": scale, "bias": bias},
                                           _j(s), groups, jfm, w, cout)
        return jnp.sum(out.data * cot), (out.data, ns)

    jargs = ([g[1].data for g in gs], jnp.asarray(p["scale"]),
             jnp.asarray(p["bias"]), jnp.asarray(w27))
    (_, (jout, jns)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)

    xs = [g[0].data.clone().requires_grad_(True) for g in gs]
    pt = _t(p, True)
    w = torch.from_numpy(w27).requires_grad_(True)
    groups = [FO.FGrid(x, DIMS, c, cpad) for x, c in zip(xs, widths)]
    out, ns = FO.bn_conv_folded_train(pt, _t(s), groups, fm, w, cout)
    (out.data * torch.from_numpy(cot)).sum().backward()
    _close(out.data, jout)
    for k in ("mean", "var"):
        _close(ns[k], jns[k], what=k)
    for i, x in enumerate(xs):
        _close(x.grad, jg[0][i], GTOL, f"dx{i}")
    _close(pt["scale"].grad, jg[1], GTOL, "dscale")
    _close(pt["bias"].grad, jg[2], GTOL, "dbias")
    _close(w.grad, jg[3], GTOL, "dw")


@pytest.mark.parametrize("cpad,cpad_out,cin,cout,bn", [
    (16, None, 12, 16, True),   # a U-Net's down site
    (8, 16, 8, 12, False),      # the encoder's level-0 exit (cross mode)
    (16, None, 12, 16, False),  # an encoder's p3
])
def test_downconv_site(cpad, cpad_out, cin, cout, bn):
    rng = np.random.RandomState(cin + cpad + bn)
    m, fm, jfm = _mask(rng, DIMS, cpad)
    fg, jfg = _grid(rng, DIMS, cin, cpad, m)
    w8 = (0.3 * rng.randn(8, cin, cout)).astype(np.float32)
    p, s = _bn(rng, cin)
    co = cpad_out or cpad
    cdims = tuple(d // 2 for d in DIMS)
    xq_c = FO.fold(torch.zeros(1, *cdims, 1), co).data.shape[3]
    cot = rng.randn(B, cdims[0] + 2, cdims[1] + 2, xq_c, 128).astype(
        np.float32)

    def jf(x, scale, bias, w):
        g = JFO.FGrid(x, DIMS, cin, cpad)
        if bn:
            out, om, ns = JFO.bn_downconv_folded_train(
                {"scale": scale, "bias": bias}, _j(s), g, jfm, w, cout,
                cpad_out=cpad_out)
        else:
            out, om = JFO.downconv_folded_train(g, jfm, w, cout,
                                                cpad_out=cpad_out)
            ns = {}
        return jnp.sum(out.data * cot), (out.data, om.data, ns)

    jargs = (jfg.data, jnp.asarray(p["scale"]), jnp.asarray(p["bias"]),
             jnp.asarray(w8))
    (_, (jout, jom, jns)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)

    x = fg.data.clone().requires_grad_(True)
    pt = _t(p, True)
    w = torch.from_numpy(w8).requires_grad_(True)
    g = FO.FGrid(x, DIMS, cin, cpad)
    if bn:
        out, om, ns = FO.bn_downconv_folded_train(pt, _t(s), g, fm, w, cout,
                                                  cpad_out=cpad_out)
    else:
        out, om = FO.downconv_folded_train(g, fm, w, cout, cpad_out=cpad_out)
        ns = {}
    assert out.data.shape == tuple(jout.shape)
    (out.data * torch.from_numpy(cot)).sum().backward()
    _close(out.data, jout)
    np.testing.assert_array_equal(om.data.numpy(), np.asarray(jom))
    for k in ns:
        _close(ns[k], jns[k], what=k)
    _close(x.grad, jg[0], GTOL, "dx")
    _close(w.grad, jg[3], GTOL, "dw")
    if bn:
        _close(pt["scale"].grad, jg[1], GTOL, "dscale")
        _close(pt["bias"].grad, jg[2], GTOL, "dbias")


def test_upconv_site():
    """bn_upconv_folded_train with three groups; its backward runs K7."""
    rng = np.random.RandomState(21)
    cpad, widths, cout = 16, [8, 8, 8], 8
    cdims = tuple(d // 2 for d in DIMS)
    cm, cfm, jcfm = _mask(rng, cdims, cpad)
    ffm_np = np.repeat(np.repeat(np.repeat(cm, 2, 1), 2, 2), 2, 3)
    ffm = FO.fold_mask(torch.from_numpy(ffm_np), cpad, F32)
    jffm = JFO.FGrid(jnp.asarray(ffm.data.numpy()), DIMS, cpad, cpad)
    gs = [_grid(rng, cdims, c, cpad, cm) for c in widths]
    p, s = _bn(rng, sum(widths))
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    cot = rng.randn(*ffm.data.shape).astype(np.float32)

    def jf(xs, scale, bias, w):
        groups = [JFO.FGrid(x, cdims, c, cpad) for x, c in zip(xs, widths)]
        out, ns = JFO.bn_upconv_folded_train(
            {"scale": scale, "bias": bias}, _j(s), groups, jcfm, jffm, w,
            cout)
        return jnp.sum(out.data * cot), (out.data, ns)

    jargs = ([g[1].data for g in gs], jnp.asarray(p["scale"]),
             jnp.asarray(p["bias"]), jnp.asarray(w27))
    (_, (jout, jns)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)

    xs = [g[0].data.clone().requires_grad_(True) for g in gs]
    pt = _t(p, True)
    w = torch.from_numpy(w27).requires_grad_(True)
    groups = [FO.FGrid(x, cdims, c, cpad) for x, c in zip(xs, widths)]
    out, ns = FO.bn_upconv_folded_train(pt, _t(s), groups, cfm, ffm, w, cout)
    (out.data * torch.from_numpy(cot)).sum().backward()
    _close(out.data, jout)
    for k in ("mean", "var"):
        _close(ns[k], jns[k], what=k)
    for i, x in enumerate(xs):
        _close(x.grad, jg[0][i], GTOL, f"dx{i}")
    _close(pt["scale"].grad, jg[1], GTOL, "dscale")
    _close(pt["bias"].grad, jg[2], GTOL, "dbias")
    _close(w.grad, jg[3], GTOL, "dw")


def test_head_site():
    """bn_head_site_folded_train: four outputs (raw on the interior), the
    gate's mask bit-equal, gradients through the composed backward."""
    rng = np.random.RandomState(31)
    cpad, C = 16, 8
    m, fm, jfm = _mask(rng, DIMS, cpad)
    up, jup = _grid(rng, DIMS, C, cpad, m)
    p, s = _bn(rng, C)
    W2 = rng.randn(C, 2).astype(np.float32)
    b2 = (0.2 * rng.randn(2)).astype(np.float32)
    shape = up.data.shape
    cots = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    cots[2][:, [0, -1]] = 0  # the raw grid's ring is unspecified
    cots[2][:, :, [0, -1]] = 0

    def jf(x, scale, bias, W, b):
        upm, o2m, nfm, raw, ns = JFO.bn_head_site_folded_train(
            {"scale": scale, "bias": bias}, _j(s),
            JFO.FGrid(x, DIMS, C, cpad), jfm, W, b)
        loss = sum(jnp.sum(o.data * c)
                   for o, c in zip((upm, o2m, raw), cots))
        return loss, (upm.data, o2m.data, nfm.data, raw.data, ns)

    (_, jouts), jg = jax.value_and_grad(jf, argnums=range(5), has_aux=True)(
        jup.data, jnp.asarray(p["scale"]), jnp.asarray(p["bias"]),
        jnp.asarray(W2), jnp.asarray(b2))

    x = up.data.clone().requires_grad_(True)
    pt = _t(p, True)
    W = torch.from_numpy(W2).requires_grad_(True)
    b = torch.from_numpy(b2).requires_grad_(True)
    K.reset_launch_counts()
    upm, o2m, nfm, raw, ns = FO.bn_head_site_folded_train(
        pt, _t(s), FO.FGrid(x, DIMS, C, cpad), fm, W, b)
    sum((o.data * torch.from_numpy(c)).sum()
        for o, c in zip((upm, o2m, raw), cots)).backward()
    _close(upm.data, jouts[0])
    _close(o2m.data, jouts[1])
    np.testing.assert_array_equal(nfm.data.numpy(), np.asarray(jouts[2]))
    _close(raw.data[:, 1:-1, 1:-1], np.asarray(jouts[3])[:, 1:-1, 1:-1])
    for k in ("mean", "var"):
        _close(ns[k], jouts[4][k], what=k)
    for got, want, name in zip((x.grad, pt["scale"].grad, pt["bias"].grad,
                                W.grad, b.grad), jg,
                               ("dx", "dscale", "dbias", "dW", "db")):
        _close(got, want, GTOL, name)
    assert not nfm.data.requires_grad


def test_surf_head_site():
    rng = np.random.RandomState(41)
    cpad, widths = 16, [8, 8, 8]
    m, fm, jfm = _mask(rng, DIMS, cpad)
    gs = [_grid(rng, DIMS, c, cpad, m) for c in widths]
    p, s = _bn(rng, sum(widths))
    W = rng.randn(sum(widths), 1).astype(np.float32)
    bias = (0.2 * rng.randn(1)).astype(np.float32)
    cot = rng.randn(*fm.data.shape).astype(np.float32)
    cot[:, [0, -1]] = 0
    cot[:, :, [0, -1]] = 0

    def jf(xs, scale, bias_, W_, b_):
        groups = [JFO.FGrid(x, DIMS, c, cpad) for x, c in zip(xs, widths)]
        out, ns = JFO.bn_surf_head_folded_train(
            {"scale": scale, "bias": bias_}, _j(s), groups, jfm, W_, b_)
        return jnp.sum(out.data * cot), (out.data, ns)

    (_, (jout, jns)), jg = jax.value_and_grad(
        jf, argnums=range(5), has_aux=True)(
        [g[1].data for g in gs], jnp.asarray(p["scale"]),
        jnp.asarray(p["bias"]), jnp.asarray(W), jnp.asarray(bias))

    xs = [g[0].data.clone().requires_grad_(True) for g in gs]
    pt = _t(p, True)
    Wt = torch.from_numpy(W).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    groups = [FO.FGrid(x, DIMS, c, cpad) for x, c in zip(xs, widths)]
    out, ns = FO.bn_surf_head_folded_train(pt, _t(s), groups, fm, Wt, bt)
    (out.data * torch.from_numpy(cot)).sum().backward()
    _close(out.data[:, 1:-1, 1:-1], np.asarray(jout)[:, 1:-1, 1:-1])
    for k in ("mean", "var"):
        _close(ns[k], jns[k], what=k)
    for i, x in enumerate(xs):
        _close(x.grad, jg[0][i], GTOL, f"dx{i}")
    for got, want, name in zip((pt["scale"].grad, pt["bias"].grad, Wt.grad,
                                bt.grad), jg[1:],
                               ("dscale", "dbias", "dW", "db")):
        _close(got, want, GTOL, name)


def test_bn_folded_train():
    """The materialized BN pass (the encoder's p2_bn and p3_bn)."""
    rng = np.random.RandomState(51)
    cpad, C = 8, 8
    m, fm, jfm = _mask(rng, DIMS, cpad)
    fg, jfg = _grid(rng, DIMS, C, cpad, m)
    p, s = _bn(rng, C)
    cot = rng.randn(*fg.data.shape).astype(np.float32)

    def jf(x, scale, bias):
        y, ns = JFO.bn_folded({"scale": scale, "bias": bias}, _j(s),
                              JFO.FGrid(x, DIMS, C, cpad), jfm,
                              training=True)
        return jnp.sum(y.data * cot), (y.data, ns)

    (_, (jy, jns)), jg = jax.value_and_grad(jf, argnums=range(3),
                                            has_aux=True)(
        jfg.data, jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))
    x = fg.data.clone().requires_grad_(True)
    pt = _t(p, True)
    y, ns = FO.bn_folded_train(pt, _t(s), FO.FGrid(x, DIMS, C, cpad), fm,
                               training=True)
    (y.data * torch.from_numpy(cot)).sum().backward()
    _close(y.data, jy)
    for k in ("mean", "var"):
        _close(ns[k], jns[k], what=k)
    for got, want, name in zip((x.grad, pt["scale"].grad, pt["bias"].grad),
                               jg, ("dx", "dscale", "dbias")):
        _close(got, want, GTOL, name)


def test_dense_trunk_train():
    """The 1/8-resolution trunk in training mode (dense_trunk:328 with
    batch-moment BN): features, coarse output, new stats, and the
    gradients for the input and every trunk parameter."""
    from sgnn_tpu.config import SGNNConfig as JConfig
    from sgnn_tpu.models.dense_flow import dense_trunk
    from sgnn_tpu.models.sgnn import genmodel_init
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.models.dense_flow import dense_trunk_train
    from sgnn_tpu_torch.params import tree_items

    kw = dict(input_dim=(32, 32, 32), batch_size=B, num_hierarchy_levels=3,
              encoder_dim=4, nf_coarse=8, nf=8, compute_dtype="float32")
    jcfg = JConfig(**kw)
    params, stats = jax.device_get(jax.jit(
        genmodel_init, static_argnums=1)(jax.random.PRNGKey(2), jcfg))
    enc_p = {k: v for k, v in params["encoder"].items()
             if k != "process_sparse"}
    enc_s = {k: v for k, v in stats["encoder"].items()
             if k != "process_sparse"}
    rng = np.random.RandomState(61)
    x = rng.randn(B, 8, 8, 8, jcfg.nf_per_level[-1]).astype(np.float32)
    cy = rng.randn(B, 8, 8, 8, 8).astype(np.float32)
    co = rng.randn(B, 8, 8, 8, 2).astype(np.float32)

    def jf(p, x):
        y, out, s = dense_trunk(p, enc_s, jcfg, x, training=True,
                                axis_name=None)
        return jnp.sum(y * cy) + jnp.sum(out * co), (y, out, s)

    (_, (jy, jout, js)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(enc_p, jnp.asarray(x))

    pt = {k: {kk: ({k3: torch.tensor(v3, requires_grad=True)
                    for k3, v3 in vv.items()} if isinstance(vv, dict)
                   else torch.tensor(vv, requires_grad=True))
              for kk, vv in v.items()} if isinstance(v, dict)
          else torch.tensor(v, requires_grad=True)
          for k, v in enc_p.items()}
    st = {k: {"bn": {kk: torch.tensor(vv) for kk, vv in v["bn"].items()}}
          for k, v in enc_s.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, out, s = dense_trunk_train(pt, st, SGNNConfig(**kw), xt,
                                  training=True)
    ((y * torch.from_numpy(cy)).sum()
     + (out * torch.from_numpy(co)).sum()).backward()
    _close(y, jy)
    _close(out, jout)
    want = dict(tree_items(js))
    for k, v in tree_items(s):
        _close(v, want[k], what=k)
    _close(xt.grad, jgx, GTOL, "dx")
    grads = dict(tree_items(jax.device_get(jgp)))
    for k, t in tree_items(pt):
        _close(t.grad, grads[k], GTOL, k)
