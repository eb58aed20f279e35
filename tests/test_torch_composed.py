"""The folded execution's composed BN -> op forms against the JAX package,
on the CPU.

- The lane-algebra helpers of ``ops/folded.py`` (``strided_conv_folded``,
  ``mask_down_folded``, the stride-2 site and its cross form,
  ``linear_folded``, ``occ_mask_folded``, the composed surface head and
  refinement tail) against the JAX functions at the cases of
  tests/test_folded.py:56-136: whole grids (ring and x tail included),
  masks bit-equal, f32 values within 1e-5, bf16 within 2 ulps of the
  output's scale; the cross site's and the linear's gradients against
  ``jax.vjp`` (1e-5).
- The composed training forward in f32 under ``jax.jit``, at the
  smallest configuration that reaches cpad 8 and the cross down site
  (16^3, L = 2, batch 2): the eval form (``training=False``, which takes
  the composed branch whatever ``fuse_train_bn``) against JAX's
  ``genmodel_apply_folded_train(training=False)``, and the composed
  training form (``fuse_train_bn=False``) against JAX's dense-flow
  training forward, which tests/test_folded_train.py holds JAX's folded
  one to (a second folded compile, ~15 s, would not fit this file's
  time): the coarse output 1e-4, the level heads 1e-3, masks bit-equal,
  the surface 1e-3, the new running stats 1e-4. Its gradients are held to
  the port's fused step's (which tests/test_torch_train_model.py holds to
  JAX's), within 5e-3 of each parameter's largest |g|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import dense_flow as JDF
from sgnn_tpu.models import folded_train as JFT
from sgnn_tpu.ops import folded as JFO
from sgnn_tpu.ops.sparse import make_sparse
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.folded_train import GenModelFoldedTrain
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.params import init_params, load_jax_params, tree_items

F32, BF16 = torch.float32, torch.bfloat16
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread_among_workers():
    """One intra-op thread while several pytest-xdist workers share the
    host's cores (tests/test_torch_folded_levels.py)."""
    n = torch.get_num_threads()
    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fold(x, cpad, dt):
    """(port FGrid, JAX FGrid) of the same dense [B, Z, Y, X, C] array,
    both rounded to ``dt``."""
    fg = FO.fold(torch.from_numpy(x).to(dt), cpad)
    jdt = jnp.float32 if dt == F32 else jnp.bfloat16
    return fg, JFO.FGrid(jnp.asarray(fg.data.float().numpy()).astype(jdt),
                         fg.dims, fg.real_c, cpad)


def _mask(m, cpad, dt):
    fm = FO.fold_mask(torch.from_numpy(m), cpad, dt)
    jdt = jnp.float32 if dt == F32 else jnp.bfloat16
    return fm, JFO.FGrid(jnp.asarray(fm.data.float().numpy()).astype(jdt),
                         fm.dims, cpad, cpad)


def _np(t):
    return (t.detach().float().numpy() if torch.is_tensor(t)
            else np.asarray(t, np.float32))


def _close(got, want, dt, what=""):
    """f32: within 1e-5; bf16: within 2 ulps of the output's scale."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dt == F32:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)
    else:
        ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp,
                                   err_msg=what)


def _same_grid(fg, jfg):
    assert (fg.dims, fg.real_c, fg.cpad) == (tuple(jfg.dims), jfg.real_c,
                                             jfg.cpad)


DTYPES = pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])


# ------------------------------------------------------------- the helpers


@pytest.mark.parametrize("dt,dims,widths,cout", [
    (F32, (4, 6, 20), (5,), 16), (BF16, (4, 6, 20), (5,), 16),
    (F32, (4, 4, 16), (16, 2), 8)],
    ids=["one_group-f32", "one_group-bf16", "two_groups-f32"])
def test_strided_conv_folded(dt, dims, widths, cout):
    rng = np.random.RandomState(len(widths))
    gs = [_fold(rng.randn(1, *dims, c).astype(np.float32), 16, dt)
          for c in widths]
    w8 = (0.3 * rng.randn(8, sum(widths), cout)).astype(np.float32)
    got = FO.strided_conv_folded([g for g, _ in gs], torch.from_numpy(w8),
                                 cout)
    want = JFO.strided_conv_folded([j for _, j in gs], jnp.asarray(w8), cout)
    _same_grid(got, want)
    assert got.data.dtype == dt
    _close(got.data, want.data, dt)


@DTYPES
@pytest.mark.parametrize("cpad", [8, 16])
def test_mask_down_folded(dt, cpad):
    m = np.random.RandomState(cpad).rand(2, 4, 6, 20) > 0.6
    fm, jfm = _mask(m, cpad, dt)
    got, want = FO.mask_down_folded(fm), jax.jit(JFO.mask_down_folded)(jfm)
    _same_grid(got, want)
    np.testing.assert_array_equal(_np(got.data), _np(want.data))
    assert got.data.dtype == dt and 0 < int(got.data.sum())


def _site_case(dt, cpad, cin=5, cout=8, dims=(4, 6, 32)):
    rng = np.random.RandomState(cpad)
    m = rng.rand(2, *dims) > 0.5
    x = rng.randn(2, *dims, cin).astype(np.float32) * m[..., None]
    w8 = (0.3 * rng.randn(8, cin, cout)).astype(np.float32)
    return _fold(x, cpad, dt), _mask(m, cpad, dt), w8


@DTYPES
def test_strided_site_cross(dt):
    """The composed cross site that widens cpad 8 -> 16 across the stride
    (_strided_site_cross_f); the same-cpad site is strided_conv_folded
    times mask_down_folded, held above, and runs in every composed U-Net
    of the forward below."""
    (g, jg), (fm, jfm), w8 = _site_case(dt, 8)
    got, gm = FO.strided_site_folded([g], fm, torch.from_numpy(w8), 8,
                                     cpad_out=16)
    want, wm = jax.jit(lambda g, m, w: JFT._strided_site_cross_f(
        g, m, w, 8, 16))(jg, jfm, jnp.asarray(w8))
    _same_grid(got, want)
    _same_grid(gm, wm)
    np.testing.assert_array_equal(_np(gm.data), _np(wm.data))
    _close(got.data, want.data, dt)


def test_strided_site_cross_gradients():
    """The cross site differentiates as JAX's: the input's and the
    weight's gradients against jax.vjp."""
    (g, jg), (fm, jfm), w8 = _site_case(F32, 8)
    cot = np.random.RandomState(5).randn(2, 4, 5, 8, 128).astype(np.float32)
    x = g.data.clone().requires_grad_(True)
    w = torch.from_numpy(w8).requires_grad_(True)
    out, _ = FO.strided_site_folded([g.with_data(x)], fm, w, 8, cpad_out=16)
    assert out.data.shape == cot.shape
    out.data.backward(torch.from_numpy(cot))

    def f(xd, wd):
        return JFT._strided_site_cross_f(jg.with_data(xd), jfm, wd, 8,
                                         16)[0].data
    dx, dw = jax.jit(lambda x, w, c: jax.vjp(f, x, w)[1](c))(
        jg.data, jnp.asarray(w8), jnp.asarray(cot))
    _close(x.grad, dx, F32, "dx")
    _close(w.grad, dw, F32, "dw")


@DTYPES
def test_linear_folded(dt):
    """f32 out, the bias on every voxel slot (ring and x tail too)."""
    rng = np.random.RandomState(7)
    g, jg = _fold(rng.randn(1, 2, 3, 20, 16).astype(np.float32), 16, dt)
    W = (0.3 * rng.randn(16, 2)).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    got = FO.linear_folded(g, torch.from_numpy(W), torch.from_numpy(b))
    want = jax.jit(JFO.linear_folded)(jg, jnp.asarray(W), jnp.asarray(b))
    _same_grid(got, want)
    assert got.data.dtype == F32
    _close(got.data, want.data, dt)


def test_linear_folded_gradients():
    rng = np.random.RandomState(8)
    g, jg = _fold(rng.randn(1, 2, 3, 20, 16).astype(np.float32), 16, F32)
    W = (0.3 * rng.randn(16, 2)).astype(np.float32)
    b = rng.randn(2).astype(np.float32)
    cot = rng.randn(*g.data.shape).astype(np.float32)
    x = g.data.clone().requires_grad_(True)
    Wt = torch.from_numpy(W).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    FO.linear_folded(g.with_data(x), Wt, bt).data.backward(
        torch.from_numpy(cot))
    def f(xd, w, bb):
        return JFO.linear_folded(jg.with_data(xd), w, bb).data
    want = jax.jit(lambda x, w, bb, c: jax.vjp(f, x, w, bb)[1](c))(
        jg.data, jnp.asarray(W), jnp.asarray(b), jnp.asarray(cot))
    for got, want, what in zip((x.grad, Wt.grad, bt.grad), want,
                               ("dx", "dW", "db")):
        _close(got, want, F32, what)


@DTYPES
def test_occ_mask_folded(dt):
    """Strictly positive logits on channel 0; a zero logit stays off."""
    out = np.random.RandomState(9).randn(1, 2, 3, 20, 2).astype(np.float32)
    out[0, 0, 0, :5, 0] = 0.0
    g, jg = _fold(out, 16, F32)
    got = FO.occ_mask_folded(g, dt)
    want = jax.jit(lambda g: JFO.occ_mask_folded(
        g, jnp.float32 if dt == F32 else jnp.bfloat16))(jg)
    _same_grid(got, want)
    assert got.data.dtype == dt
    np.testing.assert_array_equal(_np(got.data), _np(want.data))


def _groups(rng, dims, widths, dt, m):
    return [_fold((rng.randn(1, *dims, c) * m[..., None]).astype(np.float32),
                  16, dt) for c in widths]


@DTYPES
def test_linear_sum_folded(dt):
    """The composed surface head's per-group linears summed in group order
    plus the bias tile (folded_train.py:376-391)."""
    rng = np.random.RandomState(10)
    dims, widths = (2, 3, 20), (8, 8, 2)
    m = rng.rand(1, *dims) > 0.4
    gs = _groups(rng, dims, widths, dt, m)
    W = (0.3 * rng.randn(sum(widths), 1)).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    got = FO.linear_sum_folded([g for g, _ in gs], torch.from_numpy(W),
                               torch.from_numpy(b))
    @jax.jit
    def ref(gs, W, b):
        acc, off = None, 0
        for jg in gs:
            o = JFO.linear_folded(jg, W[off:off + jg.real_c], None)
            acc = o.data if acc is None else acc + o.data
            off += jg.real_c
        return acc + jnp.tile(jnp.zeros(16).at[:1].set(b[0]), 8)
    want = ref([j for _, j in gs], jnp.asarray(W), jnp.asarray(b))
    _close(got.data, want, dt)
    assert got.real_c == 1


@DTYPES
def test_head_gate_composed(dt):
    """The composed refinement tail (folded_train.py:320-327): masked
    feats, masked heads in the grid's type, the gated mask bit-equal, the
    raw f32 heads."""
    rng = np.random.RandomState(11)
    dims = (4, 6, 20)
    m = rng.rand(1, *dims) > 0.3
    ((up, jup),) = _groups(rng, dims, (8,), dt, m)
    fm, jfm = _mask(m, 16, dt)
    W2 = (0.5 * rng.randn(8, 2)).astype(np.float32)
    b2 = rng.randn(2).astype(np.float32)
    got = FO.head_gate_composed(up, fm, torch.from_numpy(W2),
                                torch.from_numpy(b2))
    @jax.jit
    def ref(jup, jfm, W2, b2):
        out2 = JFO.linear_folded(jup, W2, b2)
        new_fm = JFO.mask_and(JFO.occ_mask_folded(out2, jup.data.dtype), jfm)
        return (jup.data * new_fm.data, out2.data.astype(jup.data.dtype)
                * new_fm.data, new_fm.data, out2.data)
    want = ref(jup, jfm, jnp.asarray(W2), jnp.asarray(b2))
    np.testing.assert_array_equal(_np(got[2].data), _np(want[2]))
    assert 0 < int(got[2].data.sum()) < int(fm.data.sum())
    for a, b, what in zip(got, want, ("feats", "heads", "mask", "raw")):
        _close(a.data, b, dt, what)
    assert got[1].data.dtype == dt and got[3].data.dtype == F32


# ------------------------------------------- the composed training forward


CFG = dict(input_dim=(16, 16, 16), batch_size=2, num_hierarchy_levels=2,
           encoder_dim=4, nf_coarse=8, nf=8, compute_dtype="float32")
SEED = 6  # weights whose gates leave every level and a surface in both forms
FORMS = {"train": True, "eval": False}


def _rows(n=300, seed=0):
    rng = np.random.RandomState(seed)
    D = CFG["input_dim"][0]
    locs = np.stack([rng.randint(0, D, n), rng.randint(0, D, n),
                     rng.randint(0, D, n), rng.randint(0, 2, n)], -1)
    _, first = np.unique(locs, axis=0, return_index=True)
    locs = locs[np.sort(first)].astype(np.int32)  # input voxels are unique
    return locs, rng.rand(len(locs), 1).astype(np.float32) * 4 - 2


def _loss(out):
    t = sum((o * o).sum() for o in out.refine_outs)
    return ((out.coarse_out ** 2).sum() + t
            + torch.where(out.surf_mask, out.surf_sdf, 0.0).pow(2).sum())


def _model(weights, fuse):
    model = GenModelFoldedTrain(SGNNConfig(**CFG, fuse_train_bn=fuse))
    load_jax_params(model, *weights)
    return model


@pytest.fixture(scope="module")
def composed():
    """The JAX references of both forms (each under jax.jit), the port's
    composed forward in both (the training one with its gradients) and the
    port's fused training step's gradients."""
    weights = init_params(SGNNConfig(**CFG), SEED)
    locs, feats = _rows()
    n = len(locs)
    # JAX's composed training form is the dense flow's training forward
    # (tests/test_folded_train.py holds them together): ~4 s of compile
    # where JAX's folded one takes ~15 s
    execs = {"train": ("dense_flow", JDF.genmodel_apply_dense),
             "eval": ("folded", JFT.genmodel_apply_folded_train)}
    ref = {}
    for form, (ex, fwd) in execs.items():
        cfg = JConfig(execution=ex, fuse_train_bn=False, **CFG)

        @jax.jit
        def run(params, stats, lo, fe):
            return fwd(params, stats, cfg,
                       make_sparse(lo, fe, n, cfg.input_dim, cfg.batch_size),
                       num_refine_active=1, do_surf=True,
                       training=FORMS[form])
        ref[form] = jax.device_get(run(*weights, jnp.asarray(locs),
                                       jnp.asarray(feats)))
    lt, ft = torch.from_numpy(locs), torch.from_numpy(feats)
    port, grads = {}, {}
    for fuse in (False, True):
        model = _model(weights, fuse)
        out, s = model(lt, ft, n, num_refine_active=1, do_surf=True)
        _loss(out).backward()
        grads[fuse] = [p.grad for p in model.weights]
        if not fuse:
            port["train"] = (out, s)
    with torch.no_grad():
        port["eval"] = _model(weights, False)(
            lt, ft, n, num_refine_active=1, do_surf=True, training=False)
    return dict(ref=ref, port=port, grads=grads, weights=weights,
                rows=(lt, ft), keys=_model(weights, True).param_keys)


@pytest.mark.parametrize("form", FORMS)
def test_composed_forward_matches_jax(composed, form):
    out, _ = composed["port"][form]
    ref, _ = composed["ref"][form]
    np.testing.assert_allclose(_np(out.coarse_out), ref.coarse_out,
                               rtol=1e-4, atol=1e-4)
    assert len(out.refine_outs) == len(ref.refine_outs) == 1
    for a, b in zip(out.refine_outs, ref.refine_outs):
        np.testing.assert_allclose(_np(a), b, rtol=1e-3, atol=1e-3)
    for a, b in zip(out.refine_masks_unfilt, ref.refine_masks_unfilt):
        np.testing.assert_array_equal(a.numpy(), b)
        assert 0 < int(a.sum()) < a.numel()
    np.testing.assert_array_equal(out.surf_mask.numpy(), ref.surf_mask)
    assert int(out.surf_mask.sum()) > 0
    np.testing.assert_allclose(_np(out.surf_sdf), ref.surf_sdf, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("form", FORMS)
def test_composed_new_stats(composed, form):
    """Training: the new running stats within 1e-4 of JAX's; eval: the
    running stats unchanged."""
    _, s = composed["port"][form]
    _, js = composed["ref"][form]
    want = dict(tree_items(js))
    got = list(tree_items(s))
    assert [k for k, _ in got] == list(want)
    for k, v in got:
        np.testing.assert_allclose(_np(v), want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    if form == "eval":
        for (_, v), (_, w) in zip(got, tree_items(composed["weights"][1])):
            np.testing.assert_array_equal(_np(v), w)


def test_composed_gradients_match_fused(composed):
    """The composed step's gradients are the fused step's, within 5e-3 of
    each parameter's largest |g|."""
    for k, a, b in zip(composed["keys"], composed["grads"][False],
                       composed["grads"][True]):
        assert a is not None and b is not None, k
        denom = max(float(b.abs().max()), 1e-3)
        np.testing.assert_allclose(_np(a) / denom, _np(b) / denom,
                                   atol=5e-3, err_msg=k)


def test_eval_takes_the_composed_branch(composed, monkeypatch):
    """training=False with fuse_train_bn on runs no fused training site
    and gives the composed eval form's bits (the JAX guard, training and
    fuse_bn)."""
    def refused(*a, **k):
        raise AssertionError("a fused training site ran in the eval form")
    for name in ("bn_conv_folded_train", "bn_downconv_folded_train",
                 "downconv_folded_train", "bn_upconv_folded_train",
                 "bn_head_site_folded_train", "bn_surf_head_folded_train"):
        monkeypatch.setattr(FO, name, refused)
    lt, ft = composed["rows"]
    with torch.no_grad():
        out, _ = _model(composed["weights"], True)(
            lt, ft, len(lt), num_refine_active=1, do_surf=True,
            training=False)
    want, _ = composed["port"]["eval"]
    assert torch.equal(out.surf_sdf, want.surf_sdf)
    assert torch.equal(out.surf_mask, want.surf_mask)
    for a, b in zip(out.refine_outs, want.refine_outs):
        assert torch.equal(a, b)
