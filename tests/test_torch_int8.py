"""The int8 serving mode (``cfg.quantize_int8``) against the JAX package.

The port's copies of the TPU kernels' tile pickers equal JAX's; its int8
weights equal ``prep_*_weights(..., quantize=True)`` bit for bit once
re-expanded to the TPU layouts; the plain versions of the int8 conv (K1),
down (K2) and upsample (K3) sites match JAX's fused sites with
``quantize=True``, their Pallas kernels in interpret mode, at shapes
whose pickers give several tiles (each tile has its own activation
scale), K1 also where tiles of 2 x 3 rows straddle the Hopper kernel's
2 x 4 brick rows, on empty and dense masks. Site tolerance, f32: atol = rtol = 1e-5 on at least 99.9% of the
output values and one activation step (s_tile * ws[co] * 127: one int8
value moved by one) on the rest, because the JAX side runs on XLA:CPU,
which fuses ``t * a + b`` into an FMA and computes ``amax / 127`` as
``amax * (1 / 127)``, while the port rounds each operation as written: a
value on a rounding boundary can quantize one apart. Masks and halo
rings bit-equal. The affines are JAX's own constants on both sides. The whole
int8 model is held against JAX's int8 forward (surface IoU >= 0.99) and
against the port's own exact forward at the JAX package's bounds
(tests/test_folded_model.py::test_folded_int8_close_to_exact), and so is
the int8 forward under SGNN_NO_UPCONV, whose n1 sites run exact.
"""

import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import sgnn_tpu.ops.pallas.conv3d_folded as PC
from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import folded_flow as JFF
from sgnn_tpu.models import sgnn as JM
from sgnn_tpu.ops import folded as JFO
from sgnn_tpu.ops.sparse import make_sparse
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.ops.kernels import conv_site as K_conv
from sgnn_tpu_torch.ops.kernels import downconv as K_down
from sgnn_tpu_torch.ops.kernels import upconv as K_up
from sgnn_tpu_torch.params import init_params, load_jax_params

F32, BF16 = torch.float32, torch.bfloat16
ATOL = RTOL = 1e-5
MIN_CLOSE = 0.999


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    yield orig
    PC.pl.pallas_call = orig


def _grid(rng, dims, C, cpad, mask=None, dtype=F32):
    d = rng.randn(1, *dims, C).astype(np.float32)
    if mask is not None:
        d = d * mask[..., None]
    fg = FO.fold(torch.from_numpy(d), cpad)
    return fg.with_data(fg.data.to(dtype))


def _mask(rng, dims, cpad, p=0.6, dtype=F32):
    m = rng.rand(1, *dims) < p
    return m, FO.fold_mask(torch.from_numpy(m), cpad, dtype)


def _bn(rng, C):
    return ({"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
             "bias": (0.3 * rng.randn(C)).astype(np.float32)},
            {"mean": (0.3 * rng.randn(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)})


def _aff(bn, widths, cpad):
    """The port's [G, 2, 16] affines from JAX's own constants (XLA's rsqrt
    and torch's differ in the last bit for some inputs)."""
    out = torch.zeros(len(widths), 2, 16)
    off = 0
    for g, c in enumerate(widths):
        a, b = JFO._eval_affine(bn[0], bn[1], c, cpad, off)
        out[g, 0, :c] = torch.from_numpy(np.array(a)[:c])
        out[g, 1, :c] = torch.from_numpy(np.array(b)[:c])
        off += c
    return out


def _j(fg):
    return JFO.FGrid(jnp.asarray(fg.data.float().numpy()).astype(
        jnp.bfloat16 if fg.data.dtype == BF16 else jnp.float32),
        fg.dims, fg.real_c, fg.cpad)


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _assert_close(got, want, step):
    """atol = rtol = 1e-5 on >= 99.9% of the values, one activation step
    on the rest; the halo rings zero on both sides."""
    got, want = got.float().numpy(), _np(want)
    for a in (got, want):
        assert not a[:, [0, -1]].any() and not a[:, :, [0, -1]].any()
    d = np.abs(got - want)
    far = d > ATOL + RTOL * np.abs(want)
    print(f"{int(far.sum())} of {d.size} values outside 1e-5; max |diff| "
          f"{d.max():.3e}, one activation step {step:.3e}")
    assert far.mean() <= 1 - MIN_CLOSE
    assert d.max() <= step
    assert np.abs(want).max() > 0.1


def _step(s, ws):
    """The largest one-value move of an int8 product, s_tile ws[co] 127."""
    return float(s.max() * ws.max() * Q.QMAX)


# ------------------------------------------------------------ tile pickers


def test_pick_tiles_conv_equals_jax():
    for Z, Y, xq, G, isz, resid, quant in itertools.product(
            (4, 6, 10, 12, 16, 24, 48, 96), (8, 12, 20, 24, 48, 96, 192),
            (8, 16, 24), (1, 2, 3), (2, 4), (False, True), (False, True)):
        extra = 2 * isz if resid else 0
        assert Q.pick_tiles_conv(Z, Y, xq, G, isz, extra_interior_bytes=extra,
                                 quant=quant) == PC._pick_tiles_budget(
            Z, Y, xq, G, isz, extra_interior_bytes=extra, quant=quant)


def test_pick_tiles_upconv_equals_jax():
    for Zf, Yf, xqf, xqc, G, isz in itertools.product(
            (4, 8, 12, 20, 24, 48, 96), (4, 8, 20, 24, 48, 96, 192),
            (8, 16, 24), (8, 16), (1, 3), (2, 4)):
        assert Q.pick_tiles_upconv(Zf, Yf, xqf, xqc, G, isz) == \
            PC._pick_tiles_upconv(Zf, Yf, xqf, xqc, G, isz)


def test_pick_tiles_downconv_equals_jax_grid(monkeypatch):
    """K2's picker is inline in fused_downconv_folded: read the grid it
    hands to pallas_call (the call itself is replaced by zeros)."""
    grids = []

    def fake_call(kernel, *, grid, out_shape, **kw):
        grids.append(grid)
        return lambda *a: tuple(jnp.zeros(s.shape, s.dtype)
                                for s in out_shape)

    monkeypatch.setattr(PC.pl, "pallas_call", fake_call)
    for Zf, Yf, xqf, cpad, cross, quant in itertools.product(
            (4, 20, 96), (8, 20, 192), (8, 24), (8, 16), (False, True),
            (False, True)):
        if cross and cpad != 8:
            continue
        co = 16 if cross else cpad
        x = jnp.zeros((1, Zf + 2, Yf + 2, xqf, 128), jnp.bfloat16)
        prew = {"W": None, "MD": None, "ws": None}
        PC.fused_downconv_folded(x, x, None, cpad, cpad_out=co,
                                 quantize=quant, prew=prew)
        xqc = K_down.coarse_xq(xqf, cpad, co)
        tzc, tyc = Q.pick_tiles_downconv(Zf // 2, Yf // 2, xqf, xqc, quant)
        assert grids[-1] == (1, Zf // 2 // tzc, Yf // 2 // tyc)


# ---------------------------------------------------------- int8 weights


def _prep_jax(fn, *args):
    return {k: np.asarray(v) for k, v in fn(*args, quantize=True).items()
            if k in ("wm", "wc", "W", "ws")}


@pytest.mark.parametrize("cpad,widths,cout,dtype", [
    (16, [16, 2, 8], 16, F32), (16, [5], 7, BF16), (8, [8], 8, BF16),
    (8, [1], 8, F32)])
def test_quantize_conv_weights(cpad, widths, cout, dtype):
    rng = np.random.RandomState(cpad + cout)
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    wq, ws = Q.quantize_conv_weights(FO.prep_conv_weights(w27, widths, dtype))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    groups, off = [], 0
    for c in widths:
        groups.append(jnp.asarray(w27[:, off:off + c]))
        off += c
    want = _prep_jax(PC.prep_conv_weights, groups, cpad, jdt)
    F = 128 // cpad
    # the column scale of lane x * cpad + co is ws[g, co] for every x
    np.testing.assert_array_equal(
        np.tile(ws[:, :cpad].numpy(), (1, F)), want["ws"])
    for g in range(len(widths)):
        # re-expand: the TPU fold places single taps, so folding the int8
        # values gives the int8 matrices exactly
        w = wq[g].transpose(1, 2)[:, :cpad, :cpad].float().numpy()
        wm, wc = PC._fold_weights(jnp.asarray(w), cpad, jnp.float32)
        np.testing.assert_array_equal(np.asarray(wm), want["wm"][g])
        np.testing.assert_array_equal(np.asarray(wc), want["wc"][g])
    assert np.abs(want["wm"]).max() == 127


@pytest.mark.parametrize("cpad,cpad_out,cin,cout,dtype", [
    (16, None, 16, 16, F32), (8, 16, 8, 8, BF16), (8, None, 4, 6, BF16),
    (16, None, 12, 16, BF16)])
def test_quantize_downconv_weights(cpad, cpad_out, cin, cout, dtype):
    rng = np.random.RandomState(cin + cpad)
    w8 = (0.3 * rng.randn(8, cin, cout)).astype(np.float32)
    wq, ws = Q.quantize_downconv_weights(
        FO.prep_downconv_weights(w8, cin, dtype))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = _prep_jax(PC.prep_downconv_weights, jnp.asarray(w8), cpad,
                     cpad_out, jdt)
    co = cpad_out or cpad
    np.testing.assert_array_equal(
        np.tile(ws[:co].numpy(), 128 // co), want["ws"][0])
    w = jnp.asarray(wq.transpose(1, 2)[:, :cin, :cout].float().numpy())
    if cpad_out:
        W = JFO._strided_w_cross(w, cpad, cpad_out, cin, cout)
    else:
        W = JFO._strided_w(w, cpad, 0, cin, cout)
    np.testing.assert_array_equal(np.asarray(W), want["W"])


def _place_upconv(wq, cpad):
    """The port's int8 [8 parity, 8 tap, co, ci] in the TPU layout
    [2, 2, 2, 2, 128, 256] (main, carry): column o_hi 128 + o_lo cpad + co
    is fine slot o = o_hi F + o_lo of a block pair; coarse slot
    s = (o - 1) // 2 + ex feeds it, from the next block (s = F) or the
    previous one (s = -1) through the carry rows."""
    F = 128 // cpad
    w = wq.transpose(-1, -2).float().numpy()  # [par, tap, ci, co]
    wm = np.zeros((2, 2, 2, 2, 128, 256), np.float32)
    wc = np.zeros_like(wm)
    for pz, py, ez, ey, o, ex in itertools.product(
            range(2), range(2), range(2), range(2), range(2 * F), range(2)):
        blk = w[(pz * 2 + py) * 2 + (o & 1), (ez * 2 + ey) * 2 + ex,
                :cpad, :cpad]
        col = (o // F) * 128 + (o % F) * cpad
        s = (o - 1) // 2 + ex
        if 0 <= s < F:
            wm[pz, py, ez, ey, s * cpad:(s + 1) * cpad, col:col + cpad] = blk
        elif s < 0:
            wc[pz, py, ez, ey, 128 - cpad:, col:col + cpad] = blk
        else:
            wc[pz, py, ez, ey, :cpad, col:col + cpad] = blk
    return wm, wc


@pytest.mark.parametrize("cpad,widths,cout,dtype", [
    (16, [16, 16, 16], 16, BF16), (16, [6], 8, F32), (8, [5, 3], 8, F32)])
def test_quantize_upconv_weights(cpad, widths, cout, dtype):
    rng = np.random.RandomState(sum(widths) + cpad)
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    wq, ws = Q.quantize_upconv_weights(
        FO.prep_upconv_weights(w27, widths, dtype))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    groups, off = [], 0
    for c in widths:
        groups.append(jnp.asarray(w27[:, off:off + c]))
        off += c
    want = _prep_jax(PC.prep_upconv_weights, groups, cpad, jdt)
    F = 128 // cpad
    o = np.arange(2 * F)
    for g in range(len(widths)):
        # column o_hi 128 + o_lo cpad + co: scale ws[g, o % 2, co]
        cols = ws[g, o % 2][:, :cpad].numpy().reshape(2, F * cpad)
        np.testing.assert_array_equal(cols.reshape(-1), want["ws"][g])
        wm, wc = _place_upconv(wq[g], cpad)
        np.testing.assert_array_equal(wm, want["wm"][g])
        np.testing.assert_array_equal(wc, want["wc"][g])


# ------------------------------------------------------------- the sites
#
# Z = 10, Y = 20: K1's picker gives tz = 2, ty = 4 (5 x 5 tiles); K3 at
# Zf = Yf = 20 gives tzf = tyf = 4 (2 for three f32 groups); K2 at
# Zf = Yf = 20 gives tzc = tyc = 2.


@pytest.mark.parametrize("cpad,widths,cout,affine,resid", [
    (16, [16, 2, 8], 16, True, True),
    (16, [5], 7, False, False),
    (8, [8], 8, True, True),
    (8, [1], 8, False, False),
])
def test_conv_site_q(cpad, widths, cout, affine, resid):
    _check_conv_site_q(cpad, widths, cout, affine, resid, (10, 20, 32), 0.6,
                       (2, 4, 5, 5))


@pytest.mark.parametrize("kind,p", [("empty", 0.0), ("dense", 1.0)])
def test_conv_site_q_tiles_straddle_bricks(kind, p):
    """At Z = 10, Y = 9 the picker gives tiles of 2 x 3 rows, whose
    activation scales change inside the Hopper kernel's 2 x 4 brick rows
    (which start at the halo ring, one row off the tiles' origin), on an
    empty and a dense mask; the residual is dense, so a masked voxel's
    output is its copy."""
    _check_conv_site_q(16, [16, 8], 16, True, True, (10, 9, 40), p,
                       (2, 3, 5, 3), dense_resid=True)


def _check_conv_site_q(cpad, widths, cout, affine, resid, dims, p, tiles,
                       dense_resid=False):
    rng = np.random.RandomState(sum(widths) + cpad + 1)
    m, fm = _mask(rng, dims, cpad, p)
    groups = [_grid(rng, dims, c, cpad, m if not affine else None)
              for c in widths]
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    res = _grid(rng, dims, cout, cpad, None if dense_resid else m) \
        if resid else None
    want = JFO.subm_conv_fused(
        [_j(g) for g in groups], _j(fm), jnp.asarray(w27), cout,
        bn_params=bn[0], bn_stats=bn[1],
        residual=_j(res) if resid else None, quantize=True,
    )
    aff = _aff(bn, widths, cpad) if affine else None
    wq, ws = Q.quantize_conv_weights(FO.prep_conv_weights(w27, widths, F32))
    t = Q.conv_tiles(fm.data, len(widths), resid)
    assert (t.tz, t.ty, t.nz, t.ny) == tiles
    got = FO.subm_conv_fused(groups, fm, wq, cout, aff=aff, residual=res,
                             quantize=True, ws=ws)
    s = Q.tile_scales_plain([g.data for g in groups], fm.data, aff, cpad, t)
    _assert_close(got.data, want.data, _step(s, ws))
    if p == 0.0:  # every voxel masked: the residual, or zero
        want_res = res.data if resid else torch.zeros_like(got.data)
        want_res = want_res.clone()
        want_res[:, [0, -1]] = 0
        want_res[:, :, [0, -1]] = 0
        assert torch.equal(got.data, want_res)


@pytest.mark.parametrize("cpad,cpad_out,cin,cout,affine", [
    (16, None, 12, 16, True),
    (8, 16, 8, 8, False),   # cross mode: the encoder's level-0 exit
    (8, None, 4, 6, True),
])
def test_downconv_q(cpad, cpad_out, cin, cout, affine):
    rng = np.random.RandomState(cin + cpad + 1)
    dims = (20, 20, 32)
    _, fm = _mask(rng, dims, cpad)
    fg = _grid(rng, dims, cin, cpad)
    w8 = (0.3 * rng.randn(8, cin, cout)).astype(np.float32)
    bn = _bn(rng, cin) if affine else (None, None)
    jout, jm = JFO.downconv_fused(_j(fg), _j(fm), jnp.asarray(w8), cout,
                                  bn_params=bn[0], bn_stats=bn[1],
                                  cpad_out=cpad_out, quantize=True)
    aff = _aff(bn, [cin], cpad)[0] if affine else None
    wq, ws = Q.quantize_downconv_weights(
        FO.prep_downconv_weights(w8, cin, F32))
    xqc = K_down.coarse_xq(fg.data.shape[3], cpad, cpad_out or cpad)
    t = Q.downconv_tiles(fg.data, xqc)
    assert (t.tz, t.ty, t.nz, t.ny) == (2, 2, 5, 5)
    out, m = FO.downconv_fused(fg, fm, wq, cout, aff=aff, cpad_out=cpad_out,
                               quantize=True, ws=ws)
    s = Q.tile_scales_plain([fg.data], fm.data,
                            aff[None] if affine else None, cpad, t)
    _assert_close(out.data, jout.data, _step(s, ws))
    np.testing.assert_array_equal(m.data.numpy(), _np(jm.data))
    exact = FO.downconv_fused(fg, fm, FO.prep_downconv_weights(w8, cin, F32),
                              cout, aff=aff, cpad_out=cpad_out)[1]
    assert torch.equal(m.data, exact.data)


@pytest.mark.parametrize("cpad,widths,affine,explicit_fmask", [
    (16, [16, 16, 16], True, False),  # the serving case
    (16, [6], True, True),
    (8, [5, 3], False, True),
])
def test_upconv_q(cpad, widths, affine, explicit_fmask):
    rng = np.random.RandomState(sum(widths) + cpad + 1)
    cdims = (10, 10, 16)
    fdims = (20, 20, 32)
    cm, cfm = _mask(rng, cdims, cpad)
    groups = [_grid(rng, cdims, c, cpad, cm if not affine else None)
              for c in widths]
    cout = 8
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    ffm = _mask(rng, fdims, cpad)[1] if explicit_fmask else None
    want = JFO.upconv_fused([_j(g) for g in groups], _j(cfm),
                            _j(ffm) if ffm is not None else None,
                            jnp.asarray(w27), cout, bn_params=bn[0],
                            bn_stats=bn[1], quantize=True)
    aff = _aff(bn, widths, cpad) if affine else None
    wq, ws = Q.quantize_upconv_weights(
        FO.prep_upconv_weights(w27, widths, F32))
    xqf = FO._xq_for(2 * cdims[2], cpad)
    t = Q.upconv_tiles(cfm.data, xqf, len(widths))
    # G = 3 f32 weights leave room for 2 x 2 fine tiles only (10 x 10)
    assert (t.tz, t.ty) == ((2, 2) if len(widths) == 3 else (4, 4))
    got = FO.upconv_fused(groups, cfm, ffm, wq, cout, aff=aff, quantize=True,
                          ws=ws)
    s = Q.tile_scales_plain([g.data for g in groups], cfm.data, aff, cpad, t)
    _assert_close(got.data, want.data, _step(s, ws))


def test_tile_scales_follow_the_tiles():
    """A voxel on a tile boundary row is quantized with each reading
    tile's scale: one large value raises the scales of exactly the tiles
    whose halo'd windows hold its row."""
    rng = np.random.RandomState(3)
    dims = (10, 20, 32)
    m, fm = _mask(rng, dims, 16)
    fg = _grid(rng, dims, 4, 16, m)
    t = Q.conv_tiles(fm.data, 1, False)
    fg.data.view(1, 12, 22, -1, 16)[0, 3, 5, 7, 0] = 1000.0  # padded z 3
    s = Q.tile_scales_plain([fg.data], fm.data, None, 16, t)[0, :, :, 0]
    big = s > 1000.0 / 127 * 0.999
    # z windows [2 iz, 2 iz + 4) hold row 3 for iz = 0, 1; y windows
    # [4 iy, 4 iy + 6) hold row 5 for iy = 0, 1
    want = torch.zeros(5, 5, dtype=torch.bool)
    want[:2, :2] = True
    assert torch.equal(big, want)


# --------------------------------------------------------- the whole model


CFG = dict(encoder_dim=4, input_dim=(16, 16, 16), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0), execution="dense_flow")


def _surface_rows(dims, truncation, cap, seed=0, keep=0.85):
    rng = np.random.RandomState(seed)
    Z, Y, X = dims
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    d = np.sqrt((zz - Z / 2.0) ** 2 + (yy - Y / 2.0) ** 2
                + (xx - X / 2.0) ** 2) - min(Z, Y, X) * 0.35
    z, y, x = np.nonzero(np.abs(d) < truncation)
    keep_m = rng.rand(len(z)) < keep
    z, y, x = z[keep_m], y[keep_m], x[keep_m]
    n = min(len(z), cap)
    locs = np.full((cap, 4), -1, np.int32)
    feats = np.zeros((cap, 1), np.float32)
    locs[:n] = np.stack([z, y, x, np.zeros_like(z)], -1)[:n]
    feats[:n, 0] = d[z, y, x][:n]
    return locs, feats, n


class _Count:
    """Counts the calls of module functions (by name) while active."""

    def __init__(self, mod, names, key=None):
        self.mod, self.names, self.key = mod, names, key
        self.calls = dict.fromkeys(names, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.mod, n) for n in self.names}
        for n in self.names:
            def counted(*a, _n=n, _f=self.saved[n], **k):
                name = self.key(_n, k) if self.key else _n
                self.calls[name] = self.calls.get(name, 0) + 1
                return _f(*a, **k)
            setattr(self.mod, n, counted)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.mod, n, f)


@pytest.fixture(scope="module")
def jax_int8(interpret_pallas):
    """JAX's int8 forward, its per-site quantize=True call counts, the
    params and the input rows. The forward runs under jax.jit with the
    TPU interpreter (pltpu.InterpretParams): it traces the forward's ~60
    Pallas kernels in ~18 s where the generic interpreter takes ~44 s,
    with the same results."""
    import jax.experimental.pallas.tpu as pltpu

    jcfg = JConfig(**CFG, quantize_int8=True)
    # the weights of the JAX package's own int8-vs-exact test
    # (PRNGKey(0)), drawn under jax.jit: ~10 s where eager takes ~21 s
    params, stats = jax.jit(lambda k: JM.genmodel_init(k, jcfg))(
        jax.random.PRNGKey(0))
    locs, feats, n = _surface_rows(jcfg.input_dim, jcfg.truncation,
                                   jcfg.input_cap)
    sites = ("subm_conv_fused", "downconv_fused", "upconv_fused")

    # the site calls are counted as they are traced
    @jax.jit
    def fwd(params, stats, locs, feats):
        return JFF.genmodel_apply_folded(
            params, stats, jcfg,
            make_sparse(locs, feats, n, jcfg.input_dim, 1),
            num_refine_active=jcfg.num_refine_levels, do_surf=True,
            want_level_outputs=False,
        )
    saved = PC.pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: interpret_pallas(
        *a, **{**k, "interpret": pltpu.InterpretParams()})
    try:
        with _Count(JFO, sites,
                    key=lambda n, k: (n, bool(k.get("quantize")))) as cnt:
            ref = fwd(params, stats, jnp.asarray(locs), jnp.asarray(feats))
    finally:
        PC.pl.pallas_call = saved
    return (jax.device_get(ref), {k: v for k, v in cnt.calls.items()
                                  if isinstance(k, tuple)},
            jax.device_get((params, stats)), (locs[:n], feats[:n]))


def _forward(q8, weights, rows, **ablations):
    model = GenModelFolded(SGNNConfig(**CFG, quantize_int8=q8), **ablations)
    load_jax_params(model, *weights)
    locs = torch.zeros(len(rows[0]), 4, dtype=torch.int64)
    locs[:, :3] = torch.from_numpy(rows[0][:, :3].astype(np.int64))
    return model(locs, torch.from_numpy(rows[1]), CFG["input_dim"])


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def test_model_int8_matches_jax(jax_int8):
    ref, _, weights, rows = jax_int8
    got = _forward(True, weights, rows)
    mj, mp = np.asarray(ref.surf_mask), got.surf_mask.numpy()
    assert mj.any() and mp.any()
    iou = _iou(mj, mp)
    both = mj & mp
    err = np.abs(got.surf_sdf.numpy()[both] - np.asarray(ref.surf_sdf)[both])
    scale = np.abs(np.asarray(ref.surf_sdf)[both]).max()
    print(f"int8 port vs JAX: IoU {iou:.5f} over {mj.sum()} / {mp.sum()} "
          f"voxels; mean |sdf diff| / scale {err.mean() / scale:.3e}")
    assert iou >= 0.99
    assert err.mean() <= 1e-3 * scale


def test_model_int8_close_to_exact(jax_int8):
    """The port's int8 forward against its own exact forward, at the JAX
    package's own bounds for the same comparison."""
    _, _, weights, rows = jax_int8
    exact, q = _forward(False, weights, rows), _forward(True, weights, rows)
    me, mq = exact.surf_mask.numpy(), q.surf_mask.numpy()
    assert me.any() and mq.any()
    assert _iou(me, mq) > 0.95
    both = me & mq
    err = np.abs(exact.surf_sdf.numpy()[both] - q.surf_sdf.numpy()[both])
    scale = max(np.abs(exact.surf_sdf.numpy()[both]).max(), 1e-3)
    assert err.mean() / scale < 0.05
    assert np.percentile(err, 95) / scale < 0.15
    assert not torch.equal(exact.surf_sdf, q.surf_sdf)


def test_model_int8_no_upconv(jax_int8):
    """SGNN_NO_UPCONV under int8: each level's n1 site runs exact (one K1
    call over the three upsampled groups; the JAX forward passes it no
    quantize), no upsample site runs, every other site is int8, and the
    surface stays as close to the exact forward as the JAX package holds
    its int8 forward (tests/test_folded_model.py:150-192)."""
    _, jcalls, weights, rows = jax_int8
    exact = _forward(False, weights, rows)
    with _Count(K_conv, ("conv_site", "conv_site_q")) as c1, \
            _Count(K_up, ("upconv", "upconv_q")) as c3:
        q = _forward(True, weights, rows, upconv=False)
    L_ref = CFG["num_hierarchy_levels"] - 1
    assert c1.calls == {"conv_site": L_ref, "conv_site_q": jcalls[
        ("subm_conv_fused", True)]}
    assert c3.calls == {"upconv": 0, "upconv_q": 0}
    me, mq = exact.surf_mask.numpy(), q.surf_mask.numpy()
    assert me.any() and mq.any()
    assert _iou(me, mq) > 0.95
    both = me & mq
    err = np.abs(exact.surf_sdf.numpy()[both] - q.surf_sdf.numpy()[both])
    scale = max(np.abs(exact.surf_sdf.numpy()[both]).max(), 1e-3)
    assert err.mean() / scale < 0.05
    assert np.percentile(err, 95) / scale < 0.15
    assert not torch.equal(exact.surf_sdf, q.surf_sdf)


def test_model_int8_runs_exactly_the_int8_sites(jax_int8):
    """cfg.quantize_int8 is read: the int8 model calls only the int8 site
    wrappers, the exact one only the exact ones, and the int8 calls are
    JAX's quantize=True calls one for one."""
    _, jcalls, weights, rows = jax_int8
    names = ("conv_site", "conv_site_q")
    counts = {}
    for q8 in (False, True):
        with _Count(K_conv, names) as c1, \
                _Count(K_down, ("downconv", "downconv_q")) as c2, \
                _Count(K_up, ("upconv", "upconv_q")) as c3:
            _forward(q8, weights, rows)
        counts[q8] = {**c1.calls, **c2.calls, **c3.calls}
    want = {"conv_site_q": jcalls[("subm_conv_fused", True)],
            "downconv_q": jcalls[("downconv_fused", True)],
            "upconv_q": jcalls[("upconv_fused", True)]}
    assert not any(k[1] is False and v for k, v in jcalls.items())
    assert counts[True] == {"conv_site": 0, "downconv": 0, "upconv": 0,
                            **want}
    assert counts[False] == {"conv_site": want["conv_site_q"],
                             "downconv": want["downconv_q"],
                             "upconv": want["upconv_q"], "conv_site_q": 0,
                             "downconv_q": 0, "upconv_q": 0}
    assert all(want.values())


def test_int8_site_counts_at_serving_depth(monkeypatch):
    """At the served depth (SGNNConfig's L=4, nf 16) the JAX forward makes
    37 / 11 / 3 quantize=True conv / down / upsample site calls (traced by
    jax.eval_shape with its kernels stubbed out: the calls do not depend
    on the values) and the port's int8 model calls its int8 wrappers as
    often: the launch counts chip_smoke.py requires on the card."""
    def fake_call(kernel, **kw):
        out = kw["out_shape"]
        if isinstance(out, (tuple, list)):
            return lambda *a: tuple(jnp.zeros(o.shape, o.dtype) for o in out)
        return lambda *a: jnp.zeros(out.shape, out.dtype)

    monkeypatch.setattr(PC.pl, "pallas_call", fake_call)
    dims = (32, 32, 32)
    kw = dict(input_dim=dims, batch_size=1, compute_dtype="float32",
              occupancy_fractions=(1.0, 0.4, 0.2, 0.1), quantize_int8=True)
    jcfg = JConfig(**kw)
    # the port's numpy initialisation (the JAX trees' layout; the JAX one
    # takes ~30 s eagerly at this width)
    params, stats = init_params(SGNNConfig(**kw), 0)
    locs, feats, n = _surface_rows(dims, jcfg.truncation, jcfg.input_cap)
    sites = ("subm_conv_fused", "downconv_fused", "upconv_fused")
    with _Count(JFO, sites,
                key=lambda n, k: (n, bool(k.get("quantize")))) as cnt:
        jax.eval_shape(lambda p, s, lc, ft: JFF.genmodel_apply_folded(
            p, s, jcfg, make_sparse(lc, ft, n, dims, 1),
            num_refine_active=jcfg.num_refine_levels, do_surf=True,
            want_level_outputs=False), params, stats, jnp.asarray(locs),
            jnp.asarray(feats))
    want = {"conv_site_q": 37, "downconv_q": 11, "upconv_q": 3}
    assert {k: v for k, v in cnt.calls.items() if isinstance(k, tuple)} == {
        ("subm_conv_fused", True): 37, ("downconv_fused", True): 11,
        ("upconv_fused", True): 3}
    model = GenModelFolded(SGNNConfig(**kw))
    load_jax_params(model, params, stats)
    with _Count(K_conv, ("conv_site_q",)) as c1, \
            _Count(K_down, ("downconv_q",)) as c2, \
            _Count(K_up, ("upconv_q",)) as c3:
        model(torch.from_numpy(locs[:n]), torch.from_numpy(feats[:n]), dims)
    assert {**c1.calls, **c2.calls, **c3.calls} == want


def test_int8_sites_follow_the_dtype():
    """The bf16 int8 site quantizes the f32 affine value (not its bf16
    rounding): a bf16 grid gives the same integer sums as its f32 copy."""
    rng = np.random.RandomState(9)
    dims = (10, 20, 32)
    m, fm = _mask(rng, dims, 16)
    g = _grid(rng, dims, 16, 16, dtype=BF16)
    bn = _bn(rng, 16)
    aff = _aff(bn, [16], 16)
    w27 = (0.2 * rng.randn(27, 16, 16)).astype(np.float32)
    wq, ws = Q.quantize_conv_weights(FO.prep_conv_weights(w27, [16], BF16))
    fmb = fm.with_data(fm.data.to(BF16))
    got = FO.subm_conv_fused([g], fmb, wq, 16, aff=aff, quantize=True, ws=ws)
    ref = FO.subm_conv_fused([g.with_data(g.data.float())], fm, wq, 16,
                             aff=aff, quantize=True, ws=ws)
    assert dataclasses.astuple(Q.conv_tiles(fmb.data, 1, False))[:2] == (5, 5)
    np.testing.assert_array_equal(got.data.float().numpy(),
                                  ref.data.to(BF16).float().numpy())


def test_kernel_entry_points_match_their_bindings():
    """Every C entry point that build.py binds is defined in csrc with as
    many parameters as its ctypes signature (nvcc is not here to say so),
    and the int8 kernels' sources are there."""
    import re

    from sgnn_tpu_torch.ops.kernels import build

    src = "".join(p.read_text() for p in build.sources())
    assert {"quant.cu", "conv_site.cu", "downconv.cu", "upconv.cu"} <= {
        p.name for p in build.sources()}
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    for kernel in ("conv_site_q_kernel", "downconv_q_kernel",
                   "upconv_q_kernel", "tile_amax_kernel", "upconv_kernel",
                   "conv3d_brick_kernel", "conv3d_any_brick_kernel"):
        assert f"{kernel}(" in src, kernel


def test_profile_names_are_kernels():
    """chip_smoke.py's profiles and the tools' attribution sum each
    hand-written kernel's device time by its CUDA name
    (ops.kernels.KERNEL_NAMES): every name there is a __global__ kernel of
    csrc, each label names one TPU kernel's port (K8 and K9 apart), and no
    kernel of csrc is left out."""
    import re

    from sgnn_tpu_torch.ops.kernels import KERNEL_NAMES as names
    from sgnn_tpu_torch.ops.kernels import build

    src = "".join(p.read_text() for p in build.sources())
    kernels = set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\(", src))
    assert set(names) == kernels
    assert len(set(names.values())) == len(names)
    assert names["conv3d_brick_kernel"] == "K8"
    assert names["conv3d_any_brick_kernel"] == "K9"
    assert names["upconv_kernel"] == "K3"
