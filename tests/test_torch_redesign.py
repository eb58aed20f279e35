"""The plain versions of K1, K2, K3, K8, tile_amax, K2q, K3q, K4 and K5
against JAX at the edges of their Hopper designs (K1 runs in output bricks
of 2 x 4 x 32 voxels of the halo'd grid, skipping bricks whose mask is
empty; K2 one thread per coarse voxel; K3 in fine output bricks of 2 x 4 x
32 voxels over the padded fine grid, its halo ring included, reading a
coarse window per group; K8 in persistent blocks over output bricks of the
unpadded channels-last grid, zeros outside the volume; tile_amax reads a
group only where the mask is set and combines rows per TPU tile, whose
windows overlap; K4 a thread per 16-byte output chunk; K5 a thread per run
of 4 x voxels of a dense output row).

The plain versions are what ``chip_smoke.py`` holds the kernels to on the
card, so these cases pin that reference to the JAX package: the same numpy
inputs (from a seed) go through the JAX site of sgnn_tpu/ops/folded.py (or
K8's conv3d_3x3x3_folded), whose Pallas kernel runs in interpret mode, and
through the port's on the CPU. Shapes: Z + 2 and Y + 2 not multiples of
the brick, a real X that is not a multiple of 32 (its x-tail slots zero),
an odd fine X for K2, a fine x tail for K3 (fewer fine x blocks than twice
the coarse ones), X = 128 / C for K8; masks dense, empty and random (K3
also with the fine mask given); inputs without an affine dense (the site
reads neighbours whose mask is 0). Tolerance: atol = rtol = 1e-5 in f32
(the two sum in different orders), bf16 2 bf16 ulps of the output's scale;
masks and zero halo rings bit-equal. tile_amax_plain is held to the JAX
int8 conv body's own per-tile amax (conv3d_folded.py:421), read from its
interpreted Pallas kernel: bit-equal without the affine; with it, to 4 f32
ulps, because XLA:CPU fuses t * a + b into one FMA where the port rounds
twice (tests/test_torch_int8.py). K3q (K3's bricks, one scale per brick
row) and K2q (K2's pass, one scale per coarse voxel) are held to the JAX
int8 sites (quantize=True) where the TPU tiles change inside a brick or
from one coarse row to the next, with the tolerance of
tests/test_torch_int8.py.
"""

import functools

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.ops import folded as JFO
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.ops.kernels import build
from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl
from test_torch_int8 import _aff

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    import jax.experimental.pallas as pl

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    yield orig
    PC.pl.pallas_call = orig


def _mask(rng, dims, cpad, kind):
    m = {"dense": np.ones((1, *dims), bool),
         "empty": np.zeros((1, *dims), bool),
         "random": rng.rand(1, *dims) < 0.3}[kind]
    return m, FO.fold_mask(torch.from_numpy(m), cpad, F32)


def _bf16_tol(want):
    """2 bf16 ulps of the output's scale."""
    return 2 * 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)


def _grid(rng, dims, c, cpad, mask=None):
    d = rng.randn(1, *dims, c).astype(np.float32)
    if mask is not None:
        d = d * mask[..., None]
    return FO.fold(torch.from_numpy(d), cpad)


def _bn(rng, C):
    return ({"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
             "bias": (0.3 * rng.randn(C)).astype(np.float32)},
            {"mean": (0.3 * rng.randn(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)})


def _j(fg):
    return JFO.FGrid(jnp.asarray(fg.data.numpy()), fg.dims, fg.real_c,
                     fg.cpad)


def _assert_grid(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, **TOL)
    for a in (got, want):
        assert not a[:, [0, -1]].any() and not a[:, :, [0, -1]].any()


@pytest.mark.parametrize("cpad,widths,affine,resid,kind", [
    (16, [16, 16, 2, 8], True, True, "random"),
    (16, [16], False, False, "dense"),
    (16, [16, 8], True, True, "empty"),
    (8, [8], False, True, "dense"),
    (8, [1, 8, 4], False, True, "empty"),
])
def test_conv_site_edges(cpad, widths, affine, resid, kind):
    rng = np.random.RandomState(len(widths) * cpad)
    dims = (3, 5, 40)  # halo'd 5 x 7, 40 real x slots
    m, fm = _mask(rng, dims, cpad, kind)
    groups = [_grid(rng, dims, c, cpad, m if affine else None)
              for c in widths]
    cout = cpad
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    res = _grid(rng, dims, cout, cpad) if resid else None
    want = JFO.subm_conv_fused(
        [_j(g) for g in groups], _j(fm), jnp.asarray(w27), cout,
        bn_params=bn[0], bn_stats=bn[1],
        residual=_j(res) if resid else None,
    )
    aff = FO.prep_affines(*bn, widths) if affine else None
    got = FO.subm_conv_fused(groups, fm, FO.prep_conv_weights(
        w27, widths, F32), cout, aff=aff, residual=res)
    _assert_grid(got.data, want.data)
    out = got.data.numpy()
    if kind == "empty":  # every output voxel masked: the residual or zero
        want_res = res.data.numpy() if resid else np.zeros_like(out)
        want_res[:, [0, -1]] = want_res[:, :, [0, -1]] = 0
        np.testing.assert_array_equal(out, want_res)
    assert np.abs(out).max() > 0.1 or (kind == "empty" and not resid)


def _k1_sums(groups, fm, w, cpad, aff, order):
    """K1's f32 sums over the interior [B, Z, Y, Xs, cpad] of a bf16 site
    (conv_site_plain's inputs: the affine, mask and rounding, weights that
    hold bf16 values), in ``order``: "fma", one f32 addition a product in
    (group, tap, channel) order, the FMA body's; "mma", per group, one k16
    step at a time (a tap's 16 channels at cpad 16, two taps' 8 at cpad 8,
    a 28th tap of zero weights), the step's 16 products summed pairwise and
    then added, the tensor cores' implicit GEMM. Products of bf16 values
    are exact in f32, so only the additions round."""
    B, Zp, Yp, xq, _ = fm.data.shape
    Xs = xq * (128 // cpad)
    m = fm.data.view(B, Zp, Yp, Xs, cpad)[..., 0].float()
    acc = torch.zeros(B, Zp - 2, Yp - 2, Xs, cpad)
    for g, grp in enumerate(groups):
        t = grp.data.view(B, Zp, Yp, Xs, cpad).float()
        if aff is not None:
            t = (t * aff[g, 0, :cpad] + aff[g, 1, :cpad]).clamp_min(0.0)
            t = (t * m[..., None]).to(torch.bfloat16).float()
        t = t * (torch.arange(cpad) < grp.real_c)  # dead lanes meet zeros
        t = torch.nn.functional.pad(t, (0, 0, 1, 1))
        # products [taps, B, Z, Y, Xs, ci, co]
        prod = torch.stack([
            t[:, dz:dz + Zp - 2, dy:dy + Yp - 2, dx:dx + Xs, :, None]
            * w[g, (dz * 3 + dy) * 3 + dx, :cpad, :cpad]
            for dz in range(3) for dy in range(3) for dx in range(3)])
        if order == "fma":
            for tap in range(27):
                for ci in range(cpad):
                    acc = acc + prod[tap, ..., ci, :]
            continue
        tpk = 16 // cpad  # taps a k16 step
        steps = torch.cat([prod, torch.zeros_like(prod[:(-27) % tpk])])
        steps = steps.movedim(0, -3).reshape(*acc.shape[:-1], -1, 16, cpad)
        for j in range(steps.shape[-3]):
            s = steps[..., j, :, :]
            while s.shape[-2] > 1:
                s = s[..., 0::2, :] + s[..., 1::2, :]
            acc = acc + s[..., 0, :]
    return acc, m[:, 1:-1, 1:-1, :, None]


@pytest.mark.parametrize("cpad", [8, 16])
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("G", [1, 3])
def test_conv_site_summation_orders(cpad, resid, G):
    """The tolerance a reordered K1 sum needs: the bf16 site summed in the
    FMA body's order and in the tensor cores' (_k1_sums) gives outputs
    that agree within chip_smoke.py's per-call bound (_tol: one inner ulp
    plus two outer half ulps, capped at 2 ulps of the output's plus the
    residual's scale), which the card holds every bf16 K1 call to against
    its plain version; the FMA order is conv_site_plain's site within it.
    Three groups with the affine, one without."""
    from chip_smoke import _tol

    from sgnn_tpu_torch.ops.kernels.conv_site import conv_site_plain

    rng = np.random.RandomState(3 * cpad + 2 * G + resid)
    dims = (6, 8, 40)
    widths = {1: [cpad], 3: [cpad, 1, cpad // 2]}[G]
    affine = G == 3
    m, fm = _mask(rng, dims, cpad, "random")
    bf = torch.bfloat16
    fm = fm.with_data(fm.data.to(bf))
    groups = [_grid(rng, dims, c, cpad, m if affine else None)
              for c in widths]
    groups = [g.with_data(g.data.to(bf)) for g in groups]
    w27 = (0.2 * rng.randn(27, sum(widths), cpad)).astype(np.float32)
    w = FO.prep_conv_weights(w27, widths, bf)
    aff = FO.prep_affines(*_bn(rng, sum(widths)), widths) if affine else None
    res = _grid(rng, dims, cpad, cpad) if resid else None
    r = res.data.to(bf) if resid else None
    B, Zp, Yp, xq, _ = fm.data.shape
    ri = (r.view(B, Zp, Yp, -1, cpad)[:, 1:-1, 1:-1] if resid else None)
    outs, accs = {}, {}
    for order in ("fma", "mma"):
        accs[order], mi = _k1_sums(groups, fm, w, cpad, aff, order)
        o = (accs[order] * mi).to(bf)
        outs[order] = (o.float() + ri.float()).to(bf) if resid else o
    assert not torch.equal(accs["fma"], accs["mma"])  # two orders apart
    plain = conv_site_plain([g.data for g in groups], fm.data, w, widths,
                            cpad, aff=aff, residual=r)
    plain = plain.view(B, Zp, Yp, -1, cpad)[:, 1:-1, 1:-1]
    for got, ref in ((outs["mma"], outs["fma"]), (outs["fma"], plain)):
        d = (got.float() - ref.float()).abs()
        assert (d <= _tol(ref, got, ri)).all()
    assert float(outs["mma"].float().abs().max()) > 0.1


@pytest.mark.parametrize("cpad,cpad_out,affine,kind", [
    (8, 16, False, "random"),   # cross mode: the encoder's level-0 exit
    (8, 16, False, "dense"),
    (16, None, True, "dense"),
    (16, None, False, "empty"),
    (8, None, True, "random"),
])
def test_downconv_edges(cpad, cpad_out, affine, kind):
    rng = np.random.RandomState(cpad + 3 * affine)
    dims = (4, 6, 45)  # an odd fine width
    m, fm = _mask(rng, dims, cpad, kind)
    cin = cpad
    fg = _grid(rng, dims, cin, cpad, m if affine else None)
    w8 = (0.3 * rng.randn(8, cin, cin)).astype(np.float32)
    bn = _bn(rng, cin) if affine else (None, None)
    jout, jm = JFO.downconv_fused(_j(fg), _j(fm), jnp.asarray(w8), cin,
                                  bn_params=bn[0], bn_stats=bn[1],
                                  cpad_out=cpad_out)
    aff = FO.prep_affines(*bn, [cin])[0] if affine else None
    out, mo = FO.downconv_fused(fg, fm, FO.prep_downconv_weights(
        w8, cin, F32), cin, aff=aff, cpad_out=cpad_out)
    _assert_grid(out.data, jout.data)
    np.testing.assert_array_equal(mo.data.numpy(), np.asarray(jm.data))
    assert mo.dims == (2, 3, 22)
    if kind == "empty":
        assert not out.data.numpy().any() and not mo.data.numpy().any()
    else:
        assert np.abs(out.data.numpy()).max() > 0.1


@pytest.mark.parametrize("cpad,widths,affine,given,kind,dtype", [
    (16, [16], True, False, "random", "float32"),
    (16, [16, 5, 8, 2], True, True, "dense", "float32"),
    (8, [5], False, True, "empty", "float32"),
    (8, [8], False, False, "random", "bfloat16"),
])
def test_upconv_edges(monkeypatch, interpret_pallas, cpad, widths, affine,
                      given, kind, dtype):
    """K3's plain version against JAX's upconv_fused: fine dims 4 x 8 x 18
    (Z + 2 = 6 and Y + 2 = 10 rows, no multiple of the brick's 4 rows in
    y), coarse X 9, so the fine grid has fewer x blocks than twice the
    coarse one (a fine x tail: 8 of 16); 1-4 groups with widths below
    cpad, cpad 8 and 16, the fine mask given (training) and expanded from
    the coarse one (serving)."""
    import jax.experimental.pallas.tpu as pltpu

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    # the TPU interpreter: the same results as interpret=True, ~2x faster
    monkeypatch.setattr(PC.pl, "pallas_call", lambda *a, **k: (
        interpret_pallas(*a, **{**k, "interpret": pltpu.InterpretParams()})))
    rng = np.random.RandomState(sum(widths) + 3 * cpad + given)
    cdims = (2, 4, 9)
    fdims = tuple(2 * d for d in cdims)
    m, cfm = _mask(rng, cdims, cpad, kind)
    ffm = _mask(rng, fdims, cpad, kind)[1] if given else None
    groups = [_grid(rng, cdims, c, cpad, m if affine else None)
              for c in widths]
    w27 = (0.2 * rng.randn(27, sum(widths), cpad)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)

    def jgrid(fg):
        return JFO.FGrid(jnp.asarray(fg.data.numpy()).astype(jdt), fg.dims,
                         fg.real_c, fg.cpad)
    want = JFO.upconv_fused([jgrid(g) for g in groups], jgrid(cfm),
                            jgrid(ffm) if given else None,
                            jnp.asarray(w27), cpad, bn_params=bn[0],
                            bn_stats=bn[1])
    aff = FO.prep_affines(*bn, widths) if affine else None

    def tgrid(fg):
        return fg.with_data(fg.data.to(tdt))
    got = FO.upconv_fused([tgrid(g) for g in groups], tgrid(cfm),
                          tgrid(ffm) if given else None,
                          FO.prep_upconv_weights(w27, widths, tdt), cpad,
                          aff=aff)
    xqf = got.data.shape[3]
    assert xqf < 2 * cfm.data.shape[3] and got.dims == want.dims
    out, ref = got.data.float().numpy(), np.asarray(want.data, np.float32)
    assert out.shape == ref.shape
    for a in (out, ref):  # zero halo rings, bit for bit
        assert not a[:, [0, -1]].any() and not a[:, :, [0, -1]].any()
    # masked fine voxels are exactly zero in both
    fm = (ffm.data if given else None)
    if fm is not None:
        off = fm.float().numpy().reshape(*ref.shape[:3], -1, cpad)[..., 0]
        masked = off == 0
        for a in (out, ref):
            assert not a.reshape(*ref.shape[:3], -1, cpad)[masked].any()
    if kind == "empty":
        assert not out.any() and not ref.any()
        return
    assert np.abs(ref).max() > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=_bf16_tol(ref))


@pytest.mark.parametrize("C,cout,dims,corner,dtype", [
    (8, 8, (3, 5, 16), False, "float32"),
    (16, 1, (5, 3, 8), True, "float32"),
    (32, 32, (5, 3, 4), False, "bfloat16"),
])
def test_conv3d_folded_edges(C, cout, dims, corner, dtype):
    """K8's plain version against the JAX conv3d_3x3x3_folded (Pallas in
    interpret mode) at Z, Y in {3, 5} (no multiple of the 2 x 4 brick), X =
    128 / C (the smallest width supported() admits), Cout 1 and C, and a
    single non-zero voxel at the volume's far corner (its brick and every
    other one skip), batch 2."""
    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    rng = np.random.RandomState(C + cout + corner)
    x = rng.randn(2, *dims, C).astype(np.float32)
    if corner:
        keep = np.zeros((2, *dims, 1), np.float32)
        keep[1, -1, -1, -1] = 1.0
    else:
        keep = (rng.rand(2, *dims, 1) < 0.5).astype(np.float32)
    x = x * keep
    w = (0.2 * rng.randn(27, C, cout)).astype(np.float32)
    assert K_cl.supported(x.shape, w.shape)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(PC.conv3d_3x3x3_folded(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)), np.float32)
    got = K_cl.conv3d_3x3x3_folded(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w))
    out = got.float().numpy()
    assert got.dtype == getattr(torch, dtype) and out.shape == ref.shape
    if corner:  # only the corner's 2 x 2 x 2 neighbourhood is reached
        reach = np.zeros(out.shape[:-1], bool)
        reach[1, -2:, -2:, -2:] = True
        assert not out[~reach].any() and not ref[~reach].any()
    assert np.abs(ref).max() > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, **TOL)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=_bf16_tol(ref))


class _AmaxSpy:
    """Stands in for ``jnp`` in the JAX kernels' module: a ``jnp.max``
    without an axis is an int8 body's activation amax (the weight preps
    give one), recorded per grid step (b, iz, iy) and group (the order of
    the calls in the traced body)."""

    def __init__(self, groups):
        self.groups, self.calls, self.seen = groups, 0, {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def max(self, x, axis=None, **kw):
        import jax.experimental.pallas as pl

        m = jnp.max(x, axis=axis, **kw)
        if axis is None:
            g = self.calls % self.groups
            self.calls += 1
            jax.debug.callback(functools.partial(self._record, g),
                               pl.program_id(0), pl.program_id(1),
                               pl.program_id(2), m)
        return m

    def _record(self, g, b, iz, iy, v):
        self.seen[int(b), int(iz), int(iy), g] = np.float32(v)


@pytest.mark.parametrize("cpad,widths,affine,kind", [
    (16, [16], True, "empty"),
    (8, [8, 3], True, "one voxel"),  # a row that four windows hold
    (16, [16], False, "random"),
    (8, [8, 3], False, "random"),
])
def test_tile_amax_plain_matches_jax(monkeypatch, cpad, widths, affine,
                                     kind):
    """tile_amax_plain against the per-tile amax of the JAX int8 conv site
    (K1's windows: tiles of 3 x 3 rows whose halo'd windows overlap by 2
    rows in z and y) on an all-zero mask, a mask with one active voxel in
    the padded row (3, 3) that four windows hold, and random masks, cpad 8
    and 16, with and without the affine (without it every value counts,
    mask or not)."""
    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    rng = np.random.RandomState(cpad + len(widths))
    dims = (9, 9, 16)
    if kind == "one voxel":
        m = np.zeros((1, *dims), bool)
        m[0, 2, 2, 7] = True  # padded (z, y) = (3, 3)
        fm = FO.fold_mask(torch.from_numpy(m), cpad, F32)
    else:
        m, fm = _mask(rng, dims, cpad, kind)
    groups = [_grid(rng, dims, c, cpad) for c in widths]
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    spy = _AmaxSpy(len(widths))
    monkeypatch.setattr(PC, "jnp", spy)
    w27 = (0.2 * rng.randn(27, sum(widths), 8)).astype(np.float32)
    out = JFO.subm_conv_fused([_j(g) for g in groups], _j(fm),
                              jnp.asarray(w27), 8, bn_params=bn[0],
                              bn_stats=bn[1], quantize=True)
    jax.block_until_ready(out.data)
    t = Q.conv_tiles(fm.data, len(widths), False)
    assert (t.tz, t.ty, t.nz, t.ny) == (3, 3, 3, 3)
    want = np.zeros((1, t.nz, t.ny, len(widths)), np.float32)
    assert len(spy.seen) == want.size
    for idx, v in spy.seen.items():
        want[idx] = v
    aff = _aff(bn, widths, cpad) if affine else None
    got = Q.tile_amax_plain([g.data for g in groups], fm.data, aff, cpad,
                            t).numpy()
    if affine:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -21, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    held = (want > 0).any(-1)
    if kind == "empty":
        assert not held.any()
    elif kind == "one voxel":
        wz, wy = np.nonzero(held[0])
        assert sorted(zip(wz, wy)) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    else:
        assert held.all()


def _interpret_tpu(monkeypatch, interpret_pallas):
    """The JAX int8 sites' Pallas kernels in the TPU interpreter
    (pltpu.InterpretParams: the same results as interpret=True, faster)."""
    import jax.experimental.pallas.tpu as pltpu

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    monkeypatch.setattr(PC.pl, "pallas_call", lambda *a, **k: (
        interpret_pallas(*a, **{**k, "interpret": pltpu.InterpretParams()})))


def _straddles(t, Yf):
    """Whether a TPU y-tile boundary falls inside the 4 y rows of a fine
    brick (interior rows 4 ky - 2 .. 4 ky + 1), so that rows of one brick
    take two scales."""
    return any(4 * ky - 2 < k * t.ty <= 4 * ky + 1
               for ky in range(Yf // 4 + 2) for k in range(1, t.ny))


@pytest.mark.parametrize("cpad,widths,affine,given,kind,cdims,tiles", [
    (16, [16], True, False, "random", (1, 5, 9), (2, 2)),
    (16, [16, 5, 8, 2], True, True, "dense", (1, 3, 9), (2, 2)),
    (8, [5], False, True, "empty", (2, 5, 9), (4, 2)),
    (8, [8, 3], False, False, "random", (1, 9, 9), (2, 6)),
])
def test_upconv_q_edges(monkeypatch, interpret_pallas, cpad, widths, affine,
                        given, kind, cdims, tiles):
    """K3q's plain version against JAX's upconv_fused(quantize=True) where
    the Hopper K3q's design has edges: fine TPU tiles of 2 or 6 y rows,
    which straddle its bricks' 4 y rows (a brick's rows take two scales;
    the picker's (tz, ty) asserted); 1-4 groups with widths below cpad,
    cpad 8 and 16, with and without the affine, the fine mask given and
    expanded, random, dense and empty masks; coarse X 9, so the fine grid
    has an x tail (8 of 16 x blocks) whose last real slot is odd. f32;
    tolerance as tests/test_torch_int8.py (one activation step at most,
    1e-5 on >= 99.9% of the values)."""
    from test_torch_int8 import _assert_close, _step

    _interpret_tpu(monkeypatch, interpret_pallas)
    rng = np.random.RandomState(sum(widths) + 5 * cpad + given)
    fdims = tuple(2 * d for d in cdims)
    m, cfm = _mask(rng, cdims, cpad, kind)
    ffm = _mask(rng, fdims, cpad, kind)[1] if given else None
    groups = [_grid(rng, cdims, c, cpad, m if affine else None)
              for c in widths]
    cout = cpad
    w27 = (0.2 * rng.randn(27, sum(widths), cout)).astype(np.float32)
    bn = _bn(rng, sum(widths)) if affine else (None, None)
    want = JFO.upconv_fused([_j(g) for g in groups], _j(cfm),
                            _j(ffm) if given else None, jnp.asarray(w27),
                            cout, bn_params=bn[0], bn_stats=bn[1],
                            quantize=True)
    aff = _aff(bn, widths, cpad) if affine else None
    wq, ws = Q.quantize_upconv_weights(
        FO.prep_upconv_weights(w27, widths, F32))
    got = FO.upconv_fused(groups, cfm, ffm, wq, cout, aff=aff, quantize=True,
                          ws=ws)
    xqf = got.data.shape[3]
    assert xqf < 2 * cfm.data.shape[3] and got.dims == want.dims
    t = Q.upconv_tiles(cfm.data, xqf, len(widths))
    assert (t.tz, t.ty) == tiles
    assert _straddles(t, fdims[1])
    if kind == "empty":
        assert not got.data.any() and not np.asarray(want.data).any()
        return
    s = Q.tile_scales_plain([g.data for g in groups], cfm.data, aff, cpad, t)
    _assert_close(got.data, want.data, _step(s, ws))


@pytest.mark.parametrize("cpad,cpad_out,cin,affine,kind,fdims,tiles", [
    (8, 16, 8, False, "random", (2, 10, 20), (1, 1)),  # cross mode
    (16, None, 12, True, "dense", (2, 6, 20), (1, 3)),
    (8, None, 5, True, "empty", (4, 6, 40), (2, 3)),
])
def test_downconv_q_edges(monkeypatch, interpret_pallas, cpad, cpad_out, cin,
                          affine, kind, fdims, tiles):
    """K2q's plain version against JAX's downconv_fused(quantize=True) where
    the Hopper K2q's design (K2's, one thread per coarse voxel) has edges:
    coarse TPU tiles of one row (coarse Y 5), so the tile changes from one
    coarse row to the next; cross mode (cpad 8 -> 16) and same-cpad modes,
    cin below cpad, with and without the affine, random, dense and empty
    masks. f32; tolerance as tests/test_torch_int8.py; the coarse mask bit
    for bit."""
    from test_torch_int8 import _assert_close, _step

    from sgnn_tpu_torch.ops.kernels import downconv as K_down

    _interpret_tpu(monkeypatch, interpret_pallas)
    rng = np.random.RandomState(cin + cpad + 7)
    m, fm = _mask(rng, fdims, cpad, kind)
    fg = _grid(rng, fdims, cin, cpad, m if affine else None)
    cout = cpad_out or cpad
    w8 = (0.3 * rng.randn(8, cin, cout)).astype(np.float32)
    bn = _bn(rng, cin) if affine else (None, None)
    jout, jm = JFO.downconv_fused(_j(fg), _j(fm), jnp.asarray(w8), cout,
                                  bn_params=bn[0], bn_stats=bn[1],
                                  cpad_out=cpad_out, quantize=True)
    aff = _aff(bn, [cin], cpad)[0] if affine else None
    wq, ws = Q.quantize_downconv_weights(
        FO.prep_downconv_weights(w8, cin, F32))
    xqc = K_down.coarse_xq(fg.data.shape[3], cpad, cout)
    t = Q.downconv_tiles(fg.data, xqc)
    assert (t.tz, t.ty) == tiles
    out, mo = FO.downconv_fused(fg, fm, wq, cout, aff=aff, cpad_out=cpad_out,
                                quantize=True, ws=ws)
    np.testing.assert_array_equal(mo.data.numpy(), np.asarray(jm.data))
    if kind == "empty":
        assert not out.data.any() and not np.asarray(jout.data).any()
        return
    s = Q.tile_scales_plain([fg.data], fm.data,
                            aff[None] if affine else None, cpad, t)
    _assert_close(out.data, jout.data, _step(s, ws))


@pytest.mark.parametrize("mode,cpad,widths,scale,raw,kind,dtype", [
    ("gate", 16, [16], 1, True, "random", "float32"),
    ("gate", 8, [5], 2, False, "random", "float32"),
    ("gate", 16, [8], 2, True, "dense", "float32"),
    ("gate", 8, [8], 1, False, "empty", "float32"),
    ("sum", 8, [1], 1, False, "random", "float32"),
    ("sum", 16, [5, 16, 1, 8], 1, False, "random", "float32"),
    ("sum", 8, [1, 5, 8, 2], 1, False, "dense", "float32"),
    ("sum", 16, [5], 1, False, "random", "bfloat16"),
])
def test_head_edges(monkeypatch, interpret_pallas, mode, cpad, widths,
                    scale, raw, kind, dtype):
    """K4's plain versions against JAX's head sites at the edges of its
    Hopper design (a thread per 16-byte output chunk, warps over the grid's
    rows): head_gate_plain against head_site_fused with and without the raw
    f32 grid, at fm_scale 1 and 2 (the coarse mask expanded in place),
    widths below cpad; head_sum_plain against surf_head_fused over 1 and 4
    groups of widths 1 and 5 < cpad, cpad 8 and 16; fine dims 4 x 6 x 40
    (Y != X, 40 real of 48 or 64 x slots), random, dense and empty masks.
    The raw grid's and the summed grid's halo rings are unspecified:
    interiors only."""
    import jax.experimental.pallas.tpu as pltpu

    import sgnn_tpu.ops.pallas.conv3d_folded as PC
    from sgnn_tpu_torch.ops.kernels import head as K_head

    monkeypatch.setattr(PC.pl, "pallas_call", lambda *a, **k: (
        interpret_pallas(*a, **{**k, "interpret": pltpu.InterpretParams()})))
    rng = np.random.RandomState(sum(widths) + cpad + 2 * scale + raw)
    dims = (4, 6, 40)
    _, fm = _mask(rng, tuple(d // scale for d in dims), cpad, kind)
    groups = [_grid(rng, dims, c, cpad) for c in widths]
    bn = _bn(rng, sum(widths))
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)

    def jgrid(fg):
        return JFO.FGrid(jnp.asarray(fg.data.numpy()).astype(jdt), fg.dims,
                         fg.real_c, fg.cpad)

    def tdata(fg):
        return fg.data.to(tdt)

    def close(got, want, ring=True):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if ring:
            for a in (got, want):
                assert not a[:, [0, -1]].any() and not a[:, :, [0, -1]].any()
        got, want = got[:, 1:-1, 1:-1], want[:, 1:-1, 1:-1]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=_bf16_tol(want))

    if mode == "gate":
        C = widths[0]
        W2 = rng.randn(C, 2).astype(np.float32)
        b2 = (0.2 * rng.randn(2)).astype(np.float32)
        want = JFO.head_site_fused(jgrid(groups[0]), jgrid(fm), *bn,
                                   jnp.asarray(W2), jnp.asarray(b2),
                                   emit_raw=raw, fm_scale=scale)
        got = K_head.head_gate_plain(
            tdata(groups[0]), tdata(fm), FO.prep_head_weights(W2, [C], tdt)[0],
            FO.prep_bias(b2), FO.prep_affines(*bn, [C])[0], cpad,
            mask_scale=scale, emit_raw=raw)
        assert len(got) == (4 if raw else 3) and (want[3] is None) != raw
        close(got[0], want[0].data)
        close(got[1], want[1].data)
        np.testing.assert_array_equal(got[2].float().numpy(),
                                      np.asarray(want[2].data, np.float32))
        if raw:
            assert got[3].dtype == F32
            close(got[3], want[3].data, ring=False)
        kept = int((got[2][..., ::cpad] > 0).sum())
        active = int((fm.data[..., ::cpad] > 0).sum()) * scale ** 3
        assert (0 < kept < active) if kind != "empty" else kept == 0
    else:
        W = rng.randn(sum(widths), 1).astype(np.float32)
        b = (0.2 * rng.randn(1)).astype(np.float32)
        want = JFO.surf_head_fused([jgrid(g) for g in groups], jgrid(fm),
                                   *bn, jnp.asarray(W), jnp.asarray(b))
        got = K_head.head_sum_plain(
            [tdata(g) for g in groups], tdata(fm),
            FO.prep_head_weights(W, widths, tdt), FO.prep_bias(b),
            FO.prep_affines(*bn, widths), widths, cpad)
        assert got.dtype == F32
        close(got, want.data, ring=False)
        assert np.abs(got.numpy()).max() > 0.1


@pytest.mark.parametrize("cpad,scales,widths,dims,kind,dtype", [
    (16, (1,), (16,), (4, 8, 38), "ones", "float32"),
    (8, (1, 2), (8, 5), (4, 8, 38), "random", "float32"),
    (8, (1, 2, 4), (8, 8, 1), (4, 8, 96), "zeros", "float32"),
    (16, (1, 2, 4), (16, 5, 16), (4, 8, 96), "random", "bfloat16"),
])
def test_surf_head_edges(monkeypatch, interpret_pallas, cpad, scales, widths,
                         dims, kind, dtype):
    """K5's plain version against JAX's surf_head_packed at the edges of its
    Hopper design (a thread per run of 4 x voxels of an output row, a float4
    store, each coarse voxel's head value computed once a run): one group
    (scale 1) and two (scales 1 and 2) with X = 38 (X = 2 mod 4: rows of
    the dense output not 16-byte aligned, a partial last run), three groups
    at scales 1, 2 and 4 with Y != X; cpad 8 and 16; batch 2; random,
    all-on and all-off masks; junk (7.0) in every coarse grid's x tail-pad
    blocks, which neither side may read. JAX accepts each of these cases
    (its tile picker falls back to tiles of the largest scale, and its
    expansion only needs ceil(xq / s) <= xq_g). Tolerance: the mask
    bit-equal, the sdf atol = rtol = 1e-5 in both dtypes: both round each
    group's activations to the compute type at the same point and sum exact
    products in f32, in other orders."""
    import jax.experimental.pallas.tpu as pltpu

    import sgnn_tpu.ops.pallas.conv3d_folded as PC
    from sgnn_tpu_torch.ops.kernels import surf_head as K_surf

    monkeypatch.setattr(PC.pl, "pallas_call", lambda *a, **k: (
        interpret_pallas(*a, **{**k, "interpret": pltpu.InterpretParams()})))
    rng = np.random.RandomState(sum(dims) + cpad + len(scales))
    B = 2
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    m = {"random": rng.rand(B, *dims) < 0.3,
         "ones": np.ones((B, *dims), bool),
         "zeros": np.zeros((B, *dims), bool)}[kind]
    fm = FO.fold_mask(torch.from_numpy(m), cpad, tdt)
    groups = []
    for s, c in zip(scales, widths):
        d = rng.randn(B, *(n // s for n in dims), c).astype(np.float32)
        data = FO.fold(torch.from_numpy(d), cpad).data
        live = -(-fm.data.shape[3] // s)  # the x blocks the fine grid covers
        data[:, :, :, live:] = 7.0
        groups.append((FO.FGrid(data.to(tdt), tuple(n // s for n in dims), c,
                                cpad), s))
    assert any(g.data.shape[3] > -(-fm.data.shape[3] // s)
               for g, s in groups) == (len(scales) > 1)
    bn = _bn(rng, sum(widths))
    W = (0.3 * rng.randn(sum(widths), 1)).astype(np.float32)
    b = (0.2 * rng.randn(1)).astype(np.float32)

    def jgrid(fg):
        return JFO.FGrid(jnp.asarray(fg.data.float().numpy()).astype(jdt),
                         fg.dims, fg.real_c, fg.cpad)

    want_sdf, want_mask = JFO.surf_head_packed(
        [(jgrid(g), s) for g, s in groups], jgrid(fm), *bn, jnp.asarray(W),
        jnp.asarray(b))
    sdf = K_surf.surf_head_plain(
        [g.data for g, _ in groups], list(scales), fm.data,
        FO.prep_head_weights(W, list(widths), tdt), FO.prep_bias(b),
        FO.prep_affines(*bn, list(widths)), list(widths), cpad, dims)
    assert sdf.dtype == F32 and sdf.shape == (B, *dims)
    np.testing.assert_array_equal((FO.unfold(fm)[..., 0] > 0.5).numpy(),
                                  np.asarray(want_mask))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(want_sdf), **TOL)
    sdf = sdf.numpy()
    assert (sdf[~m] == b[0]).all()  # a voxel outside the mask holds b
    if kind != "zeros":
        assert np.abs(sdf[m] - b[0]).max() > 0.1


def test_conv_site_entry_point():
    """K1's C entry point ends in (cpad, bf16, stream), and build.SIGNATURES
    declares as many arguments as it takes."""
    src = (build.CSRC / "conv_site.cu").read_text()
    m = re.search(r'extern "C" int sgnn_conv_site\(([^)]*)\)', src)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    assert args[-3:] == ["cpad", "bf16", "stream"]
    assert len(args) == len(build.SIGNATURES["sgnn_conv_site"])
