"""The coordinate-list execution of the port against the JAX package's.

Same inputs, made with numpy from a seed, go through each JAX function
and its counterpart in sgnn_tpu_torch: the coordinate and SparseTensor
primitives (row sets and orders, overflow counts: bit-equal), K10's
plain version against ``gather_gemm_pallas`` in interpret mode and the
XLA ``gather_gemm`` (f32 1e-5 of the output scale; bf16 2 ulps of it),
and the whole ``genmodel_apply`` with both conv backends on a tiny model
(locs row for row, num_valid and overflows equal; coarse 1e-4, levels
and surface 2e-3). The JAX forwards run under jit (eager dispatch of
their hundreds of small ops takes ~30 s).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import sgnn as JM
from sgnn_tpu.ops import conv as JCV
from sgnn_tpu.ops import coords as JC
from sgnn_tpu.ops import sparse as JS
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.sgnn import GenModelSparse
from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops import sparse as S
from sgnn_tpu_torch.ops.kernels import gather_gemm as K_gg
from sgnn_tpu_torch.params import init_params, load_jax_params
from test_torch_model import _surface_rows

CFG = dict(encoder_dim=4, input_dim=(16, 16, 32), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0), execution="sparse")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(rng, dims, n, cap, batch=1, dup=0):
    """``n`` random rows (z, y, x, b) in a capacity of ``cap`` (the rest
    -1), with ``dup`` of them repeated and one out of bounds."""
    Z, Y, X = dims
    flat = rng.choice(batch * Z * Y * X, n - dup, replace=False)
    flat = np.concatenate([flat, flat[:dup]])
    b, rem = flat // (Z * Y * X), flat % (Z * Y * X)
    locs = np.full((cap, 4), -1, np.int32)
    locs[:n] = np.stack([rem // (Y * X), rem // X % Y, rem % X, b], -1)
    locs[n - 1, 0] = Z  # outside the volume: key -1
    return locs


# -------------------------------------------------------- coords / sparse


def test_coords_match_jax(rng):
    dims, cap, n = (6, 8, 10), 300, 240
    locs = _rows(rng, dims, n, cap, batch=2, dup=20)
    jl, tl = jnp.asarray(locs), torch.from_numpy(locs)
    for nv in (n, 100):
        np.testing.assert_array_equal(_np(C.valid_mask(nv, cap)),
                                      _np(JC.valid_mask(nv, cap)))
    np.testing.assert_array_equal(_np(C.flat_key(tl, dims, 2)),
                                  _np(JC.flat_key(jl, dims, 2)))
    nbr = locs[:, None, :] + rng.randint(-1, 2, (cap, 5, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(C.flat_key_nd(torch.from_numpy(nbr), dims, 2)),
        _np(JC.flat_key_nd(jnp.asarray(nbr), dims, 2)))
    # unique rows for the index grid (scatter order of duplicates is
    # unspecified in both)
    ul = _rows(rng, dims, n, cap, batch=2)
    grid_t = C.build_index_grid(torch.from_numpy(ul), 200, dims, 2)
    grid_j = JC.build_index_grid(jnp.asarray(ul), 200, dims, 2)
    np.testing.assert_array_equal(_np(grid_t), _np(grid_j))
    keys = np.concatenate([_np(JC.flat_key(jnp.asarray(nbr.reshape(-1, 4)),
                                           dims, 2)), [-1, 0]])
    np.testing.assert_array_equal(
        _np(C.lookup(torch.from_numpy(keys), grid_t)),
        _np(JC.lookup(jnp.asarray(keys), grid_j)))
    np.testing.assert_array_equal(_np(C.parent_locs(tl)),
                                  _np(JC.parent_locs(jl)))
    feats = rng.randn(cap, 3).astype(np.float32)
    for a, b in zip(C.upsample_locs_x2(tl, torch.from_numpy(feats)),
                    JC.upsample_locs_x2(jl, jnp.asarray(feats))):
        np.testing.assert_array_equal(_np(a), _np(b))
    for f in (2, 3):
        np.testing.assert_array_equal(_np(C.neighbor_offsets(f)),
                                      _np(JC.neighbor_offsets(f)))


@pytest.mark.parametrize("out_cap", [400, 120])
def test_compact_and_unique_match_jax(rng, out_cap):
    """Row order, counts and overflow, with and without a capacity cut;
    unique_locs over rows with duplicates and parents (many repeats)."""
    dims, cap, n = (6, 8, 10), 300, 240
    locs = _rows(rng, dims, n, cap, batch=2, dup=20)
    feats = rng.randn(cap, 3).astype(np.float32)
    keep = rng.rand(cap) < 0.6
    got = C.compact(torch.from_numpy(keep), (torch.from_numpy(locs),
                                             torch.from_numpy(feats)),
                    out_cap, num_valid=n)
    want = JC.compact(jnp.asarray(keep), (jnp.asarray(locs),
                                          jnp.asarray(feats)),
                      out_cap, num_valid=n)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert (got[1], got[2]) == (int(want[1]), int(want[2]))
    par = C.parent_locs(torch.from_numpy(locs))
    half = tuple(d // 2 for d in dims)
    for rows, nv in ((torch.from_numpy(locs), n), (par, n), (par, 150)):
        t = C.unique_locs(rows, nv, half if rows is par else dims, 2,
                          out_cap // 2)
        j = JC.unique_locs(jnp.asarray(_np(rows)), nv,
                           half if rows is par else dims, 2, out_cap // 2)
        np.testing.assert_array_equal(_np(t[0]), _np(j[0]))
        assert (t[1], t[2]) == (int(j[1]), int(j[2]))


def test_sparse_tensor_match_jax(rng):
    dims, cap, n = (6, 8, 10), 300, 240
    locs = _rows(rng, dims, n, cap, batch=2)
    feats = rng.randn(cap, 3).astype(np.float32)
    t = S.make_sparse(torch.from_numpy(locs), torch.from_numpy(feats), 200,
                      dims, 2)
    j = JS.make_sparse(jnp.asarray(locs), jnp.asarray(feats), 200, dims, 2)
    np.testing.assert_array_equal(_np(t.locs), _np(j.locs))
    np.testing.assert_array_equal(_np(t.feats), _np(j.feats))
    dense_t, dense_j = S.sparse_to_dense(t), JS.sparse_to_dense(j)
    np.testing.assert_array_equal(_np(dense_t), _np(dense_j))
    np.testing.assert_array_equal(_np(S.gather_dense(dense_t, t.locs, -2.0)),
                                  _np(JS.gather_dense(dense_j, j.locs, -2.0)))
    keep = rng.rand(2, *dims) < 0.3
    for c in (900, 150):  # the second cut overflows
        a = S.dense_to_sparse(dense_t, torch.from_numpy(keep), c)
        b = JS.dense_to_sparse(dense_j, jnp.asarray(keep), c)
        np.testing.assert_array_equal(_np(a.locs), _np(b.locs))
        np.testing.assert_array_equal(_np(a.feats), _np(b.feats))
        assert a.num_valid == int(b.num_valid)


# ------------------------------------------------------------------ K10


def _tol(ref, dtype):
    scale = float(np.abs(ref).max())
    if dtype == "bfloat16":
        return 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    return 1e-5 * scale + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,cin,cout,cap,band", [
    pytest.param(27, 16, 16, 700, None, id="27-16-16"),
    pytest.param(8, 48, 16, 700, None, id="8-48-16"),
    pytest.param(27, 48, 12, 700, None, id="27-48-12"),
    pytest.param(27, 34, 16, 1000, (200, 400), id="27-34-16-band"),
    pytest.param(8, 8, 8, 1000, (250, 390), id="8-8-8-band"),
])
def test_gather_gemm_plain_matches_jax(rng, monkeypatch, dtype, K, cin,
                                       cout, cap, band):
    """K10's plain version against gather_gemm_pallas in interpret mode
    and the XLA gather_gemm; a capacity that is no multiple of the TPU
    tile (512), some rows with every neighbour missing (output exactly
    0). The Hopper kernel's seams: cin 34 (68-byte bf16 rows) and 8, 1000
    rows (no multiple of its 64- or 128-row tiles), and a band of rows
    with every tap missing that holds a whole 128-row tile."""
    import jax.experimental.pallas as pl

    from sgnn_tpu.ops.pallas import gather_gemm as JPG

    feats = rng.randn(cap, cin).astype(np.float32)
    nbr = rng.randint(0, cap + 1, size=(cap, K)).astype(np.int32)
    nbr[rng.rand(cap, K) < 0.4] = 0
    nbr[:50] = 0
    missing = [slice(0, 50)]
    if band is not None:
        nbr[band[0]:band[1]] = 0
        missing.append(slice(*band))
    w = (0.2 * rng.randn(K, cin, cout)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jf = jnp.asarray(feats).astype(jdt)
    monkeypatch.delenv("SGNN_TPU_PALLAS_GATHER", raising=False)
    xla = np.asarray(JCV.gather_gemm(jf, jnp.asarray(nbr), jnp.asarray(w)),
                     np.float32)
    orig = pl.pallas_call
    JPG.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        pallas = np.asarray(JPG.gather_gemm_pallas(
            jf, jnp.asarray(nbr), jnp.asarray(w)), np.float32)
    finally:
        JPG.pl.pallas_call = orig
    got = K_gg.gather_gemm(torch.from_numpy(feats).to(getattr(torch, dtype)),
                           torch.from_numpy(nbr), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (cap, cout)
    got = got.float().numpy()
    for rows in missing:
        assert not got[rows].any()
    for ref in (xla, pallas):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, dtype))


def test_gather_gemm_checks():
    f = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int32"):
        K_gg.gather_gemm(f, torch.zeros(4, 27, dtype=torch.int64),
                         torch.zeros(27, 3, 2))
    with pytest.raises(ValueError, match="weight"):
        K_gg.gather_gemm(f, torch.zeros(4, 27, dtype=torch.int32),
                         torch.zeros(27, 4, 2))
    with pytest.raises(ValueError, match="impl"):
        K_gg.gather_gemm(f, torch.zeros(4, 27, dtype=torch.int32),
                         torch.zeros(27, 3, 2), impl="kernel")


# ------------------------------------------------------- whole forward


@pytest.fixture(scope="module")
def jax_weights():
    """Seeded weights in the JAX package's tree layout (params.init_params
    draws them as genmodel_init does, with numpy, in a fraction of its
    eager time)."""
    return init_params(SGNNConfig(**CFG), seed=4)


def _compare(ref, out):
    """GenModelOutput of the JAX package vs the port's."""
    np.testing.assert_allclose(out.coarse_out.numpy(),
                               np.asarray(ref.coarse_out), rtol=0, atol=1e-4)
    assert out.overflows == [int(o) for o in ref.overflows]
    for (jl, jo, jn), (tl, to, tn) in zip(ref.refine_outs, out.refine_outs,
                                          strict=True):
        assert tn == int(jn)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(to.numpy()[:tn], np.asarray(jo)[:tn],
                                   rtol=0, atol=2e-3)
    k = out.surf_num_valid
    assert k == int(ref.surf_num_valid) and k > 0
    np.testing.assert_array_equal(out.surf_locs.numpy(),
                                  np.asarray(ref.surf_locs))
    np.testing.assert_allclose(out.surf_sdf.numpy()[:k],
                               np.asarray(ref.surf_sdf)[:k], rtol=0,
                               atol=2e-3)


# capacities: every level's active rows fit (the input's capacity is the
# finest level's), or both refinement levels overflow theirs (234 and
# then 900 active rows with these weights) while the input keeps its rows
FULL = {}
CUT = dict(level_capacity_override=(256, 128, 768), input_capacity=4096)


@pytest.mark.parametrize("backend,pallas,caps", [
    ("gather", False, FULL), ("dense", False, FULL), ("gather", True, FULL),
    ("gather", False, CUT), ("dense", False, CUT)],
    ids=["gather", "dense", "gather-pallas", "gather-cut", "dense-cut"])
def test_genmodel_apply_matches_jax(jax_weights, monkeypatch, backend,
                                    pallas, caps):
    """The eval forward, f32: every level's rows in the JAX order and the
    same overflow counts; ``pallas``: the JAX side's gather_gemm is the
    Pallas kernel in interpret mode (SGNN_TPU_PALLAS_GATHER=1)."""
    import jax.experimental.pallas as pl

    from sgnn_tpu.ops.pallas import gather_gemm as JPG

    cfg = dict(CFG, conv_backend=backend, **caps)
    jcfg = JConfig(**cfg)
    params, stats = jax_weights
    locs, feats, n = _surface_rows(jcfg.input_dim, jcfg.truncation,
                                   jcfg.input_cap)
    if pallas:
        monkeypatch.setenv("SGNN_TPU_PALLAS_GATHER", "1")
    orig = pl.pallas_call
    JPG.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        ref = jax.device_get(jax.jit(lambda p, s, st: JM.genmodel_apply(
            p, s, jcfg, st, num_refine_active=jcfg.num_refine_levels,
            do_surf=True, training=False)[0])(
                params, stats, JS.make_sparse(jnp.asarray(locs),
                                              jnp.asarray(feats), n,
                                              jcfg.input_dim, 1)))
    finally:
        JPG.pl.pallas_call = orig
    model = GenModelSparse(SGNNConfig(**cfg))
    load_jax_params(model, params, stats)
    out = model(S.make_sparse(torch.from_numpy(locs),
                              torch.from_numpy(feats), n, cfg["input_dim"],
                              1))
    if caps:
        assert all(out.overflows), "degenerate case: no overflow"
    _compare(ref, out)
