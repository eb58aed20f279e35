"""Training through the two secondary executions, the coordinate lists
(``sparse``) and the dense flow, held against the JAX package on the CPU.

- The masked training BN against ``sgnn_tpu.ops.bn.batch_norm(training=
  True)``: the output, the new running stats and the input gradient.
- K10's inverse neighbour list against a numpy transpose of the list, bit
  for bit, and the autograd Function's input gradient (its plain version,
  and K10's sum over the inverse list, run by K10's plain version) and
  weight gradient against ``jax.vjp`` of ``sgnn_tpu.ops.conv.gather_gemm``
  at 27 and 8 taps, with padding output rows.
- Each execution's training forward and loss (``train/step._forward_loss``
  against the JAX step's ``_forward_loss``, f32, 32^3, batch 2, L = 3,
  encoder_dim 4, nf 8, the same weights and chunks): the loss and every
  level's loss to 1e-4 relative, the level and surface masks (or rows)
  bit-equal, the outputs and the new running stats to 1e-4, every
  parameter's gradient to 5e-3 of its largest |g| (the coordinate lists to
  1e-2: see test_gradients_match_jax). The input gradients of the
  coordinate lists' convs have shapes K10 takes.
- The training CLI with ``--cpu`` for 2 steps of each execution, its
  ``.ckpt`` read by the JAX loader and served by the execution's eval
  forward; the trainer's prediction dump writes its meshes and point
  clouds, and ``utils/vis.py`` writes its point clouds.

The JAX side is computed once per module (``jax.jit``: eager JAX takes
several times longer).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu import losses as JL
from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.ops import bn as JBN
from sgnn_tpu.ops import conv as JCV
from sgnn_tpu.parallel import mesh as PM
from sgnn_tpu.train import checkpoint as JC
from sgnn_tpu.train import state as JS
from sgnn_tpu.train import step as JTS
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.data.capacity import estimate_row_capacities
from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import coords as C
from sgnn_tpu_torch.ops import conv as CV
from sgnn_tpu_torch.ops.kernels import gather_gemm as K_gg
from sgnn_tpu_torch.ops.sparse import make_sparse
from sgnn_tpu_torch.params import init_params, load_jax_params, tree_items
from sgnn_tpu_torch.tools import train as train_cli
from sgnn_tpu_torch.train import step as TS
from sgnn_tpu_torch.utils import vis
from test_torch_train_step import CFG, DIMS, TRUNC, chunks  # noqa: F401

EXECUTIONS = ("sparse", "dense_flow")
LW = np.ones(4, np.float32)  # every level and the surface


# ---------------------------------------------------------------- BN


@pytest.mark.parametrize("masked", [True, False])
def test_masked_bn_training(masked):
    rng = np.random.RandomState(0)
    x = (rng.randn(300, 6) * 2 + 1).astype(np.float32)
    mask = rng.rand(300) < 0.6 if masked else None
    params = {"scale": (0.5 + rng.rand(6)).astype(np.float32),
              "bias": (0.3 * rng.randn(6)).astype(np.float32)}
    stats = {"mean": (0.2 * rng.randn(6)).astype(np.float32),
             "var": (0.5 + rng.rand(6)).astype(np.float32)}
    g = rng.randn(300, 6).astype(np.float32)

    def jf(x):
        return JBN.batch_norm(params, stats, x,
                              None if mask is None else jnp.asarray(mask),
                              training=True, relu=True)
    (jy, js), vjp = jax.vjp(jf, jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, js)))

    xt = torch.from_numpy(x).requires_grad_()
    y, s = BN.batch_norm({k: torch.from_numpy(v) for k, v in params.items()},
                         {k: torch.from_numpy(v) for k, v in stats.items()},
                         xt, None if mask is None else torch.from_numpy(mask),
                         training=True)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s[k].numpy(), js[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- K10 backward


def _shell_rows(n_pad=37):
    """A shell's sites at 16^3, batch 2, and their neighbour lists: the
    submanifold 27-tap list and the strided 8-tap list to the parents,
    each padded with ``n_pad`` rows."""
    z, y, x = np.meshgrid(*(np.arange(16),) * 3, indexing="ij")
    r = np.sqrt((z - 7.5) ** 2 + (y - 8) ** 2 + (x - 7) ** 2)
    locs = []
    for b, rad in enumerate((5.0, 6.0)):
        idx = np.stack(np.nonzero(np.abs(r - rad) < 1.2), -1)
        locs.append(np.concatenate([idx, np.full((len(idx), 1), b)], 1))
    locs = np.concatenate(locs).astype(np.int32)
    n, cap = len(locs), len(locs) + n_pad
    st = make_sparse(torch.from_numpy(np.pad(locs, ((0, n_pad), (0, 0)),
                                             constant_values=-1)),
                     torch.zeros(cap, 1), n, (16, 16, 16), 2)
    sub = CV.neighbours(st, "gather")
    grid = st.index_grid()
    parents, n_par, _ = C.unique_locs(C.parent_locs(st.locs), n, (8, 8, 8),
                                      2, cap)
    rows = CV.neighbor_rows(parents, grid, C.neighbor_offsets(2), (16,) * 3,
                            2, scale=2)
    return {27: sub, 8: K_gg.NeighbourList(rows, n_par, cap)}


@pytest.mark.parametrize("K", [27, 8])
def test_inverse_rows_is_the_transpose(K):
    nl = _shell_rows()[K]
    rows = nl.rows.numpy()
    want = np.zeros((nl.cap_in, K), np.int32)
    for i in range(nl.num_out):
        for k in range(K):
            if rows[i, k]:
                assert want[rows[i, k] - 1, k] == 0  # unique targets
                want[rows[i, k] - 1, k] = i + 1
    np.testing.assert_array_equal(nl.inverse().numpy(), want)
    assert nl.inverse() is nl.inverse()  # built once


@pytest.mark.parametrize("K,cin,cout", [(27, 12, 8), (8, 8, 16)])
def test_gather_gemm_grads_match_jax(K, cin, cout):
    nl = _shell_rows()[K]
    cap = nl.rows.shape[0]
    rng = np.random.RandomState(K)
    feats = rng.randn(cap, cin).astype(np.float32)
    w = (0.3 * rng.randn(K, cin, cout)).astype(np.float32)
    g = rng.randn(cap, cout).astype(np.float32)
    g[nl.num_out:] = 0  # the conv zeroes its padding rows' outputs
    rows = nl.rows.numpy()
    _, vjp = jax.vjp(lambda f, w: JCV.gather_gemm(f, jnp.asarray(rows), w),
                     jnp.asarray(feats), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))

    gt, wt = torch.from_numpy(g), torch.from_numpy(w)
    dx = K_gg.gather_gemm_dx(gt, nl.rows, nl.inverse(), wt, nl.num_out)
    # K10's input-gradient launch computes this sum over the inverse list
    k10 = K_gg.gather_gemm_plain(gt, nl.inverse(), wt.transpose(1, 2))
    dw = K_gg.weight_grad(torch.from_numpy(feats), nl.rows, gt)
    for got in (dx, k10):
        np.testing.assert_allclose(got.numpy(), jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), jdw, rtol=1e-5, atol=1e-4)
    # the plain version under autograd gives the same gradients
    f = torch.from_numpy(feats).requires_grad_()
    wr = wt.clone().requires_grad_()
    K_gg.gather_gemm(f, nl.rows, wr, nbr=nl).backward(gt)
    np.testing.assert_allclose(f.grad.numpy(), jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wr.grad.numpy(), jdw, rtol=1e-5, atol=1e-4)


# --------------------------------------------------- forward and loss


@pytest.fixture(scope="module")
def weights_batch(chunks):  # noqa: F811
    _, files = chunks
    params, stats = init_params(SGNNConfig(**CFG), seed=3)
    ds = D.SceneDataset(files, TRUNC, 3)
    batch = D.collate([ds[0], ds[1]], JConfig(**CFG).input_cap)
    return params, stats, batch


def _kw(training=True):
    return dict(num_refine_active=2, do_surf=True, use_log_transform=True,
                weight_missing_geo=5.0, use_loss_masking=True,
                training=training)


@pytest.fixture(scope="module")
def jax_runs(weights_batch):
    """The JAX step's loss, outputs, new stats and gradients of each
    execution."""
    params, stats, batch = weights_batch
    runs = {}
    for ex in EXECUTIONS:
        jcfg = JConfig(execution=ex, **CFG)
        st, sdf, known, hier = JTS._unpack_batch(
            jcfg, jax.tree.map(jnp.asarray, PM.device_batch(batch, 1)))
        targets = JL.compute_targets(sdf, hier, 3, TRUNC, True, known)

        def loss(p, jcfg=jcfg, st=st, targets=targets, known=known):
            return JTS._forward_loss(p, stats, jcfg, st, targets,
                                     jnp.asarray(LW), known, axis_name=None,
                                     **_kw())
        runs[ex] = jax.device_get(jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params))
    return runs


@pytest.fixture(scope="module")
def port_runs(weights_batch):
    """The port's loss, outputs, new stats and gradients of each
    execution, with (K, Cin, Cout, whether the input needs a gradient) of
    every K10 call."""
    params, stats, batch = weights_batch
    runs, calls = {}, set()
    orig = K_gg.gather_gemm

    def spy(feats, nbr_rows, weight, **kw):
        calls.add((*weight.shape, feats.requires_grad))
        return orig(feats, nbr_rows, weight, **kw)
    K_gg.gather_gemm = spy
    try:
        for ex in EXECUTIONS:
            cfg = SGNNConfig(execution=ex, **CFG)
            model = TS.train_model(cfg)
            load_jax_params(model, params, stats)
            inputs, targets, known = TS._prepare(
                cfg, TS.to_device(batch, "cpu"), True)
            total, (per, out, new) = TS._forward_loss(
                model.param_tree(), model.stat_tree(), cfg, inputs, targets,
                list(LW), known, **_kw())
            total.backward()
            runs[ex] = (model, total, per, out, new)
    finally:
        K_gg.gather_gemm = orig
    return runs, calls


@pytest.mark.parametrize("ex", EXECUTIONS)
def test_forward_loss_matches_jax(jax_runs, port_runs, ex):
    (jtotal, (jper, jout, _)), _ = jax_runs[ex]
    _, total, per, out, _ = port_runs[0][ex]
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)
    np.testing.assert_allclose(torch.stack(per).detach().numpy(),
                               np.asarray(jper), rtol=1e-4, atol=1e-6)
    assert (np.asarray(jper) > 0).all()

    def close(a, b, what):
        a, b = a.detach().numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-4 * max(np.abs(b).max(), 1),
                                   err_msg=what)
    close(out.coarse_out, jout.coarse_out, "coarse_out")
    if ex == "sparse":
        assert out.overflows == [int(o) for o in jout.overflows]
        for h, ((lu, ou, nu), (jl, jo, jn)) in enumerate(zip(
                out.refine_outs, jout.refine_outs)):
            assert nu == int(jn), h
            np.testing.assert_array_equal(lu[:nu].numpy(), jl[:nu])
            close(ou[:nu], jo[:nu], f"level {h}")
        n = out.surf_num_valid
        assert n == int(jout.surf_num_valid) and n > 0
        np.testing.assert_array_equal(out.surf_locs[:n].numpy(),
                                      jout.surf_locs[:n])
        close(out.surf_sdf[:n], jout.surf_sdf[:n], "surface")
    else:
        for h, (o, m, jo, jm) in enumerate(zip(
                out.refine_outs, out.refine_masks_unfilt, jout.refine_outs,
                jout.refine_masks_unfilt)):
            np.testing.assert_array_equal(m.numpy(), jm)
            close(torch.where(m[..., None], o, 0),
                  np.where(jm[..., None], jo, 0), f"level {h}")
        np.testing.assert_array_equal(out.surf_mask.numpy(), jout.surf_mask)
        assert out.surf_mask.any()
        close(torch.where(out.surf_mask, out.surf_sdf, 0),
              np.where(jout.surf_mask, jout.surf_sdf, 0), "surface")


@pytest.mark.parametrize("ex", EXECUTIONS)
def test_new_stats_match_jax(jax_runs, port_runs, ex):
    (_, (_, _, jnew)), _ = jax_runs[ex]
    new = port_runs[0][ex][4]
    want = dict(tree_items(jnew))
    got = list(tree_items(new))
    assert sorted(k for k, _ in got) == sorted(want)
    for k, v in got:
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# per-parameter gradient tolerance, a share of the parameter's largest
# |g|. The masks are bit-equal, so the two sides differ by f32 summation
# orders, and the dense flow agrees to ~1e-5. In the coordinate lists two
# pre-activations of the finest level's n2 BN lie within f32 rounding of 0
# and take opposite sides of the ReLU in the two packages (every earlier
# BN output has the same zero pattern); that one kink moves a few
# parameters' gradients by up to 6.0e-3 of their largest |g| (without it,
# with capacities that do not overflow, they agree to 2e-5)
GRAD_TOL = {"dense_flow": 5e-3, "sparse": 1e-2}


@pytest.mark.parametrize("ex", EXECUTIONS)
def test_gradients_match_jax(jax_runs, port_runs, ex):
    """Every parameter's gradient to GRAD_TOL of its largest |g|, and all
    of them to 5e-3 in norm (|a - b| / |b| over every parameter)."""
    _, jgrads = jax_runs[ex]
    model = port_runs[0][ex][0]
    want = dict(tree_items(jgrads))
    diff2 = ref2 = 0.0
    for k, p in zip(model.param_keys, model.weights):
        g = np.asarray(want[k])
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        denom = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(got / denom, g / denom,
                                   atol=GRAD_TOL[ex], err_msg=k)
        diff2 += float(((got - g) ** 2).sum())
        ref2 += float((g ** 2).sum())
    assert (diff2 / ref2) ** 0.5 < 5e-3, (diff2 / ref2) ** 0.5


def test_input_gradient_shapes_fit_k10(port_runs):
    """Every K10 call of the coordinate lists' step, and the transposed
    call of its input gradient (Cin and Cout swapped; none for the
    encoder's first conv, whose input is the data), at shapes K10 takes in
    both compute types."""
    calls = port_runs[1]
    assert {(k, cin, grad) for k, cin, _, grad in calls
            if not grad} == {(27, 1, False)}
    shapes = {(k, cin) for k, cin, _, _ in calls} | {
        (k, cout) for k, _, cout, grad in calls if grad}
    assert {k for k, _ in shapes} == {27, 8}
    assert all(K_gg.fits(k, cin, dt) for k, cin in shapes
               for dt in (torch.float32, torch.bfloat16)), shapes


# ------------------------------------------------------------- the CLI


@pytest.mark.parametrize("ex", EXECUTIONS)
def test_cli_trains_execution(chunks, tmp_path, ex):  # noqa: F811
    d, _ = chunks
    save = tmp_path / "logs"
    trainer = train_cli.main([
        "--data_path", str(d), "--train_file_list", str(d / "train.txt"),
        "--save", str(save), "--input_dim", "32", "--num_hierarchy_levels",
        "3", "--encoder_dim", "4", "--coarse_feat_dim", "8",
        "--refine_feat_dim", "8", "--batch_size", "2", "--max_steps", "2",
        "--num_iters_per_level", "1", "--compute_dtype", "float32",
        "--execution", ex, "--cpu"])
    assert trainer.cfg.execution == ex and trainer.iteration == 2
    assert np.isfinite([v for _, v in trainer.loss_history]).all()
    path = str(save / "model-epoch-0.ckpt")
    template = JS.create_train_state(*init_params(SGNNConfig(**CFG)))
    state, meta = JC.load_checkpoint(path, template)
    assert meta["iteration"] == 2 and int(state.opt_state.count) == 2
    # the execution's eval forward serves the checkpoint
    from sgnn_tpu_torch.checkpoint import load_checkpoint
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.dense_flow import GenModelDense
    from sgnn_tpu_torch.models.sgnn import GenModelSparse

    cfg = SGNNConfig(**dict(CFG, batch_size=1, execution=ex))
    ck = load_checkpoint(path, cfg)
    model = (GenModelSparse if ex == "sparse" else GenModelDense)(cfg)
    load_jax_params(model, ck.params, ck.stats)
    r = SceneInferencer(model)(synthetic_scene(DIMS, seed=1))
    assert np.isfinite(r["surf_sdf"]).all()


@pytest.mark.parametrize("ex", ["folded", *EXECUTIONS])
def test_visualize_batch_writes_plys(chunks, tmp_path, ex):  # noqa: F811
    from sgnn_tpu_torch.meshing.ply import load_ply
    from sgnn_tpu_torch.train.loop import TrainOptions, Trainer

    _, files = chunks
    tr = Trainer(TrainOptions(
        input_dim=DIMS, encoder_dim=4, coarse_feat_dim=8, refine_feat_dim=8,
        num_hierarchy_levels=3, batch_size=2, compute_dtype="float32",
        device="cpu", save=str(tmp_path), execution=ex))
    ds = D.SceneDataset(files, TRUNC, 3, sparse_targets=True)
    batch = D.collate_sparse([ds[0], ds[1]], tr.cfg.input_cap,
                             *estimate_row_capacities(files, 3, TRUNC, 2))
    tr.visualize_batch(batch, str(tmp_path / "vis"))
    out = sorted(os.listdir(tmp_path / "vis"))
    for name in batch["names"]:
        for part in ("input-mesh", "target-mesh", "pred-0", "pred-1"):
            assert f"{name}{part}.ply" in out, (part, out)
    name = batch["names"][0]
    for part in ("target-mesh", "pred-1"):
        verts, _, _ = load_ply(str(tmp_path / "vis" / f"{name}{part}.ply"))
        assert len(verts) and np.isfinite(verts).all(), part


def test_vis_point_clouds(tmp_path):
    from sgnn_tpu_torch.meshing.ply import load_ply

    sdf = np.full((6, 7, 8), 5.0, np.float32)
    sdf[2, 3, 4], sdf[1, 1, 1] = 0.5, -0.5
    vis.visualize_sdf_as_points(sdf, 1.0, str(tmp_path / "a.ply"))
    vis.visualize_sparse_locs_as_points(np.array([[2, 3, 4, 0]]),
                                        str(tmp_path / "b.ply"))
    vis.visualize_occ_as_points(sdf, 4.0, str(tmp_path / "c.ply"))
    a = load_ply(str(tmp_path / "a.ply"))[0]
    np.testing.assert_array_equal(np.sort(a, 0), [[1.5, 1.5, 1.5],
                                                 [4.5, 3.5, 2.5]])
    np.testing.assert_array_equal(load_ply(str(tmp_path / "b.ply"))[0],
                                  [[4.5, 3.5, 2.5]])
    assert len(load_ply(str(tmp_path / "c.ply"))[0]) == sdf.size - 2
