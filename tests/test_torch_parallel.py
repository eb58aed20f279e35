"""Multi-device execution of the port (``sgnn_tpu_torch/parallel``) on the
CPU: the port's ranks are host processes over gloo (``parallel.mesh.
launch``), the JAX package runs ``shard_map`` on the conftest's virtual
CPU devices, and the inputs are made from seeds with numpy.

- 4 ranks (``programs.collectives``) against JAX on a 4-device mesh, at
  tests/test_spatial.py's sizes: ``halo_exchange`` and ``halo_exchange_z``
  (the planes bit-equal), ``sharded_conv3d`` at stride 1 and 2 (1e-4 /
  1e-5), ``scatter_sparse_sharded`` (bit-equal), the training
  ``batch_norm`` with moments all-reduced over the ranks and the folded
  ``bn_folded_train`` (output, new stats and input gradient against
  ``jax.grad`` of ``ops/bn.py`` / ``ops/folded.py:bn_folded`` with
  ``axis_name``, 1e-4 / 1e-5).
- 2 ranks (one launch of ``programs.sequence``): the dense flow's
  z-sharded forward in eval and training mode against
  ``genmodel_apply_dense(..., sp_axis=)`` under ``shard_map`` (2e-4,
  masks bit-equal, the training BN stats to 1e-3 / 1e-5 as
  test_spatial.py has them); one data-parallel dense-flow training step
  against JAX's two-device step (``_forward_loss`` with the data axis and
  the ``pmean``s of ``make_train_step``, under ``shard_map(check_vma=
  False)``) at the single-device step's tolerances
  (test_torch_train_secondary.py): this settles the backward of the
  all-reduced moments; two folded data-parallel steps whose ranks hold the
  same parameters, bit for bit; the folded z-sharded forward in its
  level-output form against the port's unsharded forward of the same
  scene (the surface and each level's slabs: masks bit-equal, 2e-4).
- ``device_batch`` and ``shard_files`` bit-equal to the JAX package's.
- The training CLI with ``--cpu --num_devices 2`` and its refusals.

The port's ranks run in a thread started with the module's first fixture,
so that they overlap the JAX side's compiles.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sgnn_tpu import losses as JL
from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.data import dataset as JD
from sgnn_tpu.models import dense_flow as JDF
from sgnn_tpu.ops import bn as JBN
from sgnn_tpu.ops import folded as JFO
from sgnn_tpu.ops.sparse import make_sparse as jmake_sparse
from sgnn_tpu.parallel import mesh as JPM
from sgnn_tpu.parallel import spatial as JSP
from sgnn_tpu.train import step as JTS
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.infer import synthetic_scene
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.parallel import mesh as PM
from sgnn_tpu_torch.parallel import programs as PG
from sgnn_tpu_torch.params import init_params, load_jax_params, tree_items
from sgnn_tpu_torch.tools import dryrun_multichip
from sgnn_tpu_torch.tools import train as train_cli
from test_torch_train_step import CFG, TRUNC, chunks  # noqa: F401

_POOL = concurrent.futures.ThreadPoolExecutor(4)

# ------------------------------------------------------------- inputs


def _collective_case(n=4, seed=0):
    rng = np.random.RandomState(seed)
    c = {"x": rng.randn(1, 32, 8, 8, 3).astype(np.float32),
         "w3": (rng.randn(5, 3, 3, 3, 3) * 0.2).astype(np.float32),
         "w2": (rng.randn(4, 3, 2, 2, 2) * 0.3).astype(np.float32)}
    c["halo_cot"] = rng.randn(1, 32 + 2 * n, 8, 8, 3).astype(np.float32)
    c["gather_cot"] = rng.randn(n, 1, 32, 8, 8, 3).astype(np.float32)
    m = rng.rand(1, 16, 8, 16) < 0.4
    c["fold"] = (rng.randn(1, 16, 8, 16, 5) * m[..., None]).astype(np.float32)
    c["fold_mask"] = m
    flat = rng.choice(16 * 8 * 16, 300, replace=False)
    z, r = flat // 128, flat % 128
    c["locs"] = np.stack([z, r // 16, r % 16, np.zeros_like(z)],
                         -1).astype(np.int32)
    c["feats"] = rng.uniform(-2.99, 2.99, (300, 1)).astype(np.float32)
    c["scatter_dims"] = (16, 8, 16)
    c["rows"] = rng.randn(64 * n, 5).astype(np.float32)
    c["row_mask"] = rng.rand(64 * n) > 0.3
    c["row_cot"] = rng.randn(64 * n, 5).astype(np.float32)
    c["bn"] = {"scale": (0.5 + rng.rand(5)).astype(np.float32),
               "bias": rng.randn(5).astype(np.float32)}
    c["bn_stats"] = {"mean": rng.randn(5).astype(np.float32),
                     "var": (0.5 + rng.rand(5)).astype(np.float32)}
    fm = rng.rand(n, 4, 8, 16) < 0.5
    c["fg"] = (rng.randn(n, 4, 8, 16, 5) * fm[..., None]).astype(np.float32)
    c["fg_mask"] = fm
    c["fg_cot"] = rng.randn(n, 4, 8, 16, 5).astype(np.float32)
    return c


# the dense flow z-sharded over 2 ranks: test_spatial.py's model at three
# levels (its JAX compile is the longest part of the module), Z % (32 * 2)
# == 0, 600 random input voxels
DENSE_CFG = dict(encoder_dim=4, input_dim=(64, 16, 16), nf_coarse=8, nf=8,
                 num_hierarchy_levels=3, batch_size=1,
                 occupancy_fractions=(1.0, 1.0, 1.0))
# the folded forward z-sharded over 2 ranks (f32, L = 3)
FOLD_CFG = dict(encoder_dim=4, input_dim=(64, 16, 32), nf_coarse=8, nf=8,
                num_hierarchy_levels=3, batch_size=1,
                occupancy_fractions=(1.0, 1.0, 1.0), compute_dtype="float32")
# the seed of the folded case's random weights: seeds 0, 2, 3 and 7 close
# every gate at this size, 1 leaves 201 surface voxels, 4 leaves 3059
FOLD_SEED = 4
LW = np.ones(4, np.float32)
LR = 1e-3
GRAD_TOL = 5e-3  # test_torch_train_secondary.py's, the dense flow


def _dense_inputs(seed=0):
    rng = np.random.RandomState(seed)
    Z, Y, X = DENSE_CFG["input_dim"]
    n = 600
    flat = rng.choice(Z * Y * X, size=n, replace=False)
    z, rem = flat // (Y * X), flat % (Y * X)
    locs = np.full((640, 4), -1, np.int32)
    locs[:n] = np.stack([z, rem // X, rem % X, np.zeros_like(z)], -1)
    feats = np.zeros((640, 1), np.float32)
    feats[:n, 0] = rng.randn(n).astype(np.float32)
    return locs, feats, n


def _fold_scene():
    sc = synthetic_scene(FOLD_CFG["input_dim"], seed=1)
    n = len(sc["input_locs"])
    locs = np.concatenate([sc["input_locs"], np.zeros((n, 1), np.int32)], 1)
    return locs, sc["input_sdf"][:, None].copy()


@pytest.fixture(scope="module")
def dense_weights():
    return init_params(SGNNConfig(**DENSE_CFG), seed=0)


@pytest.fixture(scope="module")
def dp_batch(chunks):  # noqa: F811
    _, files = chunks
    ds = D.SceneDataset(files, TRUNC, 3)
    return D.collate([ds[0], ds[1]], JConfig(**CFG).input_cap)


@pytest.fixture(scope="module")
def port(dense_weights, dp_batch, chunks, tmp_path_factory):  # noqa: F811
    """Every launch of the module, started at once in the pool: the 4-rank
    collectives, the 2-rank jobs, the CLI on 2 ranks and the dry run's
    phases on 2 ranks."""
    d, _ = chunks
    save = tmp_path_factory.mktemp("dp") / "logs"
    return {"ranks4": _POOL.submit(PM.launch, PG.collectives, 4, "gloo",
                                   (_collective_case(), "cpu")),
            "ranks2": _ranks2(dense_weights, dp_batch),
            "cli": (save, _POOL.submit(train_cli.main, [
                "--data_path", str(d), "--train_file_list",
                str(d / "train.txt"), "--save", str(save), "--input_dim",
                "32", "--encoder_dim", "4", "--coarse_feat_dim", "8",
                "--refine_feat_dim", "8", "--num_hierarchy_levels", "3",
                "--batch_size", "2", "--max_steps", "2",
                "--num_iters_per_level", "1", "--compute_dtype", "float32",
                "--num_devices", "2", "--cpu"])),
            "dryrun": _POOL.submit(_dryrun)}


@pytest.fixture(scope="module")
def ranks4(port):
    return port["ranks4"]


@pytest.fixture(scope="module")
def ranks2(port):
    return port["ranks2"]


def _ranks2(dense_weights, dp_batch):
    """The 2-rank jobs, in one launch: [dense eval, dense training, the
    dense DP step, two folded DP steps, the folded sharded forward]."""
    locs, feats, n = _dense_inputs()
    dp_cfg = dict(CFG, execution="dense_flow")
    fold_w = init_params(SGNNConfig(**FOLD_CFG), seed=FOLD_SEED)
    flocs, ffeats = _fold_scene()
    step = dict(num_refine_active=2, do_surf=True, with_metrics=True,
                device="cpu")
    jobs = [
        ("serve_dense", (DENSE_CFG, dense_weights, locs, feats, n),
         dict(training=False, device="cpu")),
        ("serve_dense", (DENSE_CFG, dense_weights, locs, feats, n),
         dict(training=True, device="cpu")),
        ("train_dp", (dp_cfg, init_params(SGNNConfig(**dp_cfg), seed=3),
                      [dp_batch], LW, LR), step),
        ("train_dp", (dict(CFG, execution="folded"),
                      init_params(SGNNConfig(**CFG), seed=3),
                      [dp_batch, dp_batch], LW, LR), step),
        ("serve_folded", (FOLD_CFG, fold_w, flocs, ffeats,
                          FOLD_CFG["input_dim"], "cpu"),
         dict(want_level_outputs=True)),
    ]
    return _POOL.submit(PM.launch, PG.sequence, 2, "gloo", (jobs,))


def _dryrun():
    """The dry run's plan (host forwards) and its jobs on 2 ranks."""
    jobs, info = dryrun_multichip.plan(2)
    jobs = [(name, a, dict(kw, device="cpu")) for name, a, kw in jobs]
    return PM.launch(PG.sequence, 2, "gloo", (jobs,)), info


def _mesh(n, axis="data"):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


# ----------------------------------------------------- the collectives


@pytest.fixture(scope="module")
def jax_collectives(ranks4):
    c = _collective_case()
    mesh = _mesh(4)
    sm = lambda f, i, o: jax.jit(shard_map(  # noqa: E731
        f, mesh=mesh, in_specs=i, out_specs=o, check_vma=False))
    zs = P(None, "data")
    out = {}
    out["halo"] = sm(lambda x: JSP.halo_exchange(x, 1, "data"), zs, zs)(
        c["x"])
    out["conv_s1"] = sm(lambda x, w: JSP.sharded_conv3d(x, w, "data"),
                        (zs, P()), zs)(c["x"], c["w3"])
    out["conv_s2"] = sm(lambda x, w: JSP.sharded_conv3d(
        x, w, "data", stride=2, padding=0), (zs, P()), zs)(c["x"], c["w2"])
    out["halo_dx"] = sm(lambda x, g: jax.grad(lambda x: jnp.sum(
        JSP.halo_exchange(x, 1, "data") * g))(x), (zs, zs), zs)(
        c["x"], c["halo_cot"])
    out["gather_dx"] = sm(lambda x, g: jax.grad(lambda x: jnp.sum(
        jax.lax.all_gather(x, "data", axis=1, tiled=True) * g[0]))(x),
        (zs, P("data")), zs)(c["x"], c["gather_cot"])
    out["halo_z"] = sm(lambda x: JFO.halo_exchange_z(
        JFO.fold(x, 16), "data").data, zs, zs)(c["fold"])
    out["halo_z_mask"] = sm(lambda m: JFO.halo_exchange_z(
        JFO.fold_mask(m, 16, jnp.float32), "data").data, zs, zs)(
        c["fold_mask"])

    def scatter(locs, feats):
        fg, fm = JFO.scatter_sparse_sharded(
            locs, feats, locs.shape[0], c["scatter_dims"], 1, "data",
            cpad=8, dtype=jnp.float32, feat_bound=3.0)
        return fg.data, fm.data
    # the Pallas binned scatter, which K6 ports (test_torch_kernels.py), in
    # the interpreter
    import sgnn_tpu.ops.pallas.scatter_folded as SF

    orig = SF.pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("jax.default_backend", lambda: "tpu")
        mp.setattr(SF.pl, "pallas_call", lambda *a, **k: orig(
            *a, **{**k, "interpret": True}))
        out["scatter"], out["scatter_mask"] = sm(
            scatter, (P(), P()), (zs, zs))(c["locs"], c["feats"])

    def bn_rows(x, m, cot):
        def f(x):
            y, st = JBN.batch_norm(c["bn"], c["bn_stats"], x, m,
                                   training=True, relu=True,
                                   axis_name="data")
            return jnp.sum(y * cot), (y, st)
        (_, (y, st)), dx = jax.value_and_grad(f, has_aux=True)(x)
        return y, st, dx
    out["bn_y"], out["bn_stats"], out["bn_dx"] = sm(
        bn_rows, (P("data"),) * 3, (P("data"), P(), P("data")))(
        c["rows"], c["row_mask"], c["row_cot"])

    def bn_fold(x, m, cot):
        def f(x):
            y, st = JFO.bn_folded(c["bn"], c["bn_stats"], JFO.fold(x, 16),
                                  JFO.fold_mask(m, 16, jnp.float32),
                                  training=True, axis_name="data")
            yd = JFO.unfold(y)
            return jnp.sum(yd * cot), (yd, st)
        (_, (y, st)), dx = jax.value_and_grad(f, has_aux=True)(x)
        return y, st, dx
    out["fbn_y"], out["fbn_stats"], out["fbn_dx"] = sm(
        bn_fold, (P("data"),) * 3, (P("data"), P(), P("data")))(
        c["fg"], c["fg_mask"], c["fg_cot"])
    return jax.device_get(out)


def _cat(ranks, key, axis):
    return np.concatenate([r[key] for r in ranks], axis)


@pytest.mark.parametrize("key", ["halo", "halo_batched", "halo_z",
                                 "halo_z_mask", "scatter", "scatter_mask"])
def test_exchanges_bit_equal_jax(ranks4, jax_collectives, key):
    """The exchanged planes (``halo_batched``: through NCCL's batched
    point-to-point path, run here on gloo) and the scattered slabs, rank
    by rank."""
    got = _cat(ranks4.result(), key, 1)
    want = jax_collectives[key.replace("_batched", "")]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_halo_edges_are_zero(ranks4):
    r = ranks4.result()
    assert not r[0]["halo"][:, 0].any() and not r[-1]["halo"][:, -1].any()
    assert not r[0]["halo_z"][:, 0].any() and r[1]["halo_z"][:, 0].any()
    np.testing.assert_array_equal(r[2]["halo"][:, 0], r[1]["halo"][:, -2])


@pytest.mark.parametrize("key", ["conv_s1", "conv_s2", "halo_dx",
                                 "gather_dx"])
def test_sharded_conv_matches_jax(ranks4, jax_collectives, key):
    """The sharded convs, and the input gradients of the exchange (the
    reverse exchange) and of the all-gather (its cotangents summed over
    the ranks, each rank's slab kept) against jax.grad of ppermute and
    all_gather under check_vma=False."""
    np.testing.assert_allclose(_cat(ranks4.result(), key, 1),
                               np.asarray(jax_collectives[key]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("site", ["bn", "fbn"])
def test_allreduced_bn_matches_jax(ranks4, jax_collectives, site):
    """Forward, new running stats and input gradient of the BN whose
    moments are summed over 4 ranks (masked rows; the folded site)."""
    r = ranks4.result()
    for k in ("y", "dx"):
        np.testing.assert_allclose(
            _cat(r, f"{site}_{k}", 0), np.asarray(jax_collectives[
                f"{site}_{k}"]), rtol=1e-4, atol=1e-5, err_msg=k)
    for rank in r:  # every rank holds the same new stats
        for k, v in jax_collectives[f"{site}_stats"].items():
            np.testing.assert_allclose(rank[f"{site}_stats"][k],
                                       np.asarray(v), rtol=1e-4, atol=1e-5)


# ------------------------------------------------ the dense flow, sharded


@pytest.fixture(scope="module")
def jax_dense(dense_weights, ranks2):
    params, stats = dense_weights
    jcfg = JConfig(**DENSE_CFG)
    locs, feats, n = _dense_inputs()
    mesh = _mesh(2, "space")
    outs = {}
    for training in (False, True):
        def f(locs, feats, training=training):
            st = jmake_sparse(locs, feats, n, jcfg.input_dim, 1)
            out, new = JDF.genmodel_apply_dense(
                params, stats, jcfg, st,
                num_refine_active=jcfg.num_refine_levels, do_surf=True,
                training=training, sp_axis="space")
            return (out.coarse_out, out.refine_outs,
                    out.refine_masks_unfilt, out.surf_sdf, out.surf_mask,
                    new)
        zs = P(None, "space")
        nl = jcfg.num_refine_levels
        outs[training] = jax.device_get(jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P(), P()),
            out_specs=(zs, [zs] * nl, [zs] * nl, zs, zs, P()),
            check_vma=False))(locs, feats))
    return outs


@pytest.mark.parametrize("training", [False, True])
def test_dense_flow_sharded_matches_jax(ranks2, jax_dense, training):
    ranks = [r[int(training)] for r in ranks2.result()]
    co, refs, masks, surf, smask, new = jax_dense[training]
    close = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_cat(ranks, "coarse_out", 1), co, **close)
    for h in range(len(refs)):
        m = np.concatenate([r["refine_masks"][h] for r in ranks], 1)
        np.testing.assert_array_equal(m, masks[h])
        o = np.concatenate([r["refine_outs"][h] for r in ranks], 1)
        np.testing.assert_allclose(np.where(m[..., None], o, 0),
                                   np.where(m[..., None], refs[h], 0),
                                   **close, err_msg=f"level {h}")
    assert masks[0].any()
    got_mask = _cat(ranks, "surf_mask", 1)
    np.testing.assert_array_equal(got_mask, smask)
    np.testing.assert_allclose(np.where(smask, _cat(ranks, "surf_sdf", 1), 0),
                               np.where(smask, surf, 0), **close)
    if training:  # the moments over the space group, the trunk's over none
        want = dict(tree_items(new))
        for r in ranks:
            assert sorted(r["stats"]) == sorted(want)
            for k, v in r["stats"].items():
                np.testing.assert_allclose(v, want[k], rtol=1e-3, atol=1e-5,
                                           err_msg=k)


# ------------------------------------------- data-parallel training steps


@pytest.fixture(scope="module")
def jax_dp_step(dp_batch, ranks2):
    """JAX's two-device step of the dense flow (make_train_step's body:
    value_and_grad of _forward_loss with the data axis, then the pmeans)
    from the weights the port's ranks start from."""
    jcfg = JConfig(**dict(CFG, execution="dense_flow", batch_size=1))
    params, stats = init_params(SGNNConfig(**dict(CFG,
                                                  execution="dense_flow")),
                                seed=3)
    db = JPM.device_batch(dp_batch, 2)

    def step(params, batch):
        st, sdf, known, hier = JTS._unpack_batch(jcfg, batch)
        targets = JL.compute_targets(sdf, hier, 3, TRUNC, True, known)
        (total, (per, _, new)), grads = jax.value_and_grad(
            JTS._forward_loss, has_aux=True)(
            params, stats, jcfg, st, targets, jnp.asarray(LW), known,
            num_refine_active=2, do_surf=True, use_log_transform=True,
            weight_missing_geo=5.0, use_loss_masking=True, training=True,
            axis_name="data")
        pm = lambda t: jax.lax.pmean(t, "data")  # noqa: E731
        return (pm(total), [pm(p) for p in per], jax.tree.map(pm, grads),
                new)
    return jax.device_get(jax.jit(shard_map(
        step, mesh=_mesh(2), in_specs=(P(), JTS._batch_specs(jcfg, False)),
        out_specs=P(), check_vma=False))(params, db))


def test_dp_step_matches_jax(ranks2, jax_dp_step):
    """One data-parallel step on 2 ranks: loss, per-level losses, new
    running stats and the averaged gradients at the single-device step's
    tolerances. The moments' all-reduce differentiates as a sum (psum's
    transpose under check_vma=False); an identity backward leaves out
    every rank's cotangent of the other's moments and misses them."""
    total, per, grads, new = jax_dp_step
    for r in [rk[2] for rk in ranks2.result()]:
        np.testing.assert_allclose(r["metrics"]["loss"], total, rtol=1e-4)
        np.testing.assert_allclose(r["metrics"]["per_level"],
                                   np.asarray(per), rtol=1e-4, atol=1e-6)
        want = dict(tree_items(new))
        for k, v in r["stats"].items():
            np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        jg = dict(tree_items(grads))
        diff2 = ref2 = 0.0
        for k, g in r["grads"].items():
            g_ref = np.asarray(jg[k])
            denom = max(np.abs(g_ref).max(), 1e-6)
            np.testing.assert_allclose(g / denom, g_ref / denom,
                                       atol=GRAD_TOL, err_msg=k)
            diff2 += float(((g - g_ref) ** 2).sum())
            ref2 += float((g_ref ** 2).sum())
        assert (diff2 / ref2) ** 0.5 < 5e-3


@pytest.mark.parametrize("job", [2, 3])
def test_dp_ranks_hold_identical_parameters(ranks2, job):
    """After every step (the dense flow's one, the folded execution's two)
    both ranks hold the same parameters, bit for bit, and they moved."""
    a, b = (r[job] for r in ranks2.result())
    assert len(a["params"]) == len(b["params"])
    for pa, pb in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(pa, pb)
    assert np.isfinite(a["metrics"]["loss"])
    assert a["metrics"]["loss"] == b["metrics"]["loss"]
    if job == 3:
        assert not np.array_equal(a["params"][0], a["params"][1])


# ----------------------------------------------- the folded forward, sharded


def test_folded_sharded_matches_unsharded(ranks2):
    """The level-output form z-sharded over 2 ranks against the unsharded
    one: the surface, the coarse output and each level's slabs, joined
    (masks bit-equal, values within 2e-4; the raw heads on the level's
    unfiltered sites)."""
    cfg = SGNNConfig(**FOLD_CFG)
    model = GenModelFolded(cfg)
    load_jax_params(model, *init_params(cfg, seed=FOLD_SEED))
    locs, feats = _fold_scene()
    ref = model(torch.from_numpy(locs), torch.from_numpy(feats),
                cfg.input_dim, want_level_outputs=True)
    ranks = [r[4] for r in ranks2.result()]
    assert len(ref.refine_outs) == cfg.num_refine_levels
    for h, (want, wm) in enumerate(zip(ref.refine_outs,
                                       ref.refine_masks_unfilt)):
        m = np.concatenate([r["refine_masks_unfilt"][h] for r in ranks], 1)
        np.testing.assert_array_equal(m, wm.numpy())
        assert m.any(), f"degenerate case: level {h} has no sites"
        got = np.concatenate([r["refine_outs"][h] for r in ranks], 1)
        np.testing.assert_allclose(got[m], want.numpy()[m], rtol=2e-4,
                                   atol=2e-4)
    mask = _cat(ranks, "surf_mask", 1)
    np.testing.assert_array_equal(mask, ref.surf_mask.numpy())
    assert mask.any()
    np.testing.assert_allclose(
        np.where(mask, _cat(ranks, "surf_sdf", 1), 0),
        np.where(mask, ref.surf_sdf.numpy(), 0), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_cat(ranks, "coarse_out", 1),
                               ref.coarse_out.numpy(), rtol=2e-4, atol=2e-4)
    act = np.sum([r["level_active"] for r in ranks], 0)
    assert act.tolist() == [int(a) for a in ref.level_active]


def test_folded_sharding_refusals(monkeypatch):
    """Z that two slabs of 32 do not tile (the int8 forward is sharded:
    tests/test_torch_parallel_int8.py)."""
    from sgnn_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "size", lambda g: 1 if g is None else 2)
    args = (torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 1))
    for q8 in (False, True):
        model = GenModelFolded(SGNNConfig(**dict(FOLD_CFG,
                                                 quantize_int8=q8)))
        with pytest.raises(ValueError, match="must divide by 32"):
            model(*args, (96, 16, 32), space="space")


# ----------------------------------------------------- per-rank batches


@pytest.mark.parametrize("sparse", [False, True])
def test_device_batch_matches_jax(chunks, sparse):  # noqa: F811
    _, files = chunks
    ds = D.SceneDataset(files, TRUNC, 3, sparse_targets=sparse)
    samples = [ds[i] for i in range(4)]
    cap = JConfig(**dict(CFG, batch_size=4)).input_cap
    if sparse:
        batch = D.collate_sparse(samples, cap, 40000, [8000, 2000])
    else:
        batch = D.collate(samples, cap)
    for n in (2, 4):
        got = jax.tree.map(np.asarray, PM.device_batch(batch, n))
        want = jax.tree.map(np.asarray, JPM.device_batch(batch, n))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        one = PM.rank_slice(PM.device_batch(batch, n), 1)
        assert one["input_locs"].shape[0] == cap // n
        assert int(one["input_num_valid"]) == int(
            PM.device_batch(batch, n)["input_num_valid"][1])
        assert np.ndim(one["input_num_valid"]) == 0


def test_shard_files_matches_jax():
    files = [f"f{i}" for i in range(11)]
    for hosts in (1, 2, 3):
        for h in range(hosts):
            assert D.shard_files(files, h, hosts) == JD.shard_files(
                files, h, hosts)


# ------------------------------------------------------------ the CLI


def test_cli_trains_on_two_ranks(port):
    save, run = port["cli"]
    hist = run.result()
    assert len(hist) == 2 and hist[0] == hist[1] and len(hist[0]) == 2
    assert all(np.isfinite(loss) for _, loss in hist[0])
    assert sorted(os.listdir(save)) == ["args.txt", "log.csv",
                                        "model-epoch-0.ckpt"]


def test_cli_refuses_what_it_cannot_split(chunks, monkeypatch):  # noqa: F811
    d, _ = chunks
    base = ["--data_path", str(d), "--train_file_list", str(d / "train.txt")]
    with pytest.raises(SystemExit):  # a batch that does not divide
        train_cli.main(base + ["--batch_size", "3", "--num_devices", "2",
                               "--cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 CUDA devices"):
        train_cli.main(base + ["--num_devices", "2"])


def test_dryrun_reports_its_four_phases(port, capsys):
    """tools/dryrun_multichip.py's four phases on 2 ranks: one line each,
    every check passed."""
    res, info = port["dryrun"].result()
    dryrun_multichip.report(2, "gloo, cpu", res, info)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" ok")[0] for ln in lines] == [
        "[dryrun_multichip] FOLDED DP train", "[dryrun_multichip] DP SERVING",
        "[dryrun_multichip] spatial", "[dryrun_multichip] spatial FOLDED"]
