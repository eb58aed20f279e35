"""Checkpoint export and the evaluation path of the port against the JAX
package: ``export_state_dict`` and ``expected_state_dict_spec`` (exact),
the convert CLI both ways (bit-exact), the three evaluation metrics,
``SceneInferencer.measured_fractions`` (exact) and the evaluate CLI with
``--cpu`` (its metrics against JAX's metric functions on the same
surfaces).

The port sums its metrics in f64 and rounds them to f32; JAX's metric
functions sum in the dtype of their inputs, so they run here in f64 (the
same f32 inputs, widened), and the two agree to 1e-6 relative. In f32 the
JAX sums alone move by ~2e-6 relative over a 16x16x32 grid."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu import losses as JL
from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.infer import SceneInferencer as JInferencer
from sgnn_tpu.utils import ckpt_convert as JCC
from sgnn_tpu_torch import losses as L
from sgnn_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import formats as F
from sgnn_tpu_torch.data.dataset import SceneDataset
from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.models.folded_train import GenModelFoldedTrain
from sgnn_tpu_torch.params import export_params, init_params, \
    load_jax_params, tree_items
from sgnn_tpu_torch.tools import convert_checkpoint, evaluate
from sgnn_tpu_torch.utils import ckpt_convert as CC

# the JAX package's test config (tests/test_infer.py:48), in f32
CFG = dict(encoder_dim=4, input_dim=(32, 32, 32), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0))
CLI_CFG = ["--num_hierarchy_levels", "3", "--encoder_dim", "4",
           "--coarse_feat_dim", "8", "--refine_feat_dim", "8"]
METRIC_RTOL = 1e-6
SEED = 4  # weights whose gates leave a surface on the 16x16x32 sphere


def _assert_sd_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype == np.float32, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _assert_trees_equal(a, b) -> None:
    ia, ib = list(tree_items(a)), list(tree_items(b))
    assert [k for k, _ in ia] == [k for k, _ in ib]
    for (k, x), (_, y) in zip(ia, ib):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=k)


@pytest.mark.parametrize("cfg", [
    CFG, dict(CFG, pass_occ=False), dict(CFG, use_skip_sparse=False),
    dict(input_dim=(64, 64, 64), batch_size=1)], ids=[
    "tiny", "no_pass_occ", "no_skip_sparse", "default"])
def test_spec_matches_jax(cfg):
    ref = {}

    def jax_spec():
        # traced, not run: genmodel_init's shapes without its compiles
        ref.update(JCC.expected_state_dict_spec(JConfig(**cfg)))
        return 0

    jax.eval_shape(jax_spec)
    assert len(ref) > 100
    assert CC.expected_state_dict_spec(SGNNConfig(**cfg)) == ref


def test_export_matches_jax():
    """The port's own trees (a training model filled by load_jax_params
    and read back by export_params) export to the JAX package's
    state_dict of the same weights, key for key and bit for bit; the
    state_dict converts back to the same trees."""
    cfg = SGNNConfig(**CFG)
    params, stats = init_params(cfg, seed=3)
    # BN stats away from their init, so a mix-up of leaves shows
    rng = np.random.RandomState(0)
    for _, leaf in tree_items(stats):
        leaf += rng.rand(*leaf.shape).astype(np.float32)
    model = GenModelFoldedTrain(cfg)
    load_jax_params(model, params, stats)
    port_p, port_s = export_params(model)
    _assert_trees_equal(port_p, params)
    got = CC.export_state_dict(port_p, port_s, cfg)
    _assert_sd_equal(got, JCC.export_state_dict(params, stats,
                                                JConfig(**CFG)))
    assert {k: v.shape for k, v in got.items()} == \
        CC.expected_state_dict_spec(cfg)
    back_p, back_s = CC.convert_state_dict(got, cfg)
    _assert_trees_equal(back_p, params)
    _assert_trees_equal(back_s, stats)


def test_convert_cli_roundtrip(tmp_path, capsys):
    """.ckpt -> .pth -> .ckpt through the CLI: the trees bit for bit; the
    .pth holds the reference layout, which the JAX converter reads to the
    same weights."""
    cfg = SGNNConfig(**CFG)
    params, stats = init_params(cfg, seed=5)
    ck, pth, ck2 = (str(tmp_path / n) for n in ("a.ckpt", "b.pth", "c.ckpt"))
    save_checkpoint(ck, params, stats, epoch=7, iteration=3)
    convert_checkpoint.main(["--input", ck, "--output", pth, *CLI_CFG])
    convert_checkpoint.main(["--input", pth, "--output", ck2, *CLI_CFG])
    assert "227 state_dict keys" in capsys.readouterr().out
    raw = torch.load(pth, map_location="cpu", weights_only=True)
    assert raw["epoch"] == 7 and raw["optimizer"] == {}
    p, s, meta = CC.load_reference_checkpoint(pth, cfg)
    assert meta["epoch"] == 7
    _assert_trees_equal(p, params)
    _assert_trees_equal(s, stats)
    back = load_checkpoint(ck2, cfg)
    _assert_trees_equal(back.params, params)
    _assert_trees_equal(back.stats, stats)
    assert back.meta["epoch"] == 7 and back.meta["source"] == "b.pth"
    assert back.step == 0 and back.count == 0
    assert all(not np.any(v) for _, v in tree_items(back.mu))
    # the JAX converter, with the port's trees as its templates (its own
    # come from genmodel_init, whose eager init costs ~20 s here)
    jp, js = JCC.convert_state_dict(raw["state_dict"], JConfig(**CFG),
                                    *init_params(cfg, seed=0))
    _assert_trees_equal(jp, params)
    _assert_trees_equal(js, stats)


def test_convert_cli_refuses_same_direction(tmp_path):
    with pytest.raises(SystemExit):
        convert_checkpoint.parse_args(["--input", "a.ckpt", "--output",
                                       "b.ckpt"])


# ------------------------------------------------------------- metrics


def _jax64(fn, *args):
    """``fn`` on ``args`` (numpy arrays or None) with JAX in f64, under
    ``jax.jit`` (one compile, not one per op): float arrays widened, the
    rest in their own dtypes."""
    with jax.enable_x64(True):
        args = [None if a is None else jnp.asarray(
            a, jnp.float64 if a.dtype == np.float32 else a.dtype)
            for a in args]
        return float(jax.jit(fn)(*args))


def _metric_case(case: str, seed: int = 0):
    """A [2, 8, 10, 12] target with a near-surface band, known grid with
    unobserved voxels, and a row list of predictions (capacity 400, the
    last rows padding) per case."""
    rng = np.random.RandomState(seed)
    shape = (2, 8, 10, 12)
    tgt = rng.uniform(-5, 5, shape).astype(np.float32)
    tgt[rng.rand(*shape) < 0.1] = -np.inf
    known = np.where(rng.rand(*shape) < 0.2, 255, 0).astype(np.uint8)
    known[rng.rand(*shape) < 0.1] = 2  # the UNK_THRESH boundary
    n_all = int(np.prod(shape))
    n = {"rows": 300, "empty_union": 0, "all_unknown": 300}[case]
    keys = rng.choice(n_all, n, replace=False)
    b, rem = np.divmod(keys, int(np.prod(shape[1:])))
    z, rem = np.divmod(rem, shape[2] * shape[3])
    y, x = np.divmod(rem, shape[3])
    cap = 400
    locs = np.full((cap, 4), -1, np.int32)
    locs[:n] = np.stack([z, y, x, b], -1)
    preds = rng.uniform(-3, 3, cap).astype(np.float32)
    occupied = rng.rand(cap) < 0.7
    if case == "empty_union":
        tgt = np.full(shape, 10.0, np.float32)  # nothing near the surface
    if case == "all_unknown":
        known[:] = 255
    weights = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return tgt, known, locs, n, preds, occupied, weights


@pytest.mark.parametrize("case", ["rows", "empty_union", "all_unknown"])
def test_metrics_match_jax(case):
    tgt, known, locs, n, preds, occupied, weights = _metric_case(case)
    trunc = 3.0
    t = L.preprocess_sdf(torch.from_numpy(tgt), trunc)
    jt = np.asarray(JL.preprocess_sdf(jnp.asarray(tgt), trunc))
    tk, unk = torch.from_numpy(known), known >= JL.UNK_THRESH
    tl, tp = torch.from_numpy(locs), torch.from_numpy(preds)
    got, ref = {}, {}
    for logt in (False, True):
        for w in (None, weights):
            key = f"predsurf log={logt} w={w is not None}"
            got[key] = L.compute_l1_predsurf_sparse_dense(
                tl, n, tp, t, None if w is None else torch.from_numpy(w),
                logt, True, tk >= L.UNK_THRESH)
            ref[key] = _jax64(
                lambda lc, p, tg, wt, u, logt=logt:
                JL.compute_l1_predsurf_sparse_dense(
                    lc, jnp.int32(n), p, tg, wt, logt, True, u),
                locs, preds, jt, w, unk)
    for masking in (False, True):
        got[f"tgtsurf {masking}"] = L.compute_l1_tgtsurf_sparse_dense(
            tl, n, tp, t, trunc, masking, tk)
        ref[f"tgtsurf {masking}"] = _jax64(
            lambda lc, p, tg, k, masking=masking:
            JL.compute_l1_tgtsurf_sparse_dense(  # it scatters into f32
                lc, jnp.int32(n), p.astype(jnp.float32), tg, trunc, masking,
                k),
            locs, preds, jt, known)
        occ = torch.where(tk >= L.UNK_THRESH, torch.full_like(t, L.UNK_ID),
                          (t.abs() < trunc).float())
        jocc = jnp.where(unk, JL.UNK_ID,
                         (np.abs(jt) < trunc).astype(np.float32))
        got[f"iou {masking}"] = L.compute_iou_sparse_dense(
            tl, n, torch.from_numpy(occupied), occ, masking)
        ref[f"iou {masking}"] = JL.compute_iou_sparse_dense(
            jnp.asarray(locs), jnp.int32(n), jnp.asarray(occupied), jocc,
            masking)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=METRIC_RTOL, atol=0, err_msg=k)
    if case == "empty_union":
        assert float(got["iou True"]) == -1.0
    if case == "all_unknown":
        assert float(got["predsurf log=False w=False"]) == 0.0


# --------------------------------------------------- inferencer, CLI


def test_measured_fractions_match_jax():
    """The folded inferencer's calibration record equals the JAX
    inferencer's (the dense flow on the CPU) on one scene."""
    dims = (16, 16, 32)
    cfg = dict(CFG, input_dim=dims, execution="dense_flow")
    params, stats = init_params(SGNNConfig(**cfg), SEED)
    sample = synthetic_scene(dims, seed=1, orig_dims=(16, 13, 27))
    jinf = JInferencer(JConfig(**cfg), params, stats)
    jinf(sample)
    model = GenModelFolded(SGNNConfig(**cfg))
    load_jax_params(model, params, stats)
    inf = SceneInferencer(model)
    got = inf(sample)
    assert len(got["surf_locs"]) > 0, "degenerate case: empty surface"
    assert inf.measured_fractions() == jinf.measured_fractions()
    assert set(inf.measured_fractions()[dims]) == {1, 2}


def _write_scene(inp, tgt, name, dims, radius):
    """A sphere scene pair: the target band |sdf| < 3 and 80% of it as
    the input; known 0 inside the band, 255 off it in one corner."""
    z, y, x = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    d = np.sqrt((z - dims[0] / 2) ** 2 + (y - dims[1] / 2) ** 2
                + (x - dims[2] / 2) ** 2) - radius
    m = np.abs(d) < 3.0
    locs = np.stack(np.nonzero(m), -1).astype(np.int32)
    keep = np.random.RandomState(len(name)).rand(len(locs)) < 0.8
    w2g = np.eye(4, dtype=np.float32)
    F.save_scene(os.path.join(inp, name + "__0__.sdf"), F.SceneVolume(
        locs[keep], d[m][keep].astype(np.float32), dims, 0.02, w2g))
    F.save_scene(os.path.join(tgt, name + "__0__.sdf"), F.SceneVolume(
        locs, d[m].astype(np.float32), dims, 0.02, w2g))
    known = np.zeros(dims, np.uint8)
    known[: dims[0] // 2, : dims[1] // 2] = 255
    F.save_known(os.path.join(tgt, name + "__0__.knw"), dims, 0.02, w2g,
                 known)


def test_evaluate_cli_cpu_matches_jax_metrics(tmp_path):
    """The CLI's records on two scenes hold the metrics that JAX's metric
    functions give on the surfaces the port's inferencer serves."""
    inp, tgt = tmp_path / "in", tmp_path / "tgt"
    inp.mkdir()
    tgt.mkdir()
    _write_scene(str(inp), str(tgt), "a", (16, 16, 30), 6.0)
    _write_scene(str(inp), str(tgt), "bb", (14, 18, 32), 5.0)
    (tmp_path / "list.txt").write_text("a\nbb\n")
    cfg = SGNNConfig(**dict(CFG, input_dim=(16, 16, 32)))
    params, stats = init_params(cfg, SEED)
    save_checkpoint(str(tmp_path / "m.ckpt"), params, stats, epoch=0,
                    iteration=0)
    out = tmp_path / "metrics.json"
    args = ["--input_data_path", str(inp), "--target_data_path", str(tgt),
            "--test_file_list", str(tmp_path / "list.txt"), "--model_path",
            str(tmp_path / "m.ckpt"), "--output", str(out), *CLI_CFG,
            "--max_input_height", "0", "--compute_dtype", "float32",
            "--execution", "folded", "--cpu"]
    res = evaluate.main(args)
    assert res["skipped"] == 0
    js = json.loads(out.read_text())
    assert set(js) == {"aggregate", "scenes", "measured_occupancy_fractions"}
    assert [s["name"] for s in js["scenes"]] == ["a__0__", "bb__0__"]
    assert set(js["measured_occupancy_fractions"]) == {"16x16x32",
                                                       "16x32x32"}

    # the CLI's default occupancy fractions: they size the input rows
    model = GenModelFolded(SGNNConfig(**dict(
        CFG, input_dim=(16, 16, 32),
        occupancy_fractions=(1.0, 0.5, 0.25, 0.2))))
    load_jax_params(model, params, stats)
    ds = SceneDataset([str(inp / "a__0__.sdf"), str(inp / "bb__0__.sdf")],
                      3.0, 3, max_input_height=0, target_path=str(tgt))
    n_surf = 0
    for rec, sample in zip(js["scenes"], ds):
        r = SceneInferencer(model)(sample)
        n = len(r["surf_locs"])
        assert rec["surf_voxels"] == n
        n_surf += n
        if not n:
            assert rec["l1_pred"] == rec["l1_tgt"] == rec["iou_surface"] \
                == -1.0
            continue
        locs4 = np.concatenate([r["surf_locs"], np.zeros((n, 1), np.int32)],
                               -1)
        t = np.asarray(JL.preprocess_sdf(jnp.asarray(sample["sdf"][None]),
                                         3.0))
        known = sample["known"][None]
        ref = {
            "l1_pred": _jax64(
                lambda lc, p, tg, u: JL.compute_l1_predsurf_sparse_dense(
                    lc, jnp.int32(n), p, tg, None, False, True, u),
                locs4, r["surf_sdf"], t, known >= JL.UNK_THRESH),
            "l1_tgt": _jax64(
                lambda lc, p, tg, k: JL.compute_l1_tgtsurf_sparse_dense(
                    lc, jnp.int32(n), p.astype(jnp.float32), tg, 3.0, True,
                    k),
                locs4, r["surf_sdf"], t, known),
            "iou_surface": JL.compute_iou_sparse_dense(
                jnp.asarray(locs4), jnp.int32(n), jnp.ones((n,), bool),
                jnp.where(known >= JL.UNK_THRESH, JL.UNK_ID,
                          (jnp.abs(t) < 3.0).astype(jnp.float32)), True),
        }
        for k, v in ref.items():
            np.testing.assert_allclose(rec[k], float(v), rtol=METRIC_RTOL,
                                       atol=0, err_msg=k)
    assert n_surf > 0, "degenerate case: no surface on either scene"
    agg = js["aggregate"]
    for k in ("l1_pred", "l1_tgt", "iou_surface"):
        vals = [s[k] for s in js["scenes"] if s[k] >= 0]
        assert agg[k] == (float(np.mean(vals)) if vals else -1.0)

    # --tap_order auto on the weights as a reference .pth: the first
    # scene under both tap orders, the lower l1_pred chosen and recorded
    pth = str(tmp_path / "m.pth")
    convert_checkpoint.main(["--input", str(tmp_path / "m.ckpt"),
                             "--output", pth, *CLI_CFG])
    args[args.index("--model_path") + 1] = pth
    evaluate.main([*args, "--tap_order", "auto", "--max_scenes", "1"])
    tap = json.loads(out.read_text())["tap_order"]
    assert tap["l1_pred_c"] == js["scenes"][0]["l1_pred"]
    assert tap["chosen"] == min(("c", "flipped"),
                                key=lambda k: tap[f"l1_pred_{k}"])


def test_evaluate_cli_needs_cuda_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate.main(["--input_data_path", "i", "--target_data_path", "t",
                       "--test_file_list", "l", "--model_path", "m.ckpt"])
