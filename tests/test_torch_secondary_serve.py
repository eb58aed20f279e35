"""Serving through the secondary executions: the port's SceneInferencer
with GenModelSparse and GenModelDense against the JAX SceneInferencer
with ``execution="sparse"`` and ``"dense_flow"`` on one tiny scene (rows
and masks bit-equal and in the same order; coarse 1e-4, levels and
surface 2e-3, f32), and the scene CLI with ``--execution sparse --cpu``
(its meshes byte-equal to the port's inferencer's). Also the folded
forward's input rows, cut to ``input_cap`` as the JAX inferencer cuts
them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.infer import SceneInferencer as JInferencer
from sgnn_tpu_torch.checkpoint import save_checkpoint
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.data import formats as F
from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
from sgnn_tpu_torch.meshing import export as E
from sgnn_tpu_torch.models.dense_flow import GenModelDense
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.models.sgnn import GenModelSparse
from sgnn_tpu_torch.params import init_params, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(encoder_dim=4, nf_coarse=8, nf=8, num_hierarchy_levels=3,
           batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0))
DIMS = (16, 16, 32)
SEED = 4  # weights whose gates leave a surface on the scene


@pytest.mark.parametrize("execution", ["sparse", "dense_flow"])
def test_inferencer_matches_jax(execution):
    cfg = dict(CFG, input_dim=DIMS, execution=execution)
    params, stats = init_params(SGNNConfig(**cfg), SEED)
    sample = synthetic_scene(DIMS, seed=1, orig_dims=(16, 13, 27))
    ref = JInferencer(JConfig(**cfg), params, stats, compact=False)(sample)
    model = (GenModelSparse if execution == "sparse" else GenModelDense)(
        SGNNConfig(**cfg))
    load_jax_params(model, params, stats)
    got = SceneInferencer(model)(sample)
    assert len(got["surf_locs"]) > 0, "degenerate case: empty surface"
    for key in ("surf_locs", "input_locs", "input_sdf", "orig_dims"):
        np.testing.assert_array_equal(got[key], ref[key])
    assert (got["surf_locs"] < sample["orig_dims"]).all()
    np.testing.assert_allclose(got["surf_sdf"], ref["surf_sdf"], rtol=0,
                               atol=2e-3)
    assert len(got["levels"]) == len(ref["levels"]) == 3
    np.testing.assert_allclose(got["levels"][0]["dense_out"],
                               ref["levels"][0]["dense_out"], rtol=0,
                               atol=1e-4)
    for a, b in zip(got["levels"][1:], ref["levels"][1:]):
        np.testing.assert_array_equal(a["locs"], b["locs"])
        np.testing.assert_allclose(a["out"], b["out"], rtol=0, atol=2e-3)
    if execution == "sparse":
        assert got["overflows"] == [0, 0]


def test_folded_cuts_rows_to_input_cap():
    """On a scene with more input rows than ``input_capacity``, the port's
    folded SceneInferencer keeps the first rows in file order, as the JAX
    inferencer does: its surface equals the JAX one's (on the CPU the JAX
    inferencer runs the dense flow; f32: IoU 1.0, sdf to 2e-3)."""
    cfg = dict(CFG, input_dim=DIMS, execution="dense_flow",
               input_capacity=640)
    params, stats = init_params(SGNNConfig(**cfg), SEED)
    sample = synthetic_scene(DIMS, seed=1, orig_dims=(16, 13, 27))
    # a file order other than the sorted one, so which rows the cut keeps
    # matters
    perm = np.random.RandomState(0).permutation(len(sample["input_locs"]))
    sample = dict(sample, input_locs=sample["input_locs"][perm],
                  input_sdf=sample["input_sdf"][perm])
    assert len(perm) > SGNNConfig(**cfg).input_cap == 640
    ref = JInferencer(JConfig(**cfg), params, stats, compact=False)(sample)
    model = GenModelFolded(SGNNConfig(**cfg))
    load_jax_params(model, params, stats)
    got = SceneInferencer(model)(sample)
    assert len(ref["surf_locs"]) > 0, "degenerate case: empty surface"
    for key in ("input_locs", "input_sdf"):
        np.testing.assert_array_equal(got[key], ref[key])
    a = dict(zip(map(tuple, got["surf_locs"]), got["surf_sdf"]))
    b = dict(zip(map(tuple, ref["surf_locs"]), ref["surf_sdf"]))
    assert a.keys() == b.keys()  # IoU 1.0
    np.testing.assert_allclose([a[k] for k in b], list(b.values()), rtol=0,
                               atol=2e-3)


def test_cli_sparse_cpu_matches_inferencer(tmp_path):
    """The CLI with --execution sparse --cpu (a .ckpt written by the port)
    writes the meshes the port's SceneInferencer gives with
    GenModelSparse."""
    cfg = SGNNConfig(**dict(CFG, input_dim=DIMS, execution="sparse"))
    params, stats = init_params(cfg, SEED)
    inp, tgt = tmp_path / "in", tmp_path / "tgt"
    inp.mkdir()
    tgt.mkdir()
    s = synthetic_scene(DIMS, seed=1)
    vol = F.SceneVolume(s["input_locs"], s["input_sdf"], DIMS, 0.02,
                        np.eye(4, dtype=np.float32))
    for base in (inp, tgt):
        F.save_scene(str(base / "room__0__.sdf"), vol)
    F.save_known(str(tgt / "room__0__.knw"), DIMS, 0.02,
                 np.eye(4, dtype=np.float32), np.ones(DIMS, np.uint8))
    (tmp_path / "list.txt").write_text("room\n")
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, params, stats, epoch=0, iteration=0)
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "sgnn_tpu_torch.tools.test_scene",
         "--input_data_path", str(inp), "--target_data_path", str(tgt),
         "--test_file_list", str(tmp_path / "list.txt"),
         "--model_path", ckpt, "--output", str(out),
         "--num_hierarchy_levels", "3", "--encoder_dim", "4",
         "--coarse_feat_dim", "8", "--refine_feat_dim", "8",
         "--max_input_height", "0", "--occupancy_fractions", "1", "1", "1",
         "--execution", "sparse", "--compute_dtype", "float32", "--cpu",
         "--mesh_workers", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr

    model = GenModelSparse(cfg)
    load_jax_params(model, params, stats)
    sample = D.SceneDataset([str(inp / "room__0__.sdf")], 3.0, 3,
                            max_input_height=0, target_path=str(tgt))[0]
    r = SceneInferencer(model)(sample)
    assert len(r["surf_locs"]) > 0, "degenerate case: empty surface"
    ref = tmp_path / "ref"
    E.save_predictions(str(ref), r["name"], r["input_locs"], r["input_sdf"],
                       tuple(r["orig_dims"]),
                       pred_surf=(r["surf_locs"], r["surf_sdf"]))
    for kind in ("input-mesh", "pred-mesh"):
        f = f"{r['name']}{kind}.ply"
        assert (out / f).read_bytes() == (ref / f).read_bytes(), f
