"""The port's slim SceneInferencer on the CPU (plain kernel versions), and
the port's independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.ops import kernels as K
from sgnn_tpu_torch.params import init_params, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (32, 32, 32)


@pytest.fixture(scope="module")
def inferencer():
    # the default architecture (L=4, nf 16) at a tiny volume, in bf16
    cfg = SGNNConfig(input_dim=DIMS, batch_size=1, compute_dtype="bfloat16")
    model = GenModelFolded(cfg)
    load_jax_params(model, *init_params(cfg, seed=0))
    return SceneInferencer(model)


def test_scene_outputs(inferencer):
    K.reset_launch_counts()
    full = inferencer(synthetic_scene(DIMS, seed=1))
    assert set(K.launch_counts().values()) == {0}  # CPU: plain versions
    locs, sdf = full["surf_locs"], full["surf_sdf"]
    assert len(locs) > 0, "empty surface"
    assert locs.shape == (len(sdf), 3) and locs.dtype == np.int32
    assert np.isfinite(sdf).all() and sdf.dtype == np.float32
    assert len(full["level_active"]) == 4
    assert full["level_active"][-1] == len(locs)
    co = full["levels"][0]["dense_out"]
    assert co.shape == (4, 4, 4, 2) and np.isfinite(co).all()


def test_scene_crop(inferencer):
    """Outputs and inputs are cropped to orig_dims (test_scene.py's
    padding crop); the crop removes voxels and keeps the rest as is."""
    orig = (30, 24, 28)
    full = inferencer(synthetic_scene(DIMS, seed=1))
    crop = inferencer(synthetic_scene(DIMS, seed=1, orig_dims=orig))
    inside = (full["surf_locs"] < np.asarray(orig)).all(1)
    assert 0 < inside.sum() < len(inside)
    np.testing.assert_array_equal(crop["surf_locs"], full["surf_locs"][inside])
    np.testing.assert_array_equal(crop["surf_sdf"], full["surf_sdf"][inside])
    assert (crop["input_locs"] < np.asarray(orig)).all()
    assert len(crop["input_locs"]) < len(full["input_locs"])
    np.testing.assert_array_equal(crop["orig_dims"], orig)


def test_rows_order_does_not_matter(inferencer):
    """The rows the inferencer keeps are sorted: the same rows in another
    order give the same surface. (Rows beyond ``cfg.input_cap`` are cut in
    file order, as the JAX inferencer cuts them, so the scene is given as
    many rows as it keeps.)"""
    s = synthetic_scene(DIMS, seed=2)
    cap = inferencer.model.cfg.input_cap
    assert len(s["input_locs"]) > cap
    s = dict(s, input_locs=s["input_locs"][:cap],
             input_sdf=s["input_sdf"][:cap])
    perm = np.random.RandomState(0).permutation(len(s["input_locs"]))
    shuffled = dict(s, input_locs=s["input_locs"][perm],
                    input_sdf=s["input_sdf"][perm])
    a, b = inferencer(s), inferencer(shuffled)
    np.testing.assert_array_equal(a["surf_locs"], b["surf_locs"])
    np.testing.assert_array_equal(a["surf_sdf"], b["surf_sdf"])


def test_rejects_locs_outside_scene(inferencer):
    s = synthetic_scene(DIMS, seed=2)
    s["input_locs"] = s["input_locs"].copy()
    s["input_locs"][0] = (0, 0, DIMS[2])
    with pytest.raises(ValueError, match="outside"):
        inferencer(s)


def test_port_imports_without_jax():
    """The port, its CLIs, its datagen and chip_smoke.py import (and the
    CLIs parse their flags) with jax, sgnn_tpu and the root tools/
    blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sgnn_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "import sgnn_tpu_torch.infer, sgnn_tpu_torch.params\n"
        "import sgnn_tpu_torch.ops.kernels.build\n"
        "import sgnn_tpu_torch.checkpoint, sgnn_tpu_torch.utils.ckpt_convert\n"
        "import sgnn_tpu_torch.data.dataset, sgnn_tpu_torch.data.formats\n"
        "import sgnn_tpu_torch.meshing.export, sgnn_tpu_torch.meshing.native\n"
        "import sgnn_tpu_torch.ops.kernels.conv_raw, sgnn_tpu_torch.losses\n"
        "import sgnn_tpu_torch.ops.kernels.conv3d_cl\n"
        "import sgnn_tpu_torch.ops.kernels.gather_gemm\n"
        "import sgnn_tpu_torch.ops.quant\n"
        "import sgnn_tpu_torch.ops.kernels.tile_amax\n"
        "import sgnn_tpu_torch.models.sgnn, sgnn_tpu_torch.nn.blocks\n"
        "import sgnn_tpu_torch.schedules, sgnn_tpu_torch.data.capacity\n"
        "import sgnn_tpu_torch.models.folded_train\n"
        "import sgnn_tpu_torch.train.state, sgnn_tpu_torch.train.step\n"
        "import sgnn_tpu_torch.train.loop\n"
        "import sgnn_tpu_torch.datagen.camera, sgnn_tpu_torch.datagen.params\n"
        "import sgnn_tpu_torch.datagen.lighting, sgnn_tpu_torch.datagen.sens\n"
        "import sgnn_tpu_torch.datagen.segmentation\n"
        "import sgnn_tpu_torch.datagen.render, sgnn_tpu_torch.datagen.fusion\n"
        "import sgnn_tpu_torch.datagen.scene, sgnn_tpu_torch.datagen.chunking\n"
        "import sgnn_tpu_torch.utils.native_build\n"
        "from sgnn_tpu_torch.tools import test_scene, train, evaluate\n"
        "from sgnn_tpu_torch.tools import convert_checkpoint, make_chunks\n"
        "from sgnn_tpu_torch.tools import generate_scans, make_synthetic_scenes\n"
        "test_scene.parse_args(['--input_data_path', 'i',\n"
        "    '--target_data_path', 't', '--test_file_list', 'l',\n"
        "    '--model_path', 'm.ckpt'])\n"
        "evaluate.parse_args(['--input_data_path', 'i',\n"
        "    '--target_data_path', 't', '--test_file_list', 'l',\n"
        "    '--model_path', 'm.ckpt'])\n"
        "train.parse_args(['--data_path', 'd', '--train_file_list', 'l'])\n"
        "convert_checkpoint.parse_args(['--input', 'a.pth', '--output',\n"
        "    'b.ckpt'])\n"
        "generate_scans.parse_args(['--scan_path', 's', '--scan_mesh_path',\n"
        "    'm', '--scene_file_list', 'l', '--output_incomplete', 'o'])\n"
        "make_chunks.parse_args(['--input_data_path', 'i',\n"
        "    '--target_data_path', 't', '--scene_file_list', 'l',\n"
        "    '--output', 'o'])\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
