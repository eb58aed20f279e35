"""The port's training checkpoints and CLI against the JAX package, on the
CPU: the port's trainer writes a ``.ckpt`` that JAX ``load_checkpoint``
reads (with and without weight decay); JAX writes one, the port resumes
from it (``retrain="auto"``); the CLI with ``--cpu`` trains 6 steps
through the fade-in and its checkpoint serves a scene through
``GenModelFolded``; with ``--fuse_train_bn 0`` (the composed BN -> op
ablation) it trains and writes a checkpoint both packages load; the CLI
refuses what is not ported.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models.sgnn import genmodel_init
from sgnn_tpu.train import checkpoint as JC
from sgnn_tpu.train import state as JS
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.params import (export_params, init_params,
                                   load_jax_params, tree_items)
from sgnn_tpu_torch.tools import train as train_cli
from sgnn_tpu_torch.train import state as ST
from sgnn_tpu_torch.train.loop import TrainOptions, Trainer
from test_torch_train_step import (CFG, DIMS, TRUNC, _assert_equal,  # noqa
                                   chunks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- checkpoints


def _trainer(save, **kw):
    opts = TrainOptions(input_dim=DIMS, encoder_dim=4, coarse_feat_dim=8,
                        refine_feat_dim=8, num_hierarchy_levels=3,
                        batch_size=2, compute_dtype="float32", device="cpu",
                        save=str(save), **kw)
    return Trainer(opts)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_trainer_ckpt_to_jax(chunks, tmp_path, weight_decay):
    _, files = chunks
    tr = _trainer(tmp_path, weight_decay=weight_decay, num_iters_per_level=1)
    ds = D.SceneDataset(files, TRUNC, 3)
    tr.run_step(D.collate([ds[0], ds[1]], tr.cfg.input_cap))
    path = str(tmp_path / "m.ckpt")
    tr.save_ckpt(path, epoch=1)
    template = JS.create_train_state(
        *jax.jit(genmodel_init, static_argnums=1)(
            jax.random.PRNGKey(0), JConfig(**CFG)), weight_decay)
    state, meta = JC.load_checkpoint(path, template)
    assert meta == {"epoch": 1, "iteration": 1}
    params, stats = export_params(tr.model)
    mu, nu, count = ST.adam_state(tr.opt, tr.model)
    adam = state.opt_state[1] if weight_decay else state.opt_state
    _assert_equal(params, jax.device_get(state.params))
    _assert_equal(stats, jax.device_get(state.stats))
    _assert_equal(mu, jax.device_get(adam.mu))
    _assert_equal(nu, jax.device_get(adam.nu))
    assert count == int(adam.count) == 1 and int(state.step) == 1
    # the surface is inactive at step 0: its gradient is zero, and its
    # moment holds only the decay term
    p0 = init_params(tr.cfg, 0)[0]["surfacepred"]["p1"]
    np.testing.assert_allclose(mu["surfacepred"]["p1"],
                               0.1 * weight_decay * p0, rtol=1e-5,
                               atol=1e-12)
    assert np.abs(mu["encoder"]["process_sparse"][0]["p1"]).max() > 0


def test_trainer_resumes_jax_ckpt(tmp_path):
    params, stats = jax.jit(genmodel_init, static_argnums=1)(
        jax.random.PRNGKey(5), JConfig(**CFG))
    state = JS.create_train_state(params, stats)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, params)
    state = JS.apply_updates(state, grads, stats, 1e-3)
    JC.save_checkpoint(str(tmp_path / "model-epoch-2.ckpt"), state, epoch=3,
                       iteration=40)
    tr = _trainer(tmp_path, retrain="auto")
    assert (tr.start_epoch, tr.iteration) == (3, 40)
    params_p, stats_p = export_params(tr.model)
    _assert_equal(jax.device_get(state.params), params_p)
    _assert_equal(jax.device_get(stats), stats_p)
    mu, nu, count = ST.adam_state(tr.opt, tr.model)
    _assert_equal(jax.device_get(state.opt_state.mu), mu)
    _assert_equal(jax.device_get(state.opt_state.nu), nu)
    assert count == 1


# -------------------------------------------------------------- CLI


def _cli(args, env=None):
    # two threads: the suite runs several workers on the same cores
    env = {**os.environ, "OMP_NUM_THREADS": "2", **(env or {})}
    return subprocess.run(
        [sys.executable, "-m", "sgnn_tpu_torch.tools.train", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)


def test_cli_cpu_trains_and_serves(chunks, tmp_path):
    d, _ = chunks
    save = tmp_path / "logs"
    res = _cli(["--data_path", str(d), "--train_file_list",
                str(d / "train.txt"), "--val_file_list",
                str(d / "train.txt"), "--save", str(save), "--input_dim",
                "32", "--num_hierarchy_levels", "3", "--encoder_dim", "4",
                "--coarse_feat_dim", "8", "--refine_feat_dim", "8",
                "--batch_size", "2", "--max_epoch", "3", "--max_steps", "6",
                "--num_iters_per_level", "1", "--compute_dtype", "float32",
                "--cpu"])
    assert res.returncode == 0, res.stdout + res.stderr
    files = set(os.listdir(save))
    assert {"log.csv", "log_val.csv", "args.txt",
            "model-epoch-0.ckpt"} <= files
    assert (save / "log.csv").read_text().startswith(
        "epoch,iter,train_loss(total),train_loss(0)")
    # validation after epochs 0 and 1 (epoch 2 ends at max_steps)
    val = (save / "log_val.csv").read_text().splitlines()
    assert val[0].startswith("epoch,iter,val_loss(total)") and len(val) == 3
    assert all(np.isfinite(float(v)) for v in val[1].split(","))

    from sgnn_tpu_torch.checkpoint import load_checkpoint
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded

    cfg = SGNNConfig(**dict(CFG, batch_size=1))
    ck = load_checkpoint(str(save / "model-epoch-2.ckpt"), cfg)
    assert ck.meta["iteration"] == 6 and ck.count == 6
    for _, v in tree_items(ck.params):
        assert np.isfinite(v).all()
    model = GenModelFolded(cfg)
    load_jax_params(model, ck.params, ck.stats)
    r = SceneInferencer(model)(synthetic_scene(DIMS, seed=1))
    assert np.isfinite(r["surf_sdf"]).all()
    assert np.isfinite(r["levels"][0]["dense_out"]).all()


def test_cli_trains_composed_bn(chunks, tmp_path):
    """--fuse_train_bn 0: the composed BN -> op ablation trains with
    finite losses, its epoch's prediction dump runs through the eval form,
    and its .ckpt loads into the JAX package's loader and the port's
    serving model."""
    from sgnn_tpu_torch.checkpoint import load_checkpoint
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded

    d, _ = chunks
    save = tmp_path / "logs"
    tr = train_cli.main([
        "--data_path", str(d), "--train_file_list", str(d / "train.txt"),
        "--save", str(save), "--input_dim", "32", "--num_hierarchy_levels",
        "3", "--encoder_dim", "4", "--coarse_feat_dim", "8",
        "--refine_feat_dim", "8", "--batch_size", "2", "--max_steps", "4",
        "--num_iters_per_level", "1", "--compute_dtype", "float32",
        "--fuse_train_bn", "0", "--cpu"])
    assert not tr.cfg.fuse_train_bn
    losses = [loss for _, loss in tr.loss_history]
    assert len(losses) == 4 and np.isfinite(losses).all()
    dumps = [p for p in save.glob("iter*-epoch1/train/*.ply")]
    assert dumps, sorted(os.listdir(save))
    path = str(save / "model-epoch-1.ckpt")
    cfg = SGNNConfig(**dict(CFG, batch_size=1))
    _, meta = JC.load_checkpoint(path, JS.create_train_state(
        *init_params(cfg, 0)))
    assert meta["iteration"] == 4
    ck = load_checkpoint(path, cfg)
    model = GenModelFolded(cfg)
    load_jax_params(model, ck.params, ck.stats)
    r = SceneInferencer(model)(synthetic_scene(DIMS, seed=1))
    assert np.isfinite(r["surf_sdf"]).all()


@pytest.mark.parametrize("extra,msg", [
    (["--no_pass_feats", "--no_pass_occ"], "exclude each other"),
    (["--ckpt_backend", "orbax"], "orbax"),
    (["--rss_restart_gb", "8"], "rss_restart_gb"),
    # data parallelism is ported: a batch (8) that the ranks cannot split
    (["--num_devices", "3"], "num_devices"),
])
def test_cli_refuses(tmp_path, capsys, extra, msg):
    base = ["--data_path", str(tmp_path), "--train_file_list",
            str(tmp_path / "l.txt")]
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args([*base, *extra, "--cpu"])
    assert e.value.code != 0 and msg in capsys.readouterr().err


def test_cli_needs_cuda_without_cpu(tmp_path, monkeypatch):
    """No silent switch to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main(["--data_path", str(tmp_path), "--train_file_list",
                        str(tmp_path / "l.txt")])
