"""The port's serving stack against the JAX package: checkpoints (.ckpt
and reference .pth), scene files and SceneDataset, prediction export, and
the test_scene CLI on the CPU.

Every comparison is exact (array_equal or equal bytes): these stages copy,
reshape and write data without arithmetic of their own that could round
differently, and marching cubes runs the same source in both packages.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.data import dataset as JD
from sgnn_tpu.data import formats as JF
from sgnn_tpu.meshing import export as JE
from sgnn_tpu.models.sgnn import genmodel_init
from sgnn_tpu.train import checkpoint as JC
from sgnn_tpu.train import state as JS
from sgnn_tpu.utils import ckpt_convert as JCC
from sgnn_tpu_torch import checkpoint as C
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.data import formats as F
from sgnn_tpu_torch.meshing import export as E
from sgnn_tpu_torch.meshing import native
from sgnn_tpu_torch.utils import ckpt_convert as CC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's test config (tests/test_infer.py:48), in f32
CFG = dict(encoder_dim=4, input_dim=(32, 32, 32), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0))
W2G = np.eye(4, dtype=np.float32)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, path
        np.testing.assert_array_equal(x.astype(np.float32),
                                      y.astype(np.float32), err_msg=path)


@pytest.fixture(scope="module")
def jax_weights():
    params, stats = jax.jit(genmodel_init, static_argnums=1)(
        jax.random.PRNGKey(1), JConfig(**CFG))
    return jax.device_get(params), jax.device_get(stats)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_jax_ckpt_to_port(jax_weights, tmp_path, weight_decay):
    """JAX save_checkpoint (one Adam step taken, so the moments, count and
    step are not zero) -> the port's reader gives the same arrays."""
    params, stats = jax_weights
    state = JS.create_train_state(params, stats, weight_decay)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, params)
    state = JS.apply_updates(state, grads, stats, 1e-3, weight_decay)
    path = str(tmp_path / "m.ckpt")
    JC.save_checkpoint(path, state, epoch=2, iteration=17,
                       extra={"note": "x"})
    ck = C.load_checkpoint(path, SGNNConfig(**CFG))
    adam = state.opt_state[1] if weight_decay else state.opt_state
    _assert_tree_equal(jax.device_get(state.params), ck.params, "params")
    _assert_tree_equal(stats, ck.stats, "stats")
    _assert_tree_equal(jax.device_get(adam.mu), ck.mu, "mu")
    _assert_tree_equal(jax.device_get(adam.nu), ck.nu, "nu")
    assert (ck.count, ck.step) == (1, 1)
    assert ck.meta == {"epoch": 2, "iteration": 17, "note": "x"}
    assert np.abs(np.asarray(ck.mu["surfacepred"]["p1"])).max() > 0


def test_port_ckpt_to_jax(jax_weights, tmp_path):
    """The port's writer -> JAX load_checkpoint gives the same arrays, and
    Adam's moments default to zero."""
    params, stats = jax_weights
    path = str(tmp_path / "m.ckpt")
    mu = jax.tree_util.tree_map(lambda p: p * 0.5, params)
    C.save_checkpoint(path, params, stats, epoch=1, iteration=9, step=4,
                      mu=mu, count=3)
    state, meta = JC.load_checkpoint(
        path, JS.create_train_state(*jax.jit(
            genmodel_init, static_argnums=1)(jax.random.PRNGKey(7),
                                             JConfig(**CFG))))
    _assert_tree_equal(params, jax.device_get(state.params), "params")
    _assert_tree_equal(stats, jax.device_get(state.stats), "stats")
    _assert_tree_equal(mu, jax.device_get(state.opt_state.mu), "mu")
    _assert_tree_equal(jax.tree_util.tree_map(np.zeros_like, params),
                       jax.device_get(state.opt_state.nu), "nu")
    assert int(state.opt_state.count) == 3 and int(state.step) == 4
    assert meta == {"epoch": 1, "iteration": 9}


def test_ckpt_shape_mismatch_raises(jax_weights, tmp_path):
    params, stats = jax_weights
    path = str(tmp_path / "m.ckpt")
    C.save_checkpoint(path, params, stats, epoch=0, iteration=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        C.load_checkpoint(path, SGNNConfig(**dict(CFG, nf=16)))


@pytest.mark.parametrize("tap_order", ["c", "flipped"])
def test_reference_pth(jax_weights, tmp_path, tap_order):
    """JAX export_state_dict -> torch.save as the reference saves it ->
    the port's .pth loader equals JAX load_reference_checkpoint."""
    params, stats = jax_weights
    jcfg = JConfig(**CFG)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          JCC.export_state_dict(params, stats, jcfg).items()}
    path = str(tmp_path / "sgnn.pth")
    torch.save({"epoch": 5, "state_dict": sd, "optimizer": {}}, path)
    want_p, want_s, want_meta = JCC.load_reference_checkpoint(
        path, jcfg, tap_order=tap_order)
    got_p, got_s, got_meta = CC.load_reference_checkpoint(
        path, SGNNConfig(**CFG), tap_order=tap_order)
    _assert_tree_equal(jax.device_get(want_p), got_p, "params")
    _assert_tree_equal(jax.device_get(want_s), got_s, "stats")
    assert got_meta == want_meta == {"epoch": 5}
    if tap_order == "c":
        _assert_tree_equal(params, got_p, "params (round trip)")


def test_reference_pth_rejects_extra_keys(jax_weights):
    sd = JCC.export_state_dict(*jax_weights, JConfig(**CFG))
    sd["encoder.unknown.weight"] = np.zeros(3, np.float32)
    with pytest.raises(CC.ConversionError, match="unconsumed"):
        CC.convert_state_dict(sd, SGNNConfig(**CFG))


# ------------------------------------------------------------ scene files


def _write_scene(inp_dir, tgt_dir, name, dims, seed):
    """A reference-format scene: input .sdf (with rows beyond the
    truncation), target .sdf and target .knw, written by the JAX package."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(dims))

    def rows(k):
        flat = np.sort(rng.choice(n, k, replace=False))
        locs = np.stack(np.unravel_index(flat, dims), -1).astype(np.int32)
        return locs, (rng.randn(k) * 2.5).astype(np.float32)

    for d, (locs, vals) in ((inp_dir, rows(n // 6)), (tgt_dir, rows(n // 4))):
        JF.save_scene(os.path.join(d, name + ".sdf"),
                      JF.SceneVolume(locs, vals, dims, 0.02, W2G))
    JF.save_known(os.path.join(tgt_dir, name + ".knw"), dims, 0.02, W2G,
                  rng.randint(0, 4, dims).astype(np.uint8))


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("scenes")
    inp, tgt = str(base / "input"), str(base / "target")
    os.makedirs(inp)
    os.makedirs(tgt)
    # roomA is taller than max_input_height (32) and is cropped
    for name, dims, seed in (("roomA__0__", (40, 37, 50), 1),
                             ("roomB__0__", (20, 28, 30), 2)):
        _write_scene(inp, tgt, name, dims, seed)
    return inp, tgt


def test_formats_read_jax_files(scene_files):
    inp, tgt = scene_files
    for name in ("roomA__0__", "roomB__0__"):
        path = os.path.join(inp, name + ".sdf")
        want, got = JF.load_scene(path), F.load_scene(path)
        for field in ("locs", "sdf", "dims", "voxelsize", "world2grid"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        knw = os.path.join(tgt, name + ".knw")
        np.testing.assert_array_equal(F.load_scene_known(knw),
                                      JF.load_scene_known(knw))


def test_formats_write_same_bytes(scene_files, tmp_path):
    inp, tgt = scene_files
    vol = JF.load_scene(os.path.join(inp, "roomA__0__.sdf"))
    known = JF.load_scene_known(os.path.join(tgt, "roomA__0__.knw"))
    JF.save_scene(str(tmp_path / "j.sdf"), vol)
    F.save_scene(str(tmp_path / "p.sdf"), F.SceneVolume(
        vol.locs, vol.sdf, vol.dims, vol.voxelsize, vol.world2grid))
    JF.save_known(str(tmp_path / "j.knw"), vol.dims, 0.02, W2G, known)
    F.save_known(str(tmp_path / "p.knw"), vol.dims, 0.02, W2G, known)
    for ext in ("sdf", "knw"):
        assert ((tmp_path / f"p.{ext}").read_bytes()
                == (tmp_path / f"j.{ext}").read_bytes())


@pytest.mark.parametrize("dim_round", [0, (16, 32, 48)])
def test_scene_dataset(scene_files, tmp_path, dim_round):
    """The port's SceneDataset sample equals JAX's key by key: file list
    resolution, the max_input_height crop, dim_round (scalar or z y x),
    the -inf / 255 padding and the truncation filter."""
    inp, tgt = scene_files
    lst = tmp_path / "list.txt"
    lst.write_text("roomA\nroomB\nmissing\n")
    files, _ = F.get_train_files(inp, str(lst))
    assert files == JF.get_train_files(inp, str(lst))[0]
    kw = dict(max_input_height=32, target_path=tgt, dim_round=dim_round)
    want = JD.SceneDataset(files, 3.0, 3, **kw)
    got = D.SceneDataset(files, 3.0, 3, **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        w, g = want[i], got[i]
        assert set(g) == set(w)
        for k in w:
            if w[k] is None or isinstance(w[k], str):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    a = got[0]
    assert a["sdf"].shape[0] == 32 and tuple(a["orig_dims"]) == (40, 37, 50)
    assert (np.abs(a["input_sdf"]) < 3.0).all()
    assert np.isneginf(a["sdf"][:, 40:]).all() and (a["known"][:, 40:] == 255
                                                    ).all()


def test_scene_dataset_rejects_bad_round(scene_files):
    with pytest.raises(ValueError, match="multiples"):
        D.SceneDataset([], 3.0, 3, target_path=scene_files[1],
                       dim_round=(16, 24, 32))


# ------------------------------------------------------------ export


def _prediction_arrays():
    dims = (20, 28, 30)
    z, y, x = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    d = np.sqrt((z - 10.0) ** 2 + (y - 14.0) ** 2 + (x - 15.0) ** 2) - 8.0
    m = np.abs(d) < 3.0
    locs = np.stack(np.nonzero(m), -1).astype(np.int32)
    rng = np.random.RandomState(0)
    keep = rng.rand(len(locs)) < 0.8
    pred = (d[m] + 0.3 * rng.randn(m.sum())).astype(np.float32)
    occ = [np.stack(np.nonzero(m[::f, ::f, ::f]), -1) for f in (4, 2, 1)]
    return dict(input_locs=locs[keep], input_sdf=d[m][keep].astype(
        np.float32), dims=dims, target_for_sdf=np.where(m, d, -np.inf),
        target_for_occs=[m[::f, ::f, ::f].astype(np.uint8) for f in (4, 2, 1)],
        pred_surf=(locs, pred), pred_occ_locs=occ, truncation=3.0)


_JAX_NATIVE_EXPORT = """
import sys
import numpy as np
from sgnn_tpu.meshing import export, native
assert native.get_native() is not None, "JAX native core unavailable"
a = dict(np.load(sys.argv[1]))
n = int(a.pop("n_levels"))
for k in ("pred_occ_locs", "target_for_occs"):
    a[k] = [a.pop(f"{k}{h}") for h in range(n)]
a["pred_surf"] = (a.pop("pred_locs"), a.pop("pred_sdf"))
a["dims"] = tuple(int(d) for d in a["dims"])
export.save_predictions(sys.argv[2], "s", **a)
"""


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_save_predictions_same_bytes(tmp_path, monkeypatch, impl):
    """Same arrays, same files, same bytes. The JAX package's native core
    fills per-thread buffers under a dynamic schedule, so its triangle
    order varies from run to run when it has several threads; the port's
    buffers are per z-slice and its order is that of one thread. The JAX
    side of the native case therefore runs in a process with one OpenMP
    thread, the port's with as many as it likes."""
    arrays = _prediction_arrays()
    if impl == "numpy":
        monkeypatch.setenv("SGNN_TPU_NO_NATIVE", "1")
        JE.save_predictions(str(tmp_path / "jax"), "s", **arrays)
    else:
        flat = {k: v for k, v in arrays.items()
                if k not in ("pred_surf", "pred_occ_locs", "target_for_occs")}
        flat["pred_locs"], flat["pred_sdf"] = arrays["pred_surf"]
        flat["n_levels"] = len(arrays["pred_occ_locs"])
        for h in range(flat["n_levels"]):
            flat[f"pred_occ_locs{h}"] = arrays["pred_occ_locs"][h]
            flat[f"target_for_occs{h}"] = arrays["target_for_occs"][h]
        np.savez(tmp_path / "a.npz", **flat)
        res = subprocess.run(
            [sys.executable, "-c", _JAX_NATIVE_EXPORT,
             str(tmp_path / "a.npz"), str(tmp_path / "jax")],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "OMP_NUM_THREADS": "1",
                 "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr
    E.save_predictions(str(tmp_path / "port"), "s", **arrays, mc_impl=impl)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"sinput-mesh.ply", "spred-mesh.ply", "starget-mesh.ply"} <= set(
        names)
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ("-fno-such-flag",))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_native()


# ------------------------------------------------------------ CLI


def _cli(args, **kw):
    return subprocess.run(
        [sys.executable, "-m", "sgnn_tpu_torch.tools.test_scene", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300, **kw)


def _sphere_scene(inp, tgt, name, dims):
    z, y, x = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    c = [d / 2.0 for d in dims]
    d = np.sqrt((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) - 8.0
    m = np.abs(d) < 3.0
    vol = JF.SceneVolume(np.stack(np.nonzero(m), -1).astype(np.int32),
                         d[m].astype(np.float32), dims, 0.02, W2G)
    for base in (inp, tgt):
        JF.save_scene(os.path.join(base, name + ".sdf"), vol)
    JF.save_known(os.path.join(tgt, name + ".knw"), dims, 0.02, W2G,
                  np.ones(dims, np.uint8))


def test_cli_cpu_matches_inferencer(jax_weights, tmp_path):
    """The CLI (--cpu, a JAX-written .ckpt) writes the meshes, and its
    predicted mesh is the one the port's SceneInferencer gives with
    load_jax_params of the same params."""
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.params import load_jax_params

    params, stats = jax_weights
    inp, tgt = str(tmp_path / "in"), str(tmp_path / "tgt")
    os.makedirs(inp)
    os.makedirs(tgt)
    for name, dims in (("sa__0__", (20, 28, 30)), ("sb__0__", (32, 30, 26))):
        _sphere_scene(inp, tgt, name, dims)
    (tmp_path / "list.txt").write_text("sa\nsb\n")
    ckpt = str(tmp_path / "m.ckpt")
    JC.save_checkpoint(ckpt, JS.create_train_state(params, stats), epoch=0,
                       iteration=0)
    out = tmp_path / "out"
    res = _cli(["--input_data_path", inp, "--target_data_path", tgt,
                "--test_file_list", str(tmp_path / "list.txt"),
                "--model_path", ckpt, "--output", str(out),
                "--num_hierarchy_levels", "3", "--encoder_dim", "4",
                "--coarse_feat_dim", "8", "--refine_feat_dim", "8",
                "--max_input_height", "0", "--compute_dtype", "float32",
                "--cpu", "--mesh_workers", "1"])
    assert res.returncode == 0, res.stdout + res.stderr

    model = GenModelFolded(SGNNConfig(**CFG))
    load_jax_params(model, params, stats)
    inf = SceneInferencer(model)
    ds = D.SceneDataset([os.path.join(inp, n) for n in
                         ("sa__0__.sdf", "sb__0__.sdf")], 3.0, 3,
                        max_input_height=0, target_path=tgt)
    for sample in ds:
        r = inf(sample)
        assert len(r["surf_locs"]) > 0, "degenerate fixture: empty surface"
        ref = tmp_path / "ref"
        E.save_predictions(str(ref), r["name"], r["input_locs"],
                           r["input_sdf"], tuple(r["orig_dims"]),
                           pred_surf=(r["surf_locs"], r["surf_sdf"]))
        for kind in ("input-mesh", "pred-mesh"):
            f = f"{r['name']}{kind}.ply"
            assert (out / f).read_bytes() == (ref / f).read_bytes(), f


def test_cli_refuses(tmp_path):
    """No silent switch to the CPU, with the folded or the sparse
    execution."""
    base = ["--input_data_path", str(tmp_path), "--target_data_path",
            str(tmp_path), "--test_file_list", str(tmp_path / "l.txt"),
            "--model_path", str(tmp_path / "m.ckpt")]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for extra in ([], ["--execution", "sparse"]):
        res = _cli([*base, *extra], env=env)
        assert res.returncode != 0 and "no CUDA device" in res.stderr
