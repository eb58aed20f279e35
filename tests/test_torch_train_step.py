"""The port's training data path, step, checkpoints and CLI against the
JAX package, on the CPU.

- ``.sdfs`` chunks: the port's writer gives the JAX writer's bytes, and
  each package reads the other's files to the same arrays.
- ``SceneDataset`` in chunk mode (dense and sparse targets), ``collate``
  and ``collate_sparse``: bit-equal to the JAX package's.
- ``_densify_rows`` and ``_unpack_known_bits`` on a collated batch:
  bit-equal.
- One whole train step (f32, all levels and the surface, sparse targets,
  lr 1e-3) against ``make_train_step`` on a one-device mesh from the same
  weights and batch: the loss and per-level losses to 1e-4 relative;
  every gradient (the JAX side's from its first Adam moment, mu / (1 -
  b1)) to 5e-3 of its largest |g|; the new running stats to 1e-4; Adam's
  moments to the gradients' tolerance; the updated parameters to 1e-6.
- A bf16 step hands K7 taps that hold bf16 values at every call (the
  precondition of its tensor-core mode).
Checkpoints and the CLI: tests/test_torch_train_cli.py.
"""


import jax
import numpy as np
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.data import dataset as JD
from sgnn_tpu.data import formats as JF
from sgnn_tpu.models.sgnn import genmodel_init
from sgnn_tpu.parallel import mesh as PM
from sgnn_tpu.train import state as JS
from sgnn_tpu.train import step as JT
from sgnn_tpu_torch import losses as L
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.data import dataset as D
from sgnn_tpu_torch.data import formats as F
from sgnn_tpu_torch.data.capacity import estimate_row_capacities
from sgnn_tpu_torch.models.folded_train import GenModelFoldedTrain
from sgnn_tpu_torch.ops.kernels import conv_raw as K_raw
from sgnn_tpu_torch.params import init_params, load_jax_params, tree_items
from sgnn_tpu_torch.train import state as ST
from sgnn_tpu_torch.train import step as TS

DIMS = (32, 32, 32)
CFG = dict(input_dim=DIMS, batch_size=2, num_hierarchy_levels=3,
           encoder_dim=4, nf_coarse=8, nf=8, compute_dtype="float32")
TRUNC = 3.0


def _chunk(rng, dims=DIMS):
    """A chunk of a scanned sphere: its TSDF band (|d| < 6 voxels, with a
    +-saturated rim) as the target and hierarchy, 70% of it as the input,
    known 0 on the band and 0-2 elsewhere."""
    Z, Y, X = dims
    z, y, x = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    c = [d / 2 + rng.uniform(-2, 2) for d in dims]
    d = np.sqrt((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) \
        - rng.uniform(7, 10)
    band = np.abs(d) < 6
    tgt = np.full(dims, -np.inf, np.float32)
    tgt[band] = d[band]
    locs = np.stack(np.nonzero(band), -1).astype(np.int32)
    seen = rng.rand(len(locs)) < 0.7
    hier = []
    for f in (8, 4, 2):
        g = np.full((Z // f, Y // f, X // f), -np.inf, np.float32)
        dd = d[::f, ::f, ::f] / f
        m = np.abs(dd) < 6
        g[m] = dd[m]
        hier.append(g)
    known = np.where(band, 0, rng.randint(0, 3, dims)).astype(np.uint8)
    return F.TrainChunk(locs[seen], d[band][seen].astype(np.float32), tgt,
                        dims, 0.02, np.eye(4, dtype=np.float32), known, hier)


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    """Four chunks written by the port, with a file list."""
    d = tmp_path_factory.mktemp("chunks")
    rng = np.random.RandomState(7)
    names = []
    for i in range(4):
        F.save_train_file(str(d / f"c{i}.sdfs"), _chunk(rng))
        names.append(f"c{i}.sdfs")
    (d / "train.txt").write_text("\n".join(names) + "\n")
    return d, [str(d / n) for n in names]


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)
    else:
        assert a == b, path


# ------------------------------------------------------------ data


def test_sdfs_bytes_both_ways(chunks, tmp_path):
    d, files = chunks
    c = F.load_train_file(files[0])
    JF.save_train_file(str(tmp_path / "j.sdfs"), c)
    with open(files[0], "rb") as fh:
        assert (tmp_path / "j.sdfs").read_bytes() == fh.read()
    for path in (files[0], str(tmp_path / "j.sdfs")):
        _assert_equal(vars(JF.load_train_file(path)),
                      vars(F.load_train_file(path)))
        _assert_equal(vars(JF.load_train_file_sparse(path)),
                      vars(F.load_train_file_sparse(path)))
    assert len(c.input_locs) > 100 and np.isfinite(c.target_sdf).any()


@pytest.mark.parametrize("sparse", [False, True])
def test_chunk_dataset_and_collate(chunks, sparse):
    _, files = chunks
    jds = JD.SceneDataset(files, TRUNC, 3, num_overfit=6,
                          sparse_targets=sparse)
    ds = D.SceneDataset(files, TRUNC, 3, num_overfit=6,
                        sparse_targets=sparse)
    assert len(ds) == len(jds) == 4
    samples = [ds[i] for i in range(2)]
    for i, s in enumerate(samples):
        _assert_equal(jds[i], s, f"sample {i}")
    if sparse:
        caps = estimate_row_capacities(files, 3, TRUNC, 2)
        want = JD.collate_sparse([jds[0], jds[1]], 4096, caps[0], caps[1])
        got = D.collate_sparse(samples, 4096, *caps)
        assert got["target_num_valid"] > 0 and got["target_pos"].any()
    else:
        want = JD.collate([jds[0], jds[1]], 4096)
        got = D.collate(samples, 4096)
    _assert_equal(want, got)
    assert 0 < got["input_num_valid"] <= 4096


@pytest.mark.parametrize("transfer", ["float32", "bfloat16"])
def test_densify_and_known_bits(chunks, transfer):
    """On a batch shipped in either transfer type (the JAX package rounds
    its float arrays to bf16 in device_batch the same way)."""
    import jax.numpy as jnp
    import torch

    _, files = chunks
    ds = D.SceneDataset(files, TRUNC, 3, sparse_targets=True)
    caps = estimate_row_capacities(files, 3, TRUNC, 2)
    b = D.collate_sparse([ds[0], ds[1]], 4096, *caps)
    t = TS.to_device(b, "cpu", getattr(torch, transfer))
    assert t["target_vals"].dtype == getattr(torch, transfer)
    got = TS._densify_rows(t["target_locs"], t["target_vals"],
                           t["target_num_valid"], DIMS, 2, -np.inf,
                           pos_bits=t["target_pos"], pos_fill=TRUNC)
    want = JT._densify_rows(b["target_locs"],
                            jnp.asarray(b["target_vals"], transfer),
                            b["target_num_valid"], DIMS, 2, -np.inf,
                            pos_bits=b["target_pos"], pos_fill=TRUNC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).any() and (got.numpy() == TRUNC).any()
    got = TS._unpack_known_bits(t["known_unk"], DIMS, 2)
    want = JT._unpack_known_bits(b["known_unk"], DIMS, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().any() and not got.numpy().all()


def test_sparse_transfer_is_lossless(chunks):
    """The sparse-target batch (band rows and bit planes, densified here)
    gives the dense batch's targets bit for bit, after the loss's clamp."""
    _, files = chunks
    caps = estimate_row_capacities(files, 3, TRUNC, 2)
    cfg = SGNNConfig(**CFG)
    targets = []
    for sparse in (False, True):
        ds = D.SceneDataset(files, TRUNC, 3, sparse_targets=sparse)
        samples = [ds[0], ds[1]]
        b = (D.collate_sparse(samples, 4096, *caps) if sparse
             else D.collate(samples, 4096))
        _, _, _, sdf, known, hier = TS._unpack_batch(
            cfg, TS.to_device(b, "cpu"))
        targets.append(L.compute_targets(sdf, hier, 3, TRUNC, True, known))
    dense, sparse = targets
    np.testing.assert_array_equal(sparse.target_for_sdf.numpy(),
                                  dense.target_for_sdf.numpy())
    for a, b in zip(sparse.target_for_occs + sparse.target_for_hier,
                    dense.target_for_occs + dense.target_for_hier):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (dense.target_for_occs[-1].numpy() == L.UNK_ID).any()


# ------------------------------------------------------- whole step


@pytest.fixture(scope="module")
def step_runs(chunks):
    """One train step of each package from the same weights and batch."""
    _, files = chunks
    jcfg = JConfig(execution="folded", **CFG)
    # host copies: the step donates its state
    params, stats = jax.device_get(jax.jit(
        genmodel_init, static_argnums=1)(jax.random.PRNGKey(3), jcfg))
    ds = D.SceneDataset(files, TRUNC, 3, sparse_targets=True)
    caps = estimate_row_capacities(files, 3, TRUNC, 2)
    batch = D.collate_sparse([ds[0], ds[1]], jcfg.input_cap, *caps)
    lw = np.ones(4, np.float32)

    state = JS.create_train_state(params, stats)
    step = JT.make_train_step(jcfg, PM.make_mesh(1), num_refine_active=2,
                              do_surf=True, sparse_targets=True)
    new_state, jm = step(state, PM.device_batch(batch, 1), lw,
                         np.float32(1e-3))

    model = GenModelFoldedTrain(SGNNConfig(**CFG))
    load_jax_params(model, params, stats)
    opt = ST.make_optimizer(model)
    pm = TS.train_step(model, opt, TS.to_device(batch, "cpu"), lw, 1e-3,
                       num_refine_active=2, do_surf=True)
    return jax.device_get((new_state, jm)), (model, opt, pm)


def test_step_losses(step_runs):
    (_, jm), (_, _, pm) = step_runs
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    per = pm["per_level"].numpy()
    np.testing.assert_allclose(per, np.asarray(jm["per_level"]), rtol=1e-4,
                               atol=1e-6)
    assert (per > 0).all() and np.isfinite(per).all()


def test_step_gradients_and_adam(step_runs):
    """Gradients of the real loss are held to 5e-2 of each parameter's
    largest |g| and to 1e-2 over all parameters (norm of the difference
    over the norm): the loss's gradient is not smooth (hard gates and
    ReLUs), and the step's own gradients move by a few percent of a
    parameter's largest |g| when its inputs move by one f32 rounding
    (chip_smoke.py's train phase measures it; PERF.md), so two f32
    implementations that sum in different orders agree only that far.
    The model test holds every gradient of a smooth loss to 5e-3."""
    (js, _), (model, opt, _) = step_runs
    mu = dict(tree_items(js.opt_state.mu))
    nu = dict(tree_items(js.opt_state.nu))
    new_params = dict(tree_items(js.params))
    pmu, pnu, count = ST.adam_state(opt, model)
    assert count == int(js.opt_state.count) == 1
    pmu, pnu = dict(tree_items(pmu)), dict(tree_items(pnu))
    diff2 = ref2 = 0.0
    for k, p in zip(model.param_keys, model.weights):
        g = mu[k] / 0.1  # the first step's moment is (1 - b1) * grad
        denom = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / denom, g / denom,
                                   atol=5e-2, err_msg=k)
        np.testing.assert_allclose(pmu[k] / denom / 0.1, g / denom,
                                   atol=5e-2, err_msg=k)
        np.testing.assert_allclose(np.sqrt(pnu[k] / 1e-3) / denom,
                                   np.sqrt(nu[k] / 1e-3) / denom, atol=5e-2,
                                   err_msg=k)
        diff2 += float(((p.grad.numpy() - g) ** 2).sum())
        ref2 += float((g ** 2).sum())
        # the first Adam step moves each weight by lr * g / (|g| + 1e-8):
        # the updates agree to 1e-6 where the two gradients have one sign
        # and |g| > 1e-4
        same = ((np.sign(p.grad.numpy()) == np.sign(g))
                & (np.abs(g) > 1e-4) & (np.abs(p.grad.numpy()) > 1e-4))
        np.testing.assert_allclose(p.detach().numpy()[same],
                                   new_params[k][same], atol=1e-6,
                                   err_msg=k)
    assert (diff2 / ref2) ** 0.5 < 1e-2, (diff2 / ref2) ** 0.5


def test_step_stats(step_runs):
    (js, _), (model, _, _) = step_runs
    want = dict(tree_items(js.stats))
    for k, v in tree_items(model.stat_tree()):
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_bf16_step_gives_k7_bf16_weights(chunks, monkeypatch):
    """Every K7 call of a bf16 train step (the forward of each training
    conv site and every input gradient) gets taps that hold bf16 values:
    the precondition of K7's tensor-core mode, which converts them to
    bf16 (csrc/conv_raw.cu)."""
    _, files = chunks
    cfg = SGNNConfig(**{**CFG, "compute_dtype": "bfloat16"})
    model = GenModelFoldedTrain(cfg)
    load_jax_params(model, *init_params(cfg, seed=1))
    ds = D.SceneDataset(files, TRUNC, 3, sparse_targets=True)
    caps = estimate_row_capacities(files, 3, TRUNC, 2)
    batch = D.collate_sparse([ds[0], ds[1]], cfg.input_cap, *caps)
    seen, orig = [], K_raw.conv_raw

    def record(x, w, cin, cpad, **kw):
        seen.append((x.dtype, w.clone()))
        return orig(x, w, cin, cpad, **kw)
    monkeypatch.setattr(K_raw, "conv_raw", record)
    m = TS.train_step(model, ST.make_optimizer(model),
                      TS.to_device(batch, "cpu"), np.ones(4, np.float32),
                      1e-3, num_refine_active=2, do_surf=True)
    assert np.isfinite(float(m["loss"]))
    assert len(seen) > 20, len(seen)  # forwards and input gradients
    for dt, w in seen:
        assert dt == torch.bfloat16
        assert w.dtype == torch.float32
        assert torch.equal(w, w.bfloat16().float())
        assert w.abs().max() > 0
