"""The whole serving slice: GenModelFolded against the JAX package's
genmodel_apply_folded(want_level_outputs=False) on a tiny model.

The JAX params (genmodel_init, PRNGKey(0)) go through jax.device_get into
load_jax_params; the same surface-like input goes to both forwards. The
port's forward is checked with its default surface head (K5) and with the
summed one (``surf_pack=False``); JAX's with its default. The
JAX forward runs its Pallas kernels in interpret mode, once per module.
Tolerances are the repo's own between its executions
(tests/test_folded_model.py:94-115): coarse_out 1e-4, surf_sdf on the
mask 2e-3, surf_mask bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import folded_flow as JFF
from sgnn_tpu.models import sgnn as JM
from sgnn_tpu.ops.sparse import make_sparse
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.models.folded_flow import GenModelFolded
from sgnn_tpu_torch.ops import dense
from sgnn_tpu_torch.params import load_jax_params

CFG = dict(encoder_dim=4, input_dim=(16, 16, 16), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0), execution="dense_flow")


def _surface_rows(dims, truncation, cap, seed=0, keep=0.85):
    """A partial spherical TSDF shell (random-init gates open on it; pure
    noise can close every gate and make the comparison vacuous)."""
    rng = np.random.RandomState(seed)
    Z, Y, X = dims
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    d = np.sqrt((zz - Z / 2.0) ** 2 + (yy - Y / 2.0) ** 2
                + (xx - X / 2.0) ** 2) - min(Z, Y, X) * 0.35
    z, y, x = np.nonzero(np.abs(d) < truncation)
    m = rng.rand(len(z)) < keep
    z, y, x = z[m], y[m], x[m]
    n = min(len(z), cap)
    locs = np.full((cap, 4), -1, np.int32)
    feats = np.zeros((cap, 1), np.float32)
    locs[:n] = np.stack([z, y, x, np.zeros_like(z)], -1)[:n]
    feats[:n, 0] = d[z, y, x][:n]
    return locs, feats, n


@pytest.fixture(scope="module")
def jax_forward():
    """(JAX's default forward output, its params, the input rows). The
    Pallas kernels run in the TPU interpreter (pltpu.InterpretParams):
    the same outputs as the generic interpreter, bit for bit, in ~60% of
    its time (~52 s against ~83 s on the CPU)."""
    import jax.experimental.pallas as pl
    import jax.experimental.pallas.tpu as pltpu

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    jcfg = JConfig(**CFG)
    # drawn under jax.jit: ~10 s where eager takes ~21 s
    params, stats = jax.jit(lambda k: JM.genmodel_init(k, jcfg))(
        jax.random.PRNGKey(0))
    locs, feats, n = _surface_rows(jcfg.input_dim, jcfg.truncation,
                                   jcfg.input_cap)
    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(
        *a, **{**k, "interpret": pltpu.InterpretParams()})
    try:
        ref = JFF.genmodel_apply_folded(
            params, stats, jcfg,
            make_sparse(jnp.asarray(locs), jnp.asarray(feats), n,
                        jcfg.input_dim, 1),
            num_refine_active=jcfg.num_refine_levels, do_surf=True,
            want_level_outputs=False,
        )
    finally:
        PC.pl.pallas_call = orig
    weights = (jax.device_get(params), jax.device_get(stats))
    return jax.device_get(ref), weights, (locs[:n], feats[:n])


def _port_forward(jax_forward, surf_pack: bool):
    _, weights, (locs, feats) = jax_forward
    model = GenModelFolded(SGNNConfig(**CFG), surf_pack=surf_pack)
    load_jax_params(model, *weights)
    return model(torch.from_numpy(locs), torch.from_numpy(feats),
                 CFG["input_dim"])


@pytest.fixture(scope="module")
def forwards(jax_forward):
    """The default forward (multi-scale surface head) beside JAX's."""
    return jax_forward[0], _port_forward(jax_forward, True)


def test_coarse_out(forwards):
    ref, got = forwards
    np.testing.assert_allclose(got.coarse_out.numpy(),
                               np.asarray(ref.coarse_out), rtol=1e-4,
                               atol=1e-4)


def test_surface_mask_bit_equal(forwards):
    ref, got = forwards
    want = np.asarray(ref.surf_mask)
    assert want.any(), "degenerate fixture: empty surface"
    np.testing.assert_array_equal(got.surf_mask.numpy(), want)
    # this config takes the cpad-8 level-0 branch (cross downconv, repack)
    assert got.level_active[-1] == int(want.sum())


def test_surface_sdf(forwards):
    ref, got = forwards
    m = np.asarray(ref.surf_mask)
    np.testing.assert_allclose(got.surf_sdf.numpy()[m],
                               np.asarray(ref.surf_sdf)[m], rtol=2e-3,
                               atol=2e-3)
    assert np.isfinite(got.surf_sdf.numpy()).all()


@pytest.mark.parametrize("surf_pack", [True, False],
                         ids=["packed", "summed"])
def test_surface_forms(jax_forward, surf_pack):
    """Both surface heads (K5, and the SGNN_NO_SURFPACK counterpart: the
    groups upsampled, then K4 summed mode) against JAX's default forward,
    at the tolerances above."""
    ref = jax_forward[0]
    got = _port_forward(jax_forward, surf_pack)
    m = np.asarray(ref.surf_mask)
    np.testing.assert_allclose(got.coarse_out.numpy(),
                               np.asarray(ref.coarse_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got.surf_mask.numpy(), m)
    np.testing.assert_allclose(got.surf_sdf.numpy()[m],
                               np.asarray(ref.surf_sdf)[m], rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("fn", ["conv3d", "conv_transpose3d"])
def test_trunk_cudnn_flags(monkeypatch, fn):
    """The dense trunk's convolutions run with cuDNN's TF32 off and its
    deterministic algorithms on, scoped to the call: the process-wide
    flags are as before afterwards."""
    seen = {}
    orig = getattr(dense.nnf, fn)

    def spy(*a, **k):
        b = torch.backends.cudnn
        seen.update(enabled=b.enabled, benchmark=b.benchmark,
                    deterministic=b.deterministic, allow_tf32=b.allow_tf32)
        return orig(*a, **k)

    monkeypatch.setattr(dense.nnf, fn, spy)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    try:
        x = torch.randn(1, 4, 4, 4, 3)
        if fn == "conv3d":
            y = dense.conv3d(x, torch.randn(5, 3, 3, 3, 3), padding=1)
        else:
            y = dense.conv_transpose3d(x, torch.randn(3, 5, 4, 4, 4))
        assert seen == dict(enabled=True, benchmark=False,
                            deterministic=True, allow_tf32=False)
        assert y.shape[-1] == 5
        assert torch.backends.cudnn.allow_tf32
        assert not torch.backends.cudnn.deterministic
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before
