"""The folded forward's level-output form and partial forwards against the
JAX package, on the CPU, in f32.

The reference is JAX's ``genmodel_apply_dense(training=False)`` under
``jax.jit`` (the JAX package holds its folded forward to it,
tests/test_folded_model.py:94-115; the folded forward in the TPU
interpreter costs ~52 s, tests/test_torch_model.py), at
tests/test_torch_model.py's configuration, with weights from
``init_params`` (a seed whose gates leave every level and a surface on
the input). Tolerances are the repo's own between its executions: coarse
output 1e-4, per-level raw heads and the surface sdf 2e-3, masks
bit-equal; the raw heads are compared on the level's unfiltered sites
(the raw grid's halo is unspecified; the unfolded grids hold interiors
only). Also: the port's level-output form keeps the only-surface form's
surface bit for bit (also in int8), and the folded ``SceneInferencer``
with ``want_levels`` returns the JAX ``SceneInferencer``'s levels. The
serving ablations (the JAX package's SGNN_NO_UPCONV, SGNN_NO_HEADK,
SGNN_NO_MASKFUSE, and the first two together) are held to the same
reference at the same tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.infer import SceneInferencer as JInferencer
from sgnn_tpu.models import dense_flow as JDF
from sgnn_tpu.ops.sparse import make_sparse
from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
from sgnn_tpu_torch.models.dense_flow import GenModelDense
from sgnn_tpu_torch.models.folded_flow import (GenModelFolded,
                                                HeadComposed,
                                                ablations_from_env)
from sgnn_tpu_torch.params import init_params, load_jax_params

CFG = dict(encoder_dim=4, input_dim=(16, 16, 16), nf_coarse=8, nf=8,
           num_hierarchy_levels=3, batch_size=1, compute_dtype="float32",
           occupancy_fractions=(1.0, 1.0, 1.0), execution="dense_flow")
SEED = 4  # active voxels per level [32, 100, 758] on the scene below
ORIG = (16, 13, 14)
L_REF = CFG["num_hierarchy_levels"] - 1


@pytest.fixture(scope="module", autouse=True)
def one_thread_among_workers():
    """One intra-op thread while several pytest-xdist workers share the
    host's cores (the test tier runs six on eight): PyTorch's thread pools
    thrash there over this module's small tensors, which ran ~100x slower
    (~40 s with one thread); alone, the default threads."""
    n = torch.get_num_threads()
    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """(weights, the scene sample, its rows as the port takes them). The
    sample's orig_dims crop the surface, not the levels."""
    weights = init_params(SGNNConfig(**CFG), SEED)
    scene = synthetic_scene(CFG["input_dim"], seed=1, orig_dims=ORIG)
    locs = torch.zeros(len(scene["input_locs"]), 4, dtype=torch.int64)
    locs[:, :3] = torch.from_numpy(scene["input_locs"].astype(np.int64))
    feats = torch.from_numpy(scene["input_sdf"])[:, None]
    return weights, scene, (locs, feats)


@pytest.fixture(scope="module")
def jax_scene(case):
    """The JAX SceneInferencer's result on the sample, with its defaults
    (every level, extracted on the device): on the CPU it runs
    genmodel_apply_dense(training=False) under jax.jit."""
    weights, scene, _ = case
    return JInferencer(JConfig(**CFG), *weights)(scene)


def _jax(case, num_refine_active, do_surf):
    (params, stats), _, (locs, feats) = case
    cfg = JConfig(**CFG)
    n = len(locs)
    lp = np.full((cfg.input_cap, 4), -1, np.int32)
    fp = np.zeros((cfg.input_cap, 1), np.float32)
    lp[:n], fp[:n] = locs.numpy(), feats.numpy()

    @jax.jit
    def fwd(p, s, lo, fe):
        return JDF.genmodel_apply_dense(
            p, s, cfg, make_sparse(lo, fe, n, cfg.input_dim, 1),
            num_refine_active=num_refine_active, do_surf=do_surf,
            training=False)[0]
    return jax.device_get(fwd(params, stats, jnp.asarray(lp),
                              jnp.asarray(fp)))


def _port(case, q8=False, **kw):
    weights, _, (locs, feats) = case
    model = GenModelFolded(SGNNConfig(**CFG, quantize_int8=q8))
    load_jax_params(model, *weights)
    return model(locs, feats, CFG["input_dim"], **kw)


@pytest.fixture(scope="module")
def full(case):
    return _port(case, want_level_outputs=True)


def test_level_outputs_match_jax(full, jax_scene):
    """The level-output forward against JAX's: each level's unfiltered
    sites (in C order) equal, its raw heads there within 2e-3, the coarse
    output within 1e-4, the surface (cropped as the inferencer crops it)
    equal with its sdf within 2e-3."""
    _assert_matches_jax(full, jax_scene)


def _assert_matches_jax(got, ref):
    np.testing.assert_allclose(got.coarse_out[0].numpy(),
                               ref["levels"][0]["dense_out"], rtol=1e-4,
                               atol=1e-4)
    assert len(got.refine_outs) == len(ref["levels"]) - 1 == L_REF
    for h, lv in enumerate(ref["levels"][1:]):
        assert len(lv["locs"]) > 0, f"degenerate case: level {h} no sites"
        m = got.refine_masks_unfilt[h][0]
        np.testing.assert_array_equal(torch.nonzero(m).numpy(), lv["locs"])
        np.testing.assert_allclose(got.refine_outs[h][0][m].numpy(),
                                   lv["out"], rtol=2e-3, atol=2e-3)
    sm = got.surf_mask[0, :ORIG[0], :ORIG[1], :ORIG[2]]
    assert len(ref["surf_locs"]) > 0, "degenerate case: empty surface"
    np.testing.assert_array_equal(torch.nonzero(sm).numpy(),
                                  ref["surf_locs"])
    np.testing.assert_allclose(
        got.surf_sdf[0, :ORIG[0], :ORIG[1], :ORIG[2]][sm].numpy(),
        ref["surf_sdf"], rtol=2e-3, atol=2e-3)
    # each level's unfiltered sites are the children of the last kept
    assert [int(x.sum()) for x in got.refine_masks_unfilt] == [
        8 * int(a) for a in got.level_active[:-1]]


@pytest.mark.parametrize("q8", [False, True], ids=["exact", "int8"])
def test_level_form_keeps_surface(case, full, q8):
    """Materialising the fine masks and the raw heads leaves the surface
    and the coarse output as the only-surface form gives them, bit for
    bit, in the exact and the int8 forward."""
    lv = full if not q8 else _port(case, q8, want_level_outputs=True)
    surf = _port(case, q8)
    assert surf.refine_outs == surf.refine_masks_unfilt == []
    assert len(lv.refine_outs) == L_REF
    assert torch.equal(lv.surf_mask, surf.surf_mask) and surf.surf_mask.any()
    assert torch.equal(lv.surf_sdf, surf.surf_sdf)
    assert torch.equal(lv.coarse_out, surf.coarse_out)
    assert [int(a) for a in lv.level_active] == [
        int(a) for a in surf.level_active]


def test_partial_forward_matches_jax(case):
    """One refinement level and no surface against JAX's partial forward
    (genmodel_apply_dense under jax.jit): the coarse output, the level's
    sites and raw heads, and zero surface grids."""
    ref = _jax(case, 1, False)
    got = _port(case, num_refine_active=1, do_surf=False,
                want_level_outputs=True)
    np.testing.assert_allclose(got.coarse_out.numpy(),
                               np.asarray(ref.coarse_out), rtol=1e-4,
                               atol=1e-4)
    assert len(got.refine_outs) == len(ref.refine_outs) == 1
    m = np.asarray(ref.refine_masks_unfilt[0])
    assert m.any(), "degenerate case: no sites"
    np.testing.assert_array_equal(got.refine_masks_unfilt[0].numpy(), m)
    np.testing.assert_allclose(got.refine_outs[0].numpy()[m],
                               np.asarray(ref.refine_outs[0])[m], rtol=2e-3,
                               atol=2e-3)
    assert got.surf_sdf.shape == (1, *CFG["input_dim"])
    assert not got.surf_mask.any() and not got.surf_sdf.any()
    assert not np.asarray(ref.surf_mask).any()


@pytest.mark.parametrize("nra,do_surf", [(0, False), (1, False),
                                         (L_REF, False), (1, True)])
def test_partial_forwards_are_prefixes(case, full, nra, do_surf):
    """Every partial form stops after ``nra`` levels: its outputs are the
    whole forward's first levels, bit for bit, and its surface zeros (the
    surface needs every level)."""
    got = _port(case, num_refine_active=nra, do_surf=do_surf,
                want_level_outputs=True)
    whole = full
    assert torch.equal(got.coarse_out, whole.coarse_out)
    assert [int(a) for a in got.level_active] == [
        int(a) for a in whole.level_active[:nra + 1]]
    for a, b in zip(got.refine_outs, whole.refine_outs[:nra], strict=True):
        assert torch.equal(a, b)
    assert not got.surf_mask.any() and not got.surf_sdf.any()


@pytest.mark.parametrize("off", [("upconv",), ("head_kernel",),
                                 ("mask_fuse",), ("upconv", "head_kernel")],
                         ids="+".join)
def test_ablations_match_jax(case, jax_scene, off):
    """Each serving ablation (GenModelFolded's options for SGNN_NO_UPCONV,
    SGNN_NO_HEADK, SGNN_NO_MASKFUSE; the first two together) in its
    level-output form against JAX's reference at the tolerances above,
    and its only-surface form with the same surface, bit for bit."""
    weights, _, (locs, feats) = case
    model = GenModelFolded(SGNNConfig(**CFG), **{o: False for o in off})
    load_jax_params(model, *weights)
    got = model(locs, feats, CFG["input_dim"], want_level_outputs=True)
    _assert_matches_jax(got, jax_scene)
    surf = model(locs, feats, CFG["input_dim"])
    assert torch.equal(got.surf_mask, surf.surf_mask)
    assert torch.equal(got.surf_sdf, surf.surf_sdf)


def test_ablations_from_env():
    """One reader for the JAX package's four variables: set non-empty, an
    option is off."""
    assert ablations_from_env({}) == dict(
        surf_pack=True, upconv=True, head_kernel=True, mask_fuse=True)
    assert ablations_from_env({"SGNN_NO_HEADK": "1", "SGNN_NO_UPCONV": "",
                               "SGNN_NO_MASKFUSE": "yes"}) == dict(
        surf_pack=True, upconv=True, head_kernel=False, mask_fuse=False)


def test_forward_refuses(case):
    with pytest.raises(ValueError, match="num_refine_active"):
        _port(case, num_refine_active=L_REF + 1)
    with pytest.raises(ValueError, match="composed head"):
        HeadComposed(8)(None, None, 2, False)


def test_inferencer_levels_match_jax(case, jax_scene):
    """The folded SceneInferencer with want_levels (its default) against
    the JAX SceneInferencer with its defaults: the same levels, equal locs
    (uncropped), raw heads within 2e-3, the cropped surface; the
    only-surface form returns the coarse entry alone and the same
    surface."""
    weights, scene, _ = case
    model = GenModelFolded(SGNNConfig(**CFG))
    load_jax_params(model, *weights)
    got = SceneInferencer(model)(scene)
    surf = SceneInferencer(model, want_levels=False)(scene)
    ref = jax_scene
    assert len(got["levels"]) == len(ref["levels"]) == L_REF + 1
    np.testing.assert_allclose(got["levels"][0]["dense_out"],
                               ref["levels"][0]["dense_out"], rtol=0,
                               atol=1e-4)
    for a, b in zip(got["levels"][1:], ref["levels"][1:]):
        np.testing.assert_array_equal(a["locs"], b["locs"])
        np.testing.assert_allclose(a["out"], b["out"], rtol=0, atol=2e-3)
    # the levels are not cropped to orig_dims
    assert (got["levels"][-1]["locs"][:, 1:] >= np.asarray(ORIG[1:])).any()
    np.testing.assert_array_equal(got["surf_locs"], ref["surf_locs"])
    np.testing.assert_allclose(got["surf_sdf"], ref["surf_sdf"], rtol=0,
                               atol=2e-3)
    assert len(surf["levels"]) == 1
    for key in ("surf_locs", "surf_sdf", "level_active"):
        np.testing.assert_array_equal(got[key], surf[key])


def test_secondary_levels_whatever_the_flag(case):
    """The secondary executions return every level with want_levels=False
    too, as the JAX inferencer's dense-flow and sparse paths do."""
    weights, scene, _ = case
    model = GenModelDense(SGNNConfig(**CFG))
    load_jax_params(model, *weights)
    a = SceneInferencer(model, want_levels=False)(scene)
    b = SceneInferencer(model)(scene)
    assert len(a["levels"]) == len(b["levels"]) == L_REF + 1
    for x, y in zip(a["levels"][1:], b["levels"][1:]):
        np.testing.assert_array_equal(x["locs"], y["locs"])
