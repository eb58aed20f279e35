"""The int8 serving forward z-sharded over 2 ranks, against the JAX
package's int8 forward under ``shard_map`` on 2 CPU devices.

Under ``sp_axis`` every JAX int8 body runs on its device's halo'd slab:
its tile picker sees the slab's dims, and each tile's amax reads what the
slab holds in the tile's window (the z ring once exchanged). The port's
sites do the same on each rank's slab (``GenModelFolded(space=...)``),
so the two sharded answers agree, and neither is the unsharded answer:
the pickers prefer the largest tz that divides the grid's Z (K1 tries 16
first), and at this size the third level's grid has Z 16 on the scene
but 8 on a slab, so the activation scales of every site there follow
other tiles.

At FOLD_CFG's size (64x16x32, L = 3, f32 compute) with the JAX weights of
``PRNGKey(0)`` carried across and the rows of the port's
``synthetic_scene(seed=1)`` (10,408 surface voxels; other weights can
close every gate and leave no surface), the port's 2-rank forward (its
plain versions on gloo) is held to JAX's sharded one: each level's
unfiltered mask bit-equal, the raw heads on those sites and the surface
sdf on the voxels both hold within SDF_TOL, the surface IoU >= 0.99.
JAX's unsharded int8 answer of the same scene breaks that bound (its
sdf moves by up to ~6e-2 and its surface by 2 voxels), which the test
asserts, so it can tell per-slab scales from whole-scene ones.

The JAX side runs under ``jax.jit`` in the TPU interpreter
(``pltpu.InterpretParams``): ~50 s of tracing and compiling and ~45 s of
interpreted kernels for each of the two forwards, ~3.5 min on one worker
of an 8-core host (two interpreted forwards cannot run at once: the
interpreter's shared memory is global); the port's ranks run meanwhile.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import sgnn_tpu.ops.pallas.conv3d_folded as PC
from sgnn_tpu.config import SGNNConfig as JConfig
from sgnn_tpu.models import folded_flow as JFF
from sgnn_tpu.models import sgnn as JM
from sgnn_tpu.ops.sparse import make_sparse
from sgnn_tpu_torch.infer import synthetic_scene
from sgnn_tpu_torch.ops import quant as Q
from sgnn_tpu_torch.parallel import mesh as PM
from sgnn_tpu_torch.parallel import programs as PG

# tests/test_torch_parallel.py's folded configuration, int8
FOLD_CFG = dict(encoder_dim=4, input_dim=(64, 16, 32), nf_coarse=8, nf=8,
                num_hierarchy_levels=3, batch_size=1,
                occupancy_fractions=(1.0, 1.0, 1.0), compute_dtype="float32",
                quantize_int8=True)
N_RANKS = 2
# sdf and raw heads, sharded port against sharded JAX: the port's int8
# sites match JAX's to one activation step (test_torch_int8.py), and a
# value on a rounding boundary can move a level's heads by ~2e-3 (the
# unsharded pair at this size); per-slab against whole-scene scales move
# them by ~6e-2
SDF_TOL = 1e-2
MIN_IOU = 0.99

_POOL = concurrent.futures.ThreadPoolExecutor(1)


def _rows():
    sc = synthetic_scene(FOLD_CFG["input_dim"], seed=1)
    n = len(sc["input_locs"])
    locs = np.concatenate([sc["input_locs"], np.zeros((n, 1), np.int32)], 1)
    return locs, sc["input_sdf"][:, None].copy()


@pytest.fixture(scope="module")
def weights():
    """JAX's PRNGKey(0) weights (the JAX int8 tests' own), drawn under
    jax.jit, as numpy trees."""
    jcfg = JConfig(**FOLD_CFG)
    return jax.device_get(jax.jit(lambda k: JM.genmodel_init(k, jcfg))(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port(weights):
    """The port's 2-rank int8 forward (level-output form), started at
    once in a thread so that it overlaps the JAX compiles."""
    locs, feats = _rows()
    return _POOL.submit(PM.launch, PG.serve_folded, N_RANKS, "gloo", (
        FOLD_CFG, weights, locs, feats, FOLD_CFG["input_dim"], "cpu", 0,
        None, True))


@pytest.fixture(scope="module")
def jax_int8(weights, port):
    """JAX's int8 forward of the rows, unsharded and under shard_map over
    2 devices: (surf_sdf, surf_mask, coarse_out, per level masks, per
    level raw heads) each, the sharded one's slabs joined along z."""
    import jax.experimental.pallas as pl
    import jax.experimental.pallas.tpu as pltpu

    jcfg = JConfig(**FOLD_CFG)
    params, stats = weights
    locs, feats = _rows()
    n, dims = len(locs), jcfg.input_dim
    L = jcfg.num_refine_levels

    def fwd(sp_axis=None):
        def f(params, stats, locs, feats):
            out = JFF.genmodel_apply_folded(
                params, stats, jcfg, make_sparse(locs, feats, n, dims, 1),
                num_refine_active=L, do_surf=True, sp_axis=sp_axis,
                want_level_outputs=True)
            return (out.surf_sdf, out.surf_mask, out.coarse_out,
                    out.refine_masks_unfilt, out.refine_outs)
        return f

    zs = P(None, "space")
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("space",))
    sharded = shard_map(fwd("space"), mesh=mesh, in_specs=(P(),) * 4,
                        out_specs=(zs, zs, zs, [zs] * L, [zs] * L),
                        check_vma=False)
    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(
        *a, **{**k, "interpret": pltpu.InterpretParams()})
    args = (params, stats, jnp.asarray(locs), jnp.asarray(feats))
    try:
        return {name: jax.device_get(jax.jit(f)(*args))
                for name, f in (("unsharded", fwd()), ("sharded", sharded))}
    finally:
        PC.pl.pallas_call = orig


def _port_joined(port) -> tuple:
    ranks = port.result()
    assert [r["rank"] for r in ranks] == list(range(N_RANKS))

    def cat(key):
        return np.concatenate([r[key] for r in ranks], 1)

    L = len(ranks[0]["refine_outs"])
    return (cat("surf_sdf"), cat("surf_mask"), cat("coarse_out"),
            [np.concatenate([r["refine_masks_unfilt"][h] for r in ranks], 1)
             for h in range(L)],
            [np.concatenate([r["refine_outs"][h] for r in ranks], 1)
             for h in range(L)])


def _agreement(a, b) -> dict:
    """How far answer a is from answer b: the level masks equal, the
    largest |raw head diff| on each level's common sites, the surface IoU
    and the largest |sdf diff| on the common surface voxels."""
    sdf_a, m_a, _, lm_a, ro_a = a
    sdf_b, m_b, _, lm_b, ro_b = b
    m_a, m_b = np.asarray(m_a, bool), np.asarray(m_b, bool)
    both = m_a & m_b
    raw = []
    for ma, mb, oa, ob in zip(lm_a, lm_b, ro_a, ro_b):
        common = np.asarray(ma, bool) & np.asarray(mb, bool)
        raw.append(float(np.abs(oa[common] - ob[common]).max()))
    return {"masks_equal": all(np.array_equal(x, y)
                               for x, y in zip(lm_a, lm_b)),
            "level_sites": [int(np.sum(x)) for x in lm_a],
            "raw_diff": raw,
            "surface": (int(m_a.sum()), int(m_b.sum())),
            "iou": float(both.sum() / max((m_a | m_b).sum(), 1)),
            "sdf_diff": float(np.abs(sdf_a[both] - sdf_b[both]).max())}


def _within(agr: dict) -> bool:
    return (agr["masks_equal"] and agr["iou"] >= MIN_IOU
            and agr["sdf_diff"] <= SDF_TOL
            and max(agr["raw_diff"]) <= SDF_TOL)


def test_sharded_int8_matches_jax(port, jax_int8):
    got = _port_joined(port)
    agr = _agreement(got, jax_int8["sharded"])
    print(f"port vs JAX, int8 sharded over {N_RANKS}: {agr}")
    assert min(agr["level_sites"]) > 0 and min(agr["surface"]) > 0, agr
    assert agr["masks_equal"], agr
    assert agr["iou"] >= MIN_IOU, agr
    assert agr["sdf_diff"] <= SDF_TOL, agr
    assert max(agr["raw_diff"]) <= SDF_TOL, agr
    np.testing.assert_allclose(got[2], jax_int8["sharded"][2], rtol=1e-5,
                               atol=1e-5)  # the trunk's output slabs


def test_unsharded_answer_breaks_the_bound(jax_int8):
    """The power of the bound above: JAX's unsharded int8 answer (whole-
    scene tiles and scales) fails it against the sharded one."""
    agr = _agreement(jax_int8["unsharded"], jax_int8["sharded"])
    print(f"JAX int8 unsharded vs sharded: {agr}")
    assert min(agr["surface"]) > 0
    assert not _within(agr), agr
    assert agr["sdf_diff"] > SDF_TOL, agr


def test_pickers_follow_the_slab():
    """Why the answers differ: K1's picker on the third level's grid
    (Z 16 on the scene, 8 on a slab; Y 4, one x block) picks another tz,
    so its tiles, and the amax windows with them, follow the slab."""
    grid = {Z: np.zeros((1, Z + 2, 6, 1, 128), np.float32) for Z in (16, 8)}
    tiles = {Z: Q.conv_tiles(torch.from_numpy(g), 2, False)
             for Z, g in grid.items()}
    assert (tiles[16].tz, tiles[16].nz) == (16, 1)
    assert (tiles[8].tz, tiles[8].nz) == (8, 1)
    # the slabs' two tiles are not the scene's one: the scene tile's
    # window spans both slabs' rows
    assert tiles[16].lz == 18 and tiles[8].lz == 10
