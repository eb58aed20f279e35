"""The port's multi-scale surface head (K5, plain version on the CPU)
against the JAX package's ``surf_head_packed`` (Pallas in interpret mode)
and against the port's own summed form.

Inputs are made from a seed with numpy; the coarse groups are random
everywhere (not masked), as the surface U-Net's deeper levels may hold
values where the fine mask is off. Tolerance: mask bit-equal, sdf
atol = rtol = 1e-5 (the two sum the head product in different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sgnn_tpu.ops import folded as JFO
from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.ops import kernels as K
from sgnn_tpu_torch.ops.kernels import surf_head as K_surf

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
SCALES = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas():
    import jax.experimental.pallas as pl

    import sgnn_tpu.ops.pallas.conv3d_folded as PC

    orig = pl.pallas_call
    PC.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    yield
    PC.pl.pallas_call = orig


def _case(dims, nf, seed, dtype=F32):
    """(groups [(FGrid, scale)], fine mask FGrid, bn (params, stats), W, b)
    at cpad 16."""
    rng = np.random.RandomState(seed)
    groups = []
    for s in SCALES:
        d = rng.randn(1, *(n // s for n in dims), nf).astype(np.float32)
        fg = FO.fold(torch.from_numpy(d), 16)
        groups.append((fg.with_data(fg.data.to(dtype)), s))
    mask = rng.rand(1, *dims) < 0.3
    fm = FO.fold_mask(torch.from_numpy(mask), 16, dtype)
    C = nf * len(SCALES)
    bn = ({"scale": (rng.rand(C) + 0.5).astype(np.float32),
           "bias": rng.randn(C).astype(np.float32)},
          {"mean": rng.randn(C).astype(np.float32),
           "var": (rng.rand(C) + 0.2).astype(np.float32)})
    W = (0.3 * rng.randn(C, 1)).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    return groups, fm, bn, W, b


def _prep(groups, bn, W, b, dtype=F32):
    widths = [g.real_c for g, _ in groups]
    return (FO.prep_head_weights(W, widths, dtype), FO.prep_bias(b),
            FO.prep_affines(*bn, widths))


def _j(fg):
    return JFO.FGrid(jnp.asarray(fg.data.float().numpy()), fg.dims,
                     fg.real_c, fg.cpad)


@pytest.mark.parametrize("dims", [
    (32, 32, 64),  # tests/test_folded.py:710's case
    (16, 16, 96),  # xq 16: the scale-4 grid carries 4 tail-pad x blocks
])
def test_surf_head_packed_vs_jax(dims):
    groups, fm, bn, W, b = _case(dims, 4, seed=sum(dims))
    if dims[2] == 96:
        g4 = groups[2][0]
        assert g4.data.shape[3] > -(-fm.data.shape[3] // 4)
        # the kernel must not rely on the tail-pad blocks being zero
        junk = g4.data.clone()
        junk[:, :, :, -4:] = 7.0
        groups[2] = (g4.with_data(junk), 4)
    want_sdf, want_mask = JFO.surf_head_packed(
        [(_j(g), s) for g, s in groups], _j(fm), bn[0], bn[1],
        jnp.asarray(W), jnp.asarray(b))
    K.reset_launch_counts()
    sdf, mask = FO.surf_head_packed(groups, fm, *_prep(groups, bn, W, b))
    assert K.launch_counts()["surf_head"] == 0  # CPU: the plain version
    assert sdf.dtype == F32 and sdf.shape == (1, *dims)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(want_sdf), **TOL)
    m = mask.numpy()
    assert 0 < m.sum() < m.size
    # a voxel outside the mask holds exactly the bias
    assert (sdf.numpy()[~m] == b[0]).all()


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
def test_surf_head_packed_vs_summed(dtype):
    """Packed form == upsample2_folded per scale step -> surf_head_fused
    (K4 summed mode) -> unfold, the port's SGNN_NO_SURFPACK form. The two
    round at the same points; only the f32 order of the head product can
    differ."""
    dims = (16, 16, 64)
    groups, fm, bn, W, b = _case(dims, 8, seed=3, dtype=dtype)
    w, bias, aff = _prep(groups, bn, W, b, dtype)
    sdf, mask = FO.surf_head_packed(groups, fm, w, bias, aff)
    mats = []
    for g, s in groups:
        while s > 1:
            g, s = FO.upsample2_folded(g), s // 2
        mats.append(g)
    ref = FO.unfold(FO.surf_head_fused(mats, fm, w, bias, aff))[..., 0]
    np.testing.assert_array_equal(mask.numpy(),
                                  (FO.unfold(fm)[..., 0] > 0.5).numpy())
    np.testing.assert_allclose(sdf.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_surf_head_rejects_bad_groups():
    groups, fm, bn, W, b = _case((16, 16, 64), 4, seed=5)
    w, bias, aff = _prep(groups, bn, W, b)
    with pytest.raises(ValueError, match="scale 1"):
        FO.surf_head_packed(groups[1:], fm, w[1:], bias, aff[1:])
    wrong = [groups[0], (groups[1][0], 4), groups[2]]
    with pytest.raises(ValueError, match="does not fit"):
        FO.surf_head_packed(wrong, fm, w, bias, aff)
    with pytest.raises(ValueError, match="dims"):
        K_surf.surf_head([g.data for g, _ in groups], [1, 2, 2], fm.data,
                         w, bias, aff, [4] * 3, 16, (16, 16, 64))
