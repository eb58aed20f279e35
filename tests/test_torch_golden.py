"""The port's ops held to the golden fixtures of plain torch.

tests/golden/golden_torch.npz holds activations of plain-torch runs of the
reference layer graph's dense pieces (tools/make_golden_fixtures.py):
Conv3d and ConvTranspose3d k4 s2 p1, the 1^3 head conv, BatchNorm3d in
training and eval, the rows' BN at scn's eps 1e-4, the linear head, the
MaxPool3d target pyramid with its -1 sentinel, the SDF clamp, the log
transform, the weighted BCE with logits and the L1 on log-transformed
values. The same 13 cases and tolerances as tests/test_golden_torch.py
holds the JAX package's ops to, here on ``sgnn_tpu_torch``'s
``ops/dense.py``, ``ops/bn.py`` and ``losses.py``; no jax is imported.
"""

import os

import numpy as np
import pytest
import torch

from sgnn_tpu_torch import losses as L
from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import dense as D

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_torch.npz")


@pytest.fixture(scope="module")
def g():
    assert os.path.exists(GOLDEN), (
        "golden fixtures missing; run tools/make_golden_fixtures.py")
    return np.load(GOLDEN)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_cl(x):  # torch NCDHW -> channels-last NDHWC
    return _t(np.transpose(x, (0, 2, 3, 4, 1)))


def _from_cl(y: torch.Tensor):
    return np.transpose(y.numpy(), (0, 4, 1, 2, 3))


def _bn(g, prefix: str, stats: str) -> tuple:
    return ({"scale": _t(g[f"{prefix}_scale"]),
             "bias": _t(g[f"{prefix}_bias"])},
            {"mean": _t(g[f"{prefix}_rm{stats}"]),
             "var": _t(g[f"{prefix}_rv{stats}"])})


def test_conv3d_k4s2p1(g):
    y = D.conv3d(_to_cl(g["conv_k4s2p1_x"]), _t(g["conv_k4s2p1_w"]),
                 stride=2, padding=1)
    np.testing.assert_allclose(_from_cl(y), g["conv_k4s2p1_y"], atol=2e-5,
                               rtol=1e-5)


def test_conv_transpose3d_k4s2p1(g):
    y = D.conv_transpose3d(_to_cl(g["convt_k4s2p1_x"]),
                           _t(g["convt_k4s2p1_w"]), stride=2, padding=1)
    np.testing.assert_allclose(_from_cl(y), g["convt_k4s2p1_y"], atol=2e-5,
                               rtol=1e-5)


def test_conv3d_k1_head(g):
    y = D.conv3d(_to_cl(g["conv_k1_x"]), _t(g["conv_k1_w"]))
    np.testing.assert_allclose(_from_cl(y), g["conv_k1_y"], atol=2e-5,
                               rtol=1e-5)


def test_bn3d_train_matches_torch(g):
    params, stats = _bn(g, "bn3d", "0")
    y, ns = BN.batch_norm_dense(params, stats, _to_cl(g["bn3d_x"]),
                                training=True, relu=False)
    np.testing.assert_allclose(_from_cl(y), g["bn3d_y_train"], atol=1e-5,
                               rtol=1e-5)
    # running stats follow torch's momentum-0.1 unbiased-var update
    np.testing.assert_allclose(ns["mean"].numpy(), g["bn3d_rm1"], atol=1e-6)
    np.testing.assert_allclose(ns["var"].numpy(), g["bn3d_rv1"], atol=1e-5)


def test_bn3d_eval_matches_torch(g):
    # the torch oracle ran eval after its train step: the post-update stats
    params, stats = _bn(g, "bn3d", "1")
    y, _ = BN.batch_norm_dense(params, stats, _to_cl(g["bn3d_x"]),
                               training=False, relu=False)
    np.testing.assert_allclose(_from_cl(y), g["bn3d_y_eval"], atol=1e-5,
                               rtol=1e-5)


def test_row_bn_scn_eps_train(g):
    params, stats = _bn(g, "bnrow", "0")
    y, ns = BN.batch_norm(params, stats, _t(g["bnrow_x"]), training=True,
                          eps=BN.SPARSE_BN_EPS)
    assert BN.SPARSE_BN_EPS == 1e-4  # scn's default
    np.testing.assert_allclose(y.numpy(), g["bnrow_y_train"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ns["mean"].numpy(), g["bnrow_rm1"], atol=1e-6)
    np.testing.assert_allclose(ns["var"].numpy(), g["bnrow_rv1"], atol=1e-5)


def test_row_bn_scn_eps_eval(g):
    params, stats = _bn(g, "bnrow", "1")
    y, _ = BN.batch_norm(params, stats, _t(g["bnrow_x"]), training=False,
                         eps=BN.SPARSE_BN_EPS)
    np.testing.assert_allclose(y.numpy(), g["bnrow_y_eval"], atol=1e-5,
                               rtol=1e-5)


def test_linear_head(g):
    y = g["linear_x"] @ g["linear_w"].T + g["linear_b"]
    np.testing.assert_allclose(y, g["linear_y"], atol=1e-6)
    # and through torch's linear, as the port's heads compute it
    yt = torch.nn.functional.linear(_t(g["linear_x"]), _t(g["linear_w"]),
                                    _t(g["linear_b"]))
    np.testing.assert_allclose(yt.numpy(), g["linear_y"], atol=1e-5)


def test_maxpool_pyramid_with_unk_sentinel(g):
    y = D.max_pool3d(_t(g["maxpool_x"][:, 0]))  # [B, Z, Y, X]
    np.testing.assert_array_equal(y.numpy(), g["maxpool_y"][:, 0])


def test_preprocess_sdf_clamp(g):
    y = L.preprocess_sdf(_t(g["clamp_x"]), 3.0)
    np.testing.assert_allclose(y.numpy(), g["clamp_y"], atol=0)


def test_apply_log_transform(g):
    y = L.apply_log_transform(_t(g["logt_x"]))
    np.testing.assert_allclose(y.numpy(), g["logt_y"], atol=1e-6)


def test_weighted_bce_with_logits(g):
    loss = L.bce_with_logits(_t(g["bce_logits"]), _t(g["bce_tgts"]))
    val = torch.mean(loss * _t(g["bce_w"]))
    np.testing.assert_allclose(float(val), float(g["bce_y"]), atol=1e-6)


def test_l1_on_log_transformed(g):
    d = torch.abs(L.apply_log_transform(_t(g["l1log_p"]))
                  - L.apply_log_transform(_t(g["l1log_t"])))
    np.testing.assert_allclose(float(torch.mean(d)), float(g["l1log_y"]),
                               atol=1e-6)
