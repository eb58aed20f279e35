"""The coarse dense trunk at 1/8 resolution (port of
``sgnn_tpu/models/dense_flow.py:328`` ``dense_trunk`` and
``models/sgnn.py:94`` ``_dense_cbr``): a small conv / transposed-conv
U-Net over the encoder's last level, then the occupancy and SDF heads.
``DenseTrunk`` serves with prepared eval constants; ``dense_trunk_train``
is the same trunk over parameter tensors, with batch-moment BN when
training.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.ops import bn as BN
from sgnn_tpu_torch.ops import dense as D


def trunk_layers(cfg: SGNNConfig) -> list:
    """(name, cin, cout, kernel, stride, padding, transpose) per layer."""
    nf = cfg.nf_per_level[-1]
    nf0, nf1 = nf * 3 // 2, nf * 2
    nf2 = nf1
    nf3 = nf1 + nf2 if cfg.use_skip_dense else nf2
    nf4 = nf3 // 2
    nf4_in = nf4 + nf0 if cfg.use_skip_dense else nf4
    nf5 = nf4_in // 2
    return [
        ("encode_dense0", nf, nf0, 4, 2, 1, False),
        ("encode_dense1", nf0, nf1, 4, 2, 1, False),
        ("bottleneck_dense2", nf1, nf2, 1, 1, 0, False),
        ("decode_dense3", nf3, nf4, 4, 2, 1, True),
        ("decode_dense4", nf4_in, nf5, 4, 2, 1, True),
        ("final", nf5, cfg.nf_coarse, 1, 1, 0, False),
    ]


def _rounded(a, dtype: torch.dtype) -> torch.Tensor:
    """A weight array as f32 holding values rounded to the compute type."""
    return torch.tensor(np.asarray(a, np.float32)).to(dtype).float()


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 padding: int, transpose: bool):
        super().__init__()
        self.stride, self.padding, self.transpose = stride, padding, transpose
        shape = (cin, cout, k, k, k) if transpose else (cout, cin, k, k, k)
        self.register_buffer("w", torch.zeros(shape))
        for name in ("mean", "inv", "bias"):
            self.register_buffer(name, torch.zeros(cout))

    def load(self, p: dict, s: dict, dtype: torch.dtype) -> None:
        self.w.copy_(_rounded(p["conv"], dtype))
        for buf, v in zip((self.mean, self.inv, self.bias),
                          BN.eval_constants(p["bn"], s["bn"])):
            buf.copy_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = D.conv_transpose3d if self.transpose else D.conv3d
        y = conv(x, self.w, stride=self.stride, padding=self.padding)
        return BN.batch_norm_eval(y, self.mean, self.inv, self.bias)


class DenseTrunk(nn.Module):
    """Returns (features y [B, Z8, Y8, X8, nf_coarse] in the compute type,
    coarse_out [B, Z8, Y8, X8, 2] f32 (occ logit, sdf))."""

    def __init__(self, cfg: SGNNConfig):
        super().__init__()
        self.skip = cfg.use_skip_dense
        self.layers = nn.ModuleDict({
            name: ConvBNReLU(cin, cout, k, s, p, tr)
            for name, cin, cout, k, s, p, tr in trunk_layers(cfg)
        })
        self.register_buffer("occ_w", torch.zeros(1, cfg.nf_coarse, 1, 1, 1))
        self.register_buffer("sdf_w", torch.zeros(1, cfg.nf_coarse, 1, 1, 1))

    def load(self, enc_p: dict, enc_s: dict, dtype: torch.dtype) -> None:
        for name, layer in self.layers.items():
            layer.load(enc_p[name], enc_s[name], dtype)
        self.occ_w.copy_(_rounded(enc_p["occpred"], dtype))
        self.sdf_w.copy_(_rounded(enc_p["sdfpred"], dtype))

    def forward(self, x: torch.Tensor):
        L = self.layers
        enc0 = L["encode_dense0"](x)
        enc1 = L["encode_dense1"](enc0)
        bott = L["bottleneck_dense2"](enc1)
        dec_in = torch.cat([bott, enc1], -1) if self.skip else bott
        dec0 = L["decode_dense3"](dec_in)
        dec_in = torch.cat([dec0, enc0], -1) if self.skip else dec0
        y = L["final"](L["decode_dense4"](dec_in))
        occ = D.conv3d(y, self.occ_w)
        sdf = D.conv3d(y, self.sdf_w)
        return y, torch.cat([occ, sdf], -1).float()


def dense_trunk_train(enc_p: dict, enc_s: dict, cfg: SGNNConfig,
                      x: torch.Tensor, *, training: bool):
    """dense_trunk(training=...) over the encoder's parameter tensors:
    returns (features y, coarse_out f32, new stats of the trunk's BNs).
    Weights are rounded to x's type, as ``w.astype(x.dtype)`` does."""
    dt = x.dtype
    layers = {name: (stride, pad, tr)
              for name, _, _, _, stride, pad, tr in trunk_layers(cfg)}
    s = {}

    def cbr(name, inp):
        stride, pad, tr = layers[name]
        conv = D.conv_transpose3d if tr else D.conv3d
        y = conv(inp, enc_p[name]["conv"].to(dt).float(), stride=stride,
                 padding=pad)
        y, bn_s = BN.batch_norm_dense(enc_p[name]["bn"], enc_s[name]["bn"],
                                      y, training=training)
        s[name] = {"bn": bn_s}
        return y

    skip = cfg.use_skip_dense
    enc0 = cbr("encode_dense0", x)
    enc1 = cbr("encode_dense1", enc0)
    bott = cbr("bottleneck_dense2", enc1)
    dec0 = cbr("decode_dense3", torch.cat([bott, enc1], -1) if skip else bott)
    y = cbr("decode_dense4", torch.cat([dec0, enc0], -1) if skip else dec0)
    y = cbr("final", y)
    occ = D.conv3d(y, enc_p["occpred"].to(dt).float())
    sdf = D.conv3d(y, enc_p["sdfpred"].to(dt).float())
    return y, torch.cat([occ, sdf], -1).float(), s
