"""Reference ``sgnn.pth`` checkpoints <-> the port's parameter trees.

Port of ``sgnn_tpu/utils/ckpt_convert.py`` (:49-375), both ways. The
reference saves ``{'epoch', 'state_dict', 'optimizer'}``; the state_dict
keys follow its GenModel module tree (reference ``model.py:276-314``).
Every key maps to one leaf of the numpy ``(params, stats)`` trees of
``params.init_params``:

  torch module                              tree path
  encoder.process_sparse.K.p1               encoder/process_sparse[K]/p1
  encoder.process_sparse.K.p2.0.1.{0..3}    .../p2/{bn0,conv0,bn1,conv1}
  encoder.process_sparse.K.p2.2             .../p2_bn
  encoder.process_sparse.K.p3.{0,1}         .../{p3,p3_bn}
  encoder.{encode_dense*,bottleneck_dense2,decode_dense*,final}.{0,1}
                                            .../{conv,bn}
  encoder.{occpred,sdfpred}.0               .../{occpred,sdfpred}
  refinement.H.{p1,p3,n1,n2,linear,linearsdf}   direct
  refinement.H.p2, surfacepred.p2           scn.FullyConvolutionalNet
      (reps=1, residual): [0] block ConcatTable, [2] down ConcatTable
      whose branch 1 is Sequential(BNReLU, Convolution, deeper, UnPool)
      -> {block, down_bn, down_conv, deeper}
  surfacepred.{p1,p3,linear}                direct

Sparse conv weights are ``[filter_volume, Cin, Cout]`` with taps in C
order over (z, y, x) (``tap_order="c"``) or reversed (``"flipped"``);
``nn.Linear`` ``[out, in]`` is transposed to ``[in, out]``; dense conv
weights keep torch's layout. ``export_state_dict`` maps the trees back.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.params import init_params

DENSE_LAYERS = ("encode_dense0", "encode_dense1", "bottleneck_dense2",
                "decode_dense3", "decode_dense4", "final")


class ConversionError(Exception):
    pass


class _SD:
    """A state_dict view that tracks the keys taken."""

    def __init__(self, sd: dict):
        self.sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                       else np.asarray(v)) for k, v in sd.items()}
        self.used = set()

    def take(self, key: str, shape: tuple) -> np.ndarray:
        if key not in self.sd:
            raise ConversionError(f"missing key {key}")
        self.used.add(key)
        v = self.sd[key].astype(np.float32)
        if v.shape != tuple(shape):
            raise ConversionError(f"{key}: shape {v.shape} != expected "
                                  f"{tuple(shape)}")
        return v

    def leftovers(self) -> list:
        return [k for k in self.sd if k not in self.used
                and not k.endswith("num_batches_tracked")]


def _bn(sd: _SD, prefix: str, p: dict, s: dict) -> None:
    c = p["scale"].shape
    p["scale"] = sd.take(f"{prefix}.weight", c)
    p["bias"] = sd.take(f"{prefix}.bias", c)
    s["mean"] = sd.take(f"{prefix}.running_mean", c)
    s["var"] = sd.take(f"{prefix}.running_var", c)


def _linear(sd: _SD, prefix: str, p: dict) -> None:
    cin, cout = p["weight"].shape
    p["weight"] = sd.take(f"{prefix}.weight", (cout, cin)).T.copy()
    p["bias"] = sd.take(f"{prefix}.bias", (cout,))


def _resblock(sd: _SD, prefix: str, p: dict, s: dict) -> None:
    _bn(sd, f"{prefix}.1.0", p["bn0"], s["bn0"])
    p["conv0"] = sd.take(f"{prefix}.1.1.weight", p["conv0"].shape)
    _bn(sd, f"{prefix}.1.2", p["bn1"], s["bn1"])
    p["conv1"] = sd.take(f"{prefix}.1.3.weight", p["conv1"].shape)


def _unet(sd: _SD, prefix: str, p: dict, s: dict) -> None:
    _resblock(sd, f"{prefix}.0", p["block"], s["block"])
    if "deeper" in p:
        _bn(sd, f"{prefix}.2.1.0", p["down_bn"], s["down_bn"])
        p["down_conv"] = sd.take(f"{prefix}.2.1.1.weight",
                                 p["down_conv"].shape)
        _unet(sd, f"{prefix}.2.1.2", p["deeper"], s["deeper"])


def convert_state_dict(state_dict: dict, cfg: SGNNConfig
                       ) -> tuple[dict, dict]:
    """A reference state_dict -> (params, stats). Raises ConversionError
    on a missing, mis-shaped or unconsumed key."""
    params, stats = init_params(cfg, 0)
    sd = _SD(state_dict)
    enc_p, enc_s = params["encoder"], stats["encoder"]
    for k, (p, s) in enumerate(zip(enc_p["process_sparse"],
                                   enc_s["process_sparse"])):
        pre = f"encoder.process_sparse.{k}"
        p["p1"] = sd.take(f"{pre}.p1.weight", p["p1"].shape)
        _resblock(sd, f"{pre}.p2.0", p["p2"], s["p2"])
        _bn(sd, f"{pre}.p2.2", p["p2_bn"], s["p2_bn"])
        p["p3"] = sd.take(f"{pre}.p3.0.weight", p["p3"].shape)
        _bn(sd, f"{pre}.p3.1", p["p3_bn"], s["p3_bn"])
    for name in DENSE_LAYERS:
        p, s = enc_p[name], enc_s[name]
        p["conv"] = sd.take(f"encoder.{name}.0.weight", p["conv"].shape)
        _bn(sd, f"encoder.{name}.1", p["bn"], s["bn"])
    for name in ("occpred", "sdfpred"):
        enc_p[name] = sd.take(f"encoder.{name}.0.weight", enc_p[name].shape)
    for h, (p, s) in enumerate(zip(params["refinement"],
                                   stats["refinement"])):
        pre = f"refinement.{h}"
        p["p1"] = sd.take(f"{pre}.p1.weight", p["p1"].shape)
        _unet(sd, f"{pre}.p2", p["p2"], s["p2"])
        _bn(sd, f"{pre}.p3", p["p3"], s["p3"])
        p["n1"] = sd.take(f"{pre}.n1.weight", p["n1"].shape)
        _bn(sd, f"{pre}.n2", p["n2"], s["n2"])
        _linear(sd, f"{pre}.linear", p["linear"])
        _linear(sd, f"{pre}.linearsdf", p["linearsdf"])
    p, s = params["surfacepred"], stats["surfacepred"]
    p["p1"] = sd.take("surfacepred.p1.weight", p["p1"].shape)
    _unet(sd, "surfacepred.p2", p["p2"], s["p2"])
    _bn(sd, "surfacepred.p3", p["p3"], s["p3"])
    _linear(sd, "surfacepred.linear", p["linear"])
    left = sd.leftovers()
    if left:
        raise ConversionError(f"unconsumed reference keys: {left[:10]}"
                              f"{' ...' if len(left) > 10 else ''}")
    return params, stats


def export_state_dict(params: dict, stats: dict, cfg: SGNNConfig) -> dict:
    """The inverse of ``convert_state_dict``: numpy (params, stats) trees
    -> the reference state_dict layout, as f32 numpy arrays. Converting
    the result back gives the trees bit for bit, and the reference code
    loads it from ``torch.save({'epoch', 'state_dict', 'optimizer'})``."""
    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [f32(v) for v in t]
        return np.asarray(t, np.float32)

    params, stats = f32(params), f32(stats)
    sd = {}

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"] = p["scale"]
        sd[f"{prefix}.bias"] = p["bias"]
        sd[f"{prefix}.running_mean"] = s["mean"]
        sd[f"{prefix}.running_var"] = s["var"]

    def linear(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(p["weight"].T)
        sd[f"{prefix}.bias"] = p["bias"]

    def resblock(prefix, p, s):
        bn(f"{prefix}.1.0", p["bn0"], s["bn0"])
        sd[f"{prefix}.1.1.weight"] = p["conv0"]
        bn(f"{prefix}.1.2", p["bn1"], s["bn1"])
        sd[f"{prefix}.1.3.weight"] = p["conv1"]

    def unet(prefix, p, s):
        resblock(f"{prefix}.0", p["block"], s["block"])
        if "deeper" in p:
            bn(f"{prefix}.2.1.0", p["down_bn"], s["down_bn"])
            sd[f"{prefix}.2.1.1.weight"] = p["down_conv"]
            unet(f"{prefix}.2.1.2", p["deeper"], s["deeper"])

    enc_p, enc_s = params["encoder"], stats["encoder"]
    for k in range(len(cfg.nf_per_level)):
        p, s = enc_p["process_sparse"][k], enc_s["process_sparse"][k]
        pre = f"encoder.process_sparse.{k}"
        sd[f"{pre}.p1.weight"] = p["p1"]
        resblock(f"{pre}.p2.0", p["p2"], s["p2"])
        bn(f"{pre}.p2.2", p["p2_bn"], s["p2_bn"])
        sd[f"{pre}.p3.0.weight"] = p["p3"]
        bn(f"{pre}.p3.1", p["p3_bn"], s["p3_bn"])
    for name in DENSE_LAYERS:
        sd[f"encoder.{name}.0.weight"] = enc_p[name]["conv"]
        bn(f"encoder.{name}.1", enc_p[name]["bn"], enc_s[name]["bn"])
    for name in ("occpred", "sdfpred"):
        sd[f"encoder.{name}.0.weight"] = enc_p[name]
    for h in range(cfg.num_refine_levels):
        p, s = params["refinement"][h], stats["refinement"][h]
        pre = f"refinement.{h}"
        sd[f"{pre}.p1.weight"] = p["p1"]
        unet(f"{pre}.p2", p["p2"], s["p2"])
        bn(f"{pre}.p3", p["p3"], s["p3"])
        sd[f"{pre}.n1.weight"] = p["n1"]
        bn(f"{pre}.n2", p["n2"], s["n2"])
        linear(f"{pre}.linear", p["linear"])
        linear(f"{pre}.linearsdf", p["linearsdf"])
    p, s = params["surfacepred"], stats["surfacepred"]
    sd["surfacepred.p1.weight"] = p["p1"]
    unet("surfacepred.p2", p["p2"], s["p2"])
    bn("surfacepred.p3", p["p3"], s["p3"])
    linear("surfacepred.linear", p["linear"])
    return sd


def expected_state_dict_spec(cfg: SGNNConfig) -> dict:
    """{key: shape} of the reference state_dict for this configuration,
    from the trees ``params.init_params`` gives: the layout a checkpoint
    is checked against before conversion."""
    return {k: v.shape for k, v in export_state_dict(*init_params(cfg, 0),
                                                     cfg).items()}


def flip_tap_order(params: dict) -> dict:
    """A copy of ``params`` with the tap enumeration of every sparse conv
    weight ([8 or 27, Cin, Cout]) reversed: for a C-order enumeration
    over (z, y, x), flipping every axis is tap -> K - 1 - tap. Dense
    conv weights (5-D torch layout) stay as they are."""
    def flip(t):
        if isinstance(t, dict):
            return {k: flip(v) for k, v in t.items()}
        if isinstance(t, list):
            return [flip(v) for v in t]
        if t.ndim == 3 and t.shape[0] in (8, 27):
            return t[::-1].copy()
        return t
    return flip(copy.deepcopy(params))


def load_reference_checkpoint(path, cfg: SGNNConfig, tap_order: str = "c"
                              ) -> tuple[dict, dict, dict]:
    """Load a reference ``.pth`` and convert it. Returns (params, stats,
    meta). The file is read with ``weights_only=True``: tensors and plain
    containers only."""
    if tap_order not in ("c", "flipped"):
        raise ValueError(f"tap_order must be 'c' or 'flipped', not "
                         f"{tap_order!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    params, stats = convert_state_dict(sd, cfg)
    if tap_order == "flipped":
        params = flip_tap_order(params)
    return params, stats, {"epoch": int(ckpt.get("epoch", 0))}
