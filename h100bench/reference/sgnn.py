"""Plain PyTorch reference of SG-NN's serving forward (Dai et al., "SG-NN:
Sparse Generative Neural Networks for Self-Supervised Scene Completion of
RGB-D Scans", CVPR 2020; the reference code's ``torch/model.py``).

Every sparse level is a dense ``[B, C, Z, Y, X]`` f32 grid with a bool
mask ``[B, Z, Y, X]``: a submanifold 3^3 conv is a dense conv times the
mask (every input is zero outside its mask), a stride-2 2^3 conv takes
as its mask the coarse voxels with an active child, the generative
upsample is a 3^3 conv of the 2x nearest-neighbour upsampled grid on the
children of the kept voxels, and each refinement level keeps the children
whose occupancy logit is positive (``sigmoid > 0.5``). BN is the eval
form over the running stats (eps 1e-4 on the sparse levels, as
SparseConvNet's, 1e-5 in the dense trunk) followed by ReLU; a grid's
concatenated groups go through one BN and one conv. Computed in f32 with
TF32 off (``precise``).

The parameters are the nested ``(params, stats)`` trees the SG-NN code
base stores (the JAX package's layout, which the port's ``load_jax_params``
reads); ``param_spec`` lists their leaves with their shapes and
initialisers. This file imports nothing of the programs it judges.

``forward(..., masks=...)`` follows a program's gate decisions instead of
its own: the kept voxels of each level are the program's, and what the
reference records at each gate (its own logits over the candidates) says
how far each of the program's decisions lies from the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

SPARSE_BN_EPS = 1e-4
DENSE_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Net:
    """The published model's sizes (the reference's train.py and
    test_scene.py defaults)."""
    encoder_dim: int = 8
    nf_coarse: int = 16
    nf: int = 16
    num_hierarchy_levels: int = 4
    input_nf: int = 1
    truncation: float = 3.0

    @property
    def nf_per_level(self) -> list:
        L = self.num_hierarchy_levels
        return [int(self.encoder_dim * (1 + k / (L - 2)))
                for k in range(L - 1)]

    @property
    def refine_levels(self) -> int:
        return self.num_hierarchy_levels - 1

    def trunk_layers(self) -> list:
        """(name, cin, cout, kernel, stride, padding, transposed)."""
        nf = self.nf_per_level[-1]
        nf0, nf1 = nf * 3 // 2, nf * 2
        nf3 = nf1 + nf1
        nf4 = nf3 // 2
        nf5 = (nf4 + nf0) // 2
        return [("encode_dense0", nf, nf0, 4, 2, 1, False),
                ("encode_dense1", nf0, nf1, 4, 2, 1, False),
                ("bottleneck_dense2", nf1, nf1, 1, 1, 0, False),
                ("decode_dense3", nf3, nf4, 4, 2, 1, True),
                ("decode_dense4", nf4 + nf0, nf5, 4, 2, 1, True),
                ("final", nf5, self.nf_coarse, 1, 1, 0, False)]

    def refine_cin(self) -> tuple[list, int]:
        """Input channels of each refinement level's first conv and of the
        surface head's: the coarse heads and features, or the features and
        heads of the level before, then the skip."""
        L = self.num_hierarchy_levels
        nf_per = self.nf_per_level + [self.nf_per_level[-1]]
        cins = []
        for h in range(L):
            first = self.nf_coarse if h == 0 else self.nf
            cins.append(first + 2 + nf_per[L - 1 - h])
        return cins[:-1], cins[-1]


# ----------------------------------------------------------- parameters


def _bn_spec(c: int):
    return ({"scale": ((c,), "bn_scale"), "bias": ((c,), "bn_bias")},
            {"mean": ((c,), "bn_mean"), "var": ((c,), "bn_var")})


def _conv_spec(fv: int, cin: int, cout: int):
    return ((fv, cin, cout), ("normal", (2.0 / (fv * cin)) ** 0.5))


def _resblock_spec(nf: int):
    (p0, s0), (p1, s1) = _bn_spec(nf), _bn_spec(nf)
    return ({"bn0": p0, "conv0": _conv_spec(27, nf, nf), "bn1": p1,
             "conv1": _conv_spec(27, nf, nf)}, {"bn0": s0, "bn1": s1})


def _unet_spec(nf: int, levels: int):
    p_res, s_res = _resblock_spec(nf)
    if levels == 1:
        return {"block": p_res}, {"block": s_res}
    p_bn, s_bn = _bn_spec(nf)
    p_deep, s_deep = _unet_spec(nf, levels - 1)
    return ({"block": p_res, "down_bn": p_bn,
             "down_conv": _conv_spec(8, nf, nf), "deeper": p_deep},
            {"block": s_res, "down_bn": s_bn, "deeper": s_deep})


def _linear(cin: int, cout: int):
    b = (1.0 / cin) ** 0.5
    return {"weight": ((cin, cout), ("uniform", b)),
            "bias": ((cout,), ("uniform", b))}


def param_spec(net: Net) -> tuple[dict, dict]:
    """(params, stats) trees whose leaves are (shape, initialiser): a
    conv's N(0, sqrt(2 / fan_in)) (SparseConvNet), a dense layer's
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's), or a BN vector's kind."""
    enc_p, enc_s = {"process_sparse": []}, {"process_sparse": []}
    nf_in = net.input_nf
    for nf in net.nf_per_level:
        p_res, s_res = _resblock_spec(nf)
        (p2, s2), (p3, s3) = _bn_spec(nf), _bn_spec(nf)
        enc_p["process_sparse"].append(
            {"p1": _conv_spec(27, nf_in, nf), "p2": p_res, "p2_bn": p2,
             "p3": _conv_spec(8, nf, nf), "p3_bn": p3})
        enc_s["process_sparse"].append({"p2": s_res, "p2_bn": s2,
                                        "p3_bn": s3})
        nf_in = nf
    for name, cin, cout, k, _, _, tr in net.trunk_layers():
        shape = (cin, cout, k, k, k) if tr else (cout, cin, k, k, k)
        p_bn, s_bn = _bn_spec(cout)
        bound = (1 / (cin * k ** 3)) ** 0.5
        enc_p[name] = {"conv": (shape, ("uniform", bound)), "bn": p_bn}
        enc_s[name] = {"bn": s_bn}
    for name in ("occpred", "sdfpred"):
        enc_p[name] = ((1, net.nf_coarse, 1, 1, 1),
                       ("uniform", (1 / net.nf_coarse) ** 0.5))
    ref_cin, surf_cin = net.refine_cin()
    nf = net.nf
    refs_p, refs_s = [], []
    for cin in ref_cin:
        p_unet, s_unet = _unet_spec(nf, 3)
        (p3, s3), (pn2, sn2) = _bn_spec(nf * 3), _bn_spec(nf)
        refs_p.append({"p1": _conv_spec(27, cin, nf), "p2": p_unet, "p3": p3,
                       "n1": _conv_spec(27, nf * 3, nf), "n2": pn2,
                       "linear": _linear(nf, 1), "linearsdf": _linear(nf, 1)})
        refs_s.append({"p2": s_unet, "p3": s3, "n2": sn2})
    p_unet, s_unet = _unet_spec(nf, 3)
    p3, s3 = _bn_spec(nf * 3)
    params = {"encoder": enc_p, "refinement": refs_p,
              "surfacepred": {"p1": _conv_spec(27, surf_cin, nf), "p2": p_unet,
                              "p3": p3, "linear": _linear(nf * 3, 1)}}
    stats = {"encoder": enc_s, "refinement": refs_s,
             "surfacepred": {"p2": s_unet, "p3": s3}}
    return params, stats


def leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def tree_map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return fn(prefix, tree)


# ----------------------------------------------------------- the forward


@contextlib.contextmanager
def precise():
    """f32 convolutions and products without TF32, deterministic cuDNN."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _bn(x, p, s, eps=SPARSE_BN_EPS, mask=None, training=False):
    """BN + ReLU over the channels of ``x [B, C, ...]``, zero outside
    ``mask``: with ``training`` over the batch moments of the mask's
    voxels (every voxel without a mask; the biased variance, E[x^2] -
    E[x]^2 clamped at 0), else over the running stats."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if training:
        dims = [0] + list(range(2, x.dim()))
        m = (torch.ones_like(x[:, :1]) if mask is None
             else mask[:, None].to(x.dtype))
        count = m.sum().clamp_min(1.0)
        mean = (x * m).sum(dims) / count
        var = torch.relu((x * x * m).sum(dims) / count - mean * mean)
    else:
        mean, var = s["mean"], s["var"]
    inv = torch.rsqrt(var + eps) * p["scale"]
    y = ((x - mean.view(shape)) * inv.view(shape)
         + p["bias"].view(shape)).relu()
    return y if mask is None else y * mask[:, None]


def _w3(w, k):
    """[k^3, Cin, Cout] (z-major taps) -> torch's [Cout, Cin, k, k, k]."""
    return w.reshape(k, k, k, w.shape[1], w.shape[2]).permute(4, 3, 0, 1, 2)


def _up2(t):
    for ax in range(-3, 0):
        t = t.repeat_interleave(2, dim=ax)
    return t


def _pool_mask(mask):
    return F.max_pool3d(mask[:, None].float(), 2)[:, 0] > 0


class Work:
    """The operations and bytes each site of a forward needs, counted from
    its shapes and active voxels (no matter what implements it), in the
    served type (bf16: 2 bytes an element): each input read once at the
    voxels the site's function reads (a level's grids are zero outside its
    mask, so a masked input only at its active voxels), each output
    written once at its active voxels, the weights once, a mask as one
    byte a voxel of its level; 2 Cin Cout operations per tap and output
    voxel computed, the trunk's dense convs in full. The BN passes and
    gates between the sites count nothing of their own. Each site's floor
    is the larger of its bytes over the card's memory rate and its
    operations over its peak rate."""

    item = 2  # bytes of an element of the served type

    def __init__(self):
        self.sites = []  # (kind, ops, bytes)

    def add(self, kind: str, ops: float, nbytes: float) -> None:
        self.sites.append((kind, float(ops), float(nbytes)))

    def ops(self) -> float:
        return sum(s[1] for s in self.sites)

    def floor_s(self, bytes_per_s: float, ops_per_s: float) -> float:
        return sum(max(b / bytes_per_s, o / ops_per_s)
                   for _, o, b in self.sites)


def _n(mask) -> int:
    return int(mask.sum())


def _vol(mask) -> int:
    return mask.numel()


class Forward:
    """One forward of the reference over (params, stats) f32 trees on one
    device. ``masks`` (optional): the kept voxels of each gate, coarse
    to fine ([B, Z8, Y8, X8] bool, then one per refinement level), which
    the forward then follows; ``gates`` records at each gate (candidates,
    the reference's own occupancy logits there, the voxels kept)."""

    def __init__(self, net: Net, params: dict, stats: dict,
                 work: Work | None = None, training: bool = False,
                 quant=None):
        self.net, self.p, self.s = net, params, stats
        self.work = work
        self.training = training
        self.q = quant or (lambda t: t)  # rounding of each product's inputs
        self.gates = []
        self.levels = []  # per refinement level: (candidates, raw heads)

    def _bn(self, x, p, s, eps=SPARSE_BN_EPS, mask=None):
        return _bn(x, p, s, eps, mask, self.training)

    def _conv(self, x, w, **kw):
        return F.conv3d(self.q(x), self.q(w), **kw)

    # -- sites
    def _count(self, kind, ops, nbytes):
        if self.work is not None:
            self.work.add(kind, ops, nbytes)

    def subm(self, x, mask, w, residual=None):
        it = Work.item
        cin, cout = w.shape[1], w.shape[2]
        n = _n(mask) if self.work else 0
        self._count("conv", 2 * 27 * cin * cout * n,
                    it * (cin + cout * (2 if residual is not None else 1)) * n
                    + it * w.numel() + _vol(mask))
        y = self._conv(x, _w3(w, 3), padding=1) * mask[:, None]
        return y if residual is None else residual + y

    def strided(self, x, mask, w):
        down_mask = _pool_mask(mask)
        if self.work:
            cin, cout = w.shape[1], w.shape[2]
            nc = _n(down_mask)
            self._count("down", 2 * 8 * cin * cout * nc,
                        Work.item * (cin * _n(mask) + cout * nc
                                          + w.numel()) + _vol(mask))
        y = self._conv(x, _w3(w, 2), stride=2) * down_mask[:, None]
        return y, down_mask

    def resblock(self, x, mask, p, s):
        y = self._bn(x, p["bn0"], s["bn0"], mask=mask)
        y = self.subm(y, mask, p["conv0"])
        y = self._bn(y, p["bn1"], s["bn1"], mask=mask)
        return self.subm(y, mask, p["conv1"], residual=x)

    def unet(self, x, mask, p, s):
        """The groups [x, up(deeper)...] at this resolution."""
        x = self.resblock(x, mask, p["block"], s["block"])
        if "deeper" not in p:
            return [x]
        y = self._bn(x, p["down_bn"], s["down_bn"], mask=mask)
        down, down_mask = self.strided(y, mask, p["down_conv"])
        deep = self.unet(down, down_mask, p["deeper"], s["deeper"])
        return [x, *[_up2(d) * mask[:, None] for d in deep]]

    def trunk(self, x):
        enc_p, enc_s = self.p["encoder"], self.s["encoder"]
        outs = {}

        def cbr(name, inp, cin, cout, k, stride, pad, tr):
            w = enc_p[name]["conv"]
            fn = F.conv_transpose3d if tr else F.conv3d
            y = fn(self.q(inp), self.q(w), stride=stride, padding=pad)
            if self.work:
                vox = (inp if tr else y)[0, 0].numel() * inp.shape[0]
                self._count("trunk", 2 * cin * cout * k ** 3 * vox,
                            Work.item * (inp.numel() + y.numel()
                                              + w.numel()))
            return self._bn(y, enc_p[name]["bn"], enc_s[name]["bn"],
                            eps=DENSE_BN_EPS)

        for name, cin, cout, k, stride, pad, tr in self.net.trunk_layers():
            if name == "encode_dense0":
                inp = x
            elif name == "decode_dense3":
                inp = torch.cat([outs["bottleneck_dense2"],
                                 outs["encode_dense1"]], 1)
            elif name == "decode_dense4":
                inp = torch.cat([outs["decode_dense3"],
                                 outs["encode_dense0"]], 1)
            else:
                inp = prev
            prev = outs[name] = cbr(name, inp, cin, cout, k, stride, pad, tr)
        y = prev
        occ = self._conv(y, enc_p["occpred"])
        sdf = self._conv(y, enc_p["sdfpred"])
        if self.work:
            self._count("trunk", 2 * 2 * y.shape[1] * occ.numel(),
                        Work.item * (y.numel() + 2 * occ.numel()))
        return y, torch.cat([occ, sdf], 1)

    def gate(self, level, cand, logit, masks):
        """The voxels kept at a gate: the reference's own, or the given
        ones; records (candidates, logits, kept)."""
        own = cand & (torch.sigmoid(logit) > 0.5)
        kept = own if masks is None else masks[level]
        if kept.shape != cand.shape:
            raise ValueError(f"gate {level}: mask {tuple(kept.shape)}, "
                             f"expected {tuple(cand.shape)}")
        self.gates.append({"cand": cand, "logit": logit, "kept": kept})
        return kept & cand

    def refine(self, h, cur, mask, masks):
        p, s = self.p["refinement"][h], self.s["refinement"][h]
        z = self.subm(torch.cat(cur, 1), mask, p["p1"])
        groups = self.unet(z, mask, p["p2"], s["p2"])
        zc = self._bn(torch.cat(groups, 1), p["p3"], s["p3"], mask=mask)
        cand = _up2(mask)
        w = p["n1"]
        if self.work:
            cin, cout = w.shape[1], w.shape[2]
            nf = _n(cand)
            self._count("upconv", 2 * 8 * cin * cout * nf,
                        Work.item * (cin * _n(mask) + cout * nf
                                          + 64 * cin * cout) + _vol(mask))
        up = self._conv(_up2(zc), _w3(w, 3), padding=1) * cand[:, None]
        up = self._bn(up, p["n2"], s["n2"], mask=cand)
        occ = self._linear(up, p["linear"])
        sdf = self._linear(up, p["linearsdf"])
        self.levels.append((cand, torch.cat([occ, sdf], 1)))
        kept = self.gate(h + 1, cand, occ[:, 0], masks)
        if self.work:
            nf, nk, c = _n(cand), _n(kept), up.shape[1]
            self._count("head", 2 * c * 2 * nf,
                        Work.item * (c * nf + (c + 2) * nk + 2 * c)
                        + _vol(cand))
        km = kept[:, None].float()
        return [up * km, torch.cat([occ, sdf], 1) * km], kept

    def _linear(self, x, p):
        w = self.q(p["weight"])
        return (torch.einsum("bc...,co->bo...", self.q(x), w)
                + p["bias"].view(1, -1, *([1] * (x.dim() - 2))))

    def __call__(self, locs, feats, dims, batch_size: int = 1, masks=None):
        """``locs [N, 4]`` (z, y, x, b), ``feats [N, 1]``. Returns
        (coarse_out [B, 2, Z8, Y8, X8], surface sdf [B, Z, Y, X], the
        surface's voxels [B, Z, Y, X] bool)."""
        net, dev = self.net, feats.device
        B, (Z, Y, X) = batch_size, dims
        locs = locs.long()
        x = torch.zeros(B, 1, Z, Y, X, device=dev)
        mask = torch.zeros(B, Z, Y, X, dtype=torch.bool, device=dev)
        x[locs[:, 3], 0, locs[:, 0], locs[:, 1], locs[:, 2]] = feats[:, 0]
        mask[locs[:, 3], locs[:, 0], locs[:, 1], locs[:, 2]] = True
        if self.work:
            self._count("scatter", 0, len(locs) * (4 * 8 + 4)
                        + Work.item * _n(mask) + _vol(mask))
        skips = []
        for p, s in zip(self.p["encoder"]["process_sparse"],
                        self.s["encoder"]["process_sparse"]):
            x = self.subm(x, mask, p["p1"])
            x = self.resblock(x, mask, p["p2"], s["p2"])
            y = self._bn(x, p["p2_bn"], s["p2_bn"], mask=mask)
            skips.append((y, mask))
            down, mask = self.strided(y, mask, p["p3"])
            x = self._bn(down, p["p3_bn"], s["p3_bn"], mask=mask)
        skips.append((x, mask))
        y, coarse_out = self.trunk(x)
        cand = torch.ones_like(coarse_out[:, 0], dtype=torch.bool)
        mask = self.gate(0, cand, coarse_out[:, 0], masks)
        m = mask[:, None].float()
        cur = [coarse_out * m, y * m]
        L = net.refine_levels
        for h in range(L):
            cur.append(skips[L - h][0] * mask[:, None])
            cur, mask = self.refine(h, cur, mask, masks)
        p, s = self.p["surfacepred"], self.s["surfacepred"]
        cur.append(skips[0][0] * mask[:, None])
        z = self.subm(torch.cat(cur, 1), mask, p["p1"])
        groups = self.unet(z, mask, p["p2"], s["p2"])
        zc = self._bn(torch.cat(groups, 1), p["p3"], s["p3"], mask=mask)
        sdf = self._linear(zc, p["linear"])[:, 0]
        if self.work:
            n = _n(mask)
            native = n + _n(_pool_mask(mask)) + _n(_pool_mask(
                _pool_mask(mask)))
            self._count("surf_head", 2 * zc.shape[1] * n,
                        Work.item * net.nf * native + 4 * n
                        + _vol(mask))
        return coarse_out, sdf, mask


def gate_gaps(fw: Forward) -> dict:
    """How far the gate decisions a forward followed lie on the wrong side
    of its own logits, over the logits' RMS at each gate's candidates:
    the widest gap (``gate_gap``) and the RMS of the gaps over the
    candidates (``gate_rms``), each the largest over the gates; 1e30
    where a kept voxel was no candidate."""
    gaps = {"gate_gap": 0.0, "gate_rms": 0.0}
    for g in fw.gates:
        if (g["kept"] & ~g["cand"]).any():
            return {k: 1e30 for k in gaps}
        logit = g["logit"].detach()[g["cand"]]
        if not len(logit):
            continue
        kept = g["kept"][g["cand"]]
        wrong = torch.where(kept, (-logit).clamp_min(0), logit.clamp_min(0))
        rms = logit.pow(2).mean().sqrt().clamp_min(1e-30)
        gaps["gate_gap"] = max(gaps["gate_gap"], float(wrong.max() / rms))
        gaps["gate_rms"] = max(gaps["gate_rms"],
                               float(wrong.pow(2).mean().sqrt() / rms))
    return gaps
