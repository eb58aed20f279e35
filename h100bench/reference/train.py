"""Plain PyTorch reference of SG-NN's training step (the reference code's
``torch/train.py`` and ``loss.py``): the chunk files read back, the
targets of every hierarchy level, the hierarchical loss, the gradients by
autograd through ``sgnn.Forward`` in its training form (BN over the batch
moments of each level's voxels) and Adam (lr 1e-3, betas (0.9, 0.999),
eps 1e-8, no weight decay).

Loss (loss.py): level 0 is the BCE of the coarse occupancy logit and the
L1 of the log-transformed coarse sdf over every coarse voxel; level h the
same at the children of the kept voxels of level h - 1; the surface the
L1 of the log-transformed sdf at the surface's voxels; every term a
masked mean, weighted 5 off the scan's voxels (``weight_missing_geo``),
with unobserved voxels (known >= 2) left out; all levels weighted 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import sgnn as R

UNK_THRESH = 2
UNK_ID = -1.0
HEADER = np.dtype([("dimx", "<u8"), ("dimy", "<u8"), ("dimz", "<u8"),
                   ("voxelsize", "<f4"), ("world2grid", "<f4", (16,))])


def read_chunk(path: str, truncation: float) -> dict:
    """A ``.sdfs`` chunk file: the header, the input rows, the target rows,
    the known grid and the hierarchy's rows (finest first in the file),
    each block a count, xyz uint32 locations and f32 values in world
    units. Returns dense arrays: input rows with |sdf| < truncation,
    target [Z, Y, X] and hierarchy coarse -> fine, -inf where no row."""
    buf = open(path, "rb").read()
    off = 0

    def take(dtype, count=1):
        nonlocal off
        dt = np.dtype(dtype)
        out = np.frombuffer(buf, dt, count, off)
        off += dt.itemsize * count
        return out

    h = take(HEADER)[0]
    dims = (int(h["dimz"]), int(h["dimy"]), int(h["dimx"]))
    vs = float(h["voxelsize"])

    def block():
        n = int(take("<u8")[0])
        locs = take("<u4", n * 3).reshape(n, 3)[:, ::-1].astype(np.int64)
        vals = take("<f4", n).astype(np.float32) / vs
        return locs, vals

    def dense(locs, vals, d):
        g = np.full(d, -np.inf, np.float32)
        g[locs[:, 0], locs[:, 1], locs[:, 2]] = vals
        return g

    in_locs, in_sdf = block()
    target = dense(*block(), dims)
    n = int(take("<u8")[0])
    known = take("u1", n).reshape(dims).copy()
    hier = []
    for f in (2, 4, 8):
        hier.append(dense(*block(), tuple(d // f for d in dims)))
    keep = np.abs(in_sdf) < truncation
    return {"dims": dims, "input_locs": in_locs[keep],
            "input_sdf": in_sdf[keep], "target": target, "known": known,
            "hierarchy": hier[::-1]}


def batch_tensors(chunks: list, device) -> dict:
    """Chunks -> input rows (z, y, x, b) and stacked dense grids."""
    locs = np.concatenate([np.concatenate(
        [c["input_locs"], np.full((len(c["input_locs"]), 1), b)], 1)
        for b, c in enumerate(chunks)])
    t = {"locs": torch.from_numpy(locs).to(device),
         "feats": torch.from_numpy(np.concatenate(
             [c["input_sdf"] for c in chunks]))[:, None].to(device),
         "target": torch.from_numpy(np.stack(
             [c["target"] for c in chunks])).to(device),
         "known": torch.from_numpy(np.stack(
             [c["known"] for c in chunks])).to(device),
         "hierarchy": [torch.from_numpy(np.stack(
             [c["hierarchy"][h] for c in chunks])).to(device)
             for h in range(len(chunks[0]["hierarchy"]))],
         "dims": chunks[0]["dims"], "batch": len(chunks)}
    return t


def _log(x):
    return torch.sign(x) * torch.log(x.abs() + 1.0)


def _bce(logit, tgt):
    return (torch.relu(logit) - logit * tgt
            + torch.log1p(torch.exp(-logit.abs())))


def _mean(vals, mask):
    return torch.where(mask, vals, torch.zeros_like(vals)).sum() / \
        mask.sum().clamp_min(1)


def _pool(x):
    return F.max_pool3d(x[:, None], 2)[:, 0]


def loss(net: R.Net, fw: R.Forward, out, b: dict,
         weight_missing_geo: float = 5.0):
    """(total, per level: L levels and the surface) of one forward."""
    coarse, sdf, smask = out
    t = net.truncation
    L = net.num_hierarchy_levels
    tsdf = b["target"].clamp(-t, t)
    unk_known = b["known"] >= UNK_THRESH
    occ = torch.where(unk_known, torch.full_like(tsdf, UNK_ID),
                      (tsdf.abs() < t).float())
    occs, hier = [None] * L, [None] * L
    occs[-1], hier[-1] = occ, tsdf
    for h in range(L - 2, -1, -1):
        occs[h] = _pool(occs[h + 1])
        hier[h] = b["hierarchy"][h].clamp(-t, t)
    B, (Z, Y, X) = b["batch"], b["dims"]
    inp = torch.zeros(B, Z, Y, X, dtype=torch.bool, device=tsdf.device)
    lc = b["locs"]
    inp[lc[:, 3], lc[:, 0], lc[:, 1], lc[:, 2]] = True
    w = [None] * L
    w[-1] = torch.where(inp, 1.0, weight_missing_geo)
    for h in range(L - 2, -1, -1):
        w[h] = w[h + 1][:, ::2, ::2, ::2]

    def level(logit, sdf_pred, site, occ_t, hier_t, wt):
        m = site & (occ_t != UNK_ID)
        return (_mean(_bce(logit, occ_t) * wt, m)
                + _mean((_log(sdf_pred) - _log(hier_t)).abs() * wt, m))

    per = [level(coarse[:, 0], coarse[:, 1], torch.ones_like(occs[0],
                 dtype=torch.bool), occs[0], hier[0], w[0])]
    for h, (cand, heads) in enumerate(fw.levels):
        per.append(level(heads[:, 0], heads[:, 1], cand, occs[h + 1],
                         hier[h + 1], w[h + 1]))
    m = smask & ~unk_known
    per.append(_mean((_log(sdf) - _log(tsdf)).abs() * w[-1], m))
    return sum(per), per


def train_steps(net: R.Net, params: dict, stats: dict, batches: list,
                lr: float = 1e-3, quant=None, masks=None) -> list:
    """Adam steps of the reference on ``batches`` from ``params`` (f32
    tensors, copied); ``masks``, where given, the kept voxels of every
    gate per step, which the forwards then follow. Returns per step: the
    loss, the per-level losses, the gradients, the parameters after the
    step (flat lists in ``R.leaves`` order) and the gate gaps."""
    leaves = [v.detach().clone().float().requires_grad_(True)
              for _, v in R.leaves(params)]
    paths = [k for k, _ in R.leaves(params)]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    steps = []
    for i, b in enumerate(batches):
        tree = R.tree_map(lambda k, _: leaves[paths.index(k)], params)
        fw = R.Forward(net, tree, stats, training=True, quant=quant)
        with R.precise():
            out = fw(b["locs"], b["feats"], b["dims"], b["batch"],
                     masks=None if masks is None else masks[i])
            total, per = loss(net, fw, out, b)
            opt.zero_grad(set_to_none=True)
            total.backward()
        grads = [p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p) for p in leaves]
        opt.step()
        steps.append({"loss": float(total.detach()),
                      "per_level": [float(x.detach()) for x in per],
                      "grads": grads, "gates": R.gate_gaps(fw),
                      "kept": [g["kept"] for g in fw.gates],
                      "params": [p.detach().clone() for p in leaves]})
    return steps


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale per tensor (its
    largest magnitude at e4m3's 448), the gradient passed straight
    through: the control's products' inputs."""
    amax = t.detach().abs().max().clamp_min(1e-30)
    scale = amax / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())
