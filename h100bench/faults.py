"""Faults planted underneath a run's timed path, for the benchmark's tests
and for reading the numbers a fault gives on the card
(``calibrate.py``): the check that decides ``correct`` has to fail each
of them. Nothing here runs in the benchmark's own runs.

Serving (``serve.run``'s ``fault(model)``): an answer altered where it is
produced (the surface's sdf, a gate's kept voxels, the coarse gate's
logit). Training (``train.run``'s ``fault`` object: ``install(trainer)``
before the first step, ``batch(host, device, trainer)`` before each):
a step that leaves the state unchanged, half of the batch left out
with the mean taken over the rest (the second half replaced by the first),
and one site's weight gradient zeroed where it reaches the weight.
"""

from __future__ import annotations

import numpy as np
import torch


def _wrap(model, edit):
    forward = model.forward

    def broken(*a, **kw):
        out = forward(*a, **kw)
        edit(out)
        return out
    model.forward = broken


def sdf_altered(model):
    """The surface's sdf moved by a tenth of a voxel at every fifth
    surface voxel."""
    def edit(out):
        flat = out.surf_sdf.view(-1)
        idx = torch.nonzero(out.surf_mask.view(-1))[::5, 0]
        flat[idx] += 0.1
    _wrap(model, edit)


def gate_dropped(model):
    """Every seventh kept voxel of the finest level dropped."""
    def edit(out):
        flat = out.surf_mask.view(-1)
        flat[torch.nonzero(flat)[::7, 0]] = False
    _wrap(model, edit)


def coarse_flipped(model):
    """The coarse gate's logit negated at every ninth coarse voxel."""
    def edit(out):
        out.coarse_out.view(-1, 2)[::9, 0] *= -1
    _wrap(model, edit)


SERVE = {"sdf_altered": sdf_altered, "gate_dropped": gate_dropped,
         "coarse_flipped": coarse_flipped}


class StateUnchanged:
    """Every optimizer step does nothing: the parameters stay as they
    were."""

    def install(self, trainer):
        trainer.opt.step = lambda *a, **kw: None

    def batch(self, host, dev, trainer):
        return host, dev


def _half_rows(locs, vals, n, B):
    """Rows of samples < B/2, then the same rows as samples B/2.., padded
    back to the capacity."""
    cap = len(locs)
    valid = locs[:n]
    first = valid[:, 3] < B // 2
    lo, vo = valid[first], vals[:n][first]
    hi = lo.copy()
    hi[:, 3] += B // 2
    locs2 = np.concatenate([lo, hi])[:cap]
    vals2 = np.concatenate([vo, vo])[:cap]
    m = len(locs2)
    pad = cap - m
    locs2 = np.concatenate([locs2, np.full((pad, 4), -1, locs.dtype)])
    vals2 = np.concatenate([vals2, np.zeros((pad,) + vals.shape[1:],
                                            vals.dtype)])
    return locs2, vals2, np.int32(m)


class HalfBatch:
    """Half of each batch left out, the mean taken over the rest: the
    samples of the second half replaced by copies of the first."""

    def install(self, trainer):
        pass

    def batch(self, host, dev, trainer):
        from sgnn_tpu_torch.train import step as TS

        b = dict(host)
        B = len(b["names"])
        h = B // 2
        b["input_locs"], b["input_sdf"], b["input_num_valid"] = _half_rows(
            b["input_locs"], b["input_sdf"], int(b["input_num_valid"]), B)
        b["target_locs"], b["target_vals"], b["target_num_valid"] = \
            _half_rows(b["target_locs"], b["target_vals"],
                       int(b["target_num_valid"]), B)
        rows = [_half_rows(lc, v, int(n), B) for lc, v, n in
                zip(b["hier_locs"], b["hier_vals"], b["hier_num"])]
        b["hier_locs"] = [r[0] for r in rows]
        b["hier_vals"] = [r[1] for r in rows]
        b["hier_num"] = [r[2] for r in rows]

        def dup(a):
            a = a.copy()
            a[h:2 * h] = a[:h]
            return a
        b["target_pos"] = dup(b["target_pos"])
        b["hier_pos"] = [dup(p) for p in b["hier_pos"]]
        b["known_unk"] = dup(b["known_unk"])
        b["names"] = b["names"][:h] * 2
        return b, TS.to_device(b, trainer.device, trainer.transfer_dtype)


class TrunkGradZeroed:
    """The weight gradient of one site, the trunk's first transposed conv
    (``encoder/decode_dense3``), zeroed where it reaches the weight."""

    key = "['encoder']['decode_dense3']['conv']"

    def install(self, trainer):
        model = trainer.model
        w = model.weights[model.param_keys.index(self.key)]
        w.register_hook(torch.zeros_like)

    def batch(self, host, dev, trainer):
        return host, dev


TRAIN = {"state_unchanged": StateUnchanged, "half_batch": HalfBatch,
         "trunk_dw_zeroed": TrunkGradZeroed}
