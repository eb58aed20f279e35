"""Roofline floors of the folded serving forward on the H100 (port of the
JAX package's ``tools/roofline.py``).

While a ``Recorder`` is active, the ``ops.folded`` entry points the
serving model calls (``subm_conv_fused``, ``downconv_fused``,
``upconv_fused``, ``head_site_fused``, ``surf_head_packed``,
``surf_head_fused``, ``scatter_sparse``, ``unfold``,
``upsample2_folded``) and the dense trunk (``models.folded_flow.
sharded_trunk``) are wrapped, and every call is priced by the work its
function must do, whatever implements it (the rule of ``PERF.md``
section 6 and of ``chip_smoke.py`` phase 3's bounds):

  bytes : each input read once, a group input only in the 32-byte
          sectors (the card's smallest memory access) of the voxels the
          function reads, a mask at every voxel, weights and affines in
          full, and each output written in full;
  ops   : the useful operations: 2 Cin Cout per tap and output voxel the
          function computes (active voxels; the trunk's dense convs as
          torch.utils.flop_counter counts them; the copies none);
  floor : max(bytes / 3.35 TB/s, ops / the peak of their type: 989
          TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s f32), per call.

(NVIDIA's H100 SXM data sheet, dense rates, at 700 W.) The JAX tool
prices the TPU kernels' MXU schedules instead; these floors hold for any
implementation of a site. The counts depend on the data (the active
voxels), so the tool runs a real forward: the bench.py workload (the
full-width model, 96x192x192 sphere scene, bf16, occupancy fractions
(1.0, 0.4, 0.2, 0.1), seeded random weights that leave a surface) in its
only-surface form. Not priced: the BN passes, folds, mask products and
the gates' compares between the sites.

``--measure`` (card only) also traces ``--reps`` forwards and prints
the forward's roofline share (the sum of the floors over the forward's
device time) and idle share, both from a trace without the Recorder's
profiler ranges (the idle share's window that of the traced forwards
themselves), then each family's device ms (the kernels
launched inside its calls, nested calls counted once, in the outermost)
beside its floor, from a second trace with the ranges.

    python -m sgnn_tpu_torch.tools.roofline [--int8] [--dims 96 192 192]
        [--measure] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile

import torch
from torch.nn import functional as nnf

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P

PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12


# ------------------------------------------------- counting the work


def nbytes(*ts) -> int:
    """Bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def voxels(mask, reach: int = 0) -> torch.Tensor:
    """[B, Z, Y, X] bool: the voxels of a folded mask grid that are active,
    or, with ``reach`` 3, within a 3^3 conv's reach of one, with 2, in the
    2^3 block of one (a stride-2 conv's coarse voxel)."""
    from sgnn_tpu_torch.ops import folded as FO

    a = FO.unfold(mask)[..., 0] != 0
    if reach == 3:
        a = nnf.max_pool3d(a[:, None].float(), 3, 1, 1)[:, 0] > 0
    elif reach == 2:
        a = nnf.max_pool3d(a[:, None].float(), 2, 2)[:, 0] > 0
        a = a.repeat_interleave(2, 1).repeat_interleave(2, 2) \
            .repeat_interleave(2, 3)
    return a


def grid_bytes(grids, dt, need=None) -> int:
    """Bytes of folded grids, held in ``dt``, that a kernel must read: each
    grid in full or, with ``need`` ([B, Z, Y, X] bool), only the 32-byte
    sectors that hold a real channel of a voxel it marks."""
    item = torch.empty((), dtype=dt).element_size()
    if need is None:
        return sum(g.data.numel() for g in grids) * item
    total = 0
    for g in grids:
        B, Zp, Yp, xq, lanes = g.data.shape
        slots = torch.zeros(B, Zp - 2, Yp - 2, xq * lanes // g.cpad,
                            dtype=torch.bool, device=need.device)
        slots[..., :need.shape[3]] = need
        real = torch.arange(g.cpad, device=need.device) < g.real_c
        sectors = (slots[..., None] & real).reshape(
            B, Zp - 2, Yp - 2, -1, 32 // item).any(-1)
        total += int(sectors.sum()) * 32
    return total


def active(fm) -> int:
    """Active voxels of a folded mask FGrid."""
    return int((fm.slots()[..., 0] != 0).sum())


def bound(nb: int, ops: float, peak: float = PEAK_BF16) -> dict:
    """The least time for the work on the card: the larger of the bytes
    over its memory rate and the operations over the rate of their type."""
    t_bytes = nb / PEAK_BYTES * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def peak_of(dt: torch.dtype, quantize: bool = False) -> float:
    if quantize:
        return PEAK_INT8
    return PEAK_F32 if dt == torch.float32 else PEAK_BF16


# each site's work: (bytes, operations, peak) from the entry point's own
# arguments (the model passes them as here) and its outputs


def conv_site_work(out, groups, fm, w, cout, *, aff=None, residual=None,
                   quantize=False, ws=None, impl=None):
    """K1: a group only at the active voxels with an affine (relu(.) times
    the mask elsewhere), else within the conv's reach of one."""
    dt = fm.data.dtype
    need = voxels(fm) if aff is not None else voxels(fm, 3)
    nb = (grid_bytes(groups, dt, need) + grid_bytes([fm], dt)
          + (grid_bytes([residual], dt) if residual is not None else 0)
          + nbytes(w, aff, ws, out.data))
    ops = 2 * 27 * sum(g.real_c for g in groups) * cout * active(fm)
    return nb, ops, peak_of(dt, quantize)


def downconv_work(outs, fg, fm, w, cout, *, aff=None, cpad_out=None,
                  quantize=False, ws=None, impl=None):
    """K2: the input at the active voxels with an affine, else in every
    2^3 block of one."""
    o, om = outs
    dt = fm.data.dtype
    need = voxels(fm) if aff is not None else voxels(fm, 2)
    nb = (grid_bytes([fg], dt, need) + grid_bytes([fm], dt)
          + nbytes(w, aff, ws, o.data, om.data))
    ops = 2 * 8 * fg.real_c * cout * active(om)
    return nb, ops, peak_of(dt, quantize)


def upconv_work(out, groups, cfm, ffm, w, cout, *, aff=None,
                quantize=False, ws=None, impl=None):
    """K3: the coarse groups at the active coarse voxels (an affine) or
    within reach of one; 8 combined taps per fine voxel computed (every
    fine voxel of an active coarse one, or the given fine mask's)."""
    dt = cfm.data.dtype
    need = voxels(cfm) if aff is not None else voxels(cfm, 3)
    nb = (grid_bytes(groups, dt, need) + grid_bytes([cfm], dt)
          + (grid_bytes([ffm], dt) if ffm is not None else 0)
          + nbytes(w, aff, ws, out.data))
    fine = active(ffm) if ffm is not None else 8 * active(cfm)
    ops = 2 * 8 * sum(g.real_c for g in groups) * cout * fine
    return nb, ops, peak_of(dt, quantize)


def head_site_work(outs, up, fm, w, bias, aff, cout, *, fm_scale=1,
                   emit_raw=False, impl=None):
    """K4 gate (and raw): the input at the level's active fine voxels
    (with ``fm_scale`` 2 the children of the coarse mask's), the mask in
    full, every output in full."""
    dt = up.data.dtype
    need = voxels(fm)
    n = active(fm)
    if fm_scale == 2:
        for ax in (1, 2, 3):
            need = need.repeat_interleave(2, ax)
        n *= 8
    nb = (grid_bytes([up], dt, need) + grid_bytes([fm], dt)
          + nbytes(w, bias, aff, *(o.data for o in outs)))
    return nb, 2 * up.real_c * cout * n, peak_of(dt)


def surf_head_packed_work(outs, groups, fm, w, bias, aff, *, impl=None):
    """K5: group s only at the coarse voxels that cover an active fine
    one, the fine mask in full, the dense f32 sdf out (the mask output is
    the fine mask's compare, not K5's)."""
    dt = fm.data.dtype
    act = voxels(fm)
    nb = grid_bytes([fm], dt) + nbytes(w, bias, aff, outs[0])
    for g, s in groups:
        need = act if s == 1 else (
            nnf.max_pool3d(act[:, None].float(), s, s)[:, 0] > 0)
        nb += grid_bytes([g], dt, need)
    ops = 2 * sum(g.real_c for g, _ in groups) * active(fm)
    return nb, ops, peak_of(dt)


def surf_head_fused_work(out, groups, fm, w, bias, aff, *, impl=None):
    """K4 summed: the groups at the active voxels, the mask in full."""
    dt = fm.data.dtype
    nb = (grid_bytes(groups, dt, voxels(fm)) + grid_bytes([fm], dt)
          + nbytes(w, bias, aff, out.data))
    ops = 2 * sum(g.real_c for g in groups) * active(fm)
    return nb, ops, peak_of(dt)


def scatter_work(outs, locs, feats, num_valid, *a, **kw):
    """K6: the valid rows in, both grids out in full; no arithmetic."""
    fg, fm = outs
    return (nbytes(locs[:num_valid], feats[:num_valid], fg.data, fm.data),
            0, peak_of(fg.data.dtype))


def unfold_work(out, fg):
    """The channels-last view's elements, read (their sectors) and
    written once by its consumer."""
    need = torch.ones(out.shape[:4], dtype=torch.bool, device=out.device)
    return (grid_bytes([fg], fg.data.dtype, need) + nbytes(out), 0,
            peak_of(fg.data.dtype))


def upsample2_work(out, fg):
    return nbytes(fg.data, out.data), 0, peak_of(fg.data.dtype)


# family -> (module attribute wrapped, work function); the order the
# families print in
FAMILIES = {
    "conv-site": ("subm_conv_fused", conv_site_work),
    "downconv": ("downconv_fused", downconv_work),
    "upconv": ("upconv_fused", upconv_work),
    "head-site": ("head_site_fused", head_site_work),
    "surf-head-ms": ("surf_head_packed", surf_head_packed_work),
    "head-sum": ("surf_head_fused", surf_head_fused_work),
    "input-scatter": ("scatter_sparse", scatter_work),
    "dense-trunk": ("sharded_trunk", None),
    "unfold": ("unfold", unfold_work),
    "upsample2": ("upsample2_folded", upsample2_work),
}


@dataclasses.dataclass
class Call:
    family: str
    nbytes: int
    ops: float
    peak: float

    @property
    def floor_ms(self) -> float:
        return bound(self.nbytes, self.ops, self.peak)["bound_ms"]


class Recorder:
    """While active, every call of the wrapped entry points runs inside a
    ``roofline::<family>`` profiler range and, with ``price``, appends its
    Call to ``calls`` (a call made inside another wrapped call counts in
    the outer one only); the originals are restored on exit. Pricing runs
    work on the call's device, so a timed or traced run takes
    ``price=False``."""

    def __init__(self, price: bool = True):
        self.price = price
        self.calls: list[Call] = []
        self._depth = 0
        self._saved = []

    def __enter__(self):
        from sgnn_tpu_torch.models import folded_flow as FF
        from sgnn_tpu_torch.ops import folded as FO

        for fam, (attr, work) in FAMILIES.items():
            mod = FF if attr == "sharded_trunk" else FO
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(fam, orig, work))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def _wrap(self, family, orig, work):
        from torch.utils.flop_counter import FlopCounterMode

        @functools.wraps(orig)
        def call(*a, **kw):
            if self._depth:
                return orig(*a, **kw)
            self._depth += 1
            try:
                with torch.profiler.record_function(f"roofline::{family}"):
                    if not self.price:
                        return orig(*a, **kw)
                    if work is None:  # the trunk: count its dense convs
                        with FlopCounterMode(display=False) as fc:
                            out = orig(*a, **kw)
                    else:
                        out = orig(*a, **kw)
                if work is None:
                    x = a[1]
                    leaves = [t for t in out if isinstance(t, torch.Tensor)]
                    priced = (nbytes(x, *leaves), fc.get_total_flops(),
                              peak_of(leaves[0].dtype))
                else:
                    priced = work(out, *a, **kw)
            finally:
                self._depth -= 1
            self.calls.append(Call(family, *priced))
            return out
        return call


def families(calls: list) -> dict:
    """Per family: calls, bytes, operations, bytes_ms, ops_ms and floor_ms
    (the sum of each call's floor)."""
    fams = {}
    for c in calls:
        f = fams.setdefault(c.family, {"calls": 0, "bytes": 0, "ops": 0.0,
                                       "bytes_ms": 0.0, "ops_ms": 0.0,
                                       "floor_ms": 0.0})
        f["calls"] += 1
        f["bytes"] += c.nbytes
        f["ops"] += c.ops
        f["bytes_ms"] += c.nbytes / PEAK_BYTES * 1e3
        f["ops_ms"] += c.ops / c.peak * 1e3
        f["floor_ms"] += c.floor_ms
    return {k: fams[k] for k in FAMILIES if k in fams}


# ----------------------------------------------------------------- tool


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--dims", type=int, nargs=3, default=list(C.SCENE_DIM))
    ap.add_argument("--measure", action="store_true",
                    help="also trace the forward on the card: each "
                         "family's device ms and the roofline share")
    ap.add_argument("--reps", type=int, default=3,
                    help="forwards traced by --measure")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sgnn_roofline"))
    C.device_arg(ap)
    args = ap.parse_args(argv)
    if args.measure and args.cpu:
        ap.error("--measure times the card; it takes no --cpu")
    return args


def main(argv=None) -> dict:
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import synthetic_scene

    args = parse_args(argv)
    device = C.device_of(args, "roofline")
    dims = tuple(args.dims)
    cfg = SGNNConfig(input_dim=dims, batch_size=1,
                     occupancy_fractions=C.FRACTIONS,
                     compute_dtype="bfloat16", quantize_int8=args.int8)
    scene = synthetic_scene(dims, seed=0, truncation=cfg.truncation)
    model, _, seed = C.serving_model(cfg, scene, device)
    locs, feats = C.rows(scene, device)

    def fwd():
        return model(locs, feats, dims)

    with Recorder() as rec:
        fwd()
    fams = families(rec.calls)
    res = {"device": P.device_entry(device), "dims": list(dims),
           "int8": args.int8, "seed": seed, "families": fams,
           "floor_ms": sum(f["floor_ms"] for f in fams.values())}
    if args.measure:
        def reps():
            for _ in range(args.reps):
                fwd()
        # the forward's device time and idle share from a trace without
        # the Recorder's ranges; each family's from a second one with them
        prof = P.profile_window(reps, device, args.out, warm=fwd)
        att = P.attribution(prof, args.reps)
        res["forward_device_ms"] = att["device_ms"]
        res["idle_share"] = P.idle_share(prof)
        with Recorder(price=False):
            ranged = P.profile_window(reps, device, warm=fwd)
        spans = P.range_device_ms(ranged, "roofline::")
        for fam, f in fams.items():
            f["device_ms"] = (spans.get(fam, 0.0) / args.reps
                              if att["device_ms"] != P.NOT_MEASURED
                              else P.NOT_MEASURED)
        res["roofline_share"] = (
            res["floor_ms"] / att["device_ms"]
            if att["device_ms"] != P.NOT_MEASURED else P.NOT_MEASURED)
    _print(res, args)
    return res


def _print(res: dict, args) -> None:
    dt = "int8" if args.int8 else "bf16"
    print(f"# roofline floors @ {tuple(args.dims)} {dt} (HBM "
          f"{PEAK_BYTES / 1e12:.2f} TB/s, {PEAK_BF16 / 1e12:g} TFLOP/s "
          f"bf16, {PEAK_INT8 / 1e12:g} TOP/s int8, {PEAK_F32 / 1e12:g} "
          f"TFLOP/s f32)")
    meas = "device_ms" in next(iter(res["families"].values()))
    print(f"{'family':>14} {'calls':>5} {'GB':>8} {'GFLOP':>9} "
          f"{'bytes_ms':>8} {'ops_ms':>8} {'floor_ms':>8}"
          + (f" {'device_ms':>9}" if meas else ""))
    for name, f in res["families"].items():
        dev = f.get("device_ms")
        print(f"{name:>14} {f['calls']:>5} {f['bytes'] / 1e9:>8.4f} "
              f"{f['ops'] / 1e9:>9.3f} {f['bytes_ms']:>8.4f} "
              f"{f['ops_ms']:>8.4f} {f['floor_ms']:>8.4f}"
              + ("" if not meas else f" {dev:>9.4f}" if isinstance(
                  dev, float) else f" {dev:>9}"))
    fams = res["families"].values()
    print(f"{'TOTAL':>14} {sum(f['calls'] for f in fams):>5} "
          f"{sum(f['bytes'] for f in fams) / 1e9:>8.4f} "
          f"{sum(f['ops'] for f in fams) / 1e9:>9.3f} {'':>8} {'':>8} "
          f"{res['floor_ms']:>8.4f}")
    if "roofline_share" in res:
        share = res["roofline_share"]
        print(f"forward device time {res['forward_device_ms']} ms per "
              f"forward (torch.profiler); roofline share (sum of floors / "
              f"device time) "
              + (f"{share:.4f}" if isinstance(share, float) else share)
              + f"; idle share {res['idle_share']}")
    if res["device"]["platform"] == "gpu":
        print(res["device"]["card"])


if __name__ == "__main__":
    main()
