#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, and only a run
where every phase passed prints the two JSON lines at the end):

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of sgnn_tpu_torch/csrc from the sources, with the
   compiler's registers/spills report;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the serving path gives it (96x192x192 scene; the surface
   head also at 96x192x160), in float32 and bfloat16, with max
   |kernel - plain| beside its tolerance and both times; K8 and K9 on
   grids masked by the scene's sphere shell (C 8/16/32, Cout < C down to
   1, Y != X, K8's input gradient), K10 over the shell's rows (27 and 8
   taps, 16 to 48 inputs, rows with every neighbour missing), the int8
   modes K1q, K2q, K3q and tile_amax with their TPU tiles, all bit-equal
   (each int8 site's kernel and tile_amax also timed apart); K1, K2, K3,
   K7, K8, K1q, K2q and K3q also at the edges of their Hopper designs
   (output bricks of 2 x 4 x 32 voxels: dims off the brick, x-tail slots,
   empty and dense inputs, cpad 8 with narrow groups, K1q's and K3q's TPU
   tiles straddling bricks; K3 and K3q with 1-4 groups, the fine mask
   given and expanded, empty, full and single-voxel masks; K2q with coarse
   rows of 48 and 16 slots and one-row TPU tiles; K8 at X = 128 / C, Cout
   1 to C, an all-zero input and single voxels at brick and volume
   corners; K8's f32 time logged beside its bf16 one; K9 at odd Cin, Cin
   26, 33 and 64, Cout > Cin, an input 2 bytes off a 16-byte boundary,
   all-zero and dense inputs, its C8, C26 and C48 cases timed too; K5
   with 1-4 groups, X = 2 mod 4, cpad 8, batch 2, all-on and all-off
   masks and junk in the coarse x tail blocks), K10 at the seams
   of its row tiles (a row count off the tile, taps and tiles
   with no neighbour, indices outside the table, rows of 2 to 400 bytes,
   channels staged in several units and weights in windows, two column
   groups) and tile_amax at its (empty, full and one-voxel masks in rows
   that two or four windows hold, 1-4 groups, cpad 8 and 16, with and
   without the affine); K4 at its (a thread per 16-byte output chunk,
   warps over grid rows: gate with and without the raw grid, mask_scale 1
   and 2 with 2 xqm == xq and an odd xq, summed over 1 and 4 groups of
   widths 1 and 5 < cpad, cpad 8 and 16, batch 2, Y != X, x-tail slots,
   all-zero, all-ones and -0 masks). Bounds count an input group only in
   the 32-byte sectors of the voxels its function reads, a mask read at
   every voxel and every output in full;
4. forward: the full-width model (L=4, nf 16, bf16, seeded random
   weights) answers three synthetic sphere scenes through
   sgnn_tpu_torch.infer.SceneInferencer; every kernel of that path must
   have been launched in that run (the summed surface head, head_sum, not
   at all); then every kernel call of one forward is held against its
   plain version on the forward's own inputs; one scene runs with
   impl="plain" and the two surfaces are compared, in f32 and bf16; in
   bf16 the plain forward also runs a second time on the card and once on
   the host CPU, which shows how far the surface moves with no
   hand-written kernel involved; one scene runs through the summed surface
   head (surf_pack=False, head_sum's path); and with cuDNN at PyTorch's
   process defaults, two kernel forwards of one scene must give the same
   bits and the dense trunk's f32 output must match the host CPU's;
5. serve: three reference-format scenes (.sdf/.knw) and a .ckpt written
   by the port go through the CLI, sgnn_tpu_torch.tools.test_scene, on
   the card; every scene must get an input mesh and a non-empty predicted
   mesh inside its bounds, and the multi-scale surface head one launch;
   the CLI again with --execution sparse (the coordinate lists, K10 51
   times per scene, nothing else);
   then each scene's stages (read, forward, meshing) are timed one after
   another, and every kernel call of the rooms' forwards (padded shapes
   with Y != X) is held against its plain version on its own inputs;
6. secondary: the phase-4 weights and scene through the coordinate-list
   execution (GenModelSparse, capacities from the folded forward's active
   voxels so nothing overflows) and the dense-flow execution
   (GenModelDense with use_pallas_conv, at the default pallas_min_voxels
   and at 0) via SceneInferencer; K10's and K8's launches per forward
   required as derived (SECONDARY), the shapes of K10's calls (taps,
   widths, rows, present neighbours) logged, every call of one forward held
   against its plain version; in f32 the surfaces of the folded, dense-
   flow and both coordinate-list backends compared on the card; in bf16
   each execution's kernels against its plain versions on the card and
   on the host CPU; ms per forward and peak memory per execution;
7. train: synthetic .sdfs chunks (128x64x64, cut from box rooms) written
   by the port; one full-level f32 train step with the kernels and one
   with the plain versions from the same weights and batch (loss,
   gradients, running stats compared); one bf16 step at full width and
   batch 8 whose every kernel call is held against its plain version,
   with each kernel's launches per step required, and a profile of it
   (each hand-written kernel's device time); the training CLI,
   sgnn_tpu_torch.tools.train, in-process for 12 steps on one chunk (the
   reference's overfit mode), whose loss must fall over the full-level
   steps and whose .ckpt must load into the serving model and serve a
   room; ms per step with kernels and with plain versions, samples/s and
   peak device memory;
8. int8: the phase-4 weights and scenes through the int8 serving
   forward (cfg.quantize_int8: K1q, K2q and K3q at every conv, down and
   upsample site, each after one tile_amax scale pre-pass) via
   SceneInferencer; launches per forward required as derived
   (INT8_EXPECTED, no exact K1-K3 launch), every kernel call of one
   forward held against its plain version (K1q, K2q, K3q bit-equal), the
   f32 surfaces of kernels and plain versions compared (IoU >= 0.999), the
   bf16 surface against the plain int8 run and the exact forward; ms per
   forward, a profile of each forward and peak device memory (this phase
   runs after phase 4);
9. drive: the port's whole loop from data to score with its CLIs:
   three rooms from sgnn_tpu_torch.tools.make_synthetic_scenes, fused at
   2 cm by generate_scans and cut into 128x64x64 chunks by make_chunks
   on the host (seconds and counts of each stage); 4 bf16 training steps
   at full width and batch 8 on the card through the training CLI; its
   .ckpt to a reference .pth and back through convert_checkpoint (the
   trees bit-equal); the evaluate CLI on the rooms, folded and
   --execution sparse, with the trained weights and with phase 5's
   (which leave a surface): launches and ms per scene, each scene's
   metrics (finite; -1 exactly where a scene has no surface), every
   kernel call held against its plain version; and the f32 evaluation of
   the smallest room (cut to 64 voxels in z) on the card and on the host
   CPU (--cpu): the same surface, the metrics within 1e-5;
10. the card's name and power limit again, a JSON line of per-kernel
   results (launches, error, ms against the plain version and against one
   PyTorch call where one computes the same function, and the card's bound
   for the same work), then the status line {"ok": true, "device": {...}}.

Imports torch, numpy and sgnn_tpu_torch only. Needs one card; fails when
torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SCENE = (96, 192, 192)  # bench.py:41, a 2 cm mp-rooms-sized room
K5_DIMS = (96, 192, 160)  # a second surface-head case with Y != X
FRACTIONS = (1.0, 0.4, 0.2, 0.1)
N_SCENES = 3
# expected launches per forward at L=4 on the main path (the TPU kernels'
# per-forward call counts of the same path); the summed surface head runs
# only with surf_pack=False, once per forward
EXPECTED = {"conv_site": 37, "downconv": 11, "upconv": 3, "head_gate": 3,
            "head_gate_raw": 0, "head_sum": 0, "surf_head": 1, "scatter": 1,
            "conv_raw": 0, "conv3d_folded": 0, "conv3d": 0,
            "gather_gemm": 0, "conv_site_q": 0, "downconv_q": 0,
            "upconv_q": 0, "tile_amax": 0}
# the int8 forward (cfg.quantize_int8, phase 8), derived from the JAX
# forward, which passes quantize=q8 to every conv, down and upsample site
# (sgnn_tpu/models/folded_flow.py:61-121, 247-271, 320-324): the same 37 /
# 11 / 3 sites run their int8 modes, each after one tile_amax launch
# (37 + 11 + 3 = 51), and no exact K1-K3 runs
INT8_EXPECTED = dict(EXPECTED, conv_site=0, downconv=0, upconv=0,
                     conv_site_q=37, downconv_q=11, upconv_q=3,
                     tile_amax=51)
SOURCES = {
    "conv_site": ("sgnn_tpu_torch/csrc/conv_site.cu",
                  "sgnn_tpu/ops/pallas/conv3d_folded.py:593"),
    "downconv": ("sgnn_tpu_torch/csrc/downconv.cu",
                 "sgnn_tpu/ops/pallas/conv3d_folded.py:1375"),
    "upconv": ("sgnn_tpu_torch/csrc/upconv.cu",
               "sgnn_tpu/ops/pallas/conv3d_folded.py:1055"),
    "head_gate": ("sgnn_tpu_torch/csrc/head.cu",
                  "sgnn_tpu/ops/pallas/conv3d_folded.py:1687"),
    "head_gate_raw": ("sgnn_tpu_torch/csrc/head.cu",
                      "sgnn_tpu/ops/pallas/conv3d_folded.py:1687"),
    "head_sum": ("sgnn_tpu_torch/csrc/head.cu",
                 "sgnn_tpu/ops/pallas/conv3d_folded.py:1687"),
    "surf_head": ("sgnn_tpu_torch/csrc/surf_head.cu",
                  "sgnn_tpu/ops/pallas/conv3d_folded.py:1975"),
    "scatter": ("sgnn_tpu_torch/csrc/scatter.cu",
                "sgnn_tpu/ops/pallas/scatter_folded.py:92"),
    "conv_raw": ("sgnn_tpu_torch/csrc/conv_raw.cu",
                 "sgnn_tpu/ops/pallas/conv3d_folded.py:213"),
    "conv3d_folded": ("sgnn_tpu_torch/csrc/conv3d_cl.cu",
                      "sgnn_tpu/ops/pallas/conv3d_folded.py:178"),
    "conv3d": ("sgnn_tpu_torch/csrc/conv3d_cl.cu",
               "sgnn_tpu/ops/pallas/conv3d.py:77"),
    "gather_gemm": ("sgnn_tpu_torch/csrc/gather_gemm.cu",
                    "sgnn_tpu/ops/pallas/gather_gemm.py:62"),
    "conv_site_q": ("sgnn_tpu_torch/csrc/conv_site.cu",
                    "sgnn_tpu/ops/pallas/conv3d_folded.py:593 (int8 body "
                    ":413-451)"),
    "downconv_q": ("sgnn_tpu_torch/csrc/downconv.cu",
                   "sgnn_tpu/ops/pallas/conv3d_folded.py:1375 (int8 body "
                   ":1228-1264)"),
    "upconv_q": ("sgnn_tpu_torch/csrc/upconv.cu",
                 "sgnn_tpu/ops/pallas/conv3d_folded.py:1055 (int8 body "
                 ":868-923)"),
    "tile_amax": ("sgnn_tpu_torch/csrc/quant.cu",
                  "sgnn_tpu/ops/pallas/conv3d_folded.py:419-421, 875-876, "
                  "1231-1233 (the int8 bodies' per-tile amax)"),
}
# the secondary executions (phase 6) on the phase-4 scene, launches per
# forward derived from the code at L = 4 (models/sgnn.py, nn/blocks.py,
# models/dense_flow.py):
# - coordinate lists, conv_backend "gather": every sparse conv is one K10
#   call: the encoder 3 x (p1, 2 resblock, p3 down) = 12, the refinements
#   3 x (p1, U-Net 8, n1) = 30, the surface head p1 + U-Net 8 = 9;
# - dense flow with use_pallas_conv at the default pallas_min_voxels
#   (1,000,000): only the 96x192x192 level passes, where K8 takes encoder
#   level 0's two resblock convs (C = 8), the 16-wide group of the
#   surface p1 and the surface U-Net's top resblock (C = 16); its 2-wide
#   (C not 8/16/32) and 8-wide (Cout 16 > Cin 8) groups stay plain;
# - at pallas_min_voxels = 0 every conv supported() admits: X % (128 / C)
#   with X = 192 / 96 / 48 / 24 / 12 / 6 per level: encoder 2 + 2 (the
#   12-wide level 1 none), refinement 0 (1/8) p1 2 + U-Net 2, refinement
#   1 p1 2 + U-Net 4, refinement 2 p1 1 + U-Net 6, surface p1 1 + U-Net 6
#   = 28; K9 is on no path.
SECONDARY = {"gather_gemm": 51, "conv3d_folded": 5}
K8_ALL_LEVELS = 28
# capacity headroom of the coordinate-list run over the folded forward's
# active voxels per level (the executions agree in f32; in bf16 the gate
# cascade may open more), so that nothing overflows
CAP_HEADROOM = 4
# the card's peaks for the bound of a kernel's timed (bf16) case: NVIDIA's
# H100 SXM data sheet, dense bf16 tensor rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the same data sheet's dense int8 tensor rate (the int8 sites' products)
# and f32 rate outside the tensor cores (tile_amax's compares)
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
# training: the JAX package's training configuration at full width
# (SGNNConfig defaults, tools/train.py: 128x64x64 chunks, batch 8)
TRAIN_DIMS = (128, 64, 64)
TRAIN_BATCH = 8
N_CHUNKS = 24
# f32 train step, kernels vs plain versions: the loss to 1e-4 relative,
# the running stats to 1e-4 of their scale; gradients (|a - b| / max |b|
# per parameter, the largest and the median over parameters) to 5e-3, or
# to twice what the plain step itself moves when its input features move
# by one f32 rounding, where that is more: the loss is not smooth (hard
# gates and ReLUs), so two f32 summation orders agree only that far
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 5e-3
TRAIN_STATS_REL = 1e-4
# tolerances of kernel vs plain (same inputs, same rounding points; only
# the f32 summation order differs): f32 outputs 1e-4 of the output scale;
# bf16 outputs 2 bf16 ulps of the output scale; gate flips (an occupancy
# logit within f32 rounding of 0) at most max(2, 1e-4 * active voxels)
F32_REL = 1e-4
BF16_ULPS = 2
# int8 sites, kernel vs plain: both quantize the same f32 values with the
# same scales and sum integers exactly, so only the f32 dequantization
# sums can round apart (and flip no int8 value); still, every value is
# held to its tolerance plus one activation step and at least this share
# to the tolerance alone (tests/test_torch_int8.py's bound against JAX)
Q_MIN_CLOSE = 0.999
FLIP_FRAC = 1e-4
# forward, kernels vs plain on one scene. f32: the surfaces agree (IoU and
# max |sdf diff| on the common surface relative to the sdf scale). bf16:
# with random weights many occupancy logits sit near 0, and a 1-ulp
# difference from another f32 summation order flips coarse gates that then
# grow into regions: the plain forward on the card and on the host CPU,
# with no hand-written kernel in either, agree only to IoU 0.81645 on
# scene 0 (PERF.md, Findings). The kernels' surface is held against both
# plain runs just below that reading; each bf16 kernel call is also checked
# on the main path's own inputs.
MIN_IOU_F32 = 0.999
MAX_SDF_REL_F32 = 1e-3
MIN_IOU_BF16 = 0.81
# the secondary executions' bf16 surfaces: the plain versions' agreement
# with themselves is itself one draw of the gate cascade (card vs host
# CPU 0.75 for the dense flow, 0.98 for the coordinate lists on an H100,
# PERF.md), so the kernels get this much slack below it
BF16_IOU_SLACK = 0.1
# the summed surface head against the multi-scale one on one scene: same
# mask, sdf within f32 summation order (1e-4 of the sdf scale)
MAX_SDF_REL_SURF = 1e-4
# the dense trunk in f32 on the card against the host CPU: cuDNN in full
# f32 (no TF32), relative to the output's scale
MAX_TRUNK_REL = 1e-5
# serve: reference-format scenes whose dims are not multiples of 32 (the
# dataset pads them and the inferencer crops back), one taller than
# max_input_height (128, cropped in z)
SERVE_DIMS = ((90, 181, 170), (128, 210, 150), (150, 160, 140))


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ------------------------------------------------------------------ phase 1


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0: {name}; {torch.cuda.device_count()} device(s)")
    log(card)  # name, power.limit exactly as nvidia-smi prints them
    # plain versions are references: full f32 in cuDNN and matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"kind": name, "count": torch.cuda.device_count(), "card": card}


# ------------------------------------------------------------------ phase 2


def phase_build() -> None:
    from sgnn_tpu_torch.ops.kernels import build

    t0 = time.time()
    path = build.build()
    build.lib()
    log(f"[build] {path.name} from {len(build.sources())} sources in "
        f"{time.time() - t0:.1f} s")
    for line in build.ptxas_log.splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            log(f"[build] {line.strip()}")


# ------------------------------------------------------------------ phase 3


def _shell(dims, width):
    """[1, Z, Y, X] bool: voxels within ``width`` of the scene's sphere."""
    Z, Y, X = dims
    z, y, x = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                          indexing="ij")
    d = np.sqrt((z - Z / 2) ** 2 + (y - Y / 2) ** 2 + (x - X / 2) ** 2)
    return torch.from_numpy(np.abs(d - 0.35 * min(dims)) < width)[None]


def _time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _log_ms(name, label, make, dtypes) -> None:
    """Logs a kernel's and its plain version's times on make(dt)'s inputs,
    beside the one case per kernel that the results keep."""
    for dt in dtypes:
        call = make(dt)
        tk = _time_ms(lambda: call(None))
        tp = _time_ms(lambda: call("plain"))
        log(f"[kernels] {name} {label} {str(dt)[6:]}: kernel {tk:.3f} ms, "
            f"plain {tp:.3f} ms")


def _device_ms(kernels, call, reps: int = 5, tries: int = 3):
    """torch.profiler's device time per call of each of ``kernels`` (CUDA
    names, csrc/*.cu) over ``reps`` calls of call(None), where a wrapper's
    CUDA-event time is host-bound. The profiler now and then records no
    device events in a session; a timing, not a check, so it tries again,
    and returns None after ``tries`` sessions without every kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call(None)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call(None)
            torch.cuda.synchronize()
        got = [0.0] * len(kernels)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for i, k in enumerate(kernels):
                if f"::{k}<" in e.key:
                    got[i] += e.self_device_time_total
        if all(t > 0 for t in got):
            return [t / 1e3 / reps for t in got]
    return None


def _ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16's unit in the last place at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _tol(ref: torch.Tensor, got: torch.Tensor,
         resid: torch.Tensor | None = None):
    """Tolerance of a kernel output ``got`` against its plain version's
    ``ref``: f32, F32_REL of the output's scale (with ``resid``, a residual
    added after the kernel's rounding, of the output's plus the residual's
    scale); bf16, BF16_ULPS ulps at the output's scale. A bf16 output with
    a residual rounds twice, round(round(acc * m) + r), so elementwise:
    the two inner roundings of nearly equal f32 sums are equal or
    adjacent, one ulp apart at their magnitude, which is at most
    (max(|got|, |ref|) + |r|) (1 + 2^-7); each outer rounding moves its
    sum by at most half an ulp of its result. That bound is capped at
    BF16_ULPS ulps of the output's plus the residual's scale, so it is
    never looser than the scalar one."""
    extra = float(resid.abs().max()) if resid is not None else 0.0
    if ref.dtype != torch.bfloat16:
        return F32_REL * (float(ref.abs().max()) + extra) + 1e-6
    scalar = float(BF16_ULPS * _ulp_bf16(
        torch.tensor(float(ref.abs().max()) + extra)))
    if resid is None:
        return scalar
    k, p, r = got.float(), ref.float(), resid.float()
    inner = (torch.maximum(k.abs(), p.abs()) + r.abs()) * (1 + 2.0 ** -7)
    return (_ulp_bf16(inner) + 0.5 * (_ulp_bf16(k) + _ulp_bf16(p))
            ).clamp_max(scalar)


def _interior(t):
    return t[:, 1:-1, 1:-1]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _voxels(mask, reach: int = 0) -> torch.Tensor:
    """[B, Z, Y, X] bool: the voxels of a folded mask grid that are active,
    or, with ``reach`` 3, within a 3^3 conv's reach of one, with 2, in the
    2^3 block of one (a stride-2 conv's coarse voxel)."""
    from torch.nn import functional as nnf

    from sgnn_tpu_torch.ops import folded as FO

    a = FO.unfold(mask)[..., 0] != 0
    if reach == 3:
        a = nnf.max_pool3d(a[:, None].float(), 3, 1, 1)[:, 0] > 0
    elif reach == 2:
        a = nnf.max_pool3d(a[:, None].float(), 2, 2)[:, 0] > 0
        a = a.repeat_interleave(2, 1).repeat_interleave(2, 2) \
            .repeat_interleave(2, 3)
    return a


def _grid_bytes(grids, dt, need=None) -> int:
    """Bytes of folded grids, held in ``dt``, that a kernel must read: each
    grid in full or, with ``need`` ([B, Z, Y, X] bool), only the 32-byte
    sectors (the card's smallest memory access) that hold a real channel
    of a voxel it marks."""
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


def _active(grid, cpad) -> int:
    """Voxels of a folded mask grid whose value is non-zero."""
    return int((_slots(grid, cpad)[..., 0] != 0).sum())


def _bound(nbytes: int, flops: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time for the work on the card: the larger of the bytes
    over its memory rate and the operations over the rate of their type
    (``peak``: bf16 by default)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _library_conv(dense_shape, cout, k, stride=1, padding=0,
                  transpose=False):
    """dt -> one cuDNN call (F.conv3d or F.conv_transpose3d under the
    port's trunk flags) over a dense [B, C, Z, Y, X] tensor."""
    import torch.nn.functional as nnf

    from sgnn_tpu_torch.ops import dense

    def make(dt):
        x = torch.randn(*dense_shape, device="cuda").to(dt)
        cin = dense_shape[1]
        w = torch.randn(*((cin, cout) if transpose else (cout, cin)),
                        k, k, k, device="cuda").to(dt)
        fn = nnf.conv_transpose3d if transpose else nnf.conv3d

        def call():
            with torch.backends.cudnn.flags(**dense._CUDNN):
                return fn(x, w, stride=stride, padding=padding)
        return call
    return make


def _slots(t, cpad):
    """[..., xq, 128] -> [..., xq * F, cpad]: one row per voxel."""
    return t.reshape(*t.shape[:-2], -1, cpad)


def _compare(what, outs_k, outs_p, values, masks=(), gate_cpad=0,
             resid=None, dense=False, step=0.0):
    """Checks kernel outputs against the plain version's: zero z/y rings,
    ``masks`` outputs equal, ``values`` outputs within tolerance (_tol;
    ``resid``: the residual added to output 0). With ``gate_cpad`` output
    2 is an occupancy gate at that lane budget (the gated head's new
    mask): its flips must fit the budget and values are compared where
    the two gates agree. ``dense``: the outputs have no halo ring ([B, Z,
    Y, X] arrays, or K7's unpadded grid). ``step``: an int8 site's
    activation step (one int8 value moved by one): every value within its
    tolerance plus the step, at most 1 - Q_MIN_CLOSE of them beyond the
    tolerance. Returns (max err, its largest share of the tolerance,
    flips, active, values beyond the tolerance)."""
    agree, flips, active = None, 0, 0
    if gate_cpad:
        gk, gp = (_slots(_interior(o[2]), gate_cpad)[..., 0] > 0
                  for o in (outs_k, outs_p))
        flips, active = int((gk != gp).sum()), int(gp.sum())
        budget = max(2, int(FLIP_FRAC * active))
        require(flips <= budget,
                f"{what}: {flips} gate flips > budget {budget}")
        agree = (gk == gp)[..., None]
    for i in masks:
        require(torch.equal(outs_k[i], outs_p[i]),
                f"{what}: mask output {i} differs")
    for k in () if dense else outs_k:
        ring = torch.cat([k[:, [0, -1]].flatten(), k[:, :, [0, -1]].flatten()])
        require(not ring.any(), f"{what}: nonzero halo ring")
    err, ratio, beyond = 0.0, 0.0, 0
    for i in values:
        k, p = outs_k[i], outs_p[i]
        r = resid if i == 0 else None
        if not dense:
            k, p = _interior(k), _interior(p)
            r = _interior(r) if r is not None else None
        d = (k.float() - p.float()).abs()
        tol = _tol(p, k, r)
        if agree is not None:
            d = _slots(d, gate_cpad) * agree
            tol = _slots(tol, gate_cpad) if torch.is_tensor(tol) else tol
        e = float(d.max())
        n_far = int((d > tol).sum())
        q = float((d / (tol + step)).max())
        require(np.isfinite(e) and q <= 1.0,
                f"{what}: max err {e}, {q:.3f} of its tolerance"
                + (f" plus one activation step {step:.3e}" if step else ""))
        require(n_far <= (1 - Q_MIN_CLOSE) * d.numel(),
                f"{what}: {n_far} of {d.numel()} values beyond the "
                f"tolerance")
        err, ratio, beyond = max(err, e), max(ratio, q), beyond + n_far
    return err, ratio, flips, active, beyond


class KernelChecks:
    """Phase 3: one case per kernel mode at main-path shapes."""

    def __init__(self):
        from sgnn_tpu_torch.ops import folded as FO

        self.FO = FO
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.fine = _shell(SCENE, 4.0)
        self.coarse = _shell(tuple(d // 2 for d in SCENE), 2.0)
        self.results = {}

    def grid(self, dims, c, cpad, mask):
        d = torch.randn(1, *dims, c, device=self.dev, generator=self.gen)
        return self.FO.fold(d * mask.to(self.dev)[..., None], cpad)

    def mask(self, m, cpad):
        return self.FO.fold_mask(m.to(self.dev), cpad, torch.float32)

    def weights(self, *shape):
        return (0.2 * torch.randn(*shape, generator=torch.Generator()
                                  .manual_seed(sum(shape)))).numpy()

    def affines(self, widths):
        g = torch.Generator().manual_seed(len(widths))
        c = sum(widths)
        p = {"scale": (0.5 + torch.rand(c, generator=g)).numpy(),
             "bias": (0.3 * torch.randn(c, generator=g)).numpy()}
        s = {"mean": (0.3 * torch.randn(c, generator=g)).numpy(),
             "var": (0.5 + torch.rand(c, generator=g)).numpy()}
        return self.FO.prep_affines(p, s, widths).to(self.dev)

    def run(self, name, label, make, values, masks=(), gate_cpad=0,
            resid=None, dense=False, work=None, library=None,
            dtypes=(torch.float32, torch.bfloat16), step=None,
            peak=PEAK_BF16_FLOPS, exact=False, split=False):
        """make(dt) -> call(impl) -> output grids, inputs converted once;
        compared as _compare does (``resid``: the residual grid; ``step``:
        dt -> an int8 site's activation step). The kernel's first bf16
        case is timed against its plain version and, with ``library``
        (dt -> a call), one PyTorch call computing the same function;
        ``work(dt)`` gives that case's (bytes each input read once and
        each output written once, operations its data needs, of the type
        whose rate is ``peak``), from which the card's bound follows.
        ``exact``: the kernel must give the plain version's bits.
        ``split``: an int8 site; its bf16 case also logs the wrapper's two
        launches timed apart (_device_ms)."""
        for dt in dtypes:
            call = make(dt)
            outs_k, outs_p = call(None), call("plain")
            what = f"{name} {label} {str(dt)[6:]}"
            r = resid.data.to(dt) if resid is not None else None
            st = step(dt) if step is not None else 0.0
            err, ratio, flips, active, far = _compare(
                what, outs_k, outs_p, values, masks, gate_cpad, r, dense,
                st)
            require(not exact or err == 0.0,
                    f"{what}: max |kernel - plain| {err}, expected 0")
            if gate_cpad:
                log(f"[kernels] {what}: gate flips {flips} of {active} "
                    f"active")
            del outs_k, outs_p
            rec = self.results.setdefault(name, {"max_abs_err": 0.0})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            msg = (f"max |kernel - plain| {err:.3e} ({ratio:.2f} of its "
                   f"tolerance" + (f" plus one activation step {st:.3e}; "
                                   f"{far} values beyond the tolerance"
                                   if step is not None else "") + ")")
            if dt == torch.bfloat16 and "ms" not in rec:
                # alternate plain, kernel, kernel, plain on the same inputs
                tp1 = _time_ms(lambda: call("plain"))
                tk1 = _time_ms(lambda: call(None))
                tk2 = _time_ms(lambda: call(None))
                tp2 = _time_ms(lambda: call("plain"))
                rec["ms"], rec["plain_ms"] = (tk1 + tk2) / 2, (tp1 + tp2) / 2
                msg += (f"; kernel {rec['ms']:.3f} ms, plain "
                        f"{rec['plain_ms']:.3f} ms")
                rec["library_ms"] = None
                if library is not None:
                    lib = library(dt)
                    rec["library_ms"] = _time_ms(lib)
                    msg += f", one PyTorch call {rec['library_ms']:.3f} ms"
                outs = call(None)
                nbytes, flops = work(dt)
                nbytes += _nbytes(*outs)
                del outs
                rec.update(_bound(nbytes, flops, peak))
                msg += (f"; bound {rec['bound_ms']:.4f} ms by "
                        f"{rec['bound_by']} ({nbytes / 1e6:.1f} MB, "
                        f"{flops / 1e9:.2f} G operations at "
                        f"{peak / 1e12:g} T/s)")
            log(f"[kernels] {name} {label} {str(dt)[6:]}: {msg}")
            if split and dt == torch.bfloat16:
                wrapper = _time_ms(lambda: call(None))
                apart = _device_ms([f"{name}_kernel", "tile_amax_kernel"],
                                   call)
                log(f"[kernels] {name} {label} bfloat16 split: wrapper "
                    f"{wrapper:.4f} ms (CUDA events, with its tile_amax); "
                    + ("device times not measured (no device events in "
                       "three profiles)" if apart is None else
                       f"device time per call (torch.profiler, 5 calls): "
                       f"{name}_kernel alone {apart[0]:.4f} ms, tile_amax "
                       f"{apart[1]:.4f} ms"))

    def all(self):
        FO, fine, coarse = self.FO, self.fine, self.coarse
        cd = tuple(d // 2 for d in SCENE)
        log(f"[kernels] masks: {int(fine.sum())} of {fine.numel()} fine "
            f"voxels active, {int(coarse.sum())} of {coarse.numel()} coarse")

        def cast(fg, dt):
            return fg.with_data(fg.data.to(dt))

        # K1 at the finest level: cpad 16, 3 groups, affine and residual
        widths = [16, 2, 8]
        fm16 = self.mask(fine, 16)
        g16 = [self.grid(SCENE, c, 16, fine) for c in widths]
        res16 = self.grid(SCENE, 16, 16, fine)
        w = FO.prep_conv_weights(self.weights(27, 26, 16), widths,
                                 torch.float32).to(self.dev)
        aff = self.affines(widths)

        def conv16(dt):
            grp, m, r = [cast(g, dt) for g in g16], cast(fm16, dt), \
                cast(res16, dt)
            return lambda impl: (FO.subm_conv_fused(
                grp, m, w, 16, aff=aff, residual=r, impl=impl).data,)
        n16 = _active(fm16.data, 16)
        act16 = _voxels(fm16)

        def conv16_work(dt):
            # the groups only at active voxels (relu(.) * 0 elsewhere); the
            # mask and the residual in full
            return (_grid_bytes(g16, dt, act16) + _grid_bytes(
                [fm16, res16], dt) + _nbytes(w, aff),
                    2 * 27 * sum(widths) * 16 * n16)
        self.run("conv_site", "cpad16 G3 affine+residual", conv16, [0],
                 resid=res16, work=conv16_work,
                 library=_library_conv((1, sum(widths), *SCENE), 16, 3,
                                       padding=1))

        # K1 at level 0: cpad 8
        fm8 = self.mask(fine, 8)
        x8 = self.grid(SCENE, 8, 8, fine)
        w8 = FO.prep_conv_weights(self.weights(27, 8, 8), [8],
                                  torch.float32).to(self.dev)
        aff8 = self.affines([8])

        def conv8(dt):
            x, m = cast(x8, dt), cast(fm8, dt)
            return lambda impl: (FO.subm_conv_fused(
                [x], m, w8, 8, aff=aff8, residual=x, impl=impl).data,)
        self.run("conv_site", "cpad8 G1 affine+residual", conv8, [0],
                 resid=x8)

        # K2 cross mode at level 0 (cpad 8 -> 16), and the plain mode
        wd = FO.prep_downconv_weights(self.weights(8, 8, 8), 8,
                                      torch.float32).to(self.dev)

        def down_cross(dt):
            x, m = cast(x8, dt), cast(fm8, dt)

            def call(impl):
                o, om = FO.downconv_fused(x, m, wd, 8, cpad_out=16,
                                          impl=impl)
                return o.data, om.data
            return call
        def down_cross_work(dt):
            o, om = down_cross(dt)(None)
            # no affine: the input in every 2^3 block of an active voxel
            return (_grid_bytes([x8], dt, _voxels(fm8, 2))
                    + _grid_bytes([fm8], dt) + _nbytes(wd),
                    2 * 8 * 8 * 8 * _active(om, 16))
        self.run("downconv", "cross cpad8->16", down_cross, [0], masks=[1],
                 work=down_cross_work,
                 library=_library_conv((1, 8, *SCENE), 8, 2, stride=2))
        wd16 = FO.prep_downconv_weights(self.weights(8, 16, 16), 16,
                                        torch.float32).to(self.dev)
        affd = self.affines([16])[0]

        def down16(dt):
            x, m = cast(g16[0], dt), cast(fm16, dt)

            def call(impl):
                o, om = FO.downconv_fused(x, m, wd16, 16, aff=affd,
                                          impl=impl)
                return o.data, om.data
            return call
        self.run("downconv", "cpad16 affine", down16, [0], masks=[1])
        self.edge_cases()

        # K3 from the 48x96x96 coarse level, 3 groups, fine mask expanded
        cfm = self.mask(coarse, 16)
        cg = [self.grid(cd, 16, 16, coarse) for _ in range(3)]
        wu = FO.prep_upconv_weights(self.weights(27, 48, 16), [16] * 3,
                                    torch.float32).to(self.dev)
        affu = self.affines([16] * 3)

        def up(dt):
            grp, m = [cast(g, dt) for g in cg], cast(cfm, dt)
            return lambda impl: (FO.upconv_fused(
                grp, m, None, wu, 16, aff=affu, impl=impl).data,)
        def up_work(dt):
            return (_grid_bytes(cg, dt, _voxels(cfm)) + _grid_bytes(
                [cfm], dt) + _nbytes(wu, affu),
                    2 * 8 * 48 * 16 * 8 * _active(cfm.data, 16))
        self.run("upconv", "G3 fmask=None", up, [0], work=up_work,
                 library=_library_conv((1, 48, *cd), 16, 4, stride=2,
                                       padding=1, transpose=True))
        self.k3_edge_cases()

        # K4 gated at the finest level, mask from the coarse level
        wh = FO.prep_head_weights(self.weights(16, 2), [16],
                                  torch.float32)[0].to(self.dev)
        bh = FO.prep_bias(np.array([0.1, -0.2], np.float32)).to(self.dev)
        affh = self.affines([16])[0]
        upg = self.grid(SCENE, 16, 16, fine)

        def gate(dt):
            u, m = cast(upg, dt), cast(cfm, dt)

            def call(impl):
                outs = FO.head_site_fused(u, m, wh, bh, affh, 2, fm_scale=2,
                                          impl=impl)
                return tuple(o.data for o in outs)
            return call
        # the input only at the fine voxels of active coarse ones, the
        # coarse mask in full (read at every fine voxel)
        act_up = _voxels(cfm)
        for ax in (1, 2, 3):
            act_up = act_up.repeat_interleave(2, ax)

        def gate_work(dt):
            return (_grid_bytes([upg], dt, act_up) + _grid_bytes([cfm], dt)
                    + _nbytes(wh, bh, affh),
                    2 * 16 * 2 * 8 * _active(cfm.data, 16))
        self.run("head_gate", "mask_scale 2", gate, [0, 1], gate_cpad=16,
                 work=gate_work)

        # K4 summed (the surface head), 3 groups
        ws = FO.prep_head_weights(self.weights(48, 1), [16] * 3,
                                  torch.float32).to(self.dev)
        bs = FO.prep_bias(np.array([0.05], np.float32)).to(self.dev)
        affs = self.affines([16] * 3)

        def surf(dt):
            grp, m = [cast(g, dt) for g in (g16[0], res16, upg)], \
                cast(fm16, dt)
            return lambda impl: (FO.surf_head_fused(
                grp, m, ws, bs, affs, impl=impl).data,)
        def surf_work(dt):
            # the groups only at active voxels, the mask in full
            return (_grid_bytes([g16[0], res16, upg], dt, act16)
                    + _grid_bytes([fm16], dt) + _nbytes(ws, bs, affs),
                    2 * 48 * n16)
        self.run("head_sum", "G3", surf, [0], work=surf_work)

        # K5 at the serving shapes: groups at scales 1/2/4 (the surface
        # U-Net's levels, each masked by a shell at its resolution), the
        # fine mask, dense f32 sdf out; then with Y != X, where a swapped
        # y/x stride or row length would show. The coarse grids' x tail-pad
        # blocks (xq_g > ceil(xq / s)) are filled with junk the kernel must
        # not read
        from sgnn_tpu_torch.ops.kernels import surf_head as K_surf

        for dims in (SCENE, K5_DIMS):
            fm = self.mask(_shell(dims, 4.0), 16)
            packed = []
            for s, width in ((1, 4.0), (2, 2.0), (4, 1.0)):
                sd = tuple(d // s for d in dims)
                g = self.grid(sd, 16, 16, _shell(sd, width))
                live = -(-fm.data.shape[3] // s)
                if g.data.shape[3] > live:
                    g.data[:, :, :, live:] = 7.0
                packed.append(g)
            label = "x".join(map(str, dims))
            log(f"[kernels] surf_head {label} groups: x blocks "
                f"{[g.data.shape[3] for g in packed]} for "
                f"{fm.data.shape[3]} fine blocks")

            def surf_ms(dt, packed=packed, fm=fm, dims=dims):
                grp, m = [cast(g, dt).data for g in packed], cast(fm, dt)
                return lambda impl: (K_surf.surf_head(
                    grp, [1, 2, 4], m.data, ws, bs, affs, [16] * 3, 16,
                    dims, impl=impl),)
            def surf_ms_work(dt, packed=packed, fm=fm):
                # group s only at the coarse voxels that cover an active
                # fine one, the fine mask in full
                from torch.nn import functional as nnf

                act = _voxels(fm)
                need = [act] + [nnf.max_pool3d(act[:, None].float(), s, s)[
                    :, 0] > 0 for s in (2, 4)]
                return (sum(_grid_bytes([g], dt, n)
                            for g, n in zip(packed, need))
                        + _grid_bytes([fm], dt) + _nbytes(ws, bs, affs),
                        2 * 48 * _active(fm.data, 16))
            self.run("surf_head", f"{label} G3 scales 1/2/4", surf_ms, [0],
                     dense=True, work=surf_ms_work)
            # the wrapper's checks take about as long as the kernel, so
            # its CUDA-event time is partly the host's
            dev = _device_ms(["surf_head_kernel"], surf_ms(torch.bfloat16))
            log(f"[kernels] surf_head {label} G3 scales 1/2/4 bfloat16: "
                + ("device time not measured (no device events in three "
                   "profiles)" if dev is None else
                   f"device time per call (torch.profiler, 5 calls) "
                   f"{dev[0]:.4f} ms"))
        self.k5_edge_cases(bs)

        # K6: the sphere scene's input rows into the level-0 grids (cpad 8);
        # kernel and plain version must agree bit for bit
        from sgnn_tpu_torch.infer import synthetic_scene

        sc = synthetic_scene(SCENE, seed=0, truncation=3.0)
        locs, feats = _rows(sc)

        def scat(dt):
            def call(impl):
                fg, fm = FO.scatter_sparse(locs, feats, len(locs), SCENE, 1,
                                           cpad=8, dtype=dt, feat_bound=3.0,
                                           impl=impl)
                return fg.data, fm.data
            return call
        self.run("scatter", f"{len(locs)} rows cpad8", scat, [0],
                 masks=[0, 1], work=lambda dt: (_nbytes(locs, feats), 0))
        self.int8_cases()
        self.training_cases()
        self.secondary_cases()
        return self.results

    def edge_cases(self):
        """K1 and K2 where their Hopper designs have edges: K1 (bricks of 2 x
        4 x 32 voxels) at cpad 8 and 16 with 1-4 groups, with and without
        the affine and the residual, on a random, a fully active and a fully
        inactive mask, with Z + 2, Y + 2 and the x slots (xq cut from the
        folded 8-block multiple) not multiples of the brick; K2 in cross
        and same-cpad modes on an odd fine width, a fully active and a
        fully inactive mask. Weights prepared in f32 and in the compute
        type by turns; inputs without an affine are dense (the kernel reads
        neighbours whose mask is 0), and so are the residuals (copied where
        the mask is 0)."""
        FO = self.FO
        dims = (9, 29, 40)
        masks = {"random": torch.rand(1, *dims, generator=torch.Generator()
                                      .manual_seed(3)) < 0.3,
                 "fully active": torch.ones(1, *dims, dtype=torch.bool),
                 "fully inactive": torch.zeros(1, *dims, dtype=torch.bool)}
        dense = masks["fully active"]

        def cut(fg, xq):
            return FO.FGrid(fg.data[:, :, :, :xq].contiguous(), fg.dims,
                            fg.real_c, fg.cpad)

        # cpad, widths, affine, residual, mask, xq (None: as folded)
        k1 = [(16, [16, 16, 2, 8], True, True, "random", 5),
              (16, [16], False, False, "fully active", 5),
              (16, [16, 8], True, False, "fully inactive", None),
              (16, [16, 2, 8], False, True, "fully inactive", 5),
              (8, [8], False, True, "fully active", 3),
              (8, [8, 1], True, False, "random", 3),
              (8, [8, 8, 8, 1], False, True, "random", None),
              (8, [1, 8, 4], True, True, "fully inactive", 3)]
        for i, (cpad, widths, has_aff, has_res, mk, xq) in enumerate(k1):
            fm = self.mask(masks[mk], cpad)
            data = masks[mk] if has_aff else dense
            gs = [self.grid(dims, c, cpad, data) for c in widths]
            res = self.grid(dims, cpad, cpad, dense) if has_res else None
            if xq is not None:
                fm, gs = cut(fm, xq), [cut(g, xq) for g in gs]
                res = cut(res, xq) if res is not None else None
            w27 = self.weights(27, sum(widths), cpad)
            aff = self.affines(widths) if has_aff else None

            def conv(dt, fm=fm, gs=gs, res=res, w27=w27, aff=aff,
                     widths=widths, cpad=cpad, i=i):
                w = FO.prep_conv_weights(
                    w27, widths, torch.float32 if i % 2 == 0 else dt
                ).to(self.dev)
                grp = [g.with_data(g.data.to(dt)) for g in gs]
                m = fm.with_data(fm.data.to(dt))
                r = res.with_data(res.data.to(dt)) if res is not None \
                    else None
                return lambda impl: (FO.subm_conv_fused(
                    grp, m, w, cpad, aff=aff, residual=r, impl=impl).data,)
            label = (f"edge cpad{cpad} G{len(widths)} "
                     f"{'affine' if has_aff else 'raw'}"
                     f"{'+residual' if has_res else ''} {mk} mask, "
                     f"{dims} xq {fm.data.shape[3]}")
            self.run("conv_site", label, conv, [0], resid=res)

        # cpad, cpad_out, affine, mask; fine dims with an odd width
        fdims = (10, 30, 45)
        fmasks = {"random": torch.rand(1, *fdims, generator=torch.Generator()
                                       .manual_seed(4)) < 0.2,
                  "fully active": torch.ones(1, *fdims, dtype=torch.bool),
                  "fully inactive": torch.zeros(1, *fdims, dtype=torch.bool)}
        k2 = [(8, 16, False, "random"), (8, 16, False, "fully active"),
              (16, 16, True, "random"), (16, 16, True, "fully active"),
              (16, 16, False, "fully inactive"), (8, 8, True, "random")]
        for i, (cpad, co, has_aff, mk) in enumerate(k2):
            fm = self.mask(fmasks[mk], cpad)
            x = self.grid(fdims, cpad, cpad,
                          fmasks[mk] if has_aff else fmasks["fully active"])
            w8 = self.weights(8, cpad, co)
            aff = self.affines([cpad])[0] if has_aff else None

            def down(dt, fm=fm, x=x, w8=w8, aff=aff, cpad=cpad, co=co, i=i):
                w = FO.prep_downconv_weights(
                    w8, cpad, torch.float32 if i % 2 == 0 else dt
                ).to(self.dev)
                xd, m = x.with_data(x.data.to(dt)), fm.with_data(
                    fm.data.to(dt))

                def call(impl):
                    o, om = FO.downconv_fused(xd, m, w, cpad, aff=aff,
                                              cpad_out=co, impl=impl)
                    return o.data, om.data
                return call
            self.run("downconv", f"edge cpad{cpad}->{co} "
                     f"{'affine' if has_aff else 'raw'} {mk} mask, {fdims}",
                     down, [0], masks=[1])

    def int8_cases(self):
        """K1q, K2q, K3q (the int8 modes of the conv, down and upsample
        sites, quantize=True) and their scale pre-pass tile_amax at the
        serving shapes, on grids masked by the sphere shell; each site's
        TPU tiles (logged) give it many activation scales. Every one is
        held bit-equal to its plain version; each site's bf16 case also
        logs its kernel's and its tile_amax's device time apart."""
        from sgnn_tpu_torch.ops import quant as Q
        from sgnn_tpu_torch.ops.kernels import tile_amax as K_amax
        from sgnn_tpu_torch.ops.kernels.downconv import coarse_xq

        FO, fine, coarse = self.FO, self.fine, self.coarse
        cd = tuple(d // 2 for d in SCENE)
        dts = (torch.float32, torch.bfloat16)

        def cast(fg, dt):
            return fg.with_data(fg.data.to(dt))

        def on_card(pair):
            return tuple(t.to(self.dev) for t in pair)

        def tiles_of(fn, *a):
            t = {dt: fn(*a, dt) for dt in dts}
            return ", ".join(f"{str(dt)[6:]} {v.nz}x{v.ny} tiles of "
                             f"{v.tz}x{v.ty}" for dt, v in t.items())

        # K1q at the finest level (cpad 16, 3 groups, affine, residual)
        # and at level 0 (cpad 8: the resblock, and the first conv over
        # the one-channel input without an affine)
        widths = [16, 2, 8]
        fm16 = self.mask(fine, 16)
        g16 = [self.grid(SCENE, c, 16, fine) for c in widths]
        res16 = self.grid(SCENE, 16, 16, fine)
        aff16 = self.affines(widths)
        w27 = self.weights(27, 26, 16)
        cw = {dt: on_card(Q.quantize_conv_weights(
            FO.prep_conv_weights(w27, widths, dt))) for dt in dts}
        log(f"[kernels] int8 conv_site cpad16 G3: " + tiles_of(
            lambda dt: Q.conv_tiles(cast(fm16, dt).data, 3, True)))

        def conv16(dt):
            grp, m, r = [cast(g, dt) for g in g16], cast(fm16, dt), \
                cast(res16, dt)
            wq, ws = cw[dt]
            return lambda impl: (FO.subm_conv_fused(
                grp, m, wq, 16, aff=aff16, residual=r, quantize=True, ws=ws,
                impl=impl).data,)
        n16 = _active(fm16.data, 16)
        act16 = _voxels(fm16)

        def conv16_work(dt):
            # as K1's: the groups only at active voxels
            return (_grid_bytes(g16, dt, act16) + _grid_bytes(
                [fm16, res16], dt) + _nbytes(*cw[dt], aff16),
                    2 * 27 * sum(widths) * 16 * n16)

        def conv16_step(dt):
            return _activation_step([cast(g, dt).data for g in g16],
                                    cast(fm16, dt).data, aff16, 16,
                                    cw[dt][1])
        self.run("conv_site_q", "cpad16 G3 affine+residual", conv16, [0],
                 resid=res16, work=conv16_work, step=conv16_step,
                 peak=PEAK_INT8_OPS, exact=True, split=True)

        fm8 = self.mask(fine, 8)
        x8 = self.grid(SCENE, 8, 8, fine)
        in8 = self.grid(SCENE, 1, 8, fine)
        aff8 = self.affines([8])
        for label, x, cin, aff, resid in (
                ("cpad8 G1 affine+residual", x8, 8, aff8, x8),
                ("cpad8 G1 cin 1", in8, 1, None, None)):
            w8 = self.weights(27, cin, 8)
            qw = {dt: on_card(Q.quantize_conv_weights(
                FO.prep_conv_weights(w8, [cin], dt))) for dt in dts}

            def conv8(dt, x=x, aff=aff, resid=resid, qw=qw):
                xd, m = cast(x, dt), cast(fm8, dt)
                r = cast(resid, dt) if resid is not None else None
                return lambda impl: (FO.subm_conv_fused(
                    [xd], m, qw[dt][0], 8, aff=aff, residual=r,
                    quantize=True, ws=qw[dt][1], impl=impl).data,)

            def conv8_step(dt, x=x, aff=aff, qw=qw):
                return _activation_step([cast(x, dt).data],
                                        cast(fm8, dt).data, aff, 8,
                                        qw[dt][1])
            self.run("conv_site_q", label, conv8, [0], resid=resid,
                     step=conv8_step, exact=True, split=True)
        self.k1q_edge_cases()

        # K2q: the encoder's level-0 exit (cpad 8 -> 16, no affine) and a
        # U-Net down site (cpad 16, affine)
        for label, x, fm, cin, cpad, co, aff in (
                ("cross cpad8->16", x8, fm8, 8, 8, 16, None),
                ("cpad16 affine", g16[0], fm16, 16, 16, 16,
                 self.affines([16])[0])):
            wd = self.weights(8, cin, cin)
            dw = {dt: on_card(Q.quantize_downconv_weights(
                FO.prep_downconv_weights(wd, cin, dt))) for dt in dts}
            xqc = coarse_xq(x.data.shape[3], cpad, co)
            log(f"[kernels] int8 downconv {label}: " + tiles_of(
                lambda dt: Q.downconv_tiles(cast(x, dt).data, xqc)))

            def down(dt, x=x, fm=fm, co=co, aff=aff, dw=dw, cin=cin):
                xd, m = cast(x, dt), cast(fm, dt)

                def call(impl):
                    o, om = FO.downconv_fused(
                        xd, m, dw[dt][0], cin, aff=aff, cpad_out=co,
                        quantize=True, ws=dw[dt][1], impl=impl)
                    return o.data, om.data
                return call

            def down_work(dt, x=x, fm=fm, aff=aff, dw=dw, cin=cin,
                          call=down):
                o, om = call(dt)(None)
                # as K2's: with an affine the input at active voxels only
                need = _voxels(fm, 2 if aff is None else 0)
                return (_grid_bytes([x], dt, need) + _grid_bytes([fm], dt)
                        + _nbytes(*dw[dt]),
                        2 * 8 * cin * cin * _active(om, 16))

            def down_step(dt, x=x, fm=fm, aff=aff, dw=dw, cpad=cpad):
                return _activation_step(
                    [cast(x, dt).data], cast(fm, dt).data,
                    aff[None] if aff is not None else None, cpad, dw[dt][1])
            self.run("downconv_q", label, down, [0], masks=[1],
                     work=down_work, step=down_step, peak=PEAK_INT8_OPS,
                     exact=True, split=True)
        self.k2q_edge_cases()

        # K3q from the 48x96x96 coarse level, 3 groups, fine mask expanded
        cfm = self.mask(coarse, 16)
        cg = [self.grid(cd, 16, 16, coarse) for _ in range(3)]
        affu = self.affines([16] * 3)
        wu27 = self.weights(27, 48, 16)
        uw = {dt: on_card(Q.quantize_upconv_weights(
            FO.prep_upconv_weights(wu27, [16] * 3, dt))) for dt in dts}
        xqf = FO._xq_for(SCENE[2], 16)
        log(f"[kernels] int8 upconv G3: " + tiles_of(
            lambda dt: Q.upconv_tiles(cast(cfm, dt).data, xqf, 3)))

        def up(dt):
            grp, m = [cast(g, dt) for g in cg], cast(cfm, dt)
            return lambda impl: (FO.upconv_fused(
                grp, m, None, uw[dt][0], 16, aff=affu, quantize=True,
                ws=uw[dt][1], impl=impl).data,)

        def up_work(dt):
            return (_grid_bytes(cg, dt, _voxels(cfm)) + _grid_bytes(
                [cfm], dt) + _nbytes(*uw[dt], affu),
                    2 * 8 * 48 * 16 * 8 * _active(cfm.data, 16))

        def up_step(dt):
            return _activation_step([cast(g, dt).data for g in cg],
                                    cast(cfm, dt).data, affu, 16, uw[dt][1])
        self.run("upconv_q", "G3 fmask=None", up, [0], work=up_work,
                 step=up_step, peak=PEAK_INT8_OPS, exact=True, split=True)
        self.k3q_edge_cases()

        # tile_amax over each site's windows, bit-equal to its plain version
        for label, xs, fm, aff, cpad, tiles in (
                ("conv windows cpad16 G3 affine", g16, fm16, aff16, 16,
                 lambda dt: Q.conv_tiles(cast(fm16, dt).data, 3, True)),
                ("down windows cpad8 G1", [x8], fm8, None, 8,
                 lambda dt: Q.downconv_tiles(cast(x8, dt).data, coarse_xq(
                     x8.data.shape[3], 8, 16))),
                ("up windows G3 affine", cg, cfm, affu, 16,
                 lambda dt: Q.upconv_tiles(cast(cfm, dt).data, xqf, 3))):

            def amax(dt, xs=xs, fm=fm, aff=aff, cpad=cpad, tiles=tiles):
                xd, m, t = [cast(g, dt).data for g in xs], cast(fm, dt), \
                    tiles(dt)
                return lambda impl: (K_amax.tile_amax(xd, m.data, aff, cpad,
                                                      t, impl=impl),)

            def amax_work(dt, xs=xs, fm=fm, aff=aff):
                # |x| and max per value, over every lane; with an affine
                # also *, +, relu, * and only the real channels of active
                # voxels (relu(.) * 0 elsewhere), plus the mask
                if aff is None:
                    return _grid_bytes(xs, dt), 2 * sum(
                        g.data.numel() for g in xs)
                act = _voxels(fm)
                return (_grid_bytes(xs, dt, act) + _grid_bytes([fm], dt),
                        6 * int(act.sum()) * sum(g.real_c for g in xs))
            self.run("tile_amax", label, amax, [], masks=[0], dense=True,
                     work=amax_work, peak=PEAK_F32_FLOPS)
            if aff is None:  # the full-grid pass, timed beside the one kept
                call = amax(torch.bfloat16)
                tk = _time_ms(lambda: call(None))
                nbytes, ops = amax_work(torch.bfloat16)
                b = _bound(nbytes + _nbytes(*call(None)), ops, PEAK_F32_FLOPS)
                log(f"[kernels] tile_amax {label} bfloat16: kernel {tk:.3f} "
                    f"ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
                    f"({nbytes / 1e6:.1f} MB)")
        self.amax_edge_cases()

    def amax_edge_cases(self):
        """tile_amax at the edges of its Hopper design (a mask vector read
        once for every group, the groups only where it is set; a block's 8
        rows combined per tile): conv windows of tiles of 2 x 3 rows at
        10x21x40, up and down windows; an all-zero and a fully active mask,
        one active voxel in a padded row that two or four windows hold, a
        random mask; cpad 8 and 16, 1-4 groups, with and without the
        affine. Bit-equal to the plain version."""
        from sgnn_tpu_torch.ops import quant as Q
        from sgnn_tpu_torch.ops.kernels import tile_amax as K_amax

        dims = (10, 21, 40)
        gen = torch.Generator().manual_seed(11)
        full = torch.ones(1, *dims, dtype=torch.bool)
        t16 = Q.conv_tiles(self.mask(full, 16).data, 1, False)
        require(t16.ty <= 3 and t16.nz > 1 and t16.ny > 1,
                f"tile_amax edge cases: tiles {t16}")

        def one_voxel(windows):
            """A mask with one active voxel in a padded row held by
            ``windows`` (2 or 4) conv windows."""
            t = t16
            for z in range(1, dims[0] + 1):
                for y in range(1, dims[1] + 1):
                    nz = sum(iz * t.sz <= z < iz * t.sz + t.lz
                             for iz in range(t.nz))
                    ny = sum(iy * t.sy <= y < iy * t.sy + t.ly
                             for iy in range(t.ny))
                    if nz * ny == windows:
                        m = torch.zeros(1, *dims, dtype=torch.bool)
                        m[0, z - 1, y - 1, 17] = True
                        return m
            raise SmokeError(f"no row in {windows} windows of {t}")

        masks = {"all-zero": torch.zeros(1, *dims, dtype=torch.bool),
                 "fully active": full,
                 "one voxel in 4 windows": one_voxel(4),
                 "one voxel in 2 windows": one_voxel(2),
                 "random": torch.rand(1, *dims, generator=gen) < 0.3}
        # cpad, widths, affine, mask, site whose windows
        cases = [(16, [16, 16, 2, 8], True, "all-zero", "conv"),
                 (16, [16, 8], True, "fully active", "conv"),
                 (8, [8, 8, 1], True, "one voxel in 4 windows", "conv"),
                 (16, [16], True, "one voxel in 2 windows", "conv"),
                 (8, [8], True, "random", "conv"),
                 (16, [16, 16, 16], True, "random", "up"),
                 (16, [16, 2, 8], False, "random", "conv"),
                 (8, [8], False, "random", "down"),
                 (16, [5, 16, 16, 16], False, "fully active", "conv")]
        for cpad, widths, has_aff, mk, site in cases:
            fm = self.mask(masks[mk], cpad)
            data = masks[mk] if has_aff else full
            xs = [self.grid(dims, c, cpad, data) for c in widths]
            aff = self.affines(widths) if has_aff else None

            def tiles(dt, fm=fm, site=site, G=len(widths), cpad=cpad):
                d = fm.data.to(dt)
                if site == "conv":
                    return Q.conv_tiles(d, G, False)
                if site == "up":
                    return Q.upconv_tiles(d, self.FO._xq_for(
                        2 * dims[2], cpad), G)
                return Q.downconv_tiles(d, d.shape[3])

            def amax(dt, xs=xs, fm=fm, aff=aff, cpad=cpad, tiles=tiles):
                xd, m, t = [g.data.to(dt) for g in xs], fm.data.to(dt), \
                    tiles(dt)
                return lambda impl: (K_amax.tile_amax(xd, m, aff, cpad, t,
                                                      impl=impl),)
            t = tiles(torch.float32)
            label = (f"edge cpad{cpad} G{len(widths)} "
                     f"{'affine' if has_aff else 'raw'} {mk} mask, {site} "
                     f"windows, {t.nz}x{t.ny} tiles of {t.tz}x{t.ty}")
            self.run("tile_amax", label, amax, [], masks=[0], dense=True)
            if mk.startswith("one voxel"):
                got = amax(torch.bfloat16)(None)[0]
                held = int((got > 0).any(-1).sum())
                want = int(mk.split()[3])
                log(f"[kernels] tile_amax {label}: {held} tiles non-zero")
                require(held == want, f"tile_amax {label}: {held} tiles "
                        f"non-zero, expected {want}")

    def k1q_edge_cases(self):
        """K1q where its Hopper design has edges: TPU tiles of ty <= 3 rows
        (the picker's choice at these dims) that straddle the 2 x 4 brick
        rows in z and y, so one brick holds rows of up to four scales; a
        random, a fully active and a fully inactive mask; cpad 8 and 16,
        1-2 groups, with and without the affine and the residual; x slots
        off the brick. Bit-equal to the plain version."""
        from sgnn_tpu_torch.ops import quant as Q

        FO = self.FO
        dims = (10, 21, 40)
        masks = {"random": torch.rand(1, *dims, generator=torch.Generator()
                                      .manual_seed(5)) < 0.3,
                 "fully active": torch.ones(1, *dims, dtype=torch.bool),
                 "fully inactive": torch.zeros(1, *dims, dtype=torch.bool)}
        # cpad, widths, affine, residual, mask; x blocks kept: 40 slots at
        # cpad 16, 48 at cpad 8 (the folded grid pads them to 64 or 128)
        cases = [(16, [16, 8], True, True, "random"),
                 (16, [16], False, True, "fully active"),
                 (8, [8, 1], True, False, "fully active"),
                 (8, [8], False, True, "random"),
                 (16, [16, 2], True, True, "fully inactive")]

        def cut(fg, cpad):
            xq = 5 if cpad == 16 else 3
            return FO.FGrid(fg.data[:, :, :, :xq].contiguous(), fg.dims,
                            fg.real_c, fg.cpad)
        for cpad, widths, has_aff, has_res, mk in cases:
            fm = cut(self.mask(masks[mk], cpad), cpad)
            data = masks[mk] if has_aff else masks["fully active"]
            gs = [cut(self.grid(dims, c, cpad, data), cpad) for c in widths]
            res = cut(self.grid(dims, cpad, cpad, masks["fully active"]),
                      cpad) if has_res else None
            aff = self.affines(widths) if has_aff else None
            w27 = self.weights(27, sum(widths), cpad)
            qw = {dt: tuple(t.to(self.dev) for t in Q.quantize_conv_weights(
                FO.prep_conv_weights(w27, widths, dt)))
                for dt in (torch.float32, torch.bfloat16)}
            t = Q.conv_tiles(fm.data, len(widths), has_res)
            require(t.ty <= 3, f"K1q edge case: tiles {t}, expected ty <= 3")

            def conv(dt, fm=fm, gs=gs, res=res, aff=aff, qw=qw, cpad=cpad):
                grp = [g.with_data(g.data.to(dt)) for g in gs]
                m = fm.with_data(fm.data.to(dt))
                r = res.with_data(res.data.to(dt)) if res is not None \
                    else None
                return lambda impl: (FO.subm_conv_fused(
                    grp, m, qw[dt][0], cpad, aff=aff, residual=r,
                    quantize=True, ws=qw[dt][1], impl=impl).data,)

            def step(dt, fm=fm, gs=gs, aff=aff, qw=qw, cpad=cpad):
                return _activation_step([g.data.to(dt) for g in gs],
                                        fm.data.to(dt), aff, cpad,
                                        qw[dt][1])
            label = (f"edge cpad{cpad} G{len(widths)} "
                     f"{'affine' if has_aff else 'raw'}"
                     f"{'+residual' if has_res else ''} {mk} mask, {dims}, "
                     f"{t.nz}x{t.ny} tiles of {t.tz}x{t.ty}")
            self.run("conv_site_q", label, conv, [0], resid=res, step=step,
                     exact=True)

    def k2q_edge_cases(self):
        """K2q where its Hopper design (K2's: one thread per coarse voxel,
        flat over [B, Z, Y, x slots]) has edges: cross mode with the fine
        x blocks cut to 6 or 2, so a coarse row has 48 or 16 slots and a
        warp holds the end of one row and the start of the next; TPU tiles
        of one coarse row (the picker's choice at coarse Y 5), so those
        warps hold voxels of two tiles; same-cpad modes at cpad 8 and 16;
        random, dense and empty masks; with and without the affine, cin
        below cpad. Bit-equal to the plain version."""
        from sgnn_tpu_torch.ops import quant as Q
        from sgnn_tpu_torch.ops.kernels.downconv import coarse_xq

        FO = self.FO
        # cpad, cpad_out, cin, affine, mask, fine dims, fine x blocks kept
        cases = [(8, 16, 8, False, "random", (10, 10, 90), 6),
                 (8, 16, 8, False, "dense", (10, 6, 40), 6),
                 (8, 16, 3, True, "random", (4, 10, 20), 2),
                 (16, 16, 16, True, "empty", (10, 10, 40), None),
                 (16, 16, 12, True, "random", (6, 10, 40), None),
                 (8, 8, 5, True, "dense", (10, 10, 40), None),
                 (16, 16, 16, False, "dense", (4, 10, 40), None)]
        for i, (cpad, co, cin, has_aff, kind, fdims, xq) in enumerate(cases):
            g = torch.Generator().manual_seed(60 + i)
            m = {"random": torch.rand(1, *fdims, generator=g) < 0.3,
                 "dense": torch.ones(1, *fdims, dtype=torch.bool),
                 "empty": torch.zeros(1, *fdims, dtype=torch.bool)}[kind]

            def cut(fg, xq=xq):
                if xq is None:
                    return fg
                return FO.FGrid(fg.data[:, :, :, :xq].contiguous(), fg.dims,
                                fg.real_c, fg.cpad)
            fm = cut(self.mask(m, cpad))
            x = cut(self.grid(fdims, cin, cpad,
                              m if has_aff else torch.ones_like(m)))
            aff = self.affines([cin])[0] if has_aff else None
            w8 = self.weights(8, cin, co)
            qw = {dt: tuple(t.to(self.dev) for t in
                            Q.quantize_downconv_weights(
                                FO.prep_downconv_weights(w8, cin, dt)))
                  for dt in (torch.float32, torch.bfloat16)}
            xqc = coarse_xq(x.data.shape[3], cpad, co)
            t = Q.downconv_tiles(x.data, xqc)

            def down(dt, fm=fm, x=x, aff=aff, qw=qw, cin=cin, co=co):
                xd, md = x.with_data(x.data.to(dt)), fm.with_data(
                    fm.data.to(dt))

                def call(impl):
                    o, om = FO.downconv_fused(
                        xd, md, qw[dt][0], cin, aff=aff, cpad_out=co,
                        quantize=True, ws=qw[dt][1], impl=impl)
                    return o.data, om.data
                return call

            def step(dt, fm=fm, x=x, aff=aff, qw=qw, cpad=cpad):
                return _activation_step(
                    [x.data.to(dt)], fm.data.to(dt),
                    aff[None] if aff is not None else None, cpad,
                    qw[dt][1])
            label = (f"edge cpad{cpad}->{co} cin {cin} "
                     f"{'affine' if has_aff else 'raw'} {kind} mask, {fdims} "
                     f"xq {x.data.shape[3]} -> {xqc} ({xqc * 128 // co} "
                     f"coarse slots), {t.nz}x{t.ny} tiles of {t.tz}x{t.ty}")
            self.run("downconv_q", label, down, [0], masks=[1], step=step,
                     exact=True)

    def k3q_edge_cases(self):
        """K3q where its Hopper design (K3's fine bricks of 2 x 4 x 32
        voxels from padded row -1, rows grouped by parity into MMA tiles of
        16, one int8 window per group and distinct TPU tile) has edges: TPU
        tiles of 2 or 6 fine y rows, which straddle a brick's 4 y rows (its
        rows take two scales), required here; 1-4 groups with widths below
        cpad, cpad 8 and 16, with and without the affine, the fine mask
        given (training) and expanded from the coarse one (serving), on
        random, full, empty and single-voxel masks; fine x tails (fewer
        fine x blocks than twice the coarse ones; the last real fine slot
        odd, of x parity 1). Bit-equal to the plain version."""
        from sgnn_tpu_torch.ops import quant as Q

        FO = self.FO

        def straddles(t, Yf):
            # a tile boundary inside brick rows 4 ky - 2 .. 4 ky + 1
            return any(4 * ky - 2 < k * t.ty <= 4 * ky + 1
                       for ky in range(Yf // 4 + 2)
                       for k in range(1, t.ny))
        # cpad, widths, affine, fine mask given, mask kind, coarse dims
        cases = [(16, [16], True, False, "random", (5, 5, 70)),
                 (16, [16, 5, 16, 2], True, True, "random", (3, 9, 40)),
                 (8, [8], False, False, "full", (5, 5, 9)),
                 (8, [3, 8], True, True, "single", (3, 9, 24)),
                 (16, [16, 16], False, True, "empty", (2, 3, 40)),
                 (16, [6], False, False, "single", (5, 5, 70)),
                 (8, [8, 8, 1, 4], True, False, "full", (5, 5, 40)),
                 (16, [16, 8, 16], True, False, "full", (3, 9, 70))]
        for i, (cpad, widths, has_aff, given, kind, cdims) in enumerate(
                cases):
            fdims = tuple(2 * d for d in cdims)
            g = torch.Generator().manual_seed(70 + i)

            def mask_of(dims, g=g, kind=kind):
                if kind == "single":
                    m = torch.zeros(1, *dims, dtype=torch.bool)
                    m[0, dims[0] // 2, dims[1] - 1, dims[2] - 1] = True
                    return m
                return {"random": torch.rand(1, *dims, generator=g) < 0.3,
                        "full": torch.ones(1, *dims, dtype=torch.bool),
                        "empty": torch.zeros(1, *dims, dtype=torch.bool)
                        }[kind]
            cm = mask_of(cdims)
            cfm = self.mask(cm, cpad)
            ffm = self.mask(mask_of(fdims), cpad) if given else None
            data = cm if has_aff else torch.ones_like(cm)
            gs = [self.grid(cdims, c, cpad, data) for c in widths]
            aff = self.affines(widths) if has_aff else None
            w27 = self.weights(27, sum(widths), cpad)
            qw = {dt: tuple(t.to(self.dev) for t in
                            Q.quantize_upconv_weights(
                                FO.prep_upconv_weights(w27, widths, dt)))
                  for dt in (torch.float32, torch.bfloat16)}
            xqf = (ffm.data.shape[3] if given
                   else FO._xq_for(2 * cdims[2], cpad))
            tiles = {dt: Q.upconv_tiles(cfm.data.to(dt), xqf, len(widths))
                     for dt in qw}
            if cdims[1] in (5, 9):
                require(all(straddles(t, fdims[1]) for t in tiles.values()),
                        f"K3q edge case {i}: tiles {tiles} do not straddle "
                        f"a brick's y rows")

            def up(dt, gs=gs, cfm=cfm, ffm=ffm, aff=aff, qw=qw, cpad=cpad):
                grp = [x.with_data(x.data.to(dt)) for x in gs]
                m = cfm.with_data(cfm.data.to(dt))
                f = ffm.with_data(ffm.data.to(dt)) if ffm is not None \
                    else None
                return lambda impl: (FO.upconv_fused(
                    grp, m, f, qw[dt][0], cpad, aff=aff, quantize=True,
                    ws=qw[dt][1], impl=impl).data,)

            def step(dt, gs=gs, cfm=cfm, aff=aff, qw=qw, cpad=cpad):
                return _activation_step([x.data.to(dt) for x in gs],
                                        cfm.data.to(dt), aff, cpad,
                                        qw[dt][1])
            label = (f"edge cpad{cpad} G{len(widths)} {widths} "
                     f"{'affine' if has_aff else 'raw'} "
                     f"fmask={'given' if given else 'None'} {kind} mask, "
                     f"coarse {cdims} xq {cfm.data.shape[3]} -> {xqf}, "
                     + ", ".join(f"{str(dt)[6:]} {t.nz}x{t.ny} tiles of "
                                 f"{t.tz}x{t.ty}" for dt, t in tiles.items()))
            self.run("upconv_q", label, up, [0], step=step, exact=True)

    def secondary_cases(self):
        """K8 and K9 (channels-last 3^3 conv) and K10 (gather-GEMM) at the
        secondary executions' full-resolution shapes: grids masked by the
        96x192x192 sphere shell, coordinate lists of its active voxels."""
        from sgnn_tpu_torch.ops import conv as CV
        from sgnn_tpu_torch.ops import coords as C
        from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl
        from sgnn_tpu_torch.ops.kernels import gather_gemm as K_gg

        def cl_grid(dims, c, shell):
            m = _shell(dims, 4.0) if shell else torch.ones(1, *dims,
                                                           dtype=torch.bool)
            d = torch.randn(1, *dims, c, device=self.dev, generator=self.gen)
            return d * m.to(self.dev)[..., None]

        def conv_work(x, w):
            def work(dt):
                nz = int((x != 0).any(-1).sum())
                return (_nbytes(x.to(dt), w),
                        2 * 27 * w.shape[1] * w.shape[2] * nz)
            return work

        def conv_case(kernel, label, dims, cin, cout, dtypes, timed=False,
                      logged=False):
            """``timed``: the kernel's timed case (its bound and one
            F.conv3d); ``logged``: also the bf16 kernel's and plain
            version's times in a line of their own."""
            fn = {"conv3d_folded": K_cl.conv3d_3x3x3_folded,
                  "conv3d": K_cl.conv3d_3x3x3}[kernel]
            x = cl_grid(dims, cin, shell=True)
            w = torch.from_numpy(self.weights(27, cin, cout)).to(self.dev)

            def make(dt):
                xd = x.to(dt)
                return lambda impl: (fn(xd, w, impl=impl),)
            self.run(kernel, label, make, [0], dense=True, dtypes=dtypes,
                     work=conv_work(x, w) if timed else None,
                     library=_library_conv((1, cin, *dims), cout, 3,
                                           padding=1) if timed else None)
            if timed and kernel == "conv3d_folded":
                _log_ms(kernel, label, make, (torch.float32,))
            if logged:
                _log_ms(kernel, label, make, (torch.bfloat16,))

        both = (torch.float32, torch.bfloat16)
        # K8 at the dense-flow execution's full-resolution sites (encoder
        # level 0's resblock, C = 8; the surface head's p1 group and
        # U-Net top, C = 16), then C = 32, Cout < Cin down to 1, Y != X
        conv_case("conv3d_folded", "C8->8 96x192x192", SCENE, 8, 8, both,
                  timed=True)
        conv_case("conv3d_folded", "C16->16 96x192x192", SCENE, 16, 16,
                  both)
        conv_case("conv3d_folded", "C32->32 48x96x96",
                  tuple(d // 2 for d in SCENE), 32, 32, both)
        conv_case("conv3d_folded", "C16->1 96x192x160 (Y != X)", K5_DIMS,
                  16, 1, both)
        conv_case("conv3d_folded", "C32->12 48x96x80 (Y != X)",
                  tuple(d // 2 for d in K5_DIMS), 32, 12, both)

        # K8's input gradient: the backward's K8 call on the flipped,
        # transposed taps (Cout = C), a cotangent at every voxel
        x = cl_grid(SCENE, 16, shell=True)
        w = torch.from_numpy(self.weights(27, 16, 16)).to(self.dev)
        g = torch.randn(1, *SCENE, 16, device=self.dev, generator=self.gen)

        def dx(dt):
            xd, gd = x.to(dt), g.to(dt)

            def call(impl):
                xr = xd.clone().requires_grad_()
                with torch.enable_grad():
                    y = K_cl.conv3d_3x3x3_folded(xr, w, impl=impl)
                    return torch.autograd.grad(y, xr, gd)
            return call
        self.run("conv3d_folded", "input gradient C16 96x192x192", dx, [0],
                 dense=True)
        # the backward's K8 call alone: the dense cotangent through the
        # flipped, transposed taps
        wt = torch.flip(w.reshape(3, 3, 3, 16, 16), (0, 1, 2)).reshape(
            27, 16, 16).transpose(1, 2)

        def dx_call(dt):
            gd = g.to(dt)
            return lambda impl: (K_cl.conv3d_3x3x3_folded(gd, wt, impl=impl),)
        _log_ms("conv3d_folded", "input gradient's call (dense cotangent "
                "C16 96x192x192)", dx_call, (torch.float32, torch.bfloat16))
        self.k8_edge_cases()

        # K9: the widths of tests/test_pallas_gather.py:46, the 96x192x192
        # C = 16 grid, and two widths K8 does not take
        conv_case("conv3d", "C16->16 96x192x192", SCENE, 16, 16, both,
                  timed=True)
        conv_case("conv3d", "C8->8 4x8x16", (4, 8, 16), 8, 8, both,
                  logged=True)
        conv_case("conv3d", "C26->16 48x96x80", tuple(
            d // 2 for d in K5_DIMS), 26, 16, both, logged=True)
        conv_case("conv3d", "C48->40 24x48x48", tuple(
            d // 4 for d in SCENE), 48, 40, both, logged=True)
        self.k9_edge_cases()

        # K10 over the rows of the shell's active voxels at 96x192x192:
        # submanifold taps (K = 27) at the widest sites of the
        # coordinate-list execution (refinement n1 48 -> 16, p1 34 -> 16,
        # U-Net 16 -> 16), the strided taps (K = 8) to the unique parents,
        # and rows whose neighbours are all missing (output exactly 0)
        idx = torch.nonzero(self.fine[0].to(self.dev))
        locs = torch.cat([idx, torch.zeros_like(idx[:, :1])], 1).to(
            torch.int32)
        n = len(locs)
        grid = C.build_index_grid(locs, n, SCENE, 1)
        sub = CV.neighbor_rows(locs, grid, C.neighbor_offsets(3, self.dev),
                               SCENE, 1)
        half = tuple(d // 2 for d in SCENE)
        # the strided conv's output rows: the unique parents, padded to
        # the input's capacity as the execution pads them
        parents, n_par, _ = C.unique_locs(C.parent_locs(locs), n, half, 1, n)
        down = CV.neighbor_rows(parents, grid,
                                C.neighbor_offsets(2, self.dev), SCENE, 1,
                                scale=2)
        log(f"[kernels] gather_gemm rows: {n} shell voxels, {n_par} "
            f"parents; {int((sub > 0).sum())} and {int((down > 0).sum())} "
            f"present neighbours")

        def gg_case(label, nbr, cin, cout, dtypes, timed=False, masks=()):
            f = torch.randn(n, cin, device=self.dev, generator=self.gen)
            w = torch.from_numpy(self.weights(nbr.shape[1], cin, cout)).to(
                self.dev)

            def make(dt):
                fd = f.to(dt)
                return lambda impl: (K_gg.gather_gemm(fd, nbr, w,
                                                      impl=impl),)

            def work(dt):
                return (_nbytes(f.to(dt), nbr, w),
                        2 * cin * cout * int((nbr > 0).sum()))
            self.run("gather_gemm", label, make, [] if masks else [0],
                     masks=masks, dense=True, dtypes=dtypes,
                     work=work if timed else None)

        gg_case(f"K27 48->16 {n} rows", sub, 48, 16, both, timed=True)
        gg_case(f"K27 34->16 {n} rows", sub, 34, 16, both)
        gg_case(f"K27 16->16 {n} rows", sub, 16, 16, both)
        gg_case(f"K8 16->16 {n_par} of {n} rows", down, 16, 16, both)
        gg_case(f"K27 48->16 {n} rows, every neighbour missing",
                torch.zeros_like(sub), 48, 16, (torch.bfloat16,), masks=[0])
        self.k10_edge_cases()

    def k8_edge_cases(self):
        """K8 where its Hopper design has edges (persistent blocks over
        output bricks of 2 x 4 x 32 voxels, the halo'd input staged with
        zeros outside the volume, all-zero bricks skipped, the outputs
        written as runs of Cout values): Z and Y not multiples of the
        brick, X = 128 / C (the smallest supported() admits) and X not a
        multiple of 32, an all-zero input (every brick skipped: exact
        zeros), a single non-zero voxel at a brick's corner and at the
        volume's corners, Cout 1, 8 and 12 below C and C32 -> 32; batch
        2, f32 and bf16."""
        from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl

        # label, dims, C, Cout, input: a density or the voxels set
        cases = [("Z 3, Y 5, X 16 = 128/C", (3, 5, 16), 8, 8, 0.4),
                 ("X 8 = 128/C, dense", (4, 6, 8), 16, 16, 1.0),
                 ("C32->32, X 4 = 128/C", (3, 5, 4), 32, 32, 0.5),
                 ("X 48, Cout 8 < C", (5, 7, 48), 16, 8, 0.3),
                 ("C32->12, Y 9, X 36", (3, 9, 36), 32, 12, 0.3),
                 ("all-zero input", (4, 8, 64), 16, 16, 0.0),
                 ("one voxel at a brick corner, Cout 1", (6, 10, 80), 8, 1,
                  [(1, 2, 4, 32)]),
                 ("one voxel at each volume corner", (5, 7, 40), 16, 16,
                  [(0, 0, 0, 0), (1, 4, 6, 39)])]
        for i, (label, dims, C, cout, inp) in enumerate(cases):
            d = torch.randn(2, *dims, C, device=self.dev, generator=self.gen)
            if isinstance(inp, list):
                keep = torch.zeros(2, *dims, dtype=torch.bool)
                for v in inp:
                    keep[v] = True
            else:
                keep = torch.rand(2, *dims, generator=torch.Generator()
                                  .manual_seed(20 + i)) < inp
            x = d * keep.to(self.dev)[..., None]
            w = torch.from_numpy(self.weights(27, C, cout)).to(self.dev)

            def make(dt, x=x, w=w):
                xd = x.to(dt)
                return lambda impl: (K_cl.conv3d_3x3x3_folded(xd, w,
                                                              impl=impl),)
            self.run("conv3d_folded", f"edge C{C}->{cout} B2 {label}", make,
                     [0], dense=True, exact=inp == 0.0)

    def k5_edge_cases(self, bs):
        """K5 where its Hopper design has edges (a thread per run of 4 x
        voxels of a dense output row, written as one float4, the runs' mask
        reads issued together, each coarse voxel's head value computed once
        a run): 1 to 4 groups (scales 1; 1 and 2; 1, 2 and 4; 1, 2, 4 and
        4), X = 2 mod 4 (rows not 16-byte aligned, a partial last run), cpad
        8 and 16, batch 2, Y != X, random, all-on and all-off masks, junk
        (7.0) in every coarse grid's x tail-pad blocks. ``bs``: the phase's
        head bias; each case draws its own head weights."""
        from sgnn_tpu_torch.ops.kernels import surf_head as K_surf

        FO, B = self.FO, 2
        # a generator of their own: the phase's later inputs stay as they
        # were before these cases existed
        gen = torch.Generator(device=self.dev).manual_seed(5)
        # label, dims, cpad, scales, widths, mask kind
        cases = [("G1, X 38", (6, 10, 38), 16, (1,), (16,), "random"),
                 ("G2 scales 1/2, X 38", (6, 10, 38), 8, (1, 2), (8, 5),
                  "random"),
                 ("G2 scales 1/2, X 42, all-on", (4, 6, 42), 16, (1, 2),
                  (16, 3), "ones"),
                 ("G3, all-off", (8, 8, 40), 8, (1, 2, 4), (8, 8, 1),
                  "zeros"),
                 ("G3, all-on, X 72", (4, 8, 72), 8, (1, 2, 4), (8, 8, 8),
                  "ones"),
                 ("G4 scales 1/2/4/4, Y != X", (8, 12, 48), 16,
                  (1, 2, 4, 4), (16, 5, 16, 1), "random")]
        for i, (label, dims, cpad, scales, widths, kind) in enumerate(cases):
            m = {"random": torch.rand(B, *dims, generator=torch.Generator()
                                      .manual_seed(60 + i)) < 0.3,
                 "ones": torch.ones(B, *dims, dtype=torch.bool),
                 "zeros": torch.zeros(B, *dims, dtype=torch.bool)}[kind]
            fm = self.mask(m, cpad)
            grids = []
            for s, c in zip(scales, widths):
                g = FO.fold(torch.randn(B, *(d // s for d in dims), c,
                                        device=self.dev, generator=gen),
                            cpad).data
                g[:, :, :, -(-fm.data.shape[3] // s):] = 7.0
                grids.append(g)
            w = FO.prep_head_weights(self.weights(sum(widths), 1),
                                     list(widths),
                                     torch.float32).to(self.dev)
            aff = self.affines(list(widths))

            def make(dt, grids=grids, fm=fm, w=w, aff=aff, dims=dims,
                     cpad=cpad, scales=scales, widths=widths):
                xs, md = [g.to(dt) for g in grids], fm.data.to(dt)
                return lambda impl: (K_surf.surf_head(
                    xs, list(scales), md, w, bs, aff, list(widths), cpad,
                    dims, impl=impl),)
            self.run("surf_head", f"edge cpad{cpad} B2 {label}", make, [0],
                     dense=True, exact=kind == "zeros")

    def k9_edge_cases(self):
        """K9 where its Hopper design has edges beyond K8's (the staged
        voxel padded to 8, 16, 32, 48 or 64 channels; rows of cin values
        copied in 16-, 8-, 4- or 2-byte words; Cout over 8-wide N tiles in
        column groups of 8 to 32 on blockIdx.y; one staging buffer where two
        do not fit): odd Cin (rows of 2, 10 and 66 bytes in bf16), Cin 26
        (52-byte rows), Cout > Cin, Cout 1, C64, an input 2 bytes off a
        16-byte boundary, Z and Y off the brick, X not a multiple of 32,
        batch 2, an all-zero input (exact zeros) and dense ones."""
        from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl

        gen = torch.Generator(device=self.dev).manual_seed(9)  # as K5's
        # label, dims, Cin, Cout, density
        cases = [("odd Cin 5 -> 7, Z 3, Y 5, X 40", (3, 5, 40), 5, 7, 0.5),
                 ("Cin 26 -> 16, Y 7, X 36", (5, 7, 36), 26, 16, 0.4),
                 ("Cin 3 -> 40 (Cout > Cin), dense, X 33", (3, 6, 33), 3,
                  40, 1.0),
                 ("C48 -> 40, all-zero input", (4, 8, 40), 48, 40, 0.0),
                 ("Cin 33 -> 1, dense, X 70", (3, 5, 70), 33, 1, 1.0),
                 ("C64 -> 64, dense", (3, 4, 40), 64, 64, 1.0),
                 ("Cin 1 -> 1, dense, X 5", (2, 3, 5), 1, 1, 1.0),
                 ("C16 -> 16, input 2 bytes off 16", (3, 6, 45), 16, 16,
                  0.5)]
        for i, (label, dims, cin, cout, dens) in enumerate(cases):
            keep = torch.rand(2, *dims, generator=torch.Generator()
                              .manual_seed(70 + i)) < dens
            x = torch.randn(2, *dims, cin, device=self.dev,
                            generator=gen) * keep.to(self.dev)[..., None]
            w = torch.from_numpy(self.weights(27, cin, cout)).to(self.dev)
            shifted = "off 16" in label

            def make(dt, x=x, w=w, shifted=shifted):
                xd = x.to(dt)
                if shifted:  # a view one element into its storage
                    buf = torch.empty(xd.numel() + 1, dtype=dt,
                                      device=self.dev)
                    xd = buf[1:].view(xd.shape).copy_(xd)
                return lambda impl: (K_cl.conv3d_3x3x3(xd, w, impl=impl),)
            self.run("conv3d", f"edge C{cin}->{cout} B2 {label}", make, [0],
                     dense=True, exact=dens == 0.0)

    def k3_edge_cases(self):
        """K3 where its Hopper design has edges (fine output bricks of 2 x
        4 x 32 voxels over the padded fine grid, ring included; a coarse
        window of 3 x 4 x 18 voxels a group staged by cp.async; rows
        grouped by parity): fine Y + 2 not a multiple of the brick, a fine
        x tail (fewer fine x blocks than twice the coarse ones), 1-4
        groups with widths below cpad, cpad 8 and 16, with and without the
        affine, the fine mask given (training) and expanded from the
        coarse one (serving), on random, full, empty and single-voxel
        masks. Inputs without an affine are dense (the kernel reads coarse
        neighbours whose mask is 0)."""
        FO = self.FO
        # cpad, widths, affine, fine mask given, mask kind, coarse dims
        cases = [(16, [16], True, False, "random", (3, 4, 70)),
                 (16, [16, 5, 16, 2], True, True, "random", (3, 5, 40)),
                 (8, [8], False, False, "full", (4, 4, 40)),
                 (8, [3, 8], True, True, "single", (3, 5, 24)),
                 (16, [16, 16], False, True, "empty", (2, 3, 40)),
                 (16, [6], False, False, "single", (3, 4, 70)),
                 (8, [8, 8, 1, 4], True, False, "full", (2, 5, 40)),
                 (16, [16, 8, 16], True, False, "empty", (3, 4, 40))]
        for i, (cpad, widths, has_aff, given, kind, cdims) in enumerate(
                cases):
            fdims = tuple(2 * d for d in cdims)
            g = torch.Generator().manual_seed(30 + i)

            def mask_of(dims, g=g, kind=kind):
                if kind == "single":
                    m = torch.zeros(1, *dims, dtype=torch.bool)
                    m[0, dims[0] // 2, dims[1] - 1, dims[2] // 2 + 1] = True
                    return m
                return {"random": torch.rand(1, *dims, generator=g) < 0.3,
                        "full": torch.ones(1, *dims, dtype=torch.bool),
                        "empty": torch.zeros(1, *dims, dtype=torch.bool)
                        }[kind]
            cm = mask_of(cdims)
            cfm = self.mask(cm, cpad)
            ffm = self.mask(mask_of(fdims), cpad) if given else None
            data = cm if has_aff else torch.ones_like(cm)
            gs = [self.grid(cdims, c, cpad, data) for c in widths]
            w27 = self.weights(27, sum(widths), cpad)
            aff = self.affines(widths) if has_aff else None

            def up(dt, gs=gs, cfm=cfm, ffm=ffm, w27=w27, aff=aff,
                   widths=widths, cpad=cpad, i=i):
                w = FO.prep_upconv_weights(
                    w27, widths, torch.float32 if i % 2 == 0 else dt
                ).to(self.dev)
                grp = [x.with_data(x.data.to(dt)) for x in gs]
                m = cfm.with_data(cfm.data.to(dt))
                f = ffm.with_data(ffm.data.to(dt)) if ffm is not None \
                    else None
                return lambda impl: (FO.upconv_fused(
                    grp, m, f, w, cpad, aff=aff, impl=impl).data,)
            xqf = (ffm.data.shape[3] if given
                   else FO._xq_for(2 * cdims[2], cpad))
            label = (f"edge cpad{cpad} G{len(widths)} {widths} "
                     f"{'affine' if has_aff else 'raw'} "
                     f"fmask={'given' if given else 'None'} {kind} mask, "
                     f"coarse {cdims} xq {cfm.data.shape[3]} -> {xqf}")
            self.run("upconv", label, up, [0],
                     exact=kind == "empty")

    def k4_edge_cases(self):
        """K4 where its Hopper design has edges (a thread per 16-byte output
        chunk, 2-4 threads a voxel, warps over rows (b, z, y), ring rows
        written zero, UNROLL chunks a thread at a time): gate with and
        without the raw output, mask_scale 1 and 2 (2 x xqm == xq, and an
        odd xq = 2 x xqm - 1), summed over 1 and 4 groups of widths 1 and 5
        < cpad; cpad 8 and 16, batch 2, Y != X, x slots past the real X (x
        blocks cut from the folded 8-block multiple), all-zero and all-ones
        masks and a mask holding -0 (an inactive voxel: the kernel tests
        values, not bits). Each in f32 and bf16."""
        from sgnn_tpu_torch.ops.kernels import head as K_head

        FO = self.FO
        B = 2

        def folded(t, cpad, xq):
            return FO.fold(t, cpad).data[:, :, :, :xq].contiguous()

        def mask_of(dims, kind, seed):
            if kind == "zero":
                return torch.zeros(B, *dims, dtype=torch.bool)
            if kind == "ones":
                return torch.ones(B, *dims, dtype=torch.bool)
            return torch.rand(B, *dims, generator=torch.Generator()
                              .manual_seed(seed)) < 0.3

        def mask_grid(m, cpad, xq, neg_zero=False):
            g = folded(m.to(self.dev, torch.float32)[..., None]
                       .expand(*m.shape, cpad), cpad, xq)
            if neg_zero:  # every other voxel's 0 as -0
                s = _slots(g, cpad)[..., ::2, :]
                s[s == 0] = -0.0
            return g

        # label, fine dims, cpad, width, mask_scale, emit_raw, mask kind,
        # x blocks kept (fine; the coarse mask keeps ceil(xq / 2)), -0
        gates = [("Y != X, 40 of 48 x slots, raw", (5, 7, 40), 16, 16, 1,
                  True, "random", 6, False),
                 ("width 5, 50 of 64 x slots", (4, 6, 50), 8, 5, 1,
                  False, "ones", 4, False),
                 ("mask_scale 2, xq == 2 xqm, raw", (6, 8, 48), 16, 16, 2,
                  True, "random", 6, False),
                 ("mask_scale 2, odd xq = 2 xqm - 1", (4, 6, 80), 8,
                  8, 2, False, "random", 5, False),
                 ("all-zero mask, raw", (3, 5, 32), 16, 16, 1, True, "zero",
                  4, False),
                 ("mask holding -0, raw", (4, 9, 24), 16, 16, 1, True,
                  "random", 3, True),
                 ("mask_scale 2, all-ones, raw", (6, 4, 64), 8, 8, 2,
                  True, "ones", 4, False)]
        bh = FO.prep_bias(np.array([0.1, -0.2], np.float32)).to(self.dev)
        for i, (label, dims, cpad, c, scale, raw, kind, xq, nz) in \
                enumerate(gates):
            mdims = tuple(d // scale for d in dims)
            mm = mask_of(mdims, kind, 40 + i)
            d = torch.randn(B, *dims, c, device=self.dev, generator=self.gen)
            # the input is dense: its values where the mask is 0 must not
            # reach the outputs
            x = folded(d, cpad, xq)
            mg = mask_grid(mm, cpad, -(-xq // 2) if scale == 2 else xq, nz)
            w = FO.prep_head_weights(self.weights(c, 2), [c],
                                     torch.float32)[0].to(self.dev)
            aff = self.affines([c])[0]
            values = [0, 1, 3] if raw else [0, 1]

            def gate(dt, x=x, mg=mg, w=w, aff=aff, cpad=cpad, scale=scale,
                     raw=raw):
                xd, md = x.to(dt), mg.to(dt)
                return lambda impl: K_head.head_gate(
                    xd, md, w, bh, aff, cpad, mask_scale=scale,
                    emit_raw=raw, impl=impl)
            self.run("head_gate_raw" if raw else "head_gate",
                     f"edge cpad{cpad} B2 {label}", gate, values,
                     gate_cpad=cpad, exact=kind == "zero")

        # label, dims, cpad, widths, mask kind, x blocks kept, -0
        sums = [("G1 width 1, Y != X", (5, 9, 30), 8, [1], "random", 2,
                 False),
                ("G4 widths 5 16 1 8, 40 of 48 x slots", (4, 6, 40), 16,
                 [5, 16, 1, 8], "random", 6, False),
                ("G4 all-ones mask", (3, 4, 64), 16, [16, 16, 16, 16],
                 "ones", 8, False),
                ("G1 width 5, all-zero mask", (4, 5, 70), 8, [5], "zero",
                 5, False),
                ("G4 widths 5 1 8 8, mask holding -0", (3, 7, 16), 8,
                 [5, 1, 8, 8], "random", 1, True)]
        bs = FO.prep_bias(np.array([0.05], np.float32)).to(self.dev)
        for i, (label, dims, cpad, widths, kind, xq, nz) in enumerate(sums):
            mg = mask_grid(mask_of(dims, kind, 50 + i), cpad, xq, nz)
            xs = [folded(torch.randn(B, *dims, c, device=self.dev,
                                     generator=self.gen), cpad, xq)
                  for c in widths]
            w = FO.prep_head_weights(self.weights(sum(widths), 1), widths,
                                     torch.float32).to(self.dev)
            aff = self.affines(widths)

            def summed(dt, xs=xs, mg=mg, w=w, aff=aff, widths=widths,
                       cpad=cpad):
                xd, md = [x.to(dt) for x in xs], mg.to(dt)
                return lambda impl: (K_head.head_sum(
                    xd, md, w, bs, aff, widths, cpad, impl=impl),)
            self.run("head_sum", f"edge cpad{cpad} B2 {label}", summed, [0],
                     exact=kind == "zero")

    def k10_edge_cases(self):
        """K10 at the seams of its Hopper design (tiles of 128 rows and 16
        columns, a tap's channels staged by cp.async as one unit of at most
        64, weights in shared memory): 1000 rows (no multiple of the tile)
        of a random table, half the neighbours present; in one tile four
        taps no row has, one tile with no neighbour at all, and entries
        outside [1, n] that the kernel must read as missing (the plain
        version gets them as 0); cin 34 (68-byte rows, 4-byte copies), 12
        (8-byte), 1 (2-byte rows, plain loads), 8, 26, 48, and 80 and 200
        (several units a tap; at 200 the weights are staged in windows);
        cout 8, 12, 16 and 20 (two column groups); K = 27 and K = 8; f32
        and bf16."""
        from sgnn_tpu_torch.ops.kernels import gather_gemm as K_gg

        n = 1000
        g = torch.Generator().manual_seed(9)
        tables = {}
        for K in (27, 8):
            nbr = torch.randint(1, n + 1, (n, K), generator=g,
                                dtype=torch.int32)
            nbr[torch.rand(n, K, generator=g) < 0.5] = 0
            nbr[128:256, [0, 5, K // 2, K - 1]] = 0  # taps no row has
            nbr[384:512] = 0  # a tile with no neighbour
            nbr[700, 1] = nbr[701, 2] = nbr[702, 3] = 0
            junk = nbr.clone()
            junk[700, 1], junk[701, 2], junk[702, 3] = n + 1, -3, 2 ** 30
            tables[K] = junk.to(self.dev), nbr.to(self.dev)
        for K, cin, cout in ((27, 34, 16), (27, 12, 12), (27, 1, 8),
                             (27, 8, 8), (27, 26, 16), (27, 48, 12),
                             (8, 16, 16), (8, 34, 8), (27, 80, 20),
                             (27, 200, 16)):
            f = torch.randn(n, cin, device=self.dev, generator=self.gen)
            w = torch.from_numpy(self.weights(K, cin, cout)).to(self.dev)
            junk, clean = tables[K]

            def make(dt, f=f, w=w, junk=junk, clean=clean):
                fd = f.to(dt)
                return lambda impl: (K_gg.gather_gemm(
                    fd, junk if impl is None else clean, w, impl=impl),)
            self.run("gather_gemm", f"edge K{K} {cin}->{cout} {n} rows", make,
                     [0], dense=True)
            out = make(torch.bfloat16)(None)[0]
            require(not out[384:512].any(),
                    f"gather_gemm edge K{K} {cin}->{cout}: the tile with no "
                    f"neighbour is not zero")

    def training_cases(self):
        """K7 and K4's raw mode at the training shapes: batch 8 at
        128x64x64, the input masked by a shell per sample."""
        FO = self.FO
        from sgnn_tpu_torch.ops.kernels import conv_raw as K_raw
        from sgnn_tpu_torch.ops.kernels import head as K_head

        B = TRAIN_BATCH

        def masked(dims, c, cpad):
            m = _shell(dims, 4.0).expand(B, *dims)
            d = torch.randn(B, *dims, c, device=self.dev, generator=self.gen)
            return FO.fold(d * m.to(self.dev)[..., None], cpad).data, m

        def conv_case(label, dims, cpad, cin, cout, dtypes, flipped=False,
                      timed=False, log_ms=()):
            x, _ = masked(dims, cin, cpad)
            w27 = torch.from_numpy(self.weights(27, cin, cout))
            if flipped:  # the input gradient's call: flipped, transposed
                w27 = torch.flip(w27.reshape(3, 3, 3, cin, cout), (0, 1, 2))
                w27 = w27.reshape(27, cin, cout).transpose(1, 2)
                cin, cout = cout, cin
                # a cotangent: non-zero at every interior voxel
                g = torch.randn(B, *dims, cin, device=self.dev,
                                generator=self.gen)
                x = FO.fold(g, cpad).data
            w = FO._prep_taps(w27, torch.float32).to(self.dev)

            def make(dt):
                xd, wd = x.to(dt), FO._prep_taps(w27, dt).to(self.dev)
                return lambda impl: (K_raw.conv_raw(xd, wd, cin, cpad,
                                                    impl=impl),)

            def work(dt):
                nz = int((_slots(x, cpad)[..., :cin] != 0).any(-1).sum())
                return _nbytes(x.to(dt), w), 2 * 27 * cin * cout * nz
            self.run("conv_raw", label, make, [0], dense=True, dtypes=dtypes,
                     work=work if timed else None,
                     library=_library_conv((B, cin, *dims), cout, 3,
                                           padding=1) if timed else None)
            _log_ms("conv_raw", label, make, log_ms)

        full = TRAIN_DIMS
        conv_case("cpad16 16->16 B8 128x64x64", full, 16, 16, 16,
                  (torch.float32, torch.bfloat16), timed=True,
                  log_ms=(torch.float32,))
        conv_case("cpad8 8->8 B8 128x64x64", full, 8, 8, 8,
                  (torch.bfloat16,))
        conv_case("cpad16 12->9 B8 128x48x64 (Y != X)", (128, 48, 64), 16,
                  12, 9, (torch.float32, torch.bfloat16))
        conv_case("input gradient: flipped taps 16->12", full, 16, 12, 16,
                  (torch.float32, torch.bfloat16), flipped=True,
                  log_ms=(torch.float32, torch.bfloat16))
        self.k7_edge_cases()

        # K4 with the raw output at the finest training level: mask_scale
        # 1 with the materialized fine mask, as the training step calls it
        up, m = masked(full, 16, 16)
        fm = FO.fold_mask(m.to(self.dev), 16, torch.float32).data
        wh = FO.prep_head_weights(self.weights(16, 2), [16],
                                  torch.float32)[0].to(self.dev)
        bh = FO.prep_bias(np.array([0.1, -0.2], np.float32)).to(self.dev)
        affh = self.affines([16])[0]

        def raw(dt):
            u, mm = up.to(dt), fm.to(dt)
            return lambda impl: K_head.head_gate(u, mm, wh, bh, affh, 16,
                                                 emit_raw=True, impl=impl)

        def raw_work(dt):
            # the input only at active voxels, the mask in full
            return (_grid_bytes([FO.FGrid(up, full, 16, 16)], dt, m)
                    + _nbytes(fm.to(dt), wh, bh, affh),
                    2 * 16 * 2 * _active(fm, 16))
        self.run("head_gate_raw", "B8 128x64x64 mask_scale 1", raw,
                 [0, 1, 3], gate_cpad=16, work=raw_work)
        self.k4_edge_cases()

    def k7_edge_cases(self):
        """K7 where its Hopper design has edges (output bricks of 2 x 4 x 32
        voxels of the unpadded grid): Z, Y and the x slots not multiples of
        the brick, x-tail slots past the real X (non-zero where a neighbour
        is), an all-zero input (every brick skipped: exact zeros), cpad 8
        with cin 1 and 5 < cpad; batch 2, inputs on random masks."""
        from sgnn_tpu_torch.ops.kernels import conv_raw as K_raw

        FO = self.FO
        # label, dims, cpad, cin, cout, input density, x blocks kept (the
        # folded grid pads them to a multiple of 8)
        cases = [("Z 5, Y 7, 40 x slots", (5, 7, 40), 16, 16, 16, 0.3, 5),
                 ("x tail: X 20 of 24 slots", (6, 9, 20), 16, 12, 16, 0.5,
                  3),
                 ("all-zero input", (8, 12, 64), 16, 16, 16, 0.0, 8),
                 ("cpad8 cin 1, X 50 of 64 slots", (7, 10, 50), 8, 1, 8, 0.4,
                  4),
                 ("cpad8 cin 5 -> 3, 16 x slots", (3, 5, 16), 8, 5, 3, 1.0,
                  1)]
        for i, (label, dims, cpad, cin, cout, p, xq) in enumerate(cases):
            m = torch.rand(2, *dims, generator=torch.Generator()
                           .manual_seed(10 + i)) < p
            d = torch.randn(2, *dims, cin, device=self.dev,
                            generator=self.gen)
            x = FO.fold(d * m.to(self.dev)[..., None], cpad).data
            x = x[:, :, :, :xq].contiguous()
            w27 = torch.from_numpy(self.weights(27, cin, cout))

            def make(dt, x=x, w27=w27, cin=cin, cpad=cpad):
                xd, wd = x.to(dt), FO._prep_taps(w27, dt).to(self.dev)
                return lambda impl: (K_raw.conv_raw(xd, wd, cin, cpad,
                                                    impl=impl),)
            self.run("conv_raw", f"edge cpad{cpad} {cin}->{cout} B2 {label}",
                     make, [0], dense=True, exact=p == 0.0)


# ------------------------------------------------------------------ phase 4


def _int8_step(name, args, kw) -> float:
    """An int8 site call's activation step, one int8 value moved by one:
    the largest tile scale times the largest column scale times 127, that
    is the largest |input| over every group times the largest column
    scale; 0 for the other kernels. Arguments as the wrappers take them:
    conv_site_q(xs, mask, wq, ws, cins, cpad), downconv_q(x, fmask, wq,
    ws, cin, cpad, ...), upconv_q(xs, cmask, fmask, wq, ws, cins, cpad,
    ...)."""
    if name == "conv_site_q":
        xs, mask, ws, cpad, aff = args[0], args[1], args[3], args[5], \
            kw.get("aff")
    elif name == "downconv_q":
        aff = kw.get("aff")
        xs, mask, ws, cpad = [args[0]], args[1], args[3], args[5]
        aff = aff[None] if aff is not None else None
    elif name == "upconv_q":
        xs, mask, ws, cpad, aff = args[0], args[1], args[4], args[6], \
            kw.get("aff")
    else:
        return 0.0
    return _activation_step(xs, mask, aff, cpad, ws)


def _activation_step(xs, mask, aff, cpad, ws) -> float:
    from sgnn_tpu_torch.ops.quant import site_input

    amax = max(float(site_input(x, mask, aff, g, cpad).abs().max())
               for g, x in enumerate(xs))
    return amax * float(ws.max())


class MainPathCheck:
    """While active, every kernel wrapper call that launches its kernel
    also runs the plain version on the same inputs and compares the two
    (_compare), so each kernel is checked on the main path's own data.
    Counters advance as usual: use it only after the counted run."""

    # wrapper -> (indices of value outputs, of mask outputs, gate output?,
    # dense output without a halo ring?)
    SPECS = {"conv_site": ([0], [], False, False),
             "downconv": ([0], [1], False, False),
             "upconv": ([0], [], False, False),
             "head_gate": ([0, 1], [], True, False),
             "head_gate_raw": ([0, 1, 3], [], True, False),
             "head_sum": ([0], [], False, False),
             "surf_head": ([0], [], False, True),
             "scatter": ([0], [0, 1], False, False),
             "conv_raw": ([0], [], False, True),
             "conv3d_folded": ([0], [], False, True),
             "conv3d": ([0], [], False, True),
             "gather_gemm": ([0], [], False, True),
             "conv_site_q": ([0], [], False, False),
             "downconv_q": ([0], [1], False, False),
             "upconv_q": ([0], [], False, False),
             "tile_amax": ([], [0], False, True)}
    # kernels that must give their plain versions' bits: the int8 sites sum
    # integers exactly and dequantize in the plain version's order
    EXACT = {"conv_site_q", "downconv_q", "upconv_q"}
    # wrapper attributes whose counter has another name
    COUNTER = {"conv3d_3x3x3_folded": "conv3d_folded",
               "conv3d_3x3x3": "conv3d"}

    def __init__(self):
        from sgnn_tpu_torch.ops.kernels import conv3d_cl, conv_raw, \
            conv_site, downconv, gather_gemm, head, scatter, surf_head, \
            tile_amax, upconv

        # wrapper function (module attribute) -> its module; the gated
        # head's calls with the raw output count under head_gate_raw
        self.mods = {"conv_site": conv_site, "downconv": downconv,
                     "upconv": upconv, "head_gate": head, "head_sum": head,
                     "surf_head": surf_head, "scatter": scatter,
                     "conv_raw": conv_raw, "conv3d_3x3x3_folded": conv3d_cl,
                     "conv3d_3x3x3": conv3d_cl, "gather_gemm": gather_gemm,
                     "conv_site_q": conv_site, "downconv_q": downconv,
                     "upconv_q": upconv, "tile_amax": tile_amax}
        self.stats = {n: {"calls": 0, "err": 0.0, "ratio": 0.0, "flips": 0,
                          "beyond": 0} for n in self.SPECS}
        self.saved = {}

    def _wrap(self, fn_name, orig):

        def checked(*args, impl=None, **kw):
            out = orig(*args, impl=impl, **kw)
            if impl is not None:
                return out
            name = ("head_gate_raw" if kw.get("emit_raw")
                    else self.COUNTER.get(fn_name, fn_name))
            values, masks, gate, dense = self.SPECS[name]
            ref = orig(*args, impl="plain", **kw)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            st = self.stats[name]
            err, ratio, flips, _, far = _compare(
                f"main path {name} call {st['calls']}", outs, refs, values,
                masks, args[5] if gate else 0, kw.get("residual"), dense,
                _int8_step(name, args, kw))
            require(name not in self.EXACT or err == 0.0,
                    f"main path {name} call {st['calls']}: max |kernel - "
                    f"plain| {err}, expected 0")
            st["calls"] += 1
            st["err"] = max(st["err"], err)
            st["ratio"] = max(st["ratio"], ratio)
            st["flips"] += flips
            st["beyond"] += far
            return out
        return checked

    def __enter__(self):
        for name, mod in self.mods.items():
            self.saved[name] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.saved[name])


def _surface_agreement(a: dict, b: dict):
    """(IoU of the two surfaces, |sdf diffs| on the common voxels, scale)."""
    ka = dict(zip(map(tuple, a["surf_locs"]), a["surf_sdf"]))
    kb = dict(zip(map(tuple, b["surf_locs"]), b["surf_sdf"]))
    common = ka.keys() & kb.keys()
    iou = len(common) / max(len(ka.keys() | kb.keys()), 1)
    diff = np.abs(np.array([ka[v] - kb[v] for v in common] or [np.inf]))
    return iou, diff, float(np.abs(b["surf_sdf"]).max())


def phase_forward(results: dict) -> tuple:
    """Phase 4; returns (model, weights) for the serve phase."""
    import dataclasses

    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import init_params, load_jax_params

    cfg = SGNNConfig(input_dim=SCENE, batch_size=1,
                     occupancy_fractions=FRACTIONS,
                     compute_dtype="bfloat16")
    model = GenModelFolded(cfg).cuda()
    scenes = [synthetic_scene(SCENE, seed=s, truncation=cfg.truncation)
              for s in range(N_SCENES)]
    log(f"[forward] config L={cfg.num_hierarchy_levels} encoder_dim="
        f"{cfg.encoder_dim} nf={cfg.nf} nf_coarse={cfg.nf_coarse} "
        f"{cfg.compute_dtype}; scene {SCENE}, "
        f"{len(scenes[0]['input_locs'])} active input voxels")
    infer = SceneInferencer(model)
    for seed in range(4):  # a seed whose random weights open the gates
        weights = init_params(cfg, seed)
        load_jax_params(model, *weights)
        warm = infer(scenes[0])
        log(f"[forward] weights seed {seed}: active per level "
            f"{warm['level_active']}")
        if len(warm["surf_locs"]):
            break
    require(len(warm["surf_locs"]) > 0, "every seed closed the surface")

    # the main path: three scenes, counted and timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    outs, host_ms = [], []
    for s in scenes:
        t0 = time.perf_counter()
        outs.append(infer(s))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        log(f"[forward] {name}: {n} launches over {N_SCENES} scenes = "
            f"{n / N_SCENES:g} per forward (expected {EXPECTED[name]})")
        if EXPECTED[name]:
            require(n > 0, f"{name} was not launched by the main path")
        else:
            require(n == 0, f"{name} was launched by the main path")
        results[name]["launches"] = n
    for o in outs:
        require(len(o["surf_locs"]) > 0, f"{o['name']}: empty surface")
        require(np.isfinite(o["surf_sdf"]).all(), "non-finite surface sdf")
        require(np.isfinite(o["levels"][0]["dense_out"]).all(),
                "non-finite coarse output")
        require((o["surf_locs"] < np.asarray(SCENE)).all(), "bad locs")
        log(f"[forward] scene {o['name']}: active per level "
            f"{o['level_active']}, surface {len(o['surf_locs'])} voxels")
    log(f"[forward] ms/scene (host clock, SceneInferencer call): "
        f"{' '.join(f'{t:.2f}' for t in host_ms)}; peak device memory "
        f"{peak / 2**20:.1f} MiB")

    # device time of the forward alone, after warm-up
    s0 = scenes[0]
    locs, feats = _rows(s0)
    for impl in (None, "plain", None, "plain"):
        ms = _time_ms(lambda: model(locs, feats, SCENE, impl=impl), reps=3)
        log(f"[forward] forward {'kernels' if impl is None else 'plain'}: "
            f"{ms:.2f} ms (CUDA events, mean of 3)")

    # every kernel call of one forward against its plain version there
    with MainPathCheck() as chk:
        infer(s0)
    for name, st in chk.stats.items():
        log(f"[forward] main-path inputs, {name}: {st['calls']} calls, max "
            f"|kernel - plain| {st['err']:.3e} (at most {st['ratio']:.2f} "
            f"of tol), gate flips {st['flips']}")
        if EXPECTED[name]:
            require(st["calls"] > 0, f"{name} unchecked on the main path")

    # whole forward, kernels vs plain versions on the card, f32 and bf16
    model32 = GenModelFolded(dataclasses.replace(
        cfg, compute_dtype="float32")).cuda()
    load_jax_params(model32, *weights)
    trunk_in = {}
    hook = model32.trunk.register_forward_pre_hook(
        lambda mod, args: trunk_in.setdefault("x", args[0].clone()))
    iou, diff, scale = _agreement("float32", "kernels", "plain",
                                  SceneInferencer(model32)(s0),
                                  SceneInferencer(model32, impl="plain")(s0))
    hook.remove()
    require(iou >= MIN_IOU_F32, f"f32 surface IoU {iou}")
    require(diff.max() <= MAX_SDF_REL_F32 * scale,
            f"f32 sdf diff {diff.max()}")
    host = GenModelFolded(cfg)
    load_jax_params(host, *weights)
    t0 = time.perf_counter()
    runs = {"kernels": SceneInferencer(model)(s0),
            "plain": SceneInferencer(model, impl="plain")(s0),
            "plain again": SceneInferencer(model, impl="plain")(s0)}
    t1 = time.perf_counter()
    runs["plain on the host CPU"] = SceneInferencer(host)(s0)
    log(f"[forward] bfloat16 plain forward on the host CPU: "
        f"{time.perf_counter() - t1:.1f} s ({torch.get_num_threads()} "
        f"threads; the three runs on the card {t1 - t0:.1f} s)")
    ious = {pair: _agreement("bfloat16", *pair, runs[pair[0]],
                             runs[pair[1]])[0]
            for pair in (("kernels", "plain"), ("plain again", "plain"),
                         ("plain on the host CPU", "plain"),
                         ("kernels", "plain on the host CPU"))}
    worst = min(ious[("kernels", "plain")],
                ious[("kernels", "plain on the host CPU")])
    require(worst >= MIN_IOU_BF16,
            f"bf16 surface IoU {worst} < {MIN_IOU_BF16}")

    results["head_sum"]["launches"] = _summed_branch(cfg, weights, s0,
                                                     runs["kernels"], model)
    _trunk_repair(model, model32, trunk_in["x"], s0)
    return model, weights


def _rows(scene):
    """A scene sample's input rows as the forward takes them, on the card."""
    locs = torch.zeros(len(scene["input_locs"]), 4, dtype=torch.int64)
    locs[:, :3] = torch.from_numpy(scene["input_locs"].astype(np.int64))
    return locs.cuda(), torch.from_numpy(scene["input_sdf"])[:, None].cuda()


def _summed_branch(cfg, weights, scene, packed, packed_model) -> int:
    """One scene through the summed surface head (surf_pack=False: the
    groups upsampled, then K4 summed mode), the counterpart of the JAX
    package's SGNN_NO_SURFPACK branch; held against the multi-scale head's
    surface (``packed``, from ``packed_model``), and the two forwards
    timed. Returns head_sum's launches on that path."""
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import load_jax_params

    model = GenModelFolded(cfg, surf_pack=False).cuda()
    load_jax_params(model, *weights)
    K.reset_launch_counts()
    summed = SceneInferencer(model)(scene)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    log(f"[summed] launches with surf_pack=False: {counts}")
    require(counts["head_sum"] == 1 and counts["surf_head"] == 0,
            "the summed branch did not run head_sum once instead of "
            "surf_head")
    same_mask = np.array_equal(summed["surf_locs"], packed["surf_locs"])
    require(same_mask, "summed vs packed surface head: masks differ")
    diff = np.abs(summed["surf_sdf"] - packed["surf_sdf"])
    scale = float(np.abs(packed["surf_sdf"]).max())
    log(f"[summed] bfloat16 summed vs packed surface head: mask bit-equal "
        f"({len(packed['surf_locs'])} voxels); sdf "
        f"{'bit-equal' if not diff.any() else 'not bit-equal'}: max |diff| "
        f"{diff.max():.3e} in {int((diff > 0).sum())} voxels (tol "
        f"{MAX_SDF_REL_SURF * scale:.3e})")
    require(diff.max() <= MAX_SDF_REL_SURF * scale,
            f"summed vs packed sdf diff {diff.max()}")

    # the forward's device time and peak memory with each surface head,
    # in turns
    locs, feats = _rows(scene)
    for label, m in (("packed (K5)", packed_model), ("summed", model),
                     ("summed", model), ("packed (K5)", packed_model)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: m(locs, feats, SCENE), reps=3)
        log(f"[summed] forward with the {label} surface head: {ms:.2f} ms "
            f"(CUDA events, mean of 3); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return counts["head_sum"]


def _trunk_repair(model, model32, x32, scene) -> None:
    """The dense trunk carries its own cuDNN flags (ops/dense.py). With the
    process at PyTorch's defaults (TF32 allowed, nondeterministic
    algorithms, here with autotuning on too), two kernel forwards of one
    scene give the same bits, and the f32 trunk matches the host CPU's."""
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.ops import dense

    b = torch.backends.cudnn
    saved = (b.allow_tf32, b.deterministic, b.benchmark)
    b.allow_tf32, b.deterministic, b.benchmark = True, False, True
    try:
        a, c = SceneInferencer(model)(scene), SceneInferencer(model)(scene)
        same = (np.array_equal(a["surf_locs"], c["surf_locs"])
                and np.array_equal(a["surf_sdf"], c["surf_sdf"]))
        log(f"[repair] bfloat16 kernels, two runs of {scene['name']}: "
            f"surface {len(a['surf_locs'])} vs {len(c['surf_locs'])} "
            f"voxels, {'bit-equal' if same else 'DIFFERENT'}")
        require(same, "two kernel forwards of one scene differ")

        host = copy.deepcopy(model32.trunk).cpu()
        want = [t.double() for t in host(x32.cpu())]
        repaired = dense._CUDNN
        defaults = dict(repaired, allow_tf32=True, deterministic=False)
        flags = {"repaired": repaired, "PyTorch's defaults": defaults}
        errs = {}
        for label in flags:
            dense._CUDNN = flags[label]
            try:
                got = [t.double().cpu() for t in model32.trunk(x32)]
            finally:
                dense._CUDNN = repaired
            errs[label] = max(float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(got, want))
            log(f"[repair] float32 trunk on the card vs the host CPU, "
                f"{label} flags: max |diff| / scale {errs[label]:.3e}")
        require(errs["repaired"] <= MAX_TRUNK_REL,
                f"f32 trunk vs CPU {errs['repaired']} > {MAX_TRUNK_REL}")

        # what the deterministic, TF32-free algorithms cost (bf16 model),
        # in turns: repaired, defaults, defaults, repaired
        xb = x32.to(model.dtype)
        for label in ("repaired", "PyTorch's defaults",
                      "PyTorch's defaults", "repaired"):
            dense._CUDNN = flags[label]
            try:
                ms = _time_ms(lambda: model.trunk(xb), reps=20)
            finally:
                dense._CUDNN = repaired
            log(f"[repair] bfloat16 trunk, {label} flags: {ms:.3f} ms "
                f"(CUDA events, mean of 20)")
    finally:
        b.allow_tf32, b.deterministic, b.benchmark = saved


def _agreement(dt, name_a, name_b, a, b):
    """Logs and returns the surface agreement of two runs of one scene."""
    iou, diff, scale = _surface_agreement(a, b)
    log(f"[forward] {dt} {name_a} vs {name_b}: levels {a['level_active']} "
        f"vs {b['level_active']}; surface IoU {iou:.5f}; sdf on the "
        f"common surface: mean |diff| {diff.mean():.3e}, max "
        f"{diff.max():.3e}, scale {scale:.3e}")
    return iou, diff, scale


# ------------------------------------------------------------------ phase 8


def phase_int8(results: dict, weights) -> None:
    """Phase 8: the int8 serving forward (cfg.quantize_int8) on the
    phase-4 weights and sphere scenes through SceneInferencer: launches
    per forward as derived (INT8_EXPECTED), every kernel call of one
    forward against its plain version, f32 kernels vs plain versions,
    bf16 against the plain int8 run and the exact forward, ms per forward
    and peak device memory."""
    import dataclasses

    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import load_jax_params

    cfg = SGNNConfig(input_dim=SCENE, batch_size=1,
                     occupancy_fractions=FRACTIONS,
                     compute_dtype="bfloat16", quantize_int8=True)

    def build(c):
        m = GenModelFolded(c).cuda()
        load_jax_params(m, *weights)
        return m
    model = build(cfg)
    exact = build(dataclasses.replace(cfg, quantize_int8=False))
    scenes = [synthetic_scene(SCENE, seed=s, truncation=cfg.truncation)
              for s in range(N_SCENES)]
    infer = SceneInferencer(model)
    infer(scenes[0])  # warm-up

    # the main path: three scenes, counted and timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    outs, host_ms = [], []
    for sc in scenes:
        t0 = time.perf_counter()
        outs.append(infer(sc))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        want = INT8_EXPECTED[name] * N_SCENES
        if want or n:
            log(f"[int8] {name}: {n} launches over {N_SCENES} scenes "
                f"(expected {want})")
        require(n == want, f"int8 forward: {name} launched {n} times, "
                           f"expected {want}")
    for name in ("conv_site_q", "downconv_q", "upconv_q", "tile_amax"):
        results[name]["launches"] = counts[name]
    for o in outs:
        require(len(o["surf_locs"]) > 0, f"int8 {o['name']}: empty surface")
        require(np.isfinite(o["surf_sdf"]).all(), "int8: non-finite sdf")
        require((o["surf_locs"] < np.asarray(SCENE)).all(), "int8: bad locs")
        log(f"[int8] scene {o['name']}: active per level "
            f"{o['level_active']}, surface {len(o['surf_locs'])} voxels")
    log(f"[int8] ms/scene (host clock, SceneInferencer call): "
        f"{' '.join(f'{t:.2f}' for t in host_ms)}; peak device memory "
        f"{peak / 2**20:.1f} MiB")

    # device time of the forward alone, int8 and exact in turns
    s0 = scenes[0]
    locs, feats = _rows(s0)
    for label, m in (("int8", model), ("exact", exact), ("exact", exact),
                     ("int8", model)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: m(locs, feats, SCENE), reps=3)
        log(f"[int8] bfloat16 forward, {label} sites: {ms:.2f} ms (CUDA "
            f"events, mean of 3); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    # the device's busy time against the host clock: the forward is
    # launched from Python, so the CUDA-event times include host gaps
    for label, m in (("int8", model), ("exact", exact)):
        _profile("int8", f"one bfloat16 forward, {label} sites",
                 lambda m=m: m(locs, feats, SCENE))

    # every kernel call of one forward against its plain version there
    with MainPathCheck() as chk:
        infer(s0)
    for name, st in chk.stats.items():
        want = INT8_EXPECTED[name]
        if want or st["calls"]:
            log(f"[int8] main-path inputs, {name}: {st['calls']} calls, "
                f"max |kernel - plain| {st['err']:.3e} (at most "
                f"{st['ratio']:.2f} of its tolerance), {st['beyond']} "
                f"values beyond the tolerance alone, gate flips "
                f"{st['flips']}")
        require(st["calls"] == want,
                f"int8: {name} checked {st['calls']} times, expected {want}")

    # f32: kernels vs plain versions; bf16: against the plain int8 run and
    # the exact forward (the gate cascade of random weights, PERF.md)
    m32 = build(dataclasses.replace(cfg, compute_dtype="float32"))
    iou, diff, scale = _agreement("float32 int8", "kernels", "plain",
                                  SceneInferencer(m32)(s0),
                                  SceneInferencer(m32, impl="plain")(s0))
    require(iou >= MIN_IOU_F32, f"int8 f32 surface IoU {iou}")
    require(diff.mean() <= MAX_SDF_REL_F32 * scale,
            f"int8 f32 mean sdf diff {diff.mean()}")
    del m32
    plain = SceneInferencer(model, impl="plain")(s0)
    ex = SceneInferencer(exact)(s0)
    require(len(plain["surf_locs"]) > 0, "int8 plain: empty surface")
    _agreement("bfloat16 int8", "kernels", "plain", outs[0], plain)
    _agreement("bfloat16", "int8 kernels", "exact kernels", outs[0], ex)


# ------------------------------------------------------------------ phase 5


def _room_field(dims, seed):
    """A synthetic scanned room in voxel units: (the signed distance of a
    box room, floor, ceiling and walls 4 voxels in from the volume's
    faces, with three boxes standing on its floor; the scanned voxels: the
    volume minus an unscanned corner of the room and four spherical
    holes), both [Z, Y, X]."""
    rng = np.random.RandomState(seed)
    Z, Y, X = dims
    z, y, x = (a.astype(np.float32) for a in np.ogrid[:Z, :Y, :X])
    d = functools.reduce(np.minimum, [z - 4, Z - 5 - z, y - 4, Y - 5 - y,
                                      x - 4, X - 5 - x])
    for _ in range(3):
        h = rng.uniform(6, 20, 3)
        c = [4 + h[0], rng.uniform(h[1] + 8, Y - h[1] - 8),
             rng.uniform(h[2] + 8, X - h[2] - 8)]
        box = functools.reduce(np.maximum, [np.abs(z - c[0]) - h[0],
                                            np.abs(y - c[1]) - h[1],
                                            np.abs(x - c[2]) - h[2]])
        d = np.minimum(d, box)
    zi, yi, xi = np.ogrid[:Z, :Y, :X]
    seen = ~((yi > 0.6 * Y) & (xi > 0.7 * X)) & np.ones(dims, bool)
    for _ in range(4):  # occlusion holes
        c, r = rng.uniform(0, dims), rng.uniform(6, 12)
        seen &= ((zi - c[0]) ** 2 + (yi - c[1]) ** 2
                 + (xi - c[2]) ** 2) > r * r
    return d, seen


def _room(dims, seed, truncation=3.0):
    """The room of _room_field as rows: (target locs zyx, target sdf) over
    the band |sdf| < truncation, and the partial input, the band's scanned
    voxels."""
    d, seen = _room_field(dims, seed)
    band = np.abs(d) < truncation
    locs = np.stack(np.nonzero(band), -1).astype(np.int32)
    sdf = d[band].astype(np.float32)
    keep = seen[band]
    return locs, sdf, locs[keep], sdf[keep]


def _check_meshes(out: str, names: list) -> None:
    """Every room has a non-empty input and predicted mesh inside its
    bounds in ``out``."""
    from sgnn_tpu_torch.meshing.ply import load_ply

    for name, dims in zip(names, SERVE_DIMS):
        bound = np.asarray(dims[::-1], np.float32) - 0.5  # x, y, z
        for kind in ("input-mesh", "pred-mesh"):
            path = os.path.join(out, f"{name}__0__{kind}.ply")
            require(os.path.exists(path), f"no {path}")
            v, _, faces = load_ply(path)
            require(len(faces) >= 1, f"{path}: empty mesh")
            require(((v >= -0.5) & (v <= bound)).all(),
                    f"{path}: vertices outside the scene")
            log(f"[serve] {name} {kind}: {len(v)} vertices, "
                f"{len(faces)} faces")


def phase_serve(model, weights) -> tuple:
    """Reference-format scenes and a .ckpt, both written by the port,
    through the CLI on the card. Returns the weights the CLI served, which
    leave a surface on the rooms."""
    from sgnn_tpu_torch.checkpoint import save_checkpoint
    from sgnn_tpu_torch.data import formats as F
    from sgnn_tpu_torch.data.dataset import SceneDataset
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.meshing.export import save_predictions
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import init_params, load_jax_params
    from sgnn_tpu_torch.tools import test_scene

    with tempfile.TemporaryDirectory() as tmp:
        inp, tgt, out = (os.path.join(tmp, d) for d in ("in", "tgt", "out"))
        os.makedirs(inp)
        os.makedirs(tgt)
        names = []
        t0 = time.perf_counter()
        for i, dims in enumerate(SERVE_DIMS):
            name = f"room{i}"
            t_locs, t_sdf, i_locs, i_sdf = _room(dims, seed=i)
            w2g = np.eye(4, dtype=np.float32)
            F.save_scene(os.path.join(inp, name + "__0__.sdf"),
                         F.SceneVolume(i_locs, i_sdf, dims, 0.02, w2g))
            F.save_scene(os.path.join(tgt, name + "__0__.sdf"),
                         F.SceneVolume(t_locs, t_sdf, dims, 0.02, w2g))
            F.save_known(os.path.join(tgt, name + "__0__.knw"), dims, 0.02,
                         w2g, np.ones(dims, np.uint8))
            names.append(name)
            log(f"[serve] {name}: dims {dims}, {len(i_locs)} input and "
                f"{len(t_locs)} target voxels")
        lst = os.path.join(tmp, "scenes.txt")
        with open(lst, "w") as fh:
            fh.write("\n".join(names) + "\n")
        log(f"[serve] wrote the scenes in {time.perf_counter() - t0:.1f} s")

        # weights that leave a surface on the first room (as in phase 4)
        cfg = model.cfg
        files, _ = F.get_train_files(inp, lst)
        sample = SceneDataset(files[:1], cfg.truncation,
                              cfg.num_hierarchy_levels,
                              max_input_height=128, target_path=tgt)[0]
        for seed in (None, 1, 2, 3):
            if seed is not None:
                weights = init_params(cfg, seed)
                load_jax_params(model, *weights)
            if len(SceneInferencer(model)(sample)["surf_locs"]):
                break
        ckpt = os.path.join(tmp, "model.ckpt")
        save_checkpoint(ckpt, *weights, epoch=0, iteration=0)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        stats = test_scene.main([
            "--input_data_path", inp, "--target_data_path", tgt,
            "--test_file_list", lst, "--model_path", ckpt, "--output", out,
            "--max_input_height", "128", "--compute_dtype", "bfloat16"])
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"[serve] CLI launches over {len(names)} scenes: {counts}")
        require(stats["skipped"] == 0 and stats["num_meshed"] == len(names),
                f"the CLI meshed {stats['num_meshed']} and skipped "
                f"{stats['skipped']} of {len(names)} scenes")
        require(counts["surf_head"] == len(names),
                f"surf_head launched {counts['surf_head']} times for "
                f"{len(names)} scenes")
        for name, n in counts.items():
            if EXPECTED[name]:
                require(n > 0, f"{name} was not launched by the CLI")
        _check_meshes(out, names)
        log(f"[serve] ms per scene, dispatch to collected surface: "
            f"{' '.join(f'{t * 1e3:.1f}' for t in stats['scene_times'])}; "
            f"the CLI from start to the last mesh written: "
            f"{wall * 1e3 / len(names):.1f} ms per scene "
            f"({wall:.2f} s for {len(names)}); peak device memory "
            f"{peak / 2**20:.1f} MiB")

        # the coordinate-list execution through the CLI: K10 at every
        # sparse conv (the CLI's default occupancy fractions)
        out_sparse = os.path.join(tmp, "out_sparse")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        stats = test_scene.main([
            "--input_data_path", inp, "--target_data_path", tgt,
            "--test_file_list", lst, "--model_path", ckpt, "--output",
            out_sparse, "--max_input_height", "128", "--compute_dtype",
            "bfloat16", "--execution", "sparse"])
        wall = time.perf_counter() - t0
        sparse_counts = K.launch_counts()
        log(f"[serve] CLI --execution sparse launches over {len(names)} "
            f"scenes: {sparse_counts}")
        require(stats["skipped"] == 0 and stats["num_meshed"] == len(names),
                f"the sparse CLI meshed {stats['num_meshed']} and skipped "
                f"{stats['skipped']} of {len(names)} scenes")
        want = {k: SECONDARY["gather_gemm"] * len(names)
                if k == "gather_gemm" else 0 for k in sparse_counts}
        require(sparse_counts == want,
                f"the sparse CLI launched {sparse_counts}, expected {want}")
        _check_meshes(out_sparse, names)
        log(f"[serve] CLI --execution sparse: ms per scene, dispatch to "
            f"collected surface: "
            f"{' '.join(f'{t * 1e3:.1f}' for t in stats['scene_times'])}; "
            f"{wall:.2f} s for {len(names)} scenes; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

        # where a scene's time goes: the CLI's stages one after another,
        # without its overlap (host clock; the forward ends in a copy to
        # the host)
        ds = SceneDataset(files, cfg.truncation, cfg.num_hierarchy_levels,
                          max_input_height=128, target_path=tgt)
        infer = SceneInferencer(model)
        for i in range(len(ds)):
            t0 = time.perf_counter()
            sample = ds[i]
            t1 = time.perf_counter()
            r = infer(sample)
            t2 = time.perf_counter()
            save_predictions(os.path.join(tmp, "stages"), r["name"],
                             r["input_locs"], r["input_sdf"],
                             tuple(int(d) for d in r["orig_dims"]),
                             pred_surf=(r["surf_locs"], r["surf_sdf"]),
                             truncation=cfg.truncation)
            t3 = time.perf_counter()
            log(f"[serve] stages of {r['name']} {sample['sdf'].shape}: read "
                f"and pad {(t1 - t0) * 1e3:.1f} ms, forward to the host "
                f"surface {(t2 - t1) * 1e3:.1f} ms, meshes and PLY files "
                f"{(t3 - t2) * 1e3:.1f} ms")

        # every kernel call of the three rooms (padded shapes with Y != X)
        # against its plain version on the same inputs
        with MainPathCheck() as chk:
            for i in range(len(ds)):
                infer(ds[i])
        for name, st in chk.stats.items():
            log(f"[serve] room inputs, {name}: {st['calls']} calls, max "
                f"|kernel - plain| {st['err']:.3e} (at most "
                f"{st['ratio']:.2f} of tol), gate flips {st['flips']}")
            if EXPECTED[name]:
                require(st["calls"] > 0, f"{name} unchecked on the rooms")
        return weights


# ------------------------------------------------------------------ phase 6


def phase_secondary(results: dict, weights) -> None:
    """Phase 6: the secondary executions on the phase-4 weights and
    scene: the coordinate-list execution (GenModelSparse, K10) and the
    dense-flow execution (GenModelDense with use_pallas_conv, K8)."""
    import dataclasses

    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.dense_flow import GenModelDense
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.models.sgnn import GenModelSparse
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import load_jax_params

    base = SGNNConfig(input_dim=SCENE, batch_size=1,
                      occupancy_fractions=FRACTIONS,
                      compute_dtype="bfloat16")
    s0 = synthetic_scene(SCENE, seed=0, truncation=base.truncation)

    def build(cls, cfg, device="cuda"):
        m = cls(cfg).to(device)
        load_jax_params(m, *weights)
        return m

    def with_dtype(cfg, dt):
        return dataclasses.replace(cfg, compute_dtype=dt)

    # capacities: the folded forward's active voxels per level (f32 and
    # bf16) times CAP_HEADROOM; the finest also holds every input row
    active = [SceneInferencer(build(GenModelFolded, with_dtype(base, dt)))(
        s0)["level_active"] for dt in ("float32", "bfloat16")]
    L = base.num_hierarchy_levels
    fr = []
    for h in range(L):
        need = CAP_HEADROOM * max(a[h] for a in active)
        if h == L - 1:
            need = max(need, len(s0["input_locs"]))
        fr.append(min(1.0, need / base.level_voxels(h)))
    sparse16 = dataclasses.replace(base, occupancy_fractions=tuple(fr),
                                   execution="sparse", conv_backend="gather")
    # the same capacities for the dense flow: both inferencers cut the
    # input rows to the finest one, as the JAX inferencer does
    dense16 = dataclasses.replace(sparse16, execution="dense_flow",
                                  use_pallas_conv=True)
    dense16_all = dataclasses.replace(dense16, pallas_min_voxels=0)
    log(f"[secondary] folded active per level {active[0]} (f32), "
        f"{active[1]} (bf16); coordinate-list capacities "
        f"{sparse16.level_capacities} (occupancy fractions "
        f"{[round(f, 4) for f in fr]})")

    # the counted forwards, one scene each: launches as derived
    models = {"coordinate lists": (build(GenModelSparse, sparse16),
                                   "gather_gemm", SECONDARY["gather_gemm"]),
              "dense flow": (build(GenModelDense, dense16), "conv3d_folded",
                             SECONDARY["conv3d_folded"]),
              "dense flow, pallas_min_voxels 0": (
                  build(GenModelDense, dense16_all), "conv3d_folded",
                  K8_ALL_LEVELS)}
    runs16 = {}
    for label, (model, kernel, want) in models.items():
        torch.cuda.synchronize()
        K.reset_launch_counts()
        r = SceneInferencer(model)(s0)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        log(f"[secondary] bfloat16 {label}: {counts[kernel]} {kernel} "
            f"launches (expected {want}); active per level "
            f"{r['level_active']}, surface {len(r['surf_locs'])} voxels"
            + (f"; overflows {r['overflows']}" if "overflows" in r else ""))
        require(counts[kernel] == want,
                f"{label}: {counts[kernel]} {kernel} launches, expected "
                f"{want}")
        require(all(n == 0 for k, n in counts.items() if k != kernel),
                f"{label}: other kernels launched: {counts}")
        require(not any(r.get("overflows", [])),
                f"{label}: capacity overflow {r.get('overflows')}")
        require(np.isfinite(r["surf_sdf"]).all()
                and np.isfinite(r["levels"][0]["dense_out"]).all()
                and all(np.isfinite(lv["out"]).all()
                        for lv in r["levels"][1:]),
                f"{label}: non-finite outputs")
        require((r["surf_locs"] < np.asarray(SCENE)).all(),
                f"{label}: surface voxels outside the scene")
        runs16[label] = r
    results["gather_gemm"]["launches"] = SECONDARY["gather_gemm"]
    results["conv3d_folded"]["launches"] = SECONDARY["conv3d_folded"]
    results["conv3d"]["launches"] = 0  # K9 is on no path

    # the shapes K10 takes on this path: (K, cin, cout, cap, present
    # neighbours) of every call of one coordinate-list forward
    from sgnn_tpu_torch.ops.kernels import gather_gemm as K_gg

    orig_gg, shapes = K_gg.gather_gemm, {}

    def logged(feats, nbr, weight, impl=None):
        shapes.setdefault(tuple(nbr.shape[1:]) + (feats.shape[1],
                                                  weight.shape[2]), []) \
            .append((feats.shape[0], int((nbr > 0).sum())))
        return orig_gg(feats, nbr, weight, impl=impl)
    K_gg.gather_gemm = logged
    try:
        SceneInferencer(models["coordinate lists"][0])(s0)
    finally:
        K_gg.gather_gemm = orig_gg
    for (K, cin, cout), calls in sorted(shapes.items()):
        log(f"[secondary] gather_gemm K {K} cin {cin} cout {cout}: "
            f"{len(calls)} calls, (cap, present neighbours) {calls}")

    # every kernel call of one forward against its plain version there
    with MainPathCheck() as chk:
        for model, _, _ in models.values():
            SceneInferencer(model)(s0)
    for name in ("gather_gemm", "conv3d_folded"):
        st = chk.stats[name]
        want = sum(w for _, k, w in models.values() if k == name)
        log(f"[secondary] forward inputs, {name}: {st['calls']} calls, max "
            f"|kernel - plain| {st['err']:.3e} (at most {st['ratio']:.2f} "
            f"of tol)")
        require(st["calls"] == want,
                f"{name}: {st['calls']} checked calls, expected {want}")

    # f32: the four executions' surfaces on the card
    ref = SceneInferencer(build(GenModelFolded, with_dtype(base,
                                                           "float32")))(s0)
    execs32 = {
        "dense flow (K8)": (GenModelDense, with_dtype(dense16, "float32")),
        "coordinate lists, gather (K10)": (GenModelSparse,
                                           with_dtype(sparse16, "float32")),
        "coordinate lists, dense": (GenModelSparse, dataclasses.replace(
            sparse16, compute_dtype="float32", conv_backend="dense"))}
    for label, (cls, cfg) in execs32.items():
        r = SceneInferencer(build(cls, cfg))(s0)
        iou, diff, scale = _surface_agreement(r, ref)
        log(f"[secondary] float32 {label} vs folded: active per level "
            f"{r['level_active']} vs {ref['level_active']}; surface IoU "
            f"{iou:.5f}, max |sdf diff| {diff.max():.3e} (scale "
            f"{scale:.3e})")
        require(len(ref["surf_locs"]) > 0 and iou >= MIN_IOU_F32,
                f"f32 {label} vs folded: IoU {iou}")
        require(diff.max() <= MAX_SDF_REL_F32 * scale,
                f"f32 {label} vs folded: sdf diff {diff.max()}")

    # bf16: each execution's kernels against its own plain versions, on
    # the card and on the host CPU. A last-ulp difference flips coarse
    # gates that grow into regions, so the surface is held to the
    # agreement the plain versions give with themselves: on the card
    # against the host CPU, and on the card with the input moved by one
    # bf16 rounding (relative 2^-9 noise), the smaller of the two, less
    # BF16_IOU_SLACK
    rng = np.random.RandomState(1)
    moved = dict(s0, input_sdf=(s0["input_sdf"] * (
        1 + 2.0 ** -9 * rng.randn(len(s0["input_sdf"])))).astype(np.float32))
    for label, cls, cfg in (("coordinate lists", GenModelSparse, sparse16),
                            ("dense flow", GenModelDense, dense16)):
        model = models[label][0]
        plain = SceneInferencer(model, impl="plain")(s0)
        t0 = time.perf_counter()
        host = SceneInferencer(build(cls, cfg, "cpu"))(s0)
        host_s = time.perf_counter() - t0
        runs = {"kernels": runs16[label], "plain": plain,
                "plain on the host CPU": host,
                "plain, input moved": SceneInferencer(
                    model, impl="plain")(moved)}
        ious = {pair: _agreement("bfloat16", f"{label} {pair[0]}", pair[1],
                                 runs[pair[0]], runs[pair[1]])[0]
                for pair in (("kernels", "plain"),
                             ("kernels", "plain on the host CPU"),
                             ("plain on the host CPU", "plain"),
                             ("plain, input moved", "plain"))}
        worst = min(ious[("kernels", "plain")],
                    ious[("kernels", "plain on the host CPU")])
        floor = min(ious[("plain on the host CPU", "plain")],
                    ious[("plain, input moved", "plain")]) - BF16_IOU_SLACK
        log(f"[secondary] bfloat16 {label}: kernels vs plain IoU "
            f"{ious[('kernels', 'plain')]:.5f}, vs plain on the host CPU "
            f"{ious[('kernels', 'plain on the host CPU')]:.5f}; plain on "
            f"the card vs the host CPU "
            f"{ious[('plain on the host CPU', 'plain')]:.5f}, vs itself "
            f"with the input moved {ious[('plain, input moved', 'plain')]:.5f}"
            f" (host forward {host_s:.1f} s); kernels held to >= "
            f"{floor:.5f}")
        require(worst >= floor, f"bf16 {label}: IoU {worst} < {floor}")

    # ms per forward (CUDA events, mean of 3) and peak device memory, the
    # kernels and the plain versions in turns
    timed = {"folded": build(GenModelFolded, base),
             "dense flow (K8 at >= 1M voxels)": models["dense flow"][0],
             "dense flow (K8 at every level)":
                 models["dense flow, pallas_min_voxels 0"][0],
             "coordinate lists, gather (K10)":
                 models["coordinate lists"][0],
             "coordinate lists, dense": build(GenModelSparse,
                                              dataclasses.replace(
                                                  sparse16,
                                                  conv_backend="dense"))}
    for label, model in timed.items():
        infer = SceneInferencer(model)
        if label != "folded":
            _profile("secondary", f"one bfloat16 forward, {label}",
                     lambda: infer.dispatch(s0), top=8)
        for impl in (None, "plain", "plain", None):
            infer.impl = impl
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _time_ms(lambda: infer.dispatch(s0), reps=3)
            log(f"[secondary] bfloat16 forward, {label}, "
                f"{'kernels' if impl is None else 'plain'}: {ms:.2f} ms "
                f"(CUDA events, mean of 3, dispatch of one scene); peak "
                f"device memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


# ------------------------------------------------------------------ phase 7


class PlainKernels:
    """While active, every kernel wrapper runs its plain PyTorch version
    (on the card): the whole training step without a hand-written
    kernel."""

    NAMES = {"conv_site": "conv_site", "downconv": "downconv",
             "upconv": "upconv", "head_gate": "head", "head_sum": "head",
             "surf_head": "surf_head", "scatter": "scatter",
             "conv_raw": "conv_raw"}

    def __enter__(self):
        import importlib

        self.saved = []
        for fn, mod in self.NAMES.items():
            m = importlib.import_module(f"sgnn_tpu_torch.ops.kernels.{mod}")
            orig = getattr(m, fn)
            self.saved.append((m, fn, orig))
            setattr(m, fn, functools.partial(_plain_call, orig))
        return self

    def __exit__(self, *exc):
        for m, fn, orig in self.saved:
            setattr(m, fn, orig)


def _plain_call(orig, *args, impl=None, **kw):
    return orig(*args, impl="plain", **kw)


def train_launches(cfg) -> dict:
    """Kernel launches of one full-level train step, from the code
    (models/folded_train.py, ops/folded.py): every U-Net has 3 levels of
    two fused BN -> conv sites (K1) and a down site (K2) between levels;
    each refinement level has an upsample site (K3, over the U-Net's 3
    groups) and a head with the raw output (K4); the surface a summed head
    (K4). K7 runs each training conv site's forward, once per input
    group; in the backward K7 gives the input gradient of every conv site
    whose input needs one (all but the encoder's first, over the scatter's
    grid), of every fused BN -> conv site (one group each), and of the
    upsample sites' composed backward, which recomputes their 3-group conv
    (3 launches) and takes its input gradient (3 more)."""
    from sgnn_tpu_torch.models.folded_flow import refine_widths

    L = cfg.num_hierarchy_levels
    enc, ref = L - 1, L - 1
    ref_w, surf_w = refine_widths(cfg)
    unet_k1, unet_k2 = 2 * 3, 3 - 1
    k7_fwd = enc + sum(len(w) for w in ref_w) + len(surf_w)
    k1 = 2 * enc + (ref + 1) * unet_k1
    k7_bwd = (k7_fwd - 1) + k1 + ref * 2 * 3
    return {"conv_site": k1, "downconv": enc + (ref + 1) * unet_k2,
            "upconv": ref, "head_gate": 0, "head_gate_raw": ref,
            "head_sum": 1, "surf_head": 0, "scatter": 1,
            "conv_raw": k7_fwd + k7_bwd, "conv3d_folded": 0, "conv3d": 0,
            "gather_gemm": 0, "conv_site_q": 0, "downconv_q": 0,
            "upconv_q": 0, "tile_amax": 0}


def _write_chunks(root, n, dims=TRAIN_DIMS, truncation=3.0):
    """``n`` .sdfs chunks of ``dims`` cut from box rooms of
    (dims[0], 2 dims[1], 2 dims[2]), four per room: the input is 40% of
    the room's scanned voxels within the truncation (a sparse scan: a
    chunk's rows stay below the input capacity's share, 1/8 of its
    voxels); the target and its 3 hierarchy levels (factors 2, 4, 8) the
    distance within twice the truncation; known 255 off the scan, else 0.
    Written by the port's save_train_file; returns the paths."""
    from sgnn_tpu_torch.data import formats as F

    Z, Y, X = dims
    paths = []
    rng = np.random.RandomState(0)
    for room in range(-(-n // 4)):
        d, seen = _room_field((Z, 2 * Y, 2 * X), seed=100 + room)
        d = d.astype(np.float32)
        for q in range(4):
            if len(paths) == n:
                break
            y0, x0 = (q // 2) * Y, (q % 2) * X
            dc = d[:, y0:y0 + Y, x0:x0 + X]
            sc = seen[:, y0:y0 + Y, x0:x0 + X]
            inp = (np.abs(dc) < truncation) & sc & (rng.rand(*dims) < 0.4)
            locs = np.stack(np.nonzero(inp), -1).astype(np.int32)

            def band(g):
                return np.where(np.abs(g) < 2 * truncation, g, -np.inf)
            hier = [band(dc[::f, ::f, ::f] / f).astype(np.float32)
                    for f in (8, 4, 2)]
            known = np.where(sc, 0, 255).astype(np.uint8)
            chunk = F.TrainChunk(locs, dc[inp], band(dc), dims, 0.02,
                                 np.eye(4, dtype=np.float32), known, hier)
            path = os.path.join(root, f"room{room}_{q}.sdfs")
            F.save_train_file(path, chunk)
            paths.append(path)
    return paths


def _step(model, batch, lw, plain=False):
    """One full-level train step (lr 1e-3) on a device batch, with the
    kernels or (``plain``) their plain versions; returns its metrics and
    the gradients."""
    from sgnn_tpu_torch.train import state as ST
    from sgnn_tpu_torch.train import step as TS

    opt = ST.make_optimizer(model)
    with PlainKernels() if plain else contextlib.nullcontext():
        m = TS.train_step(model, opt, batch, lw, 1e-3,
                          num_refine_active=model.cfg.num_refine_levels,
                          do_surf=True)
    if batch["input_locs"].is_cuda:
        torch.cuda.synchronize()
    return m, [p.grad.clone() for p in model.weights]


# the hand-written kernels by their CUDA names (csrc/*.cu)
KERNEL_NAMES = {"conv_site_kernel": "K1", "conv_site_q_kernel": "K1q",
                "downconv_kernel": "K2", "downconv_q_kernel": "K2q",
                "upconv_kernel": "K3", "upconv_q_kernel": "K3q",
                "head_gate_kernel": "K4 gate and raw",
                "head_sum_kernel": "K4 summed", "surf_head_kernel": "K5",
                "scatter_kernel": "K6", "conv_raw_kernel": "K7",
                "conv3d_brick_kernel": "K8", "conv3d_any_brick_kernel": "K9",
                "gather_gemm_kernel": "K10", "tile_amax_kernel": "tile_amax"}


def _profile(tag: str, what: str, fn, top: int = 14) -> None:
    """Where one call's device time goes: torch.profiler's CUDA time per
    kernel name (the hand-written kernels and PyTorch's own), the largest
    first, beside the call's host-clock time (ends in a synchronize); then
    each hand-written kernel's rows summed (KERNEL_NAMES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies), not the host ops above
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if "sgnn::" in r[2])
    log(f"[{tag}] profile of {what}: {total:.1f} ms of device time "
        f"(torch.profiler), {ours:.1f} ms of it in the hand-written "
        f"kernels, in {wall:.1f} ms on the host clock (profiled); the "
        f"largest:")
    for t, n, key in rows[:top]:
        log(f"[{tag}]   {t:9.2f} ms {n:5d} x {key[:90]}")
    for name, label in KERNEL_NAMES.items():
        mine = [r for r in rows if f"::{name}<" in r[2]]
        if mine:
            log(f"[{tag}] {label} ({name}) in {what}: "
                f"{sum(r[0] for r in mine):.3f} ms of device time in "
                f"{sum(r[1] for r in mine)} launches (" + "; ".join(
                    f"{t:.3f} ms {n} x {key[:60]}" for t, n, key in mine)
                + ")")


def phase_train(results: dict) -> None:
    """Phase 7."""
    import dataclasses

    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.data.capacity import estimate_row_capacities
    from sgnn_tpu_torch.data.dataset import SceneDataset, collate_sparse
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.models.folded_train import GenModelFoldedTrain
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import init_params, load_jax_params, \
        tree_items
    from sgnn_tpu_torch.tools import train as train_cli
    from sgnn_tpu_torch.train import step as TS

    cfg32 = SGNNConfig(input_dim=TRAIN_DIMS, batch_size=TRAIN_BATCH,
                       compute_dtype="float32")
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    L, B, trunc = cfg32.num_hierarchy_levels, TRAIN_BATCH, cfg32.truncation
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = _write_chunks(tmp, N_CHUNKS)
        caps = estimate_row_capacities(files, L, trunc, B)
        ds = SceneDataset(files, trunc, L, sparse_targets=True)
        batch = collate_sparse([ds[i] for i in range(B)], cfg32.input_cap,
                               *caps)
        log(f"[train] {len(files)} chunks {TRAIN_DIMS} written and batch "
            f"{B} collated in {time.perf_counter() - t0:.1f} s: "
            f"{int(batch['input_num_valid'])} input rows, "
            f"{int(batch['target_num_valid'])} target rows (capacities "
            f"{caps[0]}, {caps[1]})")
        dev = TS.to_device(batch, "cuda")
        weights = init_params(cfg32, seed=0)
        lw = np.ones(L + 1, np.float32)  # every level and the surface

        # f32: kernels vs plain versions, same weights and batch; and the
        # plain versions again with the input features moved by one f32
        # rounding (relative 1e-6 noise), which shows how far the step's
        # gradients move with no hand-written kernel involved
        noisy = dict(dev)
        g = torch.Generator(device="cuda").manual_seed(1)
        noisy["input_sdf"] = dev["input_sdf"] * (1 + 1e-6 * torch.randn(
            dev["input_sdf"].shape, device="cuda", generator=g))
        runs = {}
        for label, plain, b in (("kernels", False, dev), ("plain", True, dev),
                                ("plain, inputs moved", True, noisy)):
            model = GenModelFoldedTrain(cfg32).cuda()
            load_jax_params(model, *weights)
            m, grads = _step(model, b, lw, plain=plain)
            runs[label] = (float(m["loss"]), m["per_level"].cpu().numpy(),
                           grads, [t.cpu() for _, t in
                                   tree_items(model.stat_tree())])
            del model
        keys = GenModelFoldedTrain(cfg32).param_keys
        lp, pp, gp, sp = runs["plain"]
        ratios = {}
        for label in ("kernels", "plain, inputs moved"):
            lk, pk, gk, sk = runs[label]
            r = sorted((float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-12), k)
                       for a, b, k in zip(gk, gp, keys))
            st_err = max(float((a - b).abs().max())
                         / max(float(b.abs().max()), 1.0)
                         for a, b in zip(sk, sp))
            ratios[label] = (r[-1][0], r[len(r) // 2][0])
            log(f"[train] float32 step, {label} vs plain: loss {lk:.6f} vs "
                f"{lp:.6f}; per level {np.round(pk, 5).tolist()} vs "
                f"{np.round(pp, 5).tolist()}; gradients, |a - b| / max |b| "
                f"per parameter: largest {r[-1][0]:.3e} ({r[-1][1]}), "
                f"median {r[len(r) // 2][0]:.3e}; running stats "
                f"{st_err:.3e} of scale")
            if label == "kernels":
                require(np.isfinite(lk)
                        and abs(lk - lp) <= TRAIN_LOSS_REL * abs(lp),
                        f"f32 train loss {lk} vs plain {lp}")
                require(st_err <= TRAIN_STATS_REL,
                        f"f32 running stats {st_err}")
        (k_max, k_med), (n_max, n_med) = (ratios["kernels"],
                                          ratios["plain, inputs moved"])
        for what, k, n in (("largest", k_max, n_max),
                           ("median", k_med, n_med)):
            bound = max(TRAIN_GRAD_REL, 2 * n)
            require(k <= bound, f"f32 gradients, kernels vs plain: {what} "
                                f"{k:.3e} > {bound:.3e}")
        del runs, gp

        # bf16 at full width: the counted main-path step, then every
        # kernel call of a second step held against its plain version
        model = GenModelFoldedTrain(cfg16).cuda()
        load_jax_params(model, *weights)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        m, _ = _step(model, dev, lw)
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = train_launches(cfg16)
        log(f"[train] bfloat16 step: loss {float(m['loss']):.5f}; launches "
            f"{counts} (expected {want}); peak device memory "
            f"{peak / 2**20:.1f} MiB")
        for name, n in counts.items():
            require(n == want[name], f"{name}: {n} launches per train step, "
                                     f"expected {want[name]}")
        for name in ("conv_raw", "head_gate_raw"):
            results[name]["launches"] = counts[name]
        with MainPathCheck() as chk:
            _step(model, dev, lw)
        for name, st in chk.stats.items():
            log(f"[train] step inputs, {name}: {st['calls']} calls, max "
                f"|kernel - plain| {st['err']:.3e} (at most "
                f"{st['ratio']:.2f} of tol), gate flips {st['flips']}")
            require(st["calls"] == want[name],
                    f"{name}: {st['calls']} checked calls, expected "
                    f"{want[name]}")

        # ms per step: kernels, plain, plain, kernels (full-level steps)
        times = {"kernels": [], "plain": []}
        for label in ("kernels", "plain", "plain", "kernels"):
            for _ in range(2):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                _step(model, dev, lw, plain=label == "plain")
                b.record()
                b.synchronize()
                times[label].append(a.elapsed_time(b))
        _profile("train", "one bfloat16 step",
                 lambda: _step(model, dev, lw))
        ms = {k: float(np.median(v)) for k, v in times.items()}
        each = {k: " ".join(f"{t:.1f}" for t in v) for k, v in times.items()}
        log(f"[train] bfloat16 step, batch {B} at {TRAIN_DIMS}: kernels "
            f"{ms['kernels']:.1f} ms (CUDA events, median of "
            f"{each['kernels']}), {B / ms['kernels'] * 1e3:.1f} samples/s; "
            f"plain versions {ms['plain']:.1f} ms (median of "
            f"{each['plain']}); peak device memory {peak / 2**20:.1f} MiB")
        del model

        # the training CLI, in-process, on one chunk (overfit mode)
        lst = os.path.join(tmp, "one.txt")
        with open(lst, "w") as fh:
            fh.write(os.path.basename(files[0]) + "\n")
        save = os.path.join(tmp, "logs")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main([
            "--data_path", tmp, "--train_file_list", lst, "--save", save,
            "--execution", "folded", "--compute_dtype", "bfloat16",
            "--batch_size", str(B), "--num_iters_per_level", "1",
            "--max_steps", "12"])
        wall = time.perf_counter() - t0
        losses = [loss for _, loss in trainer.loss_history]
        log(f"[train] CLI: {len(losses)} steps in {wall:.1f} s; losses "
            f"{' '.join(f'{v:.4f}' for v in losses)}; launches "
            f"{K.launch_counts()}")
        require(len(losses) == 12 and np.isfinite(losses).all(),
                f"CLI losses {losses}")
        require(losses[11] < losses[4], f"the full-level loss did not fall: "
                f"step 4 {losses[4]}, step 11 {losses[11]}")
        ckpt = os.path.join(save, "model-epoch-0.ckpt")
        require(os.path.exists(os.path.join(save, "log.csv"))
                and os.path.exists(ckpt), f"no log.csv or .ckpt in {save}")

        # the checkpoint serves a room
        from sgnn_tpu_torch.tools.test_scene import load_params

        dims = (96, 128, 128)
        serve_cfg = dataclasses.replace(cfg16, batch_size=1)
        served = GenModelFolded(serve_cfg).cuda()
        load_jax_params(served, *load_params(ckpt, serve_cfg))
        _, _, i_locs, i_sdf = _room(dims, seed=7)
        r = SceneInferencer(served)({
            "name": "room7", "sdf": np.zeros(dims, np.float32),
            "input_locs": i_locs, "input_sdf": i_sdf,
            "orig_dims": np.asarray(dims), "world2grid": np.eye(4)})
        require(np.isfinite(r["levels"][0]["dense_out"]).all()
                and np.isfinite(r["surf_sdf"]).all(),
                "the trained checkpoint served non-finite values")
        log(f"[train] the CLI's checkpoint served a {dims} room: active per "
            f"level {r['level_active']}, surface {len(r['surf_locs'])} "
            f"voxels")


# ------------------------------------------------------------------ phase 9

# the drive: rooms from the port's synthetic generator, fused at the
# reference's 2 cm with its 320x240 frames (zParametersScanMP.txt) and cut
# into its 128x64x64 training chunks (the CLIs' defaults); a few training
# steps at full width on the card; the checkpoint through the convert CLI
# both ways; the evaluate CLI on the rooms
DRIVE_ROOMS = 3
DRIVE_FRAMES = 16  # the generator's default is 40
DRIVE_STEPS = 4
# the f32 evaluation on the card and on the host CPU (--cpu): the smallest
# room, cropped to this height (--max_input_height), so the host's plain
# forward takes seconds; the same surface, and the metrics to this
# relative difference (the surfaces' sdf values are the two devices' f32
# sums; each metric is summed in f64)
DRIVE_F32_HEIGHT = 64
DRIVE_METRIC_REL = 1e-5
METRICS = ("l1_pred", "l1_tgt", "iou_surface")


@contextlib.contextmanager
def _collected():
    """Every result SceneInferencer.collect returns while active."""
    from sgnn_tpu_torch.infer import SceneInferencer

    got, orig = [], SceneInferencer.collect

    def spy(self, handle):
        res = orig(self, handle)
        got.append(res)
        return res
    SceneInferencer.collect = spy
    try:
        yield got
    finally:
        SceneInferencer.collect = orig


def _bits_equal(a, b) -> bool:
    from sgnn_tpu_torch.params import tree_items

    ia, ib = list(tree_items(a)), list(tree_items(b))
    return [k for k, _ in ia] == [k for k, _ in ib] and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for (_, x), (_, y) in zip(ia, ib))


def _evaluate(card: str, label: str, args: list) -> tuple:
    """The evaluate CLI in-process on the card, counted: (its metrics
    JSON, launches). Logs launches and ms per scene, and each scene's
    metrics; every metric is finite, and -1 exactly where a scene has no
    surface."""
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.tools import evaluate

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = evaluate.main(args)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    m = res["metrics"]
    n = len(m["scenes"])
    require(res["skipped"] == 0 and n > 0,
            f"evaluate {label}: {res['skipped']} scenes raised")
    per = {k: v / n for k, v in counts.items() if v}
    ms = " ".join(f"{rec['seconds'] * 1e3:.0f}" for rec in m["scenes"])
    log(f"[drive] evaluate {label}: launches per scene {per}")
    log(f"[drive] evaluate {label}: ms per scene (forward and the surface "
        f"to the host, host clock) {ms}; the CLI {wall:.2f} s for {n} "
        f"scenes; {card}")
    for rec in m["scenes"]:
        log(f"[drive] evaluate {label}: {rec['name']} surface "
            f"{rec['surf_voxels']} voxels, "
            + ", ".join(f"{k} {rec[k]:.6f}" for k in METRICS))
        for k in METRICS:
            require(np.isfinite(rec[k])
                    and (rec[k] >= 0) == (rec["surf_voxels"] > 0),
                    f"evaluate {label}: {rec['name']} {k} {rec[k]} with "
                    f"{rec['surf_voxels']} surface voxels")
    log(f"[drive] evaluate {label}: aggregate {m['aggregate']}; measured "
        f"occupancy fractions {m['measured_occupancy_fractions']}")
    return m, counts


def phase_drive(card: str, serve_weights) -> None:
    """Phase 9: the port's whole drive, from data to score."""
    from sgnn_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.data import formats as F
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.tools import convert_checkpoint, evaluate, \
        generate_scans, make_chunks, make_synthetic_scenes
    from sgnn_tpu_torch.tools import train as train_cli
    from sgnn_tpu_torch.utils.ckpt_convert import load_reference_checkpoint

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as base:
        def at(*a):
            return os.path.join(base, *a)
        scenes = at("scenes.txt")

        # 1. the data, on the host
        t0 = time.perf_counter()
        names = make_synthetic_scenes.main([
            "--out", base, "--num_scenes", str(DRIVE_ROOMS),
            "--frames", str(DRIVE_FRAMES)])
        t1 = time.perf_counter()
        fused = generate_scans.main([
            "--scan_path", at("scans"), "--scan_mesh_path", at("meshes"),
            "--scene_file_list", scenes, "--output_complete",
            at("complete"), "--output_incomplete", at("incomplete"),
            "--incomplete_frame_path", at("frames")])
        t2 = time.perf_counter()
        chunks = make_chunks.main([
            "--input_data_path", at("incomplete"), "--target_data_path",
            at("complete"), "--scene_file_list", scenes, "--output",
            at("chunks"), "--list_out", at("chunks.txt")])
        t3 = time.perf_counter()
        require(fused["fused"] == DRIVE_ROOMS and fused["skipped"] == 0,
                f"generate_scans: {fused}")
        require(chunks["skipped"] == 0
                and len(chunks["written"]) >= TRAIN_BATCH,
                f"make_chunks: {len(chunks['written'])} chunks, "
                f"{chunks['skipped']} scenes raised")
        rooms = {}
        for name in names:
            room = name + "_room0__0__.sdf"
            tgt = F.load_scene(at("complete", room))
            inp = F.load_scene(at("incomplete", room))
            rooms[name + "_room0"] = tgt.dims
            log(f"[drive] {name}: dims {tgt.dims}, {len(inp.locs)} input "
                f"and {len(tgt.locs)} target voxels")
        log(f"[drive] host data: {DRIVE_ROOMS} rooms of {DRIVE_FRAMES} "
            f"320x240 frames in {t1 - t0:.2f} s; fused at 2 cm in "
            f"{t2 - t1:.2f} s; {len(chunks['written'])} chunks 128x64x64 "
            f"in {t3 - t2:.2f} s; {os.cpu_count()} host cores; {card}")

        # 2. training on the card, full width, bf16, batch 8
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main([
            "--data_path", at("chunks"), "--train_file_list",
            at("chunks.txt"), "--save", at("logs"), "--execution", "folded",
            "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
            "--num_iters_per_level", "1", "--max_steps", str(DRIVE_STEPS),
            "--max_epoch", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [loss for _, loss in trainer.loss_history]
        counts = K.launch_counts()
        log(f"[drive] train: {len(losses)} steps at batch {TRAIN_BATCH} in "
            f"{wall:.2f} s (the CLI, loading included); losses "
            f"{' '.join(f'{v:.4f}' for v in losses)}; launches "
            f"{ {k: v for k, v in counts.items() if v} }; {card}")
        ckpt = at("logs", "model-epoch-0.ckpt")
        require(len(losses) == DRIVE_STEPS and np.isfinite(losses).all()
                and os.path.exists(ckpt), f"train: losses {losses}")
        require(counts["conv_raw"] > 0 and counts["scatter"] > 0,
                f"train: launches {counts}")

        # 3. .ckpt -> .pth -> .ckpt, bit for bit
        cfg = SGNNConfig(input_dim=TRAIN_DIMS, batch_size=1)
        pth, back = at("model.pth"), at("back.ckpt")
        t0 = time.perf_counter()
        convert_checkpoint.main(["--input", ckpt, "--output", pth])
        convert_checkpoint.main(["--input", pth, "--output", back])
        wall = time.perf_counter() - t0
        a, b = load_checkpoint(ckpt, cfg), load_checkpoint(back, cfg)
        p_ref, s_ref, _ = load_reference_checkpoint(pth, cfg)
        for what, x, y in (("params", a.params, b.params),
                           ("stats", a.stats, b.stats),
                           ("params via the .pth", a.params, p_ref),
                           ("stats via the .pth", a.stats, s_ref)):
            require(_bits_equal(x, y), f"checkpoint round trip: {what} "
                                       f"differ")
        log(f"[drive] checkpoint .ckpt -> .pth -> .ckpt in {wall:.2f} s: "
            f"params and stats bit-equal; {card}")

        # 4. evaluation on the card: the trained weights, then the
        # serve phase's, which leave a surface on rooms
        serve_ckpt = at("serve.ckpt")
        save_checkpoint(serve_ckpt, *serve_weights, epoch=0, iteration=0)
        common = ["--input_data_path", at("incomplete"),
                  "--target_data_path", at("complete"),
                  "--test_file_list", scenes]
        runs = []
        for weights, path in (("trained", pth), ("serve", serve_ckpt)):
            for ex in ("folded", "sparse"):
                args = [*common, "--model_path", path, "--output",
                        at(f"{weights}_{ex}.json"), "--execution", ex]
                runs.append(args)
                m, counts = _evaluate(card, f"{weights} weights, {ex}",
                                      args)
                n = len(m["scenes"])
                if ex == "sparse":
                    want = {k: SECONDARY["gather_gemm"] * n
                            if k == "gather_gemm" else 0 for k in counts}
                    require(counts == want, f"evaluate {weights} sparse: "
                                            f"launches {counts}, expected "
                                            f"{want}")
                else:
                    require(counts["scatter"] == n
                            and counts["conv_site"] > 0,
                            f"evaluate {weights} folded: launches {counts}")
                if weights == "serve" and ex == "folded":
                    for name, c in counts.items():
                        require((c > 0) == (EXPECTED[name] > 0),
                                f"evaluate serve folded: {name} launched "
                                f"{c} times")
                if weights == "serve":
                    require(any(s["surf_voxels"] for s in m["scenes"]),
                            f"the serve weights left no surface "
                            f"({ex})")
        # every kernel call of those evaluations against its plain version
        with MainPathCheck() as chk:
            for args in runs:
                evaluate.main(args)
        for name, st in chk.stats.items():
            log(f"[drive] evaluate inputs, {name}: {st['calls']} calls, max "
                f"|kernel - plain| {st['err']:.3e} (at most "
                f"{st['ratio']:.2f} of tol), gate flips {st['flips']}")
            if EXPECTED[name] or name == "gather_gemm":
                require(st["calls"] > 0, f"{name} unchecked in evaluate")

        # 5. f32: the card against the host CPU, same surface and metrics
        small = min(rooms, key=lambda r: np.prod(rooms[r]))
        with open(at("small.txt"), "w") as fh:
            fh.write(small + "\n")
        f32 = ["--input_data_path", at("incomplete"), "--target_data_path",
               at("complete"), "--test_file_list", at("small.txt"),
               "--model_path", serve_ckpt, "--execution", "folded",
               "--compute_dtype", "float32", "--max_input_height",
               str(DRIVE_F32_HEIGHT)]
        with _collected() as surfaces:
            card_m = evaluate.main([*f32, "--output", at("f32_card.json")])
            t0 = time.perf_counter()
            host_m = evaluate.main([*f32, "--output", at("f32_host.json"),
                                    "--cpu"])
            t_host = time.perf_counter() - t0
        (rc,), (rh,) = (r["metrics"]["scenes"] for r in (card_m, host_m))
        sc, sh = surfaces
        require(len(sh["surf_locs"]) > 0, f"{small}: no f32 surface")
        require(np.array_equal(sc["surf_locs"], sh["surf_locs"]),
                f"{small}: f32 surfaces differ, card {len(sc['surf_locs'])} "
                f"host {len(sh['surf_locs'])} voxels")
        sdf_diff = float(np.abs(sc["surf_sdf"] - sh["surf_sdf"]).max())
        rel = {k: abs(rc[k] - rh[k]) / max(abs(rh[k]), 1e-12)
               for k in METRICS}
        log(f"[drive] f32 {small} cropped to z {DRIVE_F32_HEIGHT}: card and "
            f"host CPU surfaces equal ({len(sh['surf_locs'])} voxels), max "
            f"|sdf diff| {sdf_diff:.3e}; metrics card "
            + ", ".join(f"{k} {rc[k]:.7f}" for k in METRICS) + "; host "
            + ", ".join(f"{k} {rh[k]:.7f}" for k in METRICS)
            + "; relative differences "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f"; ms per scene card {rc['seconds'] * 1e3:.0f}, host CPU "
            f"{rh['seconds'] * 1e3:.0f} ({t_host:.1f} s the host CLI); "
            f"{card}")
        for k, v in rel.items():
            require(v <= DRIVE_METRIC_REL,
                    f"f32 {k}: card {rc[k]} host {rh[k]}")
    log(f"[drive] the phase took {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")


# --------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import sgnn_tpu_torch  # noqa: F401  (fails outside a checkout)
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    t0 = time.time()
    try:
        device = phase_device()
        phase_build()
        results = KernelChecks().all()
        model, weights = phase_forward(results)
        phase_int8(results, weights)
        serve_weights = phase_serve(model, weights)
        phase_secondary(results, weights)
        phase_train(results)
        phase_drive(device["card"], serve_weights)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"[done] {time.time() - t0:.1f} s")
    log(device["card"])  # name, power.limit, as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
