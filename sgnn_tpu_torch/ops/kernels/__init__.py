"""Hand-written CUDA kernels of the serving and training paths, one module
per kernel (K7, ``conv_raw``, and K4's raw mode run only in training; K8
only in the dense-flow execution, K10 only in the coordinate-list one
(its input-gradient mode, ``gather_gemm_dx``, in its training),
K9 on no path; K8 and K9 share ``conv3d_cl``; the int8 modes of K1-K3
sit beside their other modes and share ``tile_amax``'s scale pre-pass).

Each module holds a wrapper (launches the kernel for CUDA tensors), its
plain PyTorch version (taken for CPU tensors, or with ``impl="plain"``)
and a launch counter that only the kernel launch advances.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from sgnn_tpu_torch.ops.kernels import (conv3d_cl, conv_raw, conv_site,
                                        downconv, gather_gemm, head, scatter,
                                        surf_head, tile_amax, upconv)

# counter name -> (module, attribute holding its launch count)
_COUNTERS = {
    "conv_site": (conv_site, "launches"),
    "downconv": (downconv, "launches"),
    "upconv": (upconv, "launches"),
    "head_gate": (head, "gate_launches"),
    "head_gate_raw": (head, "gate_raw_launches"),
    "head_sum": (head, "sum_launches"),
    "surf_head": (surf_head, "launches"),
    "scatter": (scatter, "launches"),
    "conv_raw": (conv_raw, "launches"),
    "conv3d_folded": (conv3d_cl, "folded_launches"),
    "conv3d": (conv3d_cl, "launches"),
    "gather_gemm": (gather_gemm, "launches"),
    "gather_gemm_dx": (gather_gemm, "dx_launches"),
    "conv_site_q": (conv_site, "q_launches"),
    "downconv_q": (downconv, "q_launches"),
    "upconv_q": (upconv, "q_launches"),
    "tile_amax": (tile_amax, "launches"),
}


# the hand-written kernels by their CUDA names (csrc/*.cu; a profiler row
# of one reads "sgnn::<name><...>"); K4's gate mode with and without the
# raw heads is one kernel, told apart by the wrappers' counters
KERNEL_NAMES = {"conv_site_kernel": "K1", "conv_site_q_kernel": "K1q",
                "downconv_kernel": "K2", "downconv_q_kernel": "K2q",
                "upconv_kernel": "K3", "upconv_q_kernel": "K3q",
                "head_gate_kernel": "K4 gate and raw",
                "head_sum_kernel": "K4 summed", "surf_head_kernel": "K5",
                "scatter_kernel": "K6", "conv_raw_kernel": "K7",
                "conv3d_brick_kernel": "K8", "conv3d_any_brick_kernel": "K9",
                "gather_gemm_kernel": "K10", "tile_amax_kernel": "tile_amax"}


# counter name -> the KERNEL_NAMES label of the kernel it counts (each
# launch it counts is one launch of that kernel)
COUNTER_LABELS = {
    "conv_site": "K1", "downconv": "K2", "upconv": "K3",
    "head_gate": "K4 gate and raw", "head_gate_raw": "K4 gate and raw",
    "head_sum": "K4 summed", "surf_head": "K5", "scatter": "K6",
    "conv_raw": "K7", "conv3d_folded": "K8", "conv3d": "K9",
    "gather_gemm": "K10", "gather_gemm_dx": "K10", "conv_site_q": "K1q",
    "downconv_q": "K2q", "upconv_q": "K3q", "tile_amax": "tile_amax"}


def launches_by_label(counts: dict) -> dict:
    """Launch counts per counter (launch_counts()) summed per kernel
    label; labels with no launch left out."""
    out = {}
    for k, n in counts.items():
        if n:
            out[COUNTER_LABELS[k]] = out.get(COUNTER_LABELS[k], 0) + n
    return out


def kernel_label(name: str) -> str | None:
    """The KERNEL_NAMES label of a profiler row's CUDA kernel name, or None
    for a kernel that is not hand-written here."""
    for k, label in KERNEL_NAMES.items():
        if f"::{k}<" in name:
            return label
    return None


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: getattr(m, a) for k, (m, a) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in _COUNTERS.values():
        setattr(m, a, 0)
    conv_site.mma_launches = 0  # in launch_counts() as conv_site's


# wrapper name -> its module, for plain_versions
_WRAPPERS = {"conv_site": conv_site, "downconv": downconv, "upconv": upconv,
             "head_gate": head, "head_sum": head, "surf_head": surf_head,
             "scatter": scatter, "conv_raw": conv_raw,
             "gather_gemm": gather_gemm, "gather_gemm_dx": gather_gemm}


@contextlib.contextmanager
def plain_versions():
    """While active, every kernel wrapper of the exact serving and
    training paths runs its plain PyTorch version, on the card too (as
    ``impl="plain"``): a whole step or forward with no hand-written
    kernel, the yardstick its kernels are held to. A yardstick computes in
    full f32, so cuDNN's and cuBLAS's TF32 are off meanwhile (cuDNN's is
    on by default in a fresh process)."""
    saved = [(m, fn, getattr(m, fn)) for fn, m in _WRAPPERS.items()]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    for m, fn, orig in saved:
        setattr(m, fn, functools.partial(_plain_call, orig))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _plain_call(orig, *args, impl=None, **kw):
    return orig(*args, impl="plain", **kw)
