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


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: getattr(m, a) for k, (m, a) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in _COUNTERS.values():
        setattr(m, a, 0)


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
