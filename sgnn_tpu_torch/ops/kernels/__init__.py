"""Hand-written CUDA kernels of the serving path, one module per kernel.

Each module holds a wrapper (launches the kernel for CUDA tensors), its
plain PyTorch version (taken for CPU tensors, or with ``impl="plain"``)
and a launch counter that only the kernel launch advances.
"""

from __future__ import annotations

from sgnn_tpu_torch.ops.kernels import (conv_site, downconv, head, scatter,
                                        upconv)

# counter name -> (module, attribute holding its launch count)
_COUNTERS = {
    "conv_site": (conv_site, "launches"),
    "downconv": (downconv, "launches"),
    "upconv": (upconv, "launches"),
    "head_gate": (head, "gate_launches"),
    "head_sum": (head, "sum_launches"),
    "scatter": (scatter, "launches"),
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: getattr(m, a) for k, (m, a) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in _COUNTERS.values():
        setattr(m, a, 0)
