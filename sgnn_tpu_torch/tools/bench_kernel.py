"""Microbenchmark: K8, the channels-last 3^3 conv
(``ops/kernels/conv3d_cl.py`` ``conv3d_3x3x3_folded``), against one
``F.conv3d`` under the dense trunk's cuDNN flags (f32 sums, no TF32,
deterministic), the port's stand-in for the JAX package's XLA conv (port
of its ``tools/bench_kernel.py``).

Prints the largest |K8 - F.conv3d| against the output's scale, then each
one's ms per call by CUDA events (after a warm-up, ``--reps`` calls) and
their ratio.

    python -m sgnn_tpu_torch.tools.bench_kernel [Z Y X C [bf16|f32]]
        [--reps 10] [--cpu]

The default shape is 96 192 192 16 bf16 (the dense flow's full-resolution
sites). Runs on the card; ``--cpu`` compares K8's plain version on the
host (no time is measured there).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from sgnn_tpu_torch.tools import _common as C
from sgnn_tpu_torch.utils import profiling as P


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", default=["96", "192", "192", "16"],
                    help="Z Y X C [bf16|f32]")
    ap.add_argument("--reps", type=int, default=10)
    C.device_arg(ap)
    args = ap.parse_args(argv)
    if len(args.shape) not in (4, 5) or (
            len(args.shape) == 5 and args.shape[4] not in ("bf16", "f32")):
        ap.error("shape: Z Y X C [bf16|f32]")
    return args


def main(argv=None) -> dict:
    from sgnn_tpu_torch.ops import dense
    from sgnn_tpu_torch.ops.kernels import conv3d_cl as K_cl

    args = parse_args(argv)
    device = C.device_of(args, "bench_kernel")
    Z, Y, X, Ch = (int(v) for v in args.shape[:4])
    name = args.shape[4] if len(args.shape) == 5 else "bf16"
    dt = torch.bfloat16 if name == "bf16" else torch.float32
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, Z, Y, X, Ch).astype(np.float32)).to(
        device, dt)
    w = torch.from_numpy((rng.randn(27, Ch, Ch) * 0.1).astype(
        np.float32)).to(device, dt)
    # F.conv3d on the channels-last grid: [B, C, Z, Y, X] strides, taps
    # [Cout, Cin, 3, 3, 3]
    xl = x.permute(0, 4, 1, 2, 3)
    wl = w.reshape(3, 3, 3, Ch, Ch).permute(4, 3, 0, 1, 2)

    def library():
        with torch.backends.cudnn.flags(**dense._CUDNN):
            return F.conv3d(xl, wl, padding=1).permute(0, 2, 3, 4, 1)

    def kernel():
        return K_cl.conv3d_3x3x3_folded(x, w)

    print(f"shape (1, {Z}, {Y}, {X}, {Ch}) {name}")
    y1, y2 = library().float(), kernel().float()
    err = float((y1 - y2).abs().max())
    scale = float(y1.abs().max())
    print(f"on-device max abs err: {err:.3e} (scale {scale:.2f})")
    t_lib = P.cuda_ms(library, device, args.reps)
    t_k8 = P.cuda_ms(kernel, device, args.reps)
    res = {"device": P.device_entry(device), "shape": [1, Z, Y, X, Ch],
           "dtype": name, "max_abs_err": err, "scale": scale,
           "library_ms": t_lib, "kernel_ms": t_k8,
           "speedup": (t_lib / t_k8 if isinstance(t_k8, float)
                       else P.NOT_MEASURED)}
    for label, t in (("F.conv3d", t_lib), ("K8", t_k8)):
        print(f"{label}: " + (f"{t:.4f} ms/conv" if isinstance(t, float)
                              else t))
    print(f"speedup: " + (f"{res['speedup']:.2f}x"
                          if isinstance(res["speedup"], float)
                          else res["speedup"]))
    if res["device"]["platform"] == "gpu":
        print(res["device"]["card"])
    return res


if __name__ == "__main__":
    main()
