"""Build, load and launch the CUDA kernels of ``sgnn_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process for ``sm_90a``
(all started together, so a cold build takes the time of the slowest
source rather than the sum, which keeps ``chip_smoke.py`` inside its time
limit as sources are added), and one more call links the objects into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs the first time a CUDA tensor reaches a kernel (importing this module
builds nothing), into ``build/kernels-<hash>/`` at the repository root,
keyed on a hash of the sources and flags so an edited source rebuilds.

Every kernel wrapper follows one dispatch rule (``use_kernel``): a CPU
tensor takes the kernel's plain PyTorch version, a CUDA tensor launches
the kernel or raises, and the plain version runs on the card only when a
caller passes ``impl="plain"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libsgnn_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points of csrc/*.cu: name -> argument types (all return int)
SIGNATURES = {
    "sgnn_conv_site": [_PP, _IP, _I, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _P],
    "sgnn_downconv": [_P, _P, _P, _P, _I, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_upconv": [_PP, _IP, _I, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_head_gate": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_head_sum": [_PP, _IP, _I, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
    "sgnn_surf_head": [_PP, _IP, _IP, _IP, _I, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_conv_raw": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_scatter": [_P, _P, _I, _F, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _P],
    "sgnn_conv3d_folded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    "sgnn_conv3d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_gather_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "sgnn_tile_amax": [_PP, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _IP, _I, _P],
    "sgnn_conv_site_q": [_PP, _IP, _I, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sgnn_downconv_q": [_P, _P, _P, _P, _P, _P, _I, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    "sgnn_upconv_q": [_PP, _IP, _I, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
ptxas_log = ""  # the compiler's -Xptxas -v report of the last build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into the keyed build directory (once per hash)
    and return the library path. The compiler's report (registers and
    spills per kernel) is kept in ``ptxas_log`` and ``build.log``."""
    global ptxas_log
    out_dir = BUILD_ROOT / f"kernels-{_digest()}"
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib_path.exists():
        ptxas_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        jobs = []
        for src in sources():
            obj = Path(tmp_dir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})")
        tmp = Path(tmp_dir) / LIB_NAME
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *[str(obj) for _, obj, _ in jobs]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({res.returncode})")
        ptxas_log = "".join(logs)
        log_path.write_text(ptxas_log)
        if failed:
            raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n"
                               + ptxas_log)
        os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.sgnn_error_string.argtypes = [ctypes.c_int]
        handle.sgnn_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def use_kernel(t: torch.Tensor, impl: str | None) -> bool:
    """The dispatch rule: True to launch the CUDA kernel, False for the
    plain version. Raises for a device that has neither route."""
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', not {impl!r}")
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no route for a tensor on {t.device}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().sgnn_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def ptr_array(ts: list[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def int_array(vals: list[int]):
    return (ctypes.c_int * len(vals))(*vals)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def check_grid(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A folded grid the kernel reads: same device, dtype, rank-5 lane
    layout and contiguity as ``like``."""
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on "
            f"{like.device}"
        )
    if t.dim() != 5 or t.shape[-1] != 128 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous [B, Z+2, Y+2, xq, 128] "
                         f"grid, got {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {t.dtype} not float32/bfloat16")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, like: torch.Tensor) -> None:
    """A prepared array: of dtype and shape, contiguous, on like's
    device."""
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(
            f"{name}: need contiguous {dtype} {tuple(shape)} on "
            f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def check_f32(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor
              ) -> None:
    """A prepared weight/affine array: f32, contiguous, on like's device."""
    check_tensor(name, t, torch.float32, shape, like)
