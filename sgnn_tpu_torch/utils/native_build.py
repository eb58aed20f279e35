"""g++ builds of the port's host libraries (marching cubes, depth
rasterizer, TSDF fusion).

A library is built at first use into ``build/<name>-<hash>/`` at the
repository root (git-ignored), keyed on a hash of its source, the flags
and what ``-march=native`` resolves to on this host, so an edited source
or another CPU rebuilds. Nothing is written next to the sources. A failed
build raises: no caller falls back to a numpy path unless it asks for
that path by argument.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"


def gxx(cmd: list, what: str) -> subprocess.CompletedProcess:
    """Runs a g++ command; raises RuntimeError if it cannot run or fails."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{what}: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{what}: g++ failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return res


def build_library(name: str, source: Path, flags: tuple, what: str,
                  build_root: Path = BUILD_ROOT) -> Path:
    """Compile ``source`` into ``build_root/<name>-<hash>/lib<name>.so``
    (once per hash) and return the library's path."""
    # the target options -march=native enables here, so a library built
    # on another CPU is never loaded on this one
    host = gxx(["g++", "-march=native", "-Q", "--help=target"], what).stdout
    h = hashlib.sha256(" ".join(flags).encode() + host.encode()
                       + Path(source).read_bytes())
    out_dir = Path(build_root) / f"{name}-{h.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        gxx(["g++", *flags, "-o", tmp, str(source)], what)
    except RuntimeError:
        os.unlink(tmp)
        raise
    os.replace(tmp, lib_path)
    return lib_path
