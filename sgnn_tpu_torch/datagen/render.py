"""Depth rendering from room meshes (the s_bUseRenderedDepth datagen mode);
port of ``sgnn_tpu/datagen/render.py``.

The reference renders mesh depth with D3D11 (Scene::renderDepthFrame,
the reference's datagen/GenerateScans/src/Scene.cpp:107-158,
zParametersScanMP.txt:40); here a native C++ software z-buffer rasterizer
(cpp/rasterize.cpp, OpenMP, ctypes) produces the same camera-space depth
maps headlessly. The library is built with g++ at first use
(utils/native_build.py) and a failed build raises; the vectorized numpy
rasterizer runs only when a caller passes ``impl="numpy"``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from sgnn_tpu_torch.utils.native_build import build_library

SOURCE = Path(__file__).resolve().parent / "cpp" / "rasterize.cpp"
# the JAX package's flags (sgnn_tpu/datagen/cpp/Makefile), so both
# rasterizers give the same bits
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-shared", "-fopenmp", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


def get_raster_lib():
    """The rasterizer library, built on first use. Raises RuntimeError if
    g++ fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library(
                "rasterize", SOURCE, CXX_FLAGS, "native rasterizer")))
            lib.rasterize_depth.restype = None
            lib.rasterize_depth.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.rasterize_faceid.restype = None
            lib.rasterize_faceid.argtypes = (
                lib.rasterize_depth.argtypes
                + [ctypes.POINTER(ctypes.c_int32)]
            )
            _LIB = lib
        return _LIB


def _check_impl(impl: str) -> None:
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl must be 'native' or 'numpy', not {impl!r}")


def render_depth(
    verts: np.ndarray,  # [V, 3] world
    faces: np.ndarray,  # [T, 3] int
    cam2world: np.ndarray,  # [4, 4]
    intrinsic: np.ndarray,  # [4, 4]
    width: int,
    height: int,
    near: float = 0.1,
    far: float = 10.0,
    impl: str = "native",
) -> np.ndarray:
    """[H, W] camera-space depth; -inf = miss/out-of-range. ``impl``:
    "native" (cpp/rasterize.cpp) or "numpy"."""
    _check_impl(impl)
    world2cam = np.linalg.inv(np.asarray(cam2world, np.float64)).astype(
        np.float32
    )
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if impl == "native":
        lib = get_raster_lib()
        out = np.empty((height, width), np.float32)
        lib.rasterize_depth(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(faces),
            np.ascontiguousarray(world2cam, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            np.ascontiguousarray(intrinsic, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            width, height, near, far,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    return _render_depth_numpy(
        verts, faces, world2cam, intrinsic, width, height, near, far
    )


def render_faceid(
    verts: np.ndarray,
    faces: np.ndarray,
    cam2world: np.ndarray,
    intrinsic: np.ndarray,
    width: int,
    height: int,
    near: float = 0.1,
    far: float = 10.0,
    impl: str = "native",
) -> tuple[np.ndarray, np.ndarray]:
    """([H, W] depth, [H, W] int32 winning-face id; -inf/-1 = miss)."""
    _check_impl(impl)
    world2cam = np.linalg.inv(np.asarray(cam2world, np.float64)).astype(
        np.float32
    )
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if impl == "native":
        lib = get_raster_lib()
        depth = np.empty((height, width), np.float32)
        fid = np.empty((height, width), np.int32)
        lib.rasterize_faceid(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(faces),
            np.ascontiguousarray(world2cam, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            np.ascontiguousarray(intrinsic, np.float32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            ),
            width, height, near, far,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            fid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return depth, fid
    return _render_faceid_numpy(
        verts, faces, world2cam, intrinsic, width, height, near, far
    )


def render_color(
    verts: np.ndarray,
    faces: np.ndarray,
    vert_colors: np.ndarray,  # [V, 3] in [0, 1]
    cam2world: np.ndarray,
    intrinsic: np.ndarray,
    width: int,
    height: int,
    near: float = 0.1,
    far: float = 10.0,
    impl: str = "native",
) -> tuple[np.ndarray, np.ndarray]:
    """Flat color render: ([H, W] depth, [H, W, 3] color, 0 at misses).

    Matches the reference's annotation shader semantics — per-primitive
    flat color via ``nointerpolation`` with the D3D11 provoking vertex
    (first vertex of the triangle), drawAnnotations.hlsl:12,26-31."""
    depth, fid = render_faceid(
        verts, faces, cam2world, intrinsic, width, height, near, far, impl
    )
    vert_colors = np.asarray(vert_colors, np.float32)
    hit = fid >= 0
    color = np.zeros((height, width, 3), np.float32)
    color[hit] = vert_colors[faces[fid[hit], 0]]
    return depth, color


def render_phong(
    verts: np.ndarray,
    faces: np.ndarray,
    cam2world: np.ndarray,
    intrinsic: np.ndarray,
    width: int,
    height: int,
    lighting,
    material,
    vert_colors: np.ndarray | None = None,
    near: float = 0.1,
    far: float = 10.0,
    impl: str = "native",
) -> tuple[np.ndarray, np.ndarray]:
    """Phong-shaded render: ([H, W] depth, [H, W, 3] shaded color).

    The shading the reference's Lighting cbuffer + SimpleMaterial feed
    (the reference's datagen/GenerateScans/src/Lighting.h:38-40,
    SimpleMaterial.h:42-47): flat per-face normals, per-pixel view rays,
    optional provoking-vertex albedo."""
    from sgnn_tpu_torch.datagen.lighting import phong_shade

    depth, fid = render_faceid(
        verts, faces, cam2world, intrinsic, width, height, near, far, impl
    )
    hit = fid >= 0
    color = np.zeros((height, width, 3), np.float32)
    if not hit.any():
        return depth, color
    verts = np.asarray(verts, np.float32)
    f = faces[fid[hit]]
    # flat (per-face) world-space normals, oriented toward the camera
    e1 = verts[f[:, 1]] - verts[f[:, 0]]
    e2 = verts[f[:, 2]] - verts[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    cam2world = np.asarray(cam2world, np.float32)
    eye = cam2world[:3, 3]
    # view dir = surface point -> eye; surface point from the pixel ray
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    ys, xs = np.nonzero(hit)
    z = depth[hit]
    pc = np.stack(
        [(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=-1
    ).astype(np.float32)
    pw = pc @ cam2world[:3, :3].T + eye
    v = eye - pw
    v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    n *= np.where((n * v).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    base = None
    if vert_colors is not None:
        base = np.asarray(vert_colors, np.float32)[f[:, 0]]
    color[hit] = phong_shade(n, v, lighting, material, base_color=base)
    return depth, color


def _render_faceid_numpy(verts, faces, world2cam, intrinsic, W, H, near,
                         far):
    """The numpy render_faceid (same math as rasterize_faceid)."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    vc = verts @ world2cam[:3, :3].T + world2cam[:3, 3]
    z = vc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        px = vc[:, 0] * fx / z + cx
        py = vc[:, 1] * fy / z + cy
    zbuf = np.full((H, W), np.inf, np.float32)
    fbuf = np.full((H, W), -1, np.int32)
    for ti, t in enumerate(faces):
        tz = z[t]
        if (tz < 1e-4).any():
            continue
        tx, ty = px[t], py[t]
        x0 = max(0, int(np.floor(tx.min())))
        x1 = min(W - 1, int(np.ceil(tx.max())))
        y0 = max(0, int(np.floor(ty.min())))
        y1 = min(H - 1, int(np.ceil(ty.max())))
        if x0 > x1 or y0 > y1:
            continue
        ax, ay = tx[1] - tx[0], ty[1] - ty[0]
        bx, by = tx[2] - tx[0], ty[2] - ty[0]
        det = ax * by - ay * bx
        if abs(det) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        dx, dy = xs - tx[0], ys - ty[0]
        l1 = (dx * by - dy * bx) / det
        l2 = (-ay * dx + ax * dy) / det
        l0 = 1.0 - l1 - l2
        eps = -1e-5
        inside = (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        iz = l0 / tz[0] + l1 / tz[1] + l2 / tz[2]
        with np.errstate(divide="ignore"):
            depth = 1.0 / iz
        zsub = zbuf[y0:y1 + 1, x0:x1 + 1]
        fsub = fbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (depth < zsub)
        zsub[upd] = depth[upd]
        fsub[upd] = ti
    hit = (zbuf >= near) & (zbuf <= far)
    return (
        np.where(hit, zbuf, -np.inf).astype(np.float32),
        np.where(hit, fbuf, -1).astype(np.int32),
    )


def _render_depth_numpy(verts, faces, world2cam, intrinsic, W, H, near, far):
    """The per-triangle numpy render_depth (same math as
    cpp/rasterize.cpp)."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    vc = verts @ world2cam[:3, :3].T + world2cam[:3, 3]
    z = vc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        px = vc[:, 0] * fx / z + cx
        py = vc[:, 1] * fy / z + cy
    zbuf = np.full((H, W), np.inf, np.float32)
    for t in faces:
        tz = z[t]
        if (tz < 1e-4).any():
            continue
        tx, ty = px[t], py[t]
        x0 = max(0, int(np.floor(tx.min())))
        x1 = min(W - 1, int(np.ceil(tx.max())))
        y0 = max(0, int(np.floor(ty.min())))
        y1 = min(H - 1, int(np.ceil(ty.max())))
        if x0 > x1 or y0 > y1:
            continue
        ax, ay = tx[1] - tx[0], ty[1] - ty[0]
        bx, by = tx[2] - tx[0], ty[2] - ty[0]
        det = ax * by - ay * bx
        if abs(det) < 1e-12:
            continue
        xs, ys = np.meshgrid(
            np.arange(x0, x1 + 1), np.arange(y0, y1 + 1)
        )
        dx, dy = xs - tx[0], ys - ty[0]
        l1 = (dx * by - dy * bx) / det
        l2 = (-ay * dx + ax * dy) / det
        l0 = 1.0 - l1 - l2
        eps = -1e-5
        inside = (l0 >= eps) & (l1 >= eps) & (l2 >= eps)
        iz = l0 / tz[0] + l1 / tz[1] + l2 / tz[2]
        with np.errstate(divide="ignore"):
            depth = 1.0 / iz
        sub = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (depth < sub)
        sub[upd] = depth[upd]
    return np.where(
        (zbuf >= near) & (zbuf <= far), zbuf, -np.inf
    ).astype(np.float32)
