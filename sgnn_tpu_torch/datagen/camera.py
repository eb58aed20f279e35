"""Depth-image processing: bilateral filter, projection helpers (port
of ``sgnn_tpu/datagen/camera.py``).

Vectorized equivalents of the reference's datagen/GenerateScans/src/
CameraUtil.h (the reference's OpenMP per-pixel loops).
"""

from __future__ import annotations

import numpy as np


def bilateral_filter(depth: np.ndarray, sigma_d: float = 2.0,
                     sigma_r: float = 0.1) -> np.ndarray:
    """Edge-preserving depth smoothing (CameraUtil.h:25-64).

    Invalid pixels are -inf and stay -inf; valid pixels average valid
    neighbors within radius ceil(2*sigma_d) weighted by spatial gaussian x
    range gaussian. The fuse path calls this with (2.0, 0.1)
    (Fuser.cpp:83,138).
    """
    r = int(np.ceil(2.0 * sigma_d))
    valid = np.isfinite(depth)
    # f32 throughout: depth is metric (<= ~10), the 81-tap weighted sum
    # stays well inside f32 precision, and the filter is a third of the
    # per-scene datagen cost
    d = np.where(valid, depth, 0.0).astype(np.float32)
    H, W = depth.shape
    acc = np.zeros((H, W), np.float32)
    wacc = np.zeros((H, W), np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma_d * sigma_d))
            ys = slice(max(0, dy), min(H, H + dy))
            yd = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, dx), min(W, W + dx))
            xd = slice(max(0, -dx), min(W, W - dx))
            nd = d[ys, xs]
            nv = valid[ys, xs]
            diff = nd - d[yd, xd]
            w = g * np.exp(-(diff * diff) / (2.0 * sigma_r * sigma_r)) * nv
            acc[yd, xd] += w * nd
            wacc[yd, xd] += w
    out = np.where(valid & (wacc > 0), acc / np.maximum(wacc, 1e-30), -np.inf)
    return out.astype(np.float32)


def compute_edge_mask(depth: np.ndarray, depth_thresh: float,
                      frac_thresh: float, radius: int) -> np.ndarray:
    """Mark pixels near depth discontinuities (CameraUtil.h:67-103):
    a pixel is an edge when the fraction of neighbors within radius whose
    depth differs by more than depth_thresh (or is invalid) exceeds
    frac_thresh."""
    H, W = depth.shape
    valid = np.isfinite(depth)
    diff_cnt = np.zeros((H, W), np.int32)
    total = np.zeros((H, W), np.int32)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            ys = slice(max(0, dy), min(H, H + dy))
            yd = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, dx), min(W, W + dx))
            xd = slice(max(0, -dx), min(W, W - dx))
            nd = depth[ys, xs]
            nv = valid[ys, xs]
            bad = ~nv | (np.abs(nd - depth[yd, xd]) > depth_thresh)
            diff_cnt[yd, xd] += bad
            total[yd, xd] += 1
    frac = diff_cnt / np.maximum(total, 1)
    return valid & (frac > frac_thresh)


def depth_to_camera(intrinsic, ux, uy, depth):
    """Unproject pixel -> camera space (VoxelGrid.h depthToSkeleton)."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    x = (ux - cx) / fx * depth
    y = (uy - cy) / fy * depth
    return np.stack([x, y, np.broadcast_to(depth, np.shape(x))], -1)


def camera_to_depth(intrinsic, p):
    """Project camera-space points -> (u, v, z) (VoxelGrid.h
    skeletonToDepth). p: [..., 3]."""
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    z = p[..., 2]
    u = p[..., 0] * fx / z + cx
    v = p[..., 1] * fy / z + cy
    return np.stack([u, v, z], -1)
