"""TSDF fusion: depth frames -> .sdf/.knw volumes (port of
``sgnn_tpu/datagen/fusion.py``).

Re-implements the reference datagen voxel pipeline (the reference's
datagen/GenerateScans/src/VoxelGrid.{h,cpp}, Fuser.cpp). Two integrators
of the frustum-bounded sub-grid update (the reference's CPU strategy)
with identical semantics, bit for bit: the native core (cpp/fuse.cpp,
OpenMP, built with g++ at first use, utils/native_build.py; a failed
build raises) and the vectorized numpy slab update, which runs only when
a caller passes ``impl="numpy"``.

Reference math (VoxelGrid.cpp:7-64, VoxelGrid.h:32-33,333-335):
  sdf = d - p.z (camera z), truncation = 3*vs + d*vs,
  update iff sdf > -truncation, clamped to ±truncation;
  weightUpdate = max(4.5 * (1 - (d-0.4)/(4.0-0.4)), 1);
  running weighted average; weight = min(weight + int(weightUpdate), 255);
  freeCtr++ wherever p.z < d (observed empty);
  valid depth range [0.4, 4.0] (Fuser.cpp:73 ctor args).

Known-state encoding (VoxelGrid.h:199-218):
  sdf < -vs  -> max(2, min(255, int(-sdf/vs)+1))   (unknown, dist-coded;
                -inf saturates to 255)
  |sdf|<= vs -> 1 (known occupied)
  else       -> 0 (known empty)

Grids are stored [X, Y, Z]-indexed as (x, y, z) like the reference Grid3 to
keep the worldToGrid math verbatim; the .sdf writer emits xyz locs so the
training loader's zyx flip (data_util.py:75) behaves identically.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path

import numpy as np

from sgnn_tpu_torch.utils.native_build import build_library

DEPTH_MIN = 0.4
DEPTH_MAX = 4.0
INTEGRATION_WEIGHT_SAMPLE = 3.0

# ------------------------------------------------ native integrate core
# cpp/fuse.cpp: the per-frame projection + TSDF update loop in C++
# (OpenMP), the counterpart of the reference's VoxelGrid::integrate hot
# loop (VoxelGrid.cpp:12-63). Numerics match _frame_updates bit-for-bit.
SOURCE = Path(__file__).resolve().parent / "cpp" / "fuse.cpp"
# the JAX package's flags (sgnn_tpu/datagen/cpp/Makefile)
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-shared", "-fopenmp", "-std=c++17")
_FUSE_LOCK = threading.Lock()
_FUSE_LIB = None


def get_fuse_lib():
    """The TSDF integrate library, built on first use. Raises RuntimeError
    if g++ fails."""
    global _FUSE_LIB
    with _FUSE_LOCK:
        if _FUSE_LIB is None:
            lib = ctypes.CDLL(str(build_library(
                "fuse", SOURCE, CXX_FLAGS, "native TSDF fusion")))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.tsdf_integrate.restype = None
            lib.tsdf_integrate.argtypes = [
                f32p, f32p, i32p,                      # sdf, weight, free
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                f32p, f32p,                            # grid2world, world2cam
                ctypes.c_float, ctypes.c_float,        # fx, fy
                ctypes.c_float, ctypes.c_float,        # cx, cy
                f32p, ctypes.c_int32, ctypes.c_int32,  # depth, W, H
                ctypes.c_float,                        # voxel_size
                ctypes.c_float, ctypes.c_float,        # depth_min/max
                ctypes.c_float, ctypes.c_float,        # d01 ramp min/max
                ctypes.c_float,                        # weight_sample
                i32p, i32p,                            # lo, hi
                f32p,                                  # obb or NULL
            ]
            _FUSE_LIB = lib
        return _FUSE_LIB


@dataclasses.dataclass
class OBB:
    """Oriented bounding box: center + orthonormal axes + half extents."""
    center: np.ndarray  # [3]
    axes: np.ndarray  # [3, 3] rows = unit axes
    half: np.ndarray  # [3]

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """pts [..., 3] -> bool[...]."""
        rel = pts - self.center
        proj = np.einsum("...k,ak->...a", rel, self.axes)
        return (np.abs(proj) <= self.half + 1e-6).all(-1)

    def expanded(self, pad: np.ndarray) -> "OBB":
        return OBB(self.center, self.axes, self.half + np.asarray(pad))

    def transformed(self, m: np.ndarray) -> "OBB":
        """Apply an affine [4,4] (rotation+scale+translation) transform."""
        c = (m[:3, :3] @ self.center + m[:3, 3])
        axes_scaled = (m[:3, :3] @ (self.axes * self.half[:, None]).T).T
        lens = np.linalg.norm(axes_scaled, axis=1)
        return OBB(c, axes_scaled / lens[:, None], lens)

    @staticmethod
    def from_points_zup(pts: np.ndarray) -> "OBB":
        """mLib OBB3f(points, eZ): PCA in the xy plane, z axis fixed up
        (the reference's datagen/GenerateScans/src/Scene.cpp:30)."""
        xy = pts[:, :2]
        mean = xy.mean(0)
        cov = np.cov((xy - mean).T)
        _, vecs = np.linalg.eigh(cov)
        a0 = np.array([vecs[0, 1], vecs[1, 1], 0.0])
        a1 = np.array([-a0[1], a0[0], 0.0])
        axes = np.stack([a0, a1, np.array([0.0, 0.0, 1.0])])
        proj = (pts - pts.mean(0)) @ axes.T
        lo, hi = proj.min(0), proj.max(0)
        center = pts.mean(0) + axes.T @ ((lo + hi) / 2)
        return OBB(center, axes, (hi - lo) / 2)


class VoxelGrid:
    """Dense TSDF grid with (x, y, z) indexing, world<->grid via a 4x4."""

    def __init__(self, dims_xyz, world2grid, voxel_size,
                 scene_obb_grid: OBB | None = None,
                 depth_min=DEPTH_MIN, depth_max=DEPTH_MAX):
        self.dims = tuple(int(d) for d in dims_xyz)
        self.world2grid = np.asarray(world2grid, np.float32)
        self.grid2world = np.linalg.inv(self.world2grid).astype(np.float32)
        self.voxel_size = float(voxel_size)
        self.obb = scene_obb_grid
        self.depth_min = depth_min
        self.depth_max = depth_max
        X, Y, Z = self.dims
        self.sdf = np.full((X, Y, Z), -np.inf, np.float32)
        self.weight = np.zeros((X, Y, Z), np.float32)
        self.free_ctr = np.zeros((X, Y, Z), np.int32)
        # per-voxel RGB, allocated on the first color integrate (the
        # reference Voxel declares `vec3uc color`, VoxelGrid.h:16, but
        # its fuse path never fills it; we integrate when frames carry
        # color)
        self.color: np.ndarray | None = None

    def truncation(self, d):
        return 3.0 * self.voxel_size + d * self.voxel_size

    # ------------------------------------------------------------ integrate
    def integrate(self, intrinsic, cam2world, depth, color=None,
                  impl: str = "native"):
        """One frame, frustum-bounded: ``impl`` "native" (cpp/fuse.cpp) or
        "numpy". ``color`` is an optional [H, W, 3] uint8/float RGB frame
        registered to the depth frame; voxels updated by the TSDF pass take
        a weight-matched running average of the sampled pixel color
        (filling the `vec3uc color` field the reference Voxel declares,
        VoxelGrid.h:16). The native core has no color: a color frame
        needs ``impl="numpy"``."""
        if impl not in ("native", "numpy"):
            raise ValueError(f"impl must be 'native' or 'numpy', not "
                             f"{impl!r}")
        if color is not None and impl != "numpy":
            raise ValueError("color integration runs in the numpy update "
                             "only: pass impl='numpy'")
        lo, hi = self._frustum_bounds(intrinsic, cam2world, depth.shape)
        if (hi < lo).any():
            return
        if impl == "native":
            self._integrate_native(get_fuse_lib(), intrinsic, cam2world,
                                   depth, lo, hi)
            return
        xs = np.arange(lo[0], hi[0] + 1)
        ys = np.arange(lo[1], hi[1] + 1)
        zs = np.arange(lo[2], hi[2] + 1)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        pts_grid = np.stack([gx, gy, gz], -1).astype(np.float32)
        sl = (slice(lo[0], hi[0] + 1), slice(lo[1], hi[1] + 1),
              slice(lo[2], hi[2] + 1))
        old_w = self.weight[sl].copy() if color is not None else None
        new_sdf, new_w, free_inc, upd = self._frame_updates(
            pts_grid,
            self.sdf[sl],
            self.weight[sl],
            intrinsic, cam2world, depth,
        )
        self.sdf[sl] = new_sdf
        self.weight[sl] = new_w
        self.free_ctr[sl] += free_inc
        if color is not None:
            self._integrate_color(
                pts_grid, sl, upd, old_w, new_w, intrinsic, cam2world,
                depth.shape, color,
            )

    def _integrate_native(self, lib, intrinsic, cam2world, depth, lo, hi):
        """cpp/fuse.cpp:tsdf_integrate — in-place update of the slab."""
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)

        def fp(a):
            return a.ctypes.data_as(f32p)

        def ip(a):
            return a.ctypes.data_as(i32p)

        world2cam = np.linalg.inv(np.asarray(cam2world, np.float64)).astype(
            np.float32
        )
        g2w = np.ascontiguousarray(self.grid2world, np.float32)
        w2c = np.ascontiguousarray(world2cam, np.float32)
        d = np.ascontiguousarray(depth, np.float32)
        lo32 = np.asarray(lo, np.int32)
        hi32 = np.asarray(hi, np.int32)
        obb_arr = None
        if self.obb is not None:
            obb_arr = np.ascontiguousarray(
                np.concatenate([
                    np.asarray(self.obb.center, np.float32).ravel(),
                    np.asarray(self.obb.axes, np.float32).ravel(),
                    np.asarray(self.obb.half, np.float32).ravel(),
                ]), np.float32,
            )
        H, W = depth.shape
        lib.tsdf_integrate(
            fp(self.sdf), fp(self.weight), ip(self.free_ctr),
            *(ctypes.c_int32(v) for v in self.dims),
            fp(g2w), fp(w2c),
            ctypes.c_float(float(intrinsic[0, 0])),
            ctypes.c_float(float(intrinsic[1, 1])),
            ctypes.c_float(float(intrinsic[0, 2])),
            ctypes.c_float(float(intrinsic[1, 2])),
            fp(d), ctypes.c_int32(W), ctypes.c_int32(H),
            ctypes.c_float(self.voxel_size),
            ctypes.c_float(self.depth_min), ctypes.c_float(self.depth_max),
            ctypes.c_float(DEPTH_MIN), ctypes.c_float(DEPTH_MAX),
            ctypes.c_float(INTEGRATION_WEIGHT_SAMPLE),
            ip(lo32), ip(hi32),
            fp(obb_arr) if obb_arr is not None else None,
        )

    def _integrate_color(self, pts_grid, sl, upd, old_w, new_w, intrinsic,
                         cam2world, hw, color):
        """Weight-matched running average of sampled RGB at TSDF-updated
        voxels: c <- (c*w_old + pixel*(w_new-w_old)) / w_new."""
        if self.color is None:
            self.color = np.zeros((*self.dims, 3), np.float32)
        H, W = hw
        world2cam = np.linalg.inv(np.asarray(cam2world, np.float64)).astype(
            np.float32
        )
        pw = (
            np.einsum("ab,...b->...a", self.grid2world[:3, :3], pts_grid)
            + self.grid2world[:3, 3]
        )
        pc = (
            np.einsum("ab,...b->...a", world2cam[:3, :3], pw)
            + world2cam[:3, 3]
        )
        fx, fy = intrinsic[0, 0], intrinsic[1, 1]
        cx, cy = intrinsic[0, 2], intrinsic[1, 2]
        z = np.where(pc[..., 2] == 0, 1e-12, pc[..., 2])
        u = np.clip(np.round(pc[..., 0] * fx / z + cx).astype(np.int32),
                    0, W - 1)
        v = np.clip(np.round(pc[..., 1] * fy / z + cy).astype(np.int32),
                    0, H - 1)
        col = np.asarray(color, np.float32)
        if col.max() > 1.5:  # uint8-range input
            col = col / 255.0
        pix = col[v, u]
        w_inc = np.maximum(new_w - old_w, 0.0)[..., None]
        denom = np.maximum(new_w[..., None], 1e-12)
        cur = self.color[sl]
        merged = (cur * old_w[..., None] + pix * w_inc) / denom
        self.color[sl] = np.where(upd[..., None], merged, cur)

    def _frame_updates(self, pts_grid, sdf, weight, intrinsic, cam2world,
                       depth):
        """The numpy slab update (cpp/fuse.cpp's math)."""
        H, W = depth.shape
        world2cam = np.linalg.inv(np.asarray(cam2world, np.float64)).astype(
            np.float32
        )
        pw = (
            np.einsum("ab,...b->...a", self.grid2world[:3, :3], pts_grid)
            + self.grid2world[:3, 3]
        )
        pc = (
            np.einsum("ab,...b->...a", world2cam[:3, :3], pw)
            + world2cam[:3, 3]
        )
        fx, fy = intrinsic[0, 0], intrinsic[1, 1]
        cx, cy = intrinsic[0, 2], intrinsic[1, 2]
        z = pc[..., 2]
        safe_z = np.where(z == 0, 1e-12, z)
        u = np.round(pc[..., 0] * fx / safe_z + cx).astype(np.int32)
        v = np.round(pc[..., 1] * fy / safe_z + cy).astype(np.int32)
        inb = (u >= 0) & (v >= 0) & (u < W) & (v < H)
        uc = np.clip(u, 0, W - 1)
        vc = np.clip(v, 0, H - 1)
        d = np.asarray(depth)[vc, uc]
        valid = (
            inb & np.isfinite(d) & (d >= self.depth_min) & (d <= self.depth_max)
        )
        if self.obb is not None:
            valid = valid & self.obb.contains(pts_grid)

        free_inc = (valid & (z < d)).astype(np.int32)
        # keep the arithmetic finite in lanes masked out by `valid`
        # (invalid depth pixels are -inf and would produce inf/nan noise)
        d = np.where(np.isfinite(d), d, self.depth_min)
        sdf_new = d - z
        trunc = self.truncation(d)
        do_upd = valid & (sdf_new > -trunc)
        sdf_new = np.clip(sdf_new, -trunc, trunc)
        depth01 = (d - DEPTH_MIN) / (DEPTH_MAX - DEPTH_MIN)
        w_upd = np.maximum(
            INTEGRATION_WEIGHT_SAMPLE * 1.5 * (1.0 - depth01), 1.0
        )
        first = ~np.isfinite(sdf)
        sdf_safe = np.where(first, 0.0, sdf)  # avoid -inf*0 in the avg
        merged = np.where(
            first,
            sdf_new,
            (sdf_safe * weight + sdf_new * w_upd) / (weight + w_upd),
        )
        out_sdf = np.where(do_upd, merged, sdf)
        out_w = np.where(
            do_upd,
            np.minimum(weight + np.floor(w_upd), 255.0),
            weight,
        )
        return out_sdf.astype(np.float32), out_w.astype(np.float32), \
            free_inc, do_upd

    def _frustum_bounds(self, intrinsic, cam2world, hw):
        """VoxelGrid.h:350-377: grid-space AABB of the depth frustum."""
        H, W = hw
        fx, fy = intrinsic[0, 0], intrinsic[1, 1]
        cx, cy = intrinsic[0, 2], intrinsic[1, 2]
        corners = []
        for d in (self.depth_min, self.depth_max):
            for ux, uy in ((0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)):
                x = (ux - cx) / fx * d
                y = (uy - cy) / fy * d
                corners.append([x, y, d])
        corners = np.asarray(corners, np.float32)
        cw = (np.asarray(cam2world)[:3, :3] @ corners.T).T + np.asarray(
            cam2world
        )[:3, 3]
        lo_hi = []
        for f in (np.floor, np.ceil):
            g = (self.world2grid[:3, :3] @ f(cw).T).T + self.world2grid[:3, 3]
            lo_hi.append(np.round(g))
        allg = np.concatenate(lo_hi, 0)
        lo = np.maximum(allg.min(0).astype(np.int64), 0)
        hi = np.minimum(
            allg.max(0).astype(np.int64), np.asarray(self.dims) - 1
        )
        return lo, hi

    # ---------------------------------------------------------- inspection
    def surface_voxels(self, weight_thresh=1, sdf_thresh=None):
        """(locs_xyz, sdf) of confident near-surface voxels
        (VoxelGrid.h getSurfaceVoxels)."""
        if sdf_thresh is None:
            sdf_thresh = self.truncation(0.0)
        m = (self.weight >= weight_thresh) & (np.abs(self.sdf) < sdf_thresh)
        x, y, z = np.nonzero(m)
        return np.stack([x, y, z], -1), self.sdf[m]

    def to_binary_grid_occupied(self, weight_thresh=1, sdf_thresh=None):
        """(x,y,z) bool grid of occupied voxels (VoxelGrid.h
        toBinaryGridOccupied)."""
        if sdf_thresh is None:
            sdf_thresh = self.voxel_size
        return (self.weight >= weight_thresh) & (
            np.abs(self.sdf) < sdf_thresh
        )

    def to_binary_grid_free(self, free_thresh=1):
        """(x,y,z) bool grid of observed-free voxels (VoxelGrid.h
        toBinaryGridFree)."""
        return self.free_ctr >= free_thresh

    def normalize_sdfs(self, factor=None):
        """Scale SDFs into voxel units in place (VoxelGrid.h
        normalizeSDFs); -inf voxels stay untouched."""
        if factor is None:
            factor = 1.0 / self.voxel_size
        m = np.isfinite(self.sdf)
        self.sdf[m] *= factor
        self.voxel_size *= factor

    def trilinear_sample(self, pos_world):
        """Trilinearly interpolated (sdf, valid) at world positions
        [..., 3]; invalid if any of the 8 surrounding voxels is unobserved
        (VoxelGrid.h trilinearInterpolationSimpleFastFast)."""
        pos = np.atleast_2d(np.asarray(pos_world, np.float64))
        g = (self.world2grid[:3, :3] @ pos.T).T + self.world2grid[:3, 3]
        g0 = np.floor(g - 0.5).astype(np.int64)
        w = (g - 0.5) - g0
        out = np.zeros(len(pos), np.float32)
        ok = np.ones(len(pos), bool)
        X, Y, Z = self.dims
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    c = g0 + np.array([dx, dy, dz])
                    inb = (
                        (c >= 0).all(-1)
                        & (c[:, 0] < X) & (c[:, 1] < Y) & (c[:, 2] < Z)
                    )
                    cc = np.clip(c, 0, np.array([X - 1, Y - 1, Z - 1]))
                    v = self.sdf[cc[:, 0], cc[:, 1], cc[:, 2]]
                    wt = self.weight[cc[:, 0], cc[:, 1], cc[:, 2]]
                    ok &= inb & (wt > 0) & np.isfinite(v)
                    coef = (
                        (w[:, 0] if dx else 1 - w[:, 0])
                        * (w[:, 1] if dy else 1 - w[:, 1])
                        * (w[:, 2] if dz else 1 - w[:, 2])
                    )
                    out += np.where(ok, coef * np.where(np.isfinite(v), v, 0),
                                    0).astype(np.float32)
        return out, ok

    # ------------------------------------------------------------- exports
    def known_grid(self) -> np.ndarray:
        """uint8 known-state grid (VoxelGrid.h:199-218), (x,y,z)-indexed."""
        vs = self.voxel_size
        sdf = self.sdf
        with np.errstate(invalid="ignore", over="ignore"):
            dist_code = np.where(
                np.isfinite(sdf),
                np.clip((-sdf / vs).astype(np.int64) + 1, 2, 255),
                255,
            )
        known = np.where(
            sdf < -vs, dist_code, np.where(sdf <= vs, 1, 0)
        ).astype(np.uint8)
        return known

    def sparse_voxels(self, truncation_factor=6.0):
        """(locs_xyz uint32 [N,3], sdf_world float32 [N]) of voxels within
        truncation_factor*vs (VoxelGrid.h saveToFile sparse path;
        Fuser.cpp:34 uses factor 6)."""
        m = np.abs(self.sdf) <= truncation_factor * self.voxel_size
        x, y, z = np.nonzero(m)
        return (
            np.stack([x, y, z], -1).astype(np.uint32),
            self.sdf[m].astype(np.float32),
        )

    def save_sdf(self, path, truncation_factor=6.0):
        """Write the reference .sdf layout (header + sparse xyz block)."""
        locs, vals = self.sparse_voxels(truncation_factor)
        X, Y, Z = self.dims
        with open(path, "wb") as f:
            np.array([X, Y, Z], "<u8").tofile(f)
            np.array([self.voxel_size], "<f4").tofile(f)
            np.asarray(self.world2grid, "<f4").reshape(16).tofile(f)
            np.array([len(locs)], "<u8").tofile(f)
            np.ascontiguousarray(locs, "<u4").tofile(f)
            np.asarray(vals, "<f4").tofile(f)

    def save_known(self, path):
        """Write the reference .knw layout (dense, z-major like Grid3's
        linear order: data[x*Y*Z + ...]? Grid3 stores (x,y,z) with x
        slowest; the training loader reshapes to [dimz,dimy,dimx], so the
        file order must be z-slowest over (x fastest). Grid3<Voxel> uses
        linear index (z*dimY + y)*dimX + x? mLib Grid3 indexes
        d[x*dimY*dimZ...]. The authoritative contract is the loader
        (data_util.py:91-92): reshape([dimz,dimy,dimx]) => file order is
        x-fastest, z-slowest — transpose our (x,y,z) grid accordingly."""
        X, Y, Z = self.dims
        known = self.known_grid().transpose(2, 1, 0)  # -> [Z, Y, X]
        with open(path, "wb") as f:
            np.array([X, Y, Z], "<u8").tofile(f)
            np.array([self.voxel_size], "<f4").tofile(f)
            np.asarray(self.world2grid, "<f4").reshape(16).tofile(f)
            np.ascontiguousarray(known, "u1").tofile(f)


def make_grid_for_scene(bbox_min, bbox_max, voxel_size, scene_obb: OBB,
                        scene_pad=6, height_pad=3):
    """Fuser.cpp:47-61: voxel dims from bbox extent + padding; worldToGrid =
    scale(1/vs) * translate(-bbmin + (pad,pad,hpad)*vs); OBB expanded by
    the pads in grid space."""
    bbox_min = np.asarray(bbox_min, np.float64)
    bbox_max = np.asarray(bbox_max, np.float64)
    dims = np.round((bbox_max - bbox_min) / voxel_size).astype(np.int64)
    dims += np.array([2 * scene_pad, 2 * scene_pad, 2 * height_pad])
    t = np.eye(4)
    t[:3, 3] = -bbox_min + np.array(
        [scene_pad, scene_pad, height_pad]
    ) * voxel_size
    s = np.eye(4)
    s[0, 0] = s[1, 1] = s[2, 2] = 1.0 / voxel_size
    world2grid = (s @ t).astype(np.float32)
    obb_grid = scene_obb.transformed(world2grid).expanded(
        np.array([scene_pad, scene_pad, height_pad], np.float64)
    )
    return VoxelGrid(dims, world2grid, voxel_size, obb_grid)


def fuse_scene(
    grid: VoxelGrid,
    frames,  # iterable of (depth [H,W] float32 w/ -inf invalid, intr, pose)
    incomplete_ids,
    complete_ids,
    out_incomplete=None,  # (sdf_path, knw_path) or None
    out_complete=None,
    filter_depth=True,
    trunc_factor=6.0,
    impl="native",
):
    """Fuser::fuse (Fuser.cpp:21-180): integrate the incomplete frame
    subset first, save, then integrate the remaining complete frames into
    the SAME grid and save (complete is a superset scan). ``impl``: the
    integrator, as VoxelGrid.integrate takes it."""
    from sgnn_tpu_torch.datagen.camera import bilateral_filter

    frames = list(frames)
    byid = {i: f for i, f in zip(range(len(frames)), frames)}

    def run(ids):
        for i in ids:
            f = byid.get(i)
            if f is None:
                continue
            depth, intr, pose = f
            if filter_depth:
                depth = bilateral_filter(depth, 2.0, 0.1)
            grid.integrate(intr, pose, depth, impl=impl)

    rest = [i for i in complete_ids if i not in set(incomplete_ids)]
    run(incomplete_ids)
    if out_incomplete:
        grid.save_sdf(out_incomplete[0], trunc_factor)
        if out_incomplete[1]:
            grid.save_known(out_incomplete[1])
    if out_complete:
        run(rest)
        grid.save_sdf(out_complete[0], trunc_factor)
        if out_complete[1]:
            grid.save_known(out_complete[1])
    return grid


def verify_roundtrip(grid: VoxelGrid, sdf_path: str, eps: float = 1e-5,
                     trunc_factor: float = 6.0) -> bool:
    """Reload a saved .sdf and compare voxel-by-voxel against the grid —
    the reference's s_bDebugVis validation (Fuser.cpp:95-130)."""
    from sgnn_tpu_torch.data import formats as F

    vol = F.load_scene(sdf_path)
    dense = F.sparse_to_dense(vol.locs, vol.sdf, vol.dims, -np.inf)
    m = np.abs(grid.sdf) <= trunc_factor * grid.voxel_size
    x, y, z = np.nonzero(m)
    got = dense[z, y, x] * grid.voxel_size  # back to world units
    return bool(np.allclose(got, grid.sdf[m], atol=eps, rtol=1e-4))


def export_debug_mesh(grid: VoxelGrid, path: str):
    """Debug isosurface of the fused grid (the reference's doMC debug
    meshes, MarchingCubes.h:14-78) through our marching cubes."""
    from sgnn_tpu_torch.meshing.marching_cubes import marching_cubes

    sdf_vox = np.where(
        np.isfinite(grid.sdf), grid.sdf / grid.voxel_size, -np.inf
    ).transpose(2, 1, 0)  # (x,y,z)-indexed -> [Z, Y, X]
    marching_cubes(sdf_vox, None, 0.0, 3.0 - 0.1, 10.0, path)


def select_frames_in_obb(poses, obb: OBB, min_extra=30):
    """Scene::computeTrajFramesInScene (Scene.h:50-79): frames whose camera
    center lies in the room OBB, plus the 30 closest remaining cameras."""
    centers = np.asarray([p[:3, 3] for p in poses])
    finite = np.isfinite(centers).all(-1)
    inside = obb.contains(centers) & finite
    ids = list(np.nonzero(inside)[0])
    outside = np.nonzero(~inside & finite)[0]
    d = np.linalg.norm(centers[outside] - obb.center, axis=1)
    order = outside[np.argsort(d)]
    ids.extend(order[:min_extra].tolist())
    return ids


def drop_frames(frame_ids, chance_drop=0.65, seed=0):
    """generateIncompleteFramesMatterport (Visualizer.h:28-35): keep each
    frame with probability 1-chance_drop."""
    rng = np.random.RandomState(seed)
    keep = [f for f in frame_ids if rng.rand() >= chance_drop]
    if not keep and frame_ids:
        keep = [frame_ids[0]]
    return keep
