"""Reader and writer of mLib/ScanNet .sens RGB-D streams (SensorData
v4); port of ``sgnn_tpu/datagen/sens.py``.

Byte layout (mLib SensorData.h, consumed by the reference datagen via
the reference's datagen/GenerateScans/src/Scene.cpp:167-204):

    uint32 version (==4)
    uint64 nameLen; char name[nameLen]
    color calibration: float32 intrinsic[16]; float32 extrinsic[16]
    depth calibration: float32 intrinsic[16]; float32 extrinsic[16]
    uint32 colorCompression; uint32 depthCompression
    uint32 colorWidth, colorHeight, depthWidth, depthHeight
    float32 depthShift            (depth_m = raw / depthShift)
    uint64 numFrames
    per frame:
        float32 cameraToWorld[16]
        uint64 timestampColor, timestampDepth
        uint64 colorBytes, depthBytes
        uint8 color[colorBytes]   (jpeg — not needed for fusion)
        uint8 depth[depthBytes]   (zlib-compressed uint16 row-major)

Only depth is decoded (the reference's default fuse path never touches
color: s_bUseRenderedDepth=false, zParametersScanMP.txt:40). Frames are
indexed lazily — the file is memory-mapped and per-frame byte offsets are
scanned once at open.
"""

from __future__ import annotations

import mmap
import struct
import zlib

import numpy as np


class SensFile:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        off = 0

        def take(fmt):
            nonlocal off
            size = struct.calcsize(fmt)
            vals = struct.unpack_from(fmt, self._m, off)
            off += size
            return vals

        (self.version,) = take("<I")
        assert self.version == 4, f"unsupported .sens version {self.version}"
        (name_len,) = take("<Q")
        self.name = self._m[off : off + name_len].decode(errors="replace")
        off += name_len
        self.color_intrinsic = np.array(take("<16f"), np.float32).reshape(4, 4)
        self.color_extrinsic = np.array(take("<16f"), np.float32).reshape(4, 4)
        self.depth_intrinsic = np.array(take("<16f"), np.float32).reshape(4, 4)
        self.depth_extrinsic = np.array(take("<16f"), np.float32).reshape(4, 4)
        (self.color_compression,) = take("<i")
        (self.depth_compression,) = take("<i")
        (self.color_width, self.color_height) = take("<II")
        (self.depth_width, self.depth_height) = take("<II")
        (self.depth_shift,) = take("<f")
        (self.num_frames,) = take("<Q")

        self.poses = np.empty((self.num_frames, 4, 4), np.float32)
        self._depth_spans = []
        for i in range(self.num_frames):
            self.poses[i] = np.array(take("<16f"), np.float32).reshape(4, 4)
            take("<QQ")  # timestamps
            (color_bytes, depth_bytes) = take("<QQ")
            off += color_bytes
            self._depth_spans.append((off, depth_bytes))
            off += depth_bytes

    def close(self):
        self._m.close()
        self._f.close()

    def depth_raw(self, frame: int) -> np.ndarray:
        """[H, W] uint16 raw depth (0 = invalid)."""
        start, size = self._depth_spans[frame]
        buf = self._m[start : start + size]
        if self.depth_compression != 0:  # TYPE_ZLIB_USHORT
            buf = zlib.decompress(buf)
        return np.frombuffer(buf, "<u2").reshape(
            self.depth_height, self.depth_width
        )

    def depth_frame(
        self,
        frame: int,
        out_width: int,
        out_height: int,
        min_depth: float = 0.0,
        max_depth: float = 12.0,
    ):
        """Resampled metric depth + adapted intrinsic, exactly like
        Scene::getRawDepthFrame (Scene.cpp:167-204): nearest-neighbor
        resample on a (N-1)-spaced grid; fx/fy scaled by N_new/N_old,
        cx/cy by (N_new-1)/(N_old-1); invalid -> -inf.

        Returns (depth [out_h, out_w] float32, intrinsic [4,4], pose [4,4]);
        None if the frame pose is invalid.
        """
        pose = self.poses[frame]
        if not np.isfinite(pose).all():
            return None
        raw = self.depth_raw(frame)
        H, W = raw.shape
        fx = np.round(
            np.arange(out_width) * (W - 1) / (out_width - 1)
        ).astype(np.int64)
        fy = np.round(
            np.arange(out_height) * (H - 1) / (out_height - 1)
        ).astype(np.int64)
        d = raw[fy[:, None], fx[None, :]].astype(np.float32)
        depth = d / self.depth_shift
        invalid = (d == 0) | (depth < min_depth) | (depth > max_depth)
        depth = np.where(invalid, -np.inf, depth).astype(np.float32)
        intr = self.depth_intrinsic.copy()
        intr[0, 0] *= out_width / W
        intr[1, 1] *= out_height / H
        intr[0, 2] *= (out_width - 1) / (W - 1)
        intr[1, 2] *= (out_height - 1) / (H - 1)
        return depth, intr, pose


def write_sens(path, name, depth_intrinsic, depth_frames, poses,
               depth_shift=1000.0, color_intrinsic=None):
    """Minimal .sens writer (tests + synthetic data generation).

    depth_frames: list of [H, W] uint16 raw depth images.
    """
    H, W = depth_frames[0].shape
    ci = np.eye(4, dtype="<f4") if color_intrinsic is None else color_intrinsic
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        nb = name.encode()
        f.write(struct.pack("<Q", len(nb)))
        f.write(nb)
        f.write(np.asarray(ci, "<f4").tobytes())
        f.write(np.eye(4, dtype="<f4").tobytes())
        f.write(np.asarray(depth_intrinsic, "<f4").tobytes())
        f.write(np.eye(4, dtype="<f4").tobytes())
        f.write(struct.pack("<ii", 0, 1))  # color raw, depth zlib
        f.write(struct.pack("<IIII", W, H, W, H))
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", len(depth_frames)))
        for pose, depth in zip(poses, depth_frames):
            f.write(np.asarray(pose, "<f4").tobytes())
            f.write(struct.pack("<QQ", 0, 0))
            dz = zlib.compress(np.asarray(depth, "<u2").tobytes())
            f.write(struct.pack("<QQ", 0, len(dz)))
            f.write(dz)
