"""Scene/room handling for datagen: meshes, alignment, directory layout
(port of ``sgnn_tpu/datagen/scene.py``).

Replaces the reference's mLib-based Scene/ScansDirectory (the reference's
datagen/GenerateScans/src/Scene.cpp, ScansDirectory.h): loads the room
mesh (for bbox/OBB), optional .aln alignment, and resolves the Matterport
on-disk layout.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from sgnn_tpu_torch.datagen.fusion import OBB
from sgnn_tpu_torch.datagen.sens import SensFile


def load_ply_vertices(path: str) -> np.ndarray:
    """Minimal generic PLY vertex reader: returns [N, 3] float32 xyz.

    Handles ascii and binary_little_endian with arbitrary extra vertex
    properties (Matterport .reduced.ply has normals/colors); only x/y/z are
    extracted.
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode(errors="replace").splitlines()
    fmt = None
    n_verts = 0
    props = []  # of (name, dtype) for the vertex element
    in_vertex = False
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
        "short": "<i2", "ushort": "<u2", "char": "i1", "uchar": "u1",
        "int8": "i1", "uint8": "u1", "int16": "<i2", "uint16": "<u2",
    }
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                n_verts = int(t[2])
        elif t[0] == "property" and in_vertex:
            if t[1] == "list":
                raise ValueError("list property in vertex element")
            props.append((t[2], type_map[t[1]]))
    if fmt == "ascii":
        rows = []
        text = data[end:].decode()
        names = [p[0] for p in props]
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        for line in text.splitlines()[:n_verts]:
            v = line.split()
            rows.append([float(v[ix]), float(v[iy]), float(v[iz])])
        return np.asarray(rows, np.float32)
    dt = np.dtype([(n, t) for n, t in props])
    rec = np.frombuffer(data, dt, n_verts, end)
    return np.stack(
        [rec["x"], rec["y"], rec["z"]], -1
    ).astype(np.float32)


def load_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Vertices [V,3] + triangle faces [T,3] from a binary_little_endian or
    ascii PLY (faces read from the 'vertex_indices'/'vertex_index' list
    property; polygons are fan-triangulated)."""
    verts = load_ply_vertices(path)
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode(errors="replace").splitlines()
    fmt = None
    elements = []  # (name, count, props) in declaration order
    cur = None
    type_map = {
        "float": ("<f4", 4), "float32": ("<f4", 4), "double": ("<f8", 8),
        "int": ("<i4", 4), "int32": ("<i4", 4), "uint": ("<u4", 4),
        "uint32": ("<u4", 4), "short": ("<i2", 2), "ushort": ("<u2", 2),
        "char": ("i1", 1), "uchar": ("u1", 1), "int8": ("i1", 1),
        "uint8": ("u1", 1), "int16": ("<i2", 2), "uint16": ("<u2", 2),
        "float64": ("<f8", 8),
    }
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elements.append(cur)
        elif t[0] == "property" and cur is not None:
            cur[2].append(t[1:])
    if fmt == "ascii":
        lines = data[end:].decode().splitlines()
        off = 0
        faces = []
        for name, count, props in elements:
            if name == "face":
                for i in range(count):
                    vals = lines[off + i].split()
                    n = int(vals[0])
                    idx = [int(v) for v in vals[1 : 1 + n]]
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            off += count
        return verts, np.asarray(faces, np.int32).reshape(-1, 3)
    # binary: walk elements sequentially
    off = end
    faces = []
    for name, count, props in elements:
        if name != "face" and all(p[0] != "list" for p in props):
            row = sum(type_map[p[0]][1] for p in props)
            off += row * count
            continue
        for _ in range(count):
            row_vals = None
            for p in props:
                if p[0] == "list":
                    cnt_t, item_t = type_map[p[1]], type_map[p[2]]
                    n = int(np.frombuffer(data, cnt_t[0], 1, off)[0])
                    off += cnt_t[1]
                    idx = np.frombuffer(data, item_t[0], n, off)
                    off += item_t[1] * n
                    if name == "face" and p[3] in (
                        "vertex_indices", "vertex_index"
                    ):
                        row_vals = idx
                else:
                    off += type_map[p[0]][1]
            if name == "face" and row_vals is not None:
                idx = row_vals
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.asarray(faces, np.int32).reshape(-1, 3)


def load_aln(path: str) -> np.ndarray:
    """.aln alignment: 3 header lines then a 4x4 row-major matrix
    (Scene.cpp:11-21)."""
    lines = open(path).read().split()
    # skip the 3 header lines: tokenize everything and take the last 16
    vals = [float(v) for v in lines[-16:]]
    return np.asarray(vals, np.float32).reshape(4, 4)


@dataclasses.dataclass
class ScanInfo:
    scene_name: str  # "SCENE_roomN"
    mesh_file: str
    sens_files: list


def load_matterport_list(scan_path, scan_mesh_path, scene_list_file,
                         max_num_sens=3):
    """ScansDirectory::loadMatterport (ScansDirectory.h:30-64)."""
    scans = []
    for room in open(scene_list_file).read().splitlines():
        if not room.strip():
            continue
        scene, room_id = room.split("_room")
        mesh = os.path.join(
            scan_mesh_path, scene, "region_segmentations",
            f"region{room_id}.reduced.ply",
        )
        sens_dir = os.path.join(scan_path, scene, "sens")
        sens = [
            os.path.join(sens_dir, f"{scene}_{i}.sens")
            for i in range(max_num_sens)
        ]
        sens = [s for s in sens if os.path.isfile(s)]
        scans.append(ScanInfo(room, mesh, sens))
    return scans


class Scene:
    """A room: mesh bounds/OBB + the scene's .sens streams.

    Mirrors Scene::load/updateRoom (Scene.cpp:5-60): mesh transformed by
    the optional .aln (then translated to positive octant), bbox/OBB from
    vertices with the z-up OBB.
    """

    def __init__(self, scan_info: ScanInfo, aln_file: str | None = None,
                 use_rendered_depth: bool = False):
        self.info = scan_info
        if use_rendered_depth:
            verts, self.faces = load_ply_mesh(scan_info.mesh_file)
        else:
            verts = load_ply_vertices(scan_info.mesh_file)
            self.faces = None
        transform = np.eye(4, dtype=np.float32)
        if aln_file and os.path.isfile(aln_file):
            align = load_aln(aln_file)
            v = (align[:3, :3] @ verts.T).T + align[:3, 3]
            shift = -v.min(0)
            verts = v + shift
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = shift
            transform = t @ align
        self.transform = transform
        self.verts = verts
        self.use_rendered_depth = use_rendered_depth
        self.bbox_min = verts.min(0)
        self.bbox_max = verts.max(0)
        self.obb = OBB.from_points_zup(verts)
        self.sens = [SensFile(p) for p in scan_info.sens_files]
        self.frame_index = []  # (sens_idx, frame_idx)
        poses = []
        for si, sf in enumerate(self.sens):
            for fi in range(sf.num_frames):
                self.frame_index.append((si, fi))
                poses.append(self.transform @ sf.poses[fi])
        self.poses = np.asarray(poses) if poses else np.zeros((0, 4, 4))

    def depth_frame(self, linear_id, width, height, near=0.1, far=10.0):
        si, fi = self.frame_index[linear_id]
        if self.use_rendered_depth:
            # render depth from the room mesh at the frame's camera
            # (Scene::renderDepthFrame path)
            from sgnn_tpu_torch.datagen.render import render_depth

            pose = self.poses[linear_id]
            if not np.isfinite(pose).all():
                return None
            sf = self.sens[si]
            intr = sf.depth_intrinsic.copy()
            W0, H0 = sf.depth_width, sf.depth_height
            intr[0, 0] *= width / W0
            intr[1, 1] *= height / H0
            intr[0, 2] *= (width - 1) / (W0 - 1)
            intr[1, 2] *= (height - 1) / (H0 - 1)
            depth = render_depth(
                self.verts, self.faces, pose, intr, width, height,
                near=near, far=far,
            )
            return depth, intr, pose
        out = self.sens[si].depth_frame(fi, width, height)
        if out is None:
            return None
        depth, intr, pose = out
        return depth, intr, (self.transform @ pose)

    def close(self):
        for s in self.sens:
            s.close()
