"""Mesh file writers: binary PLY (reference format) and OBJ.

A copy of ``sgnn_tpu/meshing/ply.py``.

PLY layout matches the reference writer exactly (the reference's
marching_cubes/marching_cubes.cpp:519-560): binary_little_endian, vertex =
3x float32 + 3x uint8 rgb, face = uchar count + 3x int32.
"""

from __future__ import annotations

import numpy as np


def save_ply(path, verts, colors, faces):
    verts = np.asarray(verts, "<f4")
    colors = np.asarray(colors, np.uint8)
    faces = np.asarray(faces, "<i4")
    n_v, n_f = len(verts), len(faces)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n_v}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {n_f}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    vert_rec = np.zeros(
        n_v,
        dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))],
    )
    vert_rec["xyz"] = verts
    vert_rec["rgb"] = colors
    face_rec = np.zeros(n_f, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vert_rec.tobytes())
        f.write(face_rec.tobytes())


def load_ply(path):
    """Read back a PLY written by save_ply (for tests/round-trips)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode()
    n_v = int(header.split("element vertex ")[1].split("\n")[0])
    n_f = int(header.split("element face ")[1].split("\n")[0])
    vert_rec = np.frombuffer(
        data, dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))],
        count=n_v, offset=end,
    )
    off = end + vert_rec.itemsize * n_v
    face_rec = np.frombuffer(
        data, dtype=[("n", "u1"), ("idx", "<i4", (3,))], count=n_f, offset=off
    )
    return (
        vert_rec["xyz"].copy(),
        vert_rec["rgb"].copy(),
        face_rec["idx"].copy(),
    )


def save_obj(path, verts, colors, faces):
    """OBJ with per-vertex colors (reference save_mesh, marching_cubes.py:10-19)."""
    with open(path, "w") as f:
        for v, c in zip(verts, colors):
            f.write(
                f"v {v[0]:f} {v[1]:f} {v[2]:f} {int(c[0])} {int(c[1])} {int(c[2])}\n"
            )
        f.write("g foo\n")
        for ind in faces:
            f.write(f"f {ind[0] + 1} {ind[1] + 1} {ind[2] + 1}\n")
        f.write("g\n")


def save_mesh(path, verts, colors, faces):
    if str(path).endswith(".obj"):
        save_obj(path, verts, colors, faces)
    else:
        save_ply(path, verts, colors, faces)


def save_points(path, points, colors=None, transform=None):
    """Point-cloud export (reference visualize_points, data_util.py:211-238)."""
    pts = np.asarray(points, np.float32)
    if transform is not None:
        x = np.ones((len(pts), 4), np.float32)
        x[:, :3] = pts
        x = (np.asarray(transform) @ x.T).T
        pts = x[:, :3] / x[:, 3:4]
    if str(path).endswith(".obj") or colors is not None:
        path = str(path).rsplit(".", 1)[0] + ".obj"
        with open(path, "w") as f:
            for i, v in enumerate(pts):
                if colors is None:
                    f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
                else:
                    c = np.clip(colors[i], 0, 1)
                    f.write(
                        f"v {v[0]:f} {v[1]:f} {v[2]:f} {c[0]:f} {c[1]:f} {c[2]:f}\n"
                    )
    else:
        save_ply(path, pts, np.full((len(pts), 3), 220, np.uint8),
                 np.zeros((0, 3), np.int32))
