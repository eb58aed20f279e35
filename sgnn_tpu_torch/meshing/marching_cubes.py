"""Vectorized marching cubes over dense TSDF volumes.

Port of ``sgnn_tpu/meshing/marching_cubes.py`` (a copy: the JAX package's
modules cannot be imported without jax). Same semantics as the
reference's C++ extension (marching_cubes/marching_cubes.cpp),
re-expressed as whole-volume numpy array ops instead of a single-threaded
triple loop:

  * cube corners sit at voxel centers ± 0.5; each corner's value is the
    trilinear sample at that half-integer position == the mean of its 8
    adjacent voxels; a corner is valid only if all 8 voxels are valid
    (finite and |d| < truncation) and in bounds (get_voxel/trilerp,
    marching_cubes.cpp:72-131).
  * a cube is skipped if any corner is invalid; if any pair of corner
    distances is inconsistent (opposite signs with |di|+|dj| > thresh, or
    same sign with |di-dj| > thresh); or if any |corner| > thresh
    (marching_cubes.cpp:206-223).
  * vertices are interpolated on intersected edges (Bourke tables) with the
    reference's epsilon short-circuits (marching_cubes.cpp:133-154).
  * mesh cleanup: weld coincident vertices (the reference's approx spatial
    hash with thresh 1e-5 reduces to quantized-key dedup), drop degenerate
    and duplicate faces (marching_cubes.cpp:266-323,359-456).

A native C++ core (meshing/native.py) implements the same algorithm for
large volumes and is the default; the numpy path here is the correctness
oracle, taken only when a caller asks for it (``impl="numpy"``).
"""

from __future__ import annotations

import numpy as np

from sgnn_tpu_torch.meshing.tables import EDGE_TABLE, TRI_TABLE

# Edge endpoints as corner indices into the reference's distArray order
# [p000, p100, p010, p001, p110, p011, p101, p111]
# (marching_cubes.cpp:201), matching vertlist assignments :234-245.
_CORNERS = {
    "000": 0, "100": 1, "010": 2, "001": 3,
    "110": 4, "011": 5, "101": 6, "111": 7,
}
_EDGE_ENDPOINTS = np.array(
    [
        (_CORNERS["010"], _CORNERS["110"]),  # edge 0
        (_CORNERS["110"], _CORNERS["100"]),  # edge 1
        (_CORNERS["100"], _CORNERS["000"]),  # edge 2
        (_CORNERS["000"], _CORNERS["010"]),  # edge 3
        (_CORNERS["011"], _CORNERS["111"]),  # edge 4
        (_CORNERS["111"], _CORNERS["101"]),  # edge 5
        (_CORNERS["101"], _CORNERS["001"]),  # edge 6
        (_CORNERS["001"], _CORNERS["011"]),  # edge 7
        (_CORNERS["010"], _CORNERS["011"]),  # edge 8
        (_CORNERS["110"], _CORNERS["111"]),  # edge 9
        (_CORNERS["100"], _CORNERS["101"]),  # edge 10
        (_CORNERS["000"], _CORNERS["001"]),  # edge 11
    ],
    dtype=np.int32,
)

# Corner offsets in (x, y, z), label order p000..p111 above: pXYZ means
# x-offset X, y-offset Y, z-offset Z (marching_cubes.cpp:170-177).
_CORNER_OFFSETS_XYZ = np.array(
    [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1),
    ],
    dtype=np.int32,
)

# Cube-index bit per corner: bit0 p010, bit1 p110, bit2 p100, bit3 p000,
# bit4 p011, bit5 p111, bit6 p101, bit7 p001 (marching_cubes.cpp:192-199).
_CORNER_BITS = np.array([8, 4, 1, 128, 2, 16, 64, 32], dtype=np.int32)


def _corner_grids(tsdf: np.ndarray, truncation: float):
    """Corner-sample grid CG[(Z+1),(Y+1),(X+1)] + validity.

    CG[c] is the mean of the 8 voxels adjacent to corner position c - 0.5
    (per axis); valid iff all 8 exist and are valid.
    """
    Z, Y, X = tsdf.shape
    valid = np.isfinite(tsdf) & (np.abs(tsdf) < truncation)
    vals = np.where(valid, tsdf, 0.0).astype(np.float64)
    cg = np.zeros((Z + 1, Y + 1, X + 1), np.float64)
    cnt = np.zeros((Z + 1, Y + 1, X + 1), np.int32)
    ok = np.zeros((Z + 1, Y + 1, X + 1), np.bool_)
    # accumulate the 8 neighbors of each corner
    acc = np.zeros_like(cg)
    nvalid = np.zeros_like(cnt)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                acc[dz : dz + Z, dy : dy + Y, dx : dx + X] += vals
                nvalid[dz : dz + Z, dy : dy + Y, dx : dx + X] += valid
                cnt[dz : dz + Z, dy : dy + Y, dx : dx + X] += 1
    ok = (cnt == 8) & (nvalid == 8)
    cg = acc / 8.0
    return cg.astype(np.float32), ok


def _gather_corners(cg, ok, Z, Y, X):
    """Per-voxel [N, 8] corner dists/validity in p000..p111 label order."""
    dists = np.empty((Z, Y, X, 8), np.float32)
    valid = np.empty((Z, Y, X, 8), np.bool_)
    for i, (ox, oy, oz) in enumerate(_CORNER_OFFSETS_XYZ):
        dists[..., i] = cg[oz : oz + Z, oy : oy + Y, ox : ox + X]
        valid[..., i] = ok[oz : oz + Z, oy : oy + Y, ox : ox + X]
    return dists, valid


def _vertex_interp(isolevel, p1, p2, d1, d2):
    """marching_cubes.cpp:133-154 epsilon rules, vectorized."""
    eps = 1e-5
    mu = (isolevel - d1) / np.where(np.abs(d2 - d1) < 1e-20, 1.0, d2 - d1)
    res = p1 + mu[:, None] * (p2 - p1)
    res = np.where((np.abs(isolevel - d1) < eps)[:, None], p1, res)
    take_p2 = (np.abs(isolevel - d2) < eps) & ~(np.abs(isolevel - d1) < eps)
    res = np.where(take_p2[:, None], p2, res)
    take_p1 = (
        (np.abs(d1 - d2) < eps)
        & ~(np.abs(isolevel - d1) < eps)
        & ~(np.abs(isolevel - d2) < eps)
    )
    res = np.where(take_p1[:, None], p1, res)
    return res


def run_marching_cubes_numpy(
    tsdf: np.ndarray,
    colors: np.ndarray | None = None,
    isovalue: float = 0.0,
    truncation: float = 3.0,
    thresh: float = 10.0,
):
    """Extract the triangle soup (pre-weld).

    Args:
        tsdf: [Z, Y, X] float32 (-inf marks missing voxels).
        colors: optional [Z, Y, X, 3] uint8 (default 220 gray).
        isovalue/truncation/thresh: reference parameters.

    Returns (tri_verts [T,3,3] float32 xyz, tri_colors [T,3,3] uint8).
    """
    tsdf = np.asarray(tsdf, np.float32)
    Z, Y, X = tsdf.shape
    cg, ok = _corner_grids(tsdf, truncation)
    dists, cvalid = _gather_corners(cg, ok, Z, Y, X)
    dists_f = dists.reshape(-1, 8)
    all_valid = cvalid.reshape(-1, 8).all(-1)

    # cube index
    below = dists_f < isovalue
    cube_idx = (below * _CORNER_BITS[None, :]).sum(-1)

    # pairwise consistency checks (marching_cubes.cpp:206-223)
    di = dists_f[:, :, None]
    dj = dists_f[:, None, :]
    opposite = di * dj < 0.0
    bad = np.where(
        opposite,
        np.abs(di) + np.abs(dj) > thresh,
        np.abs(di - dj) > thresh,
    ).any(axis=(1, 2))
    bad |= (np.abs(dists_f) > thresh).any(-1)

    etab = EDGE_TABLE[cube_idx]
    active = all_valid & ~bad & (etab != 0) & (etab != 255)
    idx = np.nonzero(active)[0]
    if len(idx) == 0:
        return (
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 3), np.uint8),
        )

    # voxel centers (x, y, z) for active cubes
    vz, rem = idx // (Y * X), idx % (Y * X)
    vy, vx = rem // X, rem % X
    center = np.stack([vx, vy, vz], -1).astype(np.float32)
    d_act = dists_f[idx]  # [n, 8]
    e_act = etab[idx]
    ci_act = cube_idx[idx]

    # corner positions (xyz): center +/- 0.5 per _CORNER_OFFSETS_XYZ
    cpos = (
        center[:, None, :]
        + (_CORNER_OFFSETS_XYZ[None].astype(np.float32) - 0.5)
    )  # [n, 8, 3]

    # interpolate the 12 possible edge vertices
    vertlist = np.zeros((len(idx), 12, 3), np.float32)
    for e in range(12):
        a, b = _EDGE_ENDPOINTS[e]
        need = (e_act & (1 << e)) != 0
        if not need.any():
            continue
        v = _vertex_interp(
            isovalue, cpos[:, a, :], cpos[:, b, :], d_act[:, a], d_act[:, b]
        )
        vertlist[:, e, :] = np.where(need[:, None], v, 0)

    # triangle emission via TRI_TABLE
    tt = TRI_TABLE[ci_act]  # [n, 16]
    tri_counts = (tt[:, ::3] != -1).sum(-1)  # up to 5
    max_t = 5
    tris = []
    cols = []
    if colors is None:
        col_lookup = None
    else:
        col_lookup = colors.reshape(-1, 3)
    for t in range(max_t):
        sel = tri_counts > t
        if not sel.any():
            break
        rows = np.nonzero(sel)[0]
        e3 = tt[rows, 3 * t : 3 * t + 3]  # [m, 3] edge ids
        verts = vertlist[rows[:, None], e3, :]  # [m, 3, 3]
        tris.append(verts)
        if col_lookup is not None:
            c = col_lookup[idx[rows]]
        else:
            c = np.full((len(rows), 3), 220, np.uint8)
        cols.append(np.repeat(c[:, None, :], 3, axis=1))
    tri_verts = np.concatenate(tris, 0).astype(np.float32)
    tri_colors = np.concatenate(cols, 0).astype(np.uint8)
    return tri_verts, tri_colors


def weld_vertices(tri_verts, tri_colors, thresh=1e-5):
    """Merge coincident vertices; returns (verts, colors, faces).

    The reference welds with an approximate spatial hash at thresh 1e-5
    (marching_cubes.cpp:359-456); at that scale quantized-key dedup is
    equivalent: vertices from shared cube edges are bit-identical.
    """
    flat = tri_verts.reshape(-1, 3)
    flat_cols = tri_colors.reshape(-1, 3)
    if len(flat) == 0:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.uint8),
            np.zeros((0, 3), np.int32),
        )
    q = np.round(flat / thresh).astype(np.int64)
    # unique rows keeping FIRST occurrence order (matches reference counter)
    _, first_idx, inverse = np.unique(
        q, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    lookup = rank[inverse]
    verts = flat[np.sort(first_idx)]
    cols = flat_cols[np.sort(first_idx)]
    faces = lookup.reshape(-1, 3).astype(np.int32)
    # remove degenerate faces (repeated vertex ids)
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[keep]
    # remove duplicate faces (unordered triple)
    key = np.sort(faces, axis=1)
    _, uniq_idx = np.unique(key, axis=0, return_index=True)
    faces = faces[np.sort(uniq_idx)]
    return verts.astype(np.float32), cols, faces


def run_marching_cubes(
    tsdf,
    colors=None,
    isovalue: float = 0.0,
    truncation: float = 3.0,
    thresh: float = 10.0,
    impl: str = "native",
):
    """Full pipeline: triangle soup + weld + face cleanup.

    Returns (verts [V,3] xyz, vert_colors [V,3] uint8, faces [F,3] int32).
    Equivalent of marching_cubes_cpp.run_marching_cubes
    (the reference's marching_cubes/marching_cubes.cpp:480-517).
    ``impl``: "native" (the C++ core, built at first use; a failed build
    raises) or "numpy".
    """
    tsdf = np.asarray(tsdf, np.float32)
    if impl == "native":
        from sgnn_tpu_torch.meshing import native

        tv, tc = native.get_native().run(tsdf, colors, isovalue,
                                         truncation, thresh)
    elif impl == "numpy":
        tv, tc = run_marching_cubes_numpy(tsdf, colors, isovalue,
                                          truncation, thresh)
    else:
        raise ValueError(f"impl must be 'native' or 'numpy', not {impl!r}")
    return weld_vertices(tv, tc)


def marching_cubes(tsdf, colors, isovalue, truncation, thresh,
                   output_filename, impl: str = "native"):
    """Drop-in for the reference shim (the reference's marching_cubes/
    marching_cubes.py:28-35): extract and write a mesh file (.ply/.obj)."""
    from sgnn_tpu_torch.meshing.ply import save_mesh

    verts, cols, faces = run_marching_cubes(
        tsdf, colors, isovalue, truncation, thresh, impl=impl
    )
    save_mesh(output_filename, verts, cols, faces)
    return verts, cols, faces
