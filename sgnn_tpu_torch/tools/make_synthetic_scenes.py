"""Build a population of varied synthetic indoor scenes in Matterport
layout (region mesh + .sens depth trajectory), ready for the datagen
pipeline (generate_scans -> make_chunks); port of the JAX package's
``tools/make_synthetic_scenes.py``, the same scenes for the same seed.

Matterport3D room scans cannot be fetched in a sealed run; this
generator stands in for them so the full fade-in training schedule can
be exercised end to end (the reference's de-facto validation loop, its
torch/train.py:233-453). Rooms vary in footprint (rect / L-shaped), size,
wall height, and carry randomized clutter (tables, cabinets, shelves,
prisms, sofas) so chunks span a realistic range of surface density.
Depth is rendered by the native rasterizer (datagen/render.py).

Usage:
    python -m sgnn_tpu_torch.tools.make_synthetic_scenes --out data/synth \
        --num_scenes 200 [--width 320 --height 240] [--frames 40]

Writes:
    <out>/meshes/<SCENE>/region_segmentations/region0.reduced.ply
    <out>/scans/<SCENE>/sens/<SCENE>_0.sens
    <out>/scenes.txt            (all "<SCENE>_room0" lines)
    <out>/scenes_train.txt / scenes_val.txt  (--val_frac split)
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


# --------------------------------------------------------------- mesh parts
def _box(lo, hi):
    """Axis-aligned box mesh (12 tris, outward normals irrelevant —
    the z-buffer rasterizer is two-sided)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    f = np.array([
        [0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
    ], np.int32)
    return v, f


def _prism(cx, cy, r, z0, z1, n=8, phase=0.0):
    """n-sided vertical prism (approximates a cylinder)."""
    th = 2 * np.pi * np.arange(n) / n + phase
    ring0 = np.stack([cx + r * np.cos(th), cy + r * np.sin(th),
                      np.full(n, z0)], -1)
    ring1 = ring0.copy()
    ring1[:, 2] = z1
    v = np.concatenate([ring0, ring1, [[cx, cy, z0]], [[cx, cy, z1]]],
                       0).astype(np.float32)
    f = []
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j, n + j], [i, n + j, n + i]]           # side
        f += [[2 * n, j, i], [2 * n + 1, n + i, n + j]]   # caps
    return v, np.array(f, np.int32)


def _rotate_z(verts, angle, center):
    c, s = np.cos(angle), np.sin(angle)
    p = verts[:, :2] - center
    out = verts.copy()
    out[:, 0] = center[0] + c * p[:, 0] - s * p[:, 1]
    out[:, 1] = center[1] + s * p[:, 0] + c * p[:, 1]
    return out


def _merge(parts):
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts, 0), np.concatenate(faces, 0)


def _table(rng, x, y):
    w, d = rng.uniform(0.7, 1.6), rng.uniform(0.6, 1.0)
    h = rng.uniform(0.6, 0.85)
    t = 0.05
    leg = 0.06
    parts = [_box((x, y, h - t), (x + w, y + d, h))]
    for lx in (x + 0.02, x + w - leg - 0.02):
        for ly in (y + 0.02, y + d - leg - 0.02):
            parts.append(_box((lx, ly, 0), (lx + leg, ly + leg, h - t)))
    return _merge(parts)


def _shelf(rng, x, y):
    w, d = rng.uniform(0.6, 1.4), rng.uniform(0.25, 0.45)
    h = rng.uniform(1.2, 2.0)
    t = 0.03
    n = rng.randint(3, 6)
    parts = [
        _box((x, y, 0), (x + t, y + d, h)),
        _box((x + w - t, y, 0), (x + w, y + d, h)),
        _box((x, y, h - t), (x + w, y + d, h)),
    ]
    for k in range(n):
        z = h * (k + 1) / (n + 1)
        parts.append(_box((x, y, z - t), (x + w, y + d, z)))
    return _merge(parts)


def _sofa(rng, x, y):
    w, d = rng.uniform(1.2, 2.0), rng.uniform(0.7, 0.95)
    seat_h, back_h = rng.uniform(0.35, 0.45), rng.uniform(0.7, 0.9)
    arm = 0.15
    parts = [
        _box((x, y, 0), (x + w, y + d, seat_h)),                 # seat
        _box((x, y, seat_h), (x + w, y + 0.18, back_h)),         # back
        _box((x, y, seat_h), (x + arm, y + d, seat_h + 0.2)),    # arms
        _box((x + w - arm, y, seat_h), (x + w, y + d, seat_h + 0.2)),
    ]
    return _merge(parts)


def _cabinet(rng, x, y):
    w, d = rng.uniform(0.4, 1.2), rng.uniform(0.35, 0.6)
    h = rng.uniform(0.5, 1.9)
    return _box((x, y, 0), (x + w, y + d, h))


def _column(rng, x, y):
    r = rng.uniform(0.12, 0.35)
    h = rng.uniform(0.4, 2.2)
    n = rng.randint(6, 12)
    return _prism(x + r, y + r, r, 0, h, n=n, phase=rng.uniform(0, np.pi))


_CLUTTER = [_table, _shelf, _sofa, _cabinet, _cabinet, _column]


def build_room(rng):
    """Random room mesh: footprint polygon walls + floor + clutter.
    Returns (verts, faces, interior_rects) — interior_rects are (x0,y0,
    x1,y1) free-space rectangles used for camera placement."""
    wt = 0.04  # wall thickness stand-in: thin boxes
    H = rng.uniform(2.3, 2.7)
    W = rng.uniform(3.2, 5.6)
    D = rng.uniform(3.2, 5.6)
    lshape = rng.rand() < 0.35
    parts = []
    # floor
    parts.append(_box((0, 0, -wt), (W, D, 0)))
    # perimeter walls
    parts.append(_box((0, -wt, 0), (W, 0, H)))
    parts.append(_box((0, D, 0), (W, D + wt, H)))
    parts.append(_box((-wt, 0, 0), (0, D, H)))
    parts.append(_box((W, 0, 0), (W + wt, D, H)))
    rects = [(0.0, 0.0, W, D)]
    if lshape:
        # carve a corner by adding two interior walls (the notch region
        # is walled off; cameras avoid it)
        nw, nd = rng.uniform(0.3, 0.45) * W, rng.uniform(0.3, 0.45) * D
        parts.append(_box((W - nw, D - nd, 0), (W, D - nd + wt, H)))
        parts.append(_box((W - nw, D - nd, 0), (W - nw + wt, D, H)))
        rects = [(0.0, 0.0, W, D - nd), (0.0, 0.0, W - nw, D)]
    # ceiling on some rooms (Matterport rooms usually have one; it caps
    # the known-space coding from above)
    if rng.rand() < 0.5:
        parts.append(_box((0, 0, H), (W, D, H + wt)))
    # clutter
    occupied = []
    n_obj = rng.randint(3, 9)
    for _ in range(n_obj):
        maker = _CLUTTER[rng.randint(len(_CLUTTER))]
        for _try in range(8):
            rx0, ry0, rx1, ry1 = rects[rng.randint(len(rects))]
            x = rng.uniform(rx0 + 0.3, rx1 - 2.1)
            y = rng.uniform(ry0 + 0.3, ry1 - 1.3)
            if all(abs(x - ox) > 1.0 or abs(y - oy) > 1.0
                   for ox, oy in occupied):
                break
        v, f = maker(rng, x, y)
        ang = rng.choice([0, np.pi / 2, np.pi, -np.pi / 2]) + \
            rng.uniform(-0.2, 0.2)
        v = _rotate_z(v, ang, np.array([x + 0.5, y + 0.5]))
        # clamp rotated geometry inside the room
        v[:, 0] = np.clip(v[:, 0], 0.05, W - 0.05)
        v[:, 1] = np.clip(v[:, 1], 0.05, D - 0.05)
        parts.append((v.astype(np.float32), f))
        occupied.append((x, y))
    verts, faces = _merge(parts)
    return verts, faces, rects, H


def make_trajectory(rng, rects, H, n_frames):
    """Camera poses inside the free rects: two orbits at different
    heights/radii + random look-around frames. Pose = cam2world with
    columns (right, down, forward), z-up world (matches the fuser's
    Matterport convention, datagen/fusion.py)."""
    poses = []
    rx0, ry0, rx1, ry1 = rects[0]
    cx, cy = (rx0 + rx1) / 2, (ry0 + ry1) / 2
    up = np.array([0.0, 0.0, 1.0])

    def pose_at(pos, fwd):
        fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
        right = np.cross(fwd, up)
        rn = np.linalg.norm(right)
        if rn < 1e-6:
            right = np.array([1.0, 0.0, 0.0])
        else:
            right = right / rn
        down = np.cross(fwd, right)
        down = down / np.linalg.norm(down)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, pos
        return m

    n_orbit = n_frames * 2 // 3
    for k in range(n_orbit):
        th = 2 * np.pi * k / n_orbit
        z = rng.uniform(1.0, min(1.8, H - 0.4))
        r = rng.uniform(0.0, 0.3)
        pos = np.array([cx + r * np.cos(th), cy + r * np.sin(th), z])
        pitch = rng.uniform(-0.35, 0.15)
        fwd = np.array([np.cos(th), np.sin(th), np.sin(pitch)])
        poses.append(pose_at(pos, fwd))
    for _ in range(n_frames - n_orbit):
        rx0, ry0, rx1, ry1 = rects[rng.randint(len(rects))]
        pos = np.array([
            rng.uniform(rx0 + 0.4, rx1 - 0.4),
            rng.uniform(ry0 + 0.4, ry1 - 0.4),
            rng.uniform(0.9, min(1.9, H - 0.3)),
        ])
        yaw = rng.uniform(0, 2 * np.pi)
        pitch = rng.uniform(-0.5, 0.2)
        fwd = np.array([np.cos(yaw) * np.cos(pitch),
                        np.sin(yaw) * np.cos(pitch), np.sin(pitch)])
        poses.append(pose_at(pos, fwd))
    return poses


def write_ply(path, verts, faces):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        rec = np.empty(
            len(faces),
            np.dtype([("n", "u1"), ("idx", "<i4", (3,))]),
        )
        rec["n"] = 3
        rec["idx"] = faces
        f.write(rec.tobytes())


def build_scene(base, name, seed, W, Hpix, n_frames):
    from sgnn_tpu_torch.datagen import render as R
    from sgnn_tpu_torch.datagen import sens as SENS

    rng = np.random.RandomState(seed)
    mesh_dir = os.path.join(base, "meshes", name, "region_segmentations")
    sens_dir = os.path.join(base, "scans", name, "sens")
    os.makedirs(mesh_dir, exist_ok=True)
    os.makedirs(sens_dir, exist_ok=True)
    verts, faces, rects, H = build_room(rng)
    write_ply(os.path.join(mesh_dir, "region0.reduced.ply"), verts, faces)

    intr = np.eye(4, dtype=np.float32)
    # Matterport-like fov (~90 deg horizontal at 320 wide)
    intr[0, 0] = intr[1, 1] = W * 0.5
    intr[0, 2], intr[1, 2] = (W - 1) / 2.0, (Hpix - 1) / 2.0
    poses = make_trajectory(rng, rects, H, n_frames)
    depths = []
    for pose in poses:
        d = R.render_depth(verts, faces, pose, intr, W, Hpix,
                           near=0.3, far=8.0)
        raw = np.where(np.isfinite(d), d * 1000.0, 0.0).astype(np.uint16)
        depths.append(raw)
    SENS.write_sens(os.path.join(sens_dir, f"{name}_0.sens"), name, intr,
                    depths, poses)
    return len(verts), len(faces)


def main(argv=None) -> list:
    """Runs the CLI; returns the scene names."""
    ap = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.make_synthetic_scenes",
        description="Write synthetic rooms in Matterport layout.")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_scenes", type=int, default=200)
    ap.add_argument("--start", type=int, default=0,
                    help="first scene index (resume support)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--val_frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=1000)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    names = []
    t0 = time.time()
    for i in range(args.start, args.num_scenes):
        name = f"SYN{i:04d}"
        names.append(name)
        sens = os.path.join(args.out, "scans", name, "sens",
                            f"{name}_0.sens")
        if os.path.isfile(sens):
            continue
        nv, nf = build_scene(args.out, name, args.seed + i, args.width,
                             args.height, args.frames)
        el = time.time() - t0
        print(f"[{i + 1}/{args.num_scenes}] {name}: {nv} verts {nf} faces "
              f"({el:.1f}s elapsed)", flush=True)
    names = [f"SYN{i:04d}" for i in range(args.num_scenes)]
    rooms = [n + "_room0" for n in names]
    with open(os.path.join(args.out, "scenes.txt"), "w") as f:
        f.writelines(r + "\n" for r in rooms)
    n_val = max(1, int(len(rooms) * args.val_frac))
    with open(os.path.join(args.out, "scenes_train.txt"), "w") as f:
        f.writelines(r + "\n" for r in rooms[:-n_val])
    with open(os.path.join(args.out, "scenes_val.txt"), "w") as f:
        f.writelines(r + "\n" for r in rooms[-n_val:])
    print(f"done: {len(rooms)} scenes ({len(rooms) - n_val} train / "
          f"{n_val} val) in {time.time() - t0:.1f}s")
    return names


if __name__ == "__main__":
    main()
