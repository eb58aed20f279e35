"""The port's data generation against the JAX package's, bit for bit:
.sens files, parameter files, the bilateral filter, depth rendering
(native and numpy), TSDF fusion (native and numpy) and its .sdf/.knw
files, chunking, lighting and segmentation, the synthetic scene
generator and the datagen CLIs. Both packages build their native cores
from the same sources with the same flags. Then the port's whole drive
on the CPU at a tiny config: synthetic rooms -> fused scans -> chunks ->
2 training steps -> .ckpt -> .pth -> .ckpt -> evaluation, each stage's
outputs asserted as the JAX package's verify drive asserts them."""

import dataclasses
import json
import os

import numpy as np
import pytest

from sgnn_tpu.data import formats as JF
from sgnn_tpu.datagen import camera as JCAM
from sgnn_tpu.datagen import chunking as JCH
from sgnn_tpu.datagen import fusion as JFU
from sgnn_tpu.datagen import lighting as JLT
from sgnn_tpu.datagen import params as JPR
from sgnn_tpu.datagen import render as JR
from sgnn_tpu.datagen import segmentation as JSEG
from sgnn_tpu.datagen import sens as JSENS
from sgnn_tpu_torch.data import formats as F
from sgnn_tpu_torch.datagen import camera as CAM
from sgnn_tpu_torch.datagen import chunking as CH
from sgnn_tpu_torch.datagen import fusion as FU
from sgnn_tpu_torch.datagen import lighting as LT
from sgnn_tpu_torch.datagen import params as PR
from sgnn_tpu_torch.datagen import render as R
from sgnn_tpu_torch.datagen import segmentation as SEG
from sgnn_tpu_torch.datagen import sens as SENS
from sgnn_tpu_torch.datagen.scene import Scene, load_matterport_list
from sgnn_tpu_torch.tools import convert_checkpoint, evaluate, \
    generate_scans, make_chunks, make_synthetic_scenes
from sgnn_tpu_torch.tools import train as train_cli
from sgnn_tpu_torch.utils import native_build
from tools import make_synthetic_scenes as JSYN

W, H = 64, 48


def _intrinsic(fx, fy, cx, cy):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[0, 2], m[1, 2] = fx, fy, cx, cy
    return m


def _orbit_poses(n, center=(1.1, 0.9, 0.7)):
    poses = []
    for k in range(n):
        th = 2 * np.pi * k / n
        pose = np.eye(4, dtype=np.float32)
        fwd = np.array([np.cos(th), np.sin(th), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        pose[:3, 0], pose[:3, 1], pose[:3, 2] = np.cross(fwd, up), -up, fwd
        pose[:3, 3] = center
        poses.append(pose)
    return poses


def _depth_frames(n, seed=7):
    """Noisy depth frames with invalid (-inf), below-range and beyond-range
    pixels."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        d = r.uniform(0.2, 4.6, (H, W)).astype(np.float32)
        d[r.rand(H, W) < 0.1] = -np.inf
        d[r.rand(H, W) < 0.05] = 0.0
        out.append(d)
    return out


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_files(pa, pb)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa


def test_sens_roundtrip_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    intr = _intrinsic(30.0, 30.0, 15.5, 11.5)
    frames = [(rng.rand(24, 32) * 3000).astype(np.uint16) for _ in range(3)]
    poses = _orbit_poses(3)
    poses[2] = np.full((4, 4), np.nan, np.float32)  # an invalid pose
    a, b = str(tmp_path / "a.sens"), str(tmp_path / "b.sens")
    SENS.write_sens(a, "cam", intr, frames, poses, depth_shift=1000.0)
    JSENS.write_sens(b, "cam", intr, frames, poses, depth_shift=1000.0)
    assert open(a, "rb").read() == open(b, "rb").read()
    sf, jf = SENS.SensFile(a), JSENS.SensFile(a)
    try:
        for k in ("num_frames", "depth_width", "depth_height",
                  "depth_shift", "name"):
            assert getattr(sf, k) == getattr(jf, k)
        np.testing.assert_array_equal(sf.poses, jf.poses)
        np.testing.assert_array_equal(sf.depth_raw(1), frames[1])
        for size in ((32, 24), (20, 15)):
            got = sf.depth_frame(0, *size, min_depth=0.1, max_depth=2.0)
            ref = jf.depth_frame(0, *size, min_depth=0.1, max_depth=2.0)
            for x, y in zip(got, ref):
                np.testing.assert_array_equal(x, y)
        assert sf.depth_frame(2, 32, 24) is None
    finally:
        sf.close()
        jf.close()


def test_param_file_matches_jax(tmp_path):
    p = tmp_path / "params.txt"
    p.write_text(
        '// comment line\ns_sceneFileList = "a/b.txt";\n'
        's_maxNumScenes = 12; // trailing\ns_voxelSize = 0.02f;\n'
        's_renderWidth = 320\ns_filterDepthMap = false;\n'
        's_bUseRenderedDepth = true;\ns_chanceDropFrames = .5;\n'
        's_other = word;\nnot a pair\n = 3;\n')
    assert PR.parse_param_file(str(p)) == JPR.parse_param_file(str(p))
    args = generate_scans.parse_args([
        "--scan_path", "s", "--scan_mesh_path", "m", "--output_incomplete",
        "o", "--param_file", str(p)])
    ref = JPR.apply_param_file(generate_scans.parse_args([
        "--scan_path", "s", "--scan_mesh_path", "m", "--scene_file_list",
        "x", "--output_incomplete", "o"]), str(p))
    assert dict(vars(args), param_file="") == vars(ref)
    assert args.scene_file_list == "a/b.txt" and args.no_filter_depth
    assert args.max_num_scenes == 12 and args.use_rendered_depth


def _box_mesh():
    """A box room with a box inside it (the verify drive's world)."""
    verts, faces = JSYN._merge([JSYN._box((0, 0, -0.04), (4, 3.5, 0)),
                                JSYN._box((0, -0.04, 0), (4, 0, 2.5)),
                                JSYN._box((-0.04, 0, 0), (0, 3.5, 2.5)),
                                JSYN._box((4, 0, 0), (4.04, 3.5, 2.5)),
                                JSYN._box((0, 3.5, 0), (4, 3.54, 2.5)),
                                JSYN._box((1, 1, 0), (1.8, 1.6, 0.9))])
    return verts, faces


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_render_matches_jax(impl, monkeypatch):
    verts, faces = _box_mesh()
    intr = _intrinsic(40.0, 40.0, (W - 1) / 2, (H - 1) / 2)
    if impl == "numpy":
        monkeypatch.setenv("SGNN_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("SGNN_TPU_NO_NATIVE", raising=False)
        assert JR._get_lib() is not None
    for pose in _orbit_poses(3, center=(2.0, 1.7, 1.2)):
        d = R.render_depth(verts, faces, pose, intr, W, H, near=0.3,
                           far=8.0, impl=impl)
        assert np.isfinite(d).mean() > 0.5
        np.testing.assert_array_equal(
            d, JR.render_depth(verts, faces, pose, intr, W, H, near=0.3,
                               far=8.0))
        got = R.render_faceid(verts, faces, pose, intr, W, H, impl=impl)
        ref = JR.render_faceid(verts, faces, pose, intr, W, H)
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="impl"):
        R.render_depth(verts, faces, pose, intr, W, H, impl="fallback")


def test_render_color_and_phong_match_jax():
    verts, faces = _box_mesh()
    intr = _intrinsic(40.0, 40.0, (W - 1) / 2, (H - 1) / 2)
    pose = _orbit_poses(1, center=(2.0, 1.7, 1.2))[0]
    colors = np.random.RandomState(1).rand(len(verts), 3).astype(np.float32)
    for got, ref in (
            (R.render_color(verts, faces, colors, pose, intr, W, H),
             JR.render_color(verts, faces, colors, pose, intr, W, H)),
            (R.render_phong(verts, faces, pose, intr, W, H,
                            LT.Lighting.random(2, np.random.RandomState(3)),
                            LT.SimpleMaterial.default(), colors),
             JR.render_phong(verts, faces, pose, intr, W, H,
                             JLT.Lighting.random(2, np.random.RandomState(3)),
                             JLT.SimpleMaterial.default(), colors))):
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)


def test_bilateral_and_edges_match_jax():
    d = _depth_frames(1)[0]
    np.testing.assert_array_equal(CAM.bilateral_filter(d, 2.0, 0.1),
                                  JCAM.bilateral_filter(d, 2.0, 0.1))
    with np.errstate(invalid="ignore"):  # -inf - -inf at invalid pixels
        np.testing.assert_array_equal(CAM.compute_edge_mask(d, 0.1, 0.3, 2),
                                      JCAM.compute_edge_mask(d, 0.1, 0.3, 2))


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_fusion_matches_jax(tmp_path, impl, monkeypatch):
    """A few frames fused into a grid with a room OBB, the incomplete
    subset first (fuse_scene): the .sdf/.knw files and the grids equal
    the JAX package's, byte for byte."""
    if impl == "numpy":
        monkeypatch.setenv("SGNN_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("SGNN_TPU_NO_NATIVE", raising=False)
        assert JFU._get_fuse_lib() is not None
    intr = _intrinsic(40.0, 40.0, (W - 1) / 2, (H - 1) / 2)
    frames = list(zip(_depth_frames(5), [intr] * 5, _orbit_poses(5)))
    obb_pts = np.random.RandomState(2).rand(50, 3) * [2.4, 2.0, 1.6]
    grids = []
    for pkg, fu, out in ((FU, FU, "port"), (JFU, JFU, "jax")):
        obb = fu.OBB.from_points_zup(obb_pts)
        grid = fu.make_grid_for_scene([0, 0, 0], [2.4, 2.0, 1.6], 0.05, obb)
        os.makedirs(tmp_path / out)
        paths = [str(tmp_path / out / n)
                 for n in ("i.sdf", "i.knw", "c.sdf", "c.knw")]
        kw = {"impl": impl} if pkg is FU else {}
        with np.errstate(invalid="ignore"):
            fu.fuse_scene(grid, frames, [0, 2], [0, 1, 2, 3, 4],
                          out_incomplete=paths[:2], out_complete=paths[2:],
                          **kw)
        grids.append(grid)
    port, ref = grids
    assert np.isfinite(ref.sdf).sum() > 1000  # a non-trivial case
    for k in ("sdf", "weight", "free_ctr"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert FU.verify_roundtrip(port, str(tmp_path / "port" / "c.sdf"))


def test_fusion_color_needs_numpy():
    intr = _intrinsic(40.0, 40.0, (W - 1) / 2, (H - 1) / 2)
    grid = FU.VoxelGrid((20, 20, 20), np.eye(4), 0.05)
    color = np.zeros((H, W, 3), np.uint8)
    with pytest.raises(ValueError, match="impl='numpy'"):
        grid.integrate(intr, np.eye(4), _depth_frames(1)[0], color)
    ref = JFU.VoxelGrid((20, 20, 20), np.eye(4), 0.05)
    d = np.full((H, W), 0.6, np.float32)
    with np.errstate(invalid="ignore"):  # voxels in the camera's plane
        grid.integrate(intr, np.eye(4), d, color + 200, impl="numpy")
        ref.integrate(intr, np.eye(4), d, color + 200)
    np.testing.assert_array_equal(grid.color, ref.color)


@pytest.mark.parametrize("lib", ["fuse", "rasterize"])
def test_native_build_failure_raises(tmp_path, monkeypatch, lib):
    mod = FU if lib == "fuse" else R
    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(mod, "CXX_FLAGS", ("-fno-such-flag",))
    if lib == "fuse":
        monkeypatch.setattr(FU, "_FUSE_LIB", None)
        load = FU.get_fuse_lib
    else:
        monkeypatch.setattr(R, "_LIB", None)
        load = R.get_raster_lib
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load()


def test_lighting_and_segmentation_match_jax(tmp_path):
    for seed in range(3):
        a = LT.SimpleMaterial.random_ward(np.random.RandomState(seed))
        b = JLT.SimpleMaterial.random_ward(np.random.RandomState(seed))
        for k in ("ambient", "diffuse", "specular"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.shiny == b.shiny
    rng = np.random.RandomState(0)
    n = rng.randn(30, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = n[::-1].copy()
    np.testing.assert_array_equal(
        LT.phong_shade(n, v, LT.Lighting.random(3, np.random.RandomState(1)),
                       LT.SimpleMaterial.default()),
        JLT.phong_shade(n, v, JLT.Lighting.random(3,
                                                  np.random.RandomState(1)),
                        JLT.SimpleMaterial.default()))
    (tmp_path / "v.json").write_text(json.dumps(
        {"sceneId": "s", "segIndices": [0, 1, 1, 2, 5]}))
    (tmp_path / "s.json").write_text(json.dumps(
        {"sceneId": "s", "segGroups": [{"id": 3, "label": "chair",
                                        "segments": [1, 5]}]}))
    vs = SEG.VertexSegmentation.load(str(tmp_path / "v.json"))
    labels = SEG.SemanticSegmentation.load(
        str(tmp_path / "s.json")).vertex_labels(vs)
    np.testing.assert_array_equal(labels, JSEG.SemanticSegmentation.load(
        str(tmp_path / "s.json")).vertex_labels(
        JSEG.VertexSegmentation.load(str(tmp_path / "v.json"))))


def test_chunk_scene_matches_jax():
    """chunk_scene on one scene pair: the same chunks, field for field."""
    rng = np.random.RandomState(0)
    dims = (40, 36, 44)
    z, y, x = np.meshgrid(*(np.arange(d) for d in dims), indexing="ij")
    d = (np.minimum(z - 3, y - 4) * 0.02).astype(np.float32)
    m = np.abs(d) < 0.06
    locs = np.stack(np.nonzero(m), -1).astype(np.int32)
    keep = rng.rand(len(locs)) < 0.6
    w2g = np.eye(4, dtype=np.float32)
    vols = [F.SceneVolume(locs[s], d[m][s] / 0.02, dims, 0.02, w2g)
            for s in (keep, slice(None))]
    known = np.where(rng.rand(*dims) < 0.3, 255, 0).astype(np.uint8)
    args = ((16, 16, 16), (8, 8, 8), 60, 20)
    got = list(CH.chunk_scene(*vols, known, *args))
    ref = list(JCH.chunk_scene(*[JF.SceneVolume(*dataclasses.astuple(v))
                                 for v in vols], known, *args))
    assert len(got) == len(ref) > 5
    for (oa, a), (ob, b) in zip(got, ref):
        assert oa == ob
        for k in ("input_locs", "input_sdf", "target_sdf", "dims",
                  "voxelsize", "world2grid", "known"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        for ha, hb in zip(a.hierarchy, b.hierarchy):
            np.testing.assert_array_equal(ha, hb)


def test_synthetic_rooms_match_jax(tmp_path):
    """The generator's meshes and trajectories at one seed, and its files
    through the CLI, equal the JAX tool's."""
    for seed in (1000, 1001):
        got = make_synthetic_scenes.build_room(np.random.RandomState(seed))
        ref = JSYN.build_room(np.random.RandomState(seed))
        for x, y in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(x, y)
        assert got[2:] == ref[2:]
        rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(
            make_synthetic_scenes.make_trajectory(rng_a, got[2], got[3], 9),
            JSYN.make_trajectory(rng_b, ref[2], ref[3], 9))
    make_synthetic_scenes.main(["--out", str(tmp_path / "port"),
                                "--num_scenes", "1", "--frames", "4",
                                "--width", "48", "--height", "36"])
    JSYN.build_scene(str(tmp_path / "jax"), "SYN0000", 1000, 48, 36, 4)
    _same_files(tmp_path / "port" / "meshes", tmp_path / "jax" / "meshes")
    _same_files(tmp_path / "port" / "scans", tmp_path / "jax" / "scans")


# ------------------------------------------------------ the whole drive


# the JAX package's test config (tests/test_infer.py:48)
NET = ["--num_hierarchy_levels", "3", "--encoder_dim", "4",
       "--coarse_feat_dim", "8", "--refine_feat_dim", "8"]


def test_port_drive_cpu(tmp_path):
    """World -> scans -> chunks -> 2 training steps -> convert -> evaluate,
    on the CPU with the port alone (in-process CLIs), at 8 cm and 16^3
    chunks so the rooms' forwards stay small."""
    base = str(tmp_path)
    scenes = os.path.join(base, "scenes.txt")
    S, I, C, Lg = (os.path.join(base, d)
                   for d in ("complete", "incomplete", "chunks", "logs"))

    names = make_synthetic_scenes.main([
        "--out", base, "--num_scenes", "2", "--frames", "10",
        "--width", "64", "--height", "48"])
    assert names == ["SYN0000", "SYN0001"]
    info = load_matterport_list(os.path.join(base, "scans"),
                                os.path.join(base, "meshes"), scenes)
    assert [i.scene_name for i in info] == ["SYN0000_room0", "SYN0001_room0"]
    sc = Scene(info[0])
    assert len(sc.poses) == 10 and sc.depth_frame(0, 64, 48) is not None
    sc.close()

    counts = generate_scans.main([
        "--scan_path", os.path.join(base, "scans"),
        "--scan_mesh_path", os.path.join(base, "meshes"),
        "--scene_file_list", scenes, "--output_complete", S,
        "--output_incomplete", I,
        "--incomplete_frame_path", os.path.join(base, "frames"),
        "--voxel_size", "0.08", "--width", "64", "--height", "48"])
    assert counts == {"fused": 2, "skipped": 0, "existing": 0,
                      "no_frames": 0}
    for room in ("SYN0000_room0", "SYN0001_room0"):
        for d in (S, I):
            for ext in (".sdf", ".knw"):
                assert os.path.isfile(os.path.join(d, room + "__0__" + ext))
        tgt = F.load_scene(os.path.join(S, room + "__0__.sdf"))
        inp = F.load_scene(os.path.join(I, room + "__0__.sdf"))
        assert len(tgt.locs) > len(inp.locs) > 100  # complete > incomplete

    lst = os.path.join(base, "train_list.txt")
    res = make_chunks.main([
        "--input_data_path", I, "--target_data_path", S,
        "--scene_file_list", scenes, "--output", C,
        "--chunk_dims", "16", "16", "16", "--stride", "8", "8", "8",
        "--min_target_surface", "60", "--min_input_surface", "20",
        "--list_out", lst])
    assert res["skipped"] == res["missing"] == 0
    assert len(res["written"]) > 4
    assert open(lst).read().split() == res["written"]
    chunk = F.load_train_file(os.path.join(C, res["written"][0]))
    assert chunk.dims == (16, 16, 16) and len(chunk.input_locs) >= 20

    trainer = train_cli.main([
        "--data_path", C, "--train_file_list", lst, "--save", Lg,
        "--input_dim", "16", *NET, "--batch_size", "2", "--max_epoch", "1",
        "--max_steps", "2", "--num_iters_per_level", "1",
        "--compute_dtype", "float32", "--cpu"])
    assert len(trainer.loss_history) == 2
    assert np.isfinite([v for _, v in trainer.loss_history]).all()
    ckpt = os.path.join(Lg, "model-epoch-0.ckpt")
    assert os.path.isfile(ckpt) and os.path.isfile(os.path.join(Lg,
                                                                "log.csv"))

    pth, back = os.path.join(base, "m.pth"), os.path.join(base, "m2.ckpt")
    convert_checkpoint.main(["--input", ckpt, "--output", pth, *NET])
    convert_checkpoint.main(["--input", pth, "--output", back, *NET])
    from sgnn_tpu_torch.checkpoint import load_checkpoint
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.params import tree_items

    cfg = SGNNConfig(encoder_dim=4, nf_coarse=8, nf=8,
                     num_hierarchy_levels=3, input_dim=(16, 16, 16))
    a, b = load_checkpoint(ckpt, cfg), load_checkpoint(back, cfg)
    for tree_a, tree_b in ((a.params, b.params), (a.stats, b.stats)):
        for (k, x), (_, y) in zip(tree_items(tree_a), tree_items(tree_b)):
            np.testing.assert_array_equal(x, y, err_msg=k)

    out = evaluate.main([
        "--input_data_path", I, "--target_data_path", S,
        "--test_file_list", scenes, "--model_path", pth,
        "--output", os.path.join(base, "metrics.json"), *NET,
        "--max_input_height", "0", "--occupancy_fractions", "1.0", "1.0",
        "1.0", "--compute_dtype", "float32", "--cpu"])
    assert out["skipped"] == 0
    m = json.load(open(os.path.join(base, "metrics.json")))
    assert len(m["scenes"]) == 2 and len(m["measured_occupancy_fractions"])
    for rec in m["scenes"]:
        for k in ("l1_pred", "l1_tgt", "iou_surface"):
            assert np.isfinite(rec[k])
            assert rec[k] >= 0 or rec["surf_voxels"] == 0
