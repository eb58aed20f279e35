"""The port's measuring tools (sgnn_tpu_torch/utils/profiling.py and
sgnn_tpu_torch/tools: trace_forward, trace_train, roofline,
summarize_train, bench_stages, bench_kernel, bench_backends, bench_mesh,
bench_e2e, bench_train) on the CPU at tiny sizes.

``summarize_train`` prints the JAX tool's bytes; every tool's ``main``
runs with ``--cpu`` (the plain versions; device numbers "not measured")
and, without it on a host with no CUDA device, exits non-zero with a
message; the roofline's kernel families are called as often as the JAX
tool's, and its bytes and operations are a hand count's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.ops import folded as FO
from sgnn_tpu_torch.tools import (bench_backends, bench_e2e, bench_kernel,
                                  bench_mesh, bench_stages, bench_train,
                                  roofline, summarize_train, trace_forward,
                                  trace_train)
from sgnn_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--dims", "32", "32", "32"]
CPU = {"platform": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def one_thread_among_workers():
    """One intra-op thread while several pytest-xdist workers share the
    host's cores (the test tier runs six on eight): PyTorch's thread pools
    thrash there over this module's small tensors, which ran ~100x slower
    (~40 s with one thread); alone, the default threads."""
    n = torch.get_num_threads()
    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ summarize_train


def _write_logs(d, val: bool, L: int = 4):
    """log.csv (and log_val.csv) in the port Trainer's schema
    (train/loop.py's headers), with the -1 sentinels of inactive levels."""
    rng = np.random.RandomState(0)
    head = ["epoch", "iter", "train_loss(total)"]
    head += [f"train_loss({h})" for h in range(L)]
    head += ["train_loss(sdf)", "train_l1-pred", "train_l1-tgt"]
    head += [f"train_iou({h})" for h in range(L)] + ["time"]
    rows = []
    for it in range(20, 240, 20):
        vals = list(rng.rand(len(head) - 2))
        if it < 100:  # levels not yet active
            vals[3:6] = [-1.0] * 3
        rows.append([it // 40, it] + vals)
    with open(os.path.join(d, "log.csv"), "w") as f:
        f.write(",".join(head) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    if val:
        vh = ["epoch", "iter", "val_loss(total)"]
        vh += [f"val_iou({h})" for h in range(L)]
        vh += ["val_l1-pred", "val_l1-tgt"]
        with open(os.path.join(d, "log_val.csv"), "w") as f:
            f.write(",".join(vh) + "\n")
            for e in range(6):
                v = [e, 40 * (e + 1), rng.rand()] + list(rng.rand(L)) + [
                    -1.0 if e < 2 else rng.rand(), rng.rand()]
                f.write(",".join(str(x) for x in v) + "\n")


@pytest.mark.parametrize("val,every", [(True, "5"), (False, "1"),
                                       (True, "2"), (None, "5")],
                         ids=["val", "train-only", "every2", "empty"])
def test_summarize_train_bytes(tmp_path, val, every):
    """The port's tool prints the JAX tool's bytes (both run as programs;
    the JAX tool imports no jax), on logs with and without log_val.csv,
    and fails the same way on a directory without logs."""
    if val is not None:
        _write_logs(tmp_path, val)
    runs = [subprocess.run(cmd + [str(tmp_path), "--every", every],
                           cwd=ROOT, capture_output=True, timeout=120)
            for cmd in ([sys.executable, "tools/summarize_train.py"],
                        [sys.executable, "-m",
                         "sgnn_tpu_torch.tools.summarize_train"])]
    ref, got = runs
    assert (got.returncode, got.stdout) == (ref.returncode, ref.stdout)
    if val is None:
        assert ref.returncode != 0 and got.stderr == ref.stderr
    else:
        assert ref.returncode == 0 and ref.stdout.count(b"\n") > 3


# ---------------------------------------------------------- profiling


def test_memory_stats_and_trace(tmp_path):
    """No CUDA device here: no memory stats, as JAX gives on the CPU; a
    trace writes a Chrome trace json reads, whose CPU events the reader
    finds and whose device numbers are not measured."""
    assert P.device_memory_stats() == {}
    with P.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert P.attribution(prof)["device_ms"] == P.NOT_MEASURED
    assert P.idle_share(prof) == P.NOT_MEASURED
    assert P.idle_gaps(prof) == []
    assert P.device_entry("cpu") == CPU


def test_categories():
    """Device rows by category: the hand-written kernels by their CUDA
    names, the libraries' and PyTorch's by theirs."""
    cat = P.category
    assert cat("void sgnn::conv_site_kernel<__nv_bfloat16, 16>(...)") == \
        "K1"
    assert cat("void sgnn::head_gate_kernel<float, 8>(...)") == \
        "K4 gate and raw"
    assert cat("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32") == \
        "cuDNN convs"
    assert cat("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n") == "GEMMs"
    assert cat("Memcpy HtoD (Pinned -> Device)") == "copies and memsets"
    assert cat("void at::native::vectorized_elementwise_kernel<4, ...>") == \
        "elementwise and reduce"


def test_attribution_and_idle_share(capsys):
    """Device time per run by kernel and category, and the idle share: the
    union of the device's intervals over the window. A profiler range's
    GPU-side span (ProfilerStep#, a record_function range) is not device
    work."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(key, t0, t1, annot=False, dev=DeviceType.CUDA):
        return NS(key=key, device_type=dev, is_user_annotation=annot,
                  time_range=NS(start=t0, end=t1),
                  self_device_time_total=t1 - t0, count=1)
    k1 = "void sgnn::conv_site_kernel<float, 16>(...)"
    events = [ev(k1, 0, 2), ev(k1, 1, 3), ev("Memset (Device)", 5, 6),
              ev("ProfilerStep#2", 0, 10), ev("roofline::conv-site", 0, 9,
                                              annot=True),
              ev("sgnn::refine", 4, 7, annot=True),
              ev("aten::mm", 0, 10, dev=DeviceType.CPU)]
    rows = {}
    for e in events:  # key_averages: one row per key
        r = rows.setdefault(e.key, NS(**{**vars(e), "count": 0,
                                         "self_device_time_total": 0}))
        r.count += 1
        r.self_device_time_total += e.self_device_time_total
    prof = NS(events=lambda: events, key_averages=lambda: list(rows.values()))
    att = P.attribution(prof, reps=2)
    assert att["device_ms"] == pytest.approx(5e-3 / 2)
    assert att["categories"] == {
        "K1": {"ms": pytest.approx(4e-3 / 2), "launches": 1.0},
        "copies and memsets": {"ms": pytest.approx(1e-3 / 2),
                               "launches": 0.5}}
    # busy 0-3 and 5-6 us of the traced stretch's own 10 us window
    prof.profiled_window_s = 10e-6
    assert P.idle_share(prof) == pytest.approx(0.6)
    # a range's device work: the kernels and copies inside its GPU span
    assert P.range_device_ms(prof, "roofline::") == {
        "conv-site": pytest.approx(4e-3)}
    # the report: the idle share over the traced stretch's window, each
    # span's device work per run, every line led by the tag
    prof.profiled_window_s = 40e-6
    rep = P.report(prof, 2, 5, "two runs", tag="t")
    assert rep["idle_share"] == pytest.approx(0.9)
    assert rep["idle_gaps"] == [("host", pytest.approx(2e-3))]
    assert rep["span_device_ms"] == {"refine": pytest.approx(1e-3 / 2)}
    assert rep["profiled_window_ms"] == pytest.approx(20e-3)
    out = capsys.readouterr().out.splitlines()
    assert out and all(line.startswith("[t] ") for line in out)


def test_pad_and_lost_launches():
    """The traced cycle's pad kernels are no device work; a profile lacks
    the wrappers' launches that it did not record, per kernel label."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from sgnn_tpu_torch.ops import kernels as K

    def row(key, n):
        return NS(key=key, device_type=DeviceType.CUDA, count=n,
                  is_user_annotation=False, self_device_time_total=n)
    rows = [row("void sgnn::conv_site_kernel<float, 16>(...)", 2),
            row("void sgnn::conv_site_kernel<float, 8>(...)", 1),
            row("void at::cuda::(anonymous namespace)::spin_kernel(long)",
                8),
            row("void sgnn::scatter_kernel<float, 8>(...)", 1)]
    prof = NS(key_averages=lambda: rows)
    assert P.attribution(prof)["device_ms"] == pytest.approx(4e-3)
    launched = K.launches_by_label({"conv_site": 4, "head_gate": 1,
                                    "head_gate_raw": 2, "scatter": 1,
                                    "downconv": 0})
    assert launched == {"K1": 4, "K4 gate and raw": 3, "K6": 1}
    assert P._lost(prof, launched) == {"K1": 1, "K4 gate and raw": 3}


# ------------------------------------------------------- the tools, --cpu


@pytest.fixture(scope="module")
def roofline_cpu():
    return roofline.main(["--cpu", *TINY])


def test_roofline_families(roofline_cpu):
    """The kernel families' calls per forward are the JAX tool's: ``env
    JAX_PLATFORMS=cpu python tools/roofline.py --dims 32 32 32`` prints
    conv-site 37, downconv 11, upconv 3, head-site 3, surf-head-ms 1 and
    input-scatter 1 (38 s, too slow to run here)."""
    fams = roofline_cpu["families"]
    assert {k: fams[k]["calls"] for k in (
        "conv-site", "downconv", "upconv", "head-site", "surf-head-ms",
        "input-scatter")} == {"conv-site": 37, "downconv": 11, "upconv": 3,
                              "head-site": 3, "surf-head-ms": 1,
                              "input-scatter": 1}
    assert roofline_cpu["device"] == CPU
    assert roofline_cpu["floor_ms"] == pytest.approx(
        sum(f["floor_ms"] for f in fams.values()))
    assert all(f["floor_ms"] > 0 for k, f in fams.items()
               if k != "unfold")


def _one_voxel(cpad, dims=(8, 8, 16)):
    m = torch.zeros(1, *dims, dtype=torch.bool)
    m[0, 4, 4, 8] = True
    return FO.fold_mask(m, cpad, torch.bfloat16)


def test_roofline_hand_count():
    """One conv-site and one downconv call priced from their shapes and
    active voxels. A bf16 voxel at cpad 16 is one 32-byte sector: with an
    affine the conv reads each group at the one active voxel, without it
    at the 27 within reach; the downconv without an affine reads the 8
    voxels of the active one's 2^3 block; masks, weights and outputs in
    full; 2 Cin Cout operations per tap and output voxel."""
    fm = _one_voxel(16)
    x = FO.fold(torch.randn(1, 8, 8, 16, 16), 16)
    g = [x.with_data(x.data.bfloat16()),
         FO.FGrid(x.data.bfloat16(), x.dims, 2, 16)]
    w = torch.zeros(2, 27, 16, 16)
    aff = torch.zeros(2, 2, 16)
    grid = fm.data.numel() * 2  # a [1, 10, 10, 8, 128] bf16 grid
    for a, reads in ((aff, 1), (None, 27)):
        with roofline.Recorder() as rec:
            out = FO.subm_conv_fused(g, fm, w, 16, aff=a)
        (c,) = rec.calls
        assert c.family == "conv-site"
        assert c.nbytes == 2 * reads * 32 + grid + w.numel() * 4 + (
            0 if a is None else aff.numel() * 4) + out.data.numel() * 2
        assert c.ops == 2 * 27 * (16 + 2) * 16 * 1
    wd = torch.zeros(8, 16, 16)
    with roofline.Recorder() as rec:
        o, om = FO.downconv_fused(g[0], fm, wd, 8)
    (c,) = rec.calls
    assert c.family == "downconv" and int(om.data.sum()) == 16
    assert c.nbytes == (8 * 32 + grid + wd.numel() * 4
                        + (o.data.numel() + om.data.numel()) * 2)
    assert c.ops == 2 * 8 * 16 * 8 * 1
    assert c.floor_ms == c.nbytes / roofline.PEAK_BYTES * 1e3


@pytest.mark.parametrize("tool,argv,keys", [
    (trace_forward, [*TINY, "--reps", "1"],
     ("kernels", "categories", "idle_share", "launches", "trace")),
    (trace_train, [*TINY, "--batch_size", "1", "--reps", "1",
                   "--compute_dtype", "float32", "--execution", "sparse"],
     ("kernels", "categories", "idle_share", "launches", "loss")),
    (bench_kernel, ["16", "16", "16", "16", "bf16"],
     ("max_abs_err", "scale", "kernel_ms", "library_ms", "speedup")),
    (bench_backends, [*TINY, "--backends", "gather", "dense", "dense_flow",
                      "--reps", "1"], ("backends",)),
    (bench_e2e, [*TINY, "--scenes", "1"],
     ("e2e_scenes_per_sec", "mean_scene_ms", "scenes", "pred_mesh_files",
      "compile_plus_first_s", "mode")),
    (bench_e2e, [*TINY, "--scenes", "1", "--serial"],
     ("e2e_scenes_per_sec", "pred_mesh_files", "mode")),
    (bench_train, [*TINY, "--batch_size", "1", "--num_chunks", "3",
                   "--steps", "4", "--warmup", "0", "--compute_dtype",
                   "float32", "--execution", "sparse"],
     ("step_ms", "chunks_per_sec", "mean_step_ms", "p90_step_ms", "steps",
      "loss", "times_ms")),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "main")
    else "serial" if v == [*TINY, "--scenes", "1", "--serial"] else None)
def test_tool_cpu(tmp_path, tool, argv, keys):
    if "--reps" in argv and tool in (trace_forward, trace_train):
        argv = [*argv, "--out", str(tmp_path)]
    res = tool.main(["--cpu", *argv])
    assert res["device"] == CPU
    for k in keys:
        assert k in res, k
    if tool is bench_e2e:
        assert res["pred_mesh_files"] == 1
        assert res["mode"].startswith("serial" if "--serial" in argv
                                      else "pipelined")
    if tool is bench_train:
        # 4 steps of batch 1 on 3 chunks: the 4th after the loader's
        # restart, which its time holds; the rate is all chunks over all
        # the timed seconds, the step time their median
        assert res["steps"] == 4
        assert res["chunks_per_sec"] == pytest.approx(
            4 / (sum(res["times_ms"]) / 1e3))
        assert res["step_ms"] == pytest.approx(np.median(res["times_ms"]))
    # a CPU run fills no device metric
    for k in ("idle_share", "kernel_ms", "library_ms", "speedup"):
        if k in res:
            assert res[k] == P.NOT_MEASURED


def test_bench_stages_cpu():
    res = bench_stages.main(["--cpu", *TINY, "--reps", "1"])
    assert res["device"] == CPU
    # the JAX tool's stage names, in its order (tools/bench_stages.py:71-74)
    assert [r["stage"] for r in res["stages"]] == [
        "encoder+trunk", "+refine0", "+refine1", "+refine2", "+surface"]
    assert all(r[k] == P.NOT_MEASURED for r in res["stages"]
               for k in ("cum_ms", "delta_ms", "wall_ms", "idle_share"))


def test_bench_mesh():
    """Host-only: no card and no --cpu."""
    res = bench_mesh.main(["--scenes", "2", "--workers", "1", "2", *TINY])
    assert res["device"] == CPU
    assert [r["ply_files"] for r in res["runs"]] == [4, 4]
    assert {"mesh_workers", "host_cpus", "scenes", "ply_files",
            "ms_per_scene", "scenes_per_sec"} <= set(res["runs"][0])


def test_bench_train_composed_bn():
    """--no_fuse_train_bn times the folded composed BN -> op ablation."""
    res = bench_train.main(["--no_fuse_train_bn", "--cpu", *TINY,
                            "--batch_size", "1", "--num_chunks", "2",
                            "--steps", "2", "--warmup", "0",
                            "--compute_dtype", "float32"])
    assert res["execution"] == "folded" and res["fuse_train_bn"] is False
    assert res["steps"] == 2 and np.isfinite(res["loss"])


@pytest.mark.parametrize("tool", [trace_forward, trace_train, roofline,
                                  bench_stages, bench_kernel, bench_backends,
                                  bench_e2e, bench_train],
                         ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tool_needs_a_card(tool):
    """Without --cpu and with no CUDA device a tool exits non-zero with a
    message: no fallback to the host or to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run there")
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert "no CUDA device" in str(e.value.code)


# ------------------------------------------- the JAX tools' other options


def _count_calls(monkeypatch, mod, names) -> dict:
    """Counts the calls of ``mod``'s functions ``names`` from now on."""
    calls = dict.fromkeys(names, 0)
    for n in names:
        def counted(*a, _n=n, _f=getattr(mod, n), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, n, counted)
    return calls


def test_bench_e2e_int8_runs_the_int8_sites(monkeypatch):
    """--int8 serves the folded forward's int8 sites, K1q, K2q and K3q,
    and no exact conv, down or upsample site (on the CPU their plain
    versions take the scales themselves, without tile_amax's wrapper)."""
    from sgnn_tpu_torch.ops.kernels import conv_site, downconv, upconv

    counters = [_count_calls(monkeypatch, mod, names) for mod, names in (
        (conv_site, ("conv_site", "conv_site_q")),
        (downconv, ("downconv", "downconv_q")),
        (upconv, ("upconv", "upconv_q")))]
    res = bench_e2e.main(["--cpu", *TINY, "--scenes", "1", "--int8"])
    calls = {k: v for c in counters for k, v in c.items()}
    assert res["int8"] is True and res["pred_mesh_files"] == 1
    # the seed search's forwards, the warm-up and the scene, 37 / 11 / 3
    # sites each
    n = res["seed"] + 3
    assert calls == {"conv_site": 0, "conv_site_q": 37 * n, "downconv": 0,
                     "downconv_q": 11 * n, "upconv": 0, "upconv_q": 3 * n}


def test_bench_e2e_sparse_serves_the_coordinate_lists(monkeypatch):
    """--execution sparse serves GenModelSparse alone; --compute_dtype
    sets the served model's type."""
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.models.sgnn import GenModelSparse

    calls, dtypes = {}, set()
    for cls in (GenModelFolded, GenModelSparse):
        calls[cls.__name__] = 0

        def counted(self, *a, _f=cls.forward, _n=cls.__name__, **k):
            calls[_n] += 1
            dtypes.add(self.cfg.compute_dtype)
            return _f(self, *a, **k)
        monkeypatch.setattr(cls, "forward", counted)
    res = bench_e2e.main(["--cpu", *TINY, "--scenes", "1", "--execution",
                          "sparse", "--compute_dtype", "float32"])
    assert res["execution"] == "sparse" and res["pred_mesh_files"] == 1
    assert calls == {"GenModelFolded": 0,
                     "GenModelSparse": res["seed"] + 3}
    assert dtypes == {"float32"} and res["compute_dtype"] == "float32"


def test_bench_e2e_dense_fetch_keeps_output(tmp_path):
    """--no_compact labels the run +dense_fetch as the JAX tool does;
    --keep_output leaves the PLYs in the given directory."""
    out = tmp_path / "keep"
    res = bench_e2e.main(["--cpu", *TINY, "--scenes", "1", "--no_compact",
                          "--keep_output", str(out)])
    assert res["mode"] == "pipelined+dense_fetch"
    assert sorted(os.listdir(out)) == ["synth000__cmpinput-mesh.ply",
                                       "synth000__cmppred-mesh.ply"]


def test_dense_fetch_extracts_what_the_device_does():
    """SceneInferencer(compact=False), the JAX inferencer's dense fetch:
    the same surface and levels as the extraction on the device, from the
    level-output form whatever want_levels says."""
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.infer import SceneInferencer, synthetic_scene
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.params import init_params, load_jax_params

    cfg = SGNNConfig(encoder_dim=4, input_dim=(32, 32, 32), nf_coarse=8,
                     nf=8, num_hierarchy_levels=3, batch_size=1,
                     compute_dtype="float32")
    model = GenModelFolded(cfg)
    load_jax_params(model, *init_params(cfg, seed=1))
    scene = synthetic_scene((32, 32, 32), seed=0, orig_dims=(30, 31, 29))
    dev = SceneInferencer(model, want_levels=True)(scene)
    host = SceneInferencer(model, want_levels=False, compact=False)(scene)
    assert len(dev["surf_locs"]) > 0
    for k in ("surf_locs", "surf_sdf", "input_locs", "input_sdf"):
        np.testing.assert_array_equal(host[k], dev[k], err_msg=k)
    assert host["level_active"] == dev["level_active"]
    assert len(host["levels"]) == len(dev["levels"]) == 3
    for a, b in zip(host["levels"], dev["levels"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _bench_train(argv: list) -> dict:
    return bench_train.main(["--cpu", *TINY, "--batch_size", "1",
                             "--num_chunks", "3", "--compute_dtype",
                             "float32", *argv])


def test_bench_train_window_and_log_every(monkeypatch):
    """--window 2: a fetch every 2 steps, windows from the first fetch on
    (the JAX tool's window keys); --log_every 2: the metrics step every
    second iteration."""
    from sgnn_tpu_torch.train.loop import Trainer

    seen = []
    run_step = Trainer.run_step

    def spy(self, batch, with_metrics=False, dev_batch=None):
        seen.append(with_metrics)
        return run_step(self, batch, with_metrics, dev_batch)
    monkeypatch.setattr(Trainer, "run_step", spy)
    res = _bench_train(["--steps", "5", "--warmup", "1", "--window", "2",
                        "--log_every", "2"])
    # fetches after steps 2, 4 and 6: the windows (2, 4] and (4, 6]
    assert res["window"] == 2 and res["steps"] == 2
    assert len(res["times_ms"]) == 2 and res["log_every"] == 2
    assert res["step_ms"] == pytest.approx(np.median(res["times_ms"]))
    assert seen == [True, False] * 3  # iterations 40 to 45


def test_bench_train_dense_transfer(monkeypatch):
    """--dense_transfer collates the dense target grids (the dataset's
    sparse_targets off); --transfer_dtype ships the batch's floats in
    that type."""
    from sgnn_tpu_torch.train import step as TS

    dtypes = []
    to_device = TS.to_device

    def spy(batch, device, transfer_dtype=torch.float32, *a, **k):
        dtypes.append(transfer_dtype)
        assert ("sdf" in batch) and ("target_locs" not in batch)
        return to_device(batch, device, transfer_dtype, *a, **k)
    monkeypatch.setattr(TS, "to_device", spy)
    res = _bench_train(["--steps", "2", "--warmup", "0", "--dense_transfer",
                        "--transfer_dtype", "bfloat16"])
    assert res["targets"] == "dense grids"
    assert res["transfer_dtype"] == "bfloat16" and res["steps"] == 2
    assert dtypes and set(dtypes) == {torch.bfloat16}
    assert np.isfinite(res["loss"])
