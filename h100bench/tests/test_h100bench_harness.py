"""The harness: cells found by name, the traffic generator, the last line,
the refusal without a card, and the imports."""

import ast
import json
import os
import shutil

import pytest
import torch

from h100bench import rooms
from h100bench import run as H

PKG = os.path.dirname(H.__file__)
BENCH = json.load(open(os.path.join(H.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_cell_resolves_by_name(workload):
    cell, config, traffic = H.load_cell(workload["name"])
    assert cell["config"] == workload["config"]
    assert cell["traffic"] == workload["traffic"]
    assert cell["chips"] == workload["chips"]
    assert config["model"] and traffic["kind"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name in cell["end_to_end"]:
        assert workload["name"] in e2e[name].get("workloads",
                                                 [workload["name"]])
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in cell["per_layer"]:
        reader = H.load_reader(name)
        assert reader.UNIT == layer[name]["unit"]
        assert reader.read({}) is None  # nothing to read, nothing read
        assert layer[name]["moves"] in cell["end_to_end"]
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(H.ROOT, c["file"]))


def test_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "h100bench"
    for kind in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(PKG, kind), root / kind)
    cell, config, traffic = H.load_cell(BENCH["workloads"][0]["name"])
    traffic = dict(traffic, footprints=[[64, 64]])
    (root / "traffic" / "one-room.json").write_text(json.dumps(traffic))
    (root / "cells" / "x.one-room.json").write_text(json.dumps(
        dict(cell, traffic="one-room", per_layer=["new_metric.serve"])))
    (root / "metrics" / "new_metric.serve.py").write_text(
        "UNIT = 'ms'\n\ndef read(ctx):\n    return ctx.get('x')\n")
    c2, _, t2 = H.load_cell("x.one-room", root=str(root))
    assert t2["footprints"] == [[64, 64]] and c2["config"] == cell["config"]
    reader = H.load_reader("new_metric.serve", root=str(root))
    assert reader.read({"x": 2.5}) == 2.5 and reader.UNIT == "ms"
    # a quantity's reader serves every <stem>.<cell> without a file
    (root / "metrics" / "other.py").write_text(
        "UNIT = '%'\n\ndef read(ctx):\n    return ctx.get('y')\n")
    reader = H.load_reader("other.x-one-room", root=str(root))
    assert reader.read({"y": 1.5}) == 1.5 and reader.UNIT == "%"


def test_rooms_deterministic_and_in_range():
    _, _, traffic = H.load_cell(BENCH["workloads"][0]["name"])
    seed = 2 ** 31 + 11
    a = rooms.room_pool(traffic, "cpu", 3.0)
    b = rooms.room_pool(traffic, "cpu", 3.0)
    c = rooms.room_pool(dict(traffic, content_seed=5), "cpu", 3.0)
    for ra, rb, rc in zip(a, b, c):
        assert torch.equal(ra["locs"], rb["locs"])
        assert torch.equal(ra["feats"], rb["feats"])
        assert not torch.equal(ra["locs"], rc["locs"])
        n = len(ra["locs"])
        assert 68_000 <= n <= 630_000 and n == len(rc["locs"])
        assert (ra["feats"].abs() < 3.0).all()
        key = (ra["locs"][:, 0] * 1000 + ra["locs"][:, 1]) * 1000 + \
            ra["locs"][:, 2]
        assert (key[1:] > key[:-1]).all()  # sorted by (z, y, x), distinct
    order = rooms.stream_order(8, seed)
    first = [next(order) for _ in range(16)]
    assert sorted(first[:8]) == list(range(8))
    assert first == [next(o) for o in [rooms.stream_order(8, seed)]
                     for _ in range(16)]


def _res(trace_ctx=None):
    ctx = {"window": {"enqueue_s": [0.01, 0.02], "seconds": 2.0,
                      "ops": 1e12}, "peak_flops": 989e12}
    if trace_ctx:
        ctx["trace"] = trace_ctx
    return {"metrics": {"rooms_per_s": 3.0, "room_ms_p95": 40.0,
                        "setup_s": 9.0},
            "units": {"rooms_per_s": "rooms/s", "room_ms_p95": "ms",
                      "setup_s": "s"},
            "attempted": 6, "failed": 0, "ctx": ctx,
            "checks": {"gate_gap": {"value": 0.1, "limit": 0.5}}}


def test_last_line_keys():
    cell, _, _ = H.load_cell(BENCH["workloads"][0]["name"])
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    line = H.result_line(_res(), cell, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == set(cell["end_to_end"])
    assert line["correct"] is True
    t = {"busy_s": 1.0, "window_s": 2.0, "floor_s": 0.01,
         "per_room": {0: 4}, "device_ops": [("k", 0.5)],
         "idle_gaps": [("idle during enqueue", 0.1)]}
    line = H.result_line(_res(t), cell, True, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["metrics"]) == set(cell["per_layer"])
    assert line["device"]["busy_s"] == 1.0
    bad = _res()
    bad["checks"]["gate_gap"]["value"] = 0.6
    assert H.result_line(bad, cell, False, dev)["correct"] is False


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = H.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules():
    assert H.forbidden_modules(["jax.numpy", "sgnn_tpu.ops", "os",
                                "sgnn_tpu_torch.ops", "jaxtyping"]) == [
        "jax", "sgnn_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_imports():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = set(_imports(path))
            assert not names & {"jax", "jaxlib", "flax", "sgnn_tpu"}, path
            if os.sep + "reference" in path:
                assert "sgnn_tpu_torch" not in names, path
