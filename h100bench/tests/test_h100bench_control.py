"""The check that decides ``correct`` fails where it should: each driver
runs on the CPU at a tiny size (the look for a card skipped, the rest of
a run as it is), with the timed path sound, with its control (the
precision below the configuration's bf16: the program's int8 path for
serving, the reference with float8 products in the program's place for
training) and with the faults of ``faults.py`` planted underneath;
every case but the sound one has to come out not correct."""

import time
import types

import pytest
import torch

from h100bench import faults
from h100bench import run as H
from h100bench import serve
from h100bench import train

SERVE = "sgnn-mp-serve-bf16.rooms-stream"
ARRIVALS = "sgnn-mp-serve-bf16.rooms-arrivals"
TRAIN = "sgnn-mp-train-bf16.chunks-b8"
SEED = 2 ** 31 + 3
ROOM = dict(inset=2, box_half=[3, 6], hole_radius=[3, 6], holes=4,
            rows_per_column=2.0)


def _serve(config_update=None, fault=None, seconds=6.0, cell_name=SERVE):
    cell, config, traffic = H.load_cell(cell_name)
    traffic = dict(traffic, z=32, footprints=[[64, 64], [64, 96]],
                   room=dict(traffic["room"], **ROOM))
    if "arrivals_per_s" in traffic:  # a rate the host's plain forward keeps
        traffic["arrivals_per_s"] = 1.0
    config = dict(config, **(config_update or {}))
    args = types.SimpleNamespace(seed=SEED, seconds=seconds, trace=0)
    res = serve.run(cell, config, traffic, args, time.perf_counter(),
                    device=torch.device("cpu"), fault=fault)
    return H.result_line(res, cell, False, {"platform": "cpu"}), res


def _train_traffic():
    cell, config, traffic = H.load_cell(TRAIN)
    traffic = dict(traffic, z=32, footprints=[[64, 64], [64, 96]],
                   chunk=[32, 32, 32], chunk_grid=[1, 2], batch_size=2,
                   passes=20, warmup_steps=3,
                   room=dict(traffic["room"], **ROOM))
    return cell, config, traffic


def _train(fault=None):
    cell, config, traffic = _train_traffic()
    args = types.SimpleNamespace(seed=SEED, seconds=2.0, trace=0)
    res = train.run(cell, config, traffic, args, time.perf_counter(),
                    device=torch.device("cpu"), fault=fault)
    return H.result_line(res, cell, False, {"platform": "cpu"}), res


@pytest.mark.parametrize("cell_name", [SERVE, ARRIVALS])
def test_sound_serving_is_correct(cell_name):
    line, res = _serve(cell_name=cell_name, seconds=4.0)
    assert line["correct"], line["checks"]
    assert res["attempted"] > 0
    if cell_name == ARRIVALS:  # every room that arrived in the window
        assert res["attempted"] == 4


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_not_correct(fault):
    line, _ = _serve(fault=faults.SERVE[fault])
    assert not line["correct"], (fault, line["checks"])


def test_serving_control_is_not_correct():
    # the int8 sites' plain versions are slow on the host: a longer window
    line, _ = _serve({"quantize_int8": True}, seconds=40.0)
    assert not line["correct"], line["checks"]


def test_sound_training_is_correct():
    line, res = _train()
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_not_correct(fault):
    line, _ = _train(faults.TRAIN[fault]())
    assert not line["correct"], (fault, line["checks"])


def test_training_control_is_not_correct():
    cell, config, traffic = _train_traffic()
    numbers = train.control_numbers(config, traffic, SEED,
                                    torch.device("cpu"))
    assert any(numbers[n] > v for n, v in cell["limits"].items()), numbers
