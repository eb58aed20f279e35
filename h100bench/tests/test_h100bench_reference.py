"""The frozen reference against the port's forward on the CPU, at a tiny
size in f32: the same parameter trees, the same gate decisions and the
same values. (The reference itself imports nothing of the port.)"""

import json

import numpy as np
import pytest
import torch

from h100bench import rooms
from h100bench.reference import sgnn as R
from h100bench.run import load_cell
from h100bench.weights import make_weights, to_numpy

DIMS = (32, 64, 64)


def _leaves(tree):
    return {k: np.shape(v) for k, v in R.leaves(tree)}


def test_param_trees_match_the_port():
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.params import init_params

    spec_p, spec_s = R.param_spec(R.Net())
    port_p, port_s = init_params(SGNNConfig(), 0)
    assert {k: v[0] for k, v in R.leaves(spec_p)} == _leaves(port_p)
    assert {k: v[0] for k, v in R.leaves(spec_s)} == _leaves(port_s)


def _room(seed):
    _, _, traffic = load_cell("sgnn-mp-serve-bf16.rooms-stream")
    p = dict(traffic["room"], inset=2, box_half=[3, 6], hole_radius=[3, 6],
             holes=4, rows_per_column=2.0)
    return rooms.room_rows(DIMS, p, seed, 0, "cpu", 3.0)


def _port(P, S, dtype="float32"):
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.params import load_jax_params

    model = GenModelFolded(SGNNConfig(input_dim=DIMS, batch_size=1,
                                      compute_dtype=dtype))
    load_jax_params(model, to_numpy(P), to_numpy(S))
    return model


@pytest.mark.parametrize("weights_seed", [0, 2])
def test_reference_matches_the_port_f32(weights_seed):
    from sgnn_tpu_torch.ops import folded as FO

    torch.manual_seed(0)
    net = R.Net()
    P, S = make_weights(net, weights_seed, 7, 1e-3, "cpu")
    locs, feats = _room(3)
    model = _port(P, S)
    fms = {}
    for h, ref in enumerate(model.refinement):
        ref.register_forward_hook(
            lambda m, i, o, h=h: fms.__setitem__(h, o[2]))
    out = model(locs, feats, DIMS)
    fw = R.Forward(net, P, S)
    with R.precise():
        coarse, sdf, mask = fw(locs, feats, DIMS)
    assert mask.equal(out.surf_mask)
    for h in range(2):
        assert fw.gates[h + 1]["kept"].equal(
            FO.unfold(fms[h])[..., 0] > 0.5)
    assert fw.gates[0]["kept"].equal(torch.sigmoid(
        out.coarse_out[..., 0]) > 0.5)
    assert [int(g["kept"].sum()) for g in fw.gates] == \
        [int(a) for a in out.level_active]
    torch.testing.assert_close(coarse.permute(0, 2, 3, 4, 1),
                               out.coarse_out, rtol=1e-5, atol=1e-5)
    assert mask.any()
    scale = sdf[mask].abs().max()
    torch.testing.assert_close(out.surf_sdf[mask] / scale,
                               sdf[mask] / scale, rtol=0, atol=1e-5)


def test_work_counts_the_sites():
    net = R.Net()
    P, S = make_weights(net, 0, 1, 1e-3, "cpu")
    locs, feats = _room(4)
    work = R.Work()
    with R.precise():
        R.Forward(net, P, S, work)(locs, feats, DIMS)
    kinds = [k for k, _, _ in work.sites]
    # per encoder level 3 convs and a down, 6 trunk convs and the heads,
    # per refinement level 1 + 3 x 2 convs, 2 downs, the upconv and head,
    # the surface's 1 + 3 x 2 convs and 2 downs and its head
    assert kinds.count("conv") == 3 * 3 + 3 * 7 + 7
    assert kinds.count("down") == 3 + 3 * 2 + 2
    assert kinds.count("trunk") == 7
    assert kinds.count("upconv") == kinds.count("head") == 3
    assert kinds.count("surf_head") == kinds.count("scatter") == 1
    assert work.ops() > 0 and work.floor_s(3.35e12, 989e12) > 0
    # 2 Cin Cout per tap and active output voxel: the first conv's
    n = len(locs)
    assert work.sites[1] == ("conv", 2 * 27 * 1 * 8 * n,
                             2 * (1 + 8) * n + 2 * 27 * 8 + np.prod(DIMS))
    json.dumps(work.sites)


def _train_setup(tmp_path):
    from h100bench import train as TR
    from h100bench.rooms import chunk_files
    from h100bench.run import load_cell
    from sgnn_tpu_torch.params import load_jax_params

    _, config, traffic = load_cell("sgnn-mp-train-bf16.chunks-b8")
    traffic = dict(traffic, z=32, footprints=[[64, 64]], chunk=[32, 32, 32],
                   chunk_grid=[1, 2], batch_size=2, passes=1,
                   room=dict(traffic["room"], inset=2, box_half=[3, 6],
                             hole_radius=[3, 6], holes=4,
                             rows_per_column=2.0))
    config = dict(config, compute_dtype="float32")
    net, dev = TR.net_of(config), torch.device("cpu")
    P, S = make_weights(net, 7, 3, 1e-3, dev)
    chunks = chunk_files(traffic, dev, 3.0, str(tmp_path))
    tr = TR.make_trainer(config, traffic, str(tmp_path / "log"), dev)
    load_jax_params(tr.model, to_numpy(P), to_numpy(S))
    return TR, net, P, S, chunks, tr, traffic


def test_reference_step_matches_the_port_f32(tmp_path):
    """One training step of the folded execution: the port's (f32, plain
    versions) against the reference's on the same chunks, following the
    port's gates: the same loss and gradients, by the median leaf (at this
    tiny size a BN's moments run over a few hundred voxels, and another
    summation order moves a few small BN leaves by more)."""
    from h100bench.reference import train as RT

    TR, net, P, S, chunks, tr, traffic = _train_setup(tmp_path)
    loader = TR.make_loader(tr, chunks, traffic, 3.0)
    steps = TR.Steps(tr, loader, 20)
    with TR.captured_masks([]) as masks:
        loss = steps.step()
    steps.close()
    grads = [tr.opt.state[w]["exp_avg"] / 0.1 for w in tr.model.weights]
    by = {p.split("/")[-1][:-5]: p for p in chunks}
    batch = RT.batch_tensors([RT.read_chunk(by[n], 3.0)
                              for n in steps.names[0]], "cpu")
    ref = RT.train_steps(net, P, S, [batch], masks=masks)
    assert abs(loss - ref[0]["loss"]) <= 1e-5 * abs(ref[0]["loss"])
    rg = TR._leaf_norms(ref[0]["grads"])
    gaps, keep = TR.leaf_gaps(grads, ref[0]["grads"], rg)
    assert float(gaps[keep].median()) < 2e-2
