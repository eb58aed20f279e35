"""The multi-device paths as per-rank programs: each function here runs in
every rank of a ``parallel.mesh.launch`` (which needs them importable
from this package) and returns its rank's results as numpy arrays and
Python numbers, so that a parent process can compare ranks and hold the
sharded results against unsharded ones. ``tools/dryrun_multichip.py`` and
``chip_smoke.py`` drive them, and the CPU tests hold them against the JAX
package's ``shard_map``s.

- ``serve_folded``: the folded serving forward of one scene, z-sharded
  over every rank (``GenModelFolded(space=...)``), in its only-surface or
  level-output form, exact or int8 (``quantize_int8`` in its config),
  with each kernel's launches, and optionally the forward's ms and the
  exchanges' share, and a check of its kernel calls;
- ``serve_dense``: the dense flow's serving or training-mode forward of
  one scene, z-sharded over the space axis of a data x space grid;
- ``serve_scenes``: data-parallel serving, a scene a rank through
  ``SceneInferencer``;
- ``train_dp``: data-parallel training steps (``train.step.train_step``
  with the data group) on each rank's slice of one global batch;
- ``collectives``: the slice's collectives on seeded inputs (halo
  exchanges, sharded convs and scatter, BN with all-reduced moments and
  their gradients).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.parallel import comm
from sgnn_tpu_torch.parallel import mesh as PM


def _np(t):
    if isinstance(t, (list, tuple)):
        return [_np(x) for x in t]
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev: torch.device, reps: int) -> float:
    """ms per call of ``fn`` over ``reps`` calls: CUDA events on the
    card, the host clock else."""
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _timed(fn, dev: torch.device, reps: int) -> tuple[float, float]:
    """(ms per call of ``fn``, ms per call in its collectives), after one
    warm-up call. The first over ``reps`` untouched calls; the second
    from ``comm.timing`` over ``reps`` more, whose collectives each wait
    for the card first (host clock; over gloo the exchange is staged
    through host memory and blocks the host anyway)."""
    fn()
    _sync(dev)
    ms = _ms(fn, dev, reps)
    with comm.timing() as t:
        _ms(fn, dev, reps)
    return ms, t.seconds * 1e3 / reps


def serve_folded(cfg_kw: dict, weights: tuple, locs: np.ndarray,
                 feats: np.ndarray, dims: tuple, device: str,
                 reps: int = 0, num_space: int | None = None,
                 want_level_outputs: bool = False, check=None) -> dict:
    """One scene (``locs [N, 4]``, ``feats [N, 1]`` of the GLOBAL
    ``dims``) through ``GenModelFolded`` z-sharded over ``num_space``
    ranks (all by default; each group of that many serves the scene):
    this rank's slabs of the surface and coarse outputs, with
    ``want_level_outputs`` of each level's raw heads and unfiltered mask
    too, its kernels' launches in that forward, and with ``reps`` its ms
    per forward and the exchanges' ms of it. ``cfg_kw`` with
    ``quantize_int8`` serves the int8 sites: the weights are quantized
    once, at load, from the whole weights (as unsharded), and each site
    picks its tiles and scales on this rank's slab. ``check``: a context
    manager class entered around one more forward (chip_smoke.py's
    MainPathCheck holds each kernel call to its plain version); its
    instance's ``stats`` come back as ``check``."""
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import load_jax_params

    world = dist.get_world_size()
    num_space = num_space or world
    g = PM.init_groups(world // num_space, num_space, device)
    model = GenModelFolded(SGNNConfig(**cfg_kw))
    load_jax_params(model, *weights)
    model.to(g.device)
    lt = torch.from_numpy(np.asarray(locs)).to(g.device)
    ft = torch.from_numpy(np.asarray(feats, np.float32)).to(g.device)

    def fwd():
        return model(lt, ft, tuple(dims), space=g.space,
                     want_level_outputs=want_level_outputs)
    K.reset_launch_counts()
    out = fwd()
    _sync(g.device)
    res = {"launches": K.launch_counts(), "rank": g.rank,
           "coarse_out": _np(out.coarse_out), "surf_sdf": _np(out.surf_sdf),
           "surf_mask": _np(out.surf_mask),
           "level_active": [int(a) for a in out.level_active],
           "refine_outs": _np(out.refine_outs),
           "refine_masks_unfilt": _np(out.refine_masks_unfilt)}
    if reps:
        res["ms"], res["exchange_ms"] = _timed(fwd, g.device, reps)
    if check is not None:
        with check() as chk:
            fwd()
        _sync(g.device)
        res["check"] = chk.stats
    return res


def serve_dense(cfg_kw: dict, weights: tuple, locs: np.ndarray,
                feats: np.ndarray, num_valid: int, num_data: int = 1,
                training: bool = False, *, device: str,
                reps: int = 0) -> dict:
    """One scene's dense-flow forward (``st`` of the GLOBAL dims), z-
    sharded over the space axis of a ``num_data`` x (world / num_data)
    grid (every data index serves the same scene, as the JAX dry run's
    data x space mesh does): eval with prepared weights
    (``GenModelDense``), or with ``training`` the training form's batch
    moments (``GenModelDenseTrain``; the sparse levels sum over data and
    space, the trunk over data). Returns this rank's slabs, the new stats
    (training), its kernels' launches (none: the sharded convs are plain
    convs) and with ``reps`` the ms per forward."""
    from sgnn_tpu_torch.models.dense_flow import (GenModelDense,
                                                  GenModelDenseTrain)
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.ops.sparse import make_sparse
    from sgnn_tpu_torch.params import load_jax_params, tree_items

    world = dist.get_world_size()
    g = PM.init_groups(num_data, world // num_data, device)
    cfg = SGNNConfig(**cfg_kw)
    st = make_sparse(torch.from_numpy(np.asarray(locs)).to(g.device),
                     torch.from_numpy(np.asarray(feats)).to(g.device),
                     num_valid, cfg.input_dim, cfg.batch_size)
    if training:
        model = GenModelDenseTrain(cfg).to(g.device)
        model.load(*weights)

        def fwd():
            with torch.no_grad():
                return model(st, num_refine_active=cfg.num_refine_levels,
                             do_surf=True, training=True, data=g.data,
                             space=g.space)
    else:
        model = GenModelDense(cfg)
        load_jax_params(model, *weights)
        model.to(g.device)

        def fwd():
            return model(st, space=g.space), None
    K.reset_launch_counts()
    out, new = fwd()
    _sync(g.device)
    res = {"rank": g.rank, "launches": K.launch_counts(),
           "coarse_out": _np(out.coarse_out),
           "refine_outs": _np(out.refine_outs),
           "refine_masks": _np(out.refine_masks_unfilt),
           "surf_sdf": _np(out.surf_sdf), "surf_mask": _np(out.surf_mask),
           "stats": None if new is None else
           {k: _np(v) for k, v in tree_items(new)}}
    if reps:
        res["ms"], res["exchange_ms"] = _timed(fwd, g.device, reps)
    return res


def serve_scenes(cfg_kw: dict, weights: tuple, scenes: list,
                 device: str) -> dict:
    """Data-parallel serving: rank r serves ``scenes[r]`` (a scene sample
    dict) through ``SceneInferencer(GenModelFolded)``, with no exchange
    between ranks; returns its surface voxels and values."""
    from sgnn_tpu_torch.infer import SceneInferencer
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import load_jax_params

    g = PM.init_groups(dist.get_world_size(), 1, device)
    model = GenModelFolded(SGNNConfig(**cfg_kw))
    load_jax_params(model, *weights)
    model.to(g.device)
    K.reset_launch_counts()
    res = SceneInferencer(model, want_levels=False)(scenes[g.rank])
    return {"rank": g.rank, "name": res["name"],
            "surf_locs": res["surf_locs"], "surf_sdf": res["surf_sdf"],
            "launches": K.launch_counts()}


def train_dp(cfg_kw: dict, weights: tuple, batches: list, lw, lr: float,
             *, num_refine_active: int, do_surf: bool, device: str,
             with_metrics: bool = False, reps: int = 0, plain: bool = False,
             noise: float = 0.0) -> dict:
    """``len(batches)`` data-parallel steps, one global collated batch
    each (``cfg_kw["batch_size"]`` the global batch; the per-rank config's
    is it over the ranks), every rank on its slice (``mesh.device_batch``)
    from the same ``weights``. Returns the first step's averaged
    gradients, loss, per-level losses (and metrics) and new stats, each
    step's parameters as one flat vector, the first step's kernel
    launches, and with ``reps`` the ms per step over ``reps`` more steps
    of the last batch. ``plain``: every kernel's plain version
    (``ops.kernels.plain_versions``); ``noise``: the input features moved
    by that relative normal noise (seeded per rank), which shows how far
    a step moves with no kernel involved."""
    import contextlib

    from sgnn_tpu_torch.ops import kernels as K
    from sgnn_tpu_torch.params import export_params, load_jax_params
    from sgnn_tpu_torch.params import tree_items
    from sgnn_tpu_torch.train import state as ST
    from sgnn_tpu_torch.train import step as TS

    n = dist.get_world_size()
    g = PM.init_groups(n, 1, device)
    cfg = SGNNConfig(**{**cfg_kw, "batch_size": cfg_kw["batch_size"] // n})
    model = TS.train_model(cfg)
    load_jax_params(model, *weights)
    model.to(g.device)
    opt = ST.make_optimizer(model, lr, 0.0)
    kw = dict(num_refine_active=num_refine_active, do_surf=do_surf,
              with_metrics=with_metrics, group=g.data)
    res = {"rank": g.rank, "params": []}

    gen = torch.Generator(device=g.device).manual_seed(1 + g.rank)

    def step(b):
        dev = PM.put_device_batch(PM.device_batch(b, n), g.data_index,
                                  g.device)
        if noise:
            f = dev["input_sdf"]
            dev["input_sdf"] = f * (1 + noise * torch.randn(
                f.shape, device=f.device, generator=gen))
        with K.plain_versions() if plain else contextlib.nullcontext():
            return TS.train_step(model, opt, dev, lw, lr, **kw)
    for i, b in enumerate(batches):
        if i == 0:
            K.reset_launch_counts()
        m = step(b)
        if i == 0:
            _sync(g.device)
            res["launches"] = K.launch_counts()
            res["metrics"] = _np({k: v for k, v in m.items()
                                  if k != "overflow"})
            res["grads"] = {k: _np(p.grad) for k, p in
                            zip(model.param_keys, model.weights)}
            res["stats"] = dict(tree_items(export_params(model)[1]))
        res["params"].append(np.concatenate(
            [_np(p).reshape(-1) for p in model.weights]))
    if reps:
        res["ms"], res["exchange_ms"] = _timed(lambda: step(batches[-1]),
                                               g.device, reps)
    return res


def collectives(case: dict, device: str) -> dict:
    """The slice's collectives on one rank of a group spanning every rank,
    on the GLOBAL inputs of ``case`` (numpy), each rank taking its part:

    - ``x`` [B, Z, Y, X, C]: its z-slab through ``halo_exchange`` (halo
      1; and the same exchange as NCCL's batched point-to-point transfers,
      ``halo_batched``), ``sharded_conv3d`` with ``w3`` (3^3, stride 1)
      and ``w2`` (2^3, stride 2), and the input gradients of the exchange
      (cotangent ``halo_cot``) and of ``all_gather`` (``gather_cot``, a
      [B, Z, ...] cotangent a rank);
    - ``fold`` [B, Z, Y, X, C] with ``fold_mask`` [B, Z, Y, X]: its folded
      z-slab (cpad 16) through ``halo_exchange_z``;
    - ``locs``/``feats`` rows of a ``scatter_dims`` scene: its slab of
      ``scatter_sparse_sharded`` (cpad 8, f32);
    - ``rows`` [N, C], ``row_mask`` [N], ``row_cot`` [N, C]: its block of
      rows through the training ``batch_norm`` with moments summed over
      the group (``bn``, ``bn_stats``): the output, the new stats and the
      gradient of sum(y * cot) by its rows;
    - ``fg`` [B, Z, Y, X, C] with ``fg_mask`` and ``fg_cot``: its batch
      sample(s), folded, through ``bn_folded_train`` with the group: the
      output, the new stats and the input gradient."""
    from sgnn_tpu_torch.ops import bn as BN
    from sgnn_tpu_torch.ops import folded as FO
    from sgnn_tpu_torch.parallel import spatial as SP

    n = dist.get_world_size()
    g = PM.init_groups(1, n, device)
    grp, i, dev = g.space, g.space_index, g.device

    def part(a, axis):
        k = a.shape[axis] // n
        return torch.from_numpy(np.ascontiguousarray(
            np.take(a, np.arange(i * k, (i + 1) * k), axis))).to(dev)
    out = {"rank": g.rank}
    x = part(case["x"], 1)
    out["halo"] = _np(SP.halo_exchange(x, 1, grp))
    # the same planes through NCCL's batched point-to-point path
    fp, fn = comm.shift(x[:, -1:], x[:, :1], grp, batched=True)
    out["halo_batched"] = _np(torch.cat([fp, x, fn], 1))
    # the gradients of the exchange and of the all-gather
    xg = x.clone().requires_grad_(True)
    (SP.halo_exchange(xg, 1, grp) * part(case["halo_cot"], 1)).sum().backward()
    out["halo_dx"] = _np(xg.grad)
    xg.grad = None
    (comm.all_gather(xg, grp, 1) * part(case["gather_cot"], 0)[0]).sum(
        ).backward()
    out["gather_dx"] = _np(xg.grad)
    w3 = torch.from_numpy(case["w3"]).to(dev)
    w2 = torch.from_numpy(case["w2"]).to(dev)
    out["conv_s1"] = _np(SP.sharded_conv3d(x, w3, grp, stride=1, padding=1))
    out["conv_s2"] = _np(SP.sharded_conv3d(x, w2, grp, stride=2, padding=0))

    fgz = FO.fold(part(case["fold"], 1), 16)
    fmz = FO.fold_mask(part(case["fold_mask"], 1), 16, torch.float32)
    out["halo_z"] = _np(FO.halo_exchange_z(fgz, grp).data)
    out["halo_z_mask"] = _np(FO.halo_exchange_z(fmz, grp).data)

    sg, sm = FO.scatter_sparse_sharded(
        torch.from_numpy(case["locs"]).to(dev),
        torch.from_numpy(case["feats"]).to(dev), len(case["locs"]),
        tuple(case["scatter_dims"]), 1, grp, cpad=8, dtype=torch.float32)
    out["scatter"], out["scatter_mask"] = _np(sg.data), _np(sm.data)

    p = {k: torch.from_numpy(v).to(dev) for k, v in case["bn"].items()}
    s = {k: torch.from_numpy(v).to(dev) for k, v in case["bn_stats"].items()}
    rows = part(case["rows"], 0).requires_grad_(True)
    y, ns = BN.batch_norm(p, s, rows, part(case["row_mask"], 0),
                          training=True, group=grp)
    (y * part(case["row_cot"], 0)).sum().backward()
    out["bn_y"], out["bn_stats"], out["bn_dx"] = _np(y), _np(ns), \
        _np(rows.grad)

    fg = FO.fold(part(case["fg"], 0), 16)
    fg.data.requires_grad_(True)
    fm = FO.fold_mask(part(case["fg_mask"], 0), 16, torch.float32)
    y, ns = FO.bn_folded_train(p, s, fg, fm, training=True, group=grp)
    (FO.unfold(y) * part(case["fg_cot"], 0)).sum().backward()
    out["fbn_y"] = _np(FO.unfold(y))
    out["fbn_stats"] = _np(ns)
    dx = fg.with_data(fg.data.grad)
    out["fbn_dx"] = _np(FO.unfold(dx))
    return out


def sequence(jobs: list) -> list:
    """Several of these programs in one launch, in order (each builds the
    groups it needs): ``jobs`` of (name, args, kwargs); returns their
    results."""
    return [globals()[name](*args, **kw) for name, args, kw in jobs]
