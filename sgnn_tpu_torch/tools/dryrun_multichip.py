"""Multi-device dry run of the port (the counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``, :157-445): its four phases on N
ranks of ``torch.distributed``, each printing one line.

    python -m sgnn_tpu_torch.tools.dryrun_multichip --cpu --num_devices 4
    python -m sgnn_tpu_torch.tools.dryrun_multichip --num_devices 2

1. folded data-parallel training: one step of the folded execution, one
   sample a rank, sparse-target batches of a jittered sphere shell (a
   partial scan of its target), every level and the surface active;
2. data-parallel serving: one sphere scene a rank through
   ``SceneInferencer`` (no exchange between ranks);
3. the dense flow on a data x space grid of ranks (2 x N/2 when N is even):
   one scene's forward z-sharded over the space axis;
4. the folded forward z-sharded over 2 ranks (each pair of ranks serves
   the scene) in its level-output form, the JAX dry run's default: the
   surface and each level's unfiltered sites, summed over the slabs,
   against the unsharded forward's.

Tiny shapes (encoder_dim 4, nf 8), as the JAX dry run has them; the
serving phases' weights are the first seed (from 0) whose random gates
leave a surface of at least MIN_SURFACE voxels on their scenes, found by
the unsharded forward in this process. ``--cpu``
runs the ranks on the host over gloo; without it the ranks take a card
each over NCCL, or with ``--share_card`` all share cuda:0 over gloo (one
card: the exchanges go through host memory). Exits non-zero if a phase
fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sgnn_tpu_torch.config import SGNNConfig
from sgnn_tpu_torch.infer import synthetic_scene
from sgnn_tpu_torch.params import init_params, load_jax_params

NET = dict(encoder_dim=4, nf_coarse=8, nf=8, batch_size=1)


def _rows(dims, seed=0):
    """(locs [N, 4] with batch 0, feats [N, 1]) of a sphere scene."""
    sc = synthetic_scene(dims, seed=seed)
    n = len(sc["input_locs"])
    locs = np.concatenate([sc["input_locs"], np.zeros((n, 1), np.int32)], 1)
    return locs, sc["input_sdf"][:, None].copy()


def _sphere(dims):
    zz, yy, xx = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    Z, Y, X = dims
    return (np.sqrt((zz - Z / 2) ** 2 + (yy - Y / 2) ** 2 + (xx - X / 2) ** 2)
            - min(dims) * 0.35).astype(np.float32)


def _band_rows(d, trunc):
    z, y, x = np.nonzero(np.abs(d) < trunc)
    return np.stack([z, y, x], -1).astype(np.int32), d[z, y, x]


def _chunk_sample(dims, L, trunc, rng, name):
    """A sparse-target chunk sample (data/dataset.py's schema): a shell
    jittered by up to half a voxel, 70% of its band observed as input, the
    whole band as target and hierarchy rows, nothing saturated or
    unobserved."""
    d = _sphere(dims) + np.float32(rng.uniform(-0.5, 0.5))
    t_locs, t_vals = _band_rows(d, trunc)
    keep = rng.rand(len(t_locs)) < 0.7
    hier_rows, hier_pos = [], []
    for h in range(L - 1):
        f = 2 ** (L - 1 - h)
        dh = tuple(s // f for s in dims)
        hier_rows.append(_band_rows(_sphere(dh) / f, trunc))
        hier_pos.append(np.packbits(np.zeros(int(np.prod(dh)), bool),
                                    bitorder="little"))
    zeros = np.packbits(np.zeros(int(np.prod(dims)), bool), bitorder="little")
    return {"name": name, "input_locs": t_locs[keep],
            "input_sdf": t_vals[keep], "target_locs": t_locs,
            "target_vals": t_vals, "target_pos": zeros,
            "hier_rows": hier_rows, "hier_pos": hier_pos,
            "known_unk": zeros, "world2grid": np.eye(4, dtype=np.float32),
            "orig_dims": np.array(dims, np.int64)}


MIN_SURFACE = 100  # voxels a phase's weights must leave on each scene


def _open_weights(cfg: SGNNConfig, dense: bool = False, scenes: int = 1):
    """The first seed's weights whose gates leave a surface of at least
    MIN_SURFACE voxels on each of the sphere scenes of seeds 0 ..
    ``scenes`` - 1 (the unsharded forward on the host), and the surface's
    size on the first."""
    for seed in range(16):
        w = init_params(cfg, seed)
        surfs = [_surface(cfg, w, s, dense) for s in range(scenes)]
        if min(surfs) >= MIN_SURFACE:
            return w, surfs[0]
    raise RuntimeError(f"no seed's gates leave a surface at {cfg.input_dim}")


def _level_sites(cfg, w) -> list:
    """Each refinement level's unfiltered sites in the unsharded
    level-output form of the folded forward on the scene of seed 0."""
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded

    locs, feats = _rows(cfg.input_dim)
    model = GenModelFolded(cfg)
    load_jax_params(model, *w)
    out = model(torch.from_numpy(locs), torch.from_numpy(feats),
                cfg.input_dim, want_level_outputs=True)
    return [int(m.sum()) for m in out.refine_masks_unfilt]


def _surface(cfg, w, scene_seed, dense):
    from sgnn_tpu_torch.models.dense_flow import GenModelDense
    from sgnn_tpu_torch.models.folded_flow import GenModelFolded
    from sgnn_tpu_torch.ops.sparse import make_sparse

    locs, feats = _rows(cfg.input_dim, scene_seed)
    if dense:
        model = GenModelDense(cfg)
        load_jax_params(model, *w)
        cap = cfg.input_cap
        lp = np.full((cap, 4), -1, np.int32)
        fp = np.zeros((cap, 1), np.float32)
        n = min(len(locs), cap)
        lp[:n], fp[:n] = locs[:n], feats[:n]
        out = model(make_sparse(torch.from_numpy(lp), torch.from_numpy(fp),
                                n, cfg.input_dim, 1))
    else:
        model = GenModelFolded(cfg)
        load_jax_params(model, *w)
        out = model(torch.from_numpy(locs), torch.from_numpy(feats),
                    cfg.input_dim)
    return int(out.surf_mask.sum())


def plan(n: int) -> tuple[list, dict]:
    """The four phases' jobs for ``parallel.programs.sequence`` on ``n``
    ranks, and what the lines need to know of them."""
    from sgnn_tpu_torch.data.dataset import collate_sparse

    info = {}
    # 1. folded DP training, one sample a rank (__graft_entry__.py:177-186)
    tcfg = dict(NET, input_dim=(16, 16, 16), num_hierarchy_levels=3,
                occupancy_fractions=(1.0, 1.0, 1.0), execution="folded")
    cfg1 = SGNNConfig(**tcfg)
    rng = np.random.RandomState(0)
    samples = [_chunk_sample(cfg1.input_dim, 3, cfg1.truncation, rng,
                             f"shell{i}") for i in range(n)]
    cap = cfg1.input_cap
    batch = collate_sparse(samples, cap * n, cap * n, [cap * n, cap * n])
    w1 = init_params(cfg1, 0)
    jobs = [("train_dp", (dict(tcfg, batch_size=n), w1, [batch],
                          np.ones(4, np.float32), 1e-3),
             dict(num_refine_active=2, do_surf=True, with_metrics=True))]
    # 2. DP serving, a scene a rank (:239-305)
    scfg = dict(NET, input_dim=(32, 32, 32), num_hierarchy_levels=4,
                occupancy_fractions=(1.0,) * 4, compute_dtype="float32")
    w2, _ = _open_weights(SGNNConfig(**scfg), scenes=n)
    scenes = [synthetic_scene(scfg["input_dim"], seed=d, name=f"scene{d}")
              for d in range(n)]
    jobs.append(("serve_scenes", (scfg, w2, scenes), {}))
    # 3. the dense flow on a data x space grid (:308-373)
    n_data = 2 if n % 2 == 0 and n > 1 else 1
    n_sp = n // n_data
    dcfg = dict(NET, input_dim=(32 * n_sp, 32, 32), num_hierarchy_levels=4,
                occupancy_fractions=(1.0,) * 4, execution="dense_flow")
    cfg3 = SGNNConfig(**dcfg)
    w3, _ = _open_weights(cfg3, dense=True)
    locs, feats = _rows(cfg3.input_dim)
    cap = cfg3.input_cap
    lp = np.full((cap, 4), -1, np.int32)
    fp = np.zeros((cap, 1), np.float32)
    k = min(len(locs), cap)
    lp[:k], fp[:k] = locs[:k], feats[:k]
    jobs.append(("serve_dense", (dcfg, w3, lp, fp, k), dict(num_data=n_data)))
    info["grid"] = (n_data, n_sp, cfg3.input_dim)
    # 4. the folded forward z-sharded over 2 ranks (:376-445)
    if n >= 2:
        fcfg = dict(NET, input_dim=(64, 32, 32), num_hierarchy_levels=4,
                    occupancy_fractions=(1.0,) * 4, compute_dtype="float32")
        w4, surf4 = _open_weights(SGNNConfig(**fcfg))
        locs, feats = _rows(fcfg["input_dim"])
        jobs.append(("serve_folded", (fcfg, w4, locs, feats,
                                      fcfg["input_dim"]),
                     dict(num_space=2, want_level_outputs=True)))
        info["folded"] = (fcfg["input_dim"], surf4,
                          _level_sites(SGNNConfig(**fcfg), w4))
    return jobs, info


def report(n: int, backend: str, res: list, info: dict) -> None:
    """One line per phase; raises AssertionError where a phase failed."""
    tr = [r[0] for r in res]
    loss = float(tr[0]["metrics"]["loss"])
    assert np.isfinite(loss), "non-finite loss in the DP step"
    assert all(np.array_equal(tr[0]["params"][0], t["params"][0])
               for t in tr), "ranks hold different parameters"
    print(f"[dryrun_multichip] FOLDED DP train ok on {n} ranks ({backend}):"
          f" loss={loss:.4f} iou={np.round(tr[0]['metrics']['iou'], 3)},"
          f" parameters bit-identical across ranks", flush=True)
    sv = [len(r[1]["surf_locs"]) for r in res]
    assert all(v > 0 for v in sv), f"empty surface on a rank ({sv})"
    print(f"[dryrun_multichip] DP SERVING ok: {n} scenes on {n} ranks, "
          f"surf voxels/scene={sv}", flush=True)
    n_data, n_sp, dims = info["grid"]
    masks = [r[2]["surf_mask"] for r in res]
    assert all(np.isfinite(r[2]["surf_sdf"]).all() for r in res)
    per_data = [int(sum(m.sum() for m in masks[d * n_sp:(d + 1) * n_sp]))
                for d in range(n_data)]
    assert per_data[0] > 0 and len(set(per_data)) == 1, per_data
    print(f"[dryrun_multichip] spatial ok on {n_data}x{n_sp} (data x space)"
          f" grid: scene {dims[0]}x{dims[1]}x{dims[2]}, surf voxels="
          f"{per_data[0]}", flush=True)
    if "folded" in info:
        dims, surf, sites = info["folded"]
        got = int(sum(r[3]["surf_mask"].sum() for r in res[:2]))
        assert got == surf, f"sharded surface {got} voxels, unsharded {surf}"
        lv = [int(sum(r[3]["refine_masks_unfilt"][h].sum() for r in res[:2]))
              for h in range(len(sites))]
        assert lv == sites, f"sharded level sites {lv}, unsharded {sites}"
        print(f"[dryrun_multichip] spatial FOLDED ok on 2-way z-sharded "
              f"ranks: scene {dims[0]}x{dims[1]}x{dims[2]}, surf voxels="
              f"{got} (the unsharded forward's {surf}), level sites {lv}",
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.dryrun_multichip",
        description="The multi-device paths on N ranks, one line a phase.")
    p.add_argument("--num_devices", type=int, default=4)
    p.add_argument("--cpu", action="store_true",
                   help="host ranks over gloo")
    p.add_argument("--share_card", action="store_true",
                   help="every rank on cuda:0 over gloo (one card)")
    args = p.parse_args(argv)
    from sgnn_tpu_torch.parallel import mesh as PM
    from sgnn_tpu_torch.parallel import programs as PG

    n = args.num_devices
    if args.cpu:
        backend, device = "gloo", "cpu"
    elif not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device; pass --cpu", file=sys.stderr)
        return 1
    elif args.share_card:
        backend, device = "gloo", "cuda:0"
    elif n > torch.cuda.device_count():
        print(f"dryrun_multichip: {n} ranks need {n} CUDA devices, this "
              f"host has {torch.cuda.device_count()} (--share_card puts "
              f"every rank on cuda:0)", file=sys.stderr)
        return 1
    else:
        backend, device = "nccl", "cuda"
    jobs, info = plan(n)
    jobs = [(name, a, dict(kw, device=device)) for name, a, kw in jobs]
    res = PM.launch(PG.sequence, n, backend, args=(jobs,))
    report(n, f"{backend}, {device}", res, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
