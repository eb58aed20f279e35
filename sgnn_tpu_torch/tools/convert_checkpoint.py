"""Convert checkpoints both ways between the reference ``.pth`` layout
(the reference's test_scene.py:61-62 load contract) and ``.ckpt``; port
of the JAX package's ``tools/convert_checkpoint.py``, with its flags.
The direction follows the file names:

    python -m sgnn_tpu_torch.tools.convert_checkpoint \\
        --input sgnn.pth --output sgnn.ckpt
    python -m sgnn_tpu_torch.tools.convert_checkpoint \\
        --input model-epoch-31.ckpt --output sgnn_export.pth

A ``.pth`` becomes a ``.ckpt`` with zero Adam moments, step 0, and its
epoch; a ``.ckpt`` (of either package) becomes
``{"epoch", "state_dict", "optimizer": {}}``, which the reference code
loads. Runs on the host; needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m sgnn_tpu_torch.tools.convert_checkpoint",
        description="Convert a reference .pth to a .ckpt or a .ckpt to a "
                    "reference .pth.")
    p.add_argument("--input", required=True, help=".pth or .ckpt")
    p.add_argument("--output", required=True, help=".ckpt or .pth")
    p.add_argument("--encoder_dim", type=int, default=8)
    p.add_argument("--coarse_feat_dim", type=int, default=16)
    p.add_argument("--refine_feat_dim", type=int, default=16)
    p.add_argument("--num_hierarchy_levels", type=int, default=4)
    p.add_argument("--no_pass_occ", action="store_true")
    p.add_argument("--no_pass_feats", action="store_true")
    p.add_argument("--use_skip_sparse", type=int, default=1)
    p.add_argument("--use_skip_dense", type=int, default=1)
    args = p.parse_args(argv)
    if not ((args.input.endswith(".ckpt") and args.output.endswith(".pth"))
            or (args.input.endswith(".pth")
                and not args.output.endswith(".pth"))):
        p.error("convert a .pth to a .ckpt or a .ckpt to a .pth")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    import numpy as np
    import torch

    from sgnn_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from sgnn_tpu_torch.config import SGNNConfig
    from sgnn_tpu_torch.params import tree_items
    from sgnn_tpu_torch.utils.ckpt_convert import export_state_dict, \
        load_reference_checkpoint

    f = 2 ** (args.num_hierarchy_levels - 1) * 4
    cfg = SGNNConfig(
        encoder_dim=args.encoder_dim,
        input_dim=(f,) * 3,
        nf_coarse=args.coarse_feat_dim,
        nf=args.refine_feat_dim,
        num_hierarchy_levels=args.num_hierarchy_levels,
        pass_occ=not args.no_pass_occ,
        pass_feats=not args.no_pass_feats,
        use_skip_sparse=bool(args.use_skip_sparse),
        use_skip_dense=bool(args.use_skip_dense),
        batch_size=1,
    )
    if args.input.endswith(".ckpt"):
        ck = load_checkpoint(args.input, cfg)
        sd = export_state_dict(ck.params, ck.stats, cfg)
        torch.save({"epoch": int(ck.meta.get("epoch", 0)),
                    "state_dict": {k: torch.from_numpy(v)
                                   for k, v in sd.items()},
                    "optimizer": {}}, args.output)
        print(f"exported {args.input} -> {args.output} "
              f"({len(sd)} state_dict keys)")
        return
    params, stats, meta = load_reference_checkpoint(args.input, cfg)
    save_checkpoint(args.output, params, stats, epoch=meta["epoch"],
                    iteration=0,
                    extra={"source": os.path.basename(args.input)})
    n = sum(np.size(v) for _, v in tree_items(params))
    print(f"converted {args.input} -> {args.output} ({n} params, "
          f"epoch {meta['epoch']})")


if __name__ == "__main__":
    sys.exit(main())
