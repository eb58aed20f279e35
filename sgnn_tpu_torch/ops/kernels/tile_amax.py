"""The activation-scale pre-pass of the int8 sites (csrc/quant.cu).

Port of the per-tile ``amax = jnp.max(jnp.abs(tf))`` of the TPU kernels'
int8 bodies (sgnn_tpu/ops/pallas/conv3d_folded.py :419-421, :875-876,
:1231-1233): for every input group of a site, the largest ``|tf|`` over
each TPU tile's window of input rows, every x block and every lane, where
``tf = relu(x * a + b) * mask`` with the site's affine (``aff [G, 2,
16]``, zero on dead lanes) and ``tf = x`` without one. Returns ``amax
[B, nz, ny, G]`` f32; ``ops/quant.py`` holds the tiles, the plain
version and the scales.
"""

from __future__ import annotations

import torch

from sgnn_tpu_torch.ops.kernels import build
from sgnn_tpu_torch.ops.quant import Tiles, tile_amax_plain

launches = 0  # kernel launches since the last reset_launch_counts()


def tile_amax(xs: list, mask: torch.Tensor, aff: torch.Tensor | None,
              cpad: int, tiles: Tiles, impl: str | None = None
              ) -> torch.Tensor:
    global launches
    G = len(xs)
    if not 1 <= G <= 4 or cpad not in (8, 16):
        raise ValueError(f"tile_amax: G={G}, cpad={cpad}")
    for i, x in enumerate(xs):
        build.check_grid(f"xs[{i}]", x, mask)
    build.check_grid("mask", mask, mask)
    if aff is not None:
        build.check_f32("aff", aff, (G, 2, 16), mask)
    if not build.use_kernel(mask, impl):
        return tile_amax_plain(xs, mask, aff, cpad, tiles)
    B, Zp, Yp, xq, _ = mask.shape
    out = torch.zeros(B, tiles.nz, tiles.ny, G, dtype=torch.float32,
                      device=mask.device)
    rc = build.lib().sgnn_tile_amax(
        build.ptr_array(xs), G, build.ptr(mask), build.ptr(aff),
        build.ptr(out), B, Zp, Yp, xq, cpad, tiles.nz, tiles.ny,
        build.int_array(tiles.window), build.is_bf16(mask),
        build.stream(mask),
    )
    launches += 1
    build.check(rc, "tile_amax")
    return out
