"""Model/runtime configuration: a copy of ``sgnn_tpu/config.py``.

The JAX package's config module cannot be imported without jax (its
package ``__init__`` imports the sparse ops), so the port carries its own
copy. ``tests/test_torch_params.py`` holds the fields, defaults and
derived properties to the original. Every field is kept, so a config
moves between the two packages unchanged.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class SGNNConfig:
    # --- architecture (reference names) ---
    encoder_dim: int = 8
    input_dim: tuple[int, int, int] = (128, 64, 64)  # zyx
    input_nf: int = 1
    nf_coarse: int = 16
    nf: int = 16
    num_hierarchy_levels: int = 4
    pass_occ: bool = True
    pass_feats: bool = True
    use_skip_sparse: bool = True
    use_skip_dense: bool = True
    truncation: float = 3.0

    # --- static-shape settings of the JAX package ---
    batch_size: int = 8
    input_capacity: int = 0  # 0 = auto
    occupancy_fractions: tuple[float, ...] = (1.0, 0.5, 0.25, 0.125)
    level_capacity_override: tuple[int, ...] = ()
    compute_dtype: str = "float32"
    conv_backend: str = "gather"
    execution: str = "sparse"
    use_pallas_conv: bool = False
    quantize_int8: bool = False
    pallas_min_voxels: int = 1_000_000
    input_presorted: bool = False
    fuse_train_bn: bool = True

    def __post_init__(self):
        if self.num_hierarchy_levels <= 1:
            raise ValueError("num_hierarchy_levels must be > 1")
        object.__setattr__(
            self, "input_dim", tuple(int(d) for d in self.input_dim)
        )
        f = 2 ** (self.num_hierarchy_levels - 1) * 4
        for d in self.input_dim:
            if d % f:
                raise ValueError(
                    f"input_dim {self.input_dim} must be divisible by {f}"
                )

    @cached_property
    def nf_per_level(self) -> list[int]:
        """Encoder feature widths per level."""
        L = self.num_hierarchy_levels
        if L > 2:
            return [
                int(self.encoder_dim * (1 + float(k) / (L - 2)))
                for k in range(L - 1)
            ]
        return [self.encoder_dim] * (L - 1)

    @cached_property
    def num_refine_levels(self) -> int:
        return self.num_hierarchy_levels - 1

    def level_spatial(self, h: int) -> tuple[int, int, int]:
        """Spatial size at hierarchy level h (0 = coarsest)."""
        f = 2 ** (self.num_hierarchy_levels - 1 - h)
        return tuple(d // f for d in self.input_dim)

    def level_voxels(self, h: int) -> int:
        z, y, x = self.level_spatial(h)
        return self.batch_size * z * y * x

    @cached_property
    def level_capacities(self) -> list[int]:
        """Static sparse capacities per hierarchy level (coarse -> fine)."""
        if self.level_capacity_override:
            if len(self.level_capacity_override) != self.num_hierarchy_levels:
                raise ValueError("one capacity override per level")
            return [int(c) for c in self.level_capacity_override]
        fr = list(self.occupancy_fractions)
        while len(fr) < self.num_hierarchy_levels:
            fr.append(fr[-1])
        caps = []
        for h in range(self.num_hierarchy_levels):
            cap = int(np.ceil(self.level_voxels(h) * fr[h]))
            caps.append(max(256, _round_up(cap, 128)))
        return caps

    @cached_property
    def input_cap(self) -> int:
        if self.input_capacity:
            return self.input_capacity
        return self.level_capacities[-1]

    def for_scene(self, scene_dim: tuple[int, int, int]) -> "SGNNConfig":
        """Config specialized to a (padded) whole-scene volume, batch 1."""
        return dataclasses.replace(
            self, input_dim=tuple(int(d) for d in scene_dim), batch_size=1
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
