"""Lighting + Phong/Ward materials for the datagen render path (port of
``sgnn_tpu/datagen/lighting.py``).

A host rebuild of the reference's D3D11 lighting pieces:
- ``Lighting`` mirrors GenerateScans' light set: up to MAX_NUM_LIGHTS
  randomized directional lights with text save/load
  (the reference's datagen/GenerateScans/src/Lighting.h:5-115).
- ``SimpleMaterial`` mirrors the Phong/Ward material record with the
  same clamped-normal randomizers and energy-conservation rescale
  (the reference's datagen/GenerateScans/src/SimpleMaterial.h:7-157).
- ``phong_shade`` is the shading the cbuffer lights feed: vectorized
  numpy Phong over per-pixel normals (the reference's annotation shader
  itself is passthrough flat color,
  the reference's datagen/GenerateScans/shaders/drawAnnotations.hlsl:28-31;
  flat color rendering lives in datagen/render.py:render_color).

The reference classes are Win32/D3D11 constant-buffer wrappers; here the
same state and randomization drive the software rasterizer
(datagen/cpp/rasterize.cpp) instead of a GPU pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_NUM_LIGHTS = 10  # Lighting.h:5


def _rnd_nc(rng, mu, sd, min_v=0.0, max_v=1.0):
    """Normal draw rejected until inside [min_v, max_v]
    (SimpleMaterial.h:57-66 rndNC)."""
    while True:
        r = rng.normal(mu, sd)
        if min_v <= r <= max_v:
            return float(r)


class Lighting:
    """A set of up to MAX_NUM_LIGHTS vec4 lights (xyz = direction,
    w = 0 directional / 1 point, Lighting.h:50-56)."""

    def __init__(self, lights: np.ndarray | None = None):
        if lights is None:
            lights = np.zeros((0, 4), np.float32)
        lights = np.asarray(lights, np.float32).reshape(-1, 4)
        if len(lights) > MAX_NUM_LIGHTS:
            raise ValueError(
                f"exceeds the max num light count ({MAX_NUM_LIGHTS})"
            )
        self.lights = lights

    @property
    def num_lights(self) -> int:
        return len(self.lights)

    def set_num_lights(self, n: int) -> None:
        """Grow/shrink the light array (Lighting.h:42-49); new slots are
        zero until randomize()."""
        n = min(n, MAX_NUM_LIGHTS)
        cur = self.lights
        out = np.zeros((n, 4), np.float32)
        out[: min(n, len(cur))] = cur[: min(n, len(cur))]
        self.lights = out

    def randomize(self, rng: np.random.RandomState | None = None) -> None:
        """Uniform directions in [-.5,.5]^3 normalized, w=0 (directional)
        — Lighting.h:51-56 randomize() with rndUD."""
        rng = rng or np.random.RandomState()
        for i in range(len(self.lights)):
            v = rng.uniform(-0.5, 0.5, 3)
            n = np.linalg.norm(v)
            while n < 1e-9:
                v = rng.uniform(-0.5, 0.5, 3)
                n = np.linalg.norm(v)
            self.lights[i] = [*(v / n), 0.0]

    @staticmethod
    def random(num_lights: int = 1,
               rng: np.random.RandomState | None = None) -> "Lighting":
        """loadFromGlobaAppState equivalent: 1 randomized light
        (Lighting.h:32-36)."""
        lt = Lighting()
        lt.set_num_lights(num_lights)
        lt.randomize(rng)
        return lt

    # text format: numLights line, then one "x y z w" line per light
    # (Lighting.h:64-69 saveToFile / :78-83 loadFromFile)
    def save_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(f"{self.num_lights}\n")
            for v in self.lights:
                f.write(" ".join(repr(float(c)) for c in v) + "\n")

    @staticmethod
    def load_from_file(path: str) -> "Lighting":
        with open(path) as f:
            toks = f.read().split()
        n = int(toks[0])
        vals = np.asarray([float(t) for t in toks[1 : 1 + 4 * n]],
                          np.float32)
        return Lighting(vals.reshape(n, 4))


@dataclasses.dataclass
class SimpleMaterial:
    """Phong/Ward material record (SimpleMaterial.h:7-47)."""

    ambient: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32))
    diffuse: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32))
    specular: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32))
    shiny: float = 0.0

    AMBIENT = 1 << 0
    DIFFUSE = 1 << 1
    SPECULAR = 1 << 2

    def __post_init__(self):
        self.ambient = np.asarray(self.ambient, np.float32).reshape(4)
        self.diffuse = np.asarray(self.diffuse, np.float32).reshape(4)
        self.specular = np.asarray(self.specular, np.float32).reshape(4)
        self.shiny = float(self.shiny)

    # ---- randomizers (SimpleMaterial.h:69-134)
    @staticmethod
    def random_ward(rng=None, flags=AMBIENT | DIFFUSE | SPECULAR
                    ) -> "SimpleMaterial":
        """randomMaterialWard: clamped-normal draws + energy conservation
        rescale (SimpleMaterial.h:70-104)."""
        rng = rng or np.random.RandomState()
        m = SimpleMaterial()
        if flags & SimpleMaterial.AMBIENT:
            a = _rnd_nc(rng, 0.05, 0.02, 0.0, 0.1)
            m.ambient = np.asarray([a, a, a, 1.0], np.float32)
        if flags & SimpleMaterial.DIFFUSE:
            m.diffuse = np.asarray(
                [_rnd_nc(rng, 0.5, 0.5) for _ in range(3)] + [1.0],
                np.float32)
        if flags & SimpleMaterial.SPECULAR:
            s = _rnd_nc(rng, 0.5, 0.5)
            m.specular = np.asarray([s, s, s, 1.0], np.float32)
            m.shiny = _rnd_nc(rng, 3.0, 2.0, 1.0, 10.0)
        # energy conservation: rescale so ambient+diffuse+specular <= 1
        tot = m.ambient + m.diffuse + m.specular
        peak = float(tot[:3].max())
        if peak > 1.0:
            m.ambient = m.ambient / peak
            m.diffuse = m.diffuse / peak
            m.specular = m.specular / peak
        return m

    @staticmethod
    def random_phong(rng=None, flags=AMBIENT | DIFFUSE | SPECULAR
                     ) -> "SimpleMaterial":
        """randomMaterialPhong (SimpleMaterial.h:107-128)."""
        rng = rng or np.random.RandomState()
        m = SimpleMaterial()
        if flags & SimpleMaterial.AMBIENT:
            a = _rnd_nc(rng, 0.1, 0.1)
            m.ambient = np.asarray([a, a, a, 1.0], np.float32)
        if flags & SimpleMaterial.DIFFUSE:
            m.diffuse = np.asarray(
                [_rnd_nc(rng, 0.5, 0.5) for _ in range(3)] + [1.0],
                np.float32)
        if flags & SimpleMaterial.SPECULAR:
            s = _rnd_nc(rng, 0.5, 0.5)
            m.specular = np.asarray([s, s, s, 1.0], np.float32)
            m.shiny = _rnd_nc(rng, 15.0, 10.0, 0.5, 50.0)
        return m

    @staticmethod
    def default() -> "SimpleMaterial":
        return SimpleMaterial([0.1, 0.1, 0.1, 1], [1, 1, 1, 1],
                              [1, 1, 1, 1], 3.0)

    @staticmethod
    def red_diffuse() -> "SimpleMaterial":
        return SimpleMaterial([0.1, 0.1, 0.1, 1], [1, 0, 0, 1],
                              [0, 0, 0, 1], 0.0)

    @staticmethod
    def green_diffuse() -> "SimpleMaterial":
        return SimpleMaterial([0.1, 0.1, 0.1, 1], [0, 1, 0, 1],
                              [0, 0, 0, 1], 0.0)

    # text format: one line each ambient/diffuse/specular/shiny
    # (SimpleMaterial.h:21-40)
    def save_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            for v in (self.ambient, self.diffuse, self.specular):
                f.write(" ".join(repr(float(c)) for c in v) + "\n")
            f.write(f"{self.shiny!r}\n")

    @staticmethod
    def load_from_file(path: str) -> "SimpleMaterial":
        with open(path) as f:
            toks = f.read().split()
        vals = [float(t) for t in toks]
        return SimpleMaterial(vals[0:4], vals[4:8], vals[8:12], vals[12])


def phong_shade(
    normals: np.ndarray,     # [..., 3] unit surface normals
    view_dirs: np.ndarray,   # [..., 3] unit dirs surface -> eye
    lighting: Lighting,
    material: SimpleMaterial,
    base_color: np.ndarray | None = None,  # [..., 3] albedo multiplier
) -> np.ndarray:
    """[..., 3] Phong radiance: ambient + sum_l diffuse*max(n.l,0) +
    specular*max(r.v,0)^shiny, for the directional lights (w == 0) the
    reference's cbuffer carries (Lighting.h:108-112). Vectorized numpy —
    shading happens once per rendered frame on the host."""
    n = np.asarray(normals, np.float32)
    v = np.asarray(view_dirs, np.float32)
    out = np.broadcast_to(
        material.ambient[:3], n.shape
    ).astype(np.float32).copy()
    diff = np.zeros_like(out)
    spec = np.zeros_like(out)
    for light in lighting.lights:
        if light[3] != 0.0:
            continue  # point lights unused by the reference randomizer
        # stored vector = unit direction from surface toward the light
        # (shader-style "lightDir"; the randomizer already normalizes)
        ldir = light[:3] / max(np.linalg.norm(light[:3]), 1e-9)
        ndotl = np.maximum((n * ldir).sum(-1, keepdims=True), 0.0)
        diff = diff + ndotl * material.diffuse[:3]
        # reflect ldir about n, compare with view dir
        r = 2.0 * (n * ldir).sum(-1, keepdims=True) * n - ldir
        rdotv = np.maximum((r * v).sum(-1, keepdims=True), 0.0)
        spec = spec + np.power(rdotv, max(material.shiny, 1e-6)) \
            * material.specular[:3] * (ndotl > 0)
    if base_color is not None:
        diff = diff * np.asarray(base_color, np.float32)
    return np.clip(out + diff + spec, 0.0, 1.0)
