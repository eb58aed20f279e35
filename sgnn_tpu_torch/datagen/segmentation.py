"""Matterport segmentation parsers: .vsegs.json / .semseg.json (port of
``sgnn_tpu/datagen/segmentation.py``).

The reference declares these inputs (ScanInfo, the reference's datagen/
GenerateScans/src/ScansDirectory.h:7-23; rapidjson parsers in
Segmentation/Aggregation.cpp) but never reads them in the fuse path —
they exist for semantic-label extensions. Provided here for parity and
for downstream semantic-completion work.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class VertexSegmentation:
    """Per-vertex segment ids (.vsegs.json)."""
    scene_id: str
    seg_indices: np.ndarray  # [num_vertices] int64

    @staticmethod
    def load(path) -> "VertexSegmentation":
        d = json.load(open(path))
        return VertexSegmentation(
            scene_id=d.get("sceneId", ""),
            seg_indices=np.asarray(d["segIndices"], np.int64),
        )

    def vertices_for_segments(self, segments) -> np.ndarray:
        return np.nonzero(np.isin(self.seg_indices, list(segments)))[0]


@dataclasses.dataclass
class SemsegGroup:
    id: int
    label: str
    segments: list
    obb: dict | None


@dataclasses.dataclass
class SemanticSegmentation:
    """Object groups over segments (.semseg.json)."""
    scene_id: str
    groups: list

    @staticmethod
    def load(path) -> "SemanticSegmentation":
        d = json.load(open(path))
        groups = [
            SemsegGroup(
                id=g.get("id", i),
                label=g.get("label", ""),
                segments=g.get("segments", []),
                obb=g.get("obb"),
            )
            for i, g in enumerate(d.get("segGroups", []))
        ]
        return SemanticSegmentation(d.get("sceneId", ""), groups)

    def vertex_labels(self, vsegs: VertexSegmentation) -> np.ndarray:
        """[num_vertices] group-id per vertex (-1 = unlabeled)."""
        out = np.full(len(vsegs.seg_indices), -1, np.int64)
        for g in self.groups:
            out[np.isin(vsegs.seg_indices, g.segments)] = g.id
        return out
