"""Parameter-file reader for datagen configs (port of
``sgnn_tpu/datagen/params.py``).

Parses the reference's ``key = value;``-style parameter files
(zParametersScanMP.txt, read by the X-macro ParameterFile singleton in
the reference's datagen/GenerateScans/src/GlobalAppState.h:11-81) so
existing configs drive sgnn_tpu_torch/tools/generate_scans.py unchanged.

Supported value forms: quoted strings, booleans, ints, floats; ``//``
comments anywhere; trailing semicolons optional.
"""

from __future__ import annotations

import re


def parse_param_file(path: str) -> dict:
    out = {}
    for raw in open(path, errors="replace"):
        line = raw.split("//")[0].strip()
        if not line or "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        val = val.strip().rstrip(";").strip()
        if not key:
            continue
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
            continue
        low = val.lower()
        if low in ("true", "false"):
            out[key] = low == "true"
            continue
        m = re.fullmatch(r"[-+]?\d+", val)
        if m:
            out[key] = int(val)
            continue
        m = re.fullmatch(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?f?", val)
        if m:
            out[key] = float(val.rstrip("fF"))
            continue
        out[key] = val
    return out


# mapping from reference parameter names -> generate_scans CLI options
PARAM_TO_ARG = {
    "s_sceneFileList": "scene_file_list",
    "s_scanPath": "scan_path",
    "s_scanMeshPath": "scan_mesh_path",
    "s_outputCompletePath": "output_complete",
    "s_outputIncompletePath": "output_incomplete",
    "s_incompleteFramePath": "incomplete_frame_path",
    "s_maxNumScenes": "max_num_scenes",
    "s_maxNumSens": "max_num_sens",
    "s_renderWidth": "width",
    "s_renderHeight": "height",
    "s_voxelSize": "voxel_size",
    "s_scenePadding": "scene_padding",
    "s_heightPad": "height_pad",
    "s_chanceDropFrames": "chance_drop_frames",
    "s_bUseRenderedDepth": "use_rendered_depth",
}


def apply_param_file(args, path: str):
    """Overlay a parameter file onto an argparse namespace (file wins for
    keys present in the file; s_filterDepthMap maps to no_filter_depth)."""
    params = parse_param_file(path)
    for pkey, akey in PARAM_TO_ARG.items():
        if pkey in params and hasattr(args, akey):
            setattr(args, akey, params[pkey])
    if "s_filterDepthMap" in params:
        args.no_filter_depth = not params["s_filterDepthMap"]
    return args
