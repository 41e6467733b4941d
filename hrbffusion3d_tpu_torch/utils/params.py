"""Text parameter-file parsing (the port's own copy of
``hrbffusion3d_tpu/utils/params.py``, targeting the port's ``SLAMConfig``).

Replaces ``Core/src/Utils/parameterFile.h`` + the GlobalStateParam singleton
load: parses the reference's ``GlobalStateParam.txt`` 'key = value;' format
and maps the reference's parameter names onto :class:`SLAMConfig` fields so
existing configs keep working.
"""

from __future__ import annotations

import dataclasses
import re

from ..config import SLAMConfig

# referenceName -> (SLAMConfig field, converter)
_NAME_MAP = {
    "preprocessingUsebilateralFilter": ("use_bilateral_filter", bool),
    "preprocessingInitRadiusMultiplier": ("radius_multiplier", float),
    "preprocessingCurvEstimationWindow": ("curv_window", lambda v: int(float(v))),
    "preprocessingCurvValidThreshold": ("curv_valid_threshold", float),
    "preprocessingNormalEstimationPCA": ("normal_pca", lambda v: float(v) > 0),
    "preprocessingUseConfEval": ("use_conf_eval", lambda v: float(v) > 0),
    "preprocessingConfEvalEpsilon": ("conf_eval_epsilon", float),
    "registrationPreAlignSO3": ("so3_prealign", bool),
    "registrationJointICPWeight": ("icp_weight", float),
    "registrationICPUseCoorespondenceSearch": ("icp_use_correspondence_search", bool),
    "registrationICPNeighborSearchRadius": ("icp_search_radius", lambda v: int(float(v))),
    "registrationICPUseWeightedICP": ("icp_use_weighted", bool),
    "registrationICPCurvWeightImpactControl": ("icp_curv_weight_lambda", float),
    "registrationColorUseRGBGrad": ("rgb_use_gradient_weight", bool),
    "preictionWindowMultiplier": ("predict_window_multiplier", lambda v: int(float(v))),
    "preictionMinNeighbors": ("predict_min_neighbors", lambda v: int(float(v))),
    "preictionMaxNeighbors": ("predict_max_neighbors", lambda v: int(float(v))),
    "preictionConfThreshold": ("predict_conf_threshold", float),
    "fusionMergeWindowMultiplier": ("fuse_window_multiplier", lambda v: int(float(v))),
    "fusionCleanWindowMultiplier": ("clean_window_multiplier", lambda v: int(float(v))),
    "globalConfidenceThreshold": ("confidence_threshold", float),
    "globalDenseEnoughThresh": ("dense_enough_threshold", float),
    "globalDepthCutoff": ("depth_cutoff", float),
    "optimizationUseLocalBA": ("use_local_ba", bool),
    "optimizationUseGlobalBA": ("use_global_ba", bool),
}


def _parse_value(raw: str):
    raw = raw.strip().rstrip(";").strip()
    if raw.startswith('"') and raw.endswith('"'):
        return raw[1:-1]
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return float(raw)
    except ValueError:
        return raw


def parse_parameter_file(path: str) -> dict:
    """'key = value;' lines, '#'/'//' comments (parameterFile.h grammar)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].split("//")[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            out[key.strip()] = _parse_value(val)
    return out


def config_from_parameter_file(path: str, base: SLAMConfig | None = None) -> SLAMConfig:
    base = base or SLAMConfig()
    params = parse_parameter_file(path)
    updates = {}
    for ref_name, value in params.items():
        if ref_name in _NAME_MAP:
            field, conv = _NAME_MAP[ref_name]
            if conv is bool and isinstance(value, bool):
                updates[field] = value
            else:
                updates[field] = conv(value)
    return dataclasses.replace(base, **updates)
