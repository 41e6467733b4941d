"""Parity of the port's non-default tracking formulations with the JAX
package: one ``odometry.track`` per mode from JAX's own ``TrackingInputs``
(64x48, two pyramid levels of two iterations, a two-frame orbit 0.01 rad
apart):
  - sparse ICP (the lambda carry and its dual update);
  - bilinear photometric lookups through the separate ``pack_model`` /
    ``pack_last`` pair (tracking_rgb_nearest=False) and through the
    36-channel joint table (tracking_joint_gather=True as well);
  - ICP only (icp_weight = 100); RGB only: icp_weight = 0, and
    ``track(rgb_only=True)`` (sigma = -1, unit weights).
The correspondence search is in test_torch_step_modes.py, the
fixed-correspondence, early-exit, subsampled, top-k and patch iterations
in test_torch_tracking_iterations.py.

Tolerances (those of test_torch_tracking.py::test_track): R within 1e-4
rad and t within 1e-4 m of JAX, the ICP and photometric counts within
rtol 1e-3 (the Gauss-Newton solve amplifies float32 rounding in the Gram
sums).  Each case also asserts that the pose moved."""

import dataclasses

import pytest
from torch_parity_utils import TRACK_CFG, check_track, tracking_pair
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

MODES = {
    "sparse_icp": (dict(icp_use_sparse=True), False),
    "bilinear_separate": (dict(tracking_rgb_nearest=False), False),
    "bilinear_joint": (dict(tracking_rgb_nearest=False, tracking_joint_gather=True), False),
    "icp_only": (dict(icp_weight=100.0), False),
    "rgb_only_weight": (dict(icp_weight=0.0), False),
    "rgb_only_flag": ({}, True),
}


@pytest.fixture(scope="module")
def pair():
    return tracking_pair()


@pytest.mark.parametrize("mode", list(MODES))
def test_track_mode(pair, mode):
    fields, rgb_only = MODES[mode]
    check_track(pair, dataclasses.replace(TRACK_CFG, **fields), rgb_only=rgb_only)
