"""Parity of the port's Gauss-Newton iteration schemes with the JAX package: one
``odometry.track`` per setting from JAX's own ``TrackingInputs`` (the
fixture and tolerances of test_torch_tracking_modes.py: 64x48, two
pyramid levels; R within 1e-4 rad, t within 1e-4 m, counts within rtol
1e-3), at pyramid_iterations=(3,2) so that the finest level has
iterations on both sides of each scheme's split:
  - fixed correspondences (tracking_reassoc_period=2: gather, reuse, ...);
  - the early exit (tracking_converge_eps=0.003 at (4,3): the finest
    level's increments are 0.0074, 0.0037, 0.0023, 0.0017 on this
    fixture, so it stops after its third iteration); the port runs the
    budget with a device-side flag, and its live iterations per level are
    held to (3, 3); also with fixed correspondences
    (tracking_converge_eps=0.0048: increments 0.0074, 0.0071, 0.0047,
    0.0046, so the fourth iteration, a reused association, is frozen);
  - subsampling (stride 2, the last iteration at full resolution);
  - top-k (k = 768, 16 per row; the last iteration at full resolution),
    the patch-anchored association (radius 1), and the two together."""

import dataclasses

import numpy as np
import pytest
from torch_parity_utils import TRACK_CFG, check_track, n, tracking_pair
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

SCHEMES = dataclasses.replace(TRACK_CFG, pyramid_iterations=(3, 2))
EPS = dict(pyramid_iterations=(4, 3), tracking_converge_eps=0.003)
EPS_REASSOC = dict(pyramid_iterations=(4, 3), tracking_converge_eps=0.0048,
                   tracking_reassoc_period=2)
TOPK = dict(tracking_topk=768, tracking_topk_full_iters=1)
MODES = {
    "reassoc": dict(tracking_reassoc_period=2),
    "converge_eps": EPS,
    "converge_eps_reassoc": EPS_REASSOC,
    "subsample": dict(tracking_subsample=2, tracking_subsample_full_iters=1),
    "topk": TOPK,
    "patch": dict(tracking_patch_assoc=True),
    "topk_patch": dict(TOPK, tracking_patch_assoc=True),
}


@pytest.fixture(scope="module")
def pair():
    return tracking_pair(saliency=True)


@pytest.mark.parametrize("mode", list(MODES))
def test_track_iterations(pair, mode):
    _, rt = check_track(pair, dataclasses.replace(SCHEMES, **MODES[mode]))
    if "tracking_converge_eps" in MODES[mode]:
        np.testing.assert_array_equal(n(rt.live_iters), [3, 3])
