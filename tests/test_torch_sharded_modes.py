"""Every tracking setting of ``chip_smoke.TRACKING_MODES`` on the row-sharded
dense step (``parallel/sharded_step.py`` -> ``odometry.track_levels``):
bootstrap, a tracked step on a compaction and crowd-rule frame, then a
replayed step, on 3- and 8-shard CPU meshes at 64x48 (a two-level pyramid:
the three-level one's deeper halos are covered by the other sharded-step
files), each state equal to
the unsharded port's bit for bit (map count and rows, the pose, every
prediction image).  The top-k modes' k is scaled to the image (the same
share of its pixels); a stride-3 subsample adds a split whose shards do
not start on the stride grid.

One case per setting holds the unsharded port's Gauss-Newton pass of that
setting (the residual functions it runs, at the tracked step's finest
level, from the port's own inputs) to the JAX package's under the
tolerances of ``test_torch_icp_modes.py``; the JAX side is one jitted
function for the file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_icp_modes import _close_corres, _close_step
from torch_parity_utils import n, t
from torch_parity_utils import unoptimized_jax  # noqa: F401 (autouse fixture)

import chip_smoke
from hrbffusion3d_tpu import config as jconfig
from hrbffusion3d_tpu.ops import icp as jicp
from hrbffusion3d_tpu.ops import pyramid as jpyr
from hrbffusion3d_tpu_torch.config import CameraIntrinsics, small_test_config
from hrbffusion3d_tpu_torch.eval import synth
from hrbffusion3d_tpu_torch.ops import icp as ticp
from hrbffusion3d_tpu_torch.ops import pyramid as tpyr
from hrbffusion3d_tpu_torch.parallel import sharded_step, sharding
from hrbffusion3d_tpu_torch.pipeline import slam
from hrbffusion3d_tpu_torch.tracking import odometry

torch.set_num_threads(1)

INTR = CameraIntrinsics(fx=52.0, fy=52.0, cx=32.0, cy=24.0, width=64, height=48)
BASE = small_test_config(map_capacity=1 << 12, new_surfels_capacity=1 << 10,
                         num_pyramid_levels=2, pyramid_iterations=(2, 1),
                         so3_iterations=1,
                         predict_conf_threshold=0.2, clean_compact_period=2,
                         clean_crowd_period=2, curv_window=2)
SCALE = (INTR.width * INTR.height) / (chip_smoke.TUM1.width * chip_smoke.TUM1.height)


def _mode(fields):
    fields = dict(fields)
    if "tracking_topk" in fields:
        fields["tracking_topk"] = int(fields["tracking_topk"] * SCALE)
    if "tracking_topk_full_iters" in fields:
        fields["tracking_topk_full_iters"] = 1
    return dataclasses.replace(BASE, **fields)


MODES = {"default": BASE, **{k: _mode(v) for k, v in chip_smoke.TRACKING_MODES.items()},
         "subsample3": dataclasses.replace(BASE, tracking_subsample=3)}


def _assert_same(ref: slam.SLAMState, got: slam.SLAMState, label: str):
    got = sharding.gather_state(got)
    assert torch.equal(ref.map.count, got.map.count), (label, int(ref.map.count),
                                                       int(got.map.count))
    assert torch.equal(ref.map.data, got.map.data), (label, "rows")
    for name in slam.SLAMState._fields:
        a, b = getattr(ref, name), getattr(got, name)
        if isinstance(a, torch.Tensor) and name != "dense_frac":
            assert a.dtype == b.dtype and torch.equal(a, b), (label, name)
        elif not isinstance(a, torch.Tensor) and name != "map":
            assert a == b, (label, name)


def _memo(mod, name, key):
    """``mod.name`` computed once per ``key(*args)``: the preprocessing of a
    frame does not depend on the tracking setting (only on the normals'
    method), so the cases share it."""
    fn, seen = getattr(mod, name), {}

    def run(frame, intr, cfg):
        k = key(frame, cfg)
        if k not in seen:
            # the frame is kept, so that its id is not reused
            seen[k] = (frame, fn(frame, intr, cfg))
        return seen[k][1]
    return fn, run


@pytest.fixture(scope="module")
def frames():
    poses = synth.orbit_trajectory(3, angle_per_frame=0.01)
    room = synth.default_room("cpu")
    fr = [slam.FrameInput(*synth.render_frame(room, p, INTR)) for p in poses]
    split = {k: [sharding.shard_frame(f, sharding.make_mesh(k, devices=["cpu"]), BASE)
                 for f in fr] for k in (3, 8)}
    fns = [(slam, *_memo(slam, "_preprocess", lambda f, c: (id(f.depth), c.normal_pca))),
           (sharded_step, *_memo(sharded_step, "_preprocess",
                                 lambda f, c: (id(f.depth), c.normal_pca)))]
    for mod, _, run in fns:
        setattr(mod, "_preprocess", run)
    yield poses, fr, split
    for mod, fn, _ in fns:
        setattr(mod, "_preprocess", fn)


@pytest.fixture(scope="module")
def unsharded(frames):
    """Per mode: the unsharded states (bootstrap, tracked, replayed) and
    the tracked step's ``TrackingInputs``."""
    poses, fr, _ = frames
    out, boots = {}, {}
    for name, cfg in MODES.items():
        calls = []
        track = odometry.track

        def spy(*args, **kwargs):
            calls.append(args)
            return track(*args, **kwargs)

        if cfg.normal_pca not in boots:
            boots[cfg.normal_pca] = slam.bootstrap(fr[0], INTR, cfg, init_pose=poses[0])
        boot = boots[cfg.normal_pca]
        odometry.track = spy
        try:
            tracked = slam.step(boot, fr[1], INTR, cfg)
        finally:
            odometry.track = track
        replayed = slam.step(tracked, fr[2], INTR, cfg, fixed_pose=poses[2])
        out[name] = (boot, tracked, replayed, calls[0])
    return out


# the stride-3 split is off the grid on 3 shards (rows 16-32, 32-48)
CASES = [(m, k) for m in MODES for k in (3, 8) if (m, k) != ("subsample3", 8)]


@pytest.mark.parametrize("mode,n_shards", CASES)
def test_mode_sharded_bit_for_bit(frames, unsharded, mode, n_shards):
    poses, _, split = frames
    cfg = MODES[mode]
    boot, tracked, replayed, _ = unsharded[mode]
    mesh = split[n_shards][0].depth.mesh
    st = sharding.shard_state(boot, mesh, cfg)
    st = slam.step(st, split[n_shards][1], INTR, cfg)
    _assert_same(tracked, st, f"{mode} tracked")
    assert not torch.equal(tracked.R, boot.R)
    st = slam.step(st, split[n_shards][2], INTR, cfg, fixed_pose=poses[2])
    _assert_same(replayed, st, f"{mode} replayed")
    assert len(st.map.data.parts) == n_shards


def test_sharded_bootstrap_bit_for_bit(frames, unsharded):
    """``bootstrap`` of a sharded frame runs per shard on an empty map."""
    poses, fr, _ = frames
    boot = unsharded["default"][0]
    for n_shards in (3, 8):
        mesh = sharding.make_mesh(n_shards, devices=["cpu"])
        st = slam.bootstrap(sharding.shard_frame(fr[0], mesh, BASE), INTR, BASE,
                            init_pose=poses[0])
        assert sharding.is_sharded(st)
        _assert_same(boot, st, f"bootstrap on {n_shards}")


# --------------------------------------------------------------------------- #
# the unsharded port's pass of each setting against JAX's
# --------------------------------------------------------------------------- #

def _passes(lib, ops, pyr, a, cfgs, k_top):
    """The Gauss-Newton pass each setting runs at the finest level, at the
    previous pose, on one side (``lib`` makes an array, ``ops`` / ``pyr``
    the side's icp and pyramid modules)."""
    a = {k: lib(v) for k, v in a.items()}
    intr, cfg = cfgs["intr"], cfgs["default"]
    R, tv = a["R"], a["t"]
    pose = (R, tv, R.T, tv)
    gx, gy = pyr.sobel_derivatives(a["next_intensity"])
    min_scale = (cfg.min_gradient_magnitudes[0] ** 2) / (cfg.sobel_scale ** 2)
    sv = ops.rgb_static_valid(a["next_intensity"], gx, gy, a["next_depth"],
                              min_scale).reshape(-1)
    joint = ops.pack_joint_nearest(a["last_vmap_g"], a["last_nmap_g"], a["icp_weight"],
                                   a["last_depth"], a["last_intensity"])
    bil = ops.pack_joint(a["last_vmap_g"], a["last_nmap_g"], a["icp_weight"], a["last_depth"],
                         a["last_intensity"])
    model = ops.pack_model(a["last_vmap_g"], a["last_nmap_g"], a["icp_weight"])
    last = ops.pack_last(a["last_depth"], a["last_intensity"])
    live = (a["next_vmap"], a["next_nmap"])
    args = (a["next_vmap"], a["next_nmap"], a["next_depth"])

    def joint_step(table, c, **kw):
        return ops.joint_step(*pose, *args, table, a["next_intensity"], sv, intr, c, **kw)[:2]

    out = {"default": joint_step(joint, cfg, nearest=True)}
    out["bilinear_joint"] = joint_step(bil, cfgs["bilinear_joint"])
    out["bilinear_separate"] = (ops.icp_step(*pose, *live, model, intr, cfg),
                                ops.rgb_residual(a["krkinv"], a["kt"], a["next_depth"],
                                                 a["next_intensity"], last, sv,
                                                 cfgs["bilinear_separate"]))
    out["corr_search"] = (ops.icp_step(*pose, *live, model, intr, cfgs["corr_search"],
                                       k1_curr=a["next_k1"], k2_curr=a["next_k2"],
                                       k1_prev=a["last_k1"], k2_prev=a["last_k2"]),)
    out["sparse_icp"] = (ops.icp_step(*pose, *live, model, intr, cfgs["sparse_icp"],
                                      sparse_lambda=a["lam"])[0],)
    out["icp_only"] = out["bilinear_separate"][:1]
    out["rgb_only"] = (ops.rgb_residual(a["krkinv"], a["kt"], a["next_depth"],
                                        a["next_intensity"], last, sv, cfg),)
    sub = ops.pack_sub_pixels(2, *args, a["next_intensity"], sv, gx, gy, intr)
    out["subsample"] = joint_step(joint, cfg, sub=sub, nearest=True)
    ids = ops.saliency_ids(k_top, *live, a["next_intensity"], sv, gx, gy, intr)
    top = ops.pack_sub_pixels(1, *args, a["next_intensity"], sv, gx, gy, intr)
    top = type(top)(*(f[ids] for f in top))
    out["topk"] = joint_step(joint, cfg, sub=top, nearest=True) + (ids,)
    vc, nc, vl = ops.joint_cur_pack(*args, intr)
    # the model normals back in the camera frame, as each side's tracker
    # rotates them
    nmap_c = (ops.mat3_apply(a["last_nmap_g"], R.T) if ops is ticp else
              (a["last_nmap_g"].reshape(-1, 3) @ R).reshape(a["last_nmap_g"].shape))
    table = ops.build_patch_table(ops.pack_patch_base(a["last_depth"], nmap_c, a["icp_weight"],
                                                      a["last_intensity"]), 1)
    patch = ops.patch_anchor(*pose, vc, table, intr)
    out["patch"] = ops.joint_step_patch(*pose, patch, 1, vc, nc, vl,
                                        a["next_intensity"].reshape(-1), sv, intr, cfg)
    return out


# settings that run another setting's pass
SAME_PASS = {"reassoc": "default", "converge_eps": "default", "central_diff_normals": "default",
             "topk_patch": "topk", "subsample3": "subsample"}


@pytest.fixture(scope="module")
def passes(unsharded):
    args = unsharded["default"][3]
    R, tv, inp = args[0], args[1], args[2]
    a = {f: n(getattr(inp, f)[0]) for f in odometry.TrackingInputs._fields
         if getattr(inp, f)}
    rng = np.random.default_rng(0)
    P = INTR.height * INTR.width
    K = np.array([[INTR.fx, 0, INTR.cx], [0, INTR.fy, INTR.cy], [0, 0, 1]], np.float32)
    a.update(R=n(R), t=n(tv), lam=(0.01 * rng.normal(size=(P, 3))).astype(np.float32),
             krkinv=(K @ np.linalg.inv(K)).astype(np.float32), kt=np.zeros(3, np.float32))
    # the live curvature maps of the correspondence search: the step's own
    curv = unsharded["corr_search"][3][2]
    for f in ("next_k1", "next_k2", "last_k1", "last_k2"):
        a[f] = n(getattr(curv, f)[0])
    k_top = MODES["topk"].tracking_topk
    names = ("bilinear_joint", "bilinear_separate", "corr_search", "sparse_icp")
    pcfgs = {"intr": INTR, "default": BASE, **{k: MODES[k] for k in names}}
    jcfgs = {"intr": jconfig.CameraIntrinsics(**dataclasses.asdict(INTR)),
             **{k: _jax_cfg(v) for k, v in pcfgs.items() if k != "intr"}}
    jfn = jax.jit(lambda arrs: _passes(jnp.asarray, jicp, jpyr, arrs, jcfgs, k_top))
    oj = jax.tree_util.tree_map(np.asarray, jfn(a))
    ot = _passes(t, ticp, tpyr, a, pcfgs, k_top)
    return oj, ot


def _jax_cfg(cfg):
    fields = {f.name for f in dataclasses.fields(jconfig.SLAMConfig)}
    return jconfig.SLAMConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                 if k in fields})


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_pass_matches_jax(passes, mode):
    oj, ot = passes
    key = SAME_PASS.get(mode, mode)
    for got, want in zip(ot[key], oj[key]):
        if isinstance(want, jicp.StepResult):
            assert float(want.count) > 100
            _close_step(got, want)
        elif isinstance(want, jicp.RGBCorres):
            _close_corres(got, want)
        else:
            np.testing.assert_array_equal(n(got), want)
