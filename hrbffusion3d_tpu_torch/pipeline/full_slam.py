"""Full SLAM system: the dense frame-to-model pipeline, the sparse keyframe
backend and the dense-map corrections (port of
``hrbffusion3d_tpu/pipeline/full_slam.py``).

The complete ``HRBFFusion::processFrame`` including the keyframe/BA sync
block (HRBFFusion.cpp:1136-1188): at a keyframe the backend inserts it,
runs local BA and loop closing, and the per-submap deltas it returns move
the dense map (UpdateDenseGlobalModel -> GlobalModel::updateModel), the
live pose and the stored trajectory (HRBFFusion.cpp:457-497).

Two modes, as in the JAX package:
  - sync: the backend runs between one frame and the next;
  - async (``async_ba=True``): keyframe insertion, local BA and loop
    closing run on a worker thread while the dense pipeline keeps
    stepping, with up to ``async_queue_depth`` keyframes queued or in
    work; corrections apply at the next frame boundary after they arrive;
    ``close`` applies what is queued and stops the worker.

Devices: one ``device`` for the whole system (None: the CUDA card, which
raises without one).  The dense state and the backend's solves live
there.  On a card the worker issues its work on a CUDA stream of its own,
so it overlaps the dense step: it waits on an event recorded after the
keyframe's inputs were made on the main thread's stream, and those input
tensors are marked as used by its stream.  Everything the worker hands
back (masks, deltas, poses) is numpy.  The solvers run in full float32 on
the worker thread whatever the main thread's TF32 setting is
(``utils.tensors.full_float32``).

Host syncs: ``process`` reads the pose back once per frame and the map
count once (``ensure_capacity``); ``process_batch`` reads one packed vector
per chunk (``slam.step_chunk``) and uses its count.  Over a group the
dense step reads each ``move_rows``' split sizes (``Mesh.host_reads``),
and async mode agrees once per frame boundary on a host integer (on the
CPU over ``gloo``: no device read).

``mesh`` (``parallel.sharding.Mesh``, its first device ``device``): the
dense state and the frames go on the mesh at ``process`` and
``process_batch`` (the surfel map's rows and the images' rows split, as
the JAX system places them) and every dense step is the row-sharded one
(``parallel/sharded_step``); local BA, sync or async, runs the
landmark-sharded solver (``parallel/dist_ba``) on the mesh's shards.  The
keyframe inputs (``_kf_inputs``) read the frame gathered
(``sharding.gather_frame``); the active-window exchange
(``sharded_step.exchange_active``: only the rows that leave are
gathered, the archive is whole), map growth (``sharded_step.grow``: rows
move to their new owners), the corrections and the activity refresh run
per shard.  ``full_map`` is the one path that gathers the whole map
(``sharded_step.whole_map``): an export.

Over a process group (``mesh=multihost.global_mesh(...)`` on every
process, after ``multihost.initialize``): every process runs this class on
the same frames, passing each whole frame or stack (``_frame`` keeps its
own shards' rows, as ``sharding.shard_frame`` does; a frame stack is split
by image rows, never by frames, so ``multihost.host_local_batch`` stacks
are not taken).  The dense step's collectives run over the mesh's group.
The keyframe backend is replicated: every process inserts the same
keyframe (the frame all-gathered), builds the same local-BA problem and
solves it landmark-sharded over a second group of the same processes
(``multihost.same_ranks_group``, made here, so that the async worker's
collectives never share a group with the dense step's); loop closing
runs whole on every process.  After each keyframe boundary every process
checks that it holds what the others do (``multihost.check_replicas`` of
the keyframe's id and pose, the covisibility mask, local BA's deltas and
the loop's pair and deltas), and raises on every process if not.  Async:
at every frame boundary, and in ``join_backend`` / ``close``, the
processes agree on how many finished keyframe results each holds
(``multihost.agree_min``) and each applies exactly that many, in keyframe
order, so that a correction applies at the same frame on every process
and the keyframe cadence (``_inflight``) follows equally.  Files
(``save_trajectory_tum``, ``save_map_ply``, ``utils.checkpoint.save``)
are written by the group's process 0 only, between barriers.
Not ported: the JAX package's device-placement options
(``backend_on_cpu``, ``ba_on_chip``, ``plan_cache_path``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time as _time
import warnings

import numpy as np
import torch

from ..backend.keyframes import SparseBackend
from ..backend.loop import LoopCloser
from ..config import CameraIntrinsics, SLAMConfig
from ..core import lie
from ..map import surfel_map as sm
from ..ops import preprocess, pyramid
from ..parallel import multihost, sharded_step, sharding
from ..utils.tensors import const, device_or_card, host
from . import slam

_EYE4 = np.eye(4, dtype=np.float32)


class FullSLAM:
    """MainController + HRBFFusion equivalent: a host loop over the dense
    step with the sparse backend at the keyframe boundaries."""

    def __init__(self, intr: CameraIntrinsics, cfg: SLAMConfig,
                 backend_kwargs: dict | None = None, init_pose=None,
                 loop_kwargs: dict | None = None, async_ba: bool = False,
                 mesh=None, async_queue_depth: int = 2, device=None):
        self.device = device_or_card(device)
        if mesh is not None and not isinstance(mesh, sharding.Mesh):
            raise TypeError(f"mesh must be a parallel.sharding.Mesh, not {type(mesh).__name__}")
        if mesh is not None and sharding.concrete_device(self.device) != mesh.home:
            raise ValueError(f"the mesh's first device {mesh.home} is not the system's "
                             f"device {self.device}")
        self.mesh = mesh
        # the process group the mesh spans, or None
        self._group = mesh.group if mesh is not None else None
        self.intr = intr
        self.cfg = cfg
        self.init_pose = init_pose
        self.state: slam.SLAMState | None = None
        bk = dict(backend_kwargs or {})
        # BA padding buckets pre-sized for a production-scale run
        nf = bk.get("n_features", 1024)
        bk.setdefault("ba_pad_min", (16 * nf, 8 * nf, 32))
        if mesh is not None and "mesh" not in bk:
            # over a group the backend's collectives get a group of their
            # own, made here in the same order on every process
            bk["mesh"] = (mesh if self._group is None
                          else mesh.with_group(multihost.same_ranks_group(self._group)))
        self.backend = SparseBackend(intr, cfg, device=self.device, **bk)
        self.loop_closer = (LoopCloser(self.backend, **(loop_kwargs or {}))
                            if cfg.use_global_ba else None)
        self.trajectory: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.kf_of_frame: list[int] = []
        self.loop_closures: list[tuple[int, int]] = []
        # active-window/archive split (cfg.active_capacity > 0): surfels of
        # inactive submaps live in the archive, outside the per-frame map
        self.archive: sm.SurfelMap | None = None
        self.archive_dropped = 0
        self._archive_count = 0       # host mirror of archive.count
        self._active_count = None     # host mirror of map.count after an exchange
        # host mirror of state.active_submaps (np bool): after an exchange
        # the archive holds only submaps outside it, so a correction whose
        # moved submaps all lie inside it skips the archive pass, and the
        # async enqueue never copies the mask back from the card
        self._active_mask_host: np.ndarray | None = None
        # wall seconds per stage, cumulative (the worker's are "w_*")
        self.stage_s: dict = {}

        self.async_ba = async_ba
        # keyframes queued or in work at once (LocalMapping's queue,
        # LocalMapping.cc:55-107); a busy worker delays keyframes
        self.async_queue_depth = async_queue_depth
        self._pending_fixes: dict = {}
        self._last_kf_time = -(10 ** 9)
        self._inflight = 0
        # next keyframe id, reserved at enqueue time (the worker asserts the
        # backend assigned exactly it)
        self._next_kf_id = 0
        self.async_corrections = 0
        # (the state's time at the frame boundary, keyframe id) of every
        # async keyframe result applied
        self.async_applied: list[tuple[int, int]] = []
        # results taken from the worker and not yet applied (over a group
        # they wait until every process holds them)
        self._finished: list = []
        self._fix_lock = threading.Lock()
        if async_ba:
            # the worker's own CUDA stream (None on the CPU)
            self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                            else None)
            self._kf_queue: queue.Queue = queue.Queue()
            self._result_queue: queue.Queue = queue.Queue()
            self._worker = threading.Thread(target=self._ba_worker, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------ #
    def _tick(self, key: str, t0: float) -> float:
        t1 = _time.perf_counter()
        self.stage_s[key] = self.stage_s.get(key, 0.0) + (t1 - t0)
        return t1

    def _ba_worker(self):
        """LocalMapping::Run + LoopClosing::Run equivalent (worker thread).
        A failure is handed to the main thread, which raises it."""
        stream = self._stream
        while True:
            item = self._kf_queue.get()
            if item is None:
                return
            try:
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    self._result_queue.put(self._process_keyframe(stream, *item))
            except Exception as e:  # noqa: BLE001 -- handed to the main thread, which raises it
                self._result_queue.put(e)
                return

    def _process_keyframe(self, stream, intensity, depth_f, pose, time, reserved_id, ready):
        t0 = _time.perf_counter()
        if ready is not None:
            stream.wait_event(ready)
        # corrections applied since this keyframe was enqueued moved the map
        # under it: it rides the same per-submap delta as the live pose
        with self._fix_lock:
            fix = self._pending_fixes.pop(reserved_id, None)
        if fix is not None:
            pose = (fix @ pose).astype(np.float32)
        kf_id = self.backend.insert_keyframe(intensity, depth_f, pose, time)
        assert kf_id == reserved_id, (
            f"keyframe id drift: reserved {reserved_id}, backend assigned {kf_id}")
        t0 = self._tick("w_kf_insert", t0)
        mask = self.backend.active_submap_mask(kf_id, self.cfg.max_submaps)
        t0 = self._tick("w_covis_mask", t0)
        deltas = self.backend.local_ba()
        t0 = self._tick("w_local_ba", t0)
        loop = None
        if self.loop_closer is not None:
            cand = self.loop_closer.add_keyframe(kf_id)
            if cand is not None:
                loop = (self.loop_closer.correct(cand), cand)
        self._tick("w_loop", t0)
        return kf_id, self.backend.keyframes[kf_id].pose.copy(), mask, deltas, loop

    def _check_keyframe(self, kf_id, kf_pose, mask, deltas, loop) -> None:
        """Over a group: raise on every process unless all hold the same
        keyframe boundary (id, pose, covisibility mask, local BA's deltas,
        the loop's pair and deltas; ``loop`` is (deltas, candidate) or
        None)."""
        if self._group is None:
            return
        closed = None if loop is None else (loop[1].match_kf, loop[1].query_kf, loop[0])
        multihost.check_replicas(f"keyframe {kf_id} (id, pose, covisibility mask, local BA "
                                 "deltas, loop pair and deltas)",
                                 [kf_id, kf_pose, mask, deltas, closed], self._group)

    def _drain_async_results(self, block: bool = False):
        """Apply finished BA / loop corrections at a frame boundary: over a
        group exactly as many as every process holds (``agree_min``), in
        keyframe order.  ``block``: wait for a result first when none has
        finished here."""
        if block and not self._finished:
            self._finished.append(self._result_queue.get())
        while True:
            try:
                self._finished.append(self._result_queue.get_nowait())
            except queue.Empty:
                break
        for item in self._finished:
            if isinstance(item, Exception):
                raise RuntimeError("the keyframe worker failed") from item
        n = len(self._finished)
        if self._group is not None:
            n = multihost.agree_min(n, self._group)
        ready, self._finished = self._finished[:n], self._finished[n:]
        for kf_id, kf_pose, mask, deltas, loop in ready:
            self._check_keyframe(kf_id, kf_pose, mask, deltas, loop)
            self._inflight -= 1
            self._refresh_active(mask)
            if deltas is not None:
                self._apply_correction(deltas, kf_id)
                self.async_corrections += 1
            if loop is not None:
                loop_deltas, cand = loop
                self._apply_correction(loop_deltas, kf_id)
                self.loop_closures.append((cand.match_kf, cand.query_kf))
            self.async_applied.append((self.state.time, kf_id))

    def join_backend(self):
        """Block until every queued keyframe is processed and applied (over
        a group: on every process, applied as the processes agree)."""
        if not self.async_ba:
            return
        while self._inflight > 0:
            self._drain_async_results(block=True)

    def close(self):
        """Process and apply every queued keyframe, then stop the keyframe
        worker (async; a no-op otherwise).  The system takes no frame
        after it."""
        if not self.async_ba or not self._worker.is_alive():
            return
        self.join_backend()
        self._kf_queue.put(None)
        self._worker.join()

    def _enqueue_keyframe(self, frame: slam.FrameInput, pose: np.ndarray, time: int):
        """Hand a keyframe to the worker: its id is reserved, its submap is
        active at once (its surfels fuse under it before the worker's
        covisibility mask arrives)."""
        intensity, depth_f = self._kf_inputs(frame)
        ready = None
        if self._stream is not None:
            # the worker's stream waits for the inputs, and their memory is
            # not reused before its work on them is done
            ready = torch.cuda.Event()
            ready.record()
            intensity.record_stream(self._stream)
            depth_f.record_stream(self._stream)
        kf_id = self._next_kf_id
        self._last_kf_time = time
        self._inflight += 1
        with self._fix_lock:
            self._pending_fixes[kf_id] = _EYE4.copy()
        act = self._active_mask_host.copy()
        act[kf_id] = True
        self._active_mask_host = act
        self.state = self.state._replace(submap_idx=kf_id,
                                         active_submaps=const(act, self.device, torch.bool))
        self._next_kf_id += 1
        self._kf_queue.put((intensity, depth_f, pose, time, kf_id, ready))

    # ------------------------------------------------------------------ #
    def _refresh_active(self, mask) -> None:
        """Push a new covisible-keyframe set into the dense map: the cached
        per-surfel ACT channel (single-map mode) or a full active <->
        archive exchange (cfg.active_capacity > 0)."""
        cfg = self.cfg
        self._active_mask_host = np.array(mask, dtype=bool)
        mask_t = const(self._active_mask_host, self.device, torch.bool)
        if cfg.active_capacity <= 0:
            self.state = self.state._replace(
                active_submaps=mask_t,
                map=sharded_step.refresh_active_channel(self.state.map, mask_t))
            return
        if self.archive is None:
            self.archive = sm.empty_map(max(cfg.archive_capacity, cfg.active_capacity),
                                        self.device)
        # grow BEFORE the exchange: a worst-case exchange moves the whole
        # active window out
        cap_r = self.archive.data.shape[0]
        need = self._archive_count + cfg.map_capacity
        if need > 0.75 * cap_r:
            new_cap = cap_r
            while need > 0.75 * new_cap:
                new_cap *= 2
            self.archive = sm.grow(self.archive, new_cap)
        exchange = (sharded_step.exchange_active if sharding.is_sharded(self.state)
                    else sm.exchange_active)
        act2, arch2, stats = exchange(self.state.map, self.archive, mask_t, self.state.time, cfg)
        self.state = self.state._replace(map=act2, active_submaps=mask_t)
        self.archive = arch2
        # one packed host read per exchange
        n_active, n_archive, dropped = (int(x) for x in host(stats))
        self._active_count = n_active
        self._archive_count = n_archive
        if dropped > 0:
            warnings.warn(f"archive exchange dropped {dropped} surfels (capacity overflow); "
                          f"pre-size cfg.archive_capacity", RuntimeWarning)
        self.archive_dropped += dropped

    def full_map(self) -> sm.SurfelMap:
        """Merged active + archive map (exports / evaluation), whole on the
        system's device: the one path that gathers a sharded map (over a
        group every process calls it)."""
        active = (sharded_step.whole_map(self.state.map) if sharding.is_sharded(self.state)
                  else self.state.map)
        if self.archive is None:
            return active
        merged = torch.cat([active.data[:int(active.count)],
                            self.archive.data[:int(self.archive.count)]])
        data = torch.zeros((max(merged.shape[0], 1), sm.N_CHANNELS), dtype=torch.float32,
                           device=self.device)
        data[:merged.shape[0]] = merged
        return sm.SurfelMap(data=data, count=torch.tensor(merged.shape[0], dtype=torch.int32,
                                                          device=self.device))

    # ------------------------------------------------------------------ #
    def _kf_inputs(self, frame: slam.FrameInput):
        """Keyframe-side inputs: intensity and the re-filtered depth
        (PreProcessFrame, HRBFFusion.cpp:578-594), with the shader-form
        bilateral filter as the JAX package's keyframe path; a sharded frame
        is gathered first."""
        frame = sharding.gather_frame(frame)
        depth_f = (preprocess.bilateral_filter(frame.depth, self.cfg)
                   if self.cfg.use_bilateral_filter else frame.depth)
        return pyramid.rgb_to_intensity(frame.rgb), depth_f

    def _frame(self, frame: slam.FrameInput) -> slam.FrameInput:
        """A frame (or a stack of frames) on the device, split over the
        mesh when there is one."""
        if sharding.is_sharded(frame):
            return frame
        frame = slam.FrameInput(const(frame.depth, self.device), const(frame.rgb, self.device))
        if self.mesh is None:
            return frame
        split = sharding.shard_frame_batch if frame.depth.dim() == 3 else sharding.shard_frame
        return split(frame, self.mesh, self.cfg)

    def _pose_host(self) -> np.ndarray:
        return host(lie.rt_to_mat(self.state.R, self.state.t))

    def process(self, frame: slam.FrameInput, timestamp: float = 0.0,
                fixed_pose=None) -> np.ndarray:
        """One frame; returns the current pose (4,4).  ``fixed_pose``:
        optional (4,4) camera-to-world pose, replay mode
        (globalInputLoadTrajectory): tracking is skipped, the frame fuses
        at this pose."""
        cfg = self.cfg
        frame = self._frame(frame)
        fused_submap = None
        if self.state is None:
            self.state = slam.bootstrap(
                frame, self.intr, cfg,
                init_pose=fixed_pose if fixed_pose is not None else self.init_pose)
            self._active_mask_host = np.ones((cfg.max_submaps,), bool)
            pose = self._pose_host()
            if cfg.use_local_ba:
                kf_id = self.backend.insert_keyframe(*self._kf_inputs(frame), pose,
                                                     time=self.state.time)
                self._next_kf_id = kf_id + 1
                self._last_kf_time = self.state.time
                if self.loop_closer is not None:
                    self.loop_closer.add_keyframe(kf_id)
                self.state = self.state._replace(submap_idx=kf_id)
        else:
            self.state = slam.step(self.state, frame, self.intr, cfg, fixed_pose=fixed_pose)
            pose = self._pose_host()
            time = self.state.time
            # the submap this frame's surfels fused under (before any insert)
            fused_submap = self.state.submap_idx
            if self.async_ba and cfg.use_local_ba:
                self._drain_async_results()
                if (self._inflight < self.async_queue_depth
                        and time - self._last_kf_time >= cfg.keyframe_period):
                    self._enqueue_keyframe(frame, pose, time)
            elif cfg.use_local_ba and self.backend.need_new_keyframe(time):
                kf_id = self.backend.insert_keyframe(*self._kf_inputs(frame), pose, time)
                self._next_kf_id = kf_id + 1
                self._last_kf_time = time
                # the covisible keyframe set masks dense prediction, fusion
                # and cleaning (HRBFFusion.cpp:1160-1170)
                mask = self.backend.active_submap_mask(kf_id, cfg.max_submaps)
                self.state = self.state._replace(submap_idx=kf_id)
                self._refresh_active(mask)
                deltas = self.backend.local_ba()
                if deltas is not None:
                    self._apply_correction(deltas, kf_id)
                    pose = self._pose_host()
                loop = None
                if self.loop_closer is not None:
                    cand = self.loop_closer.add_keyframe(kf_id)
                    if cand is not None:
                        loop = (self.loop_closer.correct(cand), cand)
                        self._apply_correction(loop[0], kf_id)
                        pose = self._pose_host()
                        self.loop_closures.append((cand.match_kf, cand.query_kf))
                self._check_keyframe(kf_id, self.backend.keyframes[kf_id].pose, mask, deltas,
                                     loop)

        # capacity bucketing: double the map between frames when nearly full
        self.state, self.cfg = slam.ensure_capacity(self.state, self.cfg)
        self.trajectory.append(pose)
        self.timestamps.append(timestamp)
        # tagged with the submap its surfels fused under
        self.kf_of_frame.append(fused_submap if fused_submap is not None
                                else self.state.submap_idx)
        return pose

    # ------------------------------------------------------------------ #
    def process_batch(self, frames: slam.FrameInput, timestamps=None) -> np.ndarray:
        """Process a stack of frames (leading frame axis) in chunks that end
        at the keyframe cadence (``slam.step_chunk``, one host read per
        chunk), with the backend at the chunk boundaries.  Returns the
        (N,4,4) poses of the batch's frames."""
        cfg = self.cfg
        frames = self._frame(frames)
        n = frames.depth.shape[0]
        if timestamps is None:
            t0 = self.timestamps[-1] + 1 if self.timestamps else 0
            timestamps = [float(t0 + i) for i in range(n)]
        i = 0
        if self.state is None:
            self.process(slam.FrameInput(frames.depth[0], frames.rgb[0]),
                         timestamp=timestamps[0])
            i = 1
        while i < n:
            if cfg.use_local_ba:
                until_kf = cfg.keyframe_period - (self.state.time - self._last_kf_time)
                k = min(n - i, max(1, until_kf))
            else:
                k = min(n - i, cfg.keyframe_period)
            chunk = slam.FrameInput(frames.depth[i:i + k], frames.rgb[i:i + k])
            t0 = _time.perf_counter()
            self.state, packed = slam.step_chunk(self.state, chunk, self.intr, cfg)
            packed = host(packed)
            poses = packed[:k * 16].reshape(k, 4, 4)
            live_count = int(packed[k * 16])
            self._tick("dense_scan", t0)
            kf_idx = self.state.submap_idx
            for j in range(k):
                self.trajectory.append(poses[j])
                self.timestamps.append(timestamps[i + j])
                self.kf_of_frame.append(kf_idx)
            i += k

            time = self.state.time
            if cfg.use_local_ba and time - self._last_kf_time >= cfg.keyframe_period:
                last = slam.FrameInput(frames.depth[i - 1], frames.rgb[i - 1])
                pose = poses[-1]
                if self.async_ba:
                    t0 = _time.perf_counter()
                    self._drain_async_results()
                    t0 = self._tick("drain", t0)
                    # a drained exchange changed the live count
                    if cfg.active_capacity > 0 and self._active_count is not None:
                        live_count = self._active_count
                    if self._inflight < self.async_queue_depth:
                        self._enqueue_keyframe(last, pose, time)
                        self._tick("kf_enqueue", t0)
                else:
                    live_count = self._keyframe_sync(last, pose, time, live_count)
            self.state, self.cfg = slam.ensure_capacity(self.state, self.cfg, count=live_count)
            cfg = self.cfg
        return np.stack(self.trajectory[-n:])

    def _keyframe_sync(self, frame: slam.FrameInput, pose: np.ndarray, time: int,
                       live_count: int) -> int:
        """process_batch's synchronous keyframe boundary; returns the live
        map count after it."""
        cfg = self.cfg
        t0 = _time.perf_counter()
        kf_id = self.backend.insert_keyframe(*self._kf_inputs(frame), pose, time)
        t0 = self._tick("kf_insert", t0)
        self._next_kf_id = kf_id + 1
        self._last_kf_time = time
        mask = self.backend.active_submap_mask(kf_id, cfg.max_submaps)
        t0 = self._tick("covis_mask", t0)
        deltas = self.backend.local_ba()
        t0 = self._tick("local_ba", t0)
        cand = self.loop_closer.add_keyframe(kf_id) if self.loop_closer is not None else None
        loop_deltas = self.loop_closer.correct(cand) if cand is not None else None
        t0 = self._tick("loop", t0)
        self.state = self.state._replace(submap_idx=kf_id)
        self._refresh_active(mask)
        t0 = self._tick("refresh_active", t0)
        if deltas is not None:
            self._apply_correction(deltas, kf_id)
        if loop_deltas is not None:
            self._apply_correction(loop_deltas, kf_id)
            self.loop_closures.append((cand.match_kf, cand.query_kf))
        self._tick("corrections", t0)
        self._check_keyframe(kf_id, self.backend.keyframes[kf_id].pose, mask, deltas,
                             None if loop_deltas is None else (loop_deltas, cand))
        # the exchange's packed stats carried the fresh count
        return self._active_count if cfg.active_capacity > 0 else live_count

    # ------------------------------------------------------------------ #
    def _apply_correction(self, deltas: np.ndarray, current_kf: int):
        """UpdateDenseGlobalModel: per-submap rigid correction of the dense
        map, the live pose and the recorded trajectory, only where a delta
        is not the identity:
          - an all-identity delta set changes nothing;
          - the archive pass runs only when a moved submap is archived
            (outside the covisible mask, the invariant the exchange keeps);
          - the trajectory rewrite is one vectorized product over the
            frames whose submap moved."""
        deltas = np.asarray(deltas, np.float32)
        D = deltas.shape[0]
        nonid = np.abs(deltas - _EYE4).reshape(D, 16).max(1) > 1e-7
        if not nonid.any():
            return
        pad = np.tile(_EYE4, (self.cfg.max_submaps, 1, 1))
        pad[:D] = deltas
        pad_dev = const(pad, self.device)
        self.state = self.state._replace(
            map=sharded_step.apply_submap_deltas(self.state.map, pad_dev))
        if self.archive is not None and self._archive_count > 0:
            mask = self._active_mask_host
            arch_moved = nonid if mask is None else nonid & ~mask[:D]
            if np.any(arch_moved):
                self.archive = sm.apply_submap_deltas(self.archive, pad_dev)
        # the live pose rides its keyframe's correction, and so do the
        # poses of keyframes enqueued but not yet inserted
        d = deltas[current_kf] if current_kf < D else _EYE4
        if self._pending_fixes:
            with self._fix_lock:
                for k in self._pending_fixes:
                    self._pending_fixes[k] = (d @ self._pending_fixes[k]).astype(np.float32)
        pose = d @ self._pose_host()
        self.state = self.state._replace(R=const(pose[:3, :3], self.device),
                                         t=const(pose[:3, 3], self.device))
        # rewrite the trajectory of the frames whose submap moved
        # (HRBFFusion.cpp:457-497)
        if self.trajectory:
            kf = np.asarray(self.kf_of_frame)
            sel = (kf >= 0) & (kf < D)
            sel[sel] = nonid[kf[sel]]
            if sel.any():
                traj = np.stack(self.trajectory)
                traj[sel] = np.einsum("nij,njk->nik", deltas[kf[sel]], traj[sel]
                                      ).astype(np.float32)
                self.trajectory = list(traj)

    # ------------------------------------------------------------------ #
    def poses(self) -> np.ndarray:
        return np.stack(self.trajectory) if self.trajectory else np.zeros((0, 4, 4))

    def save_trajectory_tum(self, path: str):
        """The trajectory as TUM text (over a group: written by process 0,
        between barriers)."""
        from ..io import traj

        multihost.barrier(self._group)
        if multihost.is_coordinator(self._group):
            traj.save_tum(path, self.timestamps, self.poses())
        multihost.barrier(self._group)

    def save_map_ply(self, path: str, conf_threshold: float = 0.0) -> int:
        """The merged map as PLY; returns the surfels written (over a group
        every process gathers the map and process 0 writes it, between
        barriers)."""
        from ..io import ply

        m = self.full_map()
        n = int((m.data[:int(m.count), sm.CONF] >= conf_threshold).sum())
        multihost.barrier(self._group)
        if multihost.is_coordinator(self._group):
            n = ply.save_ply(path, m, conf_threshold)
        multihost.barrier(self._group)
        return n
