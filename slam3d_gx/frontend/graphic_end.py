"""Host SLAM state machine: GraphicEnd (planes) and GraphicEnd2 (image-only).

Imperative shell around the jitted pipeline (pipeline.py). Replicates the
reference's per-frame control flow branch-for-branch:

- GraphicEnd::run (reference src/GraphicEnd.cpp:150-264): lost handling
  with last-frame rescue, keyframe decision at max_pos_change, loop
  closure, lost counter -> lostRecovery;
- generateKeyFrame edges with information diag(100) and optional odometry
  edges at 1/sigma^2 (src/GraphicEnd.cpp:304-351);
- loopClosure: deterministic -3/-4 checks + `loopclosure_frames` random
  draws over keyframes[0..size-4], dedup via `checked`
  (src/GraphicEnd.cpp:685-762);
- lostRecovery: unconstrained vertex + all-history scan or odometry edge
  (src/GraphicEnd.cpp:764-838);
- findMoreLoops/check/checknearby post-hoc loop expansion
  (src/GraphicEnd.cpp:864-947);
- saveFinalResult: findMoreLoops -> optimize(optimize_step) ->
  keyframe.txt + final_after.g2o (src/GraphicEnd.cpp:661-682);
- logs: error_of_transform.log (9999 = lost), lc.txt, lost.txt
  (src/GraphicEnd.cpp:153,176,775,861).

Deliberate deltas (documented):
- RNG is seeded (config `seed`) instead of srand(time(0));
- the debug imshow/waitKey UI is headless (step_time is accepted and
  ignored); lc.txt and the logs carry the same information.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ParameterReader
from ..geometry import se3
from ..io import images, pcd, tum
from ..ops import pointcloud
from . import pipeline
from .state import FrameFeatures, Keyframe, result_to_host

INFO_VISUAL = np.diag([100.0] * 6)


class GraphicEnd:
    """Plane-feature SLAM frontend."""

    image_only = False

    def __init__(self, params: Optional[ParameterReader] = None, data_dir: str = "./data"):
        self.params = params if params is not None else ParameterReader("./parameters.yaml")
        p = self.params
        self.data_dir = data_dir
        self.intr = p.intrinsics

        self.detector_name = p.GetPara("detector_name")
        self.descriptor_name = p.GetPara("descriptor_name")
        self.start_index = p.get_int("start_index")
        self.step_time = p.get_int("step_time")  # accepted, headless
        self.distance_threshold = p.get_float("distance_threshold")
        self.error_threshold = p.get_float("error_threshold")
        self.min_error_plane = p.get_float("min_error_plane")
        self.match_min_dist = p.get_float("match_min_dist")
        self.percent = p.get_float("plane_percent")
        self.max_pos_change = p.get_float("max_pos_change")
        self.max_planes = p.get_int("max_planes")
        self.loopclosure_frames = p.get_int("loopclosure_frames")
        self.loop_closure_detection = p.get_bool("loop_closure_detection")
        self.loop_closure_error = p.get_float("loop_closure_error")
        self.loop_closure_inliers = p.get_int("loop_closure_inliers")
        self.lost_frames = p.get_int("lost_frames")
        self.use_odometry = p.get_bool("use_odometry")
        self.error_odometry = p.get_float("error_odometry")
        self.z_filter = p.get_float("z_filter")
        self.grid_leaf = p.get_float("grid_leaf")
        self.max_kp = p.get_int("max_keypoints")
        self.hypotheses = p.get_int("ransac_hypotheses")
        self.seed = p.get_int("seed")
        self.cloud_capacity = p.get_int("cloud_capacity")
        self.voxel_downsample_clouds = p.get_bool("voxel_downsample_clouds")
        self.plane_image_mode = p.GetPara("plane_image_mode")
        self.detect_scope = p.GetPara("detect_scope")
        self.frame_kp_budget = p.get_int("frame_kp_budget")
        self.align_cloud_scale = p.get_bool("align_cloud_scale")

        self.rgb_path, self.dep_path, self.pcl_path = tum.dataset_paths(
            p.GetPara("data_source")
        )

        self._rng = random.Random(self.seed)
        self._key = jax.random.PRNGKey(self.seed)
        self.mesh = self._make_mesh(p.get_int("mesh_devices"))
        self._build_pipeline()
        self.lcdb = None  # built lazily when loop_closure_scored is on
        self.kf_store = None  # device-resident keyframe features

        # state
        self.robot = np.eye(4)
        self.kf_pos = np.eye(4)
        self.keyframes: List[Keyframe] = []
        self.curr_kf: Optional[Keyframe] = None
        self.present: Optional[FrameFeatures] = None
        self.last: Optional[FrameFeatures] = None
        self.last_frame_index = 0
        self.lost = 0
        self.index = self.start_index
        self.odometry: List[np.ndarray] = []
        self.odo_this = np.eye(4)
        self.odo_last = np.eye(4)
        self._errorfile = None
        self._lcfile = None
        self._pending_lc = []  # async loop-closure rounds awaiting drain
        # drain lazily: nothing in the frontend reads loop edges before
        # lostRecovery/finalize, so rounds accumulate and are resolved in
        # batched transfers once this many are pending (each drain is at
        # least one host sync, which would otherwise stall the frame loop
        # every frame)
        self.lc_drain_threshold = 24
        self._check_cache = {}  # (k1,k2) -> (passed, T) pair verdicts
        self.lc_max_drift = p.get_float("loop_closure_max_drift")
        self.finalize_prefilter = p.get_int("finalize_prefilter")
        self._kf_pose = {}  # kf id -> running frontend pose at promotion

    # -- construction ------------------------------------------------------
    def _make_mesh(self, n: int):
        """Deployed multi-chip: `mesh_devices: N` builds the (dp, sp)
        mesh every sharded component below consumes. 0 = single device
        (no mesh, no code fork); -1 = all visible devices."""
        if n == 0 or (n == -1 and len(jax.devices()) == 1):
            return None
        if n > len(jax.devices()):
            # make_mesh would silently truncate to the available
            # devices — surface the misconfiguration instead
            raise ValueError(
                f"mesh_devices={n} but only {len(jax.devices())} jax "
                f"device(s) are visible")
        from ..parallel import mesh as mesh_mod

        return mesh_mod.make_mesh(None if n == -1 else n)

    def _build_pipeline(self):
        self.extract = pipeline.build_plane_extractor(
            self.detector_name, self.descriptor_name, self.intr,
            max_planes=self.max_planes, max_kp=self.max_kp,
            dist_thresh=self.distance_threshold, percent=self.percent,
            hypotheses=self.hypotheses,
            plane_image_mode=self.plane_image_mode,
            detect_scope=self.detect_scope,
            frame_kp_budget=self.frame_kp_budget,
        )
        from ..ops.features import registry as feat_registry

        floor = feat_registry.match_floor(self.descriptor_name)
        self.multipnp = pipeline.build_multipnp_planes(
            self.intr, error_threshold=self.error_threshold,
            hypotheses=self.hypotheses, match_floor=floor,
            refine_mode=self.params.GetPara("pnp_refine_mode"),
        )
        self.batch_registrar = self._make_batch_registrar(image_only=False)

    def _make_batch_registrar(self, image_only: bool):
        """Batched loop-closure/recovery verifier (parallel fan-out); the
        `loop_closure_batched` knob (default on) restores the reference's
        sequential per-candidate checks when 0."""
        if self.params.get_int("loop_closure_batched") == 0:
            return None
        from ..parallel.registration import BatchedRegistrar

        from ..ops.features import registry as feat_registry

        return BatchedRegistrar(
            self.intr, image_only=image_only,
            error_threshold=self.error_threshold,
            hypotheses=self.hypotheses,
            mesh=self.mesh,
            match_floor=feat_registry.match_floor(self.descriptor_name),
        )

    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _register_keyframe(self, kf: Keyframe):
        self.keyframes.append(kf)
        if self.batch_registrar is not None:
            # device-resident feature store: candidate batches come from
            # ONE fixed-shape jitted gather instead of eager stacks whose
            # shapes (and XLA programs) grow with the keyframe count
            if self.kf_store is None:
                from ..parallel.registration import FeatureStore

                self.kf_store = FeatureStore(kf.features)
            self.kf_store.add(kf.features)
        if (self.params.get_int("loop_closure_scored") == 0
                and self.finalize_prefilter == 0):
            # the retrieval database serves both the scored LC sampler
            # and the finalize pre-filter; skip it when neither is on
            return
        if self.lcdb is None:
            from ..ops.features import registry as feat_registry
            from ..parallel.lcdb import KeyframeDatabase

            f = kf.features
            self.lcdb = KeyframeDatabase(
                n_desc=f.desc.shape[0] * f.desc.shape[1],
                dim=f.desc.shape[2],
                mesh=self.mesh,
                match_floor=feat_registry.match_floor(self.descriptor_name))
        self.lcdb.add(kf.features)

    # -- prefetch ------------------------------------------------------------
    def _setup_prefetch(self, want_pcd: bool, queue_depth: int = 4,
                        threads: int = 2):
        """Start the native threaded loaders for all frames after the
        current index, so host decode overlaps device compute (the
        reference's frame loop decodes synchronously each frame,
        src/GraphicEnd.cpp:266-302). No-op (pure-Python fallback stays in
        readimage) when the C++ runtime isn't available."""
        self._prefetch = None
        try:
            from .. import native_io
        except ImportError:
            return
        if not native_io.available():
            return
        last = self.index
        while os.path.exists(os.path.join(self.rgb_path, f"{last + 1}.png")):
            last += 1
        if last <= self.index:
            return
        h, w = np.asarray(self.curr_gray).shape
        idx = range(self.index + 1, last + 1)
        loaders = {
            "gray": native_io.PrefetchLoader(
                [os.path.join(self.rgb_path, f"{i}.png") for i in idx],
                native_io.MODE_GRAY8, height=h, width=w,
                queue_depth=queue_depth, threads=threads),
            "depth": native_io.PrefetchLoader(
                [os.path.join(self.dep_path, f"{i}.png") for i in idx],
                native_io.MODE_DEPTH16, height=h, width=w,
                queue_depth=queue_depth, threads=threads),
        }
        if want_pcd:
            loaders["pcd"] = native_io.PrefetchLoader(
                [os.path.join(self.pcl_path, f"{i}.pcd") for i in idx],
                native_io.MODE_PCD,
                queue_depth=queue_depth, threads=threads)
        self._prefetch = loaders
        self._prefetch_next = self.index + 1

    def _prefetch_pop(self):
        """Next (gray, depth, xyz-or-None) if the prefetcher is aligned
        with this frame index; None -> caller uses the synchronous path."""
        if getattr(self, "_prefetch", None) is None \
                or self._prefetch_next != self.index:
            return None
        try:
            gray = self._prefetch["gray"].next()
            depth = self._prefetch["depth"].next()
            cloud = (self._prefetch["pcd"].next()
                     if "pcd" in self._prefetch else None)
        except StopIteration:
            self._prefetch = None
            return None
        self._prefetch_next += 1
        if gray is None or depth is None:
            return None
        return gray, depth, cloud

    # -- io ------------------------------------------------------------------
    def _log(self, name: str, text: str, append: bool = True):
        os.makedirs(self.data_dir, exist_ok=True)
        mode = "a" if append else "w"
        with open(os.path.join(self.data_dir, name), mode) as f:
            f.write(text)

    def readimage(self):
        pre = self._prefetch_pop()
        if pre is not None and pre[2] is not None:
            gray, depth, (xyz, _) = pre
        else:
            if pre is not None:  # images prefetched but pcd failed
                gray, depth, _ = pre
            else:
                gray = images.load_gray(
                    os.path.join(self.rgb_path, f"{self.index}.png"))
                depth = images.load_depth(
                    os.path.join(self.dep_path, f"{self.index}.png"))
            xyz, _ = pcd.read_pcd(
                os.path.join(self.pcl_path, f"{self.index}.pcd"))
        # PCD clouds may live in a different depth-unit system than the
        # depth image (reference convert2PCD factor-1000 vs fr1's 5000;
        # see ops/pointcloud.estimate_depth_scale) — align them so the
        # membership images and kp3d stay consistent in depth units
        if self.align_cloud_scale:
            s = pointcloud.estimate_depth_scale(
                xyz, depth, self.intr.fx, self.intr.fy, self.intr.cx,
                self.intr.cy, self.intr.factor)
            if s > 1.5 or s < 1 / 1.5:
                xyz = xyz / np.float32(s)
        # pad the raw cloud to ONE fixed capacity for the whole run:
        # per-frame point counts vary, and any shape change re-jits the
        # entire extract program (1-6 min per distinct shape on remote
        # compile). Default capacity = H*W (clouds come from backprojecting
        # the frame, so they can't exceed it); oversize clouds are
        # stride-decimated to fit.
        if not hasattr(self, "_cloud_cap"):
            self._cloud_cap = (self.cloud_capacity if self.cloud_capacity > 0
                               else int(gray.size))
        cap = self._cloud_cap
        n = xyz.shape[0]
        if n > cap:
            stride = -(-n // cap)  # ceil div
            xyz = xyz[::stride]
            n = xyz.shape[0]
        xyz_p = np.zeros((cap, 3), np.float32)
        xyz_p[:n] = xyz
        mask = np.zeros(cap, bool)
        mask[:n] = True
        # z passthrough (reference src/GraphicEnd.cpp:283-293); the
        # downsample-before-RANSAC role of the reference's VoxelGrid
        # (287-295) is played by the extractor's strided decimation by
        # default, or by a real voxel grid when `voxel_downsample_clouds`
        # is set (exact reference semantics, costs a device sort)
        xyz_j = jnp.asarray(xyz_p)
        mask_j = pointcloud.passthrough_z(xyz_j, jnp.asarray(mask), 0.0, self.z_filter)
        if self.voxel_downsample_clouds:
            # fixed voxel capacity sized to the extractor's point budget:
            # voxel_downsample packs valid voxels to the front, so leaving
            # the full-cap array would make the extractor's stride
            # decimation discard most real voxels. 4x the budget keeps the
            # residual stride at 4 (uniform over voxel-id order) while
            # bounding truncation for small leaf sizes.
            xyz_j, _, mask_j = pointcloud.voxel_downsample(
                xyz_j, jnp.zeros_like(xyz_j), mask_j, self.grid_leaf,
                capacity=min(cap, 4 * pipeline.PLANE_POINTS))
        self.curr_gray = jnp.asarray(gray)
        self.curr_depth = jnp.asarray(depth)
        self.curr_cloud = xyz_j
        self.curr_cloud_mask = mask_j

    def _extract_present(self) -> FrameFeatures:
        return self.extract(
            self.curr_gray, self.curr_depth, self.curr_cloud,
            self.curr_cloud_mask, self.next_key(),
        )

    # -- software pipelining (SURVEY.md §2.4 item 3) -----------------------
    def _take_or_extract_present(self) -> FrameFeatures:
        """Consume the pre-dispatched extraction for this frame, or fall
        back to the synchronous read+extract."""
        pend = getattr(self, "_pending_feat", None)
        if pend is not None and self._pending_index == self.index:
            self._pending_feat = None
            return pend
        self.readimage()
        return self._extract_present()

    def _dispatch_next_extract(self):
        """Read + dispatch extraction for frame index+1 NOW — after the
        current frame's multiPnP is enqueued but before its result is
        read back, so the device computes the next frame's features
        during the host's readback + keyframe decision (the reference's
        loop is fully synchronous, src/run_SLAM.cpp:30-33)."""
        nxt = self.index + 1
        if not os.path.exists(os.path.join(self.rgb_path, f"{nxt}.png")):
            self._pending_feat = None
            return
        cur = self.index
        self.index = nxt  # readimage/extract key off self.index
        try:
            self.readimage()
            self._pending_feat = self._extract_present()
            self._pending_index = nxt
        finally:
            self.index = cur

    # -- init -----------------------------------------------------------------
    def init(self, slam_end):
        self.slam_end = slam_end
        self.opt = slam_end.globalOptimizer
        if self.use_odometry:
            self.odometry = tum.read_odometry(
                os.path.join(self.params.GetPara("data_source"), "associate.txt")
            )
            self.odo_this = self.odo_last = self.odometry[self.index - 1]

        self._log("error_of_transform.log", "", append=False)

        self.readimage()
        self._setup_prefetch(want_pcd=not self.image_only)
        feats = self._extract_present()
        self.curr_kf = Keyframe(id=0, frame_index=self.index, features=feats)
        self._register_keyframe(self.curr_kf)
        self._kf_pose[0] = np.eye(4)  # drift-gate dead-reckoning anchor
        est = self.odo_this if self.use_odometry else self.robot
        self.opt.add_vertex(0, est, fixed=True)
        self.last = feats
        self.last_frame_index = self.index
        self.index += 1

    # -- per-frame step ---------------------------------------------------------
    def _sync_odometry(self):
        """odo_this for the frame about to be processed (self.index).
        Per-frame mode sets this at the previous run()'s tail; syncing
        at entry computes the identical value and also covers entry
        from the streaming chunk path or its per-frame fallbacks."""
        if self.use_odometry and self.odometry:
            self.odo_this = self.odometry[
                min(self.index, len(self.odometry)) - 1]

    def run(self):
        self.maybe_drain_loop_closures()
        self._sync_odometry()
        present = self._take_or_extract_present()
        self.present = present

        res = self.multipnp(
            self.curr_kf.features, present, self.next_key(), 12
        )
        # overlap: next frame's decode+extract runs on the device while
        # the host blocks on this frame's pose readback below
        self._dispatch_next_extract()
        T, norm, inliers, ok = result_to_host(res)
        T = se3.inverse(T)  # "好像是反着的" (src/GraphicEnd.cpp:170)

        if not ok:
            self._log("error_of_transform.log", "9999\n")
            if self.use_odometry:
                self.lost += 1
            else:
                self._rescue_with_last(present)
        elif norm > self.max_pos_change:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.generate_keyframe(T, present)
            if self.loop_closure_detection:
                self.loop_closure()
            self.lost = 0
            self.last = present
            self.last_frame_index = self.index
        else:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.lost = 0
            self.last = present
            self.last_frame_index = self.index

        if self.lost > self.lost_frames:
            self.lost_recovery(present)
            self.last = present
            self.last_frame_index = self.index

        self.index += 1
        if self.use_odometry:
            # clamp: after the final frame index points one past the
            # odometry table (the reference would over-read its vector)
            self.odo_this = self.odometry[
                min(self.index, len(self.odometry)) - 1]
        return 1

    def _rescue_with_last(self, present: FrameFeatures):
        """Lost branch: try matching last ordinary frame; on success promote
        BOTH last and present to keyframes (src/GraphicEnd.cpp:183-227)."""
        r = self.multipnp(self.last, present, self.next_key(), 12)
        _, r_norm, r_inl, r_ok = result_to_host(r)
        if (not r_ok) or r_inl < self.loop_closure_inliers or r_norm > self.loop_closure_error:
            self.lost += 1
            return
        self.lost = 0
        rr = self.multipnp(self.curr_kf.features, self.last, self.next_key(), 12)
        rr_T, _, _, _ = result_to_host(rr)
        # promote last
        new_id = self.curr_kf.id + 1
        self.curr_kf = Keyframe(id=new_id, frame_index=self.index - 1, features=self.last)
        self._register_keyframe(self.curr_kf)
        est = self.odo_this if self.use_odometry else np.eye(4)
        self.opt.add_vertex(new_id, est)
        self.opt.add_edge(new_id - 1, new_id, se3.inverse(rr_T), INFO_VISUAL)
        self._chain_pose_hint(new_id, se3.inverse(rr_T))
        # then promote present too
        r_T = np.asarray(r.T, dtype=np.float64)
        self.generate_keyframe(se3.inverse(r_T), present)
        self.last = present
        self.last_frame_index = self.index

    def generate_keyframe(self, T: np.ndarray, present: FrameFeatures):
        new_id = self.curr_kf.id + 1
        self.kf_pos = self.robot
        self.curr_kf = Keyframe(id=new_id, frame_index=self.index, features=present)
        self._register_keyframe(self.curr_kf)
        est = self.odo_this if self.use_odometry else np.eye(4)
        self.opt.add_vertex(new_id, est)
        self.opt.add_edge(new_id - 1, new_id, T, INFO_VISUAL)
        self._chain_pose_hint(new_id, T)
        if self.use_odometry:
            To = se3.inverse(self.odo_last) @ self.odo_this
            info = np.eye(6) / (self.error_odometry**2)
            self.opt.add_edge(new_id - 1, new_id, To, info)
            self.odo_last = self.odo_this

    # -- loop closure -------------------------------------------------------
    # first N rows of a fused round are the deterministic -3/-4 checks
    # (record=False, reference src/GraphicEnd.cpp:694-725)
    _LC_N_DET = 2

    def maybe_drain_loop_closures(self):
        """Drain only once enough rounds are pending (lazy policy, see
        lc_drain_threshold). Deferred resolution is observation-
        equivalent: no frontend path reads loop edges before
        lostRecovery/finalize, which drain unconditionally."""
        if len(self._pending_lc) >= self.lc_drain_threshold:
            self.drain_pending_loop_closures()

    def drain_pending_loop_closures(self):
        """Resolve asynchronously dispatched loop-closure rounds and
        apply their edges/logs. All pending rounds' device arrays are
        fetched in batched transfers (parallel/registration.fetch_all),
        so a drain of N rounds costs ~N/8 host syncs, not N."""
        if not self._pending_lc:
            return
        from ..parallel.registration import fetch_all
        from .state import unpack_result_row

        arrs = []
        for ent in self._pending_lc:
            if ent[0] == "fused":
                arrs.append(ent[2])
            else:
                arrs.extend(packed for packed, _ in ent[4])
        fetched = iter(fetch_all(arrs))

        for ent in self._pending_lc:
            if ent[0] == "fused":
                _, kf, _ = ent
                rows = next(fetched)
                for i in range(rows.shape[0]):
                    row = rows[i]
                    if row[20] == 0.0:  # padded/ineligible candidate
                        continue
                    T, norm, inl, ok = unpack_result_row(row)
                    ki = int(row[19])
                    if (not ok) or norm > self.loop_closure_error \
                            or inl < self.loop_closure_inliers:
                        continue
                    Z = se3.inverse(T)
                    if not self._lc_within_drift(self.keyframes[ki], kf, Z):
                        continue
                    if i >= self._LC_N_DET:  # ranked draw -> record
                        self.display_lc(self.keyframes[ki].frame_index,
                                        kf.frame_index, norm, inl)
                        kf.connect.append(ki)
                    self.opt.add_edge(self.keyframes[ki].id, kf.id,
                                      Z, INFO_VISUAL, robust=True)
                    # accepted loop edges re-anchor a hint chain broken
                    # by an unrecovered blackout (else the gate stays
                    # fail-open for the rest of the run)
                    self._reanchor_pose_hint(kf.id, self.keyframes[ki].id, Z)
                continue
            _, cand, records, kf, pending = ent
            results = []
            for _, n_valid in pending:
                arr = next(fetched)
                results.extend(
                    unpack_result_row(arr[i]) for i in range(n_valid))
            for i, record, (T, norm, inl, ok) in zip(cand, records, results):
                if (not ok) or norm > self.loop_closure_error \
                        or inl < self.loop_closure_inliers:
                    continue
                Z = se3.inverse(T)
                if not self._lc_within_drift(self.keyframes[i], kf, Z):
                    continue
                if record:
                    self.display_lc(self.keyframes[i].frame_index,
                                    kf.frame_index, norm, inl)
                    kf.connect.append(i)
                self.opt.add_edge(self.keyframes[i].id, kf.id,
                                  Z, INFO_VISUAL, robust=True)
                self._reanchor_pose_hint(kf.id, self.keyframes[i].id, Z)
        self._pending_lc = []

    def _chain_pose_hint(self, new_id: int, Z) -> None:
        """Dead-reckoned world-pose hint for the drift gate:
        hint_new = hint_prev @ Z where Z is the sequential edge
        measurement (new-1 -> new). A missing predecessor hint
        propagates the broken chain (gate stays permissive)."""
        prev = self._kf_pose.get(new_id - 1)
        self._kf_pose[new_id] = (
            None if prev is None else prev @ np.asarray(Z, np.float64))

    def _reanchor_pose_hint(self, new_id: int, anchor_id: int, Z) -> None:
        """Re-anchor a broken hint chain from an accepted loop/recovery
        edge anchor -> new (first accepted edge wins)."""
        if self._kf_pose.get(new_id) is not None:
            return
        pa = self._kf_pose.get(anchor_id)
        if pa is not None:
            self._kf_pose[new_id] = pa @ np.asarray(Z, np.float64)

    def _lc_within_drift(self, old_kf: Keyframe, new_kf: Keyframe,
                         Z) -> bool:
        """loop_closure_max_drift gate: compare the measured relative
        translation Z (edge direction old->new) against the dead-
        reckoned pose prediction. Catches perceptually-aliased loops
        (wrong-but-consistent registrations that pass the norm/inlier
        gates); off by default for reference parity.

        Known limitation: a grossly mis-tracked SEQUENTIAL promotion
        (tracking-time aliasing, which the reference cannot detect
        either) poisons the hint chain downstream, and the gate then
        mis-predicts loops straddling the bad link. The Cauchy-robust
        optimize still absorbs such runs; the gate's scope is the
        loop-closure aliasing class, which the lc_audit harness shows
        it removes completely (runtime AND findMoreLoops edges)."""
        if self.lc_max_drift <= 0:
            return True
        pa = self._kf_pose.get(old_kf.id)
        pb = self._kf_pose.get(new_kf.id)
        if pa is None or pb is None:
            # chain broken (e.g. past a lostRecovery) -> permissive
            return True
        # hints are dead-reckoned world poses (hint_new = hint_prev @
        # Z_edge, maintained at every promotion site), under which the
        # sequential measurements telescope and the loop prediction is
        # exactly the right-composed relative. NB the frontend's
        # kf_pos/robot chain (the reference's quirky `_robot = T *
        # _kf_pos` left accumulation, src/GraphicEnd.cpp:245) does NOT
        # telescope and cannot serve as the prediction.
        expected = se3.inverse(pa) @ pb
        dev = float(np.linalg.norm(expected[:3, 3] - Z[:3, 3]))
        return dev <= self.lc_max_drift

    def _try_loop_edge(self, kf: Keyframe, record: bool) -> bool:
        res = self.multipnp(
            kf.features, self.curr_kf.features, self.next_key(),
            self.loop_closure_inliers,
        )
        T, norm, inl, ok = result_to_host(res)
        if not ok:
            return False
        if norm > self.loop_closure_error or inl < self.loop_closure_inliers:
            return False
        T = se3.inverse(T)
        if not self._lc_within_drift(kf, self.curr_kf, T):
            return False
        if record:
            self.display_lc(kf.frame_index, self.curr_kf.frame_index, norm, inl)
        self.opt.add_edge(kf.id, self.curr_kf.id, T, INFO_VISUAL, robust=True)
        self._reanchor_pose_hint(self.curr_kf.id, kf.id, T)
        return True

    def loop_closure(self):
        if len(self.keyframes) <= 3:
            return
        # candidate set: deterministic keyframes -3/-4 (src/GraphicEnd.cpp:
        # 694-725) + `loopclosure_frames` dedup'd draws (729-761). The
        # reference samples uniformly at random; with `loop_closure_scored`
        # the draws come from the sharded keyframe database ranked by
        # descriptor-match score instead (parallel/lcdb.py, SURVEY.md §5.7)
        if (self.lcdb is not None and self.batch_registrar is not None
                and self.kf_store is not None and self.lcdb.count > 3):
            # fully-fused round: scoring, top-k draw, -3/-4 checks,
            # feature gather and batched verification all happen in one
            # on-device dispatch chain with ZERO host syncs; the packed
            # (B,21) result (rows carry their candidate index) drains
            # lazily like every other round
            idx_dev, valid_dev = self.lcdb.select_candidates_device(
                self.curr_kf.features, self.loopclosure_frames,
                n_det=self._LC_N_DET)
            packed = self.batch_registrar.dispatch_fused(
                self.kf_store, idx_dev, valid_dev, self.curr_kf.features,
                self.next_key(), self.loop_closure_inliers)
            self._pending_lc.append(("fused", self.keyframes[-1], packed))
            return
        nearby = [len(self.keyframes) + i
                  for i in (-3, -4) if len(self.keyframes) + i >= 0]
        checked: List[int] = []
        if self.lcdb is not None and self.lcdb.count > 3:
            checked = self.lcdb.top_candidates(
                self.curr_kf.features, self.loopclosure_frames)
        else:
            for _ in range(self.loopclosure_frames):
                frame = self._rng.randrange(len(self.keyframes) - 3)
                if frame not in checked:
                    checked.append(frame)

        if self.batch_registrar is not None:
            # every candidate is judged independently in the reference, so
            # the whole round runs as batched device launches
            # (parallel/registration.py; SURVEY.md §2.4 item 2) — and the
            # readback is DEFERRED: nothing in the frontend consumes loop
            # edges or connect lists until findMoreLoops/optimize at save
            # time (the reference too only optimizes in saveFinalResult,
            # src/GraphicEnd.cpp:661-682), so the device verifies the
            # round while the host moves on to the next frame. Outputs
            # are identical to immediate resolution.
            cand = nearby + checked
            # record per-position, not by membership: an index in both
            # nearby and checked gets its edge twice (reference parity —
            # both loops add one) but is logged/connected exactly once
            records = [False] * len(nearby) + [True] * len(checked)
            pending = self.batch_registrar.dispatch_against_one(
                self.kf_store, cand, self.curr_kf.features,
                self.next_key(), self.loop_closure_inliers,
            )
            self._pending_lc.append(
                ("explicit", cand, records, self.keyframes[-1], pending))
            return

        for n in nearby:
            self._try_loop_edge(self.keyframes[n], record=False)
        for frame in checked:
            if self._try_loop_edge(self.keyframes[frame], record=True):
                self.keyframes[-1].connect.append(frame)

    def lost_recovery(self, present: FrameFeatures):
        self.drain_pending_loop_closures()
        new_id = self.curr_kf.id + 1
        self.kf_pos = self.robot
        self.curr_kf = Keyframe(id=new_id, frame_index=self.index, features=present)
        self._log("lost.txt", f"{new_id} {self.index}\n")
        self._register_keyframe(self.curr_kf)
        # pose unknown after a blackout: break the drift-gate hint
        # chain (gate permissive) until an accepted edge re-anchors it
        self._kf_pose[new_id] = None
        est = self.odo_this if self.use_odometry else np.eye(4)
        self.opt.add_vertex(new_id, est)  # unconstrained (src/GraphicEnd.cpp:792)
        if self.use_odometry:
            To = se3.inverse(self.odo_last) @ self.odo_this
            info = np.eye(6) / (self.error_odometry**2)
            self.opt.add_edge(new_id - 1, new_id, To, info)
            self._chain_pose_hint(new_id, To)  # odometry re-anchors
            self.odo_last = self.odo_this
            self.lost = 0
            return
        # brute-force re-localization against the whole history
        # (src/GraphicEnd.cpp:810-836) — with the batched registrar the
        # O(K) scan runs in fixed-shape chunks straight out of the
        # device-resident feature store (no per-K recompiles)
        if self.batch_registrar is not None:
            cand = list(range(len(self.keyframes) - 1))
            results = self.batch_registrar.run_against_one(
                self.kf_store, cand, self.curr_kf.features,
                self.next_key(), 12)
            for i, (T, norm, inl, ok) in zip(cand, results):
                if not ok or inl < self.loop_closure_inliers \
                        or norm > self.loop_closure_error:
                    continue
                Z = se3.inverse(T)
                self.opt.add_edge(self.keyframes[i].id, new_id,
                                  Z, INFO_VISUAL, robust=True)
                self.keyframes[-1].connect.append(i)
                self._reanchor_pose_hint(new_id, self.keyframes[i].id, Z)
            self.lost = 0
            return
        for i in range(len(self.keyframes) - 1):
            res = self.multipnp(
                self.keyframes[i].features, self.curr_kf.features,
                self.next_key(), 12,
            )
            T, norm, inl, ok = result_to_host(res)
            if not ok or inl < self.loop_closure_inliers or norm > self.loop_closure_error:
                continue
            Z = se3.inverse(T)
            self.opt.add_edge(
                self.keyframes[i].id, new_id, Z, INFO_VISUAL, robust=True
            )
            self.keyframes[-1].connect.append(i)
            self._reanchor_pose_hint(new_id, self.keyframes[i].id, Z)
        self.lost = 0

    def display_lc(self, frame1: int, frame2: int, norm: float, inliers: int):
        if self._lcfile is None:
            self._log("lc.txt", "", append=False)
            self._lcfile = True
        self._log("lc.txt", f"{frame1} {frame2} {norm:g} {inliers}\n")

    # -- post-hoc loop expansion (src/GraphicEnd.cpp:864-947) ---------------
    def _apply_check_verdict(self, k1: int, k2: int, passed: bool, T):
        """Record a pair verdict and, on pass, add the edge — also used
        when replaying a cached verdict (the reference re-checks
        previously-checked pairs and adds DUPLICATE edges each time,
        src/GraphicEnd.cpp:887-915; replaying from cache keeps that
        weight-accumulation semantics without recomputing)."""
        self._check_cache[(k1, k2)] = (passed, T)
        if passed:
            Z = se3.inverse(T)
            if not self._lc_within_drift(
                    self.keyframes[k1], self.keyframes[k2], Z):
                # the walk path must honor the same consistency gate as
                # loopClosure or findMoreLoops re-admits the aliased
                # registrations the gate filtered (measured: 1 bad edge
                # of 790 post-finalize with the gate only at runtime);
                # a gate rejection also stops the walk, like a failed
                # check
                return False
            self.opt.add_edge(
                self.keyframes[k1].id, self.keyframes[k2].id,
                Z, INFO_VISUAL, robust=True)
            self._more_loops += 1
        return passed

    def check(self, k1: int, k2: int) -> bool:
        cached = self._check_cache.get((k1, k2))
        if cached is not None:
            return self._apply_check_verdict(k1, k2, *cached)
        res = self.multipnp(
            self.keyframes[k1].features, self.keyframes[k2].features,
            self.next_key(), self.loop_closure_inliers,
        )
        T, norm, inl, ok = result_to_host(res)
        passed = bool(ok) and norm <= self.loop_closure_error \
            and inl >= self.loop_closure_inliers
        return self._apply_check_verdict(k1, k2, passed, T)

    def _scan_source(self, source: int):
        """Fill the verdict cache for every (source, i) pair in one
        pipelined batched-registration round (see checknearby).

        finalize_prefilter (config key, default 0 = off): the exact
        scan is O(K) registrations per source — the right trade at the
        reference's 117 keyframes, but quadratic in total and the
        finalize bottleneck by ~500 keyframes. With the knob set to N,
        the source is ranked against the whole history by the lcdb
        retrieval score (ONE device program, the same similarity the
        scored loop-closure sampler trusts) and only the top N
        candidates get the full multiPnP; the rest are cached as
        failed verdicts — the walk stops there exactly as it would at
        a failed registration. Reference semantics (check every walked
        pair, src/GraphicEnd.cpp:864-947) are preserved at the default.
        """
        fresh = [i for i in range(len(self.keyframes))
                 if i != source and (source, i) not in self._check_cache]
        if not fresh:
            return
        limit = self.finalize_prefilter
        if limit > 0 and len(fresh) > limit and self.lcdb is not None:
            s = self.lcdb.scores(self.keyframes[source].features)
            ranked = sorted(fresh, key=lambda i: -float(s[i]))
            eye = np.eye(4)
            for i in ranked[limit:]:
                self._check_cache[(source, i)] = (False, eye)
            self._prefilter_pruned = (
                getattr(self, "_prefilter_pruned", 0)
                + len(ranked) - limit)
            fresh = sorted(ranked[:limit])
        results = self.batch_registrar.run_against_one(
            self.kf_store, fresh, self.keyframes[source].features,
            self.next_key(), self.loop_closure_inliers,
            single_is_target=False)
        for i, (T, norm, inl, ok) in zip(fresh, results):
            self._check_cache[(source, i)] = (
                bool(ok) and norm <= self.loop_closure_error
                and inl >= self.loop_closure_inliers, T)

    def checknearby(self, source: int, target: int) -> List[int]:
        down = [i for i in range(target - 1, -1, -1) if i != source]
        up = [i for i in range(target + 1, len(self.keyframes)) if i != source]

        if self.batch_registrar is not None and (down or up):
            # the sequential walk stops at the first failure in each
            # direction, but its verdicts depend only on the pair, not
            # the walk order — so on the first touch of a source we
            # register it against the WHOLE keyframe history in one
            # pipelined round (dispatch_against_one launches every
            # chunk before resolving any, so the per-chunk host syncs
            # overlap later chunks' device compute) and fill the
            # verdict cache; all of this source's walks then replay at
            # zero device cost. It overcomputes early-failing walks, in
            # exchange for one sync round per source instead of one per
            # walk step. Duplicate re-checks (reference
            # semantics: edges pile up weight, GraphicEnd.cpp:887-915)
            # still replay from the cache.
            self._scan_source(source)
            checked = []
            for walk in (down, up):
                for i in walk:
                    passed, T = self._check_cache[(source, i)]
                    if not self._apply_check_verdict(source, i, passed, T):
                        break
                    checked.append(i)
            return checked

        checked = []
        for walk in (down, up):
            for i in walk:
                if self.check(source, i):
                    checked.append(i)
                else:
                    break
        return checked

    def find_more_loops(self):
        self._more_loops = 0
        for i, kf in enumerate(self.keyframes):
            if not kf.connect:
                continue
            for j in kf.connect:
                checked = self.checknearby(i, j)
                for k in checked:
                    self.checknearby(k, i)

    def save_final_result(self, fileaddr: str = ""):
        """NB: mirrors the reference in ignoring `fileaddr` and writing the
        fixed data-dir paths (src/GraphicEnd.cpp:661-682)."""
        self.drain_pending_loop_closures()
        self.find_more_loops()
        self.opt.optimize(self.params.get_int("optimize_step"),
                          mesh=self.mesh)
        os.makedirs(self.data_dir, exist_ok=True)
        tum.write_keyframes(
            os.path.join(self.data_dir, "keyframe.txt"),
            [(kf.id, kf.frame_index) for kf in self.keyframes],
        )
        self.opt.save(os.path.join(self.data_dir, "final_after.g2o"))

    # reference-name aliases
    saveFinalResult = save_final_result  # noqa: N815
    generateKeyFrame = generate_keyframe  # noqa: N815
    loopClosure = loop_closure  # noqa: N815
    lostRecovery = lost_recovery  # noqa: N815

class GraphicEnd2(GraphicEnd):
    """Image-only frontend (reference src/GraphicEnd2.cpp): whole image as
    one pseudo-plane, no point clouds, no last-frame rescue."""

    image_only = True

    def _build_pipeline(self):
        self.extract_img = pipeline.build_image_extractor(
            self.detector_name, self.descriptor_name, self.intr,
            max_kp=self.max_kp,
        )
        from ..ops.features import registry as feat_registry

        floor = feat_registry.match_floor(self.descriptor_name)
        self.multipnp = pipeline.build_multipnp_image(
            self.intr, error_threshold=self.error_threshold,
            hypotheses=self.hypotheses, match_floor=floor,
        )
        self.batch_registrar = self._make_batch_registrar(image_only=True)

    def readimage(self):
        pre = self._prefetch_pop()
        if pre is not None:
            gray, depth, _ = pre
        else:
            gray = images.load_gray(
                os.path.join(self.rgb_path, f"{self.index}.png"))
            depth = images.load_depth(
                os.path.join(self.dep_path, f"{self.index}.png"))
        self.curr_gray = jnp.asarray(gray)
        self.curr_depth = jnp.asarray(depth)

    def _extract_present(self) -> FrameFeatures:
        return self.extract_img(self.curr_gray, self.curr_depth)

    def run(self):
        self.maybe_drain_loop_closures()
        self._sync_odometry()
        present = self._take_or_extract_present()
        self.present = present

        res = self.multipnp(self.curr_kf.features, present, self.next_key(), 12)
        self._dispatch_next_extract()
        T, norm, inliers, ok = result_to_host(res)
        T = se3.inverse(T)

        if not ok:
            self._log("error_of_transform.log", "9999\n")
            self.lost += 1
        elif norm > self.max_pos_change:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.generate_keyframe(T, present)
            if self.loop_closure_detection:
                self.loop_closure()
            self.lost = 0
        else:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.lost = 0

        if self.lost > self.lost_frames:
            self.lost_recovery(present)

        self.index += 1
        if self.use_odometry:
            # clamp: after the final frame index points one past the
            # odometry table (the reference would over-read its vector)
            self.odo_this = self.odometry[
                min(self.index, len(self.odometry)) - 1]
        return 0
