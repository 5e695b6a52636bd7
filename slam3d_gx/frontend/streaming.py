"""Streaming frontend: N frames of visual odometry per host round-trip.

The reference's frame loop is strictly sequential and synchronous
(src/run_SLAM.cpp:30-33), and even this framework's per-frame mode must
read one pose back per frame for the keyframe decision, a host sync
per frame that caps the wall rate however fast the jitted step is.
This module folds the *tracking* state machine
of GraphicEnd2::run (src/GraphicEnd2.cpp:149-201: extract -> multiPnP
-> invert -> keyframe/small-motion/lost branches) into one `lax.scan`
over a chunk of frames, carried entirely on device:

  carry = (current-keyframe features, kf_pos, robot, lost counter)
  per frame: features = extract(gray, depth)
             res = multiPnP(kf_feat, features); T = res.T^-1
             ok    -> robot' = T @ kf_pos; lost' = 0
             norm > max_pos_change -> promote: kf_feat' = features,
                                      kf_pos' = robot'
             !ok   -> lost' = lost + 1

One packed (N, REC_WIDTH) readback per chunk carries every decision
the host needs (measurement T, norm, inliers, ok, new-keyframe flag,
lost counter, rescue records); per-frame features stay on device and
new keyframes are sliced out of the returned stack with a single
jitted take. Keyframe bookkeeping, graph edges, loop closure (async,
parallel/registration) and the logs are then replayed host-side with
identical semantics.

lostRecovery cannot run on device (it mutates the pose graph and scans
history, src/GraphicEnd.cpp:764-838): when a chunk's lost counter
crosses `lost_frames`, results after the trigger frame are discarded
and those frames are re-run through the exact per-frame path.

Within-chunk results are decision-equivalent to per-frame mode; RANSAC
draws consume a different PRNG stream, so poses match statistically,
not bit-for-bit (same contract as the reference's srand run-to-run).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import se3
from ..io import images
from .graphic_end import INFO_VISUAL, GraphicEnd, GraphicEnd2
from .state import Keyframe


def _inv_se3(T):
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    return Ti.at[:3, 3].set(-R.T @ t)


REC_WIDTH = 59  # per-frame packed record row (see build_tracker)


def build_tracker(extract_fn, multipnp, max_pos_change: float,
                  chunk: int, rescue: bool = False,
                  rescue_inliers: int = 30, rescue_error: float = 1.5):
    """Jitted track_chunk(kf_feat, kf_pos, robot, lost, last_feat,
    grays, depths, keys) -> (carry', features_stack (N,...),
    records (N,REC_WIDTH)).

    extract_fn(gray_f32, depth_f32, key) -> FrameFeatures — the plane
    extractor consumes a PRNG key (RANSAC), the image extractor ignores
    it.

    With rescue=True the reference's last-frame rescue
    (src/GraphicEnd.cpp:183-227, mirrored host-side by
    GraphicEnd._rescue_with_last) runs ON DEVICE under lax.cond when
    registration against the current keyframe fails: present is matched
    against the last tracked frame and, on success (inliers >=
    rescue_inliers and norm <= rescue_error — the reference reuses its
    loop-closure gates here), BOTH last and present promote to
    keyframes and present becomes the reference keyframe. Without this
    the host had to replay the chunk's remainder through the synchronous
    per-frame path on every sporadic RANSAC miss.

    Record row layout (f32): [0:16] T (inverted measurement), [16] norm,
    [17] inliers, [18] ok, [19] new_kf, [20] lost-after, [21:24]
    robot t, [24] rescued, [25:41] rescue T last->present, [41] rescue
    norm, [42] rescue inliers, [43:59] T keyframe->last."""

    def step(carry, xs):
        kf_feat, kf_pos, robot, lost, last_feat = carry
        gray, depth, key = xs
        k_ext, k_pnp, k_r, k_rr = jax.random.split(key, 4)
        # frames arrive as raw u8/u16 (half the upload bytes of f32);
        # cast on device
        feat = extract_fn(gray.astype(jnp.float32),
                          depth.astype(jnp.float32), k_ext)
        res = multipnp(kf_feat, feat, k_pnp, jnp.int32(12))
        T = _inv_se3(res.T)
        ok = res.ok

        if rescue:
            def try_rescue(_):
                r = multipnp(last_feat, feat, k_r, jnp.int32(12))
                r_ok = (r.ok & (r.inliers >= rescue_inliers)
                        & (r.norm <= rescue_error))
                # keyframe->last edge; only consumed when r_ok, so the
                # wasted solve on a failed rescue costs nothing extra
                # on the common path (the cond is only entered on !ok)
                rr = multipnp(kf_feat, last_feat, k_rr, jnp.int32(12))
                return (r_ok, r.T.reshape(16), r.norm,
                        r.inliers.astype(jnp.float32), rr.T.reshape(16))

            def no_rescue(_):
                return (jnp.bool_(False), jnp.zeros(16, jnp.float32),
                        jnp.float32(0.0), jnp.float32(0.0),
                        jnp.zeros(16, jnp.float32))

            resc_ok, r_T, r_norm, r_inl, rr_T = jax.lax.cond(
                ~ok, try_rescue, no_rescue, operand=None)
        else:
            resc_ok = jnp.bool_(False)
            r_T = rr_T = jnp.zeros(16, jnp.float32)
            r_norm = r_inl = jnp.float32(0.0)

        new_kf = ok & (res.norm > max_pos_change)
        promote = new_kf | resc_ok
        robot_n = jnp.where(ok, T @ kf_pos, robot)
        # rescue parity: generate_keyframe sets kf_pos = robot and the
        # rescue branch never moves robot, so promote covers both cases
        kf_pos_n = jnp.where(promote, robot_n, kf_pos)
        kf_feat_n = jax.tree.map(
            lambda new, old: jnp.where(promote, new, old), feat, kf_feat)
        tracked = ok | resc_ok
        lost_n = jnp.where(tracked, 0, lost + 1)
        last_n = jax.tree.map(
            lambda new, old: jnp.where(tracked, new, old), feat, last_feat)
        rec = jnp.concatenate([
            T.reshape(16).astype(jnp.float32),
            jnp.stack([
                res.norm.astype(jnp.float32),
                res.inliers.astype(jnp.float32),
                ok.astype(jnp.float32),
                new_kf.astype(jnp.float32),
                lost_n.astype(jnp.float32),
            ]),
            robot_n[:3, 3].astype(jnp.float32),
            resc_ok.astype(jnp.float32)[None],
            r_T.astype(jnp.float32),
            jnp.stack([r_norm.astype(jnp.float32),
                       r_inl.astype(jnp.float32)]),
            rr_T.astype(jnp.float32),
        ])
        return (kf_feat_n, kf_pos_n, robot_n, lost_n, last_n), (feat, rec)

    @jax.jit
    def track_chunk(kf_feat, kf_pos, robot, lost, last_feat, grays,
                    depths, keys):
        carry, (feats, recs) = jax.lax.scan(
            step, (kf_feat, kf_pos, robot, lost, last_feat),
            (grays, depths, keys), length=chunk)
        return carry, feats, recs

    return track_chunk


_take = jax.jit(lambda stack, i: jax.tree.map(lambda x: x[i], stack))


class _StreamingMixin:
    """Chunked on-device tracking shared by the image-only and plane
    frontends. Use run_streaming(n_frames) instead of n run() calls.

    Subclasses provide _make_extract_fn() -> extract(gray_f32,
    depth_f32, key). For the plane frontend the reference's last-frame
    rescue (src/GraphicEnd.cpp:183-227) runs inside the device scan
    (build_tracker rescue=True) and its keyframe bookkeeping is
    mirrored host-side from the packed records; only lostRecovery
    (graph mutation + history scan) still falls back to the exact
    per-frame path."""

    def _init_streaming(self, chunk: int, prefetch_chunks: int = None):
        self.chunk = chunk
        # chunks decoded+uploaded ahead of the device scan (2 keeps one
        # chunk decoding while another uploads, hiding both behind the
        # scan; each buffered 640x480 chunk is ~29 MB host + device).
        # 0 disables the pipeline (synchronous overlap-off baseline).
        # Config key streaming_prefetch_chunks; kwarg wins when given.
        if prefetch_chunks is None:
            try:
                prefetch_chunks = self.params.get_int(
                    "streaming_prefetch_chunks")
            except (KeyError, ValueError):
                prefetch_chunks = 2
        self.chunk_prefetch = prefetch_chunks
        # bound on waiting for a background decode+upload future: an
        # unbounded fut.result() on a stuck upload would hang the whole
        # run silently; surfacing it as an error is recoverable
        self.chunk_load_timeout = 600.0
        self._tracker = None

    def _setup_prefetch(self, want_pcd: bool, **kw):
        """Streaming never starts the native per-frame prefetch: the
        main loop loads whole chunks through _load_frames_raw/_device
        (threaded decode in the chunk loader), so per-frame loaders
        would decode the first frames twice and hold 4 threads + queue
        memory for the whole run. The rare per-frame fallback paths
        (chunk tail, lostRecovery replay) decode synchronously instead
        — readimage's pure-Python path handles _prefetch=None."""
        del want_pcd, kw
        self._prefetch = None

    def _frame_files_exist(self, idx: int) -> bool:
        """Contiguous-prefix probe. The plane frontend also requires the
        frame's PCD: the chunk path never reads it (clouds come from
        on-device backprojection) but the per-frame fallback paths
        (chunk tail, lostRecovery replay) do — a PNG-present/PCD-missing
        frame must stop the run cleanly here instead of crashing in
        read_pcd mid-replay."""
        if not os.path.exists(os.path.join(self.rgb_path, f"{idx}.png")):
            return False
        if not self.image_only:
            return os.path.exists(
                os.path.join(self.pcl_path, f"{idx}.pcd"))
        return True

    def _ensure_tracker(self):
        if self._tracker is None:
            # the rescue branch mirrors run(): only the non-odometry
            # plane frontend rescues (GraphicEnd.run:401-406); image-only
            # and odometry runs count lost frames instead
            rescue = (not self.image_only) and not self.use_odometry
            self._tracker = build_tracker(
                self._make_extract_fn(), self.multipnp,
                self.max_pos_change, self.chunk, rescue=rescue,
                rescue_inliers=self.loop_closure_inliers,
                rescue_error=self.loop_closure_error)

    def _load_frames(self, indices):
        # drain the per-frame prefetch first (single-threaded: it
        # save/restores self.index); at most one index can match
        pre_hits = {}
        for idx in indices:
            if getattr(self, "_prefetch", None) is not None \
                    and self._prefetch_next == idx:
                save = self.index
                self.index = idx
                pre = self._prefetch_pop()
                self.index = save
                if pre is not None:
                    g, d, _ = pre
                    pre_hits[idx] = (np.asarray(g),
                                     np.asarray(d, np.uint16))
        return self._load_frames_raw(indices, pre_hits)

    def _load_frames_raw(self, indices, pre_hits=None):
        """Decode a chunk's frames to stacked host arrays. Touches no
        frontend state (unlike _load_frames' prefetch drain), so it is
        safe to call from the background chunk loader thread."""
        pre_hits = pre_hits or {}

        def load_one(idx):
            if idx in pre_hits:
                return pre_hits[idx]
            g = images.load_gray(
                os.path.join(self.rgb_path, f"{idx}.png"))
            d = images.load_depth(
                os.path.join(self.dep_path, f"{idx}.png"))
            return np.asarray(g), np.asarray(d, np.uint16)

        if len(indices) > 1:
            # decode in threads: the native PNG codec / PIL's zlib both
            # release the GIL for the heavy part, and serial decode sits
            # on the critical host path even with double-buffering (it
            # runs inside dispatch)
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(max_workers=8) as ex:
                pairs = list(ex.map(load_one, indices))
        else:
            pairs = [load_one(idx) for idx in indices]
        grays = [g for g, _ in pairs]
        depths = [d for _, d in pairs]
        return np.stack(grays), np.stack(depths)

    def _load_frames_device(self, indices):
        """Decode AND upload a chunk off the critical path: a 32-frame
        chunk is 29 MB of u8/u16 pixels to decode and upload. This runs
        in the chunk-loader thread so decode+upload of chunk k+2 overlap
        chunk k+1's device scan and chunk k's bookkeeping."""
        grays, depths = self._load_frames_raw(indices)
        return jnp.asarray(grays), jnp.asarray(depths)

    def _schedule_load(self, loader, start: int, budget: int):
        """Submit the next full chunk's decode+upload to the loader
        thread. Returns (indices, future) or None (partial chunk, file
        gap, or exhausted frame budget — those fall to the tail path)."""
        if budget < self.chunk:
            return None
        indices = []
        for i in range(self.chunk):
            idx = start + i
            if not self._frame_files_exist(idx):
                break
            indices.append(idx)
        if len(indices) < self.chunk:
            return None
        return indices, loader.submit(self._load_frames_device, indices)

    def run_streaming(self, n_frames: int) -> int:
        """Process up to n_frames (stops at missing files). Returns the
        number of frames actually processed.

        Three-stage pipeline: while chunk k's records are applied
        host-side, chunk k+1 scans on device (dispatched with k's device
        carry — no host sync needed) and chunk k+2 decodes + uploads in
        a background loader thread (_load_frames_device), keeping
        decode+upload off the critical path. If applying chunk k diverges from
        the device scan (per-frame replay or lostRecovery), the
        speculative dispatch used a stale carry and is re-dispatched
        from the corrected host state; the loaded frames and the
        pending load stay valid (the frame SEQUENCE never changes, only
        the tracking carry), so only the dispatch repeats."""
        self._ensure_tracker()
        import collections
        import concurrent.futures as cf
        done = 0
        inflight = None
        next_fetch = self.index
        if self.chunk_prefetch <= 0:
            # overlap-off baseline: synchronous load -> dispatch ->
            # apply per chunk (the tail loop below handles full chunks
            # identically when nothing was pipelined)
            return self._run_streaming_tail(n_frames, done)
        depth = max(1, self.chunk_prefetch)
        pendq = collections.deque()  # (indices, future[(g_dev, d_dev)])
        with cf.ThreadPoolExecutor(max_workers=depth) as loader:
            while True:
                committed = done + (
                    len(inflight["indices"]) if inflight else 0)
                committed += sum(len(i) for i, _ in pendq)

                def refill():
                    nonlocal next_fetch, committed
                    # contiguous prefix only: a mid-sequence gap ends
                    # the run (the per-frame fallback would otherwise
                    # walk into the missing file), matching the 'stops
                    # at missing files' contract
                    while len(pendq) < depth:
                        p = self._schedule_load(
                            loader, next_fetch, n_frames - committed)
                        if p is None:
                            return
                        pendq.append(p)
                        next_fetch = p[0][-1] + 1
                        committed += len(p[0])

                refill()
                nxt = None
                if pendq:
                    indices, fut = pendq.popleft()
                    carry = inflight["carry"] if inflight else None
                    try:
                        frames = fut.result(
                            timeout=self.chunk_load_timeout)
                    except cf.TimeoutError:
                        raise RuntimeError(
                            f"streaming chunk load timed out after "
                            f"{self.chunk_load_timeout:.0f}s — PNG "
                            f"decode or device upload is stuck")
                    nxt = self._dispatch_chunk(
                        indices, carry=carry, frames=frames)
                    # refill the freed load slot NOW so later chunks'
                    # decode+upload overlap the blocking bookkeeping
                    # below
                    refill()
                if inflight is not None:
                    applied, clean = self._process_chunk(inflight)
                    done += applied
                    if not clean and nxt is not None:
                        # host state diverged from the device scan: redo
                        # the speculative dispatch with the corrected
                        # carry (frames stay resident; only the dispatch
                        # repeats)
                        nxt = self._dispatch_chunk(
                            nxt["indices"], frames=nxt["frames"])
                inflight = nxt
                if inflight is None:
                    break
        return self._run_streaming_tail(n_frames, done)

    def _run_streaming_tail(self, n_frames: int, done: int) -> int:
        """Synchronous chunked loop: load -> dispatch -> apply, one
        chunk at a time. Serves (a) the tail when fewer than chunk
        frames remain or a file gap broke the pipelined prefix, and
        (b) the whole run when streaming_prefetch_chunks=0 (the
        overlap-off baseline). Partial chunks are padded to the fixed
        tracker shape by repeating the last frame — the per-frame
        fallback costs ~1.3 s/frame on the plane pipeline (host PCD
        parse + synchronous readback) and was 91% of the 96-frame
        benchmark's wall time. Only the valid prefix of the records is
        applied; a padded frame's effect on the device carry is
        irrelevant because the run ends (or re-enters here) right
        after."""
        while done < n_frames and self._frame_files_exist(self.index):
            indices = []
            idx = self.index
            while (done + len(indices) < n_frames
                   and len(indices) < self.chunk
                   and self._frame_files_exist(idx)):
                indices.append(idx)
                idx += 1
            grays, depths = self._load_frames(indices)
            pad = self.chunk - len(indices)
            if pad:
                grays = np.concatenate(
                    [grays, np.repeat(grays[-1:], pad, axis=0)])
                depths = np.concatenate(
                    [depths, np.repeat(depths[-1:], pad, axis=0)])
            st = self._dispatch_chunk(indices, frames=(grays, depths))
            applied, _ = self._process_chunk(st)
            done += applied
        return done

    def _dispatch_chunk(self, indices, carry=None, frames=None):
        """Load (or reuse) the chunk's frames and launch the tracker.
        carry: device carry from the previous chunk's tracker output;
        None reads the host state (first chunk / post-divergence)."""
        if frames is None:
            frames = self._load_frames(indices)
        grays, depths = frames
        if carry is None:
            carry = (
                self.curr_kf.features,
                jnp.asarray(self.kf_pos, jnp.float32),
                jnp.asarray(self.robot, jnp.float32),
                jnp.int32(self.lost),
                self.last if self.last is not None
                else self.curr_kf.features,
            )
        keys = jax.random.split(self.next_key(), self.chunk)
        carry_out, feats, recs = self._tracker(
            *carry,
            jnp.asarray(grays),   # u8: a quarter of f32's upload
            jnp.asarray(depths),  # u16
            keys,
        )
        return {"indices": indices, "frames": frames, "carry": carry_out,
                "feats": feats, "recs": recs}

    def _process_chunk(self, chunk_state) -> tuple:
        """Apply one tracked chunk's records host-side. Returns
        (frames_applied, clean) — clean=False when the per-frame
        replay/recovery path ran (host state no longer matches the
        device carry)."""
        self.maybe_drain_loop_closures()
        indices = chunk_state["indices"]
        feats = chunk_state["feats"]
        recs = np.asarray(chunk_state["recs"])  # ONE readback per chunk

        applied = 0
        last_ptr = -1  # index into feats of the device's `last` frame
        for j, idx in enumerate(indices):
            T = recs[j, :16].astype(np.float64).reshape(4, 4)
            norm = float(recs[j, 16])
            ok = recs[j, 18] != 0.0
            new_kf = recs[j, 19] != 0.0
            lost_after = int(recs[j, 20])
            rescued = recs[j, 24] != 0.0
            self.index = idx
            self._sync_odometry()
            if not ok:
                self._log("error_of_transform.log", "9999\n")
                if rescued:
                    # mirror _rescue_with_last's bookkeeping from the
                    # on-device rescue records (GraphicEnd.cpp:183-227):
                    # promote last, then present; robot stays put
                    r_T = recs[j, 25:41].astype(np.float64).reshape(4, 4)
                    rr_T = recs[j, 43:59].astype(np.float64).reshape(4, 4)
                    last_feats = (_take(feats, jnp.int32(last_ptr))
                                  if last_ptr >= 0 else self.last)
                    self.lost = 0
                    new_id = self.curr_kf.id + 1
                    self.curr_kf = Keyframe(
                        id=new_id, frame_index=idx - 1,
                        features=last_feats)
                    self._register_keyframe(self.curr_kf)
                    est = (self.odo_this if self.use_odometry
                           else np.eye(4))
                    self.opt.add_vertex(new_id, est)
                    self.opt.add_edge(new_id - 1, new_id,
                                      se3.inverse(rr_T), INFO_VISUAL)
                    self._chain_pose_hint(new_id, se3.inverse(rr_T))
                    feat_j = _take(feats, jnp.int32(j))
                    self.generate_keyframe(se3.inverse(r_T), feat_j)
                    self.last = feat_j
                    self.last_frame_index = idx
                    last_ptr = j
                else:
                    self.lost = lost_after
            else:
                self._log("error_of_transform.log", f"{norm:g}\n")
                self.robot = T @ self.kf_pos
                self.lost = 0
                feat_j = _take(feats, jnp.int32(j))
                if new_kf:
                    self.generate_keyframe(T, feat_j)
                    if self.loop_closure_detection:
                        self.loop_closure()
                self.last = feat_j
                self.last_frame_index = idx
                last_ptr = j
            applied += 1
            if self.lost > self.lost_frames:
                # recovery mutates the graph and the reference keyframe;
                # device results past this frame assumed no recovery —
                # replay the rest through the per-frame path. NB: run()
                # calls lost_recovery BEFORE its index increment, so the
                # recovery keyframe must record frame_index == idx
                # (self.index still at idx here).
                feat_j = _take(feats, jnp.int32(j))
                self.lost_recovery(feat_j)
                # run() resets its last-frame rescue reference after a
                # recovery (graphic_end.py run(): self.last = present);
                # the replayed frames below must rescue against this
                # frame, not the stale pre-blackout one
                self.last = feat_j
                self.last_frame_index = idx
                last_ptr = j
                self.index = idx + 1  # run()'s post-recovery increment
                for k in range(j + 1, len(indices)):
                    self.index = indices[k]
                    self.run()
                    applied += 1
                return applied, False
            self.index = idx + 1
        return applied, True


class StreamingGraphicEnd2(_StreamingMixin, GraphicEnd2):
    """Image-only frontend with chunked on-device tracking (the
    reference's own 'real-time variant' motivation, README:15, taken
    to its device-resident conclusion)."""

    def __init__(self, params=None, data_dir: str = "./data",
                 chunk: int = 8):
        super().__init__(params, data_dir=data_dir)
        self._init_streaming(chunk)

    def _make_extract_fn(self):
        extract_img = self.extract_img

        def ext(gray, depth, key):
            del key  # image extractor is deterministic
            return extract_img(gray, depth)

        return ext


class StreamingGraphicEnd(_StreamingMixin, GraphicEnd):
    """Plane-pipeline frontend with chunked on-device tracking.

    The chunk path derives each frame's cloud by backprojecting the
    depth image on device (= convert2PCD semantics, so identical to the
    PCD files for datasets produced by the documented workflow). The
    reference's last-frame rescue runs inside the device scan
    (build_tracker rescue=True) so sporadic registration misses no
    longer leave the chunk; only lostRecovery falls back to the exact
    per-frame path (which reads the PCD files).
    """

    def __init__(self, params=None, data_dir: str = "./data",
                 chunk: int = 8):
        super().__init__(params, data_dir=data_dir)
        self._init_streaming(chunk)

    def _make_extract_fn(self):
        from . import pipeline
        from ..ops import pointcloud

        extract = self.extract
        intr = self.intr
        z_filter = self.z_filter
        # config escape hatches (readimage honors them on the per-frame
        # path; the chunked extract must match or the two paths silently
        # mix cloud-preprocessing semantics within one run):
        # - voxel_downsample_clouds: applied below, same fixed capacity
        #   as readimage (4x the extractor's point budget);
        # - align_cloud_scale is a no-op by construction here: the chunk
        #   path backprojects the frame's own depth image, so cloud and
        #   depth units are identical (the knob exists for PCD files
        #   written with a different depth factor, ops/pointcloud.
        #   estimate_depth_scale).
        voxel = self.voxel_downsample_clouds
        grid_leaf = self.grid_leaf

        def ext(gray, depth, key):
            xyz, valid = pointcloud.backproject(
                depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
            xyz = xyz.reshape(-1, 3)
            valid = pointcloud.passthrough_z(
                xyz, valid.reshape(-1), 0.0, z_filter)
            if voxel:
                xyz, _, valid = pointcloud.voxel_downsample(
                    xyz, jnp.zeros_like(xyz), valid, grid_leaf,
                    capacity=min(xyz.shape[0], 4 * pipeline.PLANE_POINTS))
            return extract(gray, depth, xyz, valid, key)

        return ext
