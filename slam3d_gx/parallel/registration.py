"""Data-parallel batched pairwise registration.

The reference verifies loop-closure candidates one multiPnP call at a
time (30 random draws per keyframe, reference src/GraphicEnd.cpp:729-761)
and runs registration sweeps one process per pair (exp1_2.py:19-27).
All of those pairs are independent — this design batches them
with vmap and shards the batch axis over the "dp" mesh axis, so a
loop-closure round or an exp1-style sweep is ONE device program.

Used by:
- frontend loopClosure / lostRecovery candidate verification;
- the exp1_2 sweep harness (tools + cli/exp1_2);
- bench.py registration throughput.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..config import CameraIntrinsics
from ..frontend import pipeline
from ..frontend.state import FrameFeatures, MultiPnPResult
from . import mesh as mesh_mod

P = PartitionSpec


def stack_features(frames) -> FrameFeatures:
    """Stack FrameFeatures into one batched pytree (B, ...).

    Device arrays stay on device (a np.asarray here would round-trip
    every keyframe's descriptors through the host per loop-closure
    round)."""
    return FrameFeatures(*[
        jnp.stack([jnp.asarray(getattr(f, name)) for f in frames])
        for name in FrameFeatures._fields
    ])


def pad_batch(batch: FrameFeatures, b_pad: int) -> FrameFeatures:
    """Pad the leading batch axis to b_pad by repeating row 0 (results for
    padded rows are discarded by the caller)."""
    b = batch.uv.shape[0]
    if b == b_pad:
        return batch
    reps = b_pad - b
    return FrameFeatures(*[
        jnp.concatenate([x, jnp.repeat(x[:1], reps, axis=0)]) for x in batch
    ])


def build_batched_multipnp(
    intr: CameraIntrinsics,
    image_only: bool = False,
    error_threshold: float = 1.0,
    hypotheses: int = 256,
    mesh: Optional[Mesh] = None,
    match_floor: float = 0.0,
) -> Callable:
    """Returns batched(fa, fb, keys, min_inliers) -> MultiPnPResult with
    a leading batch axis on every field.

    fa/fb are FrameFeatures with leading batch axis B; keys is (B, 2)
    uint32; min_inliers is a scalar (traced). With a mesh, B must be a
    multiple of the dp axis size and the batch is sharded over it —
    each device registers its shard's pairs, no collectives needed
    (embarrassingly parallel fan-out).
    """
    build = (pipeline.build_multipnp_image if image_only
             else pipeline.build_multipnp_planes)
    single = build(intr, error_threshold=error_threshold,
                   hypotheses=hypotheses, match_floor=match_floor)
    batched = jax.vmap(single, in_axes=(0, 0, 0, None))

    if mesh is None:
        return jax.jit(batched)

    dp = NamedSharding(mesh, P(mesh_mod.DP_AXIS))
    rep = NamedSharding(mesh, P())
    fn = jax.jit(
        batched,
        in_shardings=(
            jax.tree.map(lambda _: dp, FrameFeatures(*FrameFeatures._fields)),
            jax.tree.map(lambda _: dp, FrameFeatures(*FrameFeatures._fields)),
            dp,
            rep,
        ),
        out_shardings=jax.tree.map(
            lambda _: dp, MultiPnPResult(*MultiPnPResult._fields)
        ),
    )
    return fn


@jax.jit
def _pack_with_meta(packed, idx, valid):
    """(B,19) packed results + (B,) idx + (B,) valid -> (B,21) — ONE
    array so the deferred drain pays a single transfer for the
    whole fused round (results AND which keyframes they belong to)."""
    return jnp.concatenate([
        packed,
        idx.astype(jnp.float32)[:, None],
        valid.astype(jnp.float32)[:, None],
    ], axis=1)


def resolve_async(pending):
    """Materialize dispatch_against_one's futures: one transfer
    per chunk, rows unpacked to (T, norm, inliers, ok) host tuples."""
    from ..frontend.state import unpack_result_row

    out = []
    for packed, n_valid in pending:
        arr = np.asarray(packed)
        out.extend(unpack_result_row(arr[i]) for i in range(n_valid))
    return out


# transfer-batching group size for fetch_all: one device-side stack of G
# same-shaped arrays per host sync instead of G syncs
_FETCH_GROUP = 8


def fetch_all(arrs):
    """Transfer a list of device arrays with ~len/_FETCH_GROUP host
    syncs instead of one per array: same-shaped arrays are stacked on
    device in fixed-size groups (fixed so the eager stack compiles once
    per element shape) and fetched in one transfer per group. Returns
    host np arrays in input order."""
    out = [None] * len(arrs)
    groups = {}
    for i, a in enumerate(arrs):
        groups.setdefault(tuple(a.shape), []).append(i)
    for idxs in groups.values():
        for c0 in range(0, len(idxs), _FETCH_GROUP):
            part = idxs[c0:c0 + _FETCH_GROUP]
            pad = part + [part[0]] * (_FETCH_GROUP - len(part))
            stacked = np.asarray(jnp.stack([arrs[i] for i in pad]))
            for k, i in enumerate(part):
                out[i] = stacked[k]
    return out


class FeatureStore:
    """Device-resident, fixed-capacity stack of per-keyframe features.

    Why this exists: building a loop-closure batch with eager
    `jnp.stack` over a *growing* list of keyframes changes the op's
    shape every frame, and every new shape is a fresh XLA compile. Here
    the features live
    in fixed-capacity device buffers (grown by doubling) and candidate
    batches are produced by ONE jitted gather with a static chunk
    shape, so steady-state loop closure launches zero new programs.
    """

    def __init__(self, template: FrameFeatures, capacity: int = 64,
                 chunk: int = 32):
        self.chunk = chunk
        self.count = 0
        self.capacity = capacity
        self._bufs = jax.tree.map(
            lambda x: jnp.zeros((capacity,) + tuple(x.shape), x.dtype),
            template)

        def _set(bufs, i, f):
            return jax.tree.map(lambda b, x: b.at[i].set(x), bufs, f)

        def _gather(bufs, idx):
            # clamp: device-selected indices carry -1/invalid rows that
            # the caller masks out after readback
            return jax.tree.map(
                lambda b: b[jnp.clip(idx, 0, b.shape[0] - 1)], bufs)

        def _bcast(f, n: int):
            return jax.tree.map(
                lambda x: jnp.broadcast_to(
                    x[None], (n,) + tuple(x.shape)), f)

        self._set = jax.jit(_set, donate_argnums=0)
        self._gather = jax.jit(_gather)
        self._bcast = jax.jit(_bcast, static_argnames="n")

    def add(self, f: FrameFeatures) -> int:
        if self.count == self.capacity:
            old = self._bufs
            self.capacity *= 2
            self._bufs = jax.tree.map(
                lambda b: jnp.concatenate(
                    [b, jnp.zeros_like(b)], axis=0), old)
        i = self.count
        self._bufs = self._set(self._bufs, jnp.int32(i), f)
        self.count += 1
        return i

    def gather(self, indices) -> FrameFeatures:
        """indices: <= chunk host ints -> (chunk, ...) batch (padded by
        repeating index 0; callers discard padded rows)."""
        idx = np.zeros((self.chunk,), np.int32)
        idx[: len(indices)] = np.asarray(indices, np.int32)
        return self._gather(self._bufs, jnp.asarray(idx))

    def gather_dev(self, idx_dev) -> FrameFeatures:
        """Device-index gather: (B,) int32 device array (e.g. the fused
        loop-closure round's on-device top-k) -> (B, ...) batch, no host
        sync; out-of-range/invalid rows come back clamped and must be
        masked by the caller."""
        return self._gather(self._bufs, idx_dev)

    def broadcast(self, f: FrameFeatures, n: Optional[int] = None) -> FrameFeatures:
        """One frame -> (n or chunk, ...) replicated batch."""
        return self._bcast(f, n=self.chunk if n is None else n)


class BatchedRegistrar:
    """Host-side helper: collects (features_a, features_b) pairs, pads the
    batch to the dp multiple, runs one sharded device program, returns
    per-pair host results.

    This is the component the frontend's loopClosure uses to verify all
    candidates of one round in a single launch instead of the reference's
    sequential 30-iteration loop (src/GraphicEnd.cpp:729-761).
    """

    def __init__(self, intr: CameraIntrinsics, image_only: bool,
                 error_threshold: float = 1.0, hypotheses: int = 256,
                 mesh: Optional[Mesh] = None, match_floor: float = 0.0):
        self.mesh = mesh
        self.dp = mesh.shape[mesh_mod.DP_AXIS] if mesh is not None else 1
        self.fn = build_batched_multipnp(
            intr, image_only=image_only, error_threshold=error_threshold,
            hypotheses=hypotheses, mesh=mesh, match_floor=match_floor,
        )

    def _dispatch_stacked(self, fa: FrameFeatures, fb: FrameFeatures,
                          key, min_inliers: int, n_valid: int):
        """Launch one pre-stacked (chunk, ...) batch; returns a
        (packed device array, n_valid) future for resolve_async."""
        from ..frontend.state import pack_result

        keys = jax.random.split(key, fa.uv.shape[0])
        res = self.fn(fa, fb, keys, jnp.int32(min_inliers))
        return pack_result(res), n_valid

    def run_stacked(self, fa: FrameFeatures, fb: FrameFeatures, key,
                    min_inliers: int, n_valid: int):
        """Register pre-stacked (chunk, ...) batches (FeatureStore
        gather/broadcast output) — zero eager shape-varying ops, so no
        recompiles as the keyframe set grows. Returns host tuples for
        the first n_valid rows."""
        return resolve_async(
            [self._dispatch_stacked(fa, fb, key, min_inliers, n_valid)])

    def run_against_one(self, store: "FeatureStore", indices, single,
                        key, min_inliers: int, single_is_target: bool = True):
        """Register store[indices] against one broadcast frame, chunked
        to the store's fixed batch shape. single_is_target: pairs are
        (store[i], single) — the loop-closure direction; False flips to
        (single, store[i]) (checknearby's outward walk)."""
        return resolve_async(self.dispatch_against_one(
            store, indices, single, key, min_inliers, single_is_target))

    def dispatch_fused(self, store: "FeatureStore", idx_dev, valid_dev,
                       single, key, min_inliers: int):
        """Fully on-device loop-closure round: candidate indices arrive
        as a DEVICE array (lcdb.select_candidates_device output), are
        gathered straight out of the feature store and verified against
        the broadcast query — zero host syncs end to end. Returns one
        (B, 21) packed device array ([:19] result row, [19] candidate
        index, [20] valid flag) for a deferred single-transfer drain."""
        from ..frontend.state import pack_result

        b = mesh_mod.pad_to_multiple(idx_dev.shape[0], self.dp)
        if b != idx_dev.shape[0]:
            # mesh-sharded fn requires B % dp == 0; padded rows are
            # flagged invalid so the drain discards them
            pad = b - idx_dev.shape[0]
            idx_dev = jnp.pad(idx_dev, (0, pad))
            valid_dev = jnp.pad(valid_dev, (0, pad))
        gathered = store.gather_dev(idx_dev)
        bcast = store.broadcast(single, n=b)
        keys = jax.random.split(key, b)
        if self.mesh is not None:
            # inputs arriving from other mesh programs (e.g. the sharded
            # lcdb's candidate indices) are committed with a replicated
            # spec; jit in_shardings refuses the mismatch instead of
            # resharding, so shard the batch axis explicitly here
            dp = NamedSharding(self.mesh, P(mesh_mod.DP_AXIS))
            gathered = jax.tree.map(
                lambda x: jax.device_put(x, dp), gathered)
            bcast = jax.tree.map(lambda x: jax.device_put(x, dp), bcast)
            keys = jax.device_put(keys, dp)
        res = self.fn(gathered, bcast, keys, jnp.int32(min_inliers))
        return _pack_with_meta(pack_result(res), idx_dev, valid_dev)

    def dispatch_against_one(self, store: "FeatureStore", indices, single,
                             key, min_inliers: int,
                             single_is_target: bool = True):
        """Async variant: launch the chunked registrations and return a
        list of (packed device array, n_valid) futures — no host sync.
        Resolve later with resolve_async (one transfer per chunk)."""
        pending = []
        bcast = store.broadcast(single)
        for c0 in range(0, len(indices), store.chunk):
            part = list(indices[c0:c0 + store.chunk])
            gathered = store.gather(part)
            fa, fb = ((gathered, bcast) if single_is_target
                      else (bcast, gathered))
            key, sub = jax.random.split(key)
            pending.append(self._dispatch_stacked(
                fa, fb, sub, min_inliers, len(part)))
        return pending

    def __call__(self, pairs, key, min_inliers: int, pad_to: int = 32):
        """pairs: list of (FrameFeatures, FrameFeatures). Returns a list of
        (T 4x4 np, norm, inliers, ok) per pair.

        The device batch shape is FIXED at `pad_to` (padded by the dp
        multiple): longer lists run in chunks of that size. One shape =
        one compile — jit recompiles per distinct batch size otherwise,
        and a frontend-sized multiPnP program can take minutes to build
        on remote-compile toolchains."""
        if not pairs:
            return []
        chunk = mesh_mod.pad_to_multiple(max(1, pad_to), self.dp)
        out = []
        for c0 in range(0, len(pairs), chunk):
            part = pairs[c0:c0 + chunk]
            b = len(part)
            fa = pad_batch(stack_features([p[0] for p in part]), chunk)
            fb = pad_batch(stack_features([p[1] for p in part]), chunk)
            key, sub = jax.random.split(key)
            out.extend(self.run_stacked(fa, fb, sub, min_inliers, b))
        return out
