"""Sharded keyframe database — the long-context / sequence-parallel analog.

The reference's "sequence" is the keyframe history; its scaling devices
are random subsampling of loop-closure candidates (30 of K, reference
src/GraphicEnd.cpp:729-731) and an O(K) all-history scan in lostRecovery
(src/GraphicEnd.cpp:810-836). Redesign (SURVEY.md §5.7):

- the database is a fixed-capacity device-resident stack of per-keyframe
  descriptors (C, P*K, D) + masks, sharded over the "sp" mesh axis on C;
- candidate scoring is ONE batched einsum: the query frame's descriptors
  are broadcast (replicated) to every shard, each shard scores its
  keyframe block with the same min-dist matcher the frontend uses
  (ops/match.py), and the (C,) score vector comes back sp-sharded;
- when the history outgrows one chip, only C grows — the query stays
  replicated, so the collective cost is one all-gather of a single
  frame's descriptors (the ring-attention-style query broadcast).

Scores are *retrieval* scores (good-match counts). Acceptance still runs
full multiPnP (parallel/registration.py) on the top candidates, matching
the reference's accept gates exactly.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..frontend.state import FrameFeatures
from ..ops import match
from . import mesh as mesh_mod

P = PartitionSpec

_HI = jax.lax.Precision.HIGHEST


def _flatten(f: FrameFeatures):
    """(P,K,D) descriptors -> (P*K, D); validity folds plane_valid in."""
    p, k, d = f.desc.shape
    desc = f.desc.reshape(p * k, d)
    valid = (f.kp_valid & f.plane_valid[:, None]).reshape(p * k)
    return desc, valid


def _score_one(db_desc, db_valid, q_desc, q_valid, floor):
    """Retrieval score of query against one db keyframe.

    Primary term mirrors the frontend matcher (NN in db per query kp +
    the 3*min_dist gate with the descriptor-dependent `floor`,
    ops/match.py + features/registry.match_floor, reference
    src/GraphicEnd.cpp:486-520); without the floor a single exact
    binary-descriptor match collapses the bound and the score
    degenerates. The reference filter is deliberately loose, so a
    mean-NN-distance tiebreak (bounded to (0,1]) ranks frames with equal
    good counts by how well their descriptors actually agree.
    """
    _, dist, ok = match.match_nn(q_desc, q_valid, db_desc, db_valid)
    good = match.good_match_filter(dist, ok, floor=floor)
    n_ok = jnp.maximum(jnp.sum(ok), 1)
    mean_dist = jnp.sum(jnp.where(ok, dist, 0.0)) / n_ok
    return jnp.sum(good).astype(jnp.float32) + 1.0 / (1.0 + mean_dist)


@jax.jit
def score_block(db_desc, db_valid, q_desc, q_valid, floor):
    """(Cb, N, D) x (N_q, D) -> (Cb,) f32 retrieval scores."""
    return jax.vmap(_score_one, in_axes=(0, 0, None, None, None))(
        db_desc, db_valid, q_desc, q_valid, floor
    )


@functools.partial(jax.jit, static_argnames=("n_det", "k"))
def _select_candidates(db_desc, db_valid, q_desc, q_valid, floor, count,
                       n_det: int, k: int):
    """On-device loop-closure candidate selection: scores over the full
    capacity (masked to the eligible prefix), top-k draw, plus the
    deterministic newest-(-3,-4) checks — no host sync anywhere (the
    host-side top_candidates costs one device readback per keyframe).

    Returns ((n_det + k,) int32 candidate indices, (n_det + k,) bool
    valid). Candidate order mirrors the host path: deterministic checks
    first (record=False rows), ranked draws after (record=True rows).
    Eligibility matches the reference sampler's exclusion of the 3
    newest keyframes (src/GraphicEnd.cpp:731)."""
    s = score_block(db_desc, db_valid, q_desc, q_valid, floor)
    cap = s.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    eligible = idx < (count - 3)
    s = jnp.where(eligible, s, -jnp.inf)
    top_s, top_i = jax.lax.top_k(s, k)
    top_valid = jnp.isfinite(top_s)
    det = count - 3 - jnp.arange(n_det, dtype=jnp.int32)
    det_valid = det >= 0
    cand = jnp.concatenate([det, top_i.astype(jnp.int32)])
    valid = jnp.concatenate([det_valid, top_valid])
    return cand, valid


class KeyframeDatabase:
    """Fixed-capacity, device-resident keyframe descriptor store.

    Capacity grows by doubling (one re-upload per doubling); entries are
    written in place with a jitted dynamic-update so steady-state adds
    do not re-upload the database.
    """

    def __init__(self, n_desc: int, dim: int, capacity: int = 64,
                 mesh: Optional[Mesh] = None, match_floor: float = 0.0):
        self.mesh = mesh
        self.sp = mesh.shape[mesh_mod.SP_AXIS] if mesh is not None else 1
        self.n_desc = n_desc
        self.dim = dim
        self.match_floor = float(match_floor)
        self.count = 0
        self.capacity = mesh_mod.pad_to_multiple(capacity, self.sp)
        self._sharding = (
            NamedSharding(mesh, P(mesh_mod.SP_AXIS)) if mesh is not None else None
        )
        self._alloc(self.capacity)

        def _set(desc, valid, i, d, v):
            return desc.at[i].set(d), valid.at[i].set(v)

        donate = {"donate_argnums": (0, 1)}
        if self._sharding is not None:
            self._set = jax.jit(
                _set,
                out_shardings=(self._sharding, self._sharding),
                **donate,
            )
        else:
            self._set = jax.jit(_set, **donate)

    def _alloc(self, cap: int):
        desc = jnp.zeros((cap, self.n_desc, self.dim), jnp.float32)
        valid = jnp.zeros((cap, self.n_desc), bool)
        if self._sharding is not None:
            desc = jax.device_put(desc, self._sharding)
            valid = jax.device_put(valid, self._sharding)
        self.desc, self.valid = desc, valid

    def _grow(self):
        # device-side doubling (FeatureStore-style concatenate): a host
        # round-trip here would cost two syncs + a full database
        # re-upload per doubling
        self.capacity *= 2
        d = jnp.concatenate([self.desc, jnp.zeros_like(self.desc)], axis=0)
        v = jnp.concatenate([self.valid, jnp.zeros_like(self.valid)], axis=0)
        if self._sharding is not None:
            d = jax.device_put(d, self._sharding)
            v = jax.device_put(v, self._sharding)
        self.desc, self.valid = d, v

    def add(self, features: FrameFeatures) -> int:
        if self.count == self.capacity:
            self._grow()
        d, v = _flatten(features)
        i = self.count
        self.desc, self.valid = self._set(
            self.desc, self.valid, jnp.int32(i), d, v
        )
        self.count += 1
        return i

    def scores(self, query: FrameFeatures) -> np.ndarray:
        """(count,) good-match counts of query vs every stored keyframe.

        One device program; with a mesh, each sp shard scores its block
        of the database against the replicated query.
        """
        if self.count == 0:
            return np.zeros((0,), np.float32)
        qd, qv = _flatten(query)
        s = score_block(self.desc, self.valid, qd, qv,
                        jnp.float32(self.match_floor))
        return np.asarray(s)[: self.count]

    def select_candidates_device(self, query: FrameFeatures, n: int,
                                 n_det: int = 2):
        """Async variant of top_candidates fused with the deterministic
        -3/-4 checks: returns ((n_det+n,) int32 idx, (n_det+n,) bool
        valid) DEVICE arrays — zero host syncs; the caller threads them
        into a gather + batched verification and reads everything back
        in one deferred transfer (frontend loop_closure fused path)."""
        qd, qv = _flatten(query)
        return _select_candidates(
            self.desc, self.valid, qd, qv,
            jnp.float32(self.match_floor), jnp.int32(self.count),
            n_det=n_det, k=n)

    def top_candidates(self, query: FrameFeatures, n: int,
                       exclude_newest: int = 3) -> list:
        """Best-scoring keyframe indices, excluding the newest few (the
        reference's random sampler also excludes the 3 newest,
        src/GraphicEnd.cpp:731)."""
        s = self.scores(query)
        hi = max(0, len(s) - exclude_newest)
        s = s[:hi]
        if len(s) == 0:
            return []
        order = np.argsort(-s, kind="stable")
        return [int(i) for i in order[:n]]
