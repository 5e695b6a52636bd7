"""Frontend world model: fixed-shape, masked feature containers.

Parity target: the PLANE / KEYFRAME / RESULT_OF_MULTIPNP structs
(reference src/GraphicEnd.h:41-69), re-shaped for jit: ragged
vector<PLANE>/vector<KeyPoint> become (P, K, ...) padded stacks with
validity masks, so every downstream kernel sees static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import jax.numpy as jnp


class FrameFeatures(NamedTuple):
    """All planes of one frame (P = max_planes; GraphicEnd2 uses P = 1).

    coeffs: (P,4) plane [a,b,c,d]; plane_valid: (P,);
    uv: (P,K,2) keypoint pixels; kp3d: (P,K,3) backprojected positions;
    desc: (P,K,D) descriptors; kp_valid: (P,K).
    """

    coeffs: jnp.ndarray
    plane_valid: jnp.ndarray
    uv: jnp.ndarray
    kp3d: jnp.ndarray
    desc: jnp.ndarray
    kp_valid: jnp.ndarray

    @property
    def n_planes(self) -> int:
        return self.coeffs.shape[0]

    @property
    def max_kp(self) -> int:
        return self.uv.shape[1]


def empty_frame(p: int, k: int, d: int = 128) -> FrameFeatures:
    return FrameFeatures(
        coeffs=jnp.zeros((p, 4), jnp.float32),
        plane_valid=jnp.zeros((p,), bool),
        uv=jnp.zeros((p, k, 2), jnp.float32),
        kp3d=jnp.zeros((p, k, 3), jnp.float32),
        desc=jnp.zeros((p, k, d), jnp.float32),
        kp_valid=jnp.zeros((p, k), bool),
    )


class MultiPnPResult(NamedTuple):
    """RESULT_OF_MULTIPNP analog (reference src/GraphicEnd.h:59-69).

    The reference's failure sentinel is T == Identity — `ok` carries the
    same bit explicitly; callers that need the sentinel check use it.
    """

    T: jnp.ndarray        # (4,4)
    norm: jnp.ndarray     # ()
    inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray       # () bool


@dataclasses.dataclass
class Keyframe:
    """KEYFRAME analog (reference src/GraphicEnd.h:51-57), host-side."""

    id: int
    frame_index: int
    features: FrameFeatures
    connect: List[int] = dataclasses.field(default_factory=list)


def pack_result(res: MultiPnPResult):
    """Flatten a result batch into ONE device array so the host pays a
    single device-to-host transfer instead of one per field."""
    T = res.T.reshape(res.T.shape[:-2] + (16,)).astype(jnp.float32)
    tail = jnp.stack([
        res.norm.astype(jnp.float32),
        res.inliers.astype(jnp.float32),
        res.ok.astype(jnp.float32),
    ], axis=-1)
    return jnp.concatenate([T, tail], axis=-1)  # (..., 19)


def unpack_result_row(row: np.ndarray):
    """One packed row -> (np 4x4 T float64, norm, inliers, ok)."""
    return (
        row[:16].astype(np.float64).reshape(4, 4),
        float(row[16]),
        int(row[17]),
        bool(row[18] != 0.0),
    )


def result_to_host(res: MultiPnPResult):
    """Device result -> (np 4x4 T, float norm, int inliers, bool ok).

    One packed transfer (see pack_result)."""
    return unpack_result_row(np.asarray(pack_result(res)))
