"""Unit tests for the loop_closure_max_drift consistency gate.

The lc_audit harness measured a 1.8% class of accepted loop edges with
~1.3 m translation error from perceptual aliasing (wrong-but-consistent
registrations that pass the reference's norm/inlier gates,
src/GraphicEnd.cpp:739-760). The gate compares the measurement against
dead-reckoned world-pose hints maintained at every promotion site
(hint_new = hint_prev @ Z_edge); these tests build the hints through
that exact chain rule on a NON-commuting trajectory — a pure orbit is
a one-parameter subgroup where any composition convention agrees, which
is how the original (wrong) convention slipped past orbit-only tests.
"""

import numpy as np

from slam3d_gx.config import ParameterReader
from slam3d_gx.frontend.graphic_end import GraphicEnd
from slam3d_gx.frontend.state import Keyframe
from slam3d_gx.geometry import se3


class _GateHost:
    """Just the gate's state surface — no pipeline construction."""

    _lc_within_drift = GraphicEnd._lc_within_drift
    _chain_pose_hint = GraphicEnd._chain_pose_hint
    _reanchor_pose_hint = GraphicEnd._reanchor_pose_hint

    def __init__(self, max_drift):
        self.lc_max_drift = max_drift
        self._kf_pose = {}


def _wandering_chain(n=12, seed=3):
    """Ground-truth poses of a wandering, genuinely non-commuting
    trajectory (rotations about varying axes + translations)."""
    rng = np.random.default_rng(seed)
    g = [np.eye(4)]
    for _ in range(1, n):
        step = se3.make_isometry(
            se3.rodrigues(rng.normal(0, 0.25, 3)),
            rng.normal(0, 0.15, 3))
        g.append(g[-1] @ step)
    return g


def _host_with_chain(gt, max_drift):
    """Hints built EXACTLY as the frontend does: anchor at identity,
    then hint_new = hint_prev @ Z with Z the sequential measurement
    inv(g_prev) @ g_new (the right-composed relative multiPnP measures,
    verified empirically by lc_audit's direction calibration)."""
    h = _GateHost(max_drift)
    h._kf_pose[0] = np.eye(4)
    for k in range(1, len(gt)):
        Z = se3.inverse(gt[k - 1]) @ gt[k]
        h._chain_pose_hint(k, Z)
    return h


def _kf(i):
    return Keyframe(id=i, frame_index=i + 1, features=None)


def test_gate_off_accepts_everything():
    h = _GateHost(0.0)
    h._kf_pose = {0: np.eye(4), 1: np.eye(4)}
    Z = se3.make_isometry(np.eye(3), [5.0, 0, 0])
    assert h._lc_within_drift(_kf(0), _kf(1), Z)


def test_gate_on_noncommuting_chain():
    gt = _wandering_chain()
    h = _host_with_chain(gt, 0.5)
    a, b = 2, len(gt) - 1
    # true loop measurement between distant keyframes: accepted
    Z_true = se3.inverse(gt[a]) @ gt[b]
    assert h._lc_within_drift(_kf(a), _kf(b), Z_true)
    # drift-scale perturbation: accepted
    Z_drift = Z_true.copy()
    Z_drift[:3, 3] += [0.05, -0.02, 0.03]
    assert h._lc_within_drift(_kf(a), _kf(b), Z_drift)
    # the measured aliasing class (~1.3 m off): rejected
    Z_alias = Z_true.copy()
    Z_alias[:3, 3] += [1.3, 0.0, 0.0]
    assert not h._lc_within_drift(_kf(a), _kf(b), Z_alias)


def test_gate_exact_on_every_pair():
    """The dead-reckoned chain telescopes: with noise-free sequential
    measurements the prediction equals the true relative for EVERY
    pair, so deviation is ~0 regardless of trajectory shape."""
    gt = _wandering_chain(n=10, seed=7)
    h = _host_with_chain(gt, 1e-6)  # absurdly tight gate
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            Z = se3.inverse(gt[a]) @ gt[b]
            assert h._lc_within_drift(_kf(a), _kf(b), Z), (a, b)


def test_gate_permissive_across_broken_chain_and_reanchors():
    gt = _wandering_chain()
    h = _host_with_chain(gt, 0.5)
    # blackout at keyframe 5: chain broken, gate permissive
    h._kf_pose[5] = None
    h._chain_pose_hint(6, np.eye(4))  # propagates the break
    assert h._kf_pose[6] is None
    Z_bogus = se3.make_isometry(np.eye(3), [9.0, 0, 0])
    assert h._lc_within_drift(_kf(2), _kf(6), Z_bogus)
    # an accepted recovery edge re-anchors; the gate bites again
    Z_re = se3.inverse(gt[2]) @ gt[6]
    h._reanchor_pose_hint(6, 2, Z_re)
    assert h._kf_pose[6] is not None
    assert h._lc_within_drift(_kf(2), _kf(6), Z_re)
    assert not h._lc_within_drift(_kf(2), _kf(6), Z_bogus)


def test_config_key_default_off():
    p = ParameterReader(None, overrides={})
    assert p.get_float("loop_closure_max_drift") == 0.0
