"""Differential validation of tools/evaluate_rpe.py against the TUM
original the reference vendors (VERDICT r3 weak #5 / directive #6).

The reference script (/root/reference/tools/evaluate_rpe.py) is
python-2; its core functions are pure except for two `dict.keys()`
sorts, so this test loads the reference source at runtime, truncates
the py2-syntax `__main__` block, patches the two py2-isms, and execs it
as the oracle. Nothing from the reference is copied into the repo —
the oracle lives only in this test's memory and is skipped when the
reference checkout is absent.

Asserted: identical pair selection and per-pair translation/rotation
errors (to fp tolerance) across all-pairs, random-sampled, and
fixed-delta (s/f/m units) modes, with non-trivial offset and scale.
"""

import os
import random

import numpy as np
import pytest

from tools import evaluate_rpe as mine

REF_PATH = "/root/reference/tools/evaluate_rpe.py"


@pytest.fixture(scope="module")
def ref_rpe():
    if not os.path.exists(REF_PATH):
        pytest.skip("reference checkout not available")
    src = open(REF_PATH).read()
    cut = src.index("if __name__ ==")
    src = src[:cut]
    # py2-ism: list(dict.keys()).sort() idiom; everything else is py3-clean
    src = src.replace("keys = traj.keys()", "keys = sorted(traj.keys())")
    src = src.replace("keys.sort()", "pass")
    ns = {"__name__": "ref_evaluate_rpe"}
    exec(compile(src, REF_PATH, "exec"), ns)
    return ns


def make_trajectories(n=60, hz=30.0, seed=5):
    """Ground truth at hz with jitter; estimate = noisy subset with a
    small time offset, like a real keyframe trajectory."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / hz + rng.normal(0, 1e-3, n) + 1_300_000_000.0
    gt, est = {}, {}
    T = np.eye(4)
    from slam3d_gx.geometry import se3

    for i in range(n):
        w = rng.normal(0, 0.03, 3)
        v = np.array([0.02, 0.0, 0.01]) + rng.normal(0, 0.005, 3)
        T = T @ se3.make_isometry(se3.rodrigues(w), v)
        gt[float(t[i])] = T.copy()
        if i % 2 == 0:  # estimate at half rate
            N = se3.make_isometry(
                se3.rodrigues(rng.normal(0, 0.01, 3)),
                rng.normal(0, 0.01, 3))
            est[float(t[i]) + 0.004] = T @ N
    return gt, est


CASES = [
    dict(param_max_pairs=0, param_fixed_delta=False),
    dict(param_max_pairs=500, param_fixed_delta=False),
    dict(param_fixed_delta=True, param_delta=1.0, param_delta_unit="s"),
    dict(param_fixed_delta=True, param_delta=3, param_delta_unit="f"),
    dict(param_fixed_delta=True, param_delta=0.05, param_delta_unit="m"),
    dict(param_fixed_delta=True, param_delta=0.2, param_delta_unit="rad"),
    dict(param_fixed_delta=True, param_delta=1.0, param_delta_unit="s",
         param_offset=0.05, param_scale=1.3),
]


@pytest.mark.parametrize("kw", CASES,
                         ids=[f"case{i}" for i in range(len(CASES))])
def test_rpe_matches_reference(ref_rpe, kw):
    gt, est = make_trajectories()
    random.seed(17)
    ours = np.array(mine.evaluate_trajectory(gt, est, **kw))
    random.seed(17)
    ref = np.array(ref_rpe["evaluate_trajectory"](gt, est, **kw))
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    # stamps exactly; errors to fp tolerance (inv vs solve ordering)
    np.testing.assert_array_equal(ours[:, :4], ref[:, :4])
    np.testing.assert_allclose(ours[:, 4:], ref[:, 4:], rtol=1e-9,
                               atol=1e-12)


def test_read_trajectory_matches_reference(ref_rpe, tmp_path):
    gt, est = make_trajectories(n=20)
    p = tmp_path / "traj.txt"
    with open(p, "w") as f:
        f.write("# comment line\n")
        for ts, T in gt.items():
            from slam3d_gx.geometry import se3

            q = se3.rot_to_quat(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{ts:.6f} {tx} {ty} {tz} {q[0]} {q[1]} {q[2]} {q[3]}\n")
        f.write("\n")
    ours = mine.read_trajectory(str(p))
    ref = ref_rpe["read_trajectory"](str(p))
    assert set(ours) == set(ref)
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, atol=1e-12)


def test_transform44_and_angle_match(ref_rpe):
    rng = np.random.default_rng(0)
    for _ in range(50):
        row = [0.0, *rng.normal(0, 1, 3), *rng.normal(0, 1, 4)]
        ours = mine.transform44(row[1:])
        ref = ref_rpe["transform44"](row)
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
        E = ours @ np.linalg.inv(ref_rpe["transform44"]([0.0, *rng.normal(0, 1, 3), *rng.normal(0, 1, 4)]))
        np.testing.assert_allclose(mine.compute_angle(E),
                                   ref_rpe["compute_angle"](E), rtol=1e-12)
        np.testing.assert_allclose(mine.compute_distance(E),
                                   ref_rpe["compute_distance"](E), rtol=1e-12)
