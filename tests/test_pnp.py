import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from slam3d_gx.geometry import se3
from slam3d_gx.ops import pnp, polynomial
from slam3d_gx.testing import oracles

FX = FY = 517.0
CX, CY = 318.6, 255.3


def test_quartic_roots(rng):
    # build quartics from known roots
    roots = rng.normal(size=(32, 4)) * 3
    coeffs = np.stack([np.poly(r) for r in roots]).astype(np.float32)
    got = np.asarray(polynomial.quartic_roots(jnp.asarray(coeffs)))
    for i in range(32):
        got_sorted = np.sort(got[i].real)
        exp_sorted = np.sort(roots[i])
        np.testing.assert_allclose(got_sorted, exp_sorted, atol=5e-2)
        assert np.abs(got[i].imag).max() < 1e-2 * (1 + np.abs(got[i].real).max())


def test_quartic_complex_pairs():
    # (x^2+1)(x-2)(x-3) = x^4 -5x^3 + 7x^2 -5x + 6
    c = jnp.asarray([[1.0, -5.0, 7.0, -5.0, 6.0]])
    r = np.asarray(polynomial.quartic_roots(c))[0]
    real = r[np.abs(r.imag) < 1e-3].real
    np.testing.assert_allclose(np.sort(real), [2.0, 3.0], atol=1e-3)


@pytest.mark.parametrize("kind", sorted(oracles.QUARTIC_TOLERANCES))
def test_quartic_roots_match_np_roots(kind):
    coeffs = oracles.quartic_cases(kind, 1024, np.random.default_rng(5))
    got = np.asarray(polynomial.quartic_roots(jnp.asarray(coeffs)))
    assert np.isfinite(got).all()
    err = oracles.quartic_root_error(coeffs, got)
    median_tol, p99_tol = oracles.QUARTIC_TOLERANCES[kind]
    assert np.median(err) <= median_tol, np.median(err)
    assert np.quantile(err, 0.99) <= p99_tol, np.quantile(err, 0.99)


def make_scene(rng, n=100, planar=False, angle_scale=0.3, t_scale=0.3):
    """Random camera pose + 3D points in front of the camera."""
    rvec = rng.normal(size=3)
    rvec = rvec / np.linalg.norm(rvec) * rng.uniform(0, angle_scale)
    R = se3.rodrigues(rvec)
    t = rng.normal(size=3) * t_scale
    if planar:
        # points on a plane z=3 in world coords
        xy = rng.uniform(-1.5, 1.5, (n, 2))
        Pw = np.column_stack([xy[:, 0], xy[:, 1], np.full(n, 3.0)])
    else:
        Pw = rng.uniform(-1.5, 1.5, (n, 3)) + [0, 0, 3.0]
    Pc = Pw @ R.T + t
    uv = np.column_stack(
        [Pc[:, 0] * FX / Pc[:, 2] + CX, Pc[:, 1] * FY / Pc[:, 2] + CY]
    )
    return rvec, t, Pw.astype(np.float32), uv.astype(np.float32)


def test_p3p_recovers_pose():
    """Statistical exactness: near-double quartic roots cost ~1% of random
    triplets their exact solution in f32 (harmless inside RANSAC), so
    assert a >= 90% per-triplet recovery rate over 30 scenes."""
    local = np.random.default_rng(123)
    ok = 0
    trials = 30
    for _ in range(trials):
        rvec, t, Pw, uv = make_scene(local, n=3, angle_scale=1.0, t_scale=1.0)
        x = (uv[:, 0] - CX) / FX
        y = (uv[:, 1] - CY) / FY
        f = np.column_stack([x, y, np.ones(3)])
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        R4, t4, valid = pnp.p3p_grunert(
            jnp.asarray(Pw[None]), jnp.asarray(f[None], dtype=jnp.float32)
        )
        R4, t4, valid = map(np.asarray, (R4, t4, valid))
        R_true = se3.rodrigues(rvec)
        errs = [
            np.abs(R4[0, k] - R_true).max() + np.abs(t4[0, k] - t).max()
            for k in range(valid.shape[1])
            if valid[0, k]
        ]
        assert errs, "no valid P3P solution"
        if min(errs) < 5e-3:
            ok += 1
    assert ok >= trials * 0.9, f"only {ok}/{trials} triplets recovered exactly"


def test_solve_pnp_ransac_clean(rng):
    rvec, t, Pw, uv = make_scene(rng)
    res = pnp.solve_pnp_ransac(
        jnp.asarray(Pw), jnp.asarray(uv), jnp.ones(len(Pw), bool),
        FX, FY, CX, CY, jax.random.PRNGKey(0),
    )
    assert bool(res.ok)
    assert int(res.n_inliers) >= 95
    np.testing.assert_allclose(np.asarray(res.rvec), rvec, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.tvec), t, atol=1e-3)


def test_solve_pnp_ransac_outliers(rng):
    rvec, t, Pw, uv = make_scene(rng, n=150)
    uv = uv.copy()
    uv[100:] += rng.uniform(30, 120, size=(50, 2)).astype(np.float32)  # 33% outliers
    res = pnp.solve_pnp_ransac(
        jnp.asarray(Pw), jnp.asarray(uv), jnp.ones(len(Pw), bool),
        FX, FY, CX, CY, jax.random.PRNGKey(1),
    )
    assert bool(res.ok)
    inl = np.asarray(res.inliers)
    assert inl[:100].sum() >= 97  # finds the true inliers
    assert inl[100:].sum() <= 3   # rejects the corrupted ones
    np.testing.assert_allclose(np.asarray(res.rvec), rvec, atol=5e-3)
    np.testing.assert_allclose(np.asarray(res.tvec), t, atol=5e-3)


def test_solve_pnp_ransac_planar(rng):
    """Coplanar points — the per-plane PnP case (P3P must not degenerate)."""
    rvec, t, Pw, uv = make_scene(rng, planar=True)
    res = pnp.solve_pnp_ransac(
        jnp.asarray(Pw), jnp.asarray(uv), jnp.ones(len(Pw), bool),
        FX, FY, CX, CY, jax.random.PRNGKey(2),
    )
    assert bool(res.ok)
    assert int(res.n_inliers) >= 90
    np.testing.assert_allclose(np.asarray(res.rvec), rvec, atol=2e-2)
    np.testing.assert_allclose(np.asarray(res.tvec), t, atol=2e-2)


def test_solve_pnp_ransac_respects_mask(rng):
    rvec, t, Pw, uv = make_scene(rng, n=120)
    mask = np.ones(120, bool)
    uv = uv.copy()
    uv[80:] += 500.0  # garbage, but masked out
    mask[80:] = False
    res = pnp.solve_pnp_ransac(
        jnp.asarray(Pw), jnp.asarray(uv), jnp.asarray(mask),
        FX, FY, CX, CY, jax.random.PRNGKey(3),
    )
    assert bool(res.ok)
    assert not np.asarray(res.inliers)[80:].any()
    np.testing.assert_allclose(np.asarray(res.rvec), rvec, atol=1e-3)


def test_solve_pnp_with_guess(rng):
    rvec, t, Pw, uv = make_scene(rng)
    res = pnp.solve_pnp_ransac(
        jnp.asarray(Pw), jnp.asarray(uv), jnp.ones(len(Pw), bool),
        FX, FY, CX, CY, jax.random.PRNGKey(4),
        reproj_thresh=3.0,
        guess_rvec=jnp.asarray(rvec + 0.01, dtype=jnp.float32),
        guess_tvec=jnp.asarray(t + 0.01, dtype=jnp.float32),
    )
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.rvec), rvec, atol=1e-3)


def test_refine_pnp_converges_from_perturbation(rng):
    rvec, t, Pw, uv = make_scene(rng)
    rv0 = jnp.asarray(rvec + 0.05, dtype=jnp.float32)
    tv0 = jnp.asarray(t + np.array([0.05, -0.05, 0.1]), dtype=jnp.float32)
    rv, tv = pnp.refine_pnp(
        rv0, tv0, jnp.asarray(Pw), jnp.asarray(uv), jnp.ones(len(Pw)),
        FX, FY, CX, CY,
    )
    np.testing.assert_allclose(np.asarray(rv), rvec, atol=1e-4)
    np.testing.assert_allclose(np.asarray(tv), t, atol=1e-4)
