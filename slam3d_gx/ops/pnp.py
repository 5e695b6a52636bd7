"""Batched RANSAC PnP: P3P minimal solves + Gauss-Newton refinement.

A replacement for cv::solvePnPRansac (14 reference call sites,
e.g. src/GraphicEnd.cpp:542,595,615; SURVEY.md §2.2). The reference's
sequential 100-iteration RANSAC becomes one batch of B hypotheses:

  sample B 3-point subsets -> Grunert P3P quartics (Durand-Kerner roots)
  -> up to 4B candidate poses -> score every candidate against all N
  correspondences with one batched projection -> argmax inliers ->
  masked Gauss-Newton polish on the winner's inliers.

Coplanar points are fine (P3P doesn't degenerate like DLT/EPnP), which the
per-plane PnP of the plane pipeline requires (reference pnp() feeds points
from a single RANSAC plane, src/GraphicEnd.cpp:522-554).

`useExtrinsicGuess` semantics (second refinement pass at 3px,
src/GraphicEnd.cpp:615): the guess joins the hypothesis pool and the final
polish starts from the best model, exactly the role the guess plays in
OpenCV's implementation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie
from .polynomial import quartic_roots, real_roots_mask

_HI = jax.lax.Precision.HIGHEST


class PnPResult(NamedTuple):
    rvec: jnp.ndarray      # (3,)
    tvec: jnp.ndarray      # (3,)
    inliers: jnp.ndarray   # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray        # () bool — a model with >= 4 inliers was found


# ---------------------------------------------------------------------------
# P3P (Grunert) — batched
# ---------------------------------------------------------------------------


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(x * x + y * y + z * z + 1e-24)
    return x * inv, y * inv, z * inv


def _frame_comps(ax, ay, az, bx, by, bz, cx_, cy_, cz_):
    """Orthonormal frame columns (e1,e2,e3) from three points given as
    component arrays (any common broadcastable shape): e1 along B-A,
    e2 the orthogonalized C-A, e3 their cross product.

    This replaces a (...,3,3)-tensor Kabsch alignment: batched tiny SVDs
    lower to a slow sequential path, and component arrays keep the
    candidate axis minor (no trailing axes of 3; whether that still
    pays on the GPU is unmeasured). P3P triplets are *exact*
    correspondences by construction, so least-squares is unnecessary; degenerate
    (near-collinear) triplets produce garbage poses that the RANSAC
    inlier scoring discards."""
    e1x, e1y, e1z = _normalize3(bx - ax, by - ay, bz - az)
    vx, vy, vz = cx_ - ax, cy_ - ay, cz_ - az
    d = vx * e1x + vy * e1y + vz * e1z
    e2x, e2y, e2z = _normalize3(vx - d * e1x, vy - d * e1y, vz - d * e1z)
    e3x = e1y * e2z - e1z * e2y
    e3y = e1z * e2x - e1x * e2z
    e3z = e1x * e2y - e1y * e2x
    return ((e1x, e1y, e1z), (e2x, e2y, e2z), (e3x, e3y, e3z))


def _p3p_grunert_comps(P, f):
    """Grunert's P3P in component form: world triplets + unit bearing
    triplets -> candidate poses as UNPACKED components.

    Args:
      P: (B,3,3) world points (rows); f: (B,3,3) unit bearing vectors.
    Returns:
      r: 9-tuple of (S,B) arrays (row-major R entries), t: 3-tuple of
      (S,B), valid: (S,B) bool — S=12 candidate slots (4 quartic roots
      x 3 Newton seeds; duplicates are harmless, the RANSAC scorer just
      re-ranks them).

    Layout: every candidate-sized intermediate is (S,B) with the
    hypothesis batch minor, with no trailing candidate/root/coordinate
    axis (4, 12, 3...).
    """
    P1x, P1y, P1z = P[:, 0, 0], P[:, 0, 1], P[:, 0, 2]
    P2x, P2y, P2z = P[:, 1, 0], P[:, 1, 1], P[:, 1, 2]
    P3x, P3y, P3z = P[:, 2, 0], P[:, 2, 1], P[:, 2, 2]
    f1x, f1y, f1z = f[:, 0, 0], f[:, 0, 1], f[:, 0, 2]
    f2x, f2y, f2z = f[:, 1, 0], f[:, 1, 1], f[:, 1, 2]
    f3x, f3y, f3z = f[:, 2, 0], f[:, 2, 1], f[:, 2, 2]

    a2 = (P2x - P3x) ** 2 + (P2y - P3y) ** 2 + (P2z - P3z) ** 2
    b2 = (P1x - P3x) ** 2 + (P1y - P3y) ** 2 + (P1z - P3z) ** 2
    c2 = (P1x - P2x) ** 2 + (P1y - P2y) ** 2 + (P1z - P2z) ** 2
    ca = f2x * f3x + f2y * f3y + f2z * f3z  # cos(alpha)
    cb = f1x * f3x + f1y * f3y + f1z * f3z  # cos(beta)
    cg = f1x * f2x + f1y * f2y + f1z * f2z  # cos(gamma)

    b2s = jnp.where(b2 > 1e-12, b2, 1e-12)
    A = a2 / b2s
    B = c2 / b2s
    amc = (a2 - c2) / b2s  # (a^2 - c^2)/b^2

    # Haralick et al., Grunert quartic coefficients in v (s3 = v s1)
    A4 = (amc - 1.0) ** 2 - 4.0 * B * ca**2
    A3 = 4.0 * (
        amc * (1.0 - amc) * cb
        - (1.0 - (A + B)) * ca * cg
        + 2.0 * B * ca**2 * cb
    )
    A2 = 2.0 * (
        amc**2
        - 1.0
        + 2.0 * amc**2 * cb**2
        + 2.0 * (1.0 - B) * ca**2
        - 4.0 * (A + B) * ca * cb * cg
        + 2.0 * (1.0 - A) * cg**2
    )
    A1 = 4.0 * (
        -amc * (1.0 + amc) * cb
        + 2.0 * A * cg**2 * cb
        - (1.0 - (A + B)) * ca * cg
    )
    A0 = (1.0 + amc) ** 2 - 4.0 * A * cg**2

    coeffs = jnp.stack([A4, A3, A2, A1, A0], axis=-1)
    roots = quartic_roots(coeffs)  # (B,4) complex

    is_real = real_roots_mask(roots, rel_tol=5e-2)
    # roots-major layout from here on: (S,B) with the batch minor
    v = roots.real.T  # (4,B)
    # triple each root with +/- perturbed seeds: near-double roots (f32
    # root finding resolves them only to ~sqrt(eps)) can collapse into one
    # Newton basin below; the offset seeds recover the sibling branch
    v = jnp.concatenate([v, v + 4e-3, v - 4e-3], axis=0)  # (12,B)
    is_real = jnp.tile(is_real.T, (3, 1))
    v_ok = is_real & (v > 1e-6)

    # u from the relation (Haralick eq. between the two conics)
    amc_, ca_, cb_, cg_ = amc[None], ca[None], cb[None], cg[None]
    denom_u = 2.0 * (cg_ - v * ca_)
    u = (
        (-1.0 + amc_) * v**2
        - 2.0 * amc_ * cb_ * v
        + 1.0
        + amc_
    ) / jnp.where(jnp.abs(denom_u) > 1e-9, denom_u, 1e-9)

    # Newton-polish (u,v) on the original law-of-cosine constraints —
    # far better conditioned than the quartic near double roots (which
    # f32 root finding only resolves to ~sqrt(eps)):
    #   F1 = (u^2+v^2-2uv ca) - A (1+v^2-2v cb)
    #   F2 = (1+u^2-2u cg)    - B (1+v^2-2v cb)
    Ac = A[None]
    Bc = B[None]
    for _ in range(4):
        F1 = (u * u + v * v - 2 * u * v * ca_) - Ac * (1 + v * v - 2 * v * cb_)
        F2 = (1 + u * u - 2 * u * cg_) - Bc * (1 + v * v - 2 * v * cb_)
        j11 = 2 * u - 2 * v * ca_
        j12 = 2 * v - 2 * u * ca_ - Ac * (2 * v - 2 * cb_)
        j21 = 2 * u - 2 * cg_
        j22 = -Bc * (2 * v - 2 * cb_)
        det = j11 * j22 - j12 * j21
        det = jnp.where(jnp.abs(det) > 1e-9, det, 1e-9)
        u = u - (j22 * F1 - j12 * F2) / det
        v = v - (-j21 * F1 + j11 * F2) / det

    s1sq = b2s[None] / (1.0 + v**2 - 2.0 * v * cb_)
    s1 = jnp.sqrt(jnp.clip(s1sq, 1e-12, None))
    s2 = u * s1
    s3 = v * s1
    valid = v_ok & (u > 1e-6) & (s1sq > 1e-12)

    # camera-frame points (component form), then absolute orientation
    X1x, X1y, X1z = s1 * f1x[None], s1 * f1y[None], s1 * f1z[None]
    X2x, X2y, X2z = s2 * f2x[None], s2 * f2y[None], s2 * f2z[None]
    X3x, X3y, X3z = s3 * f3x[None], s3 * f3y[None], s3 * f3z[None]

    EX = _frame_comps(X1x, X1y, X1z, X2x, X2y, X2z, X3x, X3y, X3z)
    EP = _frame_comps(P1x[None], P1y[None], P1z[None],
                      P2x[None], P2y[None], P2z[None],
                      P3x[None], P3y[None], P3z[None])

    # R = Ex @ Ep^T: R[i][j] = sum_k e_k^X[i] * e_k^P[j]
    r = tuple(
        EX[0][i] * EP[0][j] + EX[1][i] * EP[1][j] + EX[2][i] * EP[2][j]
        for i in range(3) for j in range(3)
    )
    cXx = (X1x + X2x + X3x) / 3.0
    cXy = (X1y + X2y + X3y) / 3.0
    cXz = (X1z + X2z + X3z) / 3.0
    cPx = ((P1x + P2x + P3x) / 3.0)[None]
    cPy = ((P1y + P2y + P3y) / 3.0)[None]
    cPz = ((P1z + P2z + P3z) / 3.0)[None]
    t = (
        cXx - (r[0] * cPx + r[1] * cPy + r[2] * cPz),
        cXy - (r[3] * cPx + r[4] * cPy + r[5] * cPz),
        cXz - (r[6] * cPx + r[7] * cPy + r[8] * cPz),
    )
    return r, t, valid


def p3p_grunert(P, f):
    """Grunert's P3P: world triplets + unit bearing triplets -> candidates.

    Args:
      P: (B,3,3) world points (rows); f: (B,3,3) unit bearing vectors.
    Returns:
      R: (B,S,3,3), t: (B,S,3), valid: (B,S) — S=12 candidate slots.

    Packing wrapper over _p3p_grunert_comps (the hot RANSAC path
    consumes the component form directly; this tensor form serves tests
    and external callers).
    """
    r, t, valid = _p3p_grunert_comps(P, f)
    R = jnp.stack([jnp.stack(r[3 * i:3 * i + 3], axis=-1)
                   for i in range(3)], axis=-2)  # (S,B,3,3)
    tt = jnp.stack(t, axis=-1)  # (S,B,3)
    return (jnp.moveaxis(R, 0, 1), jnp.moveaxis(tt, 0, 1), valid.T)


# ---------------------------------------------------------------------------
# projection + scoring
# ---------------------------------------------------------------------------


def _project_uvz(R, t, pts, fx, fy, cx, cy):
    """R (...,3,3), t (...,3), pts (N,3) -> u, v, z each (...,N).

    Layout: instead of the einsum form's (...,N,3) camera-frame points
    and (...,N,2) pixels, the rotation is unpacked into nine (...,1)
    scalars broadcast against (N,) coordinate rows, so every
    intermediate is an (...,N) array with no small trailing axis.
    """
    x, y, zz = pts[:, 0], pts[:, 1], pts[:, 2]  # (N,) each
    r = R[..., None]  # (...,3,3,1) scalar broadcast stubs
    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
    px = r[..., 0, 0, :] * x + r[..., 0, 1, :] * y + r[..., 0, 2, :] * zz + tx
    py = r[..., 1, 0, :] * x + r[..., 1, 1, :] * y + r[..., 1, 2, :] * zz + ty
    pz = r[..., 2, 0, :] * x + r[..., 2, 1, :] * y + r[..., 2, 2, :] * zz + tz
    safe_z = jnp.where(jnp.abs(pz) > 1e-9, pz, 1e-9)
    u = px * fx / safe_z + cx
    v = py * fy / safe_z + cy
    return u, v, pz


def _project(R, t, pts, fx, fy, cx, cy):
    """R (...,3,3), t (...,3), pts (N,3) -> (...,N,2) pixels.

    Einsum form, kept for the Gauss-Newton residual path: it sits under
    jacfwd inside the unrolled LM loop, and the scalar-component
    expansion there multiplied the op count enough to blow XLA:CPU
    compile time from seconds to >10 min (6 tangents x 10 unrolled
    steps x ~10x ops). Hot scoring loops use _project_uvz."""
    pc = jnp.einsum("...ij,nj->...ni", R, pts, precision=_HI) + t[..., None, :]
    z = pc[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-9, z, 1e-9)
    u = pc[..., 0] * fx / safe_z + cx
    v = pc[..., 1] * fy / safe_z + cy
    return jnp.stack([u, v], axis=-1), z


def reprojection_errors(rvec, tvec, obj, img, fx, fy, cx, cy):
    R = lie.rodrigues(rvec)
    u, v, z = _project_uvz(R, tvec, obj, fx, fy, cx, cy)
    du = u - img[..., 0]
    dv = v - img[..., 1]
    err = jnp.sqrt(du * du + dv * dv)
    return jnp.where(z > 0, err, jnp.inf)


# ---------------------------------------------------------------------------
# Gauss-Newton refinement on SE(3)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("iters",))
def refine_pnp(rvec, tvec, obj, img, weights, fx, fy, cx, cy, iters: int = 10):
    """Levenberg-damped Gauss-Newton on the reprojection objective.

    weights: (N,) float (0 masks a correspondence out).
    """
    def residuals(x):
        rv, tv = x[:3], x[3:]
        R = lie.rodrigues(rv)
        uv, z = _project(R, tv, obj, fx, fy, cx, cy)
        r = (uv - img) * jnp.sqrt(weights)[:, None]
        return jnp.where(jnp.isfinite(r), r, 0.0).reshape(-1)

    jac_fn = jax.jacfwd(residuals)

    def step(carry, _):
        x, lam, e = carry
        r = residuals(x)
        J = jac_fn(x)
        H = jnp.matmul(J.T, J, precision=_HI)
        g = J.T @ r
        H = H + lam * jnp.diag(jnp.diag(H) + 1e-9)
        dx = jnp.linalg.solve(H, -g)
        x_new = x + dx
        e_new = jnp.sum(residuals(x_new) ** 2)
        better = e_new < e
        x = jnp.where(better, x_new, x)
        e = jnp.where(better, e_new, e)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (x, lam, e), None

    x0 = jnp.concatenate([rvec, tvec])
    e0 = jnp.sum(residuals(x0) ** 2)
    # unrolled: per-step ops are tiny (6x6 solve + one (2N,6) jacobian);
    # scan would pay per-step launch latency
    (x, _, _), _ = jax.lax.scan(
        step, (x0, jnp.float32(1e-3), e0), None, length=iters, unroll=iters
    )
    return x[:3], x[3:]


# ---------------------------------------------------------------------------
# full RANSAC PnP
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("hypotheses", "refine_iters", "prescore")
)
def solve_pnp_ransac(
    obj,
    img,
    mask,
    fx,
    fy,
    cx,
    cy,
    key,
    reproj_thresh: float = 8.0,
    hypotheses: int = 256,
    min_inliers: int = 4,
    refine_iters: int = 10,
    guess_rvec=None,
    guess_tvec=None,
    prescore: int = 128,
) -> PnPResult:
    """obj (N,3) world, img (N,2) pixels, mask (N,) valid correspondences.

    Mirrors cv::solvePnPRansac's contract: inlier set of the best model at
    `reproj_thresh`, pose refined on those inliers. When a guess is given
    it competes as an extra hypothesis (useExtrinsicGuess analog).

    prescore: two-stage preemptive scoring (Nister '05-style): every P3P
    candidate is scored on a strided `prescore`-point subset and only the
    top 32 are re-scored on all N points (the winner of the subset round
    survives into the final round with overwhelming probability — RANSAC
    consensus is a sum of ~N Bernoulli draws, and 128 points separate
    models whose inlier rates differ by more than a few percent). Cuts
    the dominant scoring cost ~N/prescore-fold; 0 restores exact
    single-stage scoring over all candidates. A supplied guess skips the
    subset round and is always fully scored.
    """
    N = obj.shape[0]
    obj = obj.astype(jnp.float32)
    img = img.astype(jnp.float32)
    w = mask.astype(jnp.float32)

    # bearings
    x = (img[:, 0] - cx) / fx
    y = (img[:, 1] - cy) / fy
    f = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    # sample triplets of valid correspondences — rank-matched uniform:
    # jax.random.categorical draws (hyp,3,N) gumbel noise, a large
    # share of the whole solve at hyp=256,N=512; a uniform rank in
    # [0, n_valid) is the identical distribution from (hyp,3) RNG
    # values, and rank->row resolution is one one-hot contraction
    # instead of a random gather
    nv = jnp.sum(mask.astype(jnp.int32))
    cm = jnp.cumsum(mask.astype(jnp.int32))
    pos = jnp.where(mask, cm - 1, -1)  # rank of each valid row, -1 invalid
    u = jax.random.uniform(key, (hypotheses, 3))
    r_rank = jnp.clip(jnp.floor(u * nv.astype(jnp.float32)).astype(jnp.int32),
                      0, jnp.maximum(nv - 1, 0))
    eq = (r_rank[..., None] == pos[None, None, :]).astype(jnp.float32)
    P = jnp.matmul(eq, obj, precision=_HI)  # (B,3,3) one-hot gather
    F = jnp.matmul(eq, f, precision=_HI)
    # degenerate samples (repeated ranks <=> repeated rows) -> invalid;
    # nv<3 leaves no distinct triplet at all
    distinct = (
        (r_rank[:, 0] != r_rank[:, 1])
        & (r_rank[:, 0] != r_rank[:, 2])
        & (r_rank[:, 1] != r_rank[:, 2])
        & (nv >= 3)
    )

    # candidate poses stay in component form ((S,) arrays per R entry)
    # end to end, no (S,3,3) tensors (see _p3p_grunert_comps)
    r_c, t_c, vcand = _p3p_grunert_comps(P, F)
    vf = (vcand & distinct[None, :]).reshape(-1)
    rf = [c.reshape(-1) for c in r_c]
    tf = [c.reshape(-1) for c in t_c]

    th2 = reproj_thresh * reproj_thresh

    def _score(rc, tc, o, im, m):
        """Squared-distance consensus on (S, N) arrays
        (no stacked uv/pc tensors, no sqrt)."""
        x, y, zz = o[:, 0], o[:, 1], o[:, 2]
        px = (rc[0][:, None] * x + rc[1][:, None] * y
              + rc[2][:, None] * zz + tc[0][:, None])
        py = (rc[3][:, None] * x + rc[4][:, None] * y
              + rc[5][:, None] * zz + tc[1][:, None])
        pz = (rc[6][:, None] * x + rc[7][:, None] * y
              + rc[8][:, None] * zz + tc[2][:, None])
        safe_z = jnp.where(jnp.abs(pz) > 1e-9, pz, 1e-9)
        du = px * fx / safe_z + cx - im[None, :, 0]
        dv = py * fy / safe_z + cy - im[None, :, 1]
        return (du * du + dv * dv < th2) & (pz > 0) & m[None, :]

    if prescore and prescore < N:
        # stage 1: subset consensus over ALL candidates
        stride = max(1, N // prescore)
        counts_s = jnp.where(
            vf,
            _score(rf, tf, obj[::stride][:prescore],
                   img[::stride][:prescore],
                   mask[::stride][:prescore]).sum(axis=1),
            -1)
        k_top = min(32, counts_s.shape[0])
        top = jax.lax.top_k(counts_s, k_top)[1]
        rf = [c[top] for c in rf]
        tf = [c[top] for c in tf]
        vf = vf[top]

    if guess_rvec is not None:
        Rg = lie.rodrigues(guess_rvec.astype(jnp.float32))
        tg = guess_tvec.astype(jnp.float32)
        rf = [jnp.concatenate([c, Rg[i // 3, i % 3][None]])
              for i, c in enumerate(rf)]
        tf = [jnp.concatenate([c, tg[i][None]]) for i, c in enumerate(tf)]
        vf = jnp.concatenate([vf, jnp.array([True])], axis=0)

    # stage 2 (or only stage): full consensus over surviving candidates
    good = _score(rf, tf, obj, img, mask)
    counts = jnp.where(vf, good.sum(axis=1), -1)
    best = jnp.argmax(counts)

    inl0 = good[best]
    rv0 = lie.inv_rodrigues(
        jnp.stack([c[best] for c in rf]).reshape(3, 3))
    tv0 = jnp.stack([c[best] for c in tf])

    rv, tv = refine_pnp(
        rv0, tv0, obj, img, inl0.astype(jnp.float32), fx, fy, cx, cy,
        iters=refine_iters,
    )
    err_f = reprojection_errors(rv, tv, obj, img, fx, fy, cx, cy)
    inliers = (err_f < reproj_thresh) & mask
    n_inl = inliers.sum()
    ok = (counts[best] >= min_inliers) & (n_inl >= min_inliers)
    return PnPResult(rvec=rv, tvec=tv, inliers=inliers, n_inliers=n_inl, ok=ok)
