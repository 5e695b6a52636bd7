"""Batched polynomial root finding (Durand-Kerner), jit/vmap-safe.

Used by the P3P minimal solver (quartics). Durand-Kerner is branch-free
simultaneous iteration in complex arithmetic — it vectorizes over large
hypothesis batches where classical closed forms (Ferrari) need case
analysis per element.

The iteration is a rolled loop: every root's update reads the other
three, so a fully unrolled chain lets a fusing compiler duplicate the
shared subexpressions (XLA:CPU's work grew ~4^iters and never finished
at 24 iterations). A rolled loop keeps compile time and run time linear
in `iters`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# loop-body copies per trip: 4 trips' worth of loop overhead fewer than
# fully rolled; on an H100 (700 W) solve_pnp_ransac (1536 points, 256
# hypotheses) took 851 us of device time against 869 us rolled, with the
# same ~1.8 s compile (benchmarks/frontend_kernels.py)
UNROLL = 4

# a pairwise iterate difference shorter than this fraction of the larger
# iterate's modulus is lengthened to it (direction kept): coincident
# iterates would divide by zero, and near-coincident ones (a multiple
# root, where float32 resolves the root only to ~sqrt(eps)) would divide
# rounding noise by a tiny number and be thrown far from the root
_MIN_SEPARATION = 1e-3
# every root of the scaled quartic lies in |y| <= 2 (Fujiwara's bound)
_RADIUS = 2.0


@functools.partial(jax.jit, static_argnames=("iters",))
def quartic_roots(coeffs, iters: int = 24):
    """Roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0.

    Args:
      coeffs: (..., 5) real, ordered [c4, c3, c2, c1, c0].
    Returns:
      (..., 4) complex64 roots. Degenerate leading coefficients are
      regularized (callers gate on residual checks anyway).
    """
    c4 = coeffs[..., 0]
    # regularize: if |c4| is tiny the quartic is ill-posed; nudge it
    c4 = jnp.where(jnp.abs(c4) > 1e-12, c4, 1e-12)
    # monic: x^4 + p0 x^3 + p1 x^2 + p2 x + p3
    p = (coeffs[..., 1:] / c4[..., None]).astype(jnp.complex64)

    # scale roots to O(1): substitute x = s*y with s from coefficient
    # magnitudes
    mags = jnp.stack(
        [jnp.abs(p[..., k]) ** (1.0 / (k + 1)) for k in range(4)], axis=-1)
    s = jnp.clip(jnp.max(mags, axis=-1), 1e-6, None).astype(jnp.complex64)
    q = p / jnp.stack([s, s**2, s**3, s**4], axis=-1)  # monic quartic in y

    def poly(y):
        return (((y + q[..., 0:1]) * y + q[..., 1:2]) * y
                + q[..., 2:3]) * y + q[..., 3:4]

    # initial iterates on the root-modulus estimates of the Newton
    # polygon (upper hull of log|coefficient| against power): the slope
    # over [k-1, k] is min_{i<k} max_{j>=k} (L_j - L_i)/(j - i), and the
    # k-th modulus is exp(-slope). Starting each iterate at its own
    # radius keeps roots of very different magnitudes (a near-zero
    # leading coefficient) from crawling in from the unit circle.
    lg = [jnp.log(jnp.abs(c) + 1e-30)
          for c in (q[..., 3], q[..., 2], q[..., 1], q[..., 0],
                    jnp.ones_like(q[..., 0]))]  # L_k for power k
    radii = []
    for k in range(1, 5):
        slope = functools.reduce(jnp.minimum, [
            functools.reduce(jnp.maximum, [
                (lg[j] - lg[i]) / (j - i) for j in range(k, 5)])
            for i in range(k)])
        radii.append(jnp.exp(-slope))
    angle = jnp.asarray(
        [0.4 + 2 * jnp.pi * k / 4 for k in range(4)], jnp.float32)
    z0 = (jnp.stack(radii, axis=-1)
          * jnp.exp(1j * angle)).astype(jnp.complex64)
    eye = jnp.eye(4, dtype=bool)

    def step(_, z):
        diff = z[..., :, None] - z[..., None, :]
        mag = jnp.abs(diff)
        az = jnp.abs(z)
        sep = _MIN_SEPARATION * jnp.maximum(az[..., :, None],
                                            az[..., None, :]) + 1e-12
        diff = jnp.where(
            mag < sep,
            jnp.where(mag > 0, diff / jnp.maximum(mag, 1e-30), 1.0) * sep,
            diff)
        denom = jnp.prod(jnp.where(eye, jnp.complex64(1.0), diff), axis=-1)
        z = z - poly(z) / denom
        # an iterate thrown past the root bound is pulled back onto it
        r = jnp.abs(z)
        return jnp.where(r > _RADIUS, z * (_RADIUS / jnp.maximum(r, 1e-30)), z)

    z = jax.lax.fori_loop(0, iters, step, z0, unroll=UNROLL)
    return z * s[..., None]


def real_roots_mask(roots, rel_tol: float = 1e-3):
    """Boolean mask of (approximately) real roots."""
    return jnp.abs(roots.imag) <= rel_tol * (1.0 + jnp.abs(roots.real))
