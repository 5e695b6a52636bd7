#!/usr/bin/env python3
"""Bisect the nested-vmap match slowdown.

profile_match.py (flat (B*P,K,D) batch) shows the full NN-match chain
at ~6 ms for 384 planes; profile_multipnp.py's match stage (vmap over
B=128 pairs of a vmap over P=3 planes) measures 27.8 ms for identical
work. This times truncated variants of the NESTED structure to find
which op pays the 4x.

Env: PROF_PAIRS (128), PROF_MAXKP (512), PROF_REPS (16), PROF_PLATFORM.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

if os.environ.get("PROF_PLATFORM"):
    import jax

    jax.config.update("jax_platforms", os.environ["PROF_PLATFORM"])


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    B = int(os.environ.get("PROF_PAIRS", "128"))
    K = int(os.environ.get("PROF_MAXKP", "512"))
    P = 3
    D = 128
    reps = int(os.environ.get("PROF_REPS", "16"))

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)
    from slam3d_gx.ops import match

    log(f"nested match profile: B={B} P={P} K={K} on "
        f"{jax.devices()[0].platform}")
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(B, P, K, D)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(B, P, K, D)).astype(np.float32))
    va = jnp.asarray(rng.uniform(size=(B, P, K)) < 0.9)
    vb = jnp.asarray(rng.uniform(size=(B, P, K)) < 0.9)
    uv = jnp.asarray(rng.normal(size=(B, P, K, 2)).astype(np.float32))

    def dist_only(da, kva, ub, db, kvb):
        return match.l2_distance_matrix(da, db).sum()

    def plus_argmin(da, kva, ub, db, kvb):
        d = match.l2_distance_matrix(da, db)
        d = jnp.where(kvb[None, :], d, jnp.inf)
        return jnp.argmin(d, axis=1).astype(jnp.int32).sum()

    def plus_take(da, kva, ub, db, kvb):
        d = match.l2_distance_matrix(da, db)
        d = jnp.where(kvb[None, :], d, jnp.inf)
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        dist = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
        return idx.sum() + dist.sum()

    def plus_min_take(da, kva, ub, db, kvb):
        # min instead of take_along_axis: same values, no gather
        d = match.l2_distance_matrix(da, db)
        d = jnp.where(kvb[None, :], d, jnp.inf)
        idx = jnp.argmin(d, axis=1).astype(jnp.int32)
        dist = jnp.min(d, axis=1)
        return idx.sum() + dist.sum()

    def full_nn(da, kva, ub, db, kvb):
        midx, mdist, mok = match.match_nn(da, kva, db, kvb)
        return midx.sum() + mdist.sum()

    def full_stage(da, kva, ub, db, kvb):
        midx, mdist, mok = match.match_nn(da, kva, db, kvb)
        good = match.good_match_filter(mdist, mok)
        return ub[midx].sum() + good.sum()

    variants = {
        "dist_only": dist_only,
        "plus_argmin": plus_argmin,
        "plus_take": plus_take,
        "plus_min_take": plus_min_take,
        "full_nn": full_nn,
        "full_stage": full_stage,
    }
    jitted = {
        name: jax.jit(jax.vmap(jax.vmap(fn)))
        for name, fn in variants.items()
    }

    import concurrent.futures as cf

    def warm(item):
        name, fn = item
        t0 = time.time()
        np.asarray(fn(a, va, uv, b, vb))
        return name, time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=len(jitted)) as ex:
        for name, dt in ex.map(warm, jitted.items()):
            log(f"warm {name}: {dt:.1f}s")

    print(f"| variant | ms ({B}x{P} planes) |")
    print("|---|---|")
    for name, fn in jitted.items():
        best = np.inf
        for _ in range(3):
            t0 = time.time()
            for _ in range(reps):
                out = fn(a, va, uv, b, vb)
            np.asarray(out)
            best = min(best, (time.time() - t0) / reps)
        print(f"| {name} | {best * 1e3:.2f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
