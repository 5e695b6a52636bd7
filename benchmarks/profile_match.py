#!/usr/bin/env python3
"""Micro-profile of the batched NN-match kernel internals.

Times: raw distance matmul at each precision, the full distance matrix,
and the argmin/take chain, on the sweep-throughput shapes
(B*P, K, D) x (B*P, D, K).

Env: PROF_BATCH (192 = 64 pairs x 3 planes), PROF_MAXKP (512),
     PROF_REPS (16), PROF_PLATFORM.
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
    B = int(os.environ.get("PROF_BATCH", "192"))
    K = int(os.environ.get("PROF_MAXKP", "512"))
    D = 128
    reps = int(os.environ.get("PROF_REPS", "16"))

    import jax
    import jax.numpy as jnp

    from slam3d_gx.utils import compile_cache

    compile_cache.enable(jax)
    from slam3d_gx.ops import match

    log(f"match profile: B={B} K={K} D={D} on "
        f"{jax.devices()[0].platform}")
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(B, K, D)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(B, K, D)).astype(np.float32))
    va = jnp.asarray(rng.uniform(size=(B, K)) < 0.9)
    vb = jnp.asarray(rng.uniform(size=(B, K)) < 0.9)
    uv = jnp.asarray(rng.normal(size=(B, K, 2)).astype(np.float32))

    P = jax.lax.Precision
    variants = {
        "matmul_default": jax.jit(lambda x, y, *_: jnp.einsum(
            "bkd,bjd->bkj", x, y, precision=P.DEFAULT).sum(axis=(1, 2))),
        "matmul_high": jax.jit(lambda x, y, *_: jnp.einsum(
            "bkd,bjd->bkj", x, y, precision=P.HIGH).sum(axis=(1, 2))),
        "matmul_highest": jax.jit(lambda x, y, *_: jnp.einsum(
            "bkd,bjd->bkj", x, y, precision=P.HIGHEST).sum(axis=(1, 2))),
        "dist_matrix": jax.jit(jax.vmap(
            lambda x, y, *_: match.l2_distance_matrix(x, y).sum())),
        "match_nn_full": jax.jit(jax.vmap(
            lambda x, y, u, v: match.match_nn(x, u, y, v)[1].sum())),
        "match_gather_uv": jax.jit(jax.vmap(
            lambda x, y, u, v, w: (lambda midx, mdist, mok:
                                   w[midx].sum() + mdist.sum())(
                *match.match_nn(x, u, y, v)),
            in_axes=(0, 0, 0, 0, 0))),
        "match_onehot_uv": jax.jit(jax.vmap(
            lambda x, y, u, v, w: (lambda midx, mdist, mok:
                                   jnp.matmul(jax.nn.one_hot(
                                       midx, w.shape[0], dtype=w.dtype),
                                       w).sum() + mdist.sum())(
                *match.match_nn(x, u, y, v)),
            in_axes=(0, 0, 0, 0, 0))),
    }

    import concurrent.futures as cf

    def warm(item):
        name, fn = item
        t0 = time.time()
        np.asarray(fn(a, b, va, vb, uv)
                   if "uv" in name else fn(a, b, va, vb))
        return name, time.time() - t0

    with cf.ThreadPoolExecutor(max_workers=len(variants)) as ex:
        for name, dt in ex.map(warm, variants.items()):
            log(f"warm {name}: {dt:.1f}s")

    gflop = B * 2.0 * K * K * D / 1e9
    print(f"| variant | ms | GFLOP/s (model {gflop:.1f} GFLOP) |")
    print("|---|---|---|")
    for name, fn in variants.items():
        best = np.inf
        for _ in range(3):
            t0 = time.time()
            for _ in range(reps):
                out = (fn(a, b, va, vb, uv)
                       if "uv" in name else fn(a, b, va, vb))
            np.asarray(out)
            best = min(best, (time.time() - t0) / reps)
        print(f"| {name} | {best * 1e3:.2f} | {gflop / best:.0f} |",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
