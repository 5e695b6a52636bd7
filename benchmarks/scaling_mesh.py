#!/usr/bin/env python3
"""Mesh-size scaling benchmark: BatchedRegistrar fan-out + lcdb scoring.

Weak scaling over the dp/sp axes: per-device work is held constant
while the mesh grows, so ideal scaling is FLAT wall time per round (the
fan-outs are embarrassingly parallel; lcdb adds one replicated-query
broadcast). On real multi-device hardware this measures collective overhead; on
a virtual CPU mesh it validates the SPMD programs and measures the
partitioning overhead — on a single-core host (this container) the
devices serialize, so expect ~linear time growth there, NOT a
framework limitation (see docs/PARALLEL.md).

Usage: scaling_mesh.py [--meshes 1,2,4,8] [--per-dev 4] [--rounds 3]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import jax

if os.environ.get("SWEEP_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--meshes", default="1,2,4,8")
    p.add_argument("--per-dev", type=int, default=4)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--kp", type=int, default=128)
    args = p.parse_args(argv)

    from slam3d_gx.config import CameraIntrinsics
    from slam3d_gx.frontend.state import FrameFeatures
    from slam3d_gx.geometry import se3
    from slam3d_gx.parallel import lcdb, mesh as mesh_mod, registration

    intr = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                            factor=5000.0)
    rng = np.random.default_rng(0)
    k = args.kp

    def make_pair():
        pts = np.stack([rng.uniform(-1.5, 1.5, k), rng.uniform(-1, 1, k),
                        rng.uniform(1.5, 3.5, k)], axis=1)
        R = se3.rodrigues(np.array([0.0, 0.05, 0.0]))
        t = np.array([0.05, 0, 0.01])
        pts_b = pts @ R.T + t
        desc = (rng.normal(size=(k, 32)) * 10).astype(np.float32)

        def feat(q):
            uv = np.stack([intr.fx * q[:, 0] / q[:, 2] + intr.cx,
                           intr.fy * q[:, 1] / q[:, 2] + intr.cy], axis=1)
            return FrameFeatures(
                coeffs=jnp.zeros((1, 4), jnp.float32),
                plane_valid=jnp.ones((1,), bool),
                uv=jnp.asarray(uv, jnp.float32)[None],
                kp3d=jnp.asarray(pts, jnp.float32)[None],
                desc=jnp.asarray(desc)[None],
                kp_valid=jnp.ones((1, k), bool),
            )
        return feat(pts), feat(pts_b)

    print(f"devices available: {len(jax.devices())}; "
          f"per-device batch {args.per_dev}; {args.rounds} rounds")
    print("\n| mesh | registrar pairs | registrar s/round | "
          "lcdb entries | lcdb s/query |")
    print("|---|---|---|---|---|")
    for n_dev in [int(x) for x in args.meshes.split(",")]:
        if n_dev > len(jax.devices()):
            continue
        mesh = mesh_mod.make_mesh(n_dev)
        dp = mesh.shape[mesh_mod.DP_AXIS]
        sp = mesh.shape[mesh_mod.SP_AXIS]
        n_pairs = args.per_dev * dp
        reg = registration.BatchedRegistrar(
            intr, image_only=True, hypotheses=64, mesh=mesh)
        pairs = [make_pair() for _ in range(n_pairs)]
        key = jax.random.PRNGKey(0)
        reg(pairs, key, min_inliers=8, pad_to=n_pairs)  # compile
        t0 = time.time()
        for r in range(args.rounds):
            out = reg(pairs, jax.random.PRNGKey(r), min_inliers=8,
                      pad_to=n_pairs)
        t_reg = (time.time() - t0) / args.rounds
        assert all(o[3] for o in out)

        cap = 16 * sp
        db = lcdb.KeyframeDatabase(n_desc=k, dim=32, capacity=cap, mesh=mesh)
        fa, _ = pairs[0]
        for _ in range(cap):
            db.add(fa)
        db.scores(fa)  # compile
        t0 = time.time()
        for _ in range(args.rounds):
            s = db.scores(fa)
        t_db = (time.time() - t0) / args.rounds
        assert np.isfinite(s).all()
        print(f"| {n_dev} (dp={dp},sp={sp}) | {n_pairs} | {t_reg:.3f} | "
              f"{cap} | {t_db:.3f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
