#!/usr/bin/env python3
"""Pose-graph backend at the reference's architectural ceiling.

The reference's ID scheme caps runs at 10,000 frames
(reference src/const.h:25); its largest attested run is 117 keyframes
(reference data/keyframe.txt). This harness *runs* the promised
regime: synthesizes ground-truthed multi-loop graphs at 2k-10k
vertices (testing/posegraph.py), optimizes with the matrix-free
block-Jacobi-CG LM, and reports wall time, LM iterations, chi2 drop,
and ATE vs ground truth per size.

Usage: posegraph_scale.py [sizes...]   (default: 2048 5120 10000)
Env: PGS_ITERS (LM iterations, default 15); SLAM3D_PLATFORM=cpu|gpu
forces the backend.
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sizes = [int(a) for a in argv] or [2048, 5120, 10000]
    n_iters = int(os.environ.get("PGS_ITERS", "15"))

    import slam3d_gx  # applies SLAM3D_PLATFORM  # noqa: F401
    import jax

    from slam3d_gx.testing.posegraph import graph_ate, make_loopy_graph

    log(f"backend: {jax.default_backend()}")
    rows = []
    for n in sizes:
        t0 = time.time()
        opt, gt, n_loops = make_loopy_graph(n, seed=1)
        t_gen = time.time() - t0
        ate0 = graph_ate(opt, gt)
        n_edges = len(opt.graph.edges)
        t0 = time.time()
        chi = opt.optimize(n_iters=n_iters, solver="cg")
        wall = time.time() - t0
        ate1 = graph_ate(opt, gt)
        row = dict(vertices=n, edges=n_edges, loops=n_loops,
                   lm_iters=n_iters, chi2=round(float(chi), 3),
                   ate_before_m=round(ate0, 4), ate_after_m=round(ate1, 4),
                   wall_s=round(wall, 2), gen_s=round(t_gen, 1),
                   backend=jax.default_backend())
        rows.append(row)
        log(f"V={n} E={n_edges} loops={n_loops}: ate {ate0:.3f} -> "
            f"{ate1:.4f} m, chi2 {chi:.1f}, {wall:.1f}s wall")
    print(json.dumps({"metric": "posegraph_scale", "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
