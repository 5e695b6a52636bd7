"""Multi-chip parallelism layer (SURVEY.md §2.4, §5.7-5.8).

The reference is single-process / single-threaded (no pthread/OpenMP/MPI
anywhere in its src/, SURVEY.md §2.4), so this subsystem is a new
design, not a port:

- mesh.py        : device mesh construction + jax.distributed bring-up
                   (the communication backend is XLA collectives, NCCL
                   on GPUs);
- registration.py: data-parallel batched pairwise registration (multiPnP
                   fan-out over frame pairs / loop-closure candidates);
- lcdb.py        : fixed-capacity keyframe database with sharded
                   descriptor matching — the "sequence parallel" analog:
                   the keyframe history is the sequence, queries broadcast
                   to every device against sharded keyframe blocks.

The pose-graph multi-chip path lives with the solver
(backend/pose_graph.py): PoseGraphOptimizer.optimize(mesh=...) shards
the edge batch over the "dp" axis — each device linearizes its shard
and scatter-adds into the normal equations, which XLA psum-reduces
before the (replicated) dense or matrix-free-CG solve.
`optimize_sharded` below is the convenience entry point.
"""

from typing import Optional

from . import lcdb, mesh, registration  # noqa: F401


def optimize_sharded(opt, device_mesh, n_iters: int = 200,
                     solver: Optional[str] = None) -> float:
    """Run a PoseGraphOptimizer's LM loop with edges sharded over the
    mesh's dp axis (see backend/pose_graph.py for the solver design)."""
    return opt.optimize(n_iters=n_iters, mesh=device_mesh, solver=solver)
