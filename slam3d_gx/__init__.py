"""slam3d_gx — an RGB-D SLAM framework in JAX.

A from-scratch re-design of the capabilities of gaoxiang12/slam3d_gx
(reference: a 2014 single-threaded C++/OpenCV/PCL/g2o Kinect SLAM pipeline)
as an idiomatic JAX/XLA framework:

- functional core: fixed-shape, masked tensor kernels (batched-hypothesis
  RANSAC, conv-pyramid feature detection, matmul matcher, vmapped
  Gauss-Newton PnP, batched pose-graph linearization), all jit-compiled;
- imperative shell: host-side dataset codecs, the per-frame SLAM state
  machine, file contracts (.g2o / keyframe.txt / trajectory.txt / PCD) that
  stay byte-compatible with the reference tooling;
- parallel layer: jax.sharding meshes for data-parallel registration sweeps
  and a sharded keyframe database for loop closure.

Layer map mirrors SURVEY.md; parity citations point into the reference
sources (file:line).
"""

__version__ = "0.1.0"

from .utils.platform import select_platform as _select_platform

# SLAM3D_PLATFORM=cpu|gpu must reach jax before its first device query
_select_platform()
