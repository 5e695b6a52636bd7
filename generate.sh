#!/bin/sh
# Build/check helper (reference generate.sh rebuilt the CMake tree; this
# framework is pure Python + JAX, so "build" = sanity-check the
# environment and run the unit suite).
set -e
cd "$(dirname "$0")"
python3 -c "import jax, slam3d_gx; print('jax', jax.__version__, 'devices', jax.devices())"
python3 -m pytest tests/ -q "$@"
