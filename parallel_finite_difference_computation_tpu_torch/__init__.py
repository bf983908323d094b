"""PyTorch and CUDA port of the 2D acoustic finite-difference modeling,
two-snapshot and full-wavefield RTM, and stencil programs, for one NVIDIA
H100.

The JAX package ``parallel_finite_difference_computation_tpu`` beside this
one is the reference the port is held against; this package never imports
it, nor ``jax``. Plain torch versions of every kernel run on the CPU; on a
CUDA device the work runs through hand-written CUDA kernels (``csrc/``,
built with ``nvcc`` at first use). :mod:`.parallel` splits shots and the
grid's x axis, or both its axes, over a mesh of devices.
"""

from .config import Params, Geometry, parse_input_dat
from .solver import (
    FDContext, forward_modeling, fd_forward, fd_back, rtm_shot_snapshot,
    backward_recorded, rtm_shot_full, forward_modeling_tiled,
    backward_recorded_tiled, rtm_shot_full_tiled, rtm_shot_snapshot_tiled,
)
from . import numerics, io, pipeline, parallel
from .parallel import make_mesh

__version__ = "0.1.0"
