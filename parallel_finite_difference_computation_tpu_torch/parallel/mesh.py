"""The device mesh of shot x domain parallelism: the port's counterpart of
the JAX package's ``parallel/mesh.py``.

A :class:`Mesh` is a (shot, x) array of ``torch.device``: shots split over
the ``shot`` axis (no communication), and the extended grid's x axis over
the ``x`` axis (halo exchange of rows between neighbours,
:mod:`.domain_kernels`). A device may appear more than once: every position
on the CPU (the tests), or four x-slabs on one card. Positions that share a
device run in turn on its stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]

AXES = ("shot", "x")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices[i, j]`` holds shot group i's x-slab j."""

    devices: np.ndarray        # (n_shot, n_x) object array of torch.device

    @property
    def axis_names(self) -> tuple:
        return AXES

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX ``Mesh.shape`` gives them."""
        return dict(zip(AXES, self.devices.shape))


def make_mesh(n_shot: int = 1, n_x: int = 1, n_z: int = 1,
              devices=None) -> Mesh:
    """A (shot, x) mesh over ``devices`` (default: every visible CUDA card),
    filled row by row. ``devices`` may repeat a device. ``n_z > 1``, the
    (x, z) decomposition, is still to be ported."""
    if n_z > 1:
        raise NotImplementedError(
            "n_z > 1: the (x, z) domain decomposition (domain2d, row 16 of "
            "PERF.md's kernel table) is still to be ported (see ROADMAP.md, "
            "Queue 2)")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_shot * n_x
    if n < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({n_shot}, {n_x})")
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_shot, n_x))
