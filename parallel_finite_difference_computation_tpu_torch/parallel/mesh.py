"""The device mesh of shot x domain parallelism: the port's counterpart of
the JAX package's ``parallel/mesh.py``.

A :class:`Mesh` is a (shot, x) or a (shot, x, z) array of
``torch.device``: shots split over the ``shot`` axis (no communication),
the extended grid's x axis over the ``x`` axis and, on a three-axis mesh,
its z axis over the ``z`` axis (halo exchange between neighbours,
:mod:`.domain_kernels`). A device may appear more than once: every position
on the CPU (the tests), or four tiles on one card. Positions that share a
device run in turn on its stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]

AXES = ("shot", "x", "z")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices[i, j]`` (or ``devices[i, j, l]``) holds shot group i's
    x-slab j (its (x, z) tile (j, l))."""

    devices: np.ndarray   # (n_shot, n_x) or (n_shot, n_x, n_z) of torch.device

    @property
    def axis_names(self) -> tuple:
        return AXES[:self.devices.ndim]

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX ``Mesh.shape`` gives them."""
        return dict(zip(self.axis_names, self.devices.shape))

    def lead(self, i: int = 0) -> torch.device:
        """The device of shot group i's first grid position: where the
        group's shot-only work runs and, for group 0, where results are
        joined."""
        return self.devices[i].flat[0]

    def grid(self, i: int) -> np.ndarray:
        """Shot group i's devices as an (n_x, n_z) array (n_z = 1 on a
        (shot, x) mesh)."""
        return self.devices[i].reshape(self.devices.shape[1], -1)


def make_mesh(n_shot: int = 1, n_x: int = 1, n_z: int = 1,
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA card), filled
    in row-major order: (shot, x) for ``n_z == 1``, else (shot, x, z), as
    the JAX package's ``make_mesh``. ``devices`` may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    shape = (n_shot, n_x) if n_z == 1 else (n_shot, n_x, n_z)
    n = int(np.prod(shape))
    if min(shape) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape))
