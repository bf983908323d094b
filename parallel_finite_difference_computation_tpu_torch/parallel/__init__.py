"""Shot and domain parallelism over a mesh of torch devices: the port's
counterpart of the JAX package's ``parallel/``.

* :mod:`.mesh`: the (shot, x) or (shot, x, z) mesh of devices.
* :mod:`.shots`: shots split over the shot axis, on the existing tiers.
* :mod:`.domain`: the x decomposition with a halo exchange every step, the
  plain reference of the x tier and its path on a mesh of CPUs.
* :mod:`.domain_kernels`: the x decomposition on the block kernels, one
  exchange of K*h rows every K steps.
* :mod:`.domain2d`, :mod:`.domain2d_kernels`: the same for the (x, z)
  decomposition, tiles with halos on both axes.

Still to be ported (ROADMAP.md): ``make_sharded_rtm_full``,
``make_sharded_rtm_full_2d`` and ``embed_injection_rows`` (``rtm_main``
over a domain mesh).
"""

from .mesh import Mesh, make_mesh
from .shots import (split_shots, distribute_shots,
                    make_sharded_modeling_cuda, make_sharded_modeling_tiled,
                    make_sharded_rtm_cuda, make_sharded_rtm_tiled,
                    make_sharded_rtm_full_cuda, make_sharded_rtm_full_tiled)
from .domain import (halo_exchange, sharded_laplacian,
                     make_sharded_forward_modeling, make_sharded_rtm_snapshot,
                     embed_source_fields, embed_dobs)
from .domain2d import (halo_exchange_axis, sharded_laplacian_2d,
                       make_sharded_forward_modeling_2d,
                       make_sharded_rtm_snapshot_2d)
from .domain_kernels import (make_sharded_forward_modeling_cuda,
                             make_sharded_rtm_snapshot_cuda)
from .domain2d_kernels import (exchange_2d,
                               make_sharded_forward_modeling_2d_cuda,
                               make_sharded_rtm_snapshot_2d_cuda)
