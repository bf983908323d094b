"""Shot and x-domain parallelism over a mesh of torch devices: the port's
counterpart of the JAX package's ``parallel/``.

* :mod:`.mesh`: the (shot, x) mesh of devices.
* :mod:`.shots`: shots split over the shot axis, on the existing tiers.
* :mod:`.domain`: the x decomposition with a halo exchange every step, the
  plain reference of the domain tier and its path on a mesh of CPUs.
* :mod:`.domain_kernels`: the x decomposition on the block kernels, one
  exchange of K*h rows every K steps.

Still to be ported (ROADMAP.md): ``domain2d``/``domain2d_pallas`` (the
(x, z) decomposition), ``make_sharded_rtm_full`` and
``embed_injection_rows`` (``rtm_main`` over an x mesh).
"""

from .mesh import Mesh, make_mesh
from .shots import (split_shots, distribute_shots,
                    make_sharded_modeling_cuda, make_sharded_modeling_tiled,
                    make_sharded_rtm_cuda, make_sharded_rtm_tiled,
                    make_sharded_rtm_full_cuda)
from .domain import (halo_exchange, sharded_laplacian,
                     make_sharded_forward_modeling, make_sharded_rtm_snapshot,
                     embed_source_fields, embed_dobs)
from .domain_kernels import (make_sharded_forward_modeling_cuda,
                             make_sharded_rtm_snapshot_cuda)
