"""Multi-rank overlap-save filtering on ``torch.distributed`` (counterpart
of ``savgol_tpu.parallel``).

SPMD: every rank calls these on its own block of the global array, under an
initialised process group, with a mesh from :func:`make_mesh`; :func:`shard`
and :func:`gather` cut a global tensor into blocks and put them back. Halos
travel by point-to-point sends (``halo="ppermute"``) or, for the uniform 1D
and 2D paths, by kernel K13's one-sided stores (``halo="rdma"``).
"""

from savgol_tpu_torch.parallel.ici_halo import (halo_exchange_rdma,
                                                halo_exchange_rdma_rows)
from savgol_tpu_torch.parallel.sharded import (apply_sharded, gather,
                                               make_mesh, shard)
from savgol_tpu_torch.parallel.sharded2d import apply2d_sharded
from savgol_tpu_torch.parallel.sharded_ext import (masked2d_apply_sharded,
                                                   masked_apply_sharded,
                                                   nonuniform_apply_sharded)

__all__ = [
    "make_mesh", "shard", "gather",
    "apply_sharded", "apply2d_sharded",
    "masked_apply_sharded", "nonuniform_apply_sharded",
    "masked2d_apply_sharded",
    "halo_exchange_rdma", "halo_exchange_rdma_rows",
]
