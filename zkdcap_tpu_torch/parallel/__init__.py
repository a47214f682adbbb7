"""Sharded proving: the mesh, the sharded MSM and NTT (port of
``zkdcap_tpu/parallel/``)."""

from .mesh import Mesh, init_distributed, multihost_mesh, proving_mesh
from .sharded_msm import sharded_msm
from .sharded_ntt import gather_rows, sharded_ntt
