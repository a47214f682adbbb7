"""KZG commitments over BN254 (halo2 KZGCommitmentScheme equivalent).

Port of ``zkdcap_tpu/commit/kzg.py``. A commitment is one MSM against the
SRS; a Lagrange-form poly goes through the coefficient basis with one
inverse NTT first. With ``mesh`` (``parallel.Mesh``) every commitment is a
sharded MSM (``parallel/sharded_msm.py``); the points are the same, so is
the result.
"""

from __future__ import annotations

import dataclasses

import torch

from ..curves.device_g1 import G1_SPEC, decode_points
from ..fields.params import BN254_FR
from ..msm.pippenger import msm_host, msm_many_host
from ..ntt import intt
from ..parallel.sharded_msm import sharded_msm, sharded_msm_many
from .srs import SRS

Affine = tuple[int, int] | None


@dataclasses.dataclass
class ParamsKZG:
    srs: SRS

    @property
    def k(self) -> int:
        return self.srs.k

    @property
    def n(self) -> int:
        return self.srs.n

    def commit(self, coeffs: torch.Tensor, mesh=None) -> Affine:
        """Commit to a coefficient-form poly (m <= n coefficients); with
        `mesh`, the MSM's points split over the mesh's shards."""
        m = coeffs.shape[0]
        if m > self.n:
            raise ValueError(f"poly of {m} coefficients exceeds SRS size {self.n}")
        if mesh is not None:
            R3 = sharded_msm(mesh, self.srs.g1_powers, coeffs, G1_SPEC)
            return decode_points(G1_SPEC, tuple(r.reshape(1, -1) for r in R3))[0]
        return msm_host(self.srs.g1_powers[:m], coeffs, G1_SPEC)

    def commit_lagrange(self, evals: torch.Tensor, mesh=None) -> Affine:
        return self.commit(intt(BN254_FR, evals), mesh=mesh)

    def commit_many(self, coeffs_list, mesh=None) -> list[Affine]:
        """Commitments of many polys against one SRS prefix; with `mesh`,
        sharded MSMs (one batched ladder for small blocks)."""
        if not coeffs_list:
            return []
        m = max(c.shape[0] for c in coeffs_list)
        if m > self.n:
            raise ValueError(f"poly of {m} coefficients exceeds SRS size {self.n}")
        if mesh is not None:
            return decode_points(G1_SPEC, tuple(torch.stack(c) for c in zip(
                *sharded_msm_many(mesh, self.srs.g1_powers, list(coeffs_list), G1_SPEC))))
        return msm_many_host(self.srs.g1_powers[:m], list(coeffs_list), G1_SPEC)
