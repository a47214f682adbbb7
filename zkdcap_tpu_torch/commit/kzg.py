"""KZG commitments over BN254 (halo2 KZGCommitmentScheme equivalent).

Port of ``zkdcap_tpu/commit/kzg.py`` without the multi-chip ``mesh``
option. A commitment is one MSM against the SRS; a Lagrange-form poly goes
through the coefficient basis with one inverse NTT first.
"""

from __future__ import annotations

import dataclasses

import torch

from ..curves.device_g1 import G1_SPEC
from ..fields.params import BN254_FR
from ..msm.pippenger import msm_host, msm_many_host
from ..ntt import intt
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

    def commit(self, coeffs: torch.Tensor) -> Affine:
        """Commit to a coefficient-form poly (m <= n coefficients)."""
        m = coeffs.shape[0]
        if m > self.n:
            raise ValueError(f"poly of {m} coefficients exceeds SRS size {self.n}")
        return msm_host(self.srs.g1_powers[:m], coeffs, G1_SPEC)

    def commit_lagrange(self, evals: torch.Tensor) -> Affine:
        return self.commit(intt(BN254_FR, evals))

    def commit_many(self, coeffs_list) -> list[Affine]:
        """Commitments of many polys against one SRS prefix."""
        if not coeffs_list:
            return []
        m = max(c.shape[0] for c in coeffs_list)
        if m > self.n:
            raise ValueError(f"poly of {m} coefficients exceeds SRS size {self.n}")
        return msm_many_host(self.srs.g1_powers[:m], list(coeffs_list), G1_SPEC)
