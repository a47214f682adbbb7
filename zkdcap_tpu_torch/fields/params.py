"""Field parameters of BN254 (numpy and Python ints only).

A field element is a little-endian vector of ``NUM_LIMBS = 16`` limbs of
``LIMB_BITS = 16`` bits, the layout of the JAX package at every module
boundary, so that arrays of the two packages compare with ``np.array_equal``.
torch has little ``uint32`` arithmetic, so the port stores the limbs as
``int32`` (a 16-bit limb is never negative). Hot-path arithmetic is in
Montgomery form with R = 2^256; the CUDA kernels use 8 limbs of 32 bits
internally, which gives the same R and so the same Montgomery form.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # 256
R = 1 << R_BITS


def int_to_limbs(x: int, num_limbs: int = NUM_LIMBS, limb_bits: int = LIMB_BITS) -> np.ndarray:
    """Little-endian limb decomposition of a non-negative int."""
    if x < 0:
        raise ValueError("negative value")
    mask = (1 << limb_bits) - 1
    out = np.empty((num_limbs,), dtype=np.uint32)
    for i in range(num_limbs):
        out[i] = x & mask
        x >>= limb_bits
    if x:
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(limbs, limb_bits: int = LIMB_BITS) -> int:
    """Inverse of :func:`int_to_limbs` (accepts any integer array-like)."""
    x = 0
    arr = np.asarray(limbs)
    for i in range(arr.shape[-1] - 1, -1, -1):
        x = (x << limb_bits) | int(arr[..., i])
    return x


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Static parameters of a prime field, precomputed on the host.

    ``n0inv`` is ``-p^{-1} mod 2^LIMB_BITS`` (Montgomery REDC constant),
    ``r2`` is ``R^2 mod p`` (to-Montgomery conversion multiplier).
    """

    name: str
    p: int
    # Multiplicative generator + 2-adicity for NTT fields (0 if unused).
    generator: int = 0
    two_adicity: int = 0

    @functools.cached_property
    def n0inv(self) -> int:
        return (-pow(self.p, -1, 1 << LIMB_BITS)) & LIMB_MASK

    @functools.cached_property
    def r_mod_p(self) -> int:
        return R % self.p

    @functools.cached_property
    def r2(self) -> int:
        return (R * R) % self.p

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.p)

    @functools.cached_property
    def root_of_unity(self) -> int:
        """2^two_adicity-th primitive root of unity (for NTT fields)."""
        if self.two_adicity <= 0:
            raise ValueError(f"{self.name} has no 2-adic roots of unity")
        odd = (self.p - 1) >> self.two_adicity
        return pow(self.generator, odd, self.p)

    def nth_root_of_unity(self, log_n: int) -> int:
        if log_n > self.two_adicity:
            raise ValueError(f"2^{log_n} exceeds the 2-adicity of {self.name}")
        return pow(self.root_of_unity, 1 << (self.two_adicity - log_n), self.p)


# BN254 scalar field Fr: the field of all PLONK polynomials. Generator 7 is
# halo2curves' multiplicative generator; Fr has 2-adicity 28.
BN254_FR = FieldParams(
    name="bn254_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=7,
    two_adicity=28,
)

# BN254 base field Fq: coordinates of G1 points (MSM arithmetic field).
BN254_FQ = FieldParams(
    name="bn254_fq",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
)
