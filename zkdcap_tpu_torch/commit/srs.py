"""Unsafe dev SRS (powers of tau), computed on the card and cached on disk.

Port of the G1 side of ``zkdcap_tpu/commit/srs.py``: the same deterministic
dev tau (NOT a secure ceremony; test and development only), the same
points [tau^i]G and the same ``kzg_bn254_{k}.srs.npz`` cache format
(``g1_powers``: uint32[2^k, 2, 16] Montgomery affine). The G2 elements wait
for the verifier's pairing code.

The points come from 256 conditional additions of [2^j]G over the scalars'
bits (kernel C with fallback "p"), then one batched inversion of the Z
coordinates to normalise to affine.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..curves.device_g1 import G1_SPEC, CurveSpec, Point, ec_inf, encode_points
from ..curves.ec_kernels import ec_add_select
from ..curves.host_curve import BN254_G1
from ..device import resolve
from ..fields import mont
from ..fields.params import BN254_FR, NUM_LIMBS

L = NUM_LIMBS
DEV_SEED = b"zkdcap-tpu-dev-srs-v1"


def _dev_tau() -> int:
    return int.from_bytes(hashlib.blake2b(DEV_SEED).digest(), "little") % BN254_FR.p


def _powers_of_base(spec: CurveSpec, scalars_std: torch.Tensor, base_bits: torch.Tensor) -> Point:
    """[s_i]G for each scalar: 256 masked additions of [2^j]G.
    scalars_std: int32[n, 16]; base_bits: int32[256, 2, 16] affine Montgomery."""
    n = scalars_std.shape[0]
    acc = ec_inf(spec, (n,), scalars_std.device)
    one = acc[1]
    s = scalars_std.to(torch.int64)
    for j in range(256):
        bit = (s[:, j >> 4] >> (j & 15)) & 1
        Gj = (base_bits[j, 0].expand(n, L), base_bits[j, 1].expand(n, L), one)
        acc = ec_add_select(spec, acc, Gj, bit, "p")
    return acc


def _to_affine_batch(spec: CurveSpec, P: Point) -> torch.Tensor:
    """Projective -> (n, 2, 16) affine; infinity -> (0, 0)."""
    f = spec.field
    X, Y, Z = P
    inf = mont.is_zero(Z)[:, None]
    zinv = mont.batch_inv(f, torch.where(inf, mont.one_mont(f, (), Z.device), Z))
    x = torch.where(inf, 0, mont.mont_mul(f, X, zinv))
    y = torch.where(inf, 0, mont.mont_mul(f, Y, zinv))
    return torch.stack([x, y], dim=-2)


@dataclasses.dataclass
class SRS:
    k: int
    g1_powers: torch.Tensor  # int32[2^k, 2, 16] Montgomery affine [tau^i]G
    g1: tuple[int, int]  # host generator

    @property
    def n(self) -> int:
        return 1 << self.k


def gen_srs(k: int, cache_dir: str = "params", device=None) -> SRS:
    """Deterministic dev SRS with disk cache (halo2 gen_srs equivalent)."""
    dev = resolve(device)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"kzg_bn254_{k}.srs.npz")
    if os.path.exists(path):
        with np.load(path) as data:
            g1_powers = torch.as_tensor(data["g1_powers"].view(np.int32), device=dev)
        return SRS(k=k, g1_powers=g1_powers, g1=BN254_G1.g)
    tau = _dev_tau()
    taus = [1] * (1 << k)
    for i in range(1, 1 << k):
        taus[i] = taus[i - 1] * tau % BN254_FR.p
    scal = mont.encode_ints(BN254_FR, taus, to_montgomery=False, device=dev)
    mults = [BN254_G1.g]
    for _ in range(255):
        mults.append(BN254_G1.add(mults[-1], mults[-1]))
    base_bits = encode_points(G1_SPEC, mults, device=dev)
    g1_powers = _to_affine_batch(G1_SPEC, _powers_of_base(G1_SPEC, scal, base_bits))
    np.savez_compressed(path, g1_powers=g1_powers.cpu().numpy().view(np.uint32))
    return SRS(k=k, g1_powers=g1_powers, g1=BN254_G1.g)
