"""Host-side (Python bigint) short-Weierstrass arithmetic: the trusted oracle.

A copy of ``zkdcap_tpu/curves/host_curve.py``: BN254 G1 for point encoding,
SRS generation and the on-card checks, and secp256r1 (P-256) with the host
ECDSA verify for the ECC chip and the P-256 circuit. Points are affine
tuples ``(x, y)`` of Python ints, with ``None`` as the point at infinity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Affine = Optional[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class CurveParams:
    name: str
    p: int  # base field
    a: int
    b: int
    n: int  # group order (prime)
    gx: int
    gy: int

    @property
    def g(self) -> Affine:
        return (self.gx, self.gy)

    def is_on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def add(self, p1: Affine, p2: Affine) -> Affine:
        """Affine group law (complete, slow, oracle-grade)."""
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        p = self.p
        if x1 == x2 and (y1 + y2) % p == 0:
            return None
        if p1 == p2:
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3)

    def neg_pt(self, pt: Affine) -> Affine:
        if pt is None:
            return None
        return (pt[0], (-pt[1]) % self.p)

    def mul(self, k: int, pt: Affine) -> Affine:
        """Scalar multiplication via Jacobian double-and-add."""
        k %= self.n
        if k == 0 or pt is None:
            return None
        jx, jy, jz = (pt[0], pt[1], 1)
        rx, ry, rz = (0, 1, 0)  # infinity
        for bit in bin(k)[2:]:
            rx, ry, rz = self._jac_double(rx, ry, rz)
            if bit == "1":
                rx, ry, rz = self._jac_add(rx, ry, rz, jx, jy, jz)
        return self._from_jac(rx, ry, rz)

    def msm(self, scalars, points) -> Affine:
        """Naive host MSM oracle: sum_i scalars[i] * points[i]."""
        acc = None
        for s, pt in zip(scalars, points):
            acc = self.add(acc, self.mul(int(s), pt))
        return acc

    # --- Jacobian internals -------------------------------------------------

    def _from_jac(self, x, y, z) -> Affine:
        if z == 0:
            return None
        p = self.p
        zi = pow(z, -1, p)
        zi2 = zi * zi % p
        return (x * zi2 % p, y * zi2 * zi % p)

    def _jac_double(self, x, y, z):
        p = self.p
        if z == 0 or y == 0:
            return (0, 1, 0)
        ysq = y * y % p
        s = 4 * x * ysq % p
        m = (3 * x * x + self.a * z * z % p * z % p * z % p) % p
        nx = (m * m - 2 * s) % p
        ny = (m * (s - nx) - 8 * ysq * ysq) % p
        nz = 2 * y * z % p
        return (nx, ny, nz)

    def _jac_add(self, x1, y1, z1, x2, y2, z2):
        p = self.p
        if z1 == 0:
            return (x2, y2, z2)
        if z2 == 0:
            return (x1, y1, z1)
        z1z1 = z1 * z1 % p
        z2z2 = z2 * z2 % p
        u1 = x1 * z2z2 % p
        u2 = x2 * z1z1 % p
        s1 = y1 * z2z2 * z2 % p
        s2 = y2 * z1z1 * z1 % p
        if u1 == u2:
            if s1 != s2:
                return (0, 1, 0)
            return self._jac_double(x1, y1, z1)
        h = (u2 - u1) % p
        i = 4 * h * h % p
        j = h * i % p
        r = 2 * (s2 - s1) % p
        v = u1 * i % p
        nx = (r * r - j - 2 * v) % p
        ny = (r * (v - nx) - 2 * s1 * j) % p
        nz = ((z1 + z2) ** 2 - z1z1 - z2z2) % p * h % p
        return (nx, ny, nz)


# BN254 G1: y^2 = x^3 + 3 over Fq, generator (1, 2).
BN254_G1 = CurveParams(
    name="bn254_g1",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    a=0,
    b=3,
    n=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    gx=1,
    gy=2,
)


# secp256r1 / NIST P-256: the attestation-signature curve
# (capability the reference forked halo2-lib for, SURVEY.md §0).
SECP256R1 = CurveParams(
    name="secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)


def p256_ecdsa_verify(msghash: int, r: int, s: int, pub: Affine) -> bool:
    """Trusted host P-256 ECDSA verify (oracle role of the `p256` crate,
    `crates/p256-ecdsa/src/base.rs:287-306`)."""
    c = SECP256R1
    if not (1 <= r < c.n and 1 <= s < c.n):
        return False
    if pub is None or not c.is_on_curve(pub):
        return False
    w = pow(s, -1, c.n)
    u1 = (msghash % c.n) * w % c.n
    u2 = r * w % c.n
    pt = c.add(c.mul(u1, c.g), c.mul(u2, pub))
    if pt is None:
        return False
    return pt[0] % c.n == r % c.n
