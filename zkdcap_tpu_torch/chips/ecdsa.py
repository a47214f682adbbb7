"""In-circuit ECDSA verification gadget (secp256r1).

A copy of ``zkdcap_tpu/chips/ecdsa.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Semantics of halo2-ecc's `ecdsa_verify_no_pubkey_check::<F, Fp, Fq, Affine>
(chip, ctx, pk, r, s, m, 4, 4)` (reference call sites
`circuits/src/sgx_dcap_verifier.rs:701-710`, `crates/p256-ecdsa/src/circuit.rs:51`;
SURVEY.md §2.2 D-ECC): checks 0 < r, s < n, computes w = s^-1,
u1 = m*w, u2 = r*w, R = u1*G + u2*pk (Strauss window-4 multi-scalar mul) and
constrains x(R) ≡ r (mod n). Pubkey on-curve checking is the caller's
responsibility (hence "no_pubkey_check").

Returns a cell that is constant 1 when all constraints hold — the caller
asserts it like the reference (`gate.assert_is_const(ctx, &res, &Fr::one())`).
"""

from __future__ import annotations

from ..curves.host_curve import SECP256R1
from ..fields import BN254_FR
from .bigint import NUM_LIMBS, BigIntChip, CRTInt, _split
from .ecc import EccChip, EcPoint


def ecdsa_verify_no_pubkey_check(
    ecc: EccChip,
    fq: BigIntChip,
    pk: EcPoint,
    r: CRTInt,
    s: CRTInt,
    msghash: CRTInt,
) -> int:
    """r, s, msghash are CRT ints over Fq = Z_n (n = secp256r1 group order);
    pk coordinates over Fp."""
    curve = SECP256R1
    g = ecc.fp.gate
    assert fq.p == curve.n

    # 0 < r, s < n
    r_c = fq.reduce_canonical(r)
    s_c = fq.reduce_canonical(s)
    g.assert_const(fq.is_zero(r_c), 0)
    g.assert_const(fq.is_zero(s_c), 0)

    w = fq.inv(s_c)
    u1 = fq.mul(msghash, w)
    u2 = fq.mul(r_c, w)
    # u1, u2 are representatives in [0, 2^256); since the group has order n,
    # (u1 mod n + k*n) * G == (u1 mod n) * G, so representatives are fine.

    G = ecc.load_constant(curve.g)
    bits1 = ecc.scalar_bits(u1, fq)
    bits2 = ecc.scalar_bits(u2, fq)
    R_pt = ecc.msm_window4([G, pk], [bits1, bits2])

    # x(R) ≡ r (mod n): canonical x < p < 2n, so x = r + j*n with j in {0,1}
    assert curve.p < 2 * curve.n
    x_c = ecc.fp.reduce_canonical(R_pt.x)
    x_val = x_c.value
    # traced 0/1 node for TInt shadow values (witness replay), bool else
    j_val = (x_val != r_c.value) * 1
    assert x_val == r_c.value + j_val * curve.n, "ecdsa witness: x(R) != r mod n"
    ctx = g.ctx
    j = ctx.push(j_val)
    g.assert_bit(j)

    # limb carry chain for x - r - j*n == 0 (mod 2^264) + native (mod r_bn)
    n_limbs = _split(curve.n)
    t_cells = []
    t_ints = []
    for k in range(NUM_LIMBS):
        jn = g.mul_const(j, n_limbs[k])
        term = g.sub(g.sub(x_c.limbs[k], r_c.limbs[k]), jn)
        t_cells.append(term)
        t_ints.append(x_c.limb_vals[k] - r_c.limb_vals[k] - j_val * n_limbs[k])
    ecc.fp._carry_chain(t_cells, t_ints)
    nat = g.sub(
        g.sub(x_c.native, r_c.native), g.mul_const(j, curve.n % BN254_FR.p)
    )
    g.assert_const(nat, 0)

    return ctx.constant(1)
