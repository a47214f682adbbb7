"""P-256 ECDSA application circuit (reference stack B).

A copy of ``zkdcap_tpu/circuits/p256_ecdsa.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Mirrors `crates/p256-ecdsa/src/circuit.rs:20-69` + `src/lib.rs` (SURVEY.md
§2.1 A6/A7): LOOKUP_BITS=17, LIMB_BITS=88, NUM_LIMBS=3; msghash/r/s loaded
over Fq and the pubkey over Fp (`load_private_unchecked` — no on-curve
check, matching circuit.rs:45); all 15 limbs (5 values x 3 limbs of 88
bits) exposed as public instances in the order
[msghash, r, s, pk.x, pk.y] (`lib.rs:79-89`, `base.rs:100`); the gadget
result is asserted == 1 (circuit.rs:54-55).
"""

from __future__ import annotations

import dataclasses

from ..chips import Context, FlexGate, RangeChip
from ..chips.bigint import LIMB_BITS, NUM_LIMBS, BigIntChip
from ..chips.ecc import EccChip
from ..chips.ecdsa import ecdsa_verify_no_pubkey_check
from ..curves.host_curve import SECP256R1, p256_ecdsa_verify

LOOKUP_BITS = 17  # circuit.rs:25
LIMB_MASK_88 = (1 << LIMB_BITS) - 1


@dataclasses.dataclass(frozen=True)
class ECDSAInput:
    """Reference `ECDSAInput` (lib.rs:17-24): all fields as python ints."""

    r: int
    s: int
    msghash: int
    x: int
    y: int

    @staticmethod
    def from_hex(msghash: str, signature: str, pubkey: str) -> "ECDSAInput":
        """Reference try_from_hex (lib.rs:62-77): 32-byte BE msghash,
        64-byte r||s signature, 65-byte uncompressed 04||x||y pubkey."""
        mh = bytes.fromhex(msghash.removeprefix("0x"))
        sig = bytes.fromhex(signature.removeprefix("0x"))
        pk = bytes.fromhex(pubkey.removeprefix("0x"))
        assert len(mh) == 32, "msghash must be 32 bytes"
        assert len(sig) == 64, "signature should be 64 bytes"
        assert len(pk) == 65 and pk[0] == 4, "pubkey should be uncompressed format"
        be = lambda b: int.from_bytes(b, "big")
        n, p = SECP256R1.n, SECP256R1.p
        r, s = be(sig[:32]), be(sig[32:])
        x, y = be(pk[1:33]), be(pk[33:])
        assert r < n and s < n and x < p and y < p, "invalid input"
        return ECDSAInput(r=r, s=s, msghash=be(mh) % n, x=x, y=y)

    def as_instances(self) -> list[int]:
        """15 Fr values: 3x88-bit limbs of [msghash, r, s, x, y] (lib.rs:79-89)."""
        out = []
        for v in (self.msghash, self.r, self.s, self.x, self.y):
            for i in range(NUM_LIMBS):
                out.append((v >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1))
        return out

    def verify_native(self) -> bool:
        return p256_ecdsa_verify(self.msghash, self.r, self.s, (self.x, self.y))


def trace_inputs(inp: ECDSAInput) -> list[int]:
    """Flat witness-replay input vector (must match build_ecdsa_trace's
    tracer.input order)."""
    return [inp.msghash, inp.r, inp.s, inp.x, inp.y]


def build_ecdsa_trace(
    inp: ECDSAInput, lookup_bits: int = LOOKUP_BITS, tracer=None
) -> Context:
    """Record the circuit trace (structure is input-independent)."""
    ctx = Context(tracer=tracer)
    gate = FlexGate(ctx)
    rc = RangeChip(gate, lookup_bits)
    fp = BigIntChip(rc, SECP256R1.p)
    fq = BigIntChip(rc, SECP256R1.n)
    ecc = EccChip(fp, SECP256R1)

    if tracer is not None:
        vm, vr, vs, vx, vy = (tracer.input(v) for v in trace_inputs(inp))
    else:
        vm, vr, vs, vx, vy = inp.msghash, inp.r, inp.s, inp.x, inp.y
    m = fq.load_private(vm)
    r = fq.load_private(vr)
    s = fq.load_private(vs)
    pk = ecc.load_private((vx, vy))  # no on-curve check: circuit.rs:45

    # public instances: limbs of m, r, s, pk.x, pk.y (circuit.rs:38-48)
    for crt in (m, r, s, pk.x, pk.y):
        for limb in crt.limbs:
            ctx.expose_public(limb)

    res = ecdsa_verify_no_pubkey_check(ecc, fq, pk, r, s, m)
    gate.assert_const(res, 1)  # circuit.rs:54-55
    return ctx
