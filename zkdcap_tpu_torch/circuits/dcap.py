"""SGX DCAP verifier circuit (reference stack A, SURVEY.md §2.1 A1-A5).

A copy of ``zkdcap_tpu/circuits/dcap.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Proves, in zero knowledge (semantics of
`circuits/src/sgx_dcap_verifier.rs:351-733`):

  1. a 1,696-char base64 PEM body decodes to the 1,271 DER bytes of an SGX
     PCK leaf certificate (base64 chip; ref :260-329),
  2. the SHA-256 digest of a 384-byte QE3 report equals the ECDSA message
     hash (SHA-256 chip; ref :426-480 — digest bytes are bound to the
     msghash limbs by exact byte recomposition, a *stronger* binding than
     the reference's single mod-r compression at :460-464),
  3. a secp256r1 ECDSA signature over that digest verifies against the
     public key embedded at DER offset 335 of the decoded certificate
     (byte 334 is constrained to the 0x04 SEC1 tag; ref :566-587,
     offset note SURVEY.md §3.1),

using the in-circuit ECDSA gadget with the reference's (4, 4) window
parameters. Like the reference demo, there are no public instances
(`MockProver::run(k, &circuit, vec![])`, ref :790).

Demo witness data (dcap_demo_data.json) is the reference's own public
Intel PCK demo inputs (cert literal ref :769, QE3 report :402-419,
signature :513-524).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os

from ..chips import Context, FlexGate, RangeChip
from ..chips.base64 import Base64Chip
from ..chips.bigint import LIMB_BITS, NUM_LIMBS, BigIntChip
from ..chips.ecc import EccChip, EcPoint
from ..chips.ecdsa import ecdsa_verify_no_pubkey_check
from ..chips.sha256 import Sha256Chip
from ..curves.host_curve import SECP256R1, p256_ecdsa_verify

CERT_B64_LEN = 1696  # SHAHASH_BASE64_STRING_LEN, ref :40
QE3_REPORT_LEN = 384  # ref :402-419, digest(ctx, input, Some(384)) :435
PUBKEY_DER_OFFSET = 335  # ref :566-587 (byte 334 is the 0x04 SEC1 tag)
DCAP_LOOKUP_BITS = 16  # stack A config lookup_bits (ecdsa_circuit.config:1)


@dataclasses.dataclass(frozen=True)
class DcapInput:
    cert_b64: str
    qe3_report: bytes
    r: int
    s: int

    def decoded_cert(self) -> bytes:
        return base64.b64decode(self.cert_b64)

    def pubkey(self) -> tuple[int, int]:
        der = self.decoded_cert()
        assert der[PUBKEY_DER_OFFSET - 1] == 0x04
        x = int.from_bytes(der[PUBKEY_DER_OFFSET : PUBKEY_DER_OFFSET + 32], "big")
        y = int.from_bytes(der[PUBKEY_DER_OFFSET + 32 : PUBKEY_DER_OFFSET + 64], "big")
        return (x, y)

    def msghash(self) -> int:
        return int.from_bytes(hashlib.sha256(self.qe3_report).digest(), "big")

    def verify_native(self) -> bool:
        return p256_ecdsa_verify(self.msghash() % SECP256R1.n, self.r, self.s, self.pubkey())


def load_demo_input() -> DcapInput:
    path = os.path.join(os.path.dirname(__file__), "dcap_demo_data.json")
    with open(path) as f:
        d = json.load(f)
    return DcapInput(
        cert_b64=d["cert_b64"],
        qe3_report=bytes(d["qe3_report"]),
        r=int.from_bytes(bytes(d["r_le"]), "little"),
        s=int.from_bytes(bytes(d["s_le"]), "little"),
    )


def _crt_from_be_bytes(fq: BigIntChip, gate: FlexGate, byte_cells, byte_vals):
    """Bind 32 big-endian byte cells into a 3x88-bit CRT integer exactly.

    limb0 = bytes 21..31, limb1 = bytes 10..20, limb2 = bytes 0..9
    (88 bits = 11 bytes; the byte/limb boundaries align)."""
    assert len(byte_cells) == 32
    value = 0
    for v in byte_vals:
        value = (value << 8) | v
    limbs = []
    for limb_idx in range(NUM_LIMBS):
        lo_bit = LIMB_BITS * limb_idx
        n_bytes = 11 if limb_idx < 2 else 10
        hi_byte = 31 - lo_bit // 8  # least-significant byte index of this limb
        idxs = list(range(hi_byte - n_bytes + 1, hi_byte + 1))
        cells = [byte_cells[i] for i in idxs]
        weights = [1 << (8 * (hi_byte - i)) for i in idxs]
        limbs.append(gate.inner_product_const(cells, weights))
    return fq.from_limbs(limbs, value)


def trace_inputs(inp: DcapInput) -> list[int]:
    """Flat witness-replay input vector (must match build_dcap_trace's
    tracer.input order: b64 chars group-wise, report bytes, r, s)."""
    return [ord(c) for c in inp.cert_b64] + list(inp.qe3_report) + [inp.r, inp.s]


def build_dcap_trace(
    inp: DcapInput, lookup_bits: int = DCAP_LOOKUP_BITS, tracer=None
) -> Context:
    assert len(inp.cert_b64) == CERT_B64_LEN
    assert len(inp.qe3_report) == QE3_REPORT_LEN
    ctx = Context(tracer=tracer)
    gate = FlexGate(ctx)
    rc = RangeChip(gate, lookup_bits)
    fp = BigIntChip(rc, SECP256R1.p)
    fq = BigIntChip(rc, SECP256R1.n)
    ecc = EccChip(fp, SECP256R1)
    b64 = Base64Chip(gate, rc)
    sha = Sha256Chip(gate, rc)

    # 1. base64 decode of the leaf cert (A1/A2)
    cert_bytes = b64.decode(inp.cert_b64)  # [(cell, value)]
    assert len(cert_bytes) == 1271

    # 2. SHA-256 of the QE3 report -> msghash CRT integer
    report_cells = []
    report_vals = (
        [tracer.input(b) for b in inp.qe3_report]
        if tracer is not None
        else list(inp.qe3_report)
    )
    for b in report_vals:
        c = ctx.push(b)
        rc.range_check(c, 8)
        report_cells.append(c)
    digest = sha.digest_bytes(report_cells, report_vals)
    m = _crt_from_be_bytes(
        fq, gate, [c for c, _ in digest], [v for _, v in digest]
    )

    # 3. pubkey extracted from the decoded certificate at DER offset 335
    gate.assert_const(cert_bytes[PUBKEY_DER_OFFSET - 1][0], 0x04)
    xb = cert_bytes[PUBKEY_DER_OFFSET : PUBKEY_DER_OFFSET + 32]
    yb = cert_bytes[PUBKEY_DER_OFFSET + 32 : PUBKEY_DER_OFFSET + 64]
    pk_x = _crt_from_be_bytes(fp, gate, [c for c, _ in xb], [v for _, v in xb])
    pk_y = _crt_from_be_bytes(fp, gate, [c for c, _ in yb], [v for _, v in yb])
    pk = EcPoint(pk_x, pk_y, (pk_x.value, pk_y.value))

    # 4. signature witnesses + ECDSA verify (windows (4,4), ref :701-710)
    vr, vs = (
        (tracer.input(inp.r), tracer.input(inp.s))
        if tracer is not None
        else (inp.r, inp.s)
    )
    r = fq.load_private(vr)
    s = fq.load_private(vs)
    res = ecdsa_verify_no_pubkey_check(ecc, fq, pk, r, s, m)
    gate.assert_const(res, 1)  # assert_is_const(.., 1), ref :713
    return ctx
