"""Full DCAP quote verification circuit (reference roadmap item).

A copy of ``zkdcap_tpu/circuits/quote.py`` (host Python, no device work),
line for line the JAX package's, as the layout depends on every detail.

Covers the unimplemented reference roadmap (`README.md:23-46`, SURVEY.md §0)
and BASELINE.json configs[4]: "Full DCAP quote proof (QE3 + isv_report
sigs, MRENCLAVE/MRSIGNER/TCB checks)".

Statement (mirroring Intel DCAP quote verification structure):
  1. SHA-256(isv_report) is ECDSA-signed by the attestation key,
  2. the QE3 report binds the attestation key: its report_data field
     (offset 320..352) equals SHA-256(attest_pub.x || attest_pub.y),
  3. SHA-256(qe3_report) is ECDSA-signed by the PCK key,
  4. the isv_report's MRENCLAVE (offset 64..96) and MRSIGNER (offset
     128..160) equal expected public measurement constants,
  5. the isv_report's CPUSVN bytes (offset 0..16) are each >= the minimum
     TCB level constants.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..chips import Context, FlexGate, RangeChip
from ..chips.bigint import BigIntChip
from ..chips.ecc import EccChip, EcPoint
from ..chips.ecdsa import ecdsa_verify_no_pubkey_check
from ..chips.sha256 import Sha256Chip
from ..curves.host_curve import SECP256R1, p256_ecdsa_verify
from ..fields.params import BN254_FR
from .dcap import _crt_from_be_bytes

REPORT_LEN = 384
MRENCLAVE_OFF = 64
MRSIGNER_OFF = 128
REPORT_DATA_OFF = 320
CPUSVN_OFF = 0


@dataclasses.dataclass(frozen=True)
class QuoteInput:
    isv_report: bytes  # 384B
    qe3_report: bytes  # 384B, report_data = sha256(attest pubkey bytes)
    attest_pub: tuple[int, int]
    isv_sig: tuple[int, int]  # (r, s) by attest key over sha256(isv_report)
    qe_sig: tuple[int, int]  # (r, s) by PCK key over sha256(qe3_report)
    pck_pub: tuple[int, int]
    mrenclave: bytes  # expected, 32B (public constants)
    mrsigner: bytes  # expected, 32B
    min_cpusvn: bytes  # minimum TCB, 16B

    def verify_native(self) -> bool:
        n = SECP256R1.n
        z1 = int.from_bytes(hashlib.sha256(self.isv_report).digest(), "big") % n
        if not p256_ecdsa_verify(z1, *self.isv_sig, self.attest_pub):
            return False
        ak_bytes = self.attest_pub[0].to_bytes(32, "big") + self.attest_pub[1].to_bytes(32, "big")
        if self.qe3_report[REPORT_DATA_OFF : REPORT_DATA_OFF + 32] != hashlib.sha256(ak_bytes).digest():
            return False
        z2 = int.from_bytes(hashlib.sha256(self.qe3_report).digest(), "big") % n
        if not p256_ecdsa_verify(z2, *self.qe_sig, self.pck_pub):
            return False
        if self.isv_report[MRENCLAVE_OFF : MRENCLAVE_OFF + 32] != self.mrenclave:
            return False
        if self.isv_report[MRSIGNER_OFF : MRSIGNER_OFF + 32] != self.mrsigner:
            return False
        return all(
            self.isv_report[CPUSVN_OFF + i] >= self.min_cpusvn[i] for i in range(16)
        )


def trace_inputs(inp: QuoteInput) -> list[int]:
    """Flat witness-replay input vector (must match build_quote_trace's
    tracer.input order)."""
    return (list(inp.isv_report) + list(inp.qe3_report)
            + [inp.attest_pub[0], inp.attest_pub[1],
               inp.isv_sig[0], inp.isv_sig[1],
               inp.pck_pub[0], inp.pck_pub[1],
               inp.qe_sig[0], inp.qe_sig[1]])


def build_quote_trace(inp: QuoteInput, lookup_bits: int = 16,
                      tracer=None) -> Context:
    assert len(inp.isv_report) == REPORT_LEN and len(inp.qe3_report) == REPORT_LEN
    ctx = Context(tracer=tracer)
    gate = FlexGate(ctx)
    rc = RangeChip(gate, lookup_bits)
    fp = BigIntChip(rc, SECP256R1.p)
    fq = BigIntChip(rc, SECP256R1.n)
    ecc = EccChip(fp, SECP256R1)
    sha = Sha256Chip(gate, rc)

    def trace_val(v: int):
        return tracer.input(v) if tracer is not None else v

    def load_bytes(vals) -> list[int]:
        cells = []
        for b in vals:
            c = ctx.push(b)
            rc.range_check(c, 8)
            cells.append(c)
        return cells

    isv_vals = [trace_val(b) for b in inp.isv_report]
    qe_vals = [trace_val(b) for b in inp.qe3_report]
    isv_cells = load_bytes(isv_vals)
    qe_cells = load_bytes(qe_vals)

    # 1. isv_report signature under the attestation key
    d1 = sha.digest_bytes(isv_cells, isv_vals)
    m1 = _crt_from_be_bytes(fq, gate, [c for c, _ in d1], [v for _, v in d1])
    ak_xy = (trace_val(inp.attest_pub[0]), trace_val(inp.attest_pub[1]))
    ak = ecc.load_private(ak_xy, check_on_curve=True)
    r1 = fq.load_private(trace_val(inp.isv_sig[0]))
    s1 = fq.load_private(trace_val(inp.isv_sig[1]))
    gate.assert_const(ecdsa_verify_no_pubkey_check(ecc, fq, ak, r1, s1, m1), 1)

    # 2. attestation-key binding: qe3.report_data == sha256(ak.x || ak.y)
    #    ak coordinate bytes derived from the loaded CRT limbs (exact binding)
    ak_bytes_cells = []
    ak_bytes_vals = []
    for crt, val in ((ak.x, ak_xy[0]), (ak.y, ak_xy[1])):
        # big-endian coordinate bytes via shifts (tape-traceable, unlike
        # int.to_bytes which a TInt proxy cannot intercept)
        coord_bytes = [(val >> (8 * (31 - i))) & 0xFF for i in range(32)]
        cells = load_bytes(coord_bytes)
        # bind: recompose bytes into the CRT limbs
        bound = _crt_from_be_bytes(fp, gate, cells, coord_bytes)
        fp.assert_equal(bound, crt)
        ak_bytes_cells.extend(cells)
        ak_bytes_vals.extend(coord_bytes)
    d_ak = sha.digest_bytes(ak_bytes_cells, ak_bytes_vals)
    for i, (cell, _) in enumerate(d_ak):
        gate.assert_equal(cell, qe_cells[REPORT_DATA_OFF + i])

    # 3. qe3_report signature under the PCK key
    d2 = sha.digest_bytes(qe_cells, qe_vals)
    m2 = _crt_from_be_bytes(fq, gate, [c for c, _ in d2], [v for _, v in d2])
    pck = ecc.load_private((trace_val(inp.pck_pub[0]), trace_val(inp.pck_pub[1])),
                           check_on_curve=True)
    r2 = fq.load_private(trace_val(inp.qe_sig[0]))
    s2 = fq.load_private(trace_val(inp.qe_sig[1]))
    gate.assert_const(ecdsa_verify_no_pubkey_check(ecc, fq, pck, r2, s2, m2), 1)

    # 4. measurement comparisons (public constants)
    for i in range(32):
        gate.assert_const(isv_cells[MRENCLAVE_OFF + i], inp.mrenclave[i])
        gate.assert_const(isv_cells[MRSIGNER_OFF + i], inp.mrsigner[i])

    # 5. TCB: cpusvn[i] >= min_cpusvn[i]
    # both operands are bytes (< 256, range-checked), so cpusvn >= min
    # iff (cpusvn - min) mod r fits in 8 bits
    for i in range(16):
        diff = gate.add_const(isv_cells[CPUSVN_OFF + i], (-inp.min_cpusvn[i]) % BN254_FR.p)
        rc.range_check(diff, 8)
    return ctx


def make_demo_quote(seed: int = 13) -> QuoteInput:
    import random

    rng = random.Random(seed)
    c = SECP256R1
    ak_d = rng.randrange(1, c.n)
    pck_d = rng.randrange(1, c.n)
    ak = c.mul(ak_d, c.g)
    pck = c.mul(pck_d, c.g)

    mrenclave = bytes(rng.randrange(256) for _ in range(32))
    mrsigner = bytes(rng.randrange(256) for _ in range(32))
    min_svn = bytes(rng.randrange(5) for _ in range(16))

    isv = bytearray(rng.randrange(256) for _ in range(REPORT_LEN))
    isv[CPUSVN_OFF : CPUSVN_OFF + 16] = bytes(
        min_svn[i] + rng.randrange(3) for i in range(16)
    )
    isv[MRENCLAVE_OFF : MRENCLAVE_OFF + 32] = mrenclave
    isv[MRSIGNER_OFF : MRSIGNER_OFF + 32] = mrsigner

    qe = bytearray(rng.randrange(256) for _ in range(REPORT_LEN))
    ak_bytes = ak[0].to_bytes(32, "big") + ak[1].to_bytes(32, "big")
    qe[REPORT_DATA_OFF : REPORT_DATA_OFF + 32] = hashlib.sha256(ak_bytes).digest()

    def sign(data: bytes, d: int):
        z = int.from_bytes(hashlib.sha256(data).digest(), "big") % c.n
        k = rng.randrange(1, c.n)
        r = c.mul(k, c.g)[0] % c.n
        s = pow(k, -1, c.n) * (z + r * d) % c.n
        return (r, s)

    return QuoteInput(
        isv_report=bytes(isv),
        qe3_report=bytes(qe),
        attest_pub=ak,
        isv_sig=sign(bytes(isv), ak_d),
        qe_sig=sign(bytes(qe), pck_d),
        pck_pub=pck,
        mrenclave=mrenclave,
        mrsigner=mrsigner,
        min_cpusvn=min_svn,
    )
