"""Certificate-chain verification circuit (reference roadmap item).

A copy of ``zkdcap_tpu/circuits/cert_chain.py`` (host Python, no device
work); the layout, and with it the pinning, the vk and the proofs, depend
on every detail of it, so it stays line for line the JAX package's.

The reference's README roadmap (`README.md:10-51`, SURVEY.md §0) lists
cert-chain checking against Intel's Root CA as an unimplemented target;
BASELINE.json configs[3] names it ("Cert-chain circuit: Root CA ->
intermediate -> leaf (2x ECDSA + SHA-256)").

Each link proves: SHA-256(tbs_i) is ECDSA-signed by the issuer's subject
public key, which is itself embedded in tbs_{i+1} at a known offset; the
chain terminates at a trust-anchor public key baked in as circuit
constants. This composes the same chips as the DCAP circuit (base64 is
orthogonal; chains operate on DER bytes directly).
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
from .dcap import _crt_from_be_bytes


@dataclasses.dataclass(frozen=True)
class CertLink:
    tbs: bytes  # to-be-signed bytes of this certificate
    r: int
    s: int
    pubkey_offset: int  # offset of the SUBJECT pubkey (0x04 tag) inside tbs


@dataclasses.dataclass(frozen=True)
class CertChainInput:
    """links[0] = leaf ... links[-1] signed by the trust anchor."""

    links: list[CertLink]
    root_pubkey: tuple[int, int]  # trust anchor (circuit constant)

    def issuer_pubkey(self, i: int) -> tuple[int, int]:
        if i + 1 < len(self.links):
            tbs = self.links[i + 1].tbs
            off = self.links[i + 1].pubkey_offset
            assert tbs[off] == 0x04
            return (
                int.from_bytes(tbs[off + 1 : off + 33], "big"),
                int.from_bytes(tbs[off + 33 : off + 65], "big"),
            )
        return self.root_pubkey

    def verify_native(self) -> bool:
        n = SECP256R1.n
        for i, link in enumerate(self.links):
            z = int.from_bytes(hashlib.sha256(link.tbs).digest(), "big") % n
            if not p256_ecdsa_verify(z, link.r, link.s, self.issuer_pubkey(i)):
                return False
        return True


def trace_inputs(inp: CertChainInput) -> list[int]:
    """Flat witness-replay input vector (must match build_cert_chain_trace's
    tracer.input order: every link's tbs bytes, then every link's r, s)."""
    out: list[int] = []
    for link in inp.links:
        out.extend(link.tbs)
    for link in inp.links:
        out.extend([link.r, link.s])
    return out


def build_cert_chain_trace(inp: CertChainInput, lookup_bits: int = 16,
                           tracer=None) -> Context:
    ctx = Context(tracer=tracer)
    gate = FlexGate(ctx)
    rc = RangeChip(gate, lookup_bits)
    fp = BigIntChip(rc, SECP256R1.p)
    fq = BigIntChip(rc, SECP256R1.n)
    ecc = EccChip(fp, SECP256R1)
    sha = Sha256Chip(gate, rc)

    # load each cert's tbs bytes as witness cells
    tbs_cells: list[list[int]] = []
    tbs_vals: list[list[int]] = []
    for link in inp.links:
        vals = ([tracer.input(b) for b in link.tbs] if tracer is not None
                else list(link.tbs))
        cells = []
        for b in vals:
            c = ctx.push(b)
            rc.range_check(c, 8)
            cells.append(c)
        tbs_cells.append(cells)
        tbs_vals.append(vals)

    for i, link in enumerate(inp.links):
        digest = sha.digest_bytes(tbs_cells[i], tbs_vals[i])
        m = _crt_from_be_bytes(
            fq, gate, [c for c, _ in digest], [v for _, v in digest]
        )
        if i + 1 < len(inp.links):
            # issuer pubkey from the NEXT cert's tbs cells (binding!)
            off = inp.links[i + 1].pubkey_offset
            nxt = tbs_cells[i + 1]
            nxt_vals = tbs_vals[i + 1]
            gate.assert_const(nxt[off], 0x04)
            xb_c = nxt[off + 1 : off + 33]
            xb_v = nxt_vals[off + 1 : off + 33]
            yb_c = nxt[off + 33 : off + 65]
            yb_v = nxt_vals[off + 33 : off + 65]
            pk_x = _crt_from_be_bytes(fp, gate, xb_c, xb_v)
            pk_y = _crt_from_be_bytes(fp, gate, yb_c, yb_v)
            pk = EcPoint(pk_x, pk_y, (pk_x.value, pk_y.value))
        else:
            pk = ecc.load_constant(inp.root_pubkey)  # trust anchor
        vr, vs = ((tracer.input(link.r), tracer.input(link.s))
                  if tracer is not None else (link.r, link.s))
        r = fq.load_private(vr)
        s = fq.load_private(vs)
        res = ecdsa_verify_no_pubkey_check(ecc, fq, pk, r, s, m)
        gate.assert_const(res, 1)
    return ctx


# --- DER helpers (minimal TLV encode/parse for X.509 structures) ----------

def _der_hdr(data: bytes, i: int) -> tuple[int, int]:
    """TLV header at offset i -> (header_len, content_len)."""
    l = data[i + 1]
    if l < 0x80:
        return 2, l
    nb = l & 0x7F
    return 2 + nb, int.from_bytes(data[i + 2 : i + 2 + nb], "big")


def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    nb = (n.bit_length() + 7) // 8
    return bytes([tag, 0x80 | nb]) + n.to_bytes(nb, "big") + content


def intel_leaf_tbs() -> bytes:
    """The REAL Intel SGX PCK leaf certificate's tbsCertificate bytes,
    extracted from the reference demo witness DER (the 1,271-byte cert at
    circuits/src/sgx_dcap_verifier.rs:769; X.509 signature input is the
    full DER encoding of the first child of the outer SEQUENCE)."""
    from .dcap import load_demo_input

    der = load_demo_input().decoded_cert()
    assert der[0] == 0x30
    h, _ = _der_hdr(der, 0)
    assert der[h] == 0x30  # tbsCertificate
    ch, cl = _der_hdr(der, h)
    return der[h : h + ch + cl]


def _spki_pubkey_offset(tbs: bytes) -> int:
    """Offset of the 0x04 SEC1 tag inside an ECDSA SubjectPublicKeyInfo
    BIT STRING (03 42 00 04 x32 y32)."""
    i = tbs.find(b"\x03\x42\x00\x04")
    assert i >= 0, "no uncompressed-point SPKI found"
    return i + 3


def _synth_ca_tbs(subject: str, issuer: str, pubkey: tuple[int, int],
                  serial: int) -> bytes:
    """Minimal but well-formed X.509 tbsCertificate for a synthetic P-256
    CA: version/serial/sigalg/issuer/validity/subject/SPKI."""
    oid_ecdsa_sha256 = bytes.fromhex("06082a8648ce3d040302")
    oid_ec_pub = bytes.fromhex("06072a8648ce3d0201")
    oid_p256 = bytes.fromhex("06082a8648ce3d030107")
    oid_cn = bytes.fromhex("0603550403")

    def name(cn: str) -> bytes:
        return _tlv(0x30, _tlv(0x31, _tlv(0x30, oid_cn + _tlv(0x0C, cn.encode()))))

    spki = _tlv(0x30, _tlv(0x30, oid_ec_pub + oid_p256) + _tlv(
        0x03, b"\x00\x04" + pubkey[0].to_bytes(32, "big") + pubkey[1].to_bytes(32, "big")))
    validity = _tlv(0x30, _tlv(0x17, b"250101000000Z") + _tlv(0x17, b"350101000000Z"))
    body = (
        _tlv(0xA0, _tlv(0x02, b"\x02"))  # [0] version v3
        + _tlv(0x02, serial.to_bytes(9, "big").lstrip(b"\x00") or b"\x00")
        + _tlv(0x30, oid_ecdsa_sha256)
        + name(issuer)
        + validity
        + name(subject)
        + spki
    )
    return _tlv(0x30, body)


def _sign_tbs(tbs: bytes, d: int, rng) -> tuple[int, int]:
    c = SECP256R1
    z = int.from_bytes(hashlib.sha256(tbs).digest(), "big") % c.n
    k = rng.randrange(1, c.n)
    r = c.mul(k, c.g)[0] % c.n
    s = pow(k, -1, c.n) * (z + r * d) % c.n
    return r, s


def make_intel_demo_chain(seed: int = 2024) -> CertChainInput:
    """3-deep chain whose LEAF is the real Intel SGX PCK leaf certificate
    TBS (1,157 bytes from the reference demo witness, intel_leaf_tbs).

    The issuing Intel PCK Platform CA / Root CA certificates are not part
    of the reference repo and this environment has no network egress, so
    the intermediate and root are SYNTHESIZED: well-formed X.509 CA
    tbsCertificates carrying fresh P-256 keys, with the real leaf TBS
    re-signed by the synthetic intermediate (real leaf bytes, synthetic
    chain-of-trust — see PARITY.md)."""
    import random

    rng = random.Random(seed)
    c = SECP256R1
    int_d = rng.randrange(1, c.n)
    root_d = rng.randrange(1, c.n)
    int_pub = c.mul(int_d, c.g)
    root_pub = c.mul(root_d, c.g)

    leaf_tbs = intel_leaf_tbs()
    int_tbs = _synth_ca_tbs("Synthetic SGX Platform CA",
                            "Synthetic SGX Root CA", int_pub, serial=0x1CA)
    links = [
        CertLink(tbs=leaf_tbs, r=0, s=0,
                 pubkey_offset=_spki_pubkey_offset(leaf_tbs)),
        CertLink(tbs=int_tbs, r=0, s=0,
                 pubkey_offset=_spki_pubkey_offset(int_tbs)),
    ]
    r0, s0 = _sign_tbs(leaf_tbs, int_d, rng)
    r1, s1 = _sign_tbs(int_tbs, root_d, rng)
    links[0] = dataclasses.replace(links[0], r=r0, s=s0)
    links[1] = dataclasses.replace(links[1], r=r1, s=s1)
    return CertChainInput(links=links, root_pubkey=root_pub)


def make_demo_chain(n_links: int = 2, tbs_len: int = 256, seed: int = 7,
                    root_key: int | None = None):
    """Synthetic chain for tests: issuer keys embedded at offset 100.

    root_key pins the trust anchor: the root pubkey is a CIRCUIT CONSTANT
    (fixed-base mul structure depends on it), so chains proved under one
    pk/pinning must share it."""
    import random

    rng = random.Random(seed)
    c = SECP256R1
    keys = [rng.randrange(1, c.n) for _ in range(n_links + 1)]
    if root_key is not None:
        keys[n_links] = root_key
    pubs = [c.mul(d, c.g) for d in keys]
    off = 100
    links = []
    tbs_list = []
    for i in range(n_links):
        tbs = bytearray(rng.randrange(256) for _ in range(tbs_len))
        if i > 0:
            # embed THIS cert's subject pubkey (it signs cert i-1)
            tbs[off] = 0x04
            tbs[off + 1 : off + 33] = pubs[i][0].to_bytes(32, "big")
            tbs[off + 33 : off + 65] = pubs[i][1].to_bytes(32, "big")
        tbs_list.append(bytes(tbs))
    for i in range(n_links):
        signer = keys[i + 1]  # issuer of cert i
        z = int.from_bytes(hashlib.sha256(tbs_list[i]).digest(), "big") % c.n
        k = rng.randrange(1, c.n)
        r = c.mul(k, c.g)[0] % c.n
        s = pow(k, -1, c.n) * (z + r * signer) % c.n
        links.append(CertLink(tbs=tbs_list[i], r=r, s=s, pubkey_offset=off))
    return CertChainInput(links=links, root_pubkey=pubs[n_links])
