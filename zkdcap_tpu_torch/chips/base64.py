"""Base64-decode chip (reference components A1 + A2, SURVEY.md §2.1).

A copy of ``zkdcap_tpu/chips/base64.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Reference semantics: prove that a base64 string (e.g. the 1,696-char PEM
body of the SGX PCK leaf certificate) decodes to its DER bytes
(`circuits/src/sgx_dcap_verifier.rs:64-329`); the reference uses 12 bit-
decomposition columns + char/value lookup tables
(`circuits/src/table/mod.rs:15-150`, '=' maps to 0).

TPU-native design: one custom pair-lookup table (char_code, sextet) of 66
rows ('=' -> 0, plus the mandatory (0,0) padding row), and per 4-char
group two 2/4-bit splits + three byte recompositions on the flex gate —
~30 cells per group instead of region-style bit columns.
"""

from __future__ import annotations

import base64

from .context import Context, FlexGate
from .range import RangeChip

B64_ALPHABET = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
)

# (char_code, sextet) rows; '=' -> 0 like the reference table (table/mod.rs:42-63)
B64_TABLE_ROWS = [(0, 0), (ord("="), 0)] + [
    (ord(ch), i) for i, ch in enumerate(B64_ALPHABET)
]
TABLE_NAME = "base64"


# total char_code -> sextet map for the witness-replay tracer table
# (invalid codes map to 0; the pair lookup still rejects them in-circuit)
_B64_REV256 = [0] * 256
for _i, _ch in enumerate(B64_ALPHABET):
    _B64_REV256[ord(_ch)] = _i


class Base64Chip:
    def __init__(self, gate: FlexGate, rc: RangeChip):
        self.gate = gate
        self.ctx = gate.ctx
        self.rc = rc
        self.ctx.register_pair_table(TABLE_NAME, B64_TABLE_ROWS)
        self._rev_tid = (
            self.ctx.tracer.register_table(_B64_REV256)
            if self.ctx.tracer is not None
            else None
        )

    def decode(self, text: str) -> list[tuple[int, int]]:
        """Push the base64 chars as witness cells and prove the decode.

        Returns [(byte_cell, byte_value)] of the decoded bytes (padding
        bytes trimmed, matching host base64.b64decode).
        """
        ctx, g, rc = self.ctx, self.gate, self.rc
        assert len(text) % 4 == 0, "base64 length must be a multiple of 4"
        expected = base64.b64decode(text)
        out: list[tuple[int, int]] = []
        n_pad = text.count("=")
        tr = ctx.tracer
        for gi in range(0, len(text), 4):
            chars = text[gi : gi + 4]
            if tr is not None:
                # per-proof inputs: the char codes; sextets via a traced
                # table node so the whole decode replays from the DAG
                cvals = [tr.input(ord(c)) for c in chars]
                svals = [tr.table(self._rev_tid, cv) for cv in cvals]
            else:
                cvals = [ord(c) for c in chars]
                svals = [0 if c == "=" else B64_ALPHABET.index(c) for c in chars]
            ccells = [ctx.push(v) for v in cvals]
            scells = [ctx.push(v) for v in svals]
            for cc, sc in zip(ccells, scells):
                ctx.pair_lookup(TABLE_NAME, cc, sc)
            # s1 = h1*16 + l1 (2+4 bits), s2 = h2*4 + l2 (4+2 bits)
            h1, l1 = svals[1] >> 4, svals[1] & 0xF
            h2, l2 = svals[2] >> 2, svals[2] & 0x3
            h1c, l1c = ctx.push(h1), ctx.push(l1)
            h2c, l2c = ctx.push(h2), ctx.push(l2)
            rc.range_check(h1c, 2)
            rc.range_check(l1c, 4)
            rc.range_check(h2c, 4)
            rc.range_check(l2c, 2)
            g.assert_equal(g.mul_const_add(h1c, 16, l1c), scells[1])
            g.assert_equal(g.mul_const_add(h2c, 4, l2c), scells[2])
            # bytes
            b0 = g.mul_const_add(scells[0], 4, h1c)  # s0<<2 | s1>>4
            b1 = g.mul_const_add(l1c, 16, h2c)  # (s1&15)<<4 | s2>>2
            b2 = g.mul_const_add(l2c, 64, scells[3])  # (s2&3)<<6 | s3
            vals = [
                (svals[0] << 2) | h1,
                (l1 << 4) | h2,
                (l2 << 6) | svals[3],
            ]
            out.extend(zip((b0, b1, b2), vals))
        if n_pad:
            out = out[:-n_pad]
        assert bytes(v for _, v in out) == expected, "decode witness mismatch"
        return out
