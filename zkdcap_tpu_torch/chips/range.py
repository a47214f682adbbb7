"""Range chip: lookup-based range checks (halo2-base RangeChip equivalent).

A copy of ``zkdcap_tpu/chips/range.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Reference semantics (SURVEY.md §2.2 D-BASE4; `crates/p256-ecdsa/src/circuit.rs:29`
builds RangeChip::new(lookup_bits=17)): a value is range-checked to B bits by
decomposing it into lookup_bits-sized limbs (each sent to the range lookup
table) plus one truncated top limb checked by a shifted trick.
"""

from __future__ import annotations

from ..fields import BN254_FR
from .context import Context, FlexGate

R = BN254_FR.p


class RangeChip:
    def __init__(self, gate: FlexGate, lookup_bits: int):
        self.gate = gate
        self.ctx = gate.ctx
        self.lookup_bits = lookup_bits

    def _lookup(self, cell: int) -> None:
        self.ctx.lookup_cells.append(cell)

    def range_check(self, a: int, bits: int) -> None:
        """Constrain 0 <= a < 2^bits."""
        lb = self.lookup_bits
        ctx, gate = self.ctx, self.gate
        va = ctx.value(a)
        assert va < (1 << bits), f"range_check witness {va} >= 2^{bits}"
        if bits == 0:
            gate.assert_const(a, 0)
            return
        k = (bits + lb - 1) // lb
        rem = bits - (k - 1) * lb  # top limb width
        if k == 1:
            if rem == lb:
                self._lookup(a)
                return
            # check a < 2^rem: lookup a and a * 2^(lb-rem)
            self._lookup(a)
            shifted = gate.mul_const(a, 1 << (lb - rem))
            self._lookup(shifted)
            return
        # decompose: a = sum limb_i 2^(lb i), each limb looked up
        limbs = []
        v = va
        for _ in range(k):
            limbs.append(ctx.push(v & ((1 << lb) - 1)))
            v >>= lb
        for l in limbs[:-1]:
            self._lookup(l)
        # top limb: < 2^rem
        top = limbs[-1]
        self._lookup(top)
        if rem < lb:
            shifted = gate.mul_const(top, 1 << (lb - rem))
            self._lookup(shifted)
        # recomposition constraint
        acc = gate.inner_product_const(limbs, [1 << (lb * i) for i in range(k)])
        gate.assert_equal(acc, a)

    def check_less_than(self, a: int, b: int, bits: int) -> None:
        """Constrain a < b given both already known < 2^bits."""
        # c = a - b + 2^bits ; a < b  <=>  c < 2^bits
        gate = self.gate
        shifted = gate.add_const(gate.sub(a, b), 1 << bits)
        # shifted = a - b + 2^bits in [1, 2^(bits+1)); a<b <=> shifted < 2^bits
        self.range_check(shifted, bits)

    def is_less_than(self, a: int, b: int, bits: int) -> int:
        """Boolean cell: a < b, for a, b < 2^bits."""
        gate, ctx = self.gate, self.ctx
        va, vb = ctx.value(a), ctx.value(b)
        # bool for plain ints, traced 0/1 node for TInt (witness replay)
        lt = (va < vb) * 1
        out = ctx.push(lt)
        gate.assert_bit(out)
        # shifted = a - b + 2^bits = 2^bits * (1 - out) + r where r < 2^bits
        shifted = gate.add_const(gate.sub(a, b), 1 << bits)
        r_val = (va - vb + (1 << bits)) - (1 << bits) * (1 - lt)
        r_cell = ctx.push(r_val)
        self.range_check(r_cell, bits)
        one = ctx.constant(1)
        not_out = gate.sub(one, out)
        recon = gate.mul_add(not_out, ctx.constant(1 << bits), r_cell)
        gate.assert_equal(recon, shifted)
        return out

    def is_zero(self, a: int) -> int:
        return self.gate.is_zero(a)
