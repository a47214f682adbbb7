"""Non-native big-integer field chip — halo2-ecc `FpConfig`/CRT equivalent.

A copy of ``zkdcap_tpu/chips/bigint.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Reference semantics (SURVEY.md §2.2 D-ECC2/4): a foreign-field element is a
`CRTInteger` of NUM_LIMBS=3 limbs of LIMB_BITS=88 bits plus a native (mod r)
residue — the layout the reference pins (`crates/p256-ecdsa/src/circuit.rs:26-27`,
`lib.rs:80-81`), so public-instance encodings match.

Like halo2-ecc, arithmetic is LAZY: add/sub/neg/scale are pure limb gates
(no reduction; limb values may go negative), and only multiplication /
explicit reduction enforces the integer identity

    a*b + slack*p_t - q*p_t - out = 0

via the truncated-CRT argument (check_carry_mod_to_zero equivalent): checked
(1) mod 2^352 by a 4-column carry chain with range-checked signed carries
and (2) mod r by one native-residue gate; CRT capacity 2^352 * r / 2 ≈ 2^605
dominates every magnitude the tracked bounds allow.

Determinism: all bounds (limb bound, value interval) are STRUCTURAL —
propagated from the circuit's shape, never from witness values — so the
recorded trace (and hence the layout/pinning, SURVEY.md §5.4) is identical
for every witness. Structural bounds decide when lazy values are
auto-reduced and how constant p-multiples are added to keep quotients
non-negative.

Outputs of mul/reduce are range-limited to 88/88/top bits (< 2^256) but not
canonical; equality predicates use `assert_congruent` / `reduce_canonical`
(halo2-ecc's CrtUint vs ProperCrtUint distinction).
"""

from __future__ import annotations

import dataclasses

from ..fields import BN254_FR
from .context import Context, FlexGate
from .range import RangeChip

R = BN254_FR.p
LIMB_BITS = 88
NUM_LIMBS = 3
LIMB_BASE = 1 << LIMB_BITS
LIMB_MASK = LIMB_BASE - 1
CARRY_SHIFT = 1 << 102  # signed carries |v| < 2^102 -> shifted into [0, 2^103)
CARRY_BITS = 103
# bound on |t_k + v_{k-1}| so that v_k = (t_k + v_{k-1}) / 2^88 fits the range
T_BOUND = 1 << (CARRY_BITS - 1 + LIMB_BITS)
CRT_CAPACITY = ((1 << 352) * R) // 2
Q_MAX = 1 << (2 * LIMB_BITS + LIMB_BITS)  # q range-checked below 2^264


def _split(v: int) -> list[int]:
    assert v >= 0
    return [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)]


@dataclasses.dataclass
class CRTInt:
    limbs: list[int]  # cell handles
    native: int  # cell handle
    value: int  # exact tracked integer (lazy: may be negative / >= p)
    limb_vals: list[int]  # exact per-limb integers (signed)
    limb_bound: int  # structural bound on |limb_vals[i]|
    vmin: int  # structural value interval
    vmax: int

    @property
    def is_tight(self) -> bool:
        return self.limb_bound <= LIMB_MASK and self.vmin >= 0


class BigIntChip:
    def __init__(self, range_chip: RangeChip, p_target: int):
        self.rc = range_chip
        self.gate = range_chip.gate
        self.ctx = range_chip.ctx
        self.p = p_target
        assert p_target < 1 << 256
        self.p_limbs = _split(p_target)
        self.top_bits = max(p_target.bit_length() - 2 * LIMB_BITS, 1)
        self.load_max = (1 << (2 * LIMB_BITS + self.top_bits)) - 1

    # --- loading ----------------------------------------------------------

    def _native_of(self, limb_cells: list[int]) -> int:
        return self.gate.inner_product_const(
            limb_cells, [pow(2, LIMB_BITS * i, R) for i in range(NUM_LIMBS)]
        )

    def _load_range_checked(self, value: int) -> CRTInt:
        assert 0 <= value <= self.load_max
        limbs_v = _split(value)
        cells = [self.ctx.push(v) for v in limbs_v]
        self.rc.range_check(cells[0], LIMB_BITS)
        self.rc.range_check(cells[1], LIMB_BITS)
        self.rc.range_check(cells[2], self.top_bits)
        native = self._native_of(cells)
        return CRTInt(cells, native, value, limbs_v, LIMB_MASK, 0, self.load_max)

    def load_private(self, value: int) -> CRTInt:
        """Load a witness < 2^256-ish (NOT canonical; see reduce_canonical)."""
        return self._load_range_checked(value % self.p)

    def load_constant(self, value: int) -> CRTInt:
        value %= self.p
        limbs_v = _split(value)
        cells = [self.ctx.constant(v) for v in limbs_v]
        native = self.ctx.constant(value % R)
        return CRTInt(cells, native, value, limbs_v, LIMB_MASK, value, value)

    def from_limbs(self, limb_cells: list[int], value: int) -> CRTInt:
        """Wrap limb cells already range-checked by the caller (88/88/top)."""
        native = self._native_of(limb_cells)
        return CRTInt(limb_cells, native, value, _split(value), LIMB_MASK, 0, self.load_max)

    # --- lazy linear ops ---------------------------------------------------

    def add(self, a: CRTInt, b: CRTInt) -> CRTInt:
        g = self.gate
        limbs = [g.add(x, y) for x, y in zip(a.limbs, b.limbs)]
        native = g.add(a.native, b.native)
        lv = [x + y for x, y in zip(a.limb_vals, b.limb_vals)]
        return CRTInt(
            limbs, native, a.value + b.value, lv,
            a.limb_bound + b.limb_bound, a.vmin + b.vmin, a.vmax + b.vmax,
        )

    def sub(self, a: CRTInt, b: CRTInt) -> CRTInt:
        g = self.gate
        limbs = [g.sub(x, y) for x, y in zip(a.limbs, b.limbs)]
        native = g.sub(a.native, b.native)
        lv = [x - y for x, y in zip(a.limb_vals, b.limb_vals)]
        return CRTInt(
            limbs, native, a.value - b.value, lv,
            a.limb_bound + b.limb_bound, a.vmin - b.vmax, a.vmax - b.vmin,
        )

    def neg(self, a: CRTInt) -> CRTInt:
        g = self.gate
        limbs = [g.neg(x) for x in a.limbs]
        native = g.neg(a.native)
        return CRTInt(
            limbs, native, -a.value, [-x for x in a.limb_vals],
            a.limb_bound, -a.vmax, -a.vmin,
        )

    def scale(self, a: CRTInt, k: int) -> CRTInt:
        g = self.gate
        assert 0 <= k < 1 << 10
        limbs = [g.mul_const(x, k) for x in a.limbs]
        native = g.mul_const(a.native, k)
        return CRTInt(
            limbs, native, a.value * k, [x * k for x in a.limb_vals],
            a.limb_bound * k, a.vmin * k, a.vmax * k,
        )

    def _add_const_p(self, a: CRTInt, k: int) -> CRTInt:
        """a + k*p as constants folded into the limbs (keeps value >= 0)."""
        if k == 0:
            return a
        g = self.gate
        kp = k * self.p
        # low limbs masked; the top limb absorbs any overflow beyond 2^264
        kp_limbs = [(kp >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS - 1)]
        kp_limbs.append(kp >> (LIMB_BITS * (NUM_LIMBS - 1)))
        limbs = [g.add_const(x, c) for x, c in zip(a.limbs, kp_limbs)]
        native = g.add_const(a.native, kp % R)
        lv = [x + c for x, c in zip(a.limb_vals, kp_limbs)]
        return CRTInt(
            limbs, native, a.value + kp, lv,
            a.limb_bound + max(kp_limbs), a.vmin + kp, a.vmax + kp,
        )

    # --- carry-chain core ---------------------------------------------------

    def _carry_chain(self, t_cells: list[int], t_ints: list[int]) -> None:
        g = self.gate
        v_prev_cell = None
        v_prev_int = 0
        for k in range(len(t_cells)):
            tot_int = t_ints[k] + v_prev_int
            assert tot_int % LIMB_BASE == 0, "carry chain misaligned"
            v_int = tot_int // LIMB_BASE
            v_cell = self.ctx.push(v_int % R)
            shifted = g.add_const(v_cell, CARRY_SHIFT)
            assert 0 <= v_int + CARRY_SHIFT < (1 << CARRY_BITS), "carry out of range"
            self.rc.range_check(shifted, CARRY_BITS)
            lhs = t_cells[k] if v_prev_cell is None else g.add(t_cells[k], v_prev_cell)
            rhs = g.mul_const(v_cell, LIMB_BASE % R)
            g.assert_equal(lhs, rhs)
            v_prev_cell = v_cell
            v_prev_int = v_int

    # --- multiplication / reduction -----------------------------------------

    def _maybe_tighten_for_mul(self, a: CRTInt, b: CRTInt, out_lb: int):
        def limb_budget(x, y):
            return (
                3 * x.limb_bound * y.limb_bound
                + 3 * LIMB_MASK * max(self.p_limbs)
                + out_lb
                + CARRY_SHIFT
            )

        def eff(x):
            # value magnitude after the non-negativity offset
            return x.vmax - min(x.vmin, 0) + self.p

        while limb_budget(a, b) >= T_BOUND or eff(a) * eff(b) >= (Q_MAX // 4) * self.p:
            if a.limb_bound * eff(a) >= b.limb_bound * eff(b):
                a = self.reduce(a)
            else:
                b = self.reduce(b)
        return a, b

    def mul_constrain(self, a: CRTInt, b: CRTInt, out: CRTInt) -> None:
        """Constrain a*b ≡ out (mod p_target)."""
        g = self.gate
        a, b = self._maybe_tighten_for_mul(a, b, out.limb_bound)
        a = self._add_const_p(a, max(0, -(a.vmin // self.p)))
        b = self._add_const_p(b, max(0, -(b.vmin // self.p)))
        slack = max(0, (out.vmax + self.p - 1) // self.p)

        prod = a.value * b.value + slack * self.p
        q_val, rem = divmod(prod - out.value, self.p)
        assert rem == 0, "mul witness inconsistent"
        assert 0 <= q_val, "negative quotient"
        # structural completeness bound: worst-case q must fit the range check
        assert (a.vmax * b.vmax + slack * self.p) // self.p < Q_MAX, "q overflow"
        q = self._load_range_checked_wide(q_val)

        slack_p = slack * self.p
        slack_limbs = [(slack_p >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NUM_LIMBS)]
        slack_limbs[NUM_LIMBS - 1] = slack_p >> (LIMB_BITS * (NUM_LIMBS - 1))

        t_cells = []
        t_ints = []
        for k in range(NUM_LIMBS + 1):  # columns 0..3 -> identity mod 2^352
            terms = None
            t_int = 0
            for i in range(k + 1):
                j = k - i
                if i < NUM_LIMBS and j < NUM_LIMBS:
                    m = g.mul(a.limbs[i], b.limbs[j])
                    terms = m if terms is None else g.add(terms, m)
                    t_int += a.limb_vals[i] * b.limb_vals[j]
                    qp = g.mul_const(q.limbs[i], self.p_limbs[j])
                    terms = g.sub(terms, qp)
                    t_int -= q.limb_vals[i] * self.p_limbs[j]
            if k < NUM_LIMBS:
                terms = g.sub(terms, out.limbs[k])
                t_int -= out.limb_vals[k]
                if slack_limbs[k]:
                    terms = g.add_const(terms, slack_limbs[k])
                    t_int += slack_limbs[k]
            t_cells.append(terms)
            t_ints.append(t_int)
        self._carry_chain(t_cells, t_ints)

        # native residue
        ab = g.mul(a.native, b.native)
        qp = g.mul_const(q.native, self.p % R)
        lhs = g.sub(ab, qp)
        if slack_p % R:
            lhs = g.add_const(lhs, slack_p % R)
        g.assert_equal(lhs, out.native)

    def _load_range_checked_wide(self, value: int) -> CRTInt:
        """Like _load_range_checked but full 88 bits on the top limb (for q)."""
        assert 0 <= value < Q_MAX
        limbs_v = _split(value)
        cells = [self.ctx.push(v) for v in limbs_v]
        for c in cells:
            self.rc.range_check(c, LIMB_BITS)
        native = self._native_of(cells)
        return CRTInt(cells, native, value, limbs_v, LIMB_MASK, 0, Q_MAX - 1)

    def mul(self, a: CRTInt, b: CRTInt) -> CRTInt:
        out = self._load_range_checked(a.value % self.p * (b.value % self.p) % self.p)
        self.mul_constrain(a, b, out)
        return out

    def div(self, a: CRTInt, b: CRTInt) -> CRTInt:
        """c with b*c ≡ a (mod p). Admits b ≡ 0 when a ≡ 0; see div_strict."""
        b_red = b.value % self.p
        assert b_red != 0, "division by zero"
        c_val = a.value % self.p * pow(b_red, -1, self.p) % self.p
        c = self._load_range_checked(c_val)
        self.mul_constrain(b, c, a)
        return c

    def div_strict(self, a: CRTInt, b: CRTInt) -> CRTInt:
        """c = a/b with b constrained nonzero via a b*b^-1 = 1 witness."""
        c = self.div(a, b)
        u = self._load_range_checked(pow(b.value % self.p, -1, self.p))
        self.mul_constrain(b, u, self.load_constant(1))
        return c

    def inv(self, a: CRTInt) -> CRTInt:
        return self.div(self.load_constant(1), a)  # b*c = 1 forces a nonzero

    def reduce(self, a: CRTInt) -> CRTInt:
        """Re-express a lazy value with tight (88/88/top) limbs (mod p)."""
        out = self._load_range_checked(a.value % self.p)
        self.assert_congruent(a, out)
        return out

    def assert_congruent(self, a: CRTInt, b: CRTInt) -> None:
        """Constrain a ≡ b (mod p) for lazy values: a - b = q*p, small q."""
        g = self.gate
        diff = a.value - b.value
        assert diff % self.p == 0, "congruence witness inconsistent"
        q_val = diff // self.p
        q_abs_max = (max(abs(a.vmin - b.vmax), abs(a.vmax - b.vmin))) // self.p + 1
        assert q_abs_max < 1 << 40, "congruence quotient bound too large"
        q_cell = self.ctx.push(q_val % R)
        q_shift = g.add_const(q_cell, 1 << 40)
        self.rc.range_check(q_shift, 41)

        t_cells = []
        t_ints = []
        for k in range(NUM_LIMBS):
            term = g.sub(a.limbs[k], b.limbs[k])
            qp = g.mul_const(q_cell, self.p_limbs[k])
            term = g.sub(term, qp)
            t_cells.append(term)
            t_ints.append(a.limb_vals[k] - b.limb_vals[k] - q_val * self.p_limbs[k])
        self._carry_chain(t_cells, t_ints)
        nat = g.sub(g.sub(a.native, b.native), g.mul_const(q_cell, self.p % R))
        g.assert_const(nat, 0)

    def reduce_canonical(self, a: CRTInt) -> CRTInt:
        """Tight limbs AND value < p (big_less_than against p)."""
        out = a if (a.is_tight and 0 <= a.value < self.p) else self.reduce(a)
        if out.value >= self.p:  # reduce() already mods; defensive
            out = self.reduce(out)
        self._check_lt_p(out)
        return CRTInt(
            out.limbs, out.native, out.value, out.limb_vals, LIMB_MASK, 0, self.p - 1
        )

    def _check_lt_p(self, a: CRTInt) -> None:
        """Constrain a.value < p via witness d: a + d = p - 1 limbwise."""
        assert a.is_tight and 0 <= a.value < self.p
        d_val = self.p - 1 - a.value
        d = self._load_range_checked(d_val)
        pm1 = _split(self.p - 1)
        g = self.gate
        carry_prev = None
        for k in range(NUM_LIMBS):
            lhs = g.add(a.limbs[k], d.limbs[k])
            lv = a.limb_vals[k] + d.limb_vals[k]
            if carry_prev is not None:
                lhs = g.add(lhs, carry_prev[0])
                lv += carry_prev[1]
            # (lv - pm1[k]) is 0 or LIMB_BASE; arithmetic (not a python
            # branch) so the hint stays traced for witness replay
            carry_bit = (lv - pm1[k]) // LIMB_BASE
            assert (lv - pm1[k]) % LIMB_BASE == 0, "lt_p carry broke"
            assert carry_bit * (carry_bit - 1) == 0, "lt_p carry broke"
            cb = self.ctx.push(carry_bit)
            g.assert_bit(cb)
            rhs = g.mul_const_add(cb, LIMB_BASE % R, g.constant(pm1[k]))
            g.assert_equal(lhs, rhs)
            carry_prev = (cb, carry_bit)
        g.assert_const(carry_prev[0], 0)

    # --- predicates / selection ---------------------------------------------

    def assert_equal(self, a: CRTInt, b: CRTInt) -> None:
        """Strict limb equality (same representative)."""
        for x, y_ in zip(a.limbs, b.limbs):
            self.gate.assert_equal(x, y_)

    def assert_zero(self, a: CRTInt) -> None:
        self.assert_congruent(a, self.load_constant(0))

    def is_zero(self, a: CRTInt) -> int:
        c = self.reduce_canonical(a)
        g = self.gate
        z = [g.is_zero(l) for l in c.limbs]
        return g.and_(g.and_(z[0], z[1]), z[2])

    def assert_nonzero(self, a: CRTInt) -> None:
        self.gate.assert_const(self.is_zero(a), 0)

    def is_equal(self, a: CRTInt, b: CRTInt) -> int:
        return self.is_zero(self.sub(a, b))

    def select(self, a: CRTInt, b: CRTInt, sel: int) -> CRTInt:
        """sel ? a : b."""
        g = self.gate
        limbs = [g.select(x, y_, sel) for x, y_ in zip(a.limbs, b.limbs)]
        native = g.select(a.native, b.native, sel)
        # traced arithmetic select (witness replay): sel's shadow value is
        # 0/1, so sv*(x-y)+y keeps the dataflow on the DAG instead of
        # baking this input's branch
        from ..witness.tracer import t_sel

        sv = self.ctx.value(sel)
        val = t_sel(sv, a.value, b.value)
        lv = [t_sel(sv, x, y_) for x, y_ in zip(a.limb_vals, b.limb_vals)]
        return CRTInt(
            limbs, native, val, list(lv),
            max(a.limb_bound, b.limb_bound), min(a.vmin, b.vmin), max(a.vmax, b.vmax),
        )
