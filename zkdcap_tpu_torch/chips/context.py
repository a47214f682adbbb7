"""Gate eDSL context — halo2-base `Context` + FlexGate equivalent.

A copy of ``zkdcap_tpu/chips/context.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Reference semantics (SURVEY.md §2.2 D-BASE2/D-BASE4): circuits are Python
programs that push witness cells onto a flat tape while recording the
constraint structure. The single "vertical" custom gate is

    q[i] * (a[i] + a[i+1] * a[i+2] - a[i+3]) = 0

so every arithmetic instruction lowers to a 4-cell window [a, b, c, a+b*c]
plus copy constraints, exactly like halo2-base's FlexGateConfig
(`crates/p256-ecdsa/src/circuit.rs:29,54` uses the same ops via GateChip).

The recorded trace is deterministic: running the same circuit function
twice yields the same structure (gate offsets, copies, constants), which is
what makes the keygen layout / prover witness split ("pinning",
`params/pinning.json` in the reference, SURVEY.md §5.4) sound.
"""

from __future__ import annotations

from ..fields import BN254_FR
from ..witness.tracer import TInt

R = BN254_FR.p


class Context:
    def __init__(self, tracer=None):
        # Optional witness-dataflow tracer (witness/tracer.py): when set,
        # input-derived cell values are TInt proxies and every push binds
        # the cell to a DAG node, enabling compiled witness replay.
        self.tracer = tracer
        self.cells: list[int] = []  # witness values (TInt while recording)
        self.gate_offsets: list[int] = []  # tape indices where q = 1
        self.copies: list[tuple[int, int]] = []  # cell equality constraints
        self.constant_cells: list[tuple[int, int]] = []  # (cell, constant value)
        self.lookup_cells: list[int] = []  # cells to range-lookup (builder-wide bits)
        self.spread_pairs: list[tuple[int, int]] = []  # (dense, spread) 11-bit pairs
        # generic custom pair-lookup tables: name -> table rows [(a, b)]
        self.pair_tables: dict[str, list[tuple[int, int]]] = {}
        # name -> [(cellA, cellB)] pairs constrained to be table rows
        self.pair_lookups: dict[str, list[tuple[int, int]]] = {}
        self.instance_cells: list[int] = []  # cells exposed as public inputs

    def register_pair_table(self, name: str, rows: list[tuple[int, int]]) -> None:
        if name in self.pair_tables:
            assert self.pair_tables[name] == rows
            return
        self.pair_tables[name] = rows
        self.pair_lookups[name] = []

    def pair_lookup(self, name: str, a: int, b: int) -> None:
        self.pair_lookups[name].append((a, b))

    # --- tape primitives -------------------------------------------------

    def push(self, value: int) -> int:
        idx = len(self.cells)
        if isinstance(value, TInt):
            # keep the traced proxy so downstream shadow arithmetic stays
            # on the DAG; skip the mod node when already reduced
            self.cells.append(value if 0 <= value.v < R else value % R)
        else:
            self.cells.append(value % R)
        return idx

    def enable_gate(self, offset: int) -> None:
        self.gate_offsets.append(offset)

    def copy(self, a: int, b: int) -> None:
        assert self.cells[a] == self.cells[b], (
            f"copy of unequal cells {a}={self.cells[a]} {b}={self.cells[b]}"
        )
        self.copies.append((a, b))

    def constant(self, value: int) -> int:
        """Push a cell pinned to a constant (via copy to the const column)."""
        assert not isinstance(value, TInt), "fixed-column constant can't be traced"
        idx = self.push(value)
        self.constant_cells.append((idx, value % R))
        return idx

    def expose_public(self, cell: int) -> None:
        self.instance_cells.append(cell)

    def value(self, cell: int) -> int:
        return self.cells[cell]


import dataclasses


@dataclasses.dataclass(frozen=True)
class E:
    """Window entry referencing an existing cell (copied in)."""

    cell: int


@dataclasses.dataclass(frozen=True)
class C:
    """Window entry pinned to a constant."""

    value: int


@dataclasses.dataclass(frozen=True)
class W:
    """Fresh witness window entry."""

    value: int


class FlexGate:
    """Arithmetic instructions lowering to the vertical gate.

    Cell handles are plain ints (tape indices). Every method returns the
    handle of its result cell. Windows are assembled from QuantumCell-style
    entries (halo2-base's Existing/Constant/Witness) so constants are
    pinned in place rather than materialised then copied.
    """

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def assemble(self, entries, result_slot: int = 3) -> int:
        """Push a 4-entry window [a, b, c, d] with gate a + b*c = d enabled.

        Returns the cell index of `result_slot`. Callers guarantee the
        values satisfy the gate.
        """
        ctx = self.ctx
        base = len(ctx.cells)
        for ent in entries:
            if isinstance(ent, E):
                idx = ctx.push(ctx.value(ent.cell))
                ctx.copy(idx, ent.cell)
            elif isinstance(ent, C):
                ctx.constant(ent.value)
            else:
                ctx.push(ent.value)
        ctx.enable_gate(base)
        return base + result_slot

    def witness(self, value: int) -> int:
        return self.ctx.push(value)

    def constant(self, value: int) -> int:
        return self.ctx.constant(value)

    def add(self, a: int, b: int) -> int:
        va, vb = self.ctx.value(a), self.ctx.value(b)
        return self.assemble([E(a), E(b), C(1), W((va + vb) % R)])

    def sub(self, a: int, b: int) -> int:
        """out = a - b via out + b*1 = a (result in slot 0)."""
        va, vb = self.ctx.value(a), self.ctx.value(b)
        return self.assemble([W((va - vb) % R), E(b), C(1), E(a)], result_slot=0)

    def neg(self, a: int) -> int:
        va = self.ctx.value(a)
        return self.assemble([W((-va) % R), E(a), C(1), C(0)], result_slot=0)

    def mul(self, a: int, b: int) -> int:
        va, vb = self.ctx.value(a), self.ctx.value(b)
        return self.assemble([C(0), E(a), E(b), W(va * vb % R)])

    def mul_add(self, a: int, b: int, c: int) -> int:
        """out = c + a*b."""
        va, vb, vc = self.ctx.value(a), self.ctx.value(b), self.ctx.value(c)
        return self.assemble([E(c), E(a), E(b), W((vc + va * vb) % R)])

    def mul_const(self, a: int, k: int) -> int:
        va = self.ctx.value(a)
        return self.assemble([C(0), E(a), C(k % R), W(va * k % R)])

    def add_const(self, a: int, k: int) -> int:
        va = self.ctx.value(a)
        return self.assemble([E(a), C(k % R), C(1), W((va + k) % R)])

    def mul_const_add(self, a: int, k: int, c: int) -> int:
        """out = c + k*a."""
        va, vc = self.ctx.value(a), self.ctx.value(c)
        return self.assemble([E(c), E(a), C(k % R), W((vc + va * k) % R)])

    def inner_product(self, a: list[int], b: list[int]) -> int:
        assert len(a) == len(b) and a
        acc = self.mul(a[0], b[0])
        for x, y_ in zip(a[1:], b[1:]):
            acc = self.mul_add(x, y_, acc)
        return acc

    def inner_product_const(self, a: list[int], consts: list[int]) -> int:
        assert a
        acc = self.mul_const(a[0], consts[0])
        for x, k in zip(a[1:], consts[1:]):
            acc = self.mul_const_add(x, k, acc)
        return acc

    def sum_(self, xs: list[int]) -> int:
        acc = xs[0]
        for x in xs[1:]:
            acc = self.add(acc, x)
        return acc

    def select(self, a: int, b: int, sel: int) -> int:
        """sel ? a : b (sel must be boolean-constrained)."""
        d = self.sub(a, b)
        return self.mul_add(sel, d, b)

    def assert_bit(self, a: int) -> None:
        """a * (a - 1) = 0 via a + a*am1... lower: am1 = a-1; prod = a*am1; prod == 0."""
        am1 = self.add_const(a, R - 1)
        prod = self.mul(a, am1)
        self.assert_zero(prod)

    def assert_zero(self, a: int) -> None:
        zero = self.ctx.constant(0)
        self.ctx.copy(a, zero)

    def assert_equal(self, a: int, b: int) -> None:
        self.ctx.copy(a, b)

    def assert_const(self, a: int, k: int) -> None:
        kc = self.ctx.constant(k)
        self.ctx.copy(a, kc)

    def is_zero(self, a: int) -> int:
        """Returns boolean cell: 1 if a == 0 else 0 (standard inverse trick)."""
        ctx = self.ctx
        va = ctx.value(a)
        # (va == 0) is bool for plain ints and a traced 0/1 TBool node for
        # TInt — either way va + (va == 0) is nonzero and invertible, and
        # the whole hint stays on the dataflow DAG for witness replay.
        inv = ctx.push(pow(va + (va == 0), -1, R))
        # out = 1 - a * inv ; a * out = 0
        prod = self.mul(a, inv)
        one = ctx.constant(1)
        out = self.sub(one, prod)
        chk = self.mul(a, out)
        self.assert_zero(chk)
        return out

    def is_equal(self, a: int, b: int) -> int:
        return self.is_zero(self.sub(a, b))

    def or_(self, a: int, b: int) -> int:
        """a + b - a*b for boolean cells."""
        ab = self.mul(a, b)
        s = self.add(a, b)
        return self.sub(s, ab)

    def and_(self, a: int, b: int) -> int:
        return self.mul(a, b)

    def not_(self, a: int) -> int:
        one = self.ctx.constant(1)
        return self.sub(one, a)
