"""PLONKish constraint system (halo2 `ConstraintSystem` equivalent).

A copy of ``zkdcap_tpu/plonk/cs.py`` over the port's expression IR.

Columns, custom gates, lookup arguments, and the global copy-constraint
permutation — the circuit IR that keygen/prover/verifier consume
(SURVEY.md §2.2 D-PROOF2: "circuit IR with columns/rotations/gates/lookups/
permutations"). Pure metadata; all values live elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from .expression import Advice, Expression, Fixed, Instance

ColumnKind = Literal["fixed", "advice", "instance"]


@dataclasses.dataclass(frozen=True, order=True)
class Column:
    kind: str
    index: int

    def query(self, rotation: int = 0) -> Expression:
        if self.kind == "fixed":
            return Fixed(self.index, rotation)
        if self.kind == "advice":
            return Advice(self.index, rotation)
        return Instance(self.index, rotation)


@dataclasses.dataclass
class Gate:
    name: str
    polys: list[Expression]


@dataclasses.dataclass
class Lookup:
    name: str
    inputs: list[Expression]
    tables: list[Expression]


class ConstraintSystem:
    def __init__(self):
        self.num_fixed = 0
        self.num_advice = 0
        self.num_instance = 0
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        # columns participating in the copy-constraint permutation, in order
        self.permutation_columns: list[Column] = []
        self._equality: set[Column] = set()  # the same columns, for membership
        # copy constraints: ((col_a, row_a), (col_b, row_b))
        self.copies: list[tuple[tuple[Column, int], tuple[Column, int]]] = []
        # cosmetic column names for failure localisation (halo2's
        # `annotate_column`); NOT part of canonical_bytes — two circuits
        # differing only in annotations share a vk
        self.annotations: dict[tuple[str, int], str] = {}

    # --- layout -------------------------------------------------------------

    def fixed_column(self) -> Column:
        c = Column("fixed", self.num_fixed)
        self.num_fixed += 1
        return c

    def advice_column(self) -> Column:
        c = Column("advice", self.num_advice)
        self.num_advice += 1
        return c

    def instance_column(self) -> Column:
        c = Column("instance", self.num_instance)
        self.num_instance += 1
        return c

    def enable_equality(self, col: Column) -> None:
        if col not in self._equality:
            self._equality.add(col)
            self.permutation_columns.append(col)

    def annotate_column(self, col: Column, name: str) -> None:
        """Attach a human-readable name to a column (halo2
        `ConstraintSystem::annotate_lookup_column` analog). Used only by
        MockProver failure messages; never serialized into the vk."""
        self.annotations[(col.kind, col.index)] = name

    def column_name(self, kind: str, index: int) -> str:
        """`advice[3]` or `advice[3]('a.limb0')` when annotated."""
        base = f"{kind}[{index}]"
        ann = self.annotations.get((kind, index))
        return f"{base}({ann!r})" if ann else base

    # --- constraints --------------------------------------------------------

    def create_gate(self, name: str, polys) -> None:
        if isinstance(polys, Expression):
            polys = [polys]
        self.gates.append(Gate(name, list(polys)))

    def add_lookup(self, name: str, inputs, tables) -> None:
        assert len(inputs) == len(tables)
        self.lookups.append(Lookup(name, list(inputs), list(tables)))

    def copy(self, a: tuple[Column, int], b: tuple[Column, int]) -> None:
        self.enable_equality(a[0])
        self.enable_equality(b[0])
        self.copies.append((a, b))

    def canonical_bytes(self) -> bytes:
        """Canonical serialization of the full constraint system — hashed
        into the vk transcript repr so two circuits differing in any gate
        polynomial, lookup, query rotation, permutation column or column
        count get distinct reprs (halo2 pinned-vk analog; ADVICE round-1)."""
        from .expression import expr_bytes

        out = bytearray()
        for v in (self.num_fixed, self.num_advice, self.num_instance,
                  self.blinding_factors):
            out += v.to_bytes(4, "little")
        out += len(self.gates).to_bytes(4, "little")
        for g in self.gates:
            nm = g.name.encode()
            out += len(nm).to_bytes(2, "little") + nm
            out += len(g.polys).to_bytes(4, "little")
            for p in g.polys:
                b = expr_bytes(p)
                out += len(b).to_bytes(4, "little") + b
        out += len(self.lookups).to_bytes(4, "little")
        for lk in self.lookups:
            nm = lk.name.encode()
            out += len(nm).to_bytes(2, "little") + nm
            out += len(lk.inputs).to_bytes(4, "little")
            for e in lk.inputs + lk.tables:
                b = expr_bytes(e)
                out += len(b).to_bytes(4, "little") + b
        out += len(self.permutation_columns).to_bytes(4, "little")
        for col in self.permutation_columns:
            out += col.kind.encode()[:1] + col.index.to_bytes(4, "little")
        return bytes(out)

    # --- degrees / domain sizing -------------------------------------------

    @property
    def permutation_chunk_len(self) -> int:
        return max(self.degree_without_permutation() - 2, 1)

    def degree_without_permutation(self) -> int:
        d = 3  # floor: lookup grand-product constraint has degree >= 3
        for g in self.gates:
            for p in g.polys:
                d = max(d, p.degree())
        for lk in self.lookups:
            in_deg = max((e.degree() for e in lk.inputs), default=1)
            tb_deg = max((e.degree() for e in lk.tables), default=1)
            # (1 - (l_last+l_blind)) * (Z(wX)(A'+beta)(S'+gamma) - Z(X)(A+beta)(S+gamma))
            d = max(d, 2 + max(in_deg, 1) + max(tb_deg, 1) - 1, 4)
        return d

    def degree(self) -> int:
        d = self.degree_without_permutation()
        if self.permutation_columns:
            # (1-(l_last+l_blind)) * z(wX) * prod over chunk (col + b X + g)
            d = max(d, 2 + self.permutation_chunk_len)
        return d

    @property
    def blinding_factors(self) -> int:
        # rotations we ever use are in {-1, 0, 1}; 5 blind rows is
        # comfortably enough (halo2 computes this from queries)
        return 5

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors + 1)

    def quotient_pieces(self) -> int:
        return self.degree() - 1

    def extended_k(self, k: int) -> int:
        """Quotient degree < (cs.degree()-1)*n, so the extended domain needs
        ceil(log2(degree-1)) extra bits."""
        d = self.degree() - 1
        extra = (d - 1).bit_length()  # ceil(log2(d)) for d >= 1
        return k + max(extra, 1)
