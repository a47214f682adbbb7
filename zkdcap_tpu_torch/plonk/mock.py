"""MockProver: constraint satisfiability checker (no commitments).

Port of ``zkdcap_tpu/plonk/mock.py`` (halo2's MockProver, the reference's
only "simulator", `circuits/src/sgx_dcap_verifier.rs:790-794`): evaluates
every gate poly on every row with the port's ``Evaluator`` on the given
device (the card unless ``device`` names another), checks lookups by
multiset membership and copy constraints by value equality on the host, and
reports the first failures with row/constraint coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve
from ..fields import BN254_FR, mont
from ..fields.params import NUM_LIMBS
from ..interop import to_numpy
from .cs import ConstraintSystem
from .expression import Evaluator

R = BN254_FR.p


@dataclasses.dataclass
class Failure:
    kind: str
    detail: str

    def __repr__(self):
        return f"[{self.kind}] {self.detail}"


def _poly_queries(poly):
    """(kind, column, rotation) cells a gate poly reads, in walk order
    (halo2 FailureLocation analog — names the cells behind a failure)."""
    from .expression import (
        Advice,
        Fixed,
        Instance,
        Negated,
        Product,
        Scaled,
        Sum,
    )

    out: list[tuple[str, int, int]] = []

    def walk(e):
        if isinstance(e, Advice):
            item = ("advice", e.index, e.rotation)
        elif isinstance(e, Fixed):
            item = ("fixed", e.index, e.rotation)
        elif isinstance(e, Instance):
            item = ("instance", e.index, e.rotation)
        elif isinstance(e, (Negated, Scaled)):
            return walk(e.inner)
        elif isinstance(e, (Sum, Product)):
            walk(e.a)
            return walk(e.b)
        else:
            return
        if item not in out:
            out.append(item)

    walk(poly)
    return out


class MockProver:
    def __init__(
        self,
        k: int,
        cs: ConstraintSystem,
        fixed: list[list[int]],
        advice: list[list[int]],
        instance: list[list[int]] | None = None,
        device=None,
    ):
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.device = resolve(device)
        pad = lambda col: list(col) + [0] * (self.n - len(col))
        self.fixed = [pad(c) for c in fixed]
        self.advice = [pad(c) for c in advice]
        self.instance = [pad(c) for c in (instance or [[]] * cs.num_instance)]

    def verify(self, max_failures: int = 10) -> list[Failure]:
        failures: list[Failure] = []
        n = self.n
        u = self.cs.usable_rows(n)
        enc = lambda cols: [mont.encode_ints(BN254_FR, c, device=self.device) for c in cols]
        ev = Evaluator(enc(self.fixed), enc(self.advice), enc(self.instance))

        def std(e) -> np.ndarray:
            return to_numpy(mont.from_mont(BN254_FR, ev.eval(e)))

        cols = {"fixed": self.fixed, "advice": self.advice, "instance": self.instance}
        for g in self.cs.gates:
            for pi, poly in enumerate(g.polys):
                vals = std(poly)
                bad = np.nonzero(vals.any(axis=-1))[0]
                for row in bad[:max_failures]:
                    # halo2-style localisation: name every cell the gate
                    # poly reads at the failing row, with its value
                    cells = ", ".join(
                        f"{self.cs.column_name(kind, ci)}"
                        f"@{(int(row) + rot) % self.n}"
                        f"={hex(cols[kind][ci][(int(row) + rot) % self.n])}"
                        for kind, ci, rot in _poly_queries(poly)
                    )
                    failures.append(
                        Failure(
                            "gate",
                            f"{g.name}[{pi}] not satisfied at row {row}"
                            + (f" ({cells})" if cells else ""),
                        )
                    )
                if len(failures) >= max_failures:
                    return failures

        for lk in self.cs.lookups:
            # Vectorized multiset membership: canonical standard-form limbs
            # (mont_mul ends with a conditional subtract, so equal field
            # elements have identical limb bytes), rows viewed as opaque
            # byte records, np.isin in C — no per-row Python loop.
            inp_std = np.concatenate([std(e) for e in lk.inputs], axis=-1)[:u]
            tab_std = np.concatenate([std(e) for e in lk.tables], axis=-1)[:u]
            rec = np.dtype((np.void, inp_std.dtype.itemsize * inp_std.shape[1]))
            inp_v = np.ascontiguousarray(inp_std).view(rec).ravel()
            tab_v = np.ascontiguousarray(tab_std).view(rec).ravel()
            bad = np.nonzero(~np.isin(inp_v, tab_v))[0]
            for row in bad[:max_failures]:
                tup = tuple(
                    int.from_bytes(
                        inp_std[row, a * NUM_LIMBS : (a + 1) * NUM_LIMBS]
                        .astype(np.uint16)
                        .tobytes(),
                        "little",
                    )
                    for a in range(len(lk.inputs))
                )
                failures.append(
                    Failure("lookup", f"{lk.name}: row {row} input {tup} not in table")
                )
            if len(failures) >= max_failures:
                return failures

        for (ca, ra), (cb, rb) in self.cs.copies:
            va = cols[ca.kind][ca.index][ra]
            vb = cols[cb.kind][cb.index][rb]
            if va % R != vb % R:
                failures.append(
                    Failure(
                        "copy",
                        f"({self.cs.column_name(ca.kind, ca.index)},{ra})={va}"
                        f" != ({self.cs.column_name(cb.kind, cb.index)},{rb})={vb}",
                    )
                )
                if len(failures) >= max_failures:
                    return failures
        return failures

    def assert_satisfied(self):
        failures = self.verify()
        assert not failures, f"{len(failures)}+ failures: {failures[:5]}"
