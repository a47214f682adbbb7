"""Trace -> circuit compiler (halo2-base BaseCircuitBuilder equivalent).

A copy of ``zkdcap_tpu/chips/builder.py``, building the port's
``plonk.cs.ConstraintSystem``.

Lays a recorded `Context` tape out into PLONK columns:

  * main tape -> N advice columns of height <= usable rows, with per-column
    selector fixed columns and the vertical gate; column break points never
    split a 4-cell gate window. The break points + shape are the "pinning"
    (reference: `params/pinning.json` = (BaseCircuitParams,
    MultiPhaseThreadBreakPoints), `crates/p256-ecdsa/src/base.rs:156-164`,
    SURVEY.md §5.4) — keygen and prover must agree on them for the pk to
    stay valid.
  * range-lookup cells -> dedicated lookup-advice columns, every row of
    which is constrained by one lookup argument against the range table
    (halo2-base "vertical" RangeConfig, SURVEY.md §2.2 D-BASE2).
  * constants -> one fixed column with copy constraints.
  * public cells -> one instance column with copy constraints.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

from ..fields import BN254_FR
from ..plonk.cs import Column, ConstraintSystem
from .context import Context

R = BN254_FR.p


@dataclasses.dataclass
class Pinning:
    k: int
    lookup_bits: int
    num_advice: int
    num_lookup_advice: int
    break_points: list[int]  # tape index where each advice column ends
    num_cells: int
    num_lookup_cells: int
    num_instance: int
    num_spread_advice: int = 0  # column PAIRS for the 11-bit spread table
    num_spread_pairs: int = 0
    # custom pair tables: name -> [num_col_pairs, num_pairs]
    pair_table_meta: dict | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Pinning":
        return Pinning(**json.loads(s))


@dataclasses.dataclass
class CompiledCircuit:
    cs: ConstraintSystem
    fixed_values: list[list[int]]
    pinning: Pinning
    # mapping helpers for witness fill
    advice_of_cell: list[tuple[int, int]]  # cell -> (advice col, row)
    lookup_of_cell: list[tuple[int, int]]  # lookup slot -> (lookup col, row)


class CircuitBuilder:
    def __init__(self, k: int, lookup_bits: int | None = None):
        self.k = k
        self.lookup_bits = lookup_bits

    def compile(self, ctx: Context, pinning: Pinning | None = None) -> CompiledCircuit:
        k = self.k
        n = 1 << k
        cs = ConstraintSystem()
        u = cs.usable_rows(n)
        num_cells = len(ctx.cells)

        # --- break tape into advice columns -------------------------------
        gate_sorted = sorted(ctx.gate_offsets)
        breaks: list[int] = []
        start = 0
        while start < num_cells:
            end = min(start + u, num_cells)
            if end < num_cells:
                # shrink end until no gate window [g, g+3] crosses it
                while True:
                    i = bisect.bisect_left(gate_sorted, end)
                    crossing = False
                    j = i - 1
                    while j >= 0 and gate_sorted[j] > end - 4:
                        if gate_sorted[j] + 3 >= end:
                            crossing = True
                            break
                        j -= 1
                    if not crossing:
                        break
                    end -= 1
                    assert end > start, "cannot break tape without splitting a gate"
            breaks.append(end)
            start = end
        num_advice = len(breaks) if num_cells else 1
        if not breaks:
            breaks = [0]

        if pinning is not None:
            assert pinning.break_points == breaks, "pinning mismatch: break points"
            assert pinning.num_cells == num_cells, "pinning mismatch: cell count"

        advice_of_cell: list[tuple[int, int]] = [None] * num_cells
        col_start = 0
        for ci, end in enumerate(breaks):
            for cell in range(col_start, end):
                advice_of_cell[cell] = (ci, cell - col_start)
            col_start = end

        # --- lookup advice columns ----------------------------------------
        num_lookup_cells = len(ctx.lookup_cells)
        num_lookup_advice = (num_lookup_cells + u - 1) // u if num_lookup_cells else 0
        lookup_of_cell: list[tuple[int, int]] = []
        for i in range(num_lookup_cells):
            lookup_of_cell.append((i // u, i % u))

        # --- spread pair columns (11-bit dense/spread table) --------------
        num_spread_pairs = len(ctx.spread_pairs)
        num_spread_advice = (num_spread_pairs + u - 1) // u if num_spread_pairs else 0

        # --- generic custom pair tables (e.g. base64) ---------------------
        pair_names = sorted(ctx.pair_tables)
        pair_meta = {}
        for name in pair_names:
            cnt = len(ctx.pair_lookups[name])
            pair_meta[name] = [max((cnt + u - 1) // u, 1) if cnt else 0, cnt]

        # --- columns -------------------------------------------------------
        def named(make, name):
            c = make()
            cs.annotate_column(c, name)
            return c

        advice_cols = [
            named(cs.advice_column, f"flex.{i}") for i in range(num_advice)
        ]
        lookup_cols = [
            named(cs.advice_column, f"range.{i}")
            for i in range(num_lookup_advice)
        ]
        spread_cols = [
            (named(cs.advice_column, f"spread.dense.{i}"),
             named(cs.advice_column, f"spread.spread.{i}"))
            for i in range(num_spread_advice)
        ]
        selector_cols = [
            named(cs.fixed_column, f"q_flex.{i}") for i in range(num_advice)
        ]
        const_col = named(cs.fixed_column, "constants")
        table_col = (
            named(cs.fixed_column, "range_table")
            if self.lookup_bits is not None else None
        )
        if num_spread_advice:
            spread_tbl_dense = named(cs.fixed_column, "spread_table.dense")
            spread_tbl_spread = named(cs.fixed_column, "spread_table.spread")
        num_instance = 1 if ctx.instance_cells else 0
        inst_col = (
            named(cs.instance_column, "instances") if num_instance else None
        )

        # gates
        for ci in range(num_advice):
            a = advice_cols[ci]
            q = selector_cols[ci]
            cs.create_gate(
                f"flex{ci}",
                q.query() * (a.query(0) + a.query(1) * a.query(2) - a.query(3)),
            )
        # lookups
        if table_col is not None:
            for lc in lookup_cols:
                cs.add_lookup("range", [lc.query()], [table_col.query()])
        for dc, sc in spread_cols:
            cs.add_lookup(
                "spread",
                [dc.query(), sc.query()],
                [spread_tbl_dense.query(), spread_tbl_spread.query()],
            )
        pair_adv_cols = {}
        pair_tbl_cols = {}
        for name in pair_names:
            ncols = pair_meta[name][0]
            if ncols == 0:
                continue
            pair_tbl_cols[name] = (
                named(cs.fixed_column, f"{name}_table.a"),
                named(cs.fixed_column, f"{name}_table.b"),
            )
            pair_adv_cols[name] = [
                (named(cs.advice_column, f"{name}.a.{i}"),
                 named(cs.advice_column, f"{name}.b.{i}"))
                for i in range(ncols)
            ]
            ta, tb = pair_tbl_cols[name]
            for ca, cb in pair_adv_cols[name]:
                cs.add_lookup(name, [ca.query(), cb.query()], [ta.query(), tb.query()])

        # --- fixed values --------------------------------------------------
        selector_vals = [[0] * n for _ in range(num_advice)]
        for g in ctx.gate_offsets:
            ci, row = advice_of_cell[g]
            selector_vals[ci][row] = 1

        const_values: list[int] = []
        const_row: dict[int, int] = {}
        for _, v in ctx.constant_cells:
            if v not in const_row:
                const_row[v] = len(const_values)
                const_values.append(v)
        assert len(const_values) <= u, "too many distinct constants"
        const_col_vals = const_values + [0] * (n - len(const_values))

        fixed_values = selector_vals + [const_col_vals]
        if table_col is not None:
            tb = 1 << self.lookup_bits
            assert tb + cs.blinding_factors + 1 <= n, "lookup table larger than domain"
            fixed_values.append(list(range(tb)) + [0] * (n - tb))
        if num_spread_advice:
            from .sha256 import SPREAD_BITS, spread_int

            sn = 1 << SPREAD_BITS
            assert sn + cs.blinding_factors + 1 <= n, "spread table larger than domain"
            fixed_values.append(list(range(sn)) + [0] * (n - sn))
            fixed_values.append([spread_int(x) for x in range(sn)] + [0] * (n - sn))
        for name in pair_names:
            if pair_meta[name][0] == 0:
                continue
            rows = ctx.pair_tables[name]
            assert len(rows) + cs.blinding_factors + 1 <= n
            assert (0, 0) in rows, f"pair table {name} must contain (0,0) padding row"
            fixed_values.append([r[0] for r in rows] + [0] * (n - len(rows)))
            fixed_values.append([r[1] for r in rows] + [0] * (n - len(rows)))

        # --- copies --------------------------------------------------------
        def cell_pos(cell: int) -> tuple[Column, int]:
            ci, row = advice_of_cell[cell]
            return (advice_cols[ci], row)

        for a, b in ctx.copies:
            cs.copy(cell_pos(a), cell_pos(b))
        for cell, v in ctx.constant_cells:
            cs.copy(cell_pos(cell), (const_col, const_row[v]))
        for slot, cell in enumerate(ctx.lookup_cells):
            lci, lrow = lookup_of_cell[slot]
            cs.copy(cell_pos(cell), (lookup_cols[lci], lrow))
        for slot, (dcell, scell) in enumerate(ctx.spread_pairs):
            pci, prow = slot // u, slot % u
            cs.copy(cell_pos(dcell), (spread_cols[pci][0], prow))
            cs.copy(cell_pos(scell), (spread_cols[pci][1], prow))
        for name in pair_names:
            for slot, (ca, cb) in enumerate(ctx.pair_lookups[name]):
                pci, prow = slot // u, slot % u
                cs.copy(cell_pos(ca), (pair_adv_cols[name][pci][0], prow))
                cs.copy(cell_pos(cb), (pair_adv_cols[name][pci][1], prow))
        for row, cell in enumerate(ctx.instance_cells):
            assert row < u
            cs.copy(cell_pos(cell), (inst_col, row))

        pin = Pinning(
            k=k,
            lookup_bits=self.lookup_bits if self.lookup_bits is not None else -1,
            num_advice=num_advice,
            num_lookup_advice=num_lookup_advice,
            break_points=breaks,
            num_cells=num_cells,
            num_lookup_cells=num_lookup_cells,
            num_instance=num_instance,
            num_spread_advice=num_spread_advice,
            num_spread_pairs=num_spread_pairs,
            pair_table_meta=pair_meta,
        )
        return CompiledCircuit(
            cs=cs,
            fixed_values=fixed_values,
            pinning=pin,
            advice_of_cell=advice_of_cell,
            lookup_of_cell=lookup_of_cell,
        )

    def witness_columns(self, compiled: CompiledCircuit, ctx: Context) -> list[list[int]]:
        """Fill advice column values from a (structurally identical) trace."""
        n = 1 << self.k
        pin = compiled.pinning
        u = compiled.cs.usable_rows(n)
        assert len(ctx.cells) == pin.num_cells, "witness trace shape mismatch"
        n_pair_cols = 2 * sum(v[0] for v in (pin.pair_table_meta or {}).values())
        cols = [
            [0] * n
            for _ in range(
                pin.num_advice + pin.num_lookup_advice + 2 * pin.num_spread_advice + n_pair_cols
            )
        ]
        for cell, v in enumerate(ctx.cells):
            ci, row = compiled.advice_of_cell[cell]
            cols[ci][row] = v
        for slot, cell in enumerate(ctx.lookup_cells):
            lci, lrow = compiled.lookup_of_cell[slot]
            cols[pin.num_advice + lci][lrow] = ctx.cells[cell]
        base = pin.num_advice + pin.num_lookup_advice
        for slot, (dcell, scell) in enumerate(ctx.spread_pairs):
            pci, prow = slot // u, slot % u
            cols[base + 2 * pci][prow] = ctx.cells[dcell]
            cols[base + 2 * pci + 1][prow] = ctx.cells[scell]
        base += 2 * pin.num_spread_advice
        for name in sorted(ctx.pair_tables):
            meta = (pin.pair_table_meta or {}).get(name, [0, 0])
            for slot, (ca, cb) in enumerate(ctx.pair_lookups[name]):
                pci, prow = slot // u, slot % u
                cols[base + 2 * pci][prow] = ctx.cells[ca]
                cols[base + 2 * pci + 1][prow] = ctx.cells[cb]
            base += 2 * meta[0]
        return cols

    def witness_limbs(self, compiled: CompiledCircuit, ctx: Context, cells_u16):
        """Vectorized witness fill from the native replay's raw limb array.

        cells_u16: (num_cells, 16) uint16 little-endian 16-bit limbs (the
        C++ evaluator's output layout, = mont.encode_ints' host layout).
        Returns (num_cols, n, 16) uint16 ready for uint32-cast + to_mont —
        no per-cell Python loop (SURVEY.md §2.3 row 3: witness fill is part
        of the compiled path).

        `ctx` supplies only the structural index lists (lookup_cells,
        spread_pairs, pair_lookups) — its cell values are not read. The
        list->ndarray conversions of those structural indices are cached on
        `compiled` (they are pinning-determined, not witness-dependent):
        converting the DCAP circuit's millions of python tuples measured
        ~1.5 s/proof, 4x the scatter itself.
        """
        import numpy as np

        n = 1 << self.k
        pin = compiled.pinning
        u = compiled.cs.usable_rows(n)
        assert cells_u16.shape == (pin.num_cells, 16)
        cache = getattr(compiled, "_fill_cache", None)
        if cache is None:
            cache = {"pos": np.asarray(compiled.advice_of_cell, np.int64)}
            if ctx.lookup_cells:
                cache["lc"] = np.asarray(ctx.lookup_cells, np.int64)
                cache["lpos"] = np.asarray(compiled.lookup_of_cell, np.int64)
            if ctx.spread_pairs:
                cache["sp"] = np.asarray(ctx.spread_pairs, np.int64)
            cache["pl"] = {
                name: np.asarray(ctx.pair_lookups[name], np.int64)
                for name in sorted(ctx.pair_tables)
                if ctx.pair_lookups[name]
            }
            try:
                compiled._fill_cache = cache
            except Exception:
                pass  # frozen dataclass etc.: recompute per call
        n_pair_cols = 2 * sum(v[0] for v in (pin.pair_table_meta or {}).values())
        ncols = (
            pin.num_advice + pin.num_lookup_advice + 2 * pin.num_spread_advice + n_pair_cols
        )
        out = np.zeros((ncols, n, 16), np.uint16)
        pos = cache["pos"]  # (num_cells, 2)
        out[pos[:, 0], pos[:, 1]] = cells_u16
        if "lc" in cache:
            lc, lpos = cache["lc"], cache["lpos"]
            out[pin.num_advice + lpos[:, 0], lpos[:, 1]] = cells_u16[lc]
        base = pin.num_advice + pin.num_lookup_advice
        if "sp" in cache:
            sp = cache["sp"]  # (m, 2) cell ids
            slots = np.arange(len(sp))
            pci, prow = slots // u, slots % u
            out[base + 2 * pci, prow] = cells_u16[sp[:, 0]]
            out[base + 2 * pci + 1, prow] = cells_u16[sp[:, 1]]
        base += 2 * pin.num_spread_advice
        for name in sorted(ctx.pair_tables):
            meta = (pin.pair_table_meta or {}).get(name, [0, 0])
            pp = cache["pl"].get(name)
            if pp is not None:
                slots = np.arange(len(pp))
                pci, prow = slots // u, slots % u
                out[base + 2 * pci, prow] = cells_u16[pp[:, 0]]
                out[base + 2 * pci + 1, prow] = cells_u16[pp[:, 1]]
            base += 2 * meta[0]
        return out

    def instance_values(self, ctx: Context) -> list[list[int]]:
        if not ctx.instance_cells:
            return []
        return [[ctx.cells[c] for c in ctx.instance_cells]]
