"""Witness tape: recorded dataflow DAG + cell bindings, with replay.

A copy of ``zkdcap_tpu/witness/tape.py``; the saved ``.npz`` format is the
same, so a tape saved by either package loads in the other. ``replay`` runs
the port's native evaluator only (no Python fallback).

`record(build_fn)` runs a circuit builder once under a Tracer and returns
(ctx, tape): the Context's cells are materialised to plain ints (the
recording input's witness) and the tape binds every cell to a DAG node.
`tape.replay(inputs)` evaluates the DAG on a new flat input vector and
returns the full cell-value list — the per-proof replacement for
re-running the Python chip stack (SURVEY.md §2.3 row 3).

Replayed witnesses are validated two ways: tests/test_witness_replay.py
diffs them against fresh Python traces on independent inputs, and the
JAX package's runtime can gate/copy-check them (plonk/mock.py) before
proving.
"""

from __future__ import annotations

import json
import os
from array import array

import numpy as np

from .tracer import (
    OP_CONST,
    OP_INPUT,
    OP_NEG,
    OP_POWMOD,
    OP_INVMOD,
    OP_TABLE,
    TInt,
    Tracer,
    evaluate,
)

_UNARY_A = {OP_NEG, OP_POWMOD, OP_INVMOD}  # only `a` can be a node ref
_NO_REF = {OP_INPUT, OP_CONST}


class WitnessTape:
    def __init__(self, tracer: Tracer, cell_nodes: array):
        self.tracer = tracer
        self.cell_nodes = cell_nodes  # cell index -> node id

    @property
    def num_inputs(self) -> int:
        return self.tracer.num_inputs

    def __len__(self) -> int:
        return len(self.tracer.op)

    # --- replay -----------------------------------------------------------

    def replay_py(self, inputs: list[int]) -> list[int]:
        vals = evaluate(self.tracer, [int(v) for v in inputs])
        return [vals[n] for n in self.cell_nodes]

    def replay(self, inputs: list[int]) -> list[int]:
        """Native replay via the C++ evaluator."""
        from .replay import replay_native

        return replay_native(self, inputs)

    # --- serialization ------------------------------------------------------

    def save(self, path: str) -> None:
        tr = self.tracer
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            op=np.frombuffer(tr.op.tobytes(), np.int64),
            a=np.frombuffer(tr.a.tobytes(), np.int64),
            b=np.frombuffer(tr.b.tobytes(), np.int64),
            c=np.frombuffer(tr.c.tobytes(), np.int64),
            cells=np.frombuffer(self.cell_nodes.tobytes(), np.int64),
            meta=np.frombuffer(
                json.dumps(
                    {
                        "pool": [hex(v) for v in tr.pool],
                        "tables": tr.tables,
                        "num_inputs": tr.num_inputs,
                    }
                ).encode(),
                np.uint8,
            ),
        )

    @staticmethod
    def load(path: str) -> "WitnessTape":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        meta = json.loads(bytes(z["meta"]).decode())
        tr = Tracer()
        tr.op = array("q", z["op"].tobytes())
        tr.a = array("q", z["a"].tobytes())
        tr.b = array("q", z["b"].tobytes())
        tr.c = array("q", z["c"].tobytes())
        tr.pool = [int(h, 16) for h in meta["pool"]]
        tr._pool_idx = {v: i for i, v in enumerate(tr.pool)}
        tr.tables = meta["tables"]
        tr.num_inputs = meta["num_inputs"]
        return WitnessTape(tr, array("q", z["cells"].tobytes()))


def cells_u16(cells: list[int]) -> np.ndarray:
    """Host cell-value list -> (n, 16) uint16 LE limb array (the native
    evaluator's output layout) for the vectorized witness fill."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in cells)
    return np.frombuffer(buf, np.uint16).reshape(-1, 16)


def finalize(ctx) -> WitnessTape:
    """Materialise a traced Context: cells become plain ints, and the
    tape binds each cell to its DAG node. Prunes nodes unreachable from
    any cell binding (assert-only comparisons etc.)."""
    tr: Tracer = ctx.tracer
    assert tr is not None, "Context was not built with a tracer"
    n = len(tr.op)
    cells_out: list[int] = []
    nodes = array("q")
    for c in ctx.cells:
        if isinstance(c, TInt):
            nodes.append(c.id)
            cells_out.append(c.v)
        else:
            nodes.append(tr.node(OP_CONST, tr.imm(int(c))))
            cells_out.append(int(c))
    ctx.cells = cells_out
    n = len(tr.op)

    # mark-and-renumber reachability pass (reverse topological: the DAG is
    # append-only so args always reference earlier nodes)
    live = np.zeros(n, dtype=bool)
    live[np.frombuffer(nodes.tobytes(), np.int64)] = True
    op = np.frombuffer(tr.op.tobytes(), np.int64)
    a = np.frombuffer(tr.a.tobytes(), np.int64)
    b = np.frombuffer(tr.b.tobytes(), np.int64)
    opl, al, bl = op.tolist(), a.tolist(), b.tolist()
    livel = live.tolist()
    for i in range(n - 1, -1, -1):
        if not livel[i]:
            continue
        o = opl[i]
        if o in _NO_REF:
            continue
        if o == OP_TABLE:
            if bl[i] >= 0:
                livel[bl[i]] = True
            continue
        if al[i] >= 0:
            livel[al[i]] = True
        if o not in _UNARY_A and bl[i] >= 0:
            livel[bl[i]] = True
    live = np.asarray(livel)
    remap = np.cumsum(live) - 1
    keep = np.flatnonzero(live)

    def renum(col, is_b=False):
        v = np.frombuffer(col.tobytes(), np.int64)[keep].copy()
        return v

    new_op = np.frombuffer(tr.op.tobytes(), np.int64)[keep]
    new_a = np.frombuffer(tr.a.tobytes(), np.int64)[keep]
    new_b = np.frombuffer(tr.b.tobytes(), np.int64)[keep]
    new_c = np.frombuffer(tr.c.tobytes(), np.int64)[keep]
    # rewrite refs through the remap
    for i, o in enumerate(new_op.tolist()):
        if o in _NO_REF:
            continue
        if o == OP_TABLE:
            if new_b[i] >= 0:
                new_b[i] = remap[new_b[i]]
            continue
        if new_a[i] >= 0:
            new_a[i] = remap[new_a[i]]
        if o not in _UNARY_A and new_b[i] >= 0:
            new_b[i] = remap[new_b[i]]
    cell_nodes = array(
        "q", remap[np.frombuffer(nodes.tobytes(), np.int64)].tolist()
    )

    out = Tracer()
    out.op = array("q", new_op.tolist())
    out.a = array("q", new_a.tolist())
    out.b = array("q", new_b.tolist())
    out.c = array("q", new_c.tolist())
    out.pool = tr.pool
    out._pool_idx = tr._pool_idx
    out.tables = tr.tables
    out.num_inputs = tr.num_inputs
    out.input_values = tr.input_values
    return WitnessTape(out, cell_nodes)


def record(build_fn) -> tuple[object, WitnessTape]:
    """build_fn(tracer) -> Context; returns (materialised ctx, tape)."""
    tr = Tracer()
    ctx = build_fn(tr)
    tape = finalize(ctx)
    return ctx, tape
