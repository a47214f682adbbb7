"""Shadow big-integer tracer: records the witness dataflow DAG.

A copy of ``zkdcap_tpu/witness/tracer.py`` (host Python, no device work); the
layout, and with it the pinning, the vk and the proofs, depend on every
detail of it, so it stays line for line the JAX package's.

Circuit builders compute every witness value with plain Python int
arithmetic ("shadow computation" threading through the chip stack). To
compile witness generation, the per-proof inputs are wrapped in `TInt` —
an int-like proxy that performs the same arithmetic on a concrete value
while appending one DAG node per operation. Every `Context.push` then
binds its cell to the node of the pushed value, so replaying the DAG with
new inputs regenerates the whole witness without re-running any chip code.

Mirrors the reference's compiled witness generation capability
(SURVEY.md §2.3 row 3: halo2-base synthesize closures under rayon).

Soundness note: Python control flow on traced values (comparisons used in
`if`/`assert`) collapses to the recording input's branch. Structure-
changing branches are already forbidden by the pinning invariant; the few
value-only selects in the chips are written via `t_sel`/comparison *nodes*
(see chips/context.py is_zero, chips/ecdsa.py j witness), and replayed
witnesses are cross-validated against fresh traces in
tests/test_witness_replay.py plus gate/copy-checked at runtime.
"""

from __future__ import annotations

from array import array

# DAG opcodes (int64 quadruples: op, a, b, c).
# Args >= 0 are node ids; args < 0 are immediate-pool refs (-(idx+1));
# unused args are 0.
OP_INPUT = 0  # a = input slot
OP_ADD = 1
OP_SUB = 2
OP_MUL = 3
OP_FLOORDIV = 4  # python floored division
OP_MOD = 5  # python floored modulo
OP_LSHIFT = 6
OP_RSHIFT = 7  # arithmetic (floor), matches python
OP_AND = 8
OP_OR = 9
OP_XOR = 10
OP_NEG = 11
OP_POWMOD = 12  # pow(a, exp=b, mod=c); exp >= 0
OP_INVMOD = 13  # pow(a, -1, mod=b)
OP_EQ = 14  # 0/1
OP_NE = 15
OP_LT = 16
OP_LE = 17
OP_TABLE = 18  # a = table id, b = index node
OP_CONST = 19  # a = pool ref (only for cell bindings of plain ints)

OP_NAMES = {
    v: k[3:].lower()
    for k, v in list(globals().items())
    if k.startswith("OP_") and isinstance(v, int)
}


class Tracer:
    """Append-only DAG of big-int operations."""

    def __init__(self):
        self.op = array("q")
        self.a = array("q")
        self.b = array("q")
        self.c = array("q")
        self.pool: list[int] = []
        self._pool_idx: dict[int, int] = {}
        self.tables: list[list[int]] = []
        self.num_inputs = 0
        self.input_values: list[int] = []  # recording input vector (for tests)

    def __len__(self) -> int:
        return len(self.op)

    def imm(self, v: int) -> int:
        """Pool an immediate, return its arg encoding (negative)."""
        idx = self._pool_idx.get(v)
        if idx is None:
            idx = len(self.pool)
            self.pool.append(v)
            self._pool_idx[v] = idx
        return -(idx + 1)

    def node(self, op: int, a: int = 0, b: int = 0, c: int = 0) -> int:
        nid = len(self.op)
        self.op.append(op)
        self.a.append(a)
        self.b.append(b)
        self.c.append(c)
        return nid

    def input(self, value: int) -> "TInt":
        """Mark a per-proof input; returns its traced proxy."""
        value = int(value)
        k = self.num_inputs
        self.num_inputs += 1
        self.input_values.append(value)
        return TInt(self, self.node(OP_INPUT, k), value)

    def table(self, table_id: int, index: "TInt") -> "TInt":
        rows = self.tables[table_id]
        if isinstance(index, TInt):
            return TInt(
                self, self.node(OP_TABLE, table_id, index.id), rows[index.v]
            )
        return rows[int(index)]

    def register_table(self, rows: list[int]) -> int:
        self.tables.append([int(r) for r in rows])
        return len(self.tables) - 1


def _arg(tr: Tracer, x) -> tuple[int, int]:
    """(arg encoding, concrete value) of a TInt or plain int operand."""
    if isinstance(x, TInt):
        assert x.tr is tr, "mixing tracers"
        return x.id, x.v
    return tr.imm(int(x)), int(x)


class TInt:
    """Int-like proxy: concrete value + DAG node id."""

    __slots__ = ("tr", "id", "v")

    def __init__(self, tr: Tracer, nid: int, v: int):
        self.tr = tr
        self.id = nid
        self.v = v

    # --- conversions ------------------------------------------------------
    def __int__(self) -> int:
        return self.v

    def __index__(self) -> int:
        return self.v

    def __repr__(self) -> str:
        return f"TInt({self.v})"

    def __format__(self, spec) -> str:
        return format(self.v, spec)

    def __hash__(self):
        return hash(self.v)

    def bit_length(self) -> int:
        return self.v.bit_length()

    # --- binary ops ---------------------------------------------------------
    def _bin(self, op: int, other, vv: int) -> "TInt":
        tr = self.tr
        oa, _ = _arg(tr, other)
        return TInt(tr, tr.node(op, self.id, oa), vv)

    def _rbin(self, op: int, other, vv: int) -> "TInt":
        tr = self.tr
        oa, _ = _arg(tr, other)
        return TInt(tr, tr.node(op, oa, self.id), vv)

    def __add__(self, o):
        return self._bin(OP_ADD, o, self.v + _val(o))

    def __radd__(self, o):
        return self._rbin(OP_ADD, o, _val(o) + self.v)

    def __sub__(self, o):
        return self._bin(OP_SUB, o, self.v - _val(o))

    def __rsub__(self, o):
        return self._rbin(OP_SUB, o, _val(o) - self.v)

    def __mul__(self, o):
        return self._bin(OP_MUL, o, self.v * _val(o))

    def __rmul__(self, o):
        return self._rbin(OP_MUL, o, _val(o) * self.v)

    def __floordiv__(self, o):
        return self._bin(OP_FLOORDIV, o, self.v // _val(o))

    def __rfloordiv__(self, o):
        return self._rbin(OP_FLOORDIV, o, _val(o) // self.v)

    def __mod__(self, o):
        return self._bin(OP_MOD, o, self.v % _val(o))

    def __rmod__(self, o):
        return self._rbin(OP_MOD, o, _val(o) % self.v)

    def __divmod__(self, o):
        return self.__floordiv__(o), self.__mod__(o)

    def __rdivmod__(self, o):
        return self.__rfloordiv__(o), self.__rmod__(o)

    def __lshift__(self, o):
        return self._bin(OP_LSHIFT, o, self.v << _val(o))

    def __rshift__(self, o):
        return self._bin(OP_RSHIFT, o, self.v >> _val(o))

    def __and__(self, o):
        return self._bin(OP_AND, o, self.v & _val(o))

    def __rand__(self, o):
        return self._rbin(OP_AND, o, _val(o) & self.v)

    def __or__(self, o):
        return self._bin(OP_OR, o, self.v | _val(o))

    def __ror__(self, o):
        return self._rbin(OP_OR, o, _val(o) | self.v)

    def __xor__(self, o):
        return self._bin(OP_XOR, o, self.v ^ _val(o))

    def __rxor__(self, o):
        return self._rbin(OP_XOR, o, _val(o) ^ self.v)

    def __neg__(self):
        tr = self.tr
        return TInt(tr, tr.node(OP_NEG, self.id), -self.v)

    def __pos__(self):
        return self

    def __pow__(self, exp, mod=None):
        tr = self.tr
        e = _val(exp)
        assert mod is not None, "traced pow requires a modulus"
        m = _val(mod)
        if e == -1:
            return TInt(
                tr,
                tr.node(OP_INVMOD, self.id, tr.imm(m)),
                pow(self.v, -1, m),
            )
        assert e >= 0, "traced pow exponent must be -1 or >= 0"
        return TInt(
            tr,
            tr.node(OP_POWMOD, self.id, tr.imm(e), tr.imm(m)),
            pow(self.v, e, m),
        )

    # --- comparisons --------------------------------------------------------
    # Return TBool: truthy like the concrete result (asserts and structural
    # branches keep working) but carrying a 0/1 DAG node so value-dependent
    # *selects* can stay traced (t_sel / arithmetic on the TBool).

    def _cmp(self, op: int, o, vv: bool) -> "TBool":
        tr = self.tr
        oa, _ = _arg(tr, o)
        return TBool(tr, tr.node(op, self.id, oa), 1 if vv else 0)

    def __eq__(self, o):
        return self._cmp(OP_EQ, o, self.v == _val(o))

    def __ne__(self, o):
        return self._cmp(OP_NE, o, self.v != _val(o))

    def __lt__(self, o):
        return self._cmp(OP_LT, o, self.v < _val(o))

    def __le__(self, o):
        return self._cmp(OP_LE, o, self.v <= _val(o))

    def __gt__(self, o):
        tr = self.tr
        oa, _ = _arg(tr, o)
        return TBool(tr, tr.node(OP_LT, oa, self.id), 1 if self.v > _val(o) else 0)

    def __ge__(self, o):
        tr = self.tr
        oa, _ = _arg(tr, o)
        return TBool(tr, tr.node(OP_LE, oa, self.id), 1 if self.v >= _val(o) else 0)

    def __bool__(self):
        return self.v != 0


class TBool(TInt):
    """0/1-valued TInt from a comparison; truthiness is the comparison."""

    __slots__ = ()


def _val(x) -> int:
    return x.v if isinstance(x, TInt) else int(x)


def t_sel(cond, x, y):
    """Traced select: cond ? x : y (cond a TBool/0-1 value)."""
    if isinstance(cond, TInt) or isinstance(x, TInt) or isinstance(y, TInt):
        return cond * (x - y) + y
    return x if cond else y


def evaluate(tr: Tracer, inputs: list[int]) -> list[int]:
    """Reference (pure-Python) DAG evaluator — the C++ engine's oracle."""
    assert len(inputs) == tr.num_inputs
    vals: list[int] = [0] * len(tr.op)
    pool = tr.pool
    op, A, B, C = tr.op, tr.a, tr.b, tr.c

    def arg(x):
        return vals[x] if x >= 0 else pool[-x - 1]

    for i in range(len(op)):
        o = op[i]
        if o == OP_INPUT:
            vals[i] = inputs[A[i]]
        elif o == OP_ADD:
            vals[i] = arg(A[i]) + arg(B[i])
        elif o == OP_SUB:
            vals[i] = arg(A[i]) - arg(B[i])
        elif o == OP_MUL:
            vals[i] = arg(A[i]) * arg(B[i])
        elif o == OP_FLOORDIV:
            vals[i] = arg(A[i]) // arg(B[i])
        elif o == OP_MOD:
            vals[i] = arg(A[i]) % arg(B[i])
        elif o == OP_LSHIFT:
            vals[i] = arg(A[i]) << arg(B[i])
        elif o == OP_RSHIFT:
            vals[i] = arg(A[i]) >> arg(B[i])
        elif o == OP_AND:
            vals[i] = arg(A[i]) & arg(B[i])
        elif o == OP_OR:
            vals[i] = arg(A[i]) | arg(B[i])
        elif o == OP_XOR:
            vals[i] = arg(A[i]) ^ arg(B[i])
        elif o == OP_NEG:
            vals[i] = -arg(A[i])
        elif o == OP_POWMOD:
            vals[i] = pow(arg(A[i]), arg(B[i]), arg(C[i]))
        elif o == OP_INVMOD:
            vals[i] = pow(arg(A[i]), -1, arg(B[i]))
        elif o == OP_EQ:
            vals[i] = 1 if arg(A[i]) == arg(B[i]) else 0
        elif o == OP_NE:
            vals[i] = 1 if arg(A[i]) != arg(B[i]) else 0
        elif o == OP_LT:
            vals[i] = 1 if arg(A[i]) < arg(B[i]) else 0
        elif o == OP_LE:
            vals[i] = 1 if arg(A[i]) <= arg(B[i]) else 0
        elif o == OP_TABLE:
            vals[i] = tr.tables[A[i]][arg(B[i])]
        elif o == OP_CONST:
            vals[i] = arg(A[i])
        else:
            raise ValueError(f"bad op {o}")
    return vals
