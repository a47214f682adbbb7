"""Constraint-expression IR (halo2 `Expression` equivalent).

Port of ``zkdcap_tpu/plonk/expression.py``: the AST, ``expr_bytes`` and
``eval_host`` are copies; ``Evaluator`` maps every node to one batched torch
op over whole columns (rotations become ``torch.roll``, products kernel E).
The same evaluator serves the row domain and the extended coset domain,
where rotations scale by the domain ratio.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import mont
from ..fields.params import BN254_FR

R = BN254_FR.p


class Expression:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_wrap(other)))

    def __rsub__(self, other):
        return Sum(_wrap(other), Negated(self))

    def __mul__(self, other):
        other = _wrap(other)
        if isinstance(other, Constant):
            return Scaled(self, other.value)
        return Product(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Negated(self)

    def degree(self) -> int:
        raise NotImplementedError


def _wrap(x) -> Expression:
    if isinstance(x, Expression):
        return x
    return Constant(int(x) % R)


@dataclasses.dataclass(frozen=True)
class Constant(Expression):
    value: int

    def degree(self):
        return 0


@dataclasses.dataclass(frozen=True)
class Fixed(Expression):
    index: int
    rotation: int = 0

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class Advice(Expression):
    index: int
    rotation: int = 0

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class Instance(Expression):
    index: int
    rotation: int = 0

    def degree(self):
        return 1


@dataclasses.dataclass(frozen=True)
class Challenge(Expression):
    """A transcript challenge usable inside expressions (theta/beta/gamma)."""

    name: str

    def degree(self):
        return 0


@dataclasses.dataclass(frozen=True)
class Negated(Expression):
    inner: Expression

    def degree(self):
        return self.inner.degree()


@dataclasses.dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())


@dataclasses.dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()


@dataclasses.dataclass(frozen=True)
class Scaled(Expression):
    inner: Expression
    scalar: int

    def degree(self):
        return self.inner.degree()


def expr_bytes(e: Expression) -> bytes:
    """Canonical byte serialization of an expression AST (for vk binding —
    ADVICE round-1: transcript_repr must hash gate/lookup expressions, not
    just their counts)."""
    if isinstance(e, Constant):
        return b"C" + (e.value % R).to_bytes(32, "little")
    if isinstance(e, Challenge):
        name = e.name.encode()
        return b"H" + len(name).to_bytes(2, "little") + name
    if isinstance(e, Fixed):
        return b"F" + e.index.to_bytes(4, "little") + (e.rotation & 0xFFFFFFFF).to_bytes(4, "little")
    if isinstance(e, Advice):
        return b"A" + e.index.to_bytes(4, "little") + (e.rotation & 0xFFFFFFFF).to_bytes(4, "little")
    if isinstance(e, Instance):
        return b"I" + e.index.to_bytes(4, "little") + (e.rotation & 0xFFFFFFFF).to_bytes(4, "little")
    if isinstance(e, Negated):
        return b"N" + expr_bytes(e.inner)
    if isinstance(e, Sum):
        return b"S" + expr_bytes(e.a) + expr_bytes(e.b)
    if isinstance(e, Product):
        return b"P" + expr_bytes(e.a) + expr_bytes(e.b)
    if isinstance(e, Scaled):
        return b"L" + (e.scalar % R).to_bytes(32, "little") + expr_bytes(e.inner)
    raise TypeError(f"unknown expression {e!r}")


class Evaluator:
    """Evaluates expressions over column arrays.

    fixed/advice/instance: lists of int32[n, 16] Montgomery Lagrange arrays
    on the evaluation domain; `rot_scale` = 1 on the row domain, or
    extended_n/n on the extended coset domain; challenges: name -> int or
    (16,) Montgomery row. `rows` (a ``plonk.row_sharder.RowSharder``) with
    `block`: evaluate block `block` of the rows only, on its shard.
    """

    def __init__(self, fixed, advice, instance, rot_scale: int = 1, challenges=None,
                 rows=None, block: int = 0):
        self.fixed = fixed
        self.advice = advice
        self.instance = instance
        self.rot_scale = rot_scale
        self.challenges = challenges or {}
        self._rows, self._block = rows, block
        if rows is None:
            first = next(c for cols in (fixed, advice, instance) for c in cols)
            self._n, self._device = first.shape[0], first.device
        else:
            self._n, self._device = rows.rows, rows.devices[block]
        self._cache: dict = {}

    def _col(self, arr, rotation: int):
        # f(omega^rot * X) on the Lagrange grid = shift indices by +rot
        if self._rows is not None:
            return self._rows.block(arr, self._block, rotation * self.rot_scale)
        if rotation == 0:
            return arr
        return torch.roll(arr, -rotation * self.rot_scale, 0)

    def _row(self, value: int) -> torch.Tensor:
        return mont.encode_ints(BN254_FR, [value], device=self._device)

    def eval(self, e: Expression) -> torch.Tensor:
        key = id(e)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        out = self._eval(e)
        self._cache[key] = out
        return out

    def _eval(self, e: Expression) -> torch.Tensor:
        f = BN254_FR
        if isinstance(e, Constant):
            return self._row(e.value).expand(self._n, 16)
        if isinstance(e, Challenge):
            v = self.challenges[e.name]
            row = self._row(v) if isinstance(v, int) else v.reshape(1, 16)
            return row.expand(self._n, 16)
        if isinstance(e, Fixed):
            return self._col(self.fixed[e.index], e.rotation)
        if isinstance(e, Advice):
            return self._col(self.advice[e.index], e.rotation)
        if isinstance(e, Instance):
            return self._col(self.instance[e.index], e.rotation)
        if isinstance(e, Negated):
            return mont.neg(f, self.eval(e.inner))
        if isinstance(e, Sum):
            return mont.add(f, self.eval(e.a), self.eval(e.b))
        if isinstance(e, Product):
            return mont.mont_mul(f, self.eval(e.a), self.eval(e.b))
        if isinstance(e, Scaled):
            return mont.mont_mul(f, self.eval(e.inner), self._row(e.scalar))
        raise TypeError(f"unknown expression {e!r}")


def eval_host(e: Expression, fixed, advice, instance, row: int, n: int, challenges=None) -> int:
    """Host (python int) evaluation at one row — verifier/mock spot checks."""
    challenges = challenges or {}
    if isinstance(e, Constant):
        return e.value % R
    if isinstance(e, Challenge):
        return challenges[e.name] % R
    if isinstance(e, Fixed):
        return fixed[e.index][(row + e.rotation) % n]
    if isinstance(e, Advice):
        return advice[e.index][(row + e.rotation) % n]
    if isinstance(e, Instance):
        return instance[e.index][(row + e.rotation) % n]
    if isinstance(e, Negated):
        return (-eval_host(e.inner, fixed, advice, instance, row, n, challenges)) % R
    if isinstance(e, Sum):
        return (
            eval_host(e.a, fixed, advice, instance, row, n, challenges)
            + eval_host(e.b, fixed, advice, instance, row, n, challenges)
        ) % R
    if isinstance(e, Product):
        return (
            eval_host(e.a, fixed, advice, instance, row, n, challenges)
            * eval_host(e.b, fixed, advice, instance, row, n, challenges)
        ) % R
    if isinstance(e, Scaled):
        return eval_host(e.inner, fixed, advice, instance, row, n, challenges) * e.scalar % R
    raise TypeError(f"unknown expression {e!r}")
