"""Batched Montgomery arithmetic over BN254 in plain torch.

Port of ``zkdcap_tpu/fields/mont.py``. The JAX package computes these in
plain jnp outside any kernel, so plain torch is their counterpart. Public
functions take and return ``int32[..., 16]`` tensors of 16-bit limbs
(Montgomery form, R = 2^256) on any device; inside they compute in ``int64``.
The ``*64`` helpers keep ``int64`` limbs between operations and are what the
curve formulas and the kernels' plain versions chain together.

Every result is canonical (in [0, p)), so it is bit-identical to the JAX
package's for canonical inputs: a Montgomery product, sum or inverse has one
canonical value whatever order the limb arithmetic ran in.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve
from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldParams, int_to_limbs

L = NUM_LIMBS
W = LIMB_BITS
MASK = LIMB_MASK


@functools.cache
def _const(params: FieldParams, which: str, device: torch.device) -> torch.Tensor:
    value = {"p": params.p, "one": params.r_mod_p, "r2": params.r2}[which]
    return torch.as_tensor(int_to_limbs(value).astype(np.int64), device=device)


def const64(value: int, device) -> torch.Tensor:
    """int64[16] limbs of a host integer (no Montgomery conversion)."""
    return torch.as_tensor(int_to_limbs(value).astype(np.int64), device=device)


# --- int64 limb-major helpers --------------------------------------------------
#
# A "*64" operand is an int64 tensor with the limb axis FIRST, (16, ...): each
# limb is then one contiguous plane, which the carry chains walk plane by
# plane. Operands broadcast over the trailing batch axes; one with fewer axes
# (a constant (16,)) gets trailing singleton axes.

def lift(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Give a limb-major operand trailing singleton axes up to `ndim`."""
    return x.reshape(x.shape + (1,) * (ndim - x.dim())) if x.dim() < ndim else x


def _sweep(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry-propagate int64 limbs (any sign, |limb| < 2^62) into 16-bit
    limbs, overwriting `t`; returns (limbs, carry out of the top limb). A
    negative carry out is a borrow (the arithmetic shift floors).

    One ripple from the lowest limb plane up: the same fifteen steps
    whatever the data, so nothing waits on a read back to the host."""
    for i in range(t.shape[0] - 1):
        t[i + 1] += t[i] >> W
    return t & MASK, t[-1] >> W


def _reduce_once(params: FieldParams, s: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """s + carry * 2^256 (< 2p) -> canonical."""
    d, bw = _sweep(s - lift(_const(params, "p", s.device), s.dim()))
    need = (carry > 0) | (bw == 0)
    return torch.where(need, d, s)


def add64(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nd = max(a.dim(), b.dim())
    s, c = _sweep(lift(a, nd) + lift(b, nd))
    return _reduce_once(params, s, c)


def sub64(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nd = max(a.dim(), b.dim())
    d, bw = _sweep(lift(a, nd) - lift(b, nd))
    dp, _ = _sweep(d + lift(_const(params, "p", a.device), nd))
    return torch.where(bw < 0, dp, d)


def mul64(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p: CIOS over 16-bit limbs into a
    32-limb accumulator with the carries left unpropagated (limbs stay
    < 2^40 in int64), then one carry sweep and one conditional subtraction."""
    nd = max(a.dim(), b.dim())
    a, b = lift(a, nd), lift(b, nd)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    b = b.expand(shape)
    p = lift(_const(params, "p", a.device), nd)
    t = torch.zeros((2 * L,) + shape[1:], dtype=torch.int64, device=a.device)
    for i in range(L):
        t[i : i + L].addcmul_(b, a[i : i + 1])
        m = (t[i] * params.n0inv) & MASK
        t[i : i + L].addcmul_(p, m[None])
        t[i + 1] += t[i] >> W  # t[i] is 0 mod 2^16 after the REDC step
    s, c = _sweep(t[L:])
    return _reduce_once(params, s, c)


def to64(x: torch.Tensor) -> torch.Tensor:
    """int32[..., 16] -> limb-major int64[16, ...]."""
    return x.to(torch.int64).movedim(-1, 0).contiguous()


def to32(x: torch.Tensor) -> torch.Tensor:
    """limb-major int64[16, ...] -> int32[..., 16]."""
    return x.movedim(0, -1).to(torch.int32).contiguous()


# --- public batched ops ------------------------------------------------------

def add(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    return to32(add64(params, to64(a), to64(b)))


def sub(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    return to32(sub64(params, to64(a), to64(b)))


def neg(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p (maps 0 -> 0)."""
    a = to64(a)
    return to32(sub64(params, torch.zeros_like(a), a))


def mont_mul(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return to32(mul64(params, to64(a), to64(b)))


def mont_sqr(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(params, a, a)


def to_mont(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    return to32(mul64(params, to64(a), _const(params, "r2", a.device)))


def from_mont(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    return to32(mul64(params, to64(a), const64(1, a.device)))


def one_mont(params: FieldParams, shape=(), device=None) -> torch.Tensor:
    one = _const(params, "one", resolve(device)).to(torch.int32)
    return one.expand(*shape, L).clone()


def zero(shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*shape, L), dtype=torch.int32, device=resolve(device))


def pow64(params: FieldParams, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e in Montgomery form for a public exponent (square and multiply,
    most significant bit first)."""
    acc = lift(_const(params, "one", a.device), a.dim()).expand_as(a)
    for bit in bin(max(e, 0))[2:]:
        acc = mul64(params, acc, acc)
        if bit == "1":
            acc = mul64(params, acc, a)
    return acc


def mont_pow(params: FieldParams, a: torch.Tensor, e: int) -> torch.Tensor:
    return to32(pow64(params, to64(a), e))


def mont_inv(params: FieldParams, a: torch.Tensor) -> torch.Tensor:
    """Batched inversion via Fermat (a^(p-2)); maps 0 -> 0."""
    return mont_pow(params, a, params.p - 2)


def batch_inv64(params: FieldParams, x: torch.Tensor) -> torch.Tensor:
    """Inverses of a nonzero limb-major (16, N) batch: a product tree up,
    one Fermat inversion of the root, and the tree down (2N products)."""
    n = x.shape[1]
    size = 1 << max((n - 1).bit_length(), 0)
    one = _const(params, "one", x.device)[:, None]
    level = torch.cat([x, one.expand(L, size - n)], 1) if size > n else x
    levels = [level]
    while level.shape[1] > 1:
        level = mul64(params, level[:, 0::2], level[:, 1::2])
        levels.append(level)
    inv = pow64(params, level, params.p - 2)
    for child in reversed(levels[:-1]):
        # inv(left) = inv(parent) * right, inv(right) = inv(parent) * left
        sib = torch.stack([child[:, 1::2], child[:, 0::2]], 2).reshape(child.shape)
        inv = mul64(params, inv.repeat_interleave(2, 1), sib)
    return inv[:, :n]


def batch_inv(params: FieldParams, x: torch.Tensor) -> torch.Tensor:
    """Inverses of the rows of (N, 16); ALL rows must be nonzero."""
    return to32(batch_inv64(params, to64(x)))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b with cond shaped like the batch (no limb axis)."""
    return torch.where(cond[..., None], a, b)


# --- host <-> device ---------------------------------------------------------

def ints_to_limbs_np(params: FieldParams, values) -> np.ndarray:
    """Host ints (reduced mod p) -> uint16-valued int32[n, 16] limbs."""
    p = params.p
    buf = b"".join((int(v) % p).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint16).reshape(-1, L).astype(np.int32)


def encode_ints(params: FieldParams, values, to_montgomery: bool = True,
                device=None) -> torch.Tensor:
    """Host list of Python ints -> int32[n, 16] limbs (Montgomery by default)."""
    x = torch.as_tensor(ints_to_limbs_np(params, values), device=resolve(device))
    return to_mont(params, x) if to_montgomery else x


def decode_ints(params: FieldParams, x: torch.Tensor, from_montgomery: bool = True) -> list[int]:
    """(..., 16) limbs -> flat list of Python ints."""
    if from_montgomery:
        x = from_mont(params, x)
    flat = x.reshape(-1, L).cpu().numpy().astype(np.uint16).tobytes()
    return [int.from_bytes(flat[32 * i : 32 * (i + 1)], "little") for i in range(len(flat) // 32)]
