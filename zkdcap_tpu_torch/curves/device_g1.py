"""Batched BN254 G1 arithmetic in plain torch (complete projective formulas).

Port of ``zkdcap_tpu/curves/device_g1.py``: Renes–Costello–Batina 2015
complete addition and doubling for a = 0 (Algorithms 7 and 9). The same
branch-free sequence is right for P+Q, P+P, P+(-P) and the identity
(0 : 1 : 0), which is what the MSM's masked reductions rely on.

A point is a tuple (X, Y, Z) of ``int32[..., 16]`` Montgomery limbs,
homogeneous projective coordinates (x = X/Z, y = Y/Z). The ``*64`` forms
take and return limb-major int64 coordinates (see ``fields/mont.py``) and
batch the formulas' independent products into one Montgomery multiply each,
which is what the kernels' plain versions build on.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..fields import mont
from ..fields.mont import add64, mul64, sub64
from ..fields.params import BN254_FQ, NUM_LIMBS, R, FieldParams, int_to_limbs
from .host_curve import BN254_G1, CurveParams

L = NUM_LIMBS
Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    field: FieldParams
    b3: int  # 3*b of the curve equation y^2 = x^3 + b
    host: CurveParams

    @functools.cached_property
    def b3_mont(self):
        return int_to_limbs(self.b3 * R % self.field.p)


G1_SPEC = CurveSpec(field=BN254_FQ, b3=9, host=BN254_G1)


def _b3(spec: CurveSpec, device) -> torch.Tensor:
    return torch.as_tensor(spec.b3_mont.astype("int64"), device=device)


def ec_inf(spec: CurveSpec, shape=(), device=None) -> Point:
    return (
        mont.zero(shape, device),
        mont.one_mont(spec.field, shape, device),
        mont.zero(shape, device),
    )


def ec_neg(spec: CurveSpec, P: Point) -> Point:
    X, Y, Z = P
    return (X, mont.neg(spec.field, Y), Z)


def ec_select(cond: torch.Tensor, P: Point, Q: Point) -> Point:
    """cond ? P : Q elementwise over the batch."""
    return tuple(torch.where(cond[..., None], a, b) for a, b in zip(P, Q))


def _st(*xs: torch.Tensor) -> torch.Tensor:
    """Stack limb-major operands along a new batch axis 1."""
    return torch.stack(xs, 1)


def ec_add64(spec: CurveSpec, P: Point, Q: Point) -> Point:
    """Complete addition, RCB'15 Algorithm 7 (a = 0), on limb-major int64
    coordinates of one shape (16, ...)."""
    f = spec.field
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    s = add64(f, _st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2)).unbind(1)
    t0, t1, t2, m3, m4, m5 = mul64(f, _st(X1, Y1, Z1, s[0], s[1], s[2]),
                                   _st(X2, Y2, Z2, s[3], s[4], s[5])).unbind(1)
    t3, t4, t5 = sub64(f, _st(m3, m4, m5),
                       add64(f, _st(t0, t1, t0), _st(t1, t2, t2))).unbind(1)
    t0 = add64(f, add64(f, t0, t0), t0)  # 3 X1X2
    t2, y3 = mul64(f, _b3(spec, X1.device), _st(t2, t5)).unbind(1)
    z3 = add64(f, t1, t2)  # Y1Y2 + b3 Z1Z2
    t1 = sub64(f, t1, t2)  # Y1Y2 - b3 Z1Z2
    m = mul64(f, _st(t3, t4, t1, y3, z3, t0), _st(t1, y3, z3, t0, t4, t3)).unbind(1)
    X3 = sub64(f, m[0], m[1])
    Y3, Z3 = add64(f, _st(m[2], m[4]), _st(m[3], m[5])).unbind(1)
    return (X3, Y3, Z3)


def ec_double64(spec: CurveSpec, P: Point) -> Point:
    """Complete doubling, RCB'15 Algorithm 9 (a = 0), on limb-major int64."""
    f = spec.field
    X, Y, Z = P
    t0, t1, t2, xy = mul64(f, _st(Y, Y, Z, X), _st(Y, Z, Z, Y)).unbind(1)
    t2 = mul64(f, _b3(spec, X.device), t2)  # b3 Z^2
    z3 = add64(f, t0, t0)
    z3 = add64(f, z3, z3)
    z3 = add64(f, z3, z3)  # 8 Y^2
    y3 = add64(f, t0, t2)
    t0 = sub64(f, t0, add64(f, add64(f, t2, t2), t2))  # Y^2 - 3 b3 Z^2
    x3, Z3, y3, x3b = mul64(f, _st(t2, t1, t0, t0), _st(z3, z3, y3, xy)).unbind(1)
    Y3 = add64(f, x3, y3)
    X3 = add64(f, x3b, x3b)
    return (X3, Y3, Z3)


def to64_pt(P: Point) -> Point:
    """int32 (..., 16) coordinates -> limb-major int64 (16, ...)."""
    return tuple(mont.to64(c) for c in P)


def to32_pt(P: Point) -> Point:
    return tuple(mont.to32(c) for c in P)


def ec_add(spec: CurveSpec, P: Point, Q: Point) -> Point:
    """Complete addition, RCB'15 Algorithm 7 (a = 0)."""
    shape = torch.broadcast_shapes(*(c.shape for c in P + Q))
    P = to64_pt(tuple(c.expand(shape) for c in P))
    Q = to64_pt(tuple(c.expand(shape) for c in Q))
    return to32_pt(ec_add64(spec, P, Q))


def ec_double(spec: CurveSpec, P: Point) -> Point:
    """Complete doubling, RCB'15 Algorithm 9 (a = 0)."""
    return to32_pt(ec_double64(spec, to64_pt(P)))


def ec_is_inf(P: Point) -> torch.Tensor:
    return mont.is_zero(P[2])


# --- host <-> device ---------------------------------------------------------

def encode_points(spec: CurveSpec, pts, device=None) -> torch.Tensor:
    """Host affine points [(x, y) | None, ...] -> int32[N, 2, 16] Montgomery.

    Infinity encodes as (0, 0), which is not on the curve, so it is
    unambiguous; consumers pair it with a digit/valid mask."""
    xs = [0 if pt is None else pt[0] for pt in pts]
    ys = [0 if pt is None else pt[1] for pt in pts]
    x = mont.encode_ints(spec.field, xs, device=device)
    y = mont.encode_ints(spec.field, ys, device=device)
    return torch.stack([x, y], dim=-2)


def affine_to_projective(spec: CurveSpec, pts: torch.Tensor) -> Point:
    """int32[..., 2, 16] Montgomery affine -> projective (Z = 1, or the
    identity for the encoded (0, 0))."""
    X = pts[..., 0, :]
    Y = pts[..., 1, :]
    is_inf = (mont.is_zero(X) & mont.is_zero(Y))[..., None]
    one = mont.one_mont(spec.field, X.shape[:-1], X.device)
    Z = torch.where(is_inf, torch.zeros_like(X), one)
    Y = torch.where(is_inf, one, Y)
    return (X, Y, Z)


def decode_points(spec: CurveSpec, P: Point):
    """Projective points -> host affine list [(x, y) | None, ...]."""
    X, Y, Z = P
    p = spec.field.p
    xs = mont.decode_ints(spec.field, X)
    ys = mont.decode_ints(spec.field, Y)
    zs = mont.decode_ints(spec.field, Z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p)
            out.append((x * zi % p, y * zi % p))
    return out
