"""Kernel E: the elementwise Montgomery product, its wrapper and its plain
torch version.

Counterpart of ``_mk_mul_kernel`` / ``mont_mul_lm`` of
``zkdcap_tpu/fields/pallas_mont.py``; the CUDA source is ``csrc/mont_mul.cu``.
``mont_mul(params, a, b)`` returns a * b * R^-1 mod p for BN254 Fr or Fq over
``int32[..., 16]`` limbs that broadcast against each other. Every product of
the prover goes through it: on CUDA tensors it launches kernel E (or
raises), on CPU tensors it runs the plain version.

Kernel E reads one operand in full and the other either in full, as one
row, or as rows each repeated over a run of consecutive elements; any other
broadcast is materialised first.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import mont
from .params import BN254_FQ, BN254_FR, NUM_LIMBS, FieldParams

L = NUM_LIMBS
_FIELD_CODE = {BN254_FR: 0, BN254_FQ: 1}


def mont_mul(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        return _mont_mul_cuda(params, a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(params, a, b)
    raise ValueError(f"mont_mul: unsupported device {a.device}")


def mont_mul_plain(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of kernel E: the limb-major int64 CIOS of
    ``fields/mont.py``."""
    return mont.to32(mont.mul64(params, mont.to64(a), mont.to64(b)))


def _b_pattern(b_shape, shape) -> tuple[int, int] | None:
    """(rows, inner) with which kernel E reads b broadcast to `shape`: element
    g takes b's row (g // inner) % rows. None when b's axes that are not
    broadcast do not form one run of the batch axes."""
    batch = list(shape[:-1])
    bb = [1] * (len(batch) - (len(b_shape) - 1)) + list(b_shape[:-1])
    kept = [i for i, s in enumerate(batch) if s != 1]
    own = [i for i in kept if bb[i] != 1]
    if not own:
        return 1, 1
    if own != kept[kept.index(own[0]) : kept.index(own[-1]) + 1]:
        return None
    return (math.prod(batch[i] for i in own),
            math.prod(batch[i] for i in kept if i > own[-1]))


def _mont_mul_cuda(params: FieldParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if params not in _FIELD_CODE:
        raise ValueError("kernel E is built for BN254 Fr and Fq only")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if shape[-1] != L:
        raise ValueError(f"mont_mul: last axis must be {L} limbs, got {tuple(shape)}")
    full = math.prod(shape)
    if a.numel() != full and b.numel() == full:
        a, b = b, a
    a = a.expand(shape).contiguous()
    pattern = _b_pattern(b.shape, shape)
    if pattern is None:
        b, pattern = b.expand(shape).contiguous(), (full // L, 1)
    else:
        b = b.contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = full // L
    if n == 0:
        return out
    dev = _build.check_cuda("mont_mul", a, b)
    _build.launch("mont_mul", a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                  pattern[0], pattern[1], _FIELD_CODE[params], device=dev)
    return out
