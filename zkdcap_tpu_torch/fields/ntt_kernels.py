"""Kernel A: the NTT pass, its wrapper and its plain torch version.

Counterpart of the fused NTT pass kernels of ``zkdcap_tpu/fields/pallas_mont.py``
(``_mk_fused_pass_kernel``, ``_mk_fused_pass_kernel_r12``,
``_mk_cg_pass_kernel_r12``); the CUDA source is ``csrc/ntt_pass.cu``.

``ntt_pass(x, tw, ptw)`` transforms every row of ``x`` (rows, 2^S, 16), S <=
11, natural order in and out, with the stage twiddles ``tw`` = powers
[w^0 .. w^(2^(S-1) - 1)] of the 2^S-th root w (forward or inverse), then
multiplies flat element g by ``ptw[g % len(ptw)]`` when ``ptw`` is given.
All values are BN254 Fr limbs in Montgomery form.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .mont import add64, mul64, sub64, to32, to64
from .params import BN254_FR, NUM_LIMBS

L = NUM_LIMBS
MAX_PASS_LOG = 11


@functools.cache
def _bitrev(log_n: int) -> torch.Tensor:
    idx = torch.arange(1 << log_n)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _check(x: torch.Tensor, tw: torch.Tensor, ptw) -> int:
    if x.dim() != 3 or x.shape[-1] != L:
        raise ValueError(f"ntt_pass: x must be (rows, 2^S, {L}), got {tuple(x.shape)}")
    size = x.shape[1]
    log_size = size.bit_length() - 1
    if size < 2 or size != 1 << log_size or log_size > MAX_PASS_LOG:
        raise ValueError(f"ntt_pass: transform size {size} is not a power of two in [2, 2^11]")
    if tuple(tw.shape) != (size // 2, L):
        raise ValueError(f"ntt_pass: tw must be ({size // 2}, {L}), got {tuple(tw.shape)}")
    if ptw is not None and (ptw.dim() != 2 or ptw.shape[1] != L
                            or (x.shape[0] * size) % ptw.shape[0]):
        raise ValueError(f"ntt_pass: ptw rows must divide {x.shape[0] * size}")
    return log_size


def ntt_pass(x: torch.Tensor, tw: torch.Tensor, ptw: torch.Tensor | None = None) -> torch.Tensor:
    log_size = _check(x, tw, ptw)
    if x.is_cuda:
        return _ntt_pass_cuda(x, tw, ptw, log_size)
    if x.device.type == "cpu":
        return ntt_pass_plain(x, tw, ptw)
    raise ValueError(f"ntt_pass: unsupported device {x.device}")


def _ntt_pass_cuda(x, tw, ptw, log_size: int) -> torch.Tensor:
    x, tw = x.contiguous(), tw.contiguous()
    ptw = None if ptw is None else ptw.contiguous()
    tensors = (x, tw) if ptw is None else (x, tw, ptw)
    _build.check_cuda("ntt_pass", *tensors)
    out = torch.empty_like(x)
    _build.launch(
        "ntt_pass", x.data_ptr(), out.data_ptr(), tw.data_ptr(),
        None if ptw is None else ptw.data_ptr(),
        x.shape[0], log_size, 1 if ptw is None else ptw.shape[0])
    return out


def ntt_pass_plain(x: torch.Tensor, tw: torch.Tensor, ptw: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of kernel A: bit-reversal gather, then the
    radix-2 DIT stages, then the optional post-multiply."""
    f = BN254_FR
    rows, size, _ = x.shape
    log_size = size.bit_length() - 1
    a = to64(x)[:, :, _bitrev(log_size).to(x.device)]  # (16, rows, size)
    tw64 = to64(tw)
    for s in range(log_size):
        m = 1 << s
        w = tw64[:, torch.arange(m, device=x.device) * (size // (2 * m))]
        A = a.reshape(L, rows, size // (2 * m), 2, m)
        lo, hi = A[:, :, :, 0], A[:, :, :, 1]
        t = mul64(f, hi, w[:, None, None, :])
        a = torch.stack([add64(f, lo, t), sub64(f, lo, t)], dim=3).reshape(L, rows, size)
    if ptw is not None:
        period = ptw.shape[0]
        flat = a.reshape(L, -1, period)
        a = mul64(f, flat, to64(ptw)[:, None, :]).reshape(L, rows, size)
    return to32(a)
