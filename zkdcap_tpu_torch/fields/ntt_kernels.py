"""Kernel A: the NTT pass, its wrapper and its plain torch version.

Counterpart of the fused NTT pass kernels of ``zkdcap_tpu/fields/pallas_mont.py``
(``_mk_fused_pass_kernel``, ``_mk_fused_pass_kernel_r12``,
``_mk_cg_pass_kernel_r12``); the CUDA source is ``csrc/ntt_pass.cu``.

``ntt_pass(x, tw, ptw, out)`` transforms every row of ``x``, a
``(rows, 2^S, 16)`` or ``(batch, rows, 2^S, 16)`` tensor or strided view whose
limb dimension is contiguous, S <= 11, natural order in and out, with the
stage twiddles ``tw`` = powers [w^0 .. w^(2^(S-1) - 1)] of the 2^S-th root w
(forward or inverse), then multiplies flat element g (in the output's logical
order) by ``ptw[g % len(ptw)]`` when ``ptw`` is given. The result goes to
``out`` when given (a view of the same shape and kind, disjoint from ``x``),
else to a new contiguous tensor. The kernel reads both views' batch, row and
element strides, so the four-step NTT (``ntt/ntt.py``) hands it columns and
transposed outputs without copies. With ``rev_rows`` (the row count a power
of two), output row r of each batch is the transform of x's row bitrev(r):
the flat NTT's chunks, read from the columns of the array in place. All
values are BN254 Fr limbs in Montgomery form.
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


def _extent(t: torch.Tensor) -> tuple[int, int]:
    """[first, last + 1) byte addresses of the elements of t."""
    span = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (span + 1) * t.element_size()


def _overlapping(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    (a0, a1), (b0, b1) = _extent(a), _extent(b)
    return a0 < b1 and b0 < a1


def _self_overlapping(t: torch.Tensor) -> bool:
    """Whether two indices of t may share memory: taken by increasing
    stride, every stride must reach past the extent of the dims before it."""
    reach = 0
    for s, n in sorted((s, n) for n, s in zip(t.shape, t.stride()) if n > 1):
        if s <= reach:
            return True
        reach += (n - 1) * s
    return False


def _check_view(name: str, t: torch.Tensor) -> None:
    """What the kernel takes of x and out, on any device: int32, the limbs
    contiguous, every stride and the start on a 16-byte boundary."""
    if t.dtype != torch.int32:
        raise ValueError(f"ntt_pass: {name} must be int32, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"ntt_pass: {name}'s limb dimension must be contiguous, "
                         f"strides {t.stride()}")
    if any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"ntt_pass: {name}'s elements must start on 16-byte boundaries, "
                         f"strides {t.stride()}")


def _check(x: torch.Tensor, tw: torch.Tensor, ptw, out, rev_rows: bool) -> int:
    if x.dim() not in (3, 4) or x.shape[-1] != L:
        raise ValueError(f"ntt_pass: x must be (rows, 2^S, {L}) or (batch, rows, 2^S, {L}), "
                         f"got {tuple(x.shape)}")
    size = x.shape[-2]
    log_size = size.bit_length() - 1
    if size < 2 or size != 1 << log_size or log_size > MAX_PASS_LOG:
        raise ValueError(f"ntt_pass: transform size {size} is not a power of two in [2, 2^11]")
    if tuple(tw.shape) != (size // 2, L):
        raise ValueError(f"ntt_pass: tw must be ({size // 2}, {L}), got {tuple(tw.shape)}")
    if rev_rows and x.shape[-3] & (x.shape[-3] - 1):
        raise ValueError(f"ntt_pass: rev_rows needs a power-of-two row count, got {x.shape[-3]}")
    elements = x.numel() // L
    if ptw is not None and (ptw.dim() != 2 or ptw.shape[1] != L or ptw.shape[0] < 1
                            or elements % ptw.shape[0]):
        raise ValueError(f"ntt_pass: ptw rows must divide {elements}")
    _check_view("x", x)
    if out is not None:
        if out.shape != x.shape or out.device != x.device:
            raise ValueError(f"ntt_pass: out must be {tuple(x.shape)} on {x.device}, "
                             f"got {tuple(out.shape)} on {out.device}")
        _check_view("out", out)
        if _self_overlapping(out):
            raise ValueError(f"ntt_pass: out's elements overlap, strides {out.stride()}")
        if _overlapping(x, out):
            raise ValueError("ntt_pass: x and out overlap")
    return log_size


def ntt_pass(x: torch.Tensor, tw: torch.Tensor, ptw: torch.Tensor | None = None,
             out: torch.Tensor | None = None, rev_rows: bool = False) -> torch.Tensor:
    log_size = _check(x, tw, ptw, out, rev_rows)
    if x.is_cuda:
        return _ntt_pass_cuda(x, tw, ptw, out, rev_rows, log_size)
    if x.device.type == "cpu":
        return ntt_pass_plain(x, tw, ptw, out, rev_rows)
    raise ValueError(f"ntt_pass: unsupported device {x.device}")


def _ntt_pass_cuda(x, tw, ptw, out, rev_rows: bool, log_size: int) -> torch.Tensor:
    tw = tw.contiguous()
    ptw = None if ptw is None else ptw.contiguous()
    dev = _build.check_cuda("ntt_pass", *((tw,) if ptw is None else (tw, ptw)))
    if x.device != tw.device:
        raise ValueError(f"ntt_pass: x on {x.device}, the tables on {tw.device}")
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    x4, o4 = (x, out) if x.dim() == 4 else (x[None], out[None])
    _build.launch(
        "ntt_pass", x.data_ptr(), out.data_ptr(), tw.data_ptr(),
        None if ptw is None else ptw.data_ptr(), x4.shape[0], x4.shape[1], log_size,
        1 if ptw is None else ptw.shape[0], *x4.stride()[:3], *o4.stride()[:3],
        x4.shape[1].bit_length() - 1 if rev_rows else 0, device=dev)
    return out


def ntt_pass_plain(x: torch.Tensor, tw: torch.Tensor, ptw: torch.Tensor | None = None,
                   out: torch.Tensor | None = None, rev_rows: bool = False) -> torch.Tensor:
    """Plain torch version of kernel A: bit-reversal gather, then the
    radix-2 DIT stages, then the optional post-multiply, on a contiguous
    copy of x (its rows gathered in bit-reversed order with ``rev_rows``);
    the result is copied into ``out`` when given."""
    f = BN254_FR
    shape = x.shape
    if rev_rows:
        x = x.index_select(-3, _bitrev(shape[-3].bit_length() - 1).to(x.device))
    size = shape[-2]
    log_size = size.bit_length() - 1
    rows = x.numel() // (L * size)
    a = to64(x.reshape(rows, size, L))[:, :, _bitrev(log_size).to(x.device)]  # (16, rows, size)
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
    res = to32(a).reshape(shape)
    return res if out is None else out.copy_(res)
