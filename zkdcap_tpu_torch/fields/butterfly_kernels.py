"""Kernel G: one radix-2 DIT stage, its wrapper and its plain torch version.

Counterpart of ``_mk_butterfly_kernel`` / ``butterfly`` of
``zkdcap_tpu/fields/pallas_mont.py``; the CUDA source is ``csrc/butterfly.cu``.

``butterfly(x, tw, s, tw_stride)`` runs stage ``s`` of the radix-2 DIT over
every row of ``x`` (rows, 2^log_n, 16), bit-reversed in, as the flat NTT
(``ntt/ntt.py``) runs its stages above kernel A's 2^11-point chunks: with
half-span m = 2^s, element i of every block of 2m (lo) and element i + m
(hi) become lo + t and lo - t, t = hi * tw[i * tw_stride] * R^-1 mod p.
``out=x`` writes in place. All values are BN254 Fr limbs in Montgomery form.
"""

from __future__ import annotations

import torch

from .. import _build
from .mont import add64, mul64, sub64, to32, to64
from .params import BN254_FR, NUM_LIMBS

L = NUM_LIMBS


def _check(x: torch.Tensor, tw: torch.Tensor, s: int, tw_stride: int, out) -> int:
    if x.dim() != 3 or x.shape[-1] != L:
        raise ValueError(f"butterfly: x must be (rows, 2^log_n, {L}), got {tuple(x.shape)}")
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n:
        raise ValueError(f"butterfly: transform size {n} is not a power of two >= 2")
    if not 0 <= s < log_n:
        raise ValueError(f"butterfly: stage {s} is not in [0, {log_n})")
    if tw.dim() != 2 or tw.shape[1] != L or tw_stride < 1 \
            or ((1 << s) - 1) * tw_stride >= tw.shape[0]:
        raise ValueError(f"butterfly: tw ({tuple(tw.shape)}) has no row "
                         f"{((1 << s) - 1) * tw_stride} for stride {tw_stride}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("butterfly: out must match x")
    return log_n


def butterfly(x: torch.Tensor, tw: torch.Tensor, s: int, tw_stride: int = 1,
              out: torch.Tensor | None = None) -> torch.Tensor:
    log_n = _check(x, tw, s, tw_stride, out)
    if x.is_cuda:
        return _butterfly_cuda(x, tw, s, tw_stride, out, log_n)
    if x.device.type == "cpu":
        res = butterfly_plain(x, tw, s, tw_stride)
        return res if out is None else out.copy_(res)
    raise ValueError(f"butterfly: unsupported device {x.device}")


def _butterfly_cuda(x, tw, s: int, tw_stride: int, out, log_n: int) -> torch.Tensor:
    tw = tw.contiguous()
    if out is None:
        x = x.contiguous()
        out = torch.empty_like(x)
    dev = _build.check_cuda("butterfly", x, tw, out)
    _build.launch("butterfly", x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                  x.shape[0], log_n, s, tw_stride, device=dev)
    return out


def butterfly_plain(x: torch.Tensor, tw: torch.Tensor, s: int, tw_stride: int = 1) -> torch.Tensor:
    """Plain torch version of kernel G: the stage of ``ntt_pass_plain``
    with the twiddles read from the strided table."""
    rows, n, _ = x.shape
    m = 1 << s
    A = to64(x).reshape(L, rows, n // (2 * m), 2, m)
    lo, hi = A[:, :, :, 0], A[:, :, :, 1]
    w = to64(tw[torch.arange(m, device=x.device) * tw_stride])
    t = mul64(BN254_FR, hi, w[:, None, None, :])
    a = torch.stack([add64(BN254_FR, lo, t), sub64(BN254_FR, lo, t)], dim=3)
    return to32(a.reshape(L, rows, n))
