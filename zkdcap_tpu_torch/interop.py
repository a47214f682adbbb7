"""Carry state between the JAX package's numpy arrays and the port's tensors.

The JAX package stores limbs and packed rows as uint32; the port stores the
same 32-bit patterns as int32. Both directions keep every bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve


def to_torch(arr, device=None) -> torch.Tensor:
    """uint32 numpy array (limbs (..., 16), encoded points (N, 2, 16) or
    packed rows) -> int32 tensor with the same bit patterns."""
    a = np.array(arr, dtype=np.uint32, copy=True, order="C")
    return torch.from_numpy(a.view(np.int32)).to(resolve(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bit patterns."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def srs_from_numpy(g1_powers, device=None):
    """The port's ParamsKZG over the reference SRS's ``g1_powers``
    (uint32[2^k, 2, 16])."""
    from .commit import SRS, ParamsKZG
    from .curves.host_curve import BN254_G1

    pts = to_torch(g1_powers, device)
    n = pts.shape[0]
    k = n.bit_length() - 1
    if n != 1 << k:
        raise ValueError(f"SRS of {n} points is not a power of two")
    return ParamsKZG(srs=SRS(k=k, g1_powers=pts, g1=BN254_G1.g))
