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
    from .commit import ParamsKZG
    from .commit.srs import srs_from_g1_powers

    pts = to_torch(g1_powers, device)
    n = pts.shape[0]
    k = n.bit_length() - 1
    if n != 1 << k:
        raise ValueError(f"SRS of {n} points is not a power of two")
    return ParamsKZG(srs=srs_from_g1_powers(k, pts))


PK_LISTS = ("fixed_lagrange", "fixed_coeff", "fixed_extended",
            "sigma_lagrange", "sigma_coeff", "sigma_extended")
PK_ARRAYS = ("l0_ext", "llast_ext", "lblind_ext", "zh_inv_ext")


def proving_key_from_numpy(cs, k: int, arrays: dict, fixed_commitments, permutation_commitments,
                           transcript_kind: str = "blake2b", device=None):
    """The port's ProvingKey over the port's ConstraintSystem `cs` from a
    reference pk: `arrays` maps each name of PK_LISTS to its list of uint32
    (n or extended_n, 16) arrays and each name of PK_ARRAYS to one array;
    the commitments are host affine points."""
    from .fields.params import BN254_FR
    from .ntt import Domain
    from .plonk.keygen import ProvingKey, VerifyingKey

    vk = VerifyingKey(k=k, cs=cs, fixed_commitments=list(fixed_commitments),
                      permutation_commitments=list(permutation_commitments),
                      transcript_kind=transcript_kind)
    fields = {name: [to_torch(a, device) for a in arrays[name]] for name in PK_LISTS}
    fields.update((name, to_torch(arrays[name], device)) for name in PK_ARRAYS)
    return ProvingKey(vk=vk, domain=Domain(BN254_FR, k, cs.extended_k(k)), **fields)


def savez_deflated(path: str, arrays: dict, level: int = 1) -> None:
    """``np.savez_compressed``'s file (a zip of deflated ``.npy`` members,
    read by ``np.load`` in either package) at deflate level 1: the pk's
    limbs are near-random, so numpy's default level 6 spends several times
    longer for about 2% fewer bytes."""
    import zipfile

    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=level) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


def save_pk(path: str, pk) -> None:
    """A prover's pk file in the JAX package's layout: each non-empty list of
    PK_LISTS stacked, then each array of PK_ARRAYS (``savez_deflated``)."""
    arrays = {name: to_numpy(torch.stack(getattr(pk, name)))
              for name in PK_LISTS if getattr(pk, name)}
    arrays.update((name, to_numpy(getattr(pk, name))) for name in PK_ARRAYS)
    savez_deflated(path, arrays)


def load_pk(path: str, vk, domain, device=None):
    """The ProvingKey of a pk file written by either package's prover."""
    from .plonk.keygen import ProvingKey

    with np.load(path) as data:
        fields = {name: [to_torch(a, device) for a in data[name]] if name in data else []
                  for name in PK_LISTS}
        fields.update((name, to_torch(data[name], device)) for name in PK_ARRAYS)
    return ProvingKey(vk=vk, domain=domain, **fields)
