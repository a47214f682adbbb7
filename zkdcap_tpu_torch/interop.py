"""Carry state between the JAX package's numpy arrays and the port's tensors.

The JAX package stores limbs and packed rows as uint32; the port stores the
same 32-bit patterns as int32. Both directions keep every bit.
"""

from __future__ import annotations

import os

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


def savez_deflated(path: str, arrays: dict, level: int = 1, chunk: int = 1 << 24) -> None:
    """``np.savez_compressed``'s file (a zip of deflated ``.npy`` members,
    read by ``np.load`` in either package) at deflate level 1: the pk's
    limbs are near-random, so numpy's default level 6 spends several times
    longer for about 2% fewer bytes. Each member is deflated in chunks of
    `chunk` bytes on one thread per host core (zlib releases the GIL), each
    chunk ending on a byte boundary (a sync flush) so that their
    concatenation is one deflate stream, as pigz writes it."""
    import io
    import time
    import zipfile
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    def deflate(piece: memoryview, last: bool) -> bytes:
        c = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
        return c.compress(piece) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf, \
            ThreadPoolExecutor(os.cpu_count()) as pool:
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            header = io.BytesIO()
            np.lib.format.write_array_header_1_0(
                header, np.lib.format.header_data_from_array_1_0(arr))
            data = memoryview(arr.reshape(-1).view(np.uint8))
            pieces = [memoryview(header.getvalue())]
            pieces += [data[i : i + chunk] for i in range(0, len(data), chunk)]
            parts = [pool.submit(deflate, piece, i == len(pieces) - 1)
                     for i, piece in enumerate(pieces)]
            crc = 0
            for piece in pieces:
                crc = zlib.crc32(piece, crc)
            parts = [f.result() for f in parts]
            info = zipfile.ZipInfo(name + ".npy", date_time=time.localtime()[:6])
            info.compress_type = zipfile.ZIP_DEFLATED
            info.file_size = sum(len(piece) for piece in pieces)
            info.compress_size = sum(len(part) for part in parts)
            info.CRC = crc
            info.header_offset = zf.fp.tell()
            zf.fp.write(info.FileHeader(zip64=True))
            for part in parts:
                zf.fp.write(part)
            zf.filelist.append(info)
            zf.NameToInfo[info.filename] = info
            zf.start_dir = zf.fp.tell()
            zf._didModify = True


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
