"""Multi-shard NTT: the four-step factorisation with all-to-all exchanges.

Port of ``zkdcap_tpu/parallel/sharded_ntt.py``. The size-n NTT factors as
n = N1 * N2 with N1 = 2^(log n // 2):

  1. view the coefficients as A[i, j] = a[i * N2 + j]; shard g owns the
     column block j in [g * N2 / D, (g + 1) * N2 / D);
  2. the size-N1 NTT of each of its columns (kernel A, reading the columns
     of A through a strided view where the shard is a's device);
  3. the twiddle w_n^(i * j) with the global column index j (kernel E);
  4. all_to_all: column blocks to row blocks, shard g owning rows
     k1 in [g * N1 / D, (g + 1) * N1 / D);
  5. the size-N2 NTT of each of its rows;
  6. all_to_all back, so that shard g holds outputs k2 * N1 + k1 for its
     block of k2: a contiguous block of the natural order.

The output is one row block per shard (:func:`gather_rows` joins them). The
shard count must divide N1 and N2, as the JAX package asserts. Steps 2-3 and
5 go through ``Mesh.map``: no step reads a card back, so the shards are
issued as a loop would issue them, and cards overlap only as far as one
card's queue outlasts the host's issue of the next (on four H100s, hardly:
the 2^22 NTT took as long as the loop).
"""

from __future__ import annotations

import torch

from ..fields import mont
from ..fields.params import BN254_FR, NUM_LIMBS, FieldParams
from ..ntt.ntt import four_step_split, four_step_twiddles, ntt_rows
from .mesh import Mesh, _is_mesh

L = NUM_LIMBS


def sharded_ntt(mesh: Mesh, a: torch.Tensor, params: FieldParams = BN254_FR) -> list[torch.Tensor]:
    """Forward NTT of an (n, 16) Montgomery coefficient array on the mesh's
    first shard (every process holds the same a). Returns this process's
    shards' blocks of the evaluations in natural order, (n / D, 16) each on
    its shard's device."""
    mesh = _is_mesh(mesh)
    if params != BN254_FR:
        raise ValueError("the NTT runs over BN254 Fr")
    n = a.shape[0]
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n:
        raise ValueError(f"NTT size {n} is not a power of two above 1")
    log_n1, log_n2 = four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    d = mesh.size
    if n1 % d or n2 % d:
        raise ValueError(f"mesh size {d} must divide both factors {n1} and {n2}")
    c1, c2 = n1 // d, n2 // d
    A = a.view(n1, n2, L)
    shards = mesh.local_shards()
    # every shard's columns are sent (and each device's twiddle table built)
    # before any transform is issued
    blocks = [A[:, g * c2:(g + 1) * c2].transpose(0, 1).to(dev) for g, dev in shards]  # [j, k1]
    tws = [four_step_twiddles(log_n, False, dev)[g * c2 * n1:(g + 1) * c2 * n1].view(c2, n1, L)
           for g, dev in shards]
    cols = mesh.map(lambda x, tw: mont.mont_mul(params, ntt_rows(params, x), tw), blocks, tws)
    recv = mesh.all_to_all([[c[:, t * c1:(t + 1) * c1] for t in range(d)] for c in cols])
    rows = mesh.map(lambda parts: ntt_rows(params, torch.cat(parts).transpose(0, 1)),  # [k1, k2]
                    recv)
    back = mesh.all_to_all([[r[:, t * c2:(t + 1) * c2] for t in range(d)] for r in rows])
    return [torch.cat(parts).transpose(0, 1).reshape(c2 * n1, L) for parts in back]


def gather_rows(mesh: Mesh, blocks: list[torch.Tensor]) -> torch.Tensor:
    """This process's row blocks -> the whole array on the first shard."""
    return torch.cat(_is_mesh(mesh).all_gather(blocks))
