"""The prover's row sharder: its (rows, 16) field arrays in row blocks.

Port of the row sharding of ``zkdcap_tpu/plonk/prover.py`` (``_row_sharder``:
GSPMD row-shards the arrays of rounds 3, 4 and 6 over the mesh). Here the
split is explicit. Each array is made whole on the mesh's first shard, as
on one device, and each shard works on its equal block of rows. A rotated
read (``f(w^r X)``, a ``torch.roll`` on one device) takes the rows past a
block's end from the whole array, wrapping modulo the array's length, so a
rotation may reach across any number of blocks. A grand product runs per
block and the blocks' totals carry across (:meth:`RowSharder.grand_product`).
The prover's per-block work goes through :meth:`RowSharder.map`
(``Mesh.map``: a lane a device).
Results are gathered on the first shard. Without a mesh there is one block,
the whole array, and every method is what the prover does on one device.

The proving key's blocks are cached on the mesh per key. Blocks are views
of the whole array where the shard is its device: nothing writes into one.
"""

from __future__ import annotations

import torch

from ..fields import mont
from ..fields.params import BN254_FR

F = BN254_FR


def prefix_product_inclusive(ratios: torch.Tensor) -> torch.Tensor:
    """z_j = prod_{t<=j} ratios_t: a Hillis-Steele scan, log n products.
    Field products are associative and commutative, so the values equal the
    reference's associative scan."""
    inc = ratios
    n = inc.shape[0]
    shift = 1
    while shift < n:
        inc = torch.cat([inc[:shift], mont.mont_mul(F, inc[shift:], inc[: n - shift])])
        shift *= 2
    return inc


def prefix_product_exclusive(ratios: torch.Tensor) -> torch.Tensor:
    """z_j = prod_{t<j} ratios_t (z_0 = 1)."""
    return torch.cat([mont.one_mont(F, (1,), ratios.device),
                      prefix_product_inclusive(ratios)[:-1]])


class RowSharder:
    """Row blocks of n-row arrays over ``mesh``'s shards in this process, or
    one block (the array) on ``device`` when ``mesh`` is None."""

    def __init__(self, mesh, n: int, device):
        self.mesh = mesh
        self.n = n
        if mesh is None:
            self.shards = [(0, torch.device(device))]
            self.rows = n
        else:
            if n % mesh.size:
                raise ValueError(f"{n} rows do not split over {mesh.size} shards")
            self.shards = mesh.local_shards()
            self.rows = n // mesh.size
        # id(array) -> (array, its blocks): holding the array keeps its id
        self._blocks: dict[int, tuple[torch.Tensor, list[torch.Tensor]]] = {}

    @property
    def devices(self) -> list[torch.device]:
        return [dev for _, dev in self.shards]

    def start(self, i: int) -> int:
        """The first row of local block i."""
        return self.shards[i][0] * self.rows

    def split(self, *arrays: torch.Tensor) -> None:
        """Make the blocks of whole arrays (on the first shard); they live as
        long as the sharder."""
        if self.mesh is None:
            return
        for x in arrays:
            if id(x) not in self._blocks:
                self._blocks[id(x)] = (x, self.mesh.split(x))

    def split_pk(self, pk, tag: str, arrays) -> None:
        """split() of a proving key's arrays, cached on the mesh per key."""
        if self.mesh is None:
            return
        arrays = list(arrays)
        blocks = self.mesh.cached(pk, ("rows", tag), lambda: [self.mesh.split(a) for a in arrays])
        for x, b in zip(arrays, blocks):
            self._blocks[id(x)] = (x, b)

    def block(self, x: torch.Tensor, i: int, shift: int = 0) -> torch.Tensor:
        """Rows start(i) + shift .. start(i) + shift + rows - 1 (mod n) of the
        whole array x, on shard i's device: block i of x(w^shift X)."""
        if self.mesh is None:
            return x if shift == 0 else torch.roll(x, -shift, 0)
        hit = self._blocks.get(id(x))
        if shift == 0 and hit is not None and hit[0] is x:
            return hit[1][i]
        s = (self.start(i) + shift) % self.n
        rows = x[s:s + self.rows]
        if rows.shape[0] < self.rows:
            rows = torch.cat([rows, x[:self.rows - rows.shape[0]]])
        return rows.to(self.shards[i][1])

    def map(self, fn, *per_block_args) -> list:
        """``fn(*args)`` for each local block with the block's item of each
        of ``per_block_args``, through ``Mesh.map``; without a mesh, the one
        block here."""
        if self.mesh is None:
            return [fn(*args) for args in zip(*per_block_args)]
        return self.mesh.map(fn, *per_block_args)

    def gather(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """The local blocks -> the whole array on the first shard (without a
        mesh, the one block itself)."""
        if self.mesh is None:
            return blocks[0]
        return torch.cat(self.mesh.all_gather(blocks))

    def grand_product(self, nums, dens, u: int, carry: torch.Tensor | None = None) -> torch.Tensor:
        """z_j = carry * prod_{t<j} num_t / den_t over the u usable rows
        (ratio 1 past them) from the blocks of num and den: each block's
        batch inverse and exclusive prefix product, then the product of the
        totals of the blocks before it. Returns the whole z on the first
        shard."""
        def inclusive(i, num, den):
            dev = num.device
            mask = ((self.start(i) + torch.arange(num.shape[0], device=dev)) < u)[:, None]
            one = mont.one_mont(F, (), dev)
            ratios = mont.mont_mul(F, num, mont.batch_inv(F, torch.where(mask, den, one)))
            return prefix_product_inclusive(torch.where(mask, ratios, one))

        incs = self.map(inclusive, range(len(nums)), nums, dens)
        if self.mesh is None:
            carries = [carry]
        else:
            totals = torch.cat(self.mesh.all_gather([inc[-1:] for inc in incs]))
            before = prefix_product_exclusive(totals)
            if carry is not None:
                before = mont.mont_mul(F, before, carry)
            carries = [before[g:g + 1].to(dev) for g, dev in self.shards]
        zs = []
        for inc, c in zip(incs, carries):
            z = torch.cat([mont.one_mont(F, (1,), inc.device), inc[:-1]])
            zs.append(z if c is None else mont.mont_mul(F, z, c))
        return self.gather(zs)
